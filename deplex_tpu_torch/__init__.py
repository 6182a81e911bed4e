"""deplex_tpu_torch: the plane-extraction pipeline and the plane-landmark
SLAM stack in PyTorch, with hand-written CUDA kernels for the NVIDIA H100.

A port of ``deplex_tpu`` (the JAX package, which stays as the reference):
the same stages, configs and results, with every TPU Pallas kernel replaced
by a CUDA C++ kernel (``csrc/``), and RANSAC refinement's chunk scoring
(the fusion XLA makes of it) by one more (``csrc/ransac.cu``); the rest of
``ops/ransac.py``, cylinders (``ops/cylinder.py``), ``slam/`` and the
torch.distributed layers of ``parallel/`` are plain PyTorch. This package imports torch and numpy,
never jax or deplex_tpu.

    >>> from deplex_tpu_torch import Config, PlaneExtractor
    >>> from deplex_tpu_torch.utils import DepthImage, read_intrinsics
    >>> image = DepthImage("depth.png")
    >>> extractor = PlaneExtractor(image.height, image.width, Config())
    >>> labels = extractor.process_depth(image.data, read_intrinsics("cam.K"))
"""

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.extractor import PlaneExtractor
from deplex_tpu_torch.pipeline import extract_primitives
from deplex_tpu_torch.slam import PlaneSlam

__version__ = "0.1.0"

__all__ = ["Config", "PlaneExtractor", "PlaneSlam", "extract_primitives", "__version__"]
