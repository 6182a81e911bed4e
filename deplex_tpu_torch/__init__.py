"""deplex_tpu_torch: the plane-extraction pipeline and the plane-landmark
SLAM stack in PyTorch, with hand-written CUDA kernels for the NVIDIA H100.

A port of ``deplex_tpu`` (the JAX package, which stays as the reference):
the same stages, configs and results, with every TPU Pallas kernel replaced
by a CUDA C++ kernel (``csrc/``); RANSAC refinement (``ops/ransac.py``) and
``slam/`` are plain PyTorch. This package imports torch and numpy, never jax
or deplex_tpu.

    >>> from deplex_tpu_torch import Config, PlaneExtractor
    >>> from deplex_tpu_torch.utils import DepthImage, read_intrinsics
    >>> image = DepthImage("depth.png")
    >>> extractor = PlaneExtractor(image.height, image.width, Config())
    >>> labels = extractor.process_depth(image.data, read_intrinsics("cam.K"))
"""

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.extractor import PlaneExtractor
from deplex_tpu_torch.slam import PlaneSlam

__version__ = "0.1.0"

__all__ = ["Config", "PlaneExtractor", "PlaneSlam", "__version__"]
