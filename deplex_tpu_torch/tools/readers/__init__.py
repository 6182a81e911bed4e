"""Dataset readers: iterate a directory of depth PNGs as organized clouds.

Ports of the reference package's ``scripts/readers``: ``TumReader`` (TUM
RGB-D, the fr3 factory intrinsics by default) and ``IclReader`` (ICL-NUIM,
the living-room intrinsics by default). Each yields (frame stem, (H*W, 3)
float32 cloud) in file-name order, through the port's ``DepthImage``.
"""

from deplex_tpu_torch.tools.readers.icl_reader import ICL_INTRINSICS, IclReader
from deplex_tpu_torch.tools.readers.tum_reader import TUM_FR3_INTRINSICS, TumReader

__all__ = ["ICL_INTRINSICS", "IclReader", "TUM_FR3_INTRINSICS", "TumReader"]
