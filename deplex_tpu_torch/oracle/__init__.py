"""Serial numpy oracle of the CAPE plane-extraction pipeline.

Port of ``deplex_tpu.oracle``: a slow, readable, serial re-derivation of the
reference semantics (``reference_impl.py``), used as a conformance oracle in
tests beside the stored goldens. Not the port's pipeline (``pipeline.py``),
which is held to both.
"""

from deplex_tpu_torch.oracle.reference_impl import extract_planes_oracle

__all__ = ["extract_planes_oracle"]
