"""The precision the reference computes in: float32 with TF32 off, or the
control's TF32.

The configuration states float32 with TF32 off. The control that the
benchmark's limits are set against is the reference one step below, in
TF32: each operand of the cell moments' products and sums and of RANSAC's
point-to-plane distances rounded to TF32's 10-bit mantissa, as a tensor
core rounds the operands of a TF32 matrix product (the moments as
segment matrix products, the distances as a batched product). Float32
arithmetic and accumulation are kept, as a TF32 product keeps them.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 rounded to nearest (ties to even) at 10 mantissa
    bits; infinities and NaNs pass."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    finite = torch.isfinite(t)
    return torch.where(finite, rounded.view(torch.float32), t)


@contextlib.contextmanager
def tf32():
    """Inside, ``operand`` rounds to TF32 (the control); outside it is the
    identity (the reference)."""
    saved = getattr(_state, "tf32", False)
    _state.tf32 = True
    try:
        yield
    finally:
        _state.tf32 = saved


def operand(t: torch.Tensor) -> torch.Tensor:
    """A product's or sum's float32 operand as the current precision sees it."""
    if getattr(_state, "tf32", False) and t.dtype == torch.float32:
        return tf32_round(t)
    return t
