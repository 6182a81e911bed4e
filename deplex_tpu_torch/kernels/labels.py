"""Wrapper of the pixel-labels kernel (csrc/labels.cu): stage 5's rasterize,
with stage 6 its final inlier pass, in the output dtype, in one launch.

Replaces the XLA fusions of deplex_tpu/ops/merge.py:156 rasterize_labels,
the uint8 cast of extract_depth_batch_jit and the final pass of
deplex_tpu/ops/ransac.py:325-332 (the JAX package has no pallas_call for
them). For CUDA tensors it launches the kernel (or raises); for CPU tensors
it runs the plain twin ``ops.merge.pixel_labels_reference``.
"""

from __future__ import annotations

import torch

from deplex_tpu_torch.kernels import _build
from deplex_tpu_torch.ops.merge import pixel_labels_reference
from deplex_tpu_torch.ops.ransac import winners

launches = 0

DTYPES = {torch.uint8: 1, torch.int32: 4}
# The shared memory a block may take on the H100 (227 KB): a row of W labels
# in the output dtype, or in int32 with stage 6 and then its MAXP winners.
MAX_ROW_BYTES = 232448


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte aligned address (the kernel's vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_inputs(labels_map: torch.Tensor, merge_labels: torch.Tensor, image_height: int,
                 image_width: int, patch_size: int, dtype: torch.dtype, refine=None) -> None:
    """Raise ValueError unless the inputs are what the labels stage takes:
    (B, gh, gw) int32 cell labels that gh*P x gw*P fit in the image, (B,
    MAXP) int32 merge labels, uint8 or int32 output; with refine, (B, H*W,
    3) float32 points, (B, MAXP, n_hyp, 4) float32 hypotheses and (B, MAXP)
    int64 winners' indices; all on one device. The kernel's own limit is
    ``check_launch``'s."""
    H, W, P = image_height, image_width, patch_size
    if labels_map.dim() != 3 or labels_map.dtype != torch.int32:
        raise ValueError(f"pixel_labels: labels_map must be (B, gh, gw) int32, got "
                         f"{tuple(labels_map.shape)} {labels_map.dtype}")
    B, gh, gw = labels_map.shape
    dev = labels_map.device
    if P < 1 or gh * P > H or gw * P > W:
        raise ValueError(f"pixel_labels: {gh}x{gw} cells of {P} do not fit a {H}x{W} image")
    if merge_labels.dim() != 2 or merge_labels.shape[0] != B or \
            merge_labels.dtype != torch.int32 or merge_labels.device != dev:
        raise ValueError(f"pixel_labels: merge_labels must be ({B}, MAXP) int32 on {dev}, "
                         f"got {tuple(merge_labels.shape)} {merge_labels.dtype} on "
                         f"{merge_labels.device}")
    if dtype not in DTYPES:
        raise ValueError(f"pixel_labels: dtype must be torch.uint8 or torch.int32, got {dtype}")
    if refine is not None:
        points, hyp, best_k, _ = refine
        M = merge_labels.shape[1]
        n_hyp = hyp.shape[2] if hyp.dim() == 4 else 0
        for name, t, shape, kind in (("points", points, (B, H * W, 3), torch.float32),
                                     ("hyp", hyp, (B, M, max(n_hyp, 1), 4), torch.float32),
                                     ("best_k", best_k, (B, M), torch.int64)):
            if tuple(t.shape) != shape or t.dtype != kind or t.device != dev:
                raise ValueError(f"pixel_labels: {name} must be {shape} {kind} on {dev}, "
                                 f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def check_launch(image_width: int, max_planes: int, dtype: torch.dtype, refine=None) -> None:
    """Raise ValueError where the kernel's shared memory refuses inputs that
    ``check_inputs`` takes (only the card's path checks this): a row of W
    labels, and with stage 6 the MAXP winners, in 227 KB (W up to 232,448
    uint8 or 58,112 int32 labels; the CPU's twin takes any W)."""
    row_bytes = image_width * (4 if refine is not None else DTYPES[dtype])
    need = (row_bytes + 15) // 16 * 16 + (16 * max_planes if refine is not None else 0)
    if need > MAX_ROW_BYTES:
        raise ValueError(f"pixel_labels: a row of {image_width} labels takes {need} bytes, over "
                         f"the {MAX_ROW_BYTES} bytes of shared memory a block may hold")


def pixel_labels(labels_map: torch.Tensor, merge_labels: torch.Tensor, image_height: int,
                 image_width: int, patch_size: int, dtype: torch.dtype = torch.int32,
                 refine=None) -> torch.Tensor:
    """(B, gh, gw) int32 cell labels + (B, MAXP) int32 merge labels -> (B,
    H*W) pixel labels in `dtype` (torch.int32, or torch.uint8: the low 8
    bits): merge_labels[cell label - 1] + 1, 0 for cell label 0 and past
    the gh*P x gw*P crop. refine: stage 6's (points, hyp, best_k,
    threshold), the final pass of ``pixel_labels_reference`` with the
    winners hyp at best_k (``winners``; the kernel reads them itself)."""
    global launches
    check_inputs(labels_map, merge_labels, image_height, image_width, patch_size, dtype,
                 refine)
    dev = labels_map.device
    if dev.type == "cpu":
        if refine is not None:
            points, hyp, best_k, threshold = refine
            refine = (points, winners(hyp, best_k), threshold)
        return pixel_labels_reference(labels_map, merge_labels, image_height, image_width,
                                      patch_size, dtype, refine)
    if dev.type != "cuda":
        raise ValueError(f"pixel_labels: unsupported device {dev}")
    check_launch(image_width, merge_labels.shape[1], dtype, refine)
    cells, merge = labels_map.contiguous(), merge_labels.contiguous()
    if refine is not None:
        points, hyp, best_k, threshold = refine
        refine = (_aligned(points), _aligned(hyp), best_k.contiguous(), threshold)
    out = torch.empty((labels_map.shape[0], image_height * image_width), dtype=dtype,
                      device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = launch(lib, cells, merge, image_height, image_width, patch_size, out,
                    torch.cuda.current_stream(dev).cuda_stream, refine)
    _build.check(rc, "pixel_labels")
    launches += 1
    return out


def launch(lib, labels_map: torch.Tensor, merge_labels: torch.Tensor, image_height: int,
           image_width: int, patch_size: int, out: torch.Tensor, stream: int,
           refine=None) -> int:
    """One call of the C entry on checked, contiguous inputs into `out`, (B,
    H*W) in its dtype; `refine` stage 6's (points, hyp, best_k, threshold),
    points and hyp 16-byte aligned. Returns the CUDA error code."""
    B, gh, gw = labels_map.shape
    points, hyp, best_k, threshold = refine if refine is not None else (None, None, None, 0.0)
    return lib.dplx_pixel_labels(
        labels_map.data_ptr(), merge_labels.data_ptr(),
        None if points is None else points.data_ptr(), None if hyp is None else hyp.data_ptr(),
        None if best_k is None else best_k.data_ptr(), 0 if hyp is None else hyp.shape[2],
        float(threshold), B, gh, gw, image_height, image_width, patch_size,
        merge_labels.shape[1], DTYPES[out.dtype], out.data_ptr(), stream)
