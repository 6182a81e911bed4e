"""The plane-extraction pipeline: depth or points -> per-pixel plane labels.

Port of ``deplex_tpu.pipeline``. Five stages, batched over frames:
  1. cell statistics      (kernels: csrc/cellstats.cu, the moments; then
                           csrc/cellfinal.cu, the fit and gates)
  2. normal bins, edges   (csrc/cellfinal.cu, in the same launch)
  3. region growing       (kernels: csrc/growing.cu, the rounds loop; then
                           csrc/rounds.cu, the round sums, fits, gates,
                           slots and cell labels)
  4. adjacency + merge    (kernel: csrc/merge.cu, one launch)
  5. pixel labels         (kernel: csrc/labels.cu, one launch, in the entry's
                           output dtype)
  6. RANSAC refinement    (kernels: csrc/sampling.cu, the hypotheses and the
                           loop's first state in two launches, a sort and
                           the fits; then
                           csrc/ransac.cu scores each chunk; the final inlier
                           pass is stage 5's launch; config.ransac_refinement)
``extract_primitives`` adds cylinders (plain ops, ops/cylinder.py) fitted to
the growing rounds that failed the plane gates. The stages call the kernel
wrappers of ``kernels/``, which run the kernel for tensors on the card and
the plain twin of ``ops/`` for tensors on the CPU. On the card the path
runs in float32 with TF32 off, and nothing between the upload and the
label download waits for the device.

The ``*_jit`` functions are the compiled entry points, under the JAX
package's names: each records its eager counterpart's stages, stage 6
included, as one CUDA graph per call signature and replays it
(``compiled``); the camera's intrinsics are an input of the graph, so one
graph serves every camera. The eager functions stay for the tests and the
stage-by-stage tools.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from deplex_tpu_torch import compiled, kernels
from deplex_tpu_torch.config import Config
from deplex_tpu_torch.ops.cellstats import camera_params, patch_size
from deplex_tpu_torch.ops.growing import CellGrid, PlaneSegments
from deplex_tpu_torch.ops.ransac import default_draws, refine_cells
from deplex_tpu_torch.profiling import annotate


def resolve_device(device=None) -> torch.device:
    """An entry point's ``device`` argument: the given one, else the card.
    Raises when none is given and there is no card: the plain twins run on
    the CPU only when the caller asks for them with ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("deplex_tpu_torch: no CUDA device (torch.cuda.is_available() "
                           "is False); pass device=\"cpu\" to run the plain PyTorch "
                           "twins on the CPU")
    return torch.device("cuda")


# The fp32_precision settings of torch's precision API, in the order they
# are restored: each backend's "all" before its operations.
_PRECISION_SETTINGS = (torch.backends, torch.backends.cudnn, torch.backends.cuda.matmul,
                       torch.backends.cudnn.conv, torch.backends.cudnn.rnn,
                       torch.backends.mkldnn, torch.backends.mkldnn.matmul,
                       torch.backends.mkldnn.conv, torch.backends.mkldnn.rnn)


def _read_legacy(getter):
    """A legacy TF32 flag, or None where torch refuses to read it (the
    caller set it through the newer fp32_precision API too, and the two
    disagree)."""
    try:
        return getter()
    except RuntimeError:
        return None


@contextlib.contextmanager
def full_float32(device):
    """Inside, float32 matrix products and convolutions on a CUDA `device`
    run without TF32 (region_sums, the BA and pose-graph solves are
    products); the caller's settings come back on exit, exceptions
    included. A CPU device changes nothing.

    torch has two APIs for these flags, the legacy ``allow_tf32`` /
    ``set_float32_matmul_precision`` and the per-backend ``fp32_precision``,
    and refuses to read a legacy flag that disagrees with the newer one.
    Inside, both say "no TF32", so cuBLAS and cuDNN read a consistent state.
    On exit the legacy values are restored first (their setters also write
    the newer settings), then every ``fp32_precision`` as it was. Restoring
    while kernels are still queued is correct: cuBLAS takes its math mode
    when an operation is dispatched on the host."""
    if torch.device(device).type != "cuda":
        yield
        return
    saved = [s.fp32_precision for s in _PRECISION_SETTINGS]
    matmul = _read_legacy(torch.get_float32_matmul_precision)
    cudnn = _read_legacy(lambda: torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for s in (torch.backends.cuda.matmul, torch.backends.cudnn.conv, torch.backends.cudnn.rnn):
        s.fp32_precision = "ieee"
    try:
        yield
    finally:
        if matmul is not None:
            torch.set_float32_matmul_precision(matmul)
        if cudnn is not None:
            torch.backends.cudnn.allow_tf32 = cudnn
        for s, value in zip(_PRECISION_SETTINGS, saved):
            s.fp32_precision = value


def depth_tensor(depth, device) -> torch.Tensor:
    """uint16 depth (numpy or tensor) -> a uint16 tensor on `device`.

    The transfer goes through an int16 view of the same bytes, since uint16
    tensors support few operations; it is the ``io.upload`` span."""
    with annotate("io.upload"):
        if isinstance(depth, torch.Tensor):
            if depth.dtype != torch.uint16:
                raise ValueError(f"depth must be uint16, got {depth.dtype}")
            return depth.view(torch.int16).to(device).view(torch.uint16)
        arr = np.ascontiguousarray(depth)
        if arr.dtype != np.uint16:
            raise ValueError(f"depth must be uint16, got {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16)).to(device).view(torch.uint16)


def intrinsics_tensor(K, device) -> torch.Tensor:
    """3x3 intrinsics (numpy or tensor) as a float32 tensor on `device`: K1
    and the back-projection read them there, and a compiled entry point
    takes them as an input of its graph. A K from the host (numpy, or a
    tensor on another device) is copied inside an ``io.upload`` span."""
    if isinstance(K, torch.Tensor) and K.device == torch.device(device):
        return K.detach().to(dtype=torch.float32).reshape(3, 3)
    with annotate("io.upload"):
        if isinstance(K, torch.Tensor):
            return K.detach().to(device=device, dtype=torch.float32).reshape(3, 3)
        return torch.as_tensor(np.asarray(K, np.float32).reshape(3, 3), device=device)


def backproject_device(depth: torch.Tensor, intrinsics) -> torch.Tensor:
    """(..., H, W) depth -> (..., H*W, 3) float32 organized clouds on depth's
    device: x = (u - cx) / fx * z, y = (v - cy) / fy * z.

    fx, fy, cx and cy are 0-d tensors on the depth's device, read from K
    there (a K already on that device is no copy, so a CUDA graph records
    it); the divisions by them round as the kernels' true division does."""
    H, W = depth.shape[-2:]
    fx, fy, cx, cy = camera_params(intrinsics_tensor(intrinsics, depth.device)).unbind()
    if depth.dtype == torch.uint16:
        depth = depth.view(torch.int16).to(torch.int32) & 0xFFFF
    z = depth.to(torch.float32)
    u = (torch.arange(W, dtype=torch.float32, device=depth.device)[None, :] - cx) / fx
    v = (torch.arange(H, dtype=torch.float32, device=depth.device)[:, None] - cy) / fy
    return torch.stack([u * z, v * z, z], dim=-1).reshape(*depth.shape[:-2], H * W, 3)


def compute_cells(src: torch.Tensor, K: torch.Tensor | None, config: Config) -> CellGrid:
    """Stages 1-2 for a batch: (B, H, W) depth + K, or (B, H, W, 3) points;
    the moments kernel, then the cell-finalize kernel (eigensolve, gates,
    normal bins, packed edges). Returns the CellGrid stage 3 takes."""
    H, W = src.shape[1], src.shape[2]
    with annotate("cell_grid"):
        return kernels.cellfinal.cell_finalize(
            kernels.cellstats.cell_moment_planes(src, K, config),
            patch_size(H, W, config), config)


def grow_regions(cells: CellGrid, config: Config):
    """Stage 3: the rounds-loop kernel, then the round-finalize kernel.
    Returns (RoundData, labels_map, PlaneSegments)."""
    round_map, seeds, nr_rounds = kernels.growing.grow_rounds(cells, config)
    return kernels.rounds.round_finalize(round_map, seeds, nr_rounds, cells.stats, config)


def grow_planes(cells: CellGrid, config: Config):
    """Stage 3 (``grow_regions``) of a CellGrid -> (labels_map,
    PlaneSegments)."""
    with annotate("region_growing"):
        return grow_regions(cells, config)[1:]


def merge_planes(labels_map: torch.Tensor, segments: PlaneSegments, config: Config):
    """Stage 4: the adjacency and the greedy merge, one kernel launch.
    Returns (merge_labels, merged PlaneSegments)."""
    with annotate("merge"):
        return kernels.merge.merge_planes(labels_map, segments, config)


def merge_stage(labels_map: torch.Tensor, segments, config: Config) -> torch.Tensor:
    """Stage 4: (B, gh, gw) labels + PlaneSegments -> (B, MAXP) merge_labels."""
    merge_labels, _ = merge_planes(labels_map, segments, config)
    return merge_labels


class PlaneCells(NamedTuple):
    """Stages 1-4's outputs for a batch: what stages 5 and 6 take."""
    labels_map: torch.Tensor            # (B, gh, gw) int32 cell labels (round finalize)
    merge_labels: torch.Tensor          # (B, MAXP) int32 representative slots (stage 4)
    points: torch.Tensor | None = None  # (B, H*W, 3) float32 stage 6 scores, if configured


def stages_3_4(cells: CellGrid, config: Config,
               points: torch.Tensor | None = None) -> PlaneCells:
    """Stages 3-4 on a batch's CellGrid, with the points stage 6 scores
    (None without config.ransac_refinement)."""
    labels_map, segments = grow_planes(cells, config)
    return PlaneCells(labels_map, merge_stage(labels_map, segments, config), points)


def write_labels(planes: PlaneCells, image_height: int, image_width: int, config: Config,
                 dtype: torch.dtype = torch.int32, refine=None) -> torch.Tensor:
    """Stage 5: (B, H*W) pixel labels in `dtype`, one launch of the labels
    kernel (``kernels.labels.pixel_labels``); with `refine`, stage 6's
    (points, hyp, best_k, threshold), its final inlier pass in the same
    launch (the kernel reads each plane's winner, hyp at best_k)."""
    with annotate("labels"):
        return kernels.labels.pixel_labels(
            planes.labels_map, planes.merge_labels, image_height, image_width,
            patch_size(image_height, image_width, config), dtype, refine=refine)


def labels_from_stats(cells: CellGrid, image_height: int, image_width: int,
                      config: Config, points: torch.Tensor | None = None) -> torch.Tensor:
    """Stages 3-5 for a batch: CellGrid -> (B, H*W) int32 labels; with
    config.ransac_refinement also stage 6, on the (B, H*W, 3) points."""
    return refine_stage(stages_3_4(cells, config, points), image_height, image_width,
                        config)[0]


def plane_stages(src: torch.Tensor, K: torch.Tensor | None, config: Config) -> PlaneCells:
    """Stages 1-4 of a batch, and the points stage 6 takes (``stages_3_4``).

    src: (B, H, W) uint16 depth with its 3x3 K on the same device, or (B,
    H, W, 3) float32 points with K None; with config.ransac_refinement,
    stage 6's points are src's, or the depth's back-projected on the device.
    Nothing here waits for the device, so a compiled entry point records
    all of it in one graph."""
    B, H, W = src.shape[:3]
    cells = compute_cells(src.contiguous(), K, config)
    points = None
    if config.ransac_refinement:
        points = src.reshape(B, H * W, 3) if K is None else backproject_device(src, K)
    return stages_3_4(cells, config, points)


def refine_stage(planes: PlaneCells, image_height: int, image_width: int, config: Config,
                 dtype: torch.dtype = torch.int32, raw: torch.Tensor | None = None):
    """Stages 5 and 6 on ``plane_stages``' outputs: (B, H*W) labels in
    `dtype`, and the chunks scored per frame (B,) int32, or None without
    config.ransac_refinement. Stage 6 samples on the merged cell labels in
    two launches of ``csrc/sampling.cu``; each chunk is scored and its
    early-exit update applied by the kernel of ``csrc/ransac.cu`` (their
    twins on the CPU); where calls are recorded (a
    card) the loop runs its fixed number of chunks with the early exit on
    the device, elsewhere it stops on a host check. Its final pass is the
    labels kernel's, on the cell labels: stage 5's labels are never written
    first. raw: the (MAXP, K, 3) raw numbers of the default draws
    (``ops.ransac.default_draws`` when None)."""
    if not config.ransac_refinement:
        return write_labels(planes, image_height, image_width, config, dtype), None
    points = planes.points
    with annotate("refinement"):
        return refine_cells(
            points, None, planes.labels_map, image_width,
            patch_size(image_height, image_width, config), config,
            merge_labels=planes.merge_labels, sample=kernels.sampling.sample,
            step=kernels.ransac.chunk_step, raw=raw, fixed_trip=compiled.captures(points.device),
            write=lambda *refine: write_labels(planes, image_height, image_width, config, dtype,
                                               refine))


def check_patch(image_height: int, image_width: int, config: Config) -> None:
    """Raise the reference's error for a cell side of 0."""
    if patch_size(image_height, image_width, config) == 0:
        raise ValueError(
            f"Error! Invalid config parameter: patchSize({config.patch_size})."
            " patchSize has to be positive.")


def cloud_batch(points: torch.Tensor, image_height: int, image_width: int) -> torch.Tensor:
    """(..., H*W, 3) organized clouds -> (B, H, W, 3) contiguous float32."""
    return points.to(torch.float32).reshape(-1, image_height, image_width, 3).contiguous()


def graph_inputs(inputs: tuple, config: Config) -> tuple:
    """A compiled plane entry's graph inputs: its own, then with stage 6 the
    default stream's raw draws (a cached tensor; as an input, the graph
    keeps its own copy)."""
    if not config.ransac_refinement:
        return tuple(inputs)
    return (*inputs, default_draws(config, inputs[0].device))


def compiled_planes(entry: str, stages, inputs: tuple, static, image_height: int,
                    image_width: int, config: Config, dtype: torch.dtype = torch.int32):
    """A compiled plane entry point: ``stages(*inputs)`` (its ``plane_stages``
    call), then stages 5 and 6 writing `dtype` labels, as one function
    through ``compiled.call`` with the static key `static` (recorded and
    replayed on a card, run as it is on the CPU) inside an ``entry`` span.
    Returns (labels, chunks scored per frame or None)."""
    ransac = config.ransac_refinement

    def fn(*args):
        raw = args[-1] if ransac else None
        return refine_stage(stages(*(args[:-1] if ransac else args)), image_height,
                            image_width, config, dtype, raw)
    with annotate("entry"):
        inputs = graph_inputs(inputs, config)
        with full_float32(inputs[0].device):
            return compiled.call(entry, fn, inputs, static)


def extract_planes(points: torch.Tensor, *, image_height: int, image_width: int,
                   config: Config) -> torch.Tensor:
    """points: (H*W, 3) organized cloud -> (H*W,) int32 labels (0 = none)."""
    check_patch(image_height, image_width, config)
    with full_float32(points.device):
        out = plane_stages(cloud_batch(points, image_height, image_width), None, config)
        return refine_stage(out, image_height, image_width, config)[0][0]


def extract_planes_jit(points: torch.Tensor, *, image_height: int, image_width: int,
                       config: Config) -> torch.Tensor:
    """``extract_planes`` as one CUDA graph per signature (``compiled``),
    stage 6 included: the counterpart of the JAX package's
    ``extract_planes_jit``. On the CPU it runs ``extract_planes``' stages."""
    check_patch(image_height, image_width, config)
    return compiled_planes(
        "extract_planes_jit",
        lambda p: plane_stages(cloud_batch(p, image_height, image_width), None, config),
        (points,), (image_height, image_width, config), image_height, image_width,
        config)[0][0]


def extract_planes_from_depth(depth: torch.Tensor, intrinsics, *,
                              config: Config) -> torch.Tensor:
    """(H, W) uint16 depth + 3x3 intrinsics -> (H*W,) int32 labels.

    Stage 1 reads the depth map itself; the point cloud is never formed."""
    from deplex_tpu_torch.parallel.batch import extract_depth_batch

    return extract_depth_batch(depth[None], intrinsics, config)[0]


def extract_planes_from_depth_jit(depth: torch.Tensor, intrinsics, *,
                                  config: Config) -> torch.Tensor:
    """``extract_planes_from_depth`` as one CUDA graph per signature
    (``compiled``), stage 6 included; the intrinsics are a graph input, so
    every camera replays the same graph: the counterpart of the JAX
    package's ``extract_planes_from_depth_jit``. On the CPU it runs
    ``extract_planes_from_depth``' stages."""
    H, W = depth.shape
    check_patch(H, W, config)
    return compiled_planes("extract_planes_from_depth_jit",
                           lambda d, k: plane_stages(d[None], k, config),
                           (depth, intrinsics_tensor(intrinsics, depth.device)),
                           (H, W, config), H, W, config)[0][0]


def _unbatch(x):
    """First frame of a batched NamedTuple (0-d fields kept)."""
    return type(x)(*[f[0] if f.dim() > 0 else f for f in x])


def extract_primitives(points: torch.Tensor, *, image_height: int, image_width: int,
                       config: Config) -> dict:
    """Planes and cylinders of one (H*W, 3) organized cloud (CAPE's full
    primitive set). Returns a dict:
      plane_labels    (H*W,) int32 -- as extract_planes, 0 where a cylinder won
      cylinder_labels (H*W,) int32 -- cylinder ids, 0 = none
      cylinders       CylinderSegments of the frame (no batch axis)
    The candidates are the growing rounds that failed the plane gates, so
    stages 1-3 (K1, K2) run once for both primitives; stage 4 is K3."""
    check_patch(image_height, image_width, config)
    with full_float32(points.device):
        return primitive_stages(points, image_height, image_width, config)


def extract_primitives_jit(points: torch.Tensor, *, image_height: int, image_width: int,
                           config: Config) -> dict:
    """``extract_primitives`` as one CUDA graph per signature (``compiled``),
    the cylinder stage included: the counterpart of the JAX package's
    ``extract_primitives_jit``. On the CPU it runs ``extract_primitives``'
    stages."""
    check_patch(image_height, image_width, config)
    with full_float32(points.device):
        return compiled.call(
            "extract_primitives_jit",
            lambda p: primitive_stages(p, image_height, image_width, config), (points,),
            (image_height, image_width, config))


def primitive_stages(points: torch.Tensor, image_height: int, image_width: int,
                     config: Config) -> dict:
    """``extract_primitives``' stages, in the caller's precision scope."""
    from deplex_tpu_torch.ops.cylinder import extract_cylinders

    H, W = image_height, image_width
    pts = cloud_batch(points, H, W)
    cells = compute_cells(pts, None, config)
    with annotate("region_growing"):
        rounds, labels_map, segments = grow_regions(cells, config)
    merge_labels = merge_stage(labels_map, segments, config)
    with annotate("cylinders"):
        cyl_map, cylinders = extract_cylinders(cells.stats, rounds, config)
    ident = torch.arange(config.max_cylinders, dtype=torch.int32,
                         device=pts.device).expand(1, -1)
    # A region a cylinder explains is not a plane (CAPE keeps the primitive
    # of lower residual). Masked on the cells: both maps label whole cells
    # of the same P and remainder, so this is the pixels' mask.
    planes = PlaneCells(torch.where(cyl_map > 0, torch.zeros_like(labels_map), labels_map),
                        merge_labels)
    plane_labels = write_labels(planes, H, W, config)
    cyl_labels = write_labels(PlaneCells(cyl_map, ident), H, W, config)
    return {"plane_labels": plane_labels[0], "cylinder_labels": cyl_labels[0],
            "cylinders": _unbatch(cylinders)}


def extract_planes_debug(points: torch.Tensor, *, image_height: int,
                         image_width: int, config: Config) -> dict:
    """Single-frame pipeline returning its intermediates, with the keys of
    the reference package's extract_planes_debug (stages 1-5)."""
    check_patch(image_height, image_width, config)
    with full_float32(points.device):
        pts = points.to(torch.float32).reshape(1, image_height, image_width, 3).contiguous()
        cells = compute_cells(pts, None, config)
        labels_map, segments = grow_planes(cells, config)
        merge_labels, merged = merge_planes(labels_map, segments, config)
        labels = write_labels(PlaneCells(labels_map, merge_labels), image_height,
                              image_width, config)
        return {"stats": _unbatch(cells.stats), "labels_map": labels_map[0],
                "segments": _unbatch(segments), "merge_labels": merge_labels[0],
                "merged": _unbatch(merged), "labels": labels[0]}
