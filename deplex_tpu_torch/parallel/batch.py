"""Frame-batched plane extraction: the serving form of the main path.

Port of ``deplex_tpu.parallel.batch``. Every stage takes the whole batch at
once: the growing and merge kernels run one block per frame, so frames
retire on their own. ``ShardedPlaneExtractor`` splits a batch over the ranks
of a ``torch.distributed`` mesh. ``BatchDepthExtractor.process_stream`` keeps
several batches in flight: uploads from pinned host buffers, compute and
label downloads are queued on the current stream, and a CUDA event per
batch says when its labels are on the host. The extractors call the
compiled counterparts (``extract_depth_batch_jit``,
``extract_planes_batch_jit``: one CUDA graph per signature, ``compiled``)
where the JAX package calls its jitted programs.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from deplex_tpu_torch import compiled
from deplex_tpu_torch.config import Config
from deplex_tpu_torch.parallel.distributed import all_gather_cat, local_batch_slice, make_mesh
from deplex_tpu_torch.pipeline import (check_patch, cloud_batch, compiled_planes, depth_tensor,
                                       full_float32, graph_inputs, intrinsics_tensor,
                                       plane_stages, refine_stage, resolve_device)


def extract_depth_batch(depth_batch: torch.Tensor, intrinsics, config: Config) -> torch.Tensor:
    """(B, H, W) uint16 depth + 3x3 K -> (B, H*W) int32 labels, on the
    depth's device. Stage 1 reads the depth maps; stage 6 (RANSAC), when
    configured, scores the back-projected points."""
    B, H, W = depth_batch.shape
    check_patch(H, W, config)
    K = intrinsics_tensor(intrinsics, depth_batch.device)
    with full_float32(depth_batch.device):
        return refine_stage(plane_stages(depth_batch, K, config), H, W, config)[0]


def extract_depth_batch_jit(depth_batch: torch.Tensor, intrinsics, *,
                            config: Config) -> torch.Tensor:
    """``extract_depth_batch`` with uint8 labels (max_planes <= 255) as one
    CUDA graph per signature (``compiled``), stage 6 included; the labels
    kernel writes the uint8 labels itself:
    the counterpart of the JAX package's ``extract_depth_batch_jit``, the
    serving path. The intrinsics are a graph input, so every camera replays
    the same graph. On the CPU it runs ``extract_depth_batch``' stages."""
    return depth_batch_call(depth_batch, intrinsics_tensor(intrinsics, depth_batch.device),
                            config)[0]


DEPTH_BATCH_ENTRY = "extract_depth_batch_jit"


def depth_batch_call(depth_batch: torch.Tensor, K: torch.Tensor, config: Config):
    """``extract_depth_batch_jit``'s compiled call on a 3x3 K on the depth's
    device: ((B, H*W) uint8 labels, (B,) int32 RANSAC chunks scored per
    frame, or None without stage 6)."""
    B, H, W = depth_batch.shape
    check_patch(H, W, config)
    return compiled_planes(DEPTH_BATCH_ENTRY, lambda d, k: plane_stages(d, k, config),
                           (depth_batch, K), (H, W, config), H, W, config, torch.uint8)


def depth_batch_graph(shape, config: Config, device) -> compiled.Graph | None:
    """The graph ``extract_depth_batch_jit`` recorded for a (B, H, W) uint16
    batch of this shape on `device` with this config, if any (one for every
    camera). Its outputs are ``depth_batch_call``'s."""
    specs = [compiled.spec_of(shape, torch.uint16, device),
             compiled.spec_of((3, 3), torch.float32, device)]
    if config.ransac_refinement:
        specs.append(compiled.spec_of((config.max_planes, config.ransac_max_iterations, 3),
                                      torch.int64, device))
    return compiled.lookup(DEPTH_BATCH_ENTRY, (shape[1], shape[2], config), specs)


def extract_planes_batch(points: torch.Tensor, *, image_height: int, image_width: int,
                         config: Config) -> torch.Tensor:
    """(B, H*W, 3) organized clouds -> (B, H*W) int32 labels."""
    check_patch(image_height, image_width, config)
    with full_float32(points.device):
        out = plane_stages(cloud_batch(points, image_height, image_width), None, config)
        return refine_stage(out, image_height, image_width, config)[0]


def extract_planes_batch_jit(points: torch.Tensor, *, image_height: int, image_width: int,
                             config: Config) -> torch.Tensor:
    """``extract_planes_batch`` as one CUDA graph per signature
    (``compiled``), stage 6 included: the counterpart of the JAX package's
    ``extract_planes_batch_jit``. On the CPU it runs
    ``extract_planes_batch``' stages."""
    check_patch(image_height, image_width, config)
    return compiled_planes(
        "extract_planes_batch_jit",
        lambda p: plane_stages(cloud_batch(p, image_height, image_width), None, config),
        (points,), (image_height, image_width, config), image_height, image_width,
        config)[0]


class BatchDepthExtractor:
    """Batched depth-map extractor; ``process_stream`` pipelines batches."""

    def __init__(self, image_height: int, image_width: int,
                 config: Config | None = None, batch: int = 8, device=None):
        self._height = int(image_height)
        self._width = int(image_width)
        self._config = config if config is not None else Config()
        self._batch = int(batch)
        self._device = resolve_device(device)

    @property
    def batch(self) -> int:
        return self._batch

    @property
    def device(self) -> torch.device:
        return self._device

    def _check(self, shape) -> None:
        if len(shape) != 3 or tuple(shape[1:]) != (self._height, self._width):
            raise ValueError(f"Expected (B, {self._height}, {self._width}) depth "
                             f"batch, got {tuple(shape)}")

    def process(self, depth_batch, intrinsics) -> np.ndarray:
        """(B, H, W) uint16 depth -> (B, H*W) uint8 labels (max_planes <= 255)."""
        self._check(np.shape(depth_batch))
        d = depth_tensor(depth_batch, self._device)
        return extract_depth_batch_jit(d, intrinsics, config=self._config).cpu().numpy()

    def process_stream(self, depth_batches, intrinsics, max_in_flight: int = 4):
        """Yield (B, H*W) uint8 label arrays for an iterable of depth batches,
        in order, with up to max_in_flight batches queued on the card.

        Once ``extract_depth_batch_jit`` has recorded the batch's graph (with
        stage 6 too), each batch is, on the current stream: the upload from
        a pinned buffer into the graph's static input, the replay, the
        download of its static labels into a pinned buffer, and an event.
        Stream order keeps a queued download ahead of the next batch's
        upload and replay. The intrinsics go to the card once."""
        if self._device.type != "cuda":
            for d in depth_batches:
                yield self.process(d, intrinsics)
            return
        cfg = self._config
        K = intrinsics_tensor(intrinsics, self._device)
        stream = torch.cuda.current_stream(self._device)
        in_flight = collections.deque()
        for d in depth_batches:
            arr = np.ascontiguousarray(d)
            self._check(arr.shape)
            if arr.dtype != np.uint16:
                raise ValueError(f"depth must be uint16, got {arr.dtype}")
            host_in = torch.empty(arr.shape, dtype=torch.int16, pin_memory=True)
            host_in.copy_(torch.from_numpy(arr.view(np.int16)))
            graph = depth_batch_graph(arr.shape, cfg, self._device)
            if graph is None:
                dev_in = host_in.to(self._device, non_blocking=True).view(torch.uint16)
                labels = depth_batch_call(dev_in, K, cfg)[0]
            else:
                graph.load(graph_inputs((host_in.view(torch.uint16), K), cfg),
                           non_blocking=True)
                graph.replay()
                labels = graph.outputs[0]       # the static labels; downloaded below
            host_out = torch.empty(labels.shape, dtype=torch.uint8, pin_memory=True)
            host_out.copy_(labels, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
            in_flight.append((done, host_out, host_in))
            if len(in_flight) >= max_in_flight:
                yield self._collect(in_flight.popleft())
        while in_flight:
            yield self._collect(in_flight.popleft())

    @staticmethod
    def _collect(entry) -> np.ndarray:
        done, host_out, _ = entry
        done.synchronize()
        return host_out.numpy().copy()


class BatchPlaneExtractor:
    """Batched extractor for organized point clouds: B frames per call."""

    def __init__(self, image_height: int, image_width: int,
                 config: Config | None = None, device=None):
        self._height = int(image_height)
        self._width = int(image_width)
        self._config = config if config is not None else Config()
        self._device = resolve_device(device)

    def process(self, pcd_batch) -> np.ndarray:
        pts = torch.as_tensor(np.asarray(pcd_batch, dtype=np.float32), device=self._device)
        if pts.dim() != 3 or pts.shape[2] != 3 or pts.shape[1] != self._height * self._width:
            raise ValueError(
                f"Expected (B, {self._height * self._width}, 3) batch, got {tuple(pts.shape)}")
        labels = extract_planes_batch_jit(pts, image_height=self._height,
                                          image_width=self._width, config=self._config)
        return labels.cpu().numpy()


class ShardedPlaneExtractor:
    """Data-parallel extractor: the frame batch split over the 'data' ranks
    of a DeviceMesh (default: a 1-D mesh over the initialized world).

    Every rank calls ``process`` with the whole batch, extracts its own
    slice (``distributed.local_batch_slice``) on its own device, and gets
    the whole (B, H*W) int32 labels back (gathered over the ranks). The
    batch must divide by the mesh's 'data' size."""

    def __init__(self, image_height: int, image_width: int,
                 config: Config | None = None, mesh=None, device=None):
        self._height = int(image_height)
        self._width = int(image_width)
        self._config = config if config is not None else Config()
        self._mesh = mesh if mesh is not None else make_mesh("data")
        self._device = resolve_device(device)

    @property
    def mesh(self):
        return self._mesh

    def process(self, pcd_batch) -> np.ndarray:
        pts = np.asarray(pcd_batch, dtype=np.float32)
        if pts.ndim != 3 or pts.shape[2] != 3 or pts.shape[1] != self._height * self._width:
            raise ValueError(
                f"Expected (B, {self._height * self._width}, 3) batch, got {pts.shape}")
        start, size = local_batch_slice(pts.shape[0], self._mesh, "data")
        local = torch.from_numpy(pts[start:start + size]).to(self._device)
        labels = extract_planes_batch_jit(local, image_height=self._height,
                                          image_width=self._width, config=self._config)
        return all_gather_cat(labels, self._mesh.get_group("data")).cpu().numpy()
