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
                                       full_float32, intrinsics_key, intrinsics_tensor,
                                       plane_stages, refine_stage, resolve_device)


def extract_depth_batch(depth_batch: torch.Tensor, intrinsics, config: Config) -> torch.Tensor:
    """(B, H, W) uint16 depth + 3x3 K -> (B, H*W) int32 labels, on the
    depth's device. Stage 1 reads the depth maps; stage 6 (RANSAC), when
    configured, scores the back-projected points."""
    B, H, W = depth_batch.shape
    check_patch(H, W, config)
    K = intrinsics_tensor(intrinsics)
    with full_float32(depth_batch.device):
        return refine_stage(*plane_stages(depth_batch, K, config), H, W, config)


def extract_depth_batch_jit(depth_batch: torch.Tensor, intrinsics, *,
                            config: Config) -> torch.Tensor:
    """``extract_depth_batch`` with uint8 labels (max_planes <= 255) as one
    CUDA graph per signature and camera (``compiled``): the counterpart of
    the JAX package's ``extract_depth_batch_jit``, the serving path. With
    config.ransac_refinement the graph holds the back-projection and stages
    1-5, and stage 6 runs eagerly. On the CPU it runs
    ``extract_depth_batch``' stages."""
    B, H, W = depth_batch.shape
    check_patch(H, W, config)
    K = intrinsics_tensor(intrinsics)

    def stages(d):
        # Without stage 6 the uint8 cast is recorded too.
        labels, cell_labels, points = plane_stages(d, K, config)
        return (labels.to(torch.uint8) if cell_labels is None else labels), cell_labels, points
    return compiled_planes(DEPTH_BATCH_ENTRY, depth_batch, stages,
                           _depth_batch_static(depth_batch.shape, K, config),
                           H, W, config).to(torch.uint8)


DEPTH_BATCH_ENTRY = "extract_depth_batch_jit"


def _depth_batch_static(shape, K: torch.Tensor, config: Config) -> tuple:
    """What ``extract_depth_batch_jit``'s graph freezes besides its input:
    the image size, the config and the camera (a host K)."""
    return shape[1], shape[2], config, intrinsics_key(K)


def depth_batch_graph(shape, intrinsics, config: Config, device) -> compiled.Graph | None:
    """The graph ``extract_depth_batch_jit`` recorded for a (B, H, W) uint16
    batch of this shape on `device` with these intrinsics and config, if any."""
    return compiled.lookup(DEPTH_BATCH_ENTRY,
                           _depth_batch_static(shape, intrinsics_tensor(intrinsics), config),
                           [compiled.spec_of(shape, torch.uint16, device)])


def extract_planes_batch(points: torch.Tensor, *, image_height: int, image_width: int,
                         config: Config) -> torch.Tensor:
    """(B, H*W, 3) organized clouds -> (B, H*W) int32 labels."""
    check_patch(image_height, image_width, config)
    with full_float32(points.device):
        out = plane_stages(cloud_batch(points, image_height, image_width), None, config)
        return refine_stage(*out, image_height, image_width, config)


def extract_planes_batch_jit(points: torch.Tensor, *, image_height: int, image_width: int,
                             config: Config) -> torch.Tensor:
    """``extract_planes_batch`` as one CUDA graph per signature
    (``compiled``): the counterpart of the JAX package's
    ``extract_planes_batch_jit``. With config.ransac_refinement the graph
    holds stages 1-5 and stage 6 runs eagerly. On the CPU it runs
    ``extract_planes_batch``' stages."""
    check_patch(image_height, image_width, config)
    return compiled_planes(
        "extract_planes_batch_jit", points,
        lambda p: plane_stages(cloud_batch(p, image_height, image_width), None, config),
        (image_height, image_width, config), image_height, image_width, config)


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

        Once ``extract_depth_batch_jit`` has recorded the batch's graph, each
        batch is, on the current stream: the upload from a pinned buffer
        into the graph's static input, the replay, the download of its
        static labels into a pinned buffer, and an event. Stream order keeps
        a queued download ahead of the next batch's upload and replay."""
        if self._device.type != "cuda":
            for d in depth_batches:
                yield self.process(d, intrinsics)
            return
        cfg = self._config
        stream = torch.cuda.current_stream(self._device)
        in_flight = collections.deque()
        for d in depth_batches:
            arr = np.ascontiguousarray(d)
            self._check(arr.shape)
            if arr.dtype != np.uint16:
                raise ValueError(f"depth must be uint16, got {arr.dtype}")
            host_in = torch.empty(arr.shape, dtype=torch.int16, pin_memory=True)
            host_in.copy_(torch.from_numpy(arr.view(np.int16)))
            graph = None if cfg.ransac_refinement else depth_batch_graph(
                arr.shape, intrinsics, cfg, self._device)
            if graph is None:
                dev_in = host_in.to(self._device, non_blocking=True).view(torch.uint16)
                labels = extract_depth_batch_jit(dev_in, intrinsics, config=cfg)
            else:
                graph.load((host_in.view(torch.uint16),), non_blocking=True)
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
