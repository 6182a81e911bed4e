"""Frame-batched plane extraction: the serving form of the main path.

Port of ``deplex_tpu.parallel.batch``. Every stage takes the whole batch at
once: the growing and merge kernels run one block per frame, so frames
retire on their own. ``ShardedPlaneExtractor`` splits a batch over the ranks
of a ``torch.distributed`` mesh. ``BatchDepthExtractor.process_stream`` keeps
several batches in flight: uploads from pinned host buffers, compute and
label downloads are queued on the current stream, and a CUDA event per
batch says when its labels are on the host.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.parallel.distributed import all_gather_cat, local_batch_slice, make_mesh
from deplex_tpu_torch.pipeline import (backproject_device, check_patch, compute_cell_stats,
                                       depth_tensor, full_float32, intrinsics_tensor,
                                       labels_from_stats, resolve_device)


def extract_depth_batch(depth_batch: torch.Tensor, intrinsics, config: Config) -> torch.Tensor:
    """(B, H, W) uint16 depth + 3x3 K -> (B, H*W) int32 labels, on the
    depth's device. Stage 1 reads the depth maps; stage 6 (RANSAC), when
    configured, scores the back-projected points."""
    B, H, W = depth_batch.shape
    check_patch(H, W, config)
    K = intrinsics_tensor(intrinsics)
    with full_float32(depth_batch.device):
        stats = compute_cell_stats(depth_batch.contiguous(), K, config)
        points = backproject_device(depth_batch, K) if config.ransac_refinement else None
        return labels_from_stats(stats, H, W, config, points)


def extract_planes_batch(points: torch.Tensor, *, image_height: int, image_width: int,
                         config: Config) -> torch.Tensor:
    """(B, H*W, 3) organized clouds -> (B, H*W) int32 labels."""
    check_patch(image_height, image_width, config)
    B = points.shape[0]
    with full_float32(points.device):
        pts = points.to(torch.float32).reshape(B, image_height, image_width, 3).contiguous()
        stats = compute_cell_stats(pts, None, config)
        return labels_from_stats(stats, image_height, image_width, config,
                                 pts.reshape(B, -1, 3))


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
        labels = extract_depth_batch(d, intrinsics, self._config)
        return labels.to(torch.uint8).cpu().numpy()

    def process_stream(self, depth_batches, intrinsics, max_in_flight: int = 4):
        """Yield (B, H*W) uint8 label arrays for an iterable of depth batches,
        in order, with up to max_in_flight batches queued on the card."""
        if self._device.type != "cuda":
            for d in depth_batches:
                yield self.process(d, intrinsics)
            return
        in_flight = collections.deque()
        for d in depth_batches:
            arr = np.ascontiguousarray(d)
            self._check(arr.shape)
            if arr.dtype != np.uint16:
                raise ValueError(f"depth must be uint16, got {arr.dtype}")
            host_in = torch.empty(arr.shape, dtype=torch.int16, pin_memory=True)
            host_in.copy_(torch.from_numpy(arr.view(np.int16)))
            dev_in = host_in.to(self._device, non_blocking=True).view(torch.uint16)
            labels = extract_depth_batch(dev_in, intrinsics, self._config).to(torch.uint8)
            host_out = torch.empty(labels.shape, dtype=torch.uint8, pin_memory=True)
            host_out.copy_(labels, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
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
        labels = extract_planes_batch(pts, image_height=self._height,
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
        labels = extract_planes_batch(local, image_height=self._height,
                                      image_width=self._width, config=self._config)
        return all_gather_cat(labels, self._mesh.get_group("data")).cpu().numpy()
