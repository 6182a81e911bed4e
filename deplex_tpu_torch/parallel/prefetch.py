"""Host-side input pipeline: decode depth PNGs ahead of the device.

Port of ``deplex_tpu.parallel.prefetch``. A small thread pool decodes frames
ahead (through ``deplex_tpu_torch.native``, whose calls release the
interpreter lock) while the card works on earlier ones; frames come out in
the order of the paths.
"""

from __future__ import annotations

import concurrent.futures as _fut
from typing import Iterator, Sequence

import numpy as np

from deplex_tpu_torch.utils.depth_image import _load_png16


def iter_depth_frames(paths: Sequence[str], *, workers: int = 2,
                      prefetch: int = 4) -> Iterator[np.ndarray]:
    """Yield (H, W) uint16 depth maps, up to `prefetch` decoding ahead."""
    with _fut.ThreadPoolExecutor(max_workers=workers) as pool:
        it = iter(paths)
        # range first: zip stops on it without drawing a path it would drop.
        pending = [pool.submit(_load_png16, str(p)) for _, p in zip(range(prefetch), it)]
        while pending:
            fut = pending.pop(0)
            p = next(it, None)
            if p is not None:
                pending.append(pool.submit(_load_png16, str(p)))
            yield fut.result()


def iter_depth_batches(paths: Sequence[str], batch: int, *, workers: int = 2,
                       prefetch: int = 8) -> Iterator[np.ndarray]:
    """Yield (B, H, W) uint16 batches; the last is padded by repeating its
    last frame."""
    buf = []
    for frame in iter_depth_frames(paths, workers=workers, prefetch=prefetch):
        buf.append(frame)
        if len(buf) == batch:
            yield np.stack(buf)
            buf = []
    if buf:
        buf += [buf[-1]] * (batch - len(buf))
        yield np.stack(buf)
