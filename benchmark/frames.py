"""The cells' inputs: the bundled depth frame, decoded here, its intrinsics,
and rings of seeded rolls of it made on the device.

The full TUM sequence is not in the repository, so a ring is the one
bundled 640x480 frame rolled by 0-7 rows and columns (the rolls of
``deplex_tpu_torch/tools/_common.py``'s ``rolled_ring``). The 64 offsets
each appear once in every 64 frames, in an order drawn from the run's
seed, so every seed's ring holds the same frames and the same work.
"""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
_PNG = b"\x89PNG\r\n\x1a\n"


def _unfilter_row(ftype: int, line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """One PNG row's bytes with its filter undone."""
    if ftype == 0:
        return line.copy()
    if ftype == 1:
        lanes = line.reshape(-1, bpp).astype(np.uint32)
        return (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
    if ftype == 2:
        return (line.astype(np.uint16) + prior).astype(np.uint8)
    out = np.zeros(len(line), np.int32)
    for i in range(len(line)):       # average and Paeth depend on the byte to the left
        a = int(out[i - bpp]) if i >= bpp else 0
        b = int(prior[i])
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = int(prior[i - bpp]) if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (int(line[i]) + pred) & 0xFF
    return out.astype(np.uint8)


def read_png16(path) -> np.ndarray:
    """A 16-bit grayscale, non-interlaced PNG -> (H, W) uint16."""
    data = pathlib.Path(path).read_bytes()
    if data[:8] != _PNG:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    width, height, depth, color, _, _, interlace = header
    if (depth, color, interlace) != (16, 0, 0):
        raise ValueError(f"{path}: not 16-bit grayscale non-interlaced")
    stride = 2 * width
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(height):
        prior = out[r] = _unfilter_row(int(rows[r, 0]), rows[r, 1:], prior, 2)
    return out.view(">u2").astype(np.uint16)


def rolls(seed: int, n: int, most: int = 8) -> np.ndarray:
    """n (row, column) roll offsets in [0, most): every one of the most**2
    offsets once in each run of most**2 frames, each run in an order drawn
    from `seed`. So every seed gives a ring the same frames (where n is a
    multiple of most**2), in another order: the work of a ring does not move
    with the seed."""
    rng = np.random.default_rng(seed % 2 ** 64)
    grid = np.stack(np.meshgrid(np.arange(most), np.arange(most), indexing="ij"), -1)
    grid = grid.reshape(-1, 2)
    runs = -(-n // len(grid))
    return np.concatenate([grid[rng.permutation(len(grid))] for _ in range(runs)])[:n]


def rolled_ring(base: np.ndarray, n: int, seed: int, device) -> torch.Tensor:
    """(n, H, W) uint16 frames on `device`: `base` rolled by the seeded
    offsets, made there in one upload and n rolls."""
    frame = torch.from_numpy(base.view(np.int16)).to(device)
    return torch.stack([torch.roll(frame, (int(r), int(c)), (0, 1))
                        for r, c in rolls(seed, n)]).view(torch.uint16)
