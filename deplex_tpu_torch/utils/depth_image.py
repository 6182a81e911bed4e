"""Depth-image ingestion and back-projection (numpy + zlib only).

API parity with ``deplex_tpu.utils.DepthImage``: loads a 16-bit grayscale PNG
and back-projects it to an organized (H*W, 3) cloud with the pinhole model
    x = (u - cx) / fx * z,  y = (v - cy) / fy * z,  z = raw depth units.

The PNG decoder covers what depth sensors write: non-interlaced 16-bit
grayscale, filter types 0-4. Anything else raises RuntimeError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _paeth_row(line: np.ndarray, prior: np.ndarray, bpp: int, average: bool) -> np.ndarray:
    """Undo filter 3 (average) or 4 (Paeth) on one row: each byte depends on
    the reconstructed byte bpp to its left, so this walk is sequential."""
    out = [0] * len(line)
    filt = line.tolist()
    up = prior.tolist()
    for i, f in enumerate(filt):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if average:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (f + pred) & 0xFF
    return np.asarray(out, np.uint8)


def decode_png16(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) uint16. Raises ValueError on anything this decoder
    does not take (not a PNG, colour, interlaced, bit depth other than 16)."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError("missing IHDR or IDAT chunk")
    width, height, depth, color, _, _, interlace = header
    if depth != 16 or color != 0 or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{color}, interlace {interlace}")
    bpp, stride = 2, 2 * width
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError("truncated image data")
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(height):
        ftype, line = rows[r, 0], rows[r, 1:]
        if ftype == 0:
            rec = line.copy()
        elif ftype == 1:
            # Sub: a running sum per byte lane, modulo 256.
            lanes = line.reshape(width, bpp).astype(np.uint32)
            rec = (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype == 2:
            rec = (line.astype(np.uint16) + prior).astype(np.uint8)
        elif ftype in (3, 4):
            rec = _paeth_row(line, prior, bpp, average=ftype == 3)
        else:
            raise ValueError(f"bad filter type {ftype} in row {r}")
        out[r] = rec
        prior = rec
    return out.view(">u2").astype(np.uint16)


def _load_png16(path: str) -> np.ndarray:
    try:
        with open(path, "rb") as f:
            data = f.read()
        return decode_png16(data)
    except (OSError, ValueError, zlib.error) as e:
        raise RuntimeError(f"Error: Couldn't read image {path}") from e


def backproject(depth: np.ndarray, intrinsics) -> np.ndarray:
    """(H, W) depth -> (H*W, 3) float32 organized cloud, in the operation
    order of the JAX package's native and device back-projection."""
    K = np.asarray(intrinsics, dtype=np.float32)
    fx, cx = K[0, 0], K[0, 2]
    fy, cy = K[1, 1], K[1, 2]
    H, W = depth.shape
    z = depth.astype(np.float32)
    u = (np.arange(W, dtype=np.float32)[None, :] - cx) / fx
    v = (np.arange(H, dtype=np.float32)[:, None] - cy) / fy
    return np.stack([u * z, v * z, z], axis=-1).reshape(H * W, 3)


class DepthImage:
    def __init__(self, image_path: str | None = None):
        self._image: np.ndarray | None = None
        self._width = 0
        self._height = 0
        if image_path is not None:
            self.reset(image_path)

    def reset(self, image_path: str) -> None:
        img = _load_png16(str(image_path))
        self._image = img
        self._height, self._width = img.shape

    @property
    def width(self) -> int:
        return self._width

    @property
    def height(self) -> int:
        return self._height

    def get_width(self) -> int:
        return self._width

    def get_height(self) -> int:
        return self._height

    @property
    def data(self) -> np.ndarray:
        """Raw depth array (H, W) uint16."""
        if self._image is None:
            raise RuntimeError("DepthImage is empty")
        return self._image

    def transform_to_pcd(self, intrinsics) -> np.ndarray:
        """Back-project to an organized (H*W, 3) float32 cloud."""
        if self._image is None:
            raise RuntimeError("DepthImage is empty")
        return backproject(self._image, intrinsics)

    # Reference-compatible alias (C++ name).
    to_point_cloud = transform_to_pcd
