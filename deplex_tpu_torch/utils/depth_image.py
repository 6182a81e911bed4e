"""Depth-image ingestion and back-projection; a PNG16 decoder and encoder
in numpy + zlib.

API parity with ``deplex_tpu.utils.DepthImage``: loads a 16-bit grayscale PNG
and back-projects it to an organized (H*W, 3) cloud with the pinhole model
    x = (u - cx) / fx * z,  y = (v - cy) / fy * z,  z = raw depth units.

Decoding prefers the native C++ decoder (``deplex_tpu_torch.native``) and
falls back to the decoder here for the formats native declines, or when the
native library cannot be built. This decoder is also native's twin in the
tests. It covers what depth sensors write: non-interlaced 16-bit grayscale,
filter types 0-4. Anything else raises RuntimeError. ``encode_png16`` writes
such files (PIL is not needed).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from deplex_tpu_torch import native

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


def png16_shape(path) -> tuple[int, int]:
    """(height, width) from a PNG file's header, without decoding it."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != _PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise RuntimeError(f"Error: Couldn't read image {path}")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def _python_load_png16(path: str) -> np.ndarray:
    try:
        with open(path, "rb") as f:
            data = f.read()
        img = decode_png16(data)
    except (OSError, ValueError, zlib.error) as e:
        raise RuntimeError(f"Error: Couldn't read image {path}") from e
    native.count_decode("python")
    return img


def _load_png16(path: str) -> np.ndarray:
    """Load a 16-bit grayscale PNG -> (H, W) uint16; RuntimeError on failure."""
    if native.available():
        img = native.decode_png16(path)
        if img is not None:
            return img
    return _python_load_png16(path)


def encode_png16(img: np.ndarray, filter_type: int = 0) -> bytes:
    """(H, W) uint16 -> the bytes of a 16-bit grayscale PNG whose every row
    is filtered with `filter_type` (0 none, 1 sub, 2 up, 3 average, 4 Paeth)."""
    h, w = img.shape
    raw = np.ascontiguousarray(img, ">u2").view(np.uint8).reshape(h, 2 * w).astype(np.int32)
    bpp = 2
    a = np.pad(raw[:, :-bpp], ((0, 0), (bpp, 0)))          # left neighbours
    b = np.pad(raw[:-1], ((1, 0), (0, 0)))                 # the row above
    c = np.pad(b[:, :-bpp], ((0, 0), (bpp, 0)))            # above-left
    if filter_type == 0:
        pred = np.zeros_like(raw)
    elif filter_type == 1:
        pred = a
    elif filter_type == 2:
        pred = b
    elif filter_type == 3:
        pred = (a + b) >> 1
    elif filter_type == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"PNG filter type {filter_type} is not 0-4")
    rows = np.concatenate([np.full((h, 1), filter_type, np.uint8),
                           ((raw - pred) & 0xFF).astype(np.uint8)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def write_png16(path, img: np.ndarray, filter_type: int = 0) -> None:
    """Write (H, W) uint16 depth as a 16-bit grayscale PNG file."""
    with open(path, "wb") as f:
        f.write(encode_png16(np.asarray(img, np.uint16), filter_type))


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
