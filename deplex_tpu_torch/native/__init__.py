"""Native (C++) host runtime: PNG16 decode, back-projection, sequence loader.

Port of ``deplex_tpu.native``. ``src/deplex_native.cpp`` decodes the
grayscale PNGs depth sensors write and back-projects a depth map;
``src/deplex_loader.cpp`` decodes a sequence on a pool of C++ threads into
an ordered ring. At first use ``g++`` builds both into one shared library
under ``build/deplex_tpu_torch/`` at the root of the source checkout, named
by a hash of the sources and flags (as ``kernels/_build.py`` builds the
CUDA library). Outside a checkout nothing is built: the library comes from
the package's ``_prebuilt/`` under the name the shipped sources hash to,
and a missing or stale one raises (``available()`` too), never falling
back to the Python decoder. zlib is linked by the path of the ``libz.so.1``
the interpreter itself uses, so the build needs no zlib header; the linker
records the soname, ``libz.so.1`` (``needed_libraries``). The library is
loaded with ``ctypes.CDLL``: its calls release the interpreter lock, so
decoding threads overlap.

``decode_counts()`` says how many frames each decoder produced since
``reset_decode_counts()``: ``native`` (this library, the sequence loader
included) and ``python`` (``utils/depth_image.py``'s decoder, the twin,
which ``DepthImage`` uses only for the formats this one declines or when
the library cannot be built).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import os
import pathlib
import struct
import subprocess
import tempfile
import threading

import numpy as np

SRC = pathlib.Path(__file__).resolve().parent / "src"
SOURCES = ("deplex_native.cpp", "deplex_loader.cpp")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: Exception | None = None
_counts = {"native": 0, "python": 0}
build_info: dict = {}       # compiler, libz path and library of the loaded build

_U16 = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_U32P = ctypes.POINTER(ctypes.c_uint32)
_F = ctypes.c_float
_SIGNATURES = {
    "deplex_png16_info": ([ctypes.c_char_p, ctypes.c_size_t, _U32P, _U32P], ctypes.c_int),
    "deplex_png16_decode": ([ctypes.c_char_p, ctypes.c_size_t, _U16, ctypes.c_size_t],
                            ctypes.c_int),
    "deplex_backproject": ([_U16, ctypes.c_uint32, ctypes.c_uint32, _F, _F, _F, _F, _F32],
                           None),
    "deplex_loader_create": ([ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_uint32,
                              ctypes.c_uint32, ctypes.c_int, ctypes.c_int], ctypes.c_void_p),
    "deplex_loader_next": ([ctypes.c_void_p, _U16], ctypes.c_int),
    "deplex_loader_next_cloud": ([ctypes.c_void_p, _F, _F, _F, _F, _F32], ctypes.c_int),
    "deplex_loader_destroy": ([ctypes.c_void_p], None),
}


def libz_path() -> str:
    """The path of the zlib shared library this process has loaded (the one
    ``ctypes.util.find_library("z")`` names)."""
    name = ctypes.util.find_library("z")
    if name is None:
        raise RuntimeError("deplex_tpu_torch.native: no zlib shared library found")
    ctypes.CDLL(name)
    with open("/proc/self/maps") as maps:
        for line in maps:
            path = line.split()[-1]
            if os.path.basename(path).startswith("libz.so"):
                return path
    raise RuntimeError(f"deplex_tpu_torch.native: {name} loaded but not found in the maps")


def library_name(src: pathlib.Path = SRC) -> str:
    """The library's file name: a hash of the sources in `src` and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((src / name).read_bytes())
    return f"libdeplex_native_{h.hexdigest()[:16]}.so"


def library_path() -> pathlib.Path:
    """Built into the checkout's build directory, or shipped in the
    installed package's ``_prebuilt/``."""
    from deplex_tpu_torch.kernels import _build

    return (_build.build_dir() if _build.in_checkout() else _build.PREBUILT) / library_name()


def compile_library(out: pathlib.Path, zlib: str, src: pathlib.Path = SRC) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        so = os.path.join(tmp, out.name)
        cmd = ["g++", *CXX_FLAGS, *(str(src / n) for n in SOURCES), zlib, "-o", so]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(so, out)   # atomic: a concurrent build never sees half a file


def needed_libraries(path) -> list[str]:
    """The DT_NEEDED entries of an ELF64 little-endian shared library: the
    names the dynamic loader resolves when it maps the library."""
    data = pathlib.Path(path).read_bytes()
    if data[:4] != b"\x7fELF" or data[4] != 2 or data[5] != 1:
        raise ValueError(f"{path} is not an ELF64 little-endian file")
    shoff, = struct.unpack_from("<Q", data, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", data, 0x3A)
    sections = [struct.unpack_from("<IIQQQQIIQQ", data, shoff + i * shentsize)
                for i in range(shnum)]
    for sec in sections:
        if sec[1] != 6:                      # SHT_DYNAMIC
            continue
        strtab = sections[sec[6]]            # sh_link: its string table
        names = []
        for off in range(sec[4], sec[4] + sec[5], 16):
            tag, val = struct.unpack_from("<qQ", data, off)
            if tag == 0:                     # DT_NULL
                break
            if tag == 1:                     # DT_NEEDED
                start = strtab[4] + val
                names.append(data[start:data.index(b"\0", start)].decode())
        return names
    return []


def _load() -> ctypes.CDLL:
    """The native library, built first if needed (in a checkout); raises if
    it cannot be."""
    global _lib, _build_error
    from deplex_tpu_torch.kernels import _build

    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise RuntimeError(f"deplex_tpu_torch.native is unavailable: {_build_error}")
        path = library_path()
        if not _build.in_checkout():
            if not path.exists():
                raise _build.missing_prebuilt(path)
            lib = ctypes.CDLL(str(path))
            build_info.update(cxx="prebuilt", libz=",".join(
                n for n in needed_libraries(path) if n.startswith("libz")), library=path.name)
        else:
            try:
                zlib = libz_path()
                if not path.exists():
                    compile_library(path, zlib)
                lib = ctypes.CDLL(str(path))
            except (OSError, RuntimeError) as e:
                _build_error = e
                raise
            version = subprocess.run(["g++", "--version"], capture_output=True, text=True)
            build_info.update(cxx=version.stdout.splitlines()[0] if version.stdout else "unknown",
                              libz=zlib, library=path.name)
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _lib = lib
        return lib


def available() -> bool:
    """Whether the native library is (or can be) built and loaded here. In
    a checkout without a compiler it is not, and the Python decoder serves;
    an installed package without its prebuilt library raises."""
    from deplex_tpu_torch.kernels._build import PrebuiltMissing

    try:
        _load()
        return True
    except PrebuiltMissing:
        raise
    except (OSError, RuntimeError):
        return False


def count_decode(kind: str, n: int = 1) -> None:
    with _lock:
        _counts[kind] += n


def decode_counts() -> dict:
    """Frames decoded by each decoder since the last reset."""
    with _lock:
        return dict(_counts)


def reset_decode_counts() -> None:
    with _lock:
        for kind in _counts:
            _counts[kind] = 0


def decode_png16(path) -> np.ndarray | None:
    """Decode a grayscale PNG file to (H, W) uint16 (8-bit samples widened).
    None for the formats this decoder declines (colour, interlaced, a bit
    depth other than 8 or 16); RuntimeError for a file that cannot be read
    or is not a valid PNG."""
    lib = _load()
    try:
        data = pathlib.Path(path).read_bytes()
    except OSError as e:
        raise RuntimeError(f"Error: Couldn't read image {path}") from e
    w, h = ctypes.c_uint32(), ctypes.c_uint32()
    rc = lib.deplex_png16_info(data, len(data), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise RuntimeError(f"Error: Couldn't read image {path} (png parse {rc})")
    out = np.empty((h.value, w.value), dtype=np.uint16)
    rc = lib.deplex_png16_decode(data, len(data), out, out.size)
    if rc in (-5, -6):
        return None
    if rc != 0:
        raise RuntimeError(f"Error: Couldn't read image {path} (png decode {rc})")
    count_decode("native")
    return out


def backproject(depth: np.ndarray, fx: float, fy: float, cx: float, cy: float) -> np.ndarray:
    """(H, W) uint16 depth -> (H*W, 3) float32 organized cloud."""
    lib = _load()
    depth = np.ascontiguousarray(depth, dtype=np.uint16)
    H, W = depth.shape
    out = np.empty((H * W, 3), dtype=np.float32)
    lib.deplex_backproject(depth, H, W, float(fx), float(fy), float(cx), float(cy), out)
    return out


class SequenceLoader:
    """Threaded, ordered depth-sequence loader: `workers` C++ threads decode
    the PNGs at `paths` ahead into a ring of `queue_depth` frames; frames
    come back strictly in order. Every frame must be `height` x `width`."""

    def __init__(self, paths, width: int, height: int, queue_depth: int = 4,
                 workers: int = 2):
        self._handle = None
        self._lib = _load()
        self._w, self._h = int(width), int(height)
        blob = b"\0".join(str(p).encode() for p in paths) + b"\0"
        self._handle = self._lib.deplex_loader_create(
            blob, len(blob), len(paths), self._w, self._h, queue_depth, workers)
        if not self._handle:
            raise RuntimeError("SequenceLoader: loader creation failed")

    def _check(self, rc: int) -> bool:
        """True for a frame, False at the end; raises on a failed frame."""
        if rc == 1:
            return False
        if rc != 0:
            raise RuntimeError(f"SequenceLoader: frame decode failed (rc={rc})")
        count_decode("native")
        return True

    def next_depth(self) -> np.ndarray | None:
        """The next (H, W) uint16 frame, or None after the last."""
        if not self._handle:
            return None
        out = np.empty((self._h, self._w), np.uint16)
        return out if self._check(self._lib.deplex_loader_next(self._handle, out)) else None

    def next_cloud(self, intrinsics) -> np.ndarray | None:
        """The next frame back-projected to an (H*W, 3) float32 cloud, or None."""
        if not self._handle:
            return None
        K = np.asarray(intrinsics, np.float32)
        out = np.empty((self._h * self._w, 3), np.float32)
        rc = self._lib.deplex_loader_next_cloud(self._handle, float(K[0, 0]), float(K[1, 1]),
                                                float(K[0, 2]), float(K[1, 2]), out)
        return out if self._check(rc) else None

    def __iter__(self):
        while (depth := self.next_depth()) is not None:
            yield depth

    def close(self) -> None:
        """Stop the workers and free the ring (idempotent)."""
        if self._handle:
            self._lib.deplex_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


__all__ = ["SequenceLoader", "available", "backproject", "decode_counts", "decode_png16",
           "reset_decode_counts"]
