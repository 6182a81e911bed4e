"""Build the CUDA kernels of ``csrc/`` into one shared library and load it.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for Hopper (sm_90a) into
one ``.so`` with a plain C interface, loaded with ctypes. The library lands
in ``build/deplex_tpu_torch/`` at the root of the source checkout, under a
name keyed by a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses it. Outside a source checkout (an installed package)
the build raises rather than write into the interpreter's prefix. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
CHECKOUT = CSRC.parents[1]
# No --use_fast_math: true division and IEEE sqrt. -fmad=false keeps nvcc from
# contracting a*b+c into one rounding, so the kernels round as the plain
# PyTorch twins do (the planar gate compares lambda_min against a threshold).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "dplx_error_string": ([_I], ctypes.c_char_p),
    "dplx_cell_moments_depth": ([_P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _I, _P, _P], _I),
    "dplx_cell_moments_points": ([_P, _I, _I, _I, _I, _F, _I, _P, _P], _I),
    "dplx_grow_rounds": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P], _I),
    "dplx_merge_planes": ([_P] * 8 + [_I, _I, _F, _F] + [_P] * 8, _I),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""          # nvcc's output (ptxas register and spill report)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_dir() -> pathlib.Path:
    """``build/deplex_tpu_torch/`` beside the checkout's ``pyproject.toml``."""
    if not (CHECKOUT / "pyproject.toml").is_file():
        raise RuntimeError(
            f"deplex_tpu_torch builds its CUDA kernels inside a source checkout, into "
            f"<checkout>/build/deplex_tpu_torch; {CSRC} is not in one (no pyproject.toml "
            f"in {CHECKOUT}). Run from a clone of the repository.")
    return CHECKOUT / "build" / "deplex_tpu_torch"


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"libdeplex_kernels_{h.hexdigest()[:16]}.so"


def _compile(out: pathlib.Path) -> None:
    global build_log
    out.parent.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu],
                          capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = library().dplx_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
