"""Build the CUDA kernels of ``csrc/`` into one shared library and load it.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for Hopper (sm_90a), one
process per source, all started together, and links them into one ``.so``
with a plain C interface, loaded with ctypes. The library lands
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
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "dplx_error_string": ([_I], ctypes.c_char_p),
    "dplx_cell_moments_depth": ([_P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _I, _P, _P], _I),
    "dplx_cell_moments_points": ([_P, _I, _I, _I, _I, _F, _I, _P, _P], _I),
    "dplx_grow_rounds": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P], _I),
    "dplx_grow_rounds_scratch_bytes": ([_I, _I, _I, _I], ctypes.c_longlong),
    "dplx_merge_from_labels": ([_P] * 8 + [_I] * 4 + [_F, _F] + [_P] * 9, _I),
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


def build_dir() -> pathlib.Path:
    """``build/deplex_tpu_torch/`` beside the checkout's ``pyproject.toml``."""
    if not (CHECKOUT / "pyproject.toml").is_file():
        raise RuntimeError(
            f"deplex_tpu_torch builds its CUDA kernels inside a source checkout, into "
            f"<checkout>/build/deplex_tpu_torch; {CSRC} is not in one (no pyproject.toml "
            f"in {CHECKOUT}). Run from a clone of the repository.")
    return CHECKOUT / "build" / "deplex_tpu_torch"


def library_path(csrc: pathlib.Path = CSRC) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"libdeplex_kernels_{h.hexdigest()[:16]}.so"


def compile_library(out: pathlib.Path, csrc: pathlib.Path = CSRC, extra_flags=()) -> str:
    """Build ``csrc/*.cu`` into the shared library ``out``; returns nvcc's output."""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for cu in sorted(csrc.glob("*.cu")):
            obj = os.path.join(tmp, cu.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, *extra_flags, "-I", str(csrc),
                                           "-c", "-o", obj,
                                           str(cu)], stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        logs = [proc.communicate()[0] for proc in procs]
        log = "".join(logs)
        if any(proc.returncode for proc in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        so = os.path.join(tmp, out.name)
        link = subprocess.run([nvcc, "-shared", "-o", so, *objs], capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
        os.replace(so, out)   # atomic: a concurrent build never sees half a file
    return log


def load_library(path: pathlib.Path) -> ctypes.CDLL:
    """Load a built library and declare the C signatures it exports."""
    lib = ctypes.CDLL(str(path))
    for name, (args, res) in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                build_log = compile_library(path)
            lib = load_library(path)
            missing = [name for name in _SIGNATURES if not hasattr(lib, name)]
            if missing:
                raise RuntimeError(f"{path} lacks {missing}")
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = library().dplx_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
