"""Build the CUDA kernels of ``csrc/`` into one shared library and load it.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for Hopper (sm_90a), one
process per source, all started together, and links them into one ``.so``
with a plain C interface, loaded with ctypes. The library lands
in ``build/deplex_tpu_torch/`` at the root of the source checkout, under a
name keyed by a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses it. Outside a source checkout (an installed wheel,
``tools/build_wheel.py``) nothing is built: the library is loaded from the
package's ``_prebuilt/`` under the name the shipped sources hash to, and a
missing or stale one raises, naming the file expected. The library runs on
Hopper only (sm_90a); on another card loading raises with its compute
capability. Nothing here runs at import time.
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

PACKAGE = pathlib.Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
CHECKOUT = PACKAGE.parent
# Where an installed package keeps the libraries its wheel was built with.
PREBUILT = PACKAGE / "_prebuilt"
CAPABILITY = (9, 0)      # sm_90a: Hopper
# No --use_fast_math: true division and IEEE sqrt. -fmad=false keeps nvcc from
# contracting a*b+c into one rounding, so the kernels round as the plain
# PyTorch twins do (the planar gate compares lambda_min against a threshold).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "dplx_error_string": ([_I], ctypes.c_char_p),
    "dplx_cell_moments_depth": ([_P, _I, _I, _I, _I, _P, _F, _I, _P, _P], _I),
    "dplx_cell_moments_points": ([_P, _I, _I, _I, _I, _F, _I, _P, _P], _I),
    "dplx_grow_rounds": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P], _I),
    "dplx_grow_rounds_scratch_bytes": ([_I, _I, _I, _I], ctypes.c_longlong),
    "dplx_grow_rounds_profile_slots": ([], _I),
    "dplx_grow_rounds_counter_slots": ([], _I),
    "dplx_cell_finalize": ([_P] + [_I] * 5 + [_F] * 12 + [_I] + [_P] * 12, _I),
    "dplx_round_finalize": ([_P] * 7 + [_I] * 5 + [_F, _F] + [_P] * 13, _I),
    "dplx_round_finalize_scratch_bytes": ([_I] * 4, ctypes.c_longlong),
    "dplx_round_finalize_max_clusters": ([_I] * 3, _I),
    "dplx_merge_from_labels": ([_P] * 8 + [_I] * 4 + [_F, _F] + [_P] * 9, _I),
    "dplx_ransac_chunk_step": ([_P] * 15 + [_I] * 11 + [_F, _P], _I),
    "dplx_pixel_labels": ([_P] * 5 + [_I, _F] + [_I] * 8 + [_P, _P], _I),
    "dplx_ransac_sample": ([_P] * 4 + [_I] * 13 + [_F] + [_P] * 16, _I),
    "dplx_ransac_sample_max_clusters": ([_I] * 2, _I),
    "dplx_ransac_sample_shared_bytes": ([_I, _I], ctypes.c_longlong),
    "dplx_ransac_sample_fit_slots": ([], _I),
    "dplx_ransac_sample_fit_blocks_per_sm": ([], _I),
    "dplx_ransac_sample_profile": ([_P, _I], _I),
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


class PrebuiltMissing(RuntimeError):
    """An installed package lacks the prebuilt library of its sources."""


def in_checkout() -> bool:
    """Whether the package sits in a source checkout (beside the
    repository's ``pyproject.toml``), where the libraries are built."""
    return (CHECKOUT / "pyproject.toml").is_file()


def missing_prebuilt(path: pathlib.Path) -> PrebuiltMissing:
    """The error for an installed package whose library `path` is absent,
    naming the libraries of other sources found beside it (stale ones)."""
    stem = path.name.rsplit("_", 1)[0]
    found = sorted(p.name for p in path.parent.glob(f"{stem}_*.so")) \
        if path.parent.is_dir() else []
    stale = f"; {path.parent} holds {found}, built from other sources" if found else ""
    return PrebuiltMissing(
        f"deplex_tpu_torch is installed outside a source checkout, so it builds nothing "
        f"and loads the prebuilt library {path}, which is missing{stale}. Rebuild the "
        f"wheel from these sources (python -m deplex_tpu_torch.tools.build_wheel).")


def build_dir() -> pathlib.Path:
    """``build/deplex_tpu_torch/`` beside the checkout's ``pyproject.toml``."""
    if not (CHECKOUT / "pyproject.toml").is_file():
        raise RuntimeError(
            f"deplex_tpu_torch builds its CUDA kernels inside a source checkout, into "
            f"<checkout>/build/deplex_tpu_torch; {CSRC} is not in one (no pyproject.toml "
            f"in {CHECKOUT}). Run from a clone of the repository.")
    return CHECKOUT / "build" / "deplex_tpu_torch"


def library_name(csrc: pathlib.Path = CSRC) -> str:
    """The library's file name: a hash of the sources in `csrc` and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return f"libdeplex_kernels_{h.hexdigest()[:16]}.so"


def library_path(csrc: pathlib.Path = CSRC) -> pathlib.Path:
    """Where the library of `csrc` is: built into the checkout's build
    directory, or shipped in the installed package's ``_prebuilt/``."""
    return (build_dir() if in_checkout() else PREBUILT) / library_name(csrc)


def check_capability() -> None:
    """Raise unless the current card is a Hopper (the library is sm_90a only)."""
    import torch

    if torch.cuda.is_available():
        cap = tuple(torch.cuda.get_device_capability())
        if cap != CAPABILITY:
            raise RuntimeError(
                f"deplex_tpu_torch's kernels are built for sm_90a (Hopper, compute "
                f"capability 9.0); {torch.cuda.get_device_name()} has compute capability "
                f"{cap[0]}.{cap[1]}")


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
    """The loaded kernel library, built first if needed (in a checkout)."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            check_capability()
            path = library_path()
            if not path.exists():
                if not in_checkout():
                    raise missing_prebuilt(path)
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
