"""Build a wheel of deplex_tpu_torch that runs on a card without a checkout.

    python -m deplex_tpu_torch.tools.build_wheel [--dist DIR]

Run from a source checkout on a machine with nvcc and g++. It

  1. builds the CUDA kernels (``kernels._build.compile_library``: nvcc,
     sm_90a) and the native PNG16 library (``native.compile_library``: g++)
     into the package's ``_prebuilt/``, each under the name the sources and
     flags hash to: the names an installed package's loaders look for (they
     build nothing and raise on a missing or stale library). Libraries of
     other sources left in ``_prebuilt/`` are removed first. The native
     library must name zlib by its soname (``libz.so.1``), not by a path;
  2. writes ``DIST/deplex_tpu_torch-<version>-py3-none-linux_x86_64.whl``
     with ``zipfile``: ``deplex_tpu_torch/`` only (the Python sources,
     ``csrc/``, ``native/src/`` and ``_prebuilt/``) and its ``.dist-info``
     (``METADATA`` requiring torch and numpy, ``WHEEL`` with
     ``Root-Is-Purelib: false``, ``RECORD`` with the sha256 of every file).

The ctypes interface does not depend on the interpreter, so one wheel
serves every CPython 3 on Linux x86_64; the kernels need a Hopper card.
Install it with ``python -m pip install --no-deps <wheel>`` (torch and
numpy come from the environment).
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import json
import pathlib
import sys
import zipfile

DIST_NAME = "deplex_tpu_torch"
TAG = "py3-none-linux_x86_64"
# What ships besides the Python sources, relative to the package.
DATA_GLOBS = ("csrc/*.cu", "csrc/*.cuh", "native/src/*.cpp", "_prebuilt/*.so")


def prebuild(package: pathlib.Path) -> dict:
    """Build both libraries of `package`'s sources into its ``_prebuilt/``;
    returns their paths and nvcc's output."""
    from deplex_tpu_torch import native
    from deplex_tpu_torch.kernels import _build

    prebuilt = package / "_prebuilt"
    kernels_so = prebuilt / _build.library_name(package / "csrc")
    native_so = prebuilt / native.library_name(package / "native" / "src")
    if prebuilt.is_dir():
        for old in prebuilt.glob("libdeplex_*.so"):
            if old not in (kernels_so, native_so):
                old.unlink()
    log = _build.compile_library(kernels_so, package / "csrc")
    native.compile_library(native_so, native.libz_path(), package / "native" / "src")
    needed = native.needed_libraries(native_so)
    libz = [n for n in needed if "libz" in n]
    if libz != ["libz.so.1"]:
        raise RuntimeError(f"{native_so} names zlib as {libz}, not by its soname libz.so.1: "
                           f"an installed library would not resolve it (needs {needed})")
    return {"kernels": kernels_so, "native": native_so, "nvcc_log": log, "needed": needed}


def package_files(package: pathlib.Path) -> list[tuple[str, pathlib.Path]]:
    """(name in the wheel, file) of everything the package ships."""
    files = {p for p in package.rglob("*.py") if "__pycache__" not in p.parts}
    for pattern in DATA_GLOBS:
        files.update(package.glob(pattern))
    return sorted((f"{DIST_NAME}/{p.relative_to(package).as_posix()}", p) for p in files)


def _record_hash(data: bytes) -> str:
    digest = base64.urlsafe_b64encode(hashlib.sha256(data).digest()).rstrip(b"=")
    return "sha256=" + digest.decode()


def write_wheel(package: pathlib.Path, dist: pathlib.Path, version: str) -> pathlib.Path:
    """Zip `package` and its metadata into a wheel under `dist`."""
    info = f"{DIST_NAME}-{version}.dist-info"
    metadata = "\n".join([
        "Metadata-Version: 2.1", f"Name: {DIST_NAME}", f"Version: {version}",
        "Summary: Plane extraction and plane-landmark SLAM in PyTorch with CUDA kernels "
        "for the NVIDIA H100",
        "License: Apache-2.0", "Requires-Python: >=3.10", "Requires-Dist: torch",
        "Requires-Dist: numpy", ""])
    wheel_meta = "\n".join(["Wheel-Version: 1.0",
                            "Generator: deplex_tpu_torch.tools.build_wheel",
                            "Root-Is-Purelib: false", f"Tag: {TAG}", ""])
    entries = [(name, path.read_bytes()) for name, path in package_files(package)]
    entries += [(f"{info}/METADATA", metadata.encode()), (f"{info}/WHEEL", wheel_meta.encode())]
    record = "".join(f"{name},{_record_hash(data)},{len(data)}\n" for name, data in entries)
    record += f"{info}/RECORD,,\n"
    dist.mkdir(parents=True, exist_ok=True)
    out = dist / f"{DIST_NAME}-{version}-{TAG}.whl"
    tmp = out.with_suffix(".tmp")
    with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_DEFLATED) as whl:
        for name, data in entries:
            whl.writestr(name, data)
        whl.writestr(f"{info}/RECORD", record)
    tmp.replace(out)
    return out


def build(package: pathlib.Path | None = None, dist: pathlib.Path | None = None) -> dict:
    """Prebuild the libraries and write the wheel; returns what was made."""
    import deplex_tpu_torch

    package = pathlib.Path(package or pathlib.Path(deplex_tpu_torch.__file__).parent).resolve()
    dist = pathlib.Path(dist or package.parent / "dist")
    built = prebuild(package)
    wheel = write_wheel(package, dist, deplex_tpu_torch.__version__)
    return {**built, "wheel": wheel, "wheel_bytes": wheel.stat().st_size}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dist", default=None, help="where the wheel goes (default: <checkout>/dist)")
    args = ap.parse_args(argv)
    out = build(dist=args.dist)
    print(json.dumps({"wheel": str(out["wheel"]), "wheel_bytes": out["wheel_bytes"],
                      "kernels": out["kernels"].name, "native": out["native"].name,
                      "native_needs": out["needed"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
