"""deplex_tpu_torch's wheel (``tools/build_wheel.py``) and the loaders of an
installed package, on the CPU: the wheel's names, metadata and RECORD with
nvcc's step stubbed (the native library is built for real by g++); a copy
of the package outside a checkout loads the libraries named by its
sources' hash from ``_prebuilt/``, and raises (naming the file it expected)
on a missing or stale one instead of building or falling back."""

import base64
import csv
import hashlib
import io
import json
import pathlib
import shutil
import subprocess
import sys
import zipfile

import pytest
torch = pytest.importorskip("torch")

import deplex_tpu_torch
from deplex_tpu_torch import native
from deplex_tpu_torch.kernels import _build
from deplex_tpu_torch.tools import build_wheel

PACKAGE = pathlib.Path(deplex_tpu_torch.__file__).resolve().parent
TUM_PNG = PACKAGE.parent / "data" / "tum" / "1341848230.910894.png"


def _copy_package(dest: pathlib.Path) -> pathlib.Path:
    pkg = dest / "deplex_tpu_torch"
    shutil.copytree(PACKAGE, pkg, ignore=shutil.ignore_patterns("__pycache__", "_prebuilt"))
    return pkg


def _stub_nvcc(out, csrc=None, extra_flags=()):
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(b"kernel library stub")
    return "stub nvcc log"


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wheel")
    pkg = _copy_package(tmp / "src")
    saved = _build.compile_library
    _build.compile_library = _stub_nvcc
    try:
        (pkg / "_prebuilt").mkdir()
        (pkg / "_prebuilt" / "libdeplex_kernels_0000000000000000.so").write_bytes(b"stale")
        built = build_wheel.build(pkg, tmp / "dist")
    finally:
        _build.compile_library = saved
    return built, pkg


def test_wheel_names_metadata_and_record(wheel):
    built, pkg = wheel
    path = built["wheel"]
    assert path.name == "deplex_tpu_torch-0.1.0-py3-none-linux_x86_64.whl"
    with zipfile.ZipFile(path) as whl:
        names = whl.namelist()
        files = {n: whl.read(n) for n in names}
    info = "deplex_tpu_torch-0.1.0.dist-info"
    assert all(n.startswith(("deplex_tpu_torch/", info + "/")) for n in names)
    assert not any(n.startswith("deplex_tpu/") for n in names)
    assert not any("__pycache__" in n or n.endswith(".pyc") for n in names)
    for name in ("__init__.py", "tools/build_wheel.py", "tools/readers/__init__.py",
                 "csrc/growing.cu", "csrc/common.cuh", "native/src/deplex_native.cpp",
                 f"_prebuilt/{_build.library_name()}", f"_prebuilt/{native.library_name()}"):
        assert f"deplex_tpu_torch/{name}" in names, name
    # The stale library was cleared; only the two of these sources ship.
    assert sorted(n for n in names if "_prebuilt" in n) == sorted(
        [f"deplex_tpu_torch/_prebuilt/{_build.library_name()}",
         f"deplex_tpu_torch/_prebuilt/{native.library_name()}"])
    metadata = files[f"{info}/METADATA"].decode()
    assert "Name: deplex_tpu_torch" in metadata and "Version: 0.1.0" in metadata
    requires = [ln.split(":", 1)[1].strip() for ln in metadata.splitlines()
                if ln.startswith("Requires-Dist:")]
    assert requires == ["torch", "numpy"] and "jax" not in metadata
    wheel_meta = files[f"{info}/WHEEL"].decode()
    assert "Root-Is-Purelib: false" in wheel_meta
    assert "Tag: py3-none-linux_x86_64" in wheel_meta
    rows = list(csv.reader(io.StringIO(files[f"{info}/RECORD"].decode())))
    assert {r[0] for r in rows} == set(names)
    for name, digest, size in rows:
        if name == f"{info}/RECORD":
            assert digest == size == ""
            continue
        want = base64.urlsafe_b64encode(hashlib.sha256(files[name]).digest()).rstrip(b"=")
        assert digest == "sha256=" + want.decode() and int(size) == len(files[name]), name
    assert built["wheel_bytes"] == path.stat().st_size
    assert built["needed"][0] == "libz.so.1"


def _installed(site: pathlib.Path, code: str) -> subprocess.CompletedProcess:
    """Run `code` with only `site` on the path, from a directory outside
    the checkout."""
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(site), "CUDA_HOME": str(site / "none"),
           "HOME": str(site)}
    return subprocess.run([sys.executable, "-c", code], cwd=site, env=env, capture_output=True,
                          text=True, timeout=120)


def test_installed_wheel_loads_its_prebuilt_libraries(wheel, tmp_path):
    built, _ = wheel
    site = tmp_path / "site"
    with zipfile.ZipFile(built["wheel"]) as whl:
        whl.extractall(site)
    out = _installed(site, (
        "import json, deplex_tpu_torch\n"
        "from deplex_tpu_torch import native\n"
        "from deplex_tpu_torch.kernels import _build\n"
        "from deplex_tpu_torch.utils import DepthImage\n"
        f"img = DepthImage({str(TUM_PNG)!r})\n"
        "print(json.dumps({'package': deplex_tpu_torch.__file__,\n"
        "                  'in_checkout': _build.in_checkout(),\n"
        "                  'kernels': str(_build.library_path()),\n"
        "                  'native': str(native.library_path()),\n"
        "                  'decodes': native.decode_counts(), 'info': native.build_info,\n"
        "                  'shape': list(img.data.shape)}))\n"))
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    prebuilt = site / "deplex_tpu_torch" / "_prebuilt"
    assert got["package"] == str(site / "deplex_tpu_torch" / "__init__.py")
    assert got["in_checkout"] is False
    assert got["kernels"] == str(prebuilt / _build.library_name())
    assert got["native"] == str(prebuilt / native.library_name())
    assert got["decodes"] == {"native": 1, "python": 0} and got["shape"] == [480, 640]
    assert got["info"] == {"cxx": "prebuilt", "libz": "libz.so.1",
                           "library": native.library_name()}


def test_installed_package_raises_on_missing_or_stale_libraries(tmp_path):
    site = tmp_path / "site"
    pkg = _copy_package(site)
    (pkg / "_prebuilt").mkdir()
    (pkg / "_prebuilt" / "libdeplex_native_0123456789abcdef.so").write_bytes(b"stale")
    out = _installed(site, (
        "from deplex_tpu_torch import native\n"
        "from deplex_tpu_torch.kernels import _build\n"
        "from deplex_tpu_torch.utils import DepthImage\n"
        "for call in (native.available, _build.library,\n"
        f"             lambda: DepthImage({str(TUM_PNG)!r})):\n"
        "    try:\n"
        "        call()\n"
        "        print('NO ERROR')\n"
        "    except _build.PrebuiltMissing as e:\n"
        "        print(str(e))\n"
        "print(native.decode_counts(), _build._lib is None, native._lib is None)\n"))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert "NO ERROR" not in out.stdout
    native_expected = str(pkg / "_prebuilt" / native.library_name())
    kernels_expected = str(pkg / "_prebuilt" / _build.library_name())
    assert native_expected in lines[0] and "libdeplex_native_0123456789abcdef.so" in lines[0]
    assert "built from other sources" in lines[0]
    assert kernels_expected in lines[1] and "built from other sources" not in lines[1]
    assert native_expected in lines[2]                       # no Python-decoder fallback
    assert lines[3] == "{'native': 0, 'python': 0} True True"
    # Nothing was built into the installed package.
    assert sorted(p.name for p in (pkg / "_prebuilt").iterdir()) == [
        "libdeplex_native_0123456789abcdef.so"]


def test_in_a_checkout_the_loaders_build_into_build_dir():
    assert _build.in_checkout()
    assert _build.library_path() == _build.build_dir() / _build.library_name()
    assert native.library_path() == _build.build_dir() / native.library_name()
    assert _build.library_name(PACKAGE / "csrc") == _build.library_name()


def test_kernels_refuse_a_card_other_than_hopper(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *a: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA A100-SXM4-80GB")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match=r"sm_90a.*A100.*compute capability 8\.0"):
        _build.library()
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *a: (9, 0))
    _build.check_capability()


def test_build_wheel_does_nothing_at_import():
    code = ("import deplex_tpu_torch.tools.build_wheel\n"
            "from deplex_tpu_torch.kernels import _build\n"
            "from deplex_tpu_torch import native\n"
            "assert _build._lib is None and native._lib is None\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PACKAGE.parent, timeout=120)
    assert out.returncode == 0, out.stderr
