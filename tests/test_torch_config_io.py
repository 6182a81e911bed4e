"""deplex_tpu_torch config, I/O and interop vs the JAX package.

Config parsing, the PNG16 decoder, intrinsics and back-projection must give
exactly what deplex_tpu gives; the package must import without JAX.
"""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from deplex_tpu import Config as JaxConfig
from deplex_tpu.utils import DepthImage as JaxDepthImage
from deplex_tpu.utils import read_intrinsics as jax_read_intrinsics
from deplex_tpu_torch import Config
from deplex_tpu_torch.interop import config_from_dict
from deplex_tpu_torch.utils import DepthImage, read_intrinsics
from deplex_tpu_torch.utils.depth_image import decode_png16, encode_png16

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "data"
INIS = sorted((DATA / "configs").glob("*.ini"))
PNGS = [DATA / "tum" / "1341848230.910894.png", DATA / "icl_nuim" / "0.png"]
KS = [DATA / "configs" / "TUM_fr3_long_val.K", DATA / "configs" / "ICL_living_room.K"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_defaults_match_jax():
    assert dataclasses.asdict(Config()) == dataclasses.asdict(JaxConfig())


@pytest.mark.parametrize("ini", INIS, ids=lambda p: p.stem)
def test_from_ini_matches_jax(ini):
    assert len(INIS) == 3
    assert dataclasses.asdict(Config.from_ini(str(ini))) == \
        dataclasses.asdict(JaxConfig.from_ini(str(ini)))


def test_ini_errors_and_warnings(tmp_path, capsys):
    with pytest.raises(RuntimeError, match="Couldn't open ini file"):
        Config.from_ini(str(tmp_path / "missing.ini"))
    ini = tmp_path / "unknown.ini"
    ini.write_text("# comment\n[Parameters]\ndoRefinement=1\npatchSize=7\nusePallasGrowing=\n")
    c = Config.from_ini(str(ini))
    assert c.patch_size == 7 and c.use_pallas_growing is None
    assert "Unknown parameter name: doRefinement" in capsys.readouterr().err
    with pytest.raises(ValueError, match=r"patchSize\(-1\)"):
        Config(patch_size=-1)
    with pytest.raises(KeyError):
        Config.from_dict({"noSuchKey": 1})
    assert Config.from_dict({"patchSize": 8, "min_cos_angle_merge": 0.95}) == \
        Config(patch_size=8, min_cos_angle_merge=0.95)


def test_config_from_dict_round_trips_jax_config():
    jc = JaxConfig.from_ini(str(DATA / "configs" / "ICL_living_room.ini"))
    c = config_from_dict(dataclasses.asdict(jc))
    assert dataclasses.asdict(c) == dataclasses.asdict(jc)
    with pytest.raises(KeyError):
        config_from_dict({"bogus": 1})


@pytest.mark.parametrize("png,k", list(zip(PNGS, KS)), ids=["tum", "icl"])
def test_png_intrinsics_backprojection_equal_jax(png, k):
    ours, ref = DepthImage(str(png)), JaxDepthImage(str(png))
    assert (ours.height, ours.width) == (ref.height, ref.width) == (480, 640)
    assert ours.data.dtype == np.uint16
    np.testing.assert_array_equal(ours.data, ref.data)
    K = read_intrinsics(str(k))
    np.testing.assert_array_equal(K, jax_read_intrinsics(str(k)))
    np.testing.assert_array_equal(ours.transform_to_pcd(K), ref.transform_to_pcd(K))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_filter_types_round_trip(ftype):
    img = np.random.default_rng(ftype).integers(0, 65536, size=(7, 9)).astype(np.uint16)
    np.testing.assert_array_equal(decode_png16(encode_png16(img, ftype)), img)


def test_bad_png_raises(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"this is not a png")
    with pytest.raises(RuntimeError, match="Couldn't read image"):
        DepthImage(str(bad))
    with pytest.raises(RuntimeError):
        DepthImage(str(tmp_path / "missing.png"))
    with pytest.raises(RuntimeError, match="intrinsics"):
        read_intrinsics(str(tmp_path / "missing.K"))
    with pytest.raises(RuntimeError):
        DepthImage().data


def test_package_imports_without_jax():
    """Importing every module of the port (found by walking the package, so
    modules added later are covered) leaves jax and the JAX package out of
    sys.modules, and works with jax blocked."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "import deplex_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(deplex_tpu_torch.__path__,\n"
        "                                               'deplex_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "expected = {'deplex_tpu_torch.ops.cylinder', 'deplex_tpu_torch.parallel.launcher',\n"
        "            'deplex_tpu_torch.parallel.verify', 'deplex_tpu_torch.slam.frontend',\n"
        "            'deplex_tpu_torch.tools.kernel_bench', 'deplex_tpu_torch.kernels._build',\n"
        "            'deplex_tpu_torch.native', 'deplex_tpu_torch.profiling',\n"
        "            'deplex_tpu_torch.parallel.spatial', 'deplex_tpu_torch.oracle',\n"
        "            'deplex_tpu_torch.oracle.reference_impl', 'deplex_tpu_torch.association',\n"
        "            'deplex_tpu_torch.tools.make_sequence',\n"
        "            'deplex_tpu_torch.examples.run_slam',\n"
        "            'deplex_tpu_torch.examples.process_cloud',\n"
        "            'deplex_tpu_torch.examples.process_sequence',\n"
        "            'deplex_tpu_torch.examples.extract_primitives'}\n"
        "assert expected <= set(names), sorted(expected - set(names))\n"
        "assert deplex_tpu_torch.PlaneSlam is deplex_tpu_torch.slam.frontend.PlaneSlam\n"
        "import deplex_tpu_torch.kernels._build as b\n"
        "bad = [m for m in sys.modules if (m.startswith('jax') and sys.modules[m] is not None)\n"
        "       or m == 'deplex_tpu' or m.startswith('deplex_tpu.')]\n"
        "assert not bad, bad\n"
        "assert b._lib is None\n"
        "import deplex_tpu_torch.native as n\n"
        "assert n._lib is None\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


def test_kernel_build_dir_is_in_the_checkout(tmp_path, monkeypatch):
    """The kernels build into build/deplex_tpu_torch of the checkout, and
    outside a checkout the build raises instead of writing elsewhere."""
    from deplex_tpu_torch.kernels import _build

    assert _build.build_dir() == ROOT / "build" / "deplex_tpu_torch"
    monkeypatch.setattr(_build, "CHECKOUT", tmp_path)
    with pytest.raises(RuntimeError, match="source checkout"):
        _build.library_path()


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper runs its twin only for CPU tensors; any other device must
    launch the kernel or raise (here: the meta device raises)."""
    from deplex_tpu_torch.kernels.cellstats import cell_moments

    with pytest.raises(ValueError, match="unsupported device"):
        cell_moments(torch.empty((1, 20, 20), dtype=torch.int16, device="meta"),
                     torch.eye(3), Config())
