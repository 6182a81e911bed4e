"""deplex_tpu_torch.native (the C++ PNG16 decoder, back-projection and
SequenceLoader, built by g++ from the port's own sources) held to the
reference package's native library, to PIL and to the port's Python
decoder, bit for bit; the cases of tests/test_native.py."""

import ctypes
import pathlib
import threading

import numpy as np
import pytest
from PIL import Image

import deplex_tpu.native as jax_native

# The port needs torch; a runner without it skips this file.
torch = pytest.importorskip("torch")
from deplex_tpu_torch import native
from deplex_tpu_torch.utils.depth_image import (DepthImage, _python_load_png16, backproject,
                                                decode_png16, encode_png16, write_png16)
from deplex_tpu_torch.utils.io import read_intrinsics

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"
FRAMES = {"tum": ("tum/1341848230.910894.png", "configs/TUM_fr3_long_val.K"),
          "icl": ("icl_nuim/0.png", "configs/ICL_living_room.K")}


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.available(), "the native library did not build"
    assert native.build_info["libz"].split("/")[-1].startswith("libz.so")


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_decode_equals_jax_native_pil_and_python(frame):
    path = str(DATA / FRAMES[frame][0])
    ours = native.decode_png16(path)
    assert ours.dtype == np.uint16 and ours.shape == (480, 640)
    np.testing.assert_array_equal(ours, jax_native.decode_png16(path))
    with Image.open(path) as im:
        np.testing.assert_array_equal(ours, np.asarray(im).astype(np.uint16))
    np.testing.assert_array_equal(ours, _python_load_png16(path))


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_decode_each_filter_type_equals_python(filter_type, tmp_path):
    """Every row filtered by one type (4: Paeth), through both decoders."""
    img = np.random.default_rng(filter_type).integers(0, 2**16, (48, 64)).astype(np.uint16)
    img[16:32] = np.arange(64, dtype=np.uint16)[None, :] * 37       # smooth rows
    path = tmp_path / "f.png"
    write_png16(path, img, filter_type)
    got = native.decode_png16(str(path))
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, decode_png16(path.read_bytes()))
    np.testing.assert_array_equal(got, jax_native.decode_png16(str(path)))


def test_decode_pil_adaptive_filters(tmp_path):
    """tests/test_native.py's mix: PIL picks a filter per row."""
    rng = np.random.default_rng(0)
    img = np.zeros((64, 64), np.uint16)
    img[:16] = rng.integers(0, 2**16, size=(16, 64))
    img[16:32] = np.arange(64, dtype=np.uint16)[None, :] * 37
    img[32:48] = np.arange(16, dtype=np.uint16)[:, None] * 1000
    img[48:] = 7
    p = tmp_path / "t.png"
    Image.fromarray(img, mode="I;16").save(p)
    np.testing.assert_array_equal(native.decode_png16(str(p)), img)


def test_invalid_content_raises_and_declined_formats_return_none(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all")
    with pytest.raises(RuntimeError):
        native.decode_png16(str(bad))
    truncated = tmp_path / "truncated.png"
    truncated.write_bytes(encode_png16(np.ones((8, 8), np.uint16))[:40])
    with pytest.raises(RuntimeError):
        native.decode_png16(str(truncated))
    with pytest.raises(RuntimeError):
        native.decode_png16(str(tmp_path / "missing.png"))
    rgb = tmp_path / "rgb.png"
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(rgb)
    assert native.decode_png16(str(rgb)) is None
    assert jax_native.decode_png16(str(rgb)) is None


def test_backproject_equals_jax_native_and_numpy():
    rng = np.random.default_rng(1)
    depth = rng.integers(0, 46656, size=(48, 64)).astype(np.uint16)
    fx, fy, cx, cy = 525.0, 520.0, 31.5, 23.5
    ours = native.backproject(depth, fx, fy, cx, cy)
    np.testing.assert_array_equal(ours, jax_native.backproject(depth, fx, fy, cx, cy))
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    np.testing.assert_array_equal(ours, backproject(depth, K))


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_backproject_real_frames_equal_utils(frame):
    img = DepthImage(str(DATA / FRAMES[frame][0]))
    K = read_intrinsics(str(DATA / FRAMES[frame][1]))
    np.testing.assert_array_equal(native.backproject(img.data, K[0, 0], K[1, 1], K[0, 2],
                                                     K[1, 2]), img.transform_to_pcd(K))


def _write_frames(tmp_path, n, shape=(32, 48), seed=7):
    rng = np.random.default_rng(seed)
    paths, frames = [], []
    for i in range(n):
        img = rng.integers(0, 2**16, size=shape).astype(np.uint16)
        img[0, 0] = i                                   # order marker
        paths.append(str(tmp_path / f"{i:03d}.png"))
        write_png16(paths[-1], img, filter_type=i % 5)
        frames.append(img)
    return paths, frames


def test_sequence_loader_ordered(tmp_path):
    """9 frames, 3 workers, a ring of 3: in order, equal to direct decodes."""
    paths, frames = _write_frames(tmp_path, 9)
    loader = native.SequenceLoader(paths, width=48, height=32, queue_depth=3, workers=3)
    got = list(loader)
    loader.close()
    assert len(got) == 9
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, f)
    assert loader.next_depth() is None                  # closed: nothing more


def test_sequence_loader_cloud(tmp_path):
    img = (np.arange(32 * 48).reshape(32, 48) % 5000).astype(np.uint16)
    p = tmp_path / "f.png"
    write_png16(p, img)
    K = np.array([[100.0, 0, 23.5], [0, 100.0, 15.5], [0, 0, 1]], np.float32)
    loader = native.SequenceLoader([str(p)], width=48, height=32)
    cloud = loader.next_cloud(K)
    assert loader.next_cloud(K) is None
    loader.close()
    np.testing.assert_array_equal(cloud, native.backproject(img, 100.0, 100.0, 23.5, 15.5))


def test_sequence_loader_refuses_a_frame_of_another_size(tmp_path):
    paths, _ = _write_frames(tmp_path, 2)
    loader = native.SequenceLoader(paths, width=40, height=32)
    with pytest.raises(RuntimeError, match="rc=-10"):
        loader.next_depth()
    loader.close()


def test_decode_counts_count_each_decoder(tmp_path):
    paths, frames = _write_frames(tmp_path, 4)
    native.reset_decode_counts()
    for p in paths[:2]:
        DepthImage(p)
    loader = native.SequenceLoader(paths, width=48, height=32)
    assert len(list(loader)) == 4
    loader.close()
    assert native.decode_counts() == {"native": 6, "python": 0}
    _python_load_png16(paths[0])
    assert native.decode_counts() == {"native": 6, "python": 1}
    native.reset_decode_counts()
    assert native.decode_counts() == {"native": 0, "python": 0}


def test_decode_calls_release_the_interpreter_lock(tmp_path):
    """Threads decode concurrently (ctypes.CDLL drops the lock in the call):
    each thread's frames come back intact."""
    paths, frames = _write_frames(tmp_path, 8, shape=(120, 160))
    results = [None] * len(paths)

    def work(i):
        results[i] = native.decode_png16(paths[i])

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(paths))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for got, want in zip(results, frames):
        np.testing.assert_array_equal(got, want)
    assert isinstance(native._load(), ctypes.CDLL)
    assert not isinstance(native._load(), ctypes.PyDLL)


def test_library_builds_in_the_checkout():
    from deplex_tpu_torch.kernels._build import build_dir

    path = native.library_path()
    assert path.parent == build_dir() and path.exists()
    assert native.build_info["library"] == path.name


def test_library_refuses_to_build_outside_a_checkout(tmp_path, monkeypatch):
    """Like the CUDA kernels, the native library builds only inside a source
    checkout. Outside one it loads the installed package's prebuilt library
    and raises when that is missing (no numpy-decoder fallback: an install
    without its library is broken); in a checkout where it cannot be built,
    DepthImage falls back to the numpy decoder."""
    from deplex_tpu_torch.kernels import _build

    checkout = _build.CHECKOUT
    monkeypatch.setattr(_build, "CHECKOUT", tmp_path)
    monkeypatch.setattr(_build, "PREBUILT", tmp_path / "_prebuilt")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    with pytest.raises(RuntimeError, match="source checkout"):
        native._load()
    native.reset_decode_counts()
    with pytest.raises(_build.PrebuiltMissing, match=native.library_name()):
        native.available()
    with pytest.raises(_build.PrebuiltMissing):
        DepthImage(str(DATA / FRAMES["tum"][0]))
    assert native.decode_counts() == {"native": 0, "python": 0}
    assert not (tmp_path / "_prebuilt").exists()

    def no_compiler(*args, **kwargs):
        raise RuntimeError("g++ failed")
    monkeypatch.setattr(_build, "CHECKOUT", checkout)
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "libdeplex_native_x.so")
    monkeypatch.setattr(native, "compile_library", no_compiler)
    assert not native.available()
    img = DepthImage(str(DATA / FRAMES["tum"][0]))
    assert img.data.shape == (480, 640)
    assert native.decode_counts() == {"native": 0, "python": 1}
