"""deplex_tpu_torch's file formats held to the reference package: the CSV
protocol of utils/io.py (byte-equal files, equal arrays), the PNG16 encoder
of utils/depth_image.py, and tools/make_sequence against
scripts/make_sequence.py (run in a subprocess)."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from deplex_tpu.utils import io as jax_io
from deplex_tpu_torch import native
from deplex_tpu_torch.tools import make_sequence
from deplex_tpu_torch.utils import io
from deplex_tpu_torch.utils.depth_image import (DepthImage, _python_load_png16, decode_png16,
                                                encode_png16)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _cloud(seed=0):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(50, 3)) * 1000).astype(np.float32)
    pts[::7] = 0.0
    pts[3] = [1e-7, -2.5e9, 123456.789]
    return pts


@pytest.mark.parametrize("writer", ["save_pcd_csv", "save_labels_csv"])
def test_csv_writers_are_byte_equal_to_jax(writer, tmp_path):
    data = (_cloud() if writer == "save_pcd_csv"
            else np.random.default_rng(1).integers(0, 40, 200).astype(np.int32))
    getattr(io, writer)(data, str(tmp_path / "ours.csv"))
    getattr(jax_io, writer)(data, str(tmp_path / "ref.csv"))
    assert (tmp_path / "ours.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()


@pytest.mark.parametrize("delimiter", [",", " "])
def test_read_pcd_csv_equals_jax(delimiter, tmp_path):
    path = tmp_path / "c.csv"
    np.savetxt(path, _cloud(2), delimiter=delimiter, fmt="%.6f")
    ours = io.read_pcd_csv(str(path), delimiter)
    assert ours.dtype == np.float32 and ours.shape == (50, 3)
    np.testing.assert_array_equal(ours, jax_io.read_pcd_csv(str(path), delimiter))
    io.save_pcd_csv(ours, str(tmp_path / "again.csv"))
    np.testing.assert_array_equal(io.read_pcd_csv(str(tmp_path / "again.csv")),
                                  np.loadtxt(tmp_path / "again.csv", delimiter=",",
                                             dtype=np.float32))


def test_read_pcd_csv_refuses_a_bad_shape(tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text("1,2\n3,4\n")
    for mod in (io, jax_io):
        with pytest.raises(RuntimeError, match="Invalid points shape"):
            mod.read_pcd_csv(str(path))


def test_labels_round_trip_through_the_reference_protocol(tmp_path):
    labels = np.random.default_rng(3).integers(0, 35, 640).astype(np.int32)
    io.save_labels_csv(labels, str(tmp_path / "l.csv"))
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "l.csv", dtype=np.int32), labels)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_png_encoder_round_trips_through_both_decoders_and_pil(filter_type, tmp_path):
    img = np.random.default_rng(10 + filter_type).integers(0, 2**16, (37, 53)).astype(np.uint16)
    data = encode_png16(img, filter_type)
    path = tmp_path / "e.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(decode_png16(data), img)
    np.testing.assert_array_equal(native.decode_png16(str(path)), img)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im).astype(np.uint16), img)


def test_png_encoder_round_trips_the_tum_frame(tmp_path):
    tum = DepthImage(str(ROOT / "data/tum/1341848230.910894.png")).data
    path = tmp_path / "tum.png"
    path.write_bytes(encode_png16(tum, 4))
    np.testing.assert_array_equal(native.decode_png16(str(path)), tum)
    np.testing.assert_array_equal(_python_load_png16(str(path)), tum)


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    """3 frames from the port's tool and from the reference's script."""
    tmp = tmp_path_factory.mktemp("seq")
    ours = make_sequence.write_sequence(tmp / "ours", str(ROOT / "data/tum/1341848230.910894.png"),
                                        str(ROOT / "data/configs/TUM_fr3_long_val.K"), 3)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, str(ROOT / "scripts/make_sequence.py"), "--out",
                    str(tmp / "ref"), "--frames", "3"], check=True, env=env, cwd=str(ROOT),
                   capture_output=True, timeout=300)
    return tmp, ours


def test_make_sequence_frames_equal_the_reference_script(sequences):
    tmp, ours = sequences
    assert [p.name for p in ours] == ["000000.png", "000001.png", "000002.png"]
    ref = sorted((tmp / "ref").glob("*.png"))
    assert [p.name for p in ref] == [p.name for p in ours]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(native.decode_png16(str(a)), native.decode_png16(str(b)))


def test_make_sequence_trajectory_and_manifest_equal_the_reference_script(sequences):
    tmp, _ = sequences
    ours, ref = np.load(tmp / "ours/trajectory_gt.npz"), np.load(tmp / "ref/trajectory_gt.npz")
    assert sorted(ours.files) == sorted(ref.files) == ["R", "t"]
    for k in ("R", "t"):
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])
    m_ours = json.loads((tmp / "ours/manifest.json").read_text())
    m_ref = json.loads((tmp / "ref/manifest.json").read_text())
    assert m_ours.keys() == m_ref.keys()
    assert {k: m_ours[k] for k in ("image", "intrinsics", "frames", "seed")} == \
        {k: m_ref[k] for k in ("image", "intrinsics", "frames", "seed")}


def test_make_sequence_cli(tmp_path):
    assert make_sequence.main(["--out", str(tmp_path / "s"), "--frames", "2", "--seed", "4"]) == 0
    assert sorted(p.name for p in (tmp_path / "s").iterdir()) == \
        ["000000.png", "000001.png", "manifest.json", "trajectory_gt.npz"]
    assert json.loads((tmp_path / "s/manifest.json").read_text())["seed"] == 4
