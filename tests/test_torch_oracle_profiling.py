"""deplex_tpu_torch's serial oracle, profiling module and association
namespace, held to the reference package's: the oracle equals
deplex_tpu.oracle on a TUM crop and meets tests/test_oracle.py's bounds;
stage_timings has the reference's STAGES keys; annotate's ranges reach a
torch.profiler trace."""

import json
import pathlib

import numpy as np
import pytest
import torch

from deplex_tpu.config import Config as JaxConfig
from deplex_tpu.oracle import extract_planes_oracle as jax_oracle
from deplex_tpu.profiling import STAGES as JAX_STAGES
from deplex_tpu_torch import Config, PlaneExtractor, association, profiling
from deplex_tpu_torch.oracle import extract_planes_oracle
from deplex_tpu_torch.slam import association as slam_association

from .conftest import label_f1, load_golden

ROOT = pathlib.Path(__file__).resolve().parent.parent
CROP_H, CROP_W = 240, 320


@pytest.fixture(scope="module")
def crop(tum_cloud):
    pts, h, w = tum_cloud
    return np.ascontiguousarray(pts.reshape(h, w, 3)[:CROP_H, :CROP_W].reshape(-1, 3))


@pytest.mark.parametrize("config", ["default", "tum_ini"])
def test_oracle_equals_jax_oracle_on_a_crop(crop, config):
    ini = str(ROOT / "data/configs/TUM_fr3_long_val.ini")
    cfg, jcfg = ((Config(), JaxConfig()) if config == "default"
                 else (Config.from_ini(ini), JaxConfig.from_ini(ini)))
    ours = extract_planes_oracle(crop, CROP_H, CROP_W, cfg)
    assert ours.dtype == np.int32 and ours.max() > 0
    np.testing.assert_array_equal(ours, jax_oracle(crop, CROP_H, CROP_W, jcfg))


def test_oracle_matches_reference_golden(tum_cloud):
    """tests/test_oracle.py's bound on the full frame."""
    pts, h, w = tum_cloud
    f1, p, r = label_f1(extract_planes_oracle(pts, h, w, Config()),
                        load_golden("tum_default_labels"))
    assert f1 >= 0.98, (f1, p, r)


def test_pipeline_matches_oracle_on_crop(crop):
    got = PlaneExtractor(CROP_H, CROP_W, Config(), device="cpu").process(crop)
    f1, p, r = label_f1(got, extract_planes_oracle(crop, CROP_H, CROP_W, Config()))
    assert f1 >= 0.95, (f1, p, r)


def test_oracle_refuses_a_cloud_of_another_size(crop):
    with pytest.raises(ValueError, match="Number of points"):
        extract_planes_oracle(crop[:-1], CROP_H, CROP_W, Config())


@pytest.mark.parametrize("ini", ["TUM_fr3_long_val.ini", "TUM_fr3_long_val_ransac.ini"])
def test_stage_timings_have_the_reference_keys(tum_cloud, ini):
    pts, h, w = tum_cloud
    cfg = Config.from_ini(str(ROOT / "data/configs" / ini))
    times = profiling.stage_timings(pts, h, w, cfg, repeats=1, device="cpu")
    want = JAX_STAGES if cfg.ransac_refinement else JAX_STAGES[:4]
    assert profiling.STAGES == JAX_STAGES
    assert tuple(times) == want
    assert all(isinstance(t, float) and t > 0 for t in times.values())


def test_stage_timings_need_a_card_or_cpu(tum_cloud):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pts, h, w = tum_cloud
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.stage_timings(pts, h, w)


def test_annotated_stages_reach_a_trace(crop, tmp_path):
    ex = PlaneExtractor(CROP_H, CROP_W, Config(), device="cpu")
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("user_range"):
            ex.process(crop)
    names = {e.name for e in prof.events()}
    assert {"user_range", *JAX_STAGES[:4]} <= names
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    trace_names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert {"user_range", *JAX_STAGES[:4]} <= trace_names


def test_refinement_and_cylinder_stages_are_annotated(crop):
    ransac = Config.from_ini(str(ROOT / "data/configs/TUM_fr3_long_val_ransac.ini"))
    with torch.profiler.profile() as prof:
        PlaneExtractor(CROP_H, CROP_W, ransac, device="cpu").process(crop)
        PlaneExtractor(CROP_H, CROP_W, Config(), device="cpu").process_primitives(crop)
    names = {e.name for e in prof.events()}
    assert {"refinement", "cylinders"} <= names


def test_annotate_opens_no_profiler_range_when_nothing_records(crop, monkeypatch):
    """Without a profiler, a stage range is two checks: no record_function."""
    opened = []
    real = torch.profiler.record_function

    def recorder(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", recorder)
    PlaneExtractor(CROP_H, CROP_W, Config(), device="cpu").process(crop)
    assert opened == []
    with torch.profiler.profile():
        PlaneExtractor(CROP_H, CROP_W, Config(), device="cpu").process(crop)
    assert set(JAX_STAGES[:4]) <= set(opened)


def test_association_namespace(capsys):
    association.foo()
    assert capsys.readouterr().out == "Foo\n"
    assert association.associate is slam_association.associate
    assert association.AssociationParams is slam_association.AssociationParams
    assert association.Matches is slam_association.Matches
    assert association.__all__ == ["AssociationParams", "Matches", "associate", "foo"]
