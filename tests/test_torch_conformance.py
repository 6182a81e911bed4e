"""deplex_tpu_torch's golden conformance on the CPU twins, against the JAX
package: ICL-NUIM at the default config (BASELINE.json config 1), the
``tools.conformance`` report of the three shipped configs, and
``tools.conformance_decomposition`` against ``scripts/conformance_decomposition.py``
(loaded by path). The top-level ``extract_primitives`` is the pipeline's.
"""

import importlib.util
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import deplex_tpu_torch
from deplex_tpu import Config as JaxConfig
from deplex_tpu.pipeline import extract_planes_from_depth_jit as jax_extract_from_depth
from deplex_tpu_torch import Config, PlaneExtractor
from deplex_tpu_torch.tools import conformance, conformance_decomposition
from deplex_tpu_torch.tools._common import write_report

from .conftest import DATA, label_f1, load_golden

ROOT = DATA.parent


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_labels(name: str) -> np.ndarray:
    ini = conformance.CONFIGS[name][2]
    depth, K, _, _ = conformance.load_case(name)
    cfg = JaxConfig.from_ini(str(DATA / "configs" / ini)) if ini else JaxConfig()
    return np.asarray(jax_extract_from_depth(jnp.asarray(depth), jnp.asarray(K), config=cfg))


@pytest.fixture(scope="module")
def report():
    return conformance.run("cpu")


def test_top_level_extract_primitives_is_the_pipelines():
    from deplex_tpu_torch import pipeline

    assert deplex_tpu_torch.extract_primitives is pipeline.extract_primitives
    assert "extract_primitives" in deplex_tpu_torch.__all__


def test_icl_default_golden_f1_and_equal_to_jax():
    """BASELINE.json config 1: the ICL frame at the default config (P=10),
    the bound of tests/test_extractor.py; the port's labels are the JAX
    package's, pixel for pixel."""
    depth, K, cfg, gold = conformance.load_case("icl_default")
    assert cfg == Config()
    got = PlaneExtractor(480, 640, cfg, device="cpu").process_depth(depth, K)
    f1, p, r = label_f1(got, load_golden("icl_default_labels"))
    assert f1 >= 0.95, (f1, p, r)
    np.testing.assert_array_equal(got, _jax_labels("icl_default"))


@pytest.mark.parametrize("name", sorted(conformance.CONFIGS))
def test_report_matches_jax_per_config(report, name):
    """Each config's F1 and plane count are the JAX package's own on the
    same frame (ICL ini: the same partition under other label numbers)."""
    entry = report["configs"][name]
    ref = _jax_labels(name)
    gold = conformance.load_case(name)[3]
    assert entry["planes"] == int(ref.max())
    assert entry["f1"] == round(label_f1(ref, gold)[0], 4)
    assert entry["f1"] >= conformance.F1_BOUND and entry["pass"]
    assert entry["card_vs_cpu_equal"] is None          # no card here


def test_report_and_exit_code(report, tmp_path, capsys, monkeypatch):
    assert report["pass"] and report["device"] == "cpu" and report["gpu"] is None
    assert report["configs"]["tum_default"]["planes"] == 34
    out = tmp_path / "conf.json"
    assert conformance.main(["--device", "cpu", "--configs", "icl_default",
                             "--out", str(out)]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == printed
    assert list(printed["configs"]) == ["icl_default"]
    # A failing bound exits 1.
    monkeypatch.setattr(conformance, "F1_BOUND", 1.01)
    assert conformance.main(["--device", "cpu", "--configs", "icl_default"]) == 1


def test_reports_are_never_written_under_data(tmp_path):
    with pytest.raises(ValueError, match="data/"):
        write_report(DATA / "golden" / "tpu_conformance.json", {})
    with pytest.raises(ValueError, match="data/"):
        write_report(DATA / "x" / ".." / "y.json", {})
    assert write_report(tmp_path / "r.json", {"a": 1}).read_text().strip() == '{\n  "a": 1\n}'


def _script():
    spec = importlib.util.spec_from_file_location(
        "jax_conformance_decomposition", ROOT / "scripts" / "conformance_decomposition.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tum_labels():
    depth, K, cfg, gold = conformance.load_case("tum_default")
    return PlaneExtractor(480, 640, cfg, device="cpu").process_depth(depth, K), gold


def test_match_planes_and_canon_equal_the_scripts(tum_labels):
    labels, gold = tum_labels
    script = _script()
    assert conformance_decomposition.match_planes(labels, gold) == \
        script.match_planes(labels, gold)
    # canon puts each matched plane on its golden id, and every other plane
    # on an id of its own past the golden's (the script's canon, which the
    # zero-perturbation report below holds as a whole).
    matches = script.match_planes(labels, gold)
    cb = conformance_decomposition.canon(labels, gold)
    for g, p in matches.items():
        if p is not None:
            assert set(np.unique(cb[labels == p])) == {g}
    unmatched = set(np.unique(labels[labels > 0])) - {p for p in matches.values() if p}
    assert all(int(np.unique(cb[labels == p])[0]) > int(gold.max()) for p in unmatched)


def test_zero_perturbation_report_equals_the_scripts(tmp_path, monkeypatch):
    ours = conformance_decomposition.run("cpu", perturbations=0)
    out = tmp_path / "decomposition.json"
    monkeypatch.setattr(sys, "argv", ["conformance_decomposition.py", "--perturbations", "0",
                                      "--out", str(out)])
    _script().main()
    ref = json.loads(out.read_text())
    for key in ("frame", "config", "golden", "perturbations", "perturbation_model", "total_px",
                "disagree_px", "disagree_frac", "stable_disagree_px",
                "stable_frac_of_disagreement", "disagreement_breakdown_px", "planes"):
        assert ours[key] == ref[key], key
    assert ours["stable_frac_of_disagreement"] == 1.0      # no jitter: all stable
