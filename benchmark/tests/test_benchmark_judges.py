"""Each configuration names the judge that decides a run's ``correct``
(``benchmark/judges/<judge>.py``, ``labels`` without the key): every
existing cell resolves to the plane-label judge, a judge with no file stops
a run at ``resolve``, and a cell whose outputs are not plane labels is
found, judged and controlled through new files only."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.test_benchmark_spec import _copy_tree

ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")

# A stub of a cell whose program returns poses: its driver runs the port's
# SE(3) exponential on seeded twists, its judge holds the poses to a matrix
# exponential in float64, and its control's stand-in is that reference on
# twists rounded to bfloat16.
STUB_DRIVER = '''
import torch

from benchmark.drivers import Reservoir, Window, sync


class Driver:
    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, device
        t = cell.traffic
        self.batch, self.ring_batches = int(t["batch"]), int(t["ring_batches"])
        self.sample = Reservoir(seed, int(t["sample_calls"]))
        self.trace_calls = int(t["trace_calls"])

    def setup(self):
        from deplex_tpu_torch.slam import lie

        g = torch.Generator(device=self.device).manual_seed(self.seed % 2 ** 63)
        self.ring = torch.randn((self.ring_batches, self.batch, 6), generator=g,
                                device=self.device)
        self.lie = lie
        lie.se3_exp(self.ring[0])
        sync(self.device)

    def window(self, w: Window):
        calls = 0
        w.begin()
        while w.running():
            with w.span(calls):
                out = self.lie.se3_exp(self.ring[calls % self.ring_batches])
            self.sample.offer(calls, (calls % self.ring_batches, out))
            w.after_call(calls)
            calls += 1
        return {"seconds": w.end(calls), "calls": calls, "frames": calls * self.batch}

    def judged(self):
        return [(r, self.ring[r], out) for _, (r, out) in self.sample.items()]

    def close(self):
        self.lie = None
'''

STUB_JUDGE = '''
import contextlib

import torch

from benchmark.judge import Verdict

LIMIT = 1e-5


def exp_reference(xi):
    """(N, 6) twists -> (R, t) by the matrix exponential of the 4x4 twist."""
    phi, rho = xi[:, :3].double(), xi[:, 3:].double()
    A = torch.zeros((xi.shape[0], 4, 4), dtype=torch.float64, device=xi.device)
    A[:, 0, 1], A[:, 0, 2], A[:, 1, 2] = -phi[:, 2], phi[:, 1], -phi[:, 0]
    A[:, 1, 0], A[:, 2, 0], A[:, 2, 1] = phi[:, 2], -phi[:, 1], phi[:, 0]
    A[:, :3, 3] = rho
    T = torch.linalg.matrix_exp(A)
    return T[:, :3, :3], T[:, :3, 3]


def judge(samples, cell, device, records=False):
    worst, judged, failed = 0.0, 0, 0
    for _, xi, (R, t) in samples:
        Rr, tr = exp_reference(xi.to(device))
        err = torch.maximum((R.to(device).double() - Rr).abs().amax((1, 2)),
                            (t.to(device).double() - tr).abs().amax(1))
        worst = max(worst, float(err.max()))
        failed += int((err > LIMIT).sum())
        judged += xi.shape[0]
    compared = {"poses_judged": {"value": judged, "limit": 1, "rule": "at least"},
                "max_abs_err": {"value": worst, "limit": LIMIT, "rule": "at most"}}
    return Verdict(judged >= 1 and worst <= LIMIT, failed, compared)


@contextlib.contextmanager
def in_place_of_program(cell, device):
    from deplex_tpu_torch.slam import lie

    def se3_exp(xi):
        R, t = exp_reference(xi.to(torch.bfloat16).float())
        return R.float(), t.float()

    saved = lie.se3_exp
    lie.se3_exp = se3_exp
    try:
        yield
    finally:
        lie.se3_exp = saved
'''


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_existing_cell_resolves_to_the_labels_judge(workload):
    cell = harness.resolve(workload)
    assert "judge" not in cell.config
    assert cell.judge.__file__ == str(ROOT / "benchmark" / "judges" / "labels.py")


def _add_cell(root, config: str, judge: str, traffic: str, mix: dict) -> str:
    """A configuration naming `judge`, a mix and their cell, as new files and
    new entries of the copy's BENCHMARK.json."""
    conf = json.loads((root / "benchmark/configs/tum_default.json").read_text())
    conf.update(name=config, judge=judge)
    (root / "benchmark/configs" / f"{config}.json").write_text(json.dumps(conf))
    (root / "benchmark/traffic" / f"{traffic}.json").write_text(json.dumps(mix))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": config, "source": "https://example.org/x",
                            "file": f"benchmark/configs/{config}.json", "reduced": [],
                            "why": "test"})
    name = f"{config}.{traffic}"
    spec["workloads"].append({"name": name, "config": config, "traffic": traffic,
                              "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return name


def test_a_judge_with_no_file_stops_at_resolve(tmp_path):
    root = _copy_tree(tmp_path)
    name = _add_cell(root, "tum_misjudged", "no_such_judge", "resident_b1",
                     {"driver": "resident", "batch": 1, "ring_batches": 1,
                      "sample_calls": 1, "trace_calls": 1})
    missing = root / "benchmark" / "judges" / "no_such_judge.py"
    with pytest.raises(SystemExit, match=str(missing)):
        harness.resolve(name, root=root)
    # A run stops there too, before it looks for a card or sets anything up.
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                           "1", "--seconds", "1", "--trace", "0"], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and str(missing) in proc.stderr
    assert "CUDA card" not in proc.stderr
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def stub(tmp_path_factory):
    """A copy of the tree with the pose cell added as new files only; the
    bytes of the copy's existing .py files before the cell was added."""
    root = _copy_tree(tmp_path_factory.mktemp("stub"))
    before = {p.relative_to(root): p.read_bytes() for p in (root / "benchmark").rglob("*.py")}
    (root / "benchmark/drivers/twists.py").write_text(STUB_DRIVER)
    (root / "benchmark/judges/poses_stub.py").write_text(STUB_JUDGE)
    name = _add_cell(root, "poses_stub", "poses_stub", "twists_b16",
                     {"driver": "twists", "batch": 16, "ring_batches": 3,
                      "sample_calls": 2, "trace_calls": 2})
    return root, name, before


def _stub_cell(stub):
    root, name, _ = stub
    cell = harness.resolve(name, root=root)
    assert cell.judge.__file__ == str(root / "benchmark/judges/poses_stub.py")
    return root, cell


def _stub_run(stub):
    root, cell = _stub_cell(stub)
    return harness.run(cell, 2 ** 31 + 7, 0.2, False, CPU, 0.0, root=root, log=lambda *a: None)


def test_a_cell_with_its_own_judge_runs_and_is_correct(stub):
    out = _stub_run(stub)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["compared"]) == {"poses_judged", "max_abs_err"}
    assert out["compared"]["poses_judged"]["value"] >= 16
    assert out["compared"]["max_abs_err"]["value"] <= 1e-5
    assert list(out)[-1] == "compared"


def test_a_cell_with_its_own_judge_is_not_correct_when_an_output_is_altered(stub,
                                                                           monkeypatch):
    from deplex_tpu_torch.slam import lie

    original = lie.se3_exp

    def se3_exp(xi):
        R, t = original(xi)
        R = R.clone()
        R[0, 0, 0] += 0.01
        return R, t
    monkeypatch.setattr(lie, "se3_exp", se3_exp)
    out = _stub_run(stub)
    assert out["correct"] is False and out["failed"] >= 1
    assert out["compared"]["max_abs_err"]["value"] > 1e-5


def test_the_control_of_a_cell_uses_its_judges_stand_in(stub):
    from deplex_tpu_torch.slam import lie

    original = lie.se3_exp
    root, cell = _stub_cell(stub)
    out = control.control_run(cell, 2 ** 31 + 7, 0.2, CPU, log=lambda *a: None, root=root)
    assert out["correct"] is False and out["failed"] >= 1
    assert out["compared"]["max_abs_err"]["value"] > 1e-5
    assert lie.se3_exp is original


def test_adding_the_cell_edited_no_existing_python_file(stub):
    root, _, before = stub
    _stub_run(stub)
    after = {p.relative_to(root): p.read_bytes() for p in (root / "benchmark").rglob("*.py")
             if p.relative_to(root) in before}
    assert after == before
