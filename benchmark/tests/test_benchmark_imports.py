"""What the benchmark may import and read, and how a run without a card or
without the program ends."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = ROOT / "benchmark"

# Run in a fresh interpreter: a finder that refuses every module whose
# top-level name (before the first dot) is one of BLOCKED, compared whole,
# then each module imported by name; prints the forbidden top-level names
# that got loaded anyway.
_PROBE = r"""
import importlib, importlib.abc, sys
BLOCKED = set(sys.argv[1].split(","))
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, sys.argv[2])
for mod in sys.argv[3:]:
    importlib.import_module(mod)
print(sorted({m.split(".")[0] for m in sys.modules} & BLOCKED))
"""


def _modules(sub: str) -> list[str]:
    base = BENCH / sub if sub else BENCH
    out = []
    for p in sorted(base.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        if "tests" in rel.parts or "." in p.stem or rel.name == "__init__":
            continue
        out.append(".".join(rel.parts))
    return out


def _probe(blocked: str, modules: list[str]) -> list[str]:
    proc = subprocess.run([sys.executable, "-c", _PROBE, blocked, str(ROOT), *modules],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1].replace("'", '"'))


def test_every_module_imports_with_jax_and_the_jax_package_blocked():
    mods = _modules("") + ["benchmark.run", "benchmark.control"]
    assert "benchmark.harness" in mods and "benchmark.drivers.camera" in mods
    assert _probe("jax,jaxlib,flax,deplex_tpu", mods) == []


def test_the_metric_readers_load_with_jax_and_the_jax_package_blocked():
    code = ("import sys; sys.path.insert(0, %r); from benchmark import harness\n"
            "for p in sorted((harness.BENCH / 'metrics').glob('*.py')):\n"
            "    harness.reader(p.stem)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'deplex_tpu'}))") % str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules("reference") + ["benchmark.costs"]
    assert "benchmark.reference.stages" in mods
    assert _probe("jax,jaxlib,flax,deplex_tpu,deplex_tpu_torch", mods) == []


def test_the_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("deplex_tpu_torch", "deplex_tpu_torch.pipeline", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "deplex_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["deplex_tpu.ops", "jax"]


def test_nothing_reads_the_jax_packages_records():
    for p in BENCH.rglob("*.py"):
        if "tests" in p.parts:
            continue
        text = p.read_text()
        assert not re.search(r"(?<![\w/])bench\.py|BENCH_r|MULTICHIP_", text), p
        assert not re.search(r"^\s*(import|from) (jax|jaxlib|flax|deplex_tpu)\b(?!_)", text,
                             re.M), p


def _result_lines(stdout: str) -> list[str]:
    return [ln for ln in stdout.splitlines() if ln.startswith("{")]


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "tum_default.resident_b64", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and _result_lines(proc.stdout) == []
    assert "needs 1 CUDA card" in proc.stderr


def test_a_run_with_only_the_benchmark_fails_and_prints_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "tum_default.resident_b64", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and _result_lines(proc.stdout) == []
