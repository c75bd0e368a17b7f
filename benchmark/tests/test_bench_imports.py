"""What the benchmark loads: a whole run of every cell, in a fresh process,
loads no module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
``spmv_research_tpu`` (names compared whole: the port's
``spmv_research_tpu_torch`` begins with the JAX package's name), and the
reference loads nothing of the port. Without a CUDA device the command
prints no result and exits with another code than 0."""

import json
import os
import subprocess
import sys

from conftest import ROOT

RUN_ALL = """
import json, sys, time
from benchmark import harness, matrices
matrices.CACHE_DIR = {cache!r}
bench = harness.Bench({spec!r}, {base!r})
for w in [w["name"] for w in bench.spec["workloads"]]:
    for trace in (False, True):
        cell = harness.prepare(bench, w, "cpu", trace)
        assert harness.run_seed(cell, 5, 0.2, time.perf_counter())["correct"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _python(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_of_every_cell_loads_no_jax(tiny_bench, tmp_path):
    env = dict(os.environ, SPARSE_FORMAT_CACHE_TORCH=str(tmp_path / "fc"))
    env.pop("JAX_PLATFORMS", None)
    out = _python(RUN_ALL.format(cache=str(tmp_path / "mc"),
                                 spec=str(tmp_path / "BENCHMARK.json"),
                                 base=tiny_bench.base), env)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.splitlines()[-1]))
    assert "spmv_research_tpu_torch" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "spmv_research_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    out = _python("import json, sys\n"
                  "from benchmark import reference, matrices, metrics\n"
                  "print(json.dumps(sorted({m.split('.')[0] "
                  "for m in sys.modules})))")
    assert out.returncode == 0, out.stderr
    names = set(json.loads(out.stdout.splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "spmv_research_tpu",
                        "spmv_research_tpu_torch"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark import harness
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "spmv_research_tpu_torch.extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "spmv_research_tpu.core", sys)
    assert "spmv_research_tpu" in harness.forbidden_modules()


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run",
                          "--workload", "ldoor.spmv", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
