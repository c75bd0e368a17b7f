"""Discovery by name, a cell added with new files only, and a whole run of
each cell on the CPU at a tiny size."""

import hashlib
import json
import os
import time

import pytest

from benchmark import harness

from conftest import BENCH_DIR, ROOT

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def test_every_name_has_its_files():
    bench = harness.Bench()
    for c in SPEC["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg, _ = bench.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    for w in WORKLOADS:
        entry = bench.workload(w)
        op = bench.op(bench.traffic(entry["traffic"])["op"])
        for fn in ("setup", "warm", "window", "after_window", "end_to_end",
                   "counts", "check"):
            assert callable(getattr(op, fn)), (w, fn)
        assert bench.limits(w)
        assert {m["name"] for m in bench.end_to_end(w)} >= {"setup_s"}
        assert bench.per_layer(w)
    for m in SPEC["per_layer"]:
        assert callable(bench.reader(m["name"]).read)
    with pytest.raises(KeyError):
        bench.workload("no.such.cell")


def _run(bench, workload, trace, seconds=0.3, seed=2**31 + 11):
    cell = harness.prepare(bench, workload, "cpu", trace)
    return harness.run_seed(cell, seed, seconds, time.perf_counter())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cell_runs_and_is_correct_on_the_cpu(tiny_bench, workload):
    out = _run(tiny_bench, workload, False)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in
                                   tiny_bench.end_to_end(workload)}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "cpu"
    traced = _run(tiny_bench, workload, True)
    assert traced["correct"] is True
    names = {m["name"] for m in tiny_bench.per_layer(workload)}
    # the CPU has no device trace, so only the host's metrics are read
    assert "build_s" in traced["metrics"]
    assert set(traced["metrics"]) <= names
    assert not any(k.endswith("_roofline") or k.startswith("launches")
                   for k in traced["metrics"])
    assert {"busy_s", "window_s"} <= set(traced["device"])


@pytest.mark.parametrize("workload", [w for w in WORKLOADS
                                      if w.endswith(".cg")])
def test_cg_notes_keep_the_profiled_solves_apart(tiny_bench, workload):
    cell = harness.prepare(tiny_bench, workload, "cpu", True)
    harness.run_seed(cell, 2**31 + 5, 0.3, time.perf_counter())
    lines = cell.op.notes(cell)
    profiled = cell.window["profiled"]
    assert len(profiled) == 1 + cell.traffic["trace_solves"]
    assert f"{len(cell.window['times']) - len(profiled)} unprofiled" in lines[0]
    assert len(lines[1].split(": ")[1].split()) == len(profiled)


def _digest(path):
    h = hashlib.sha256()
    for dirpath, _, files in sorted(os.walk(path)):
        for f in sorted(files):
            if "__pycache__" not in dirpath and ".cache" not in dirpath:
                with open(os.path.join(dirpath, f), "rb") as fh:
                    h.update(f.encode() + fh.read())
    return h.hexdigest()


def test_a_cell_and_a_metric_added_with_new_files_only(tiny_bench):
    before = _digest(tiny_bench.base)
    base = tiny_bench.base
    # a new configuration, traffic mix, limit and per-layer reader
    cfg, _ = tiny_bench.config("shipsec1_spd")
    cfg.update(name="tiny_extra", twin_line="2000 2000 12 3 normal random "
               "0.05 0.5 1.5 0.8 21 tiny_extra", transform="make_spd")
    with open(os.path.join(base, "configs", "tiny_extra.json"), "w") as f:
        json.dump(cfg, f)
    mix = dict(tiny_bench.traffic("spmv"), warm_calls=3, sample_answers=2)
    with open(os.path.join(base, "traffic", "spmv_short.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(base, "limits", "tiny_extra.spmv_short.json"),
              "w") as f:
        json.dump({"spmv_rel_err": 1e-5}, f)
    with open(os.path.join(base, "layer_metrics", "calls.window.py"),
              "w") as f:
        f.write("def read(cell):\n    return cell.window['calls']\n")
    spec = tiny_bench.spec
    spec["configs"].append({"name": "tiny_extra", "source": "test",
                            "file": "benchmark/configs/tiny_extra.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny_extra.spmv_short",
                              "config": "tiny_extra",
                              "traffic": "spmv_short", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "spmv_gnnz_s":
            m["workloads"].append("tiny_extra.spmv_short")
    spec["per_layer"].append({"name": "calls.window", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "dispatch", "moves": "spmv_gnnz_s",
                              "workloads": ["tiny_extra.spmv_short"]})
    plain = _run(tiny_bench, "tiny_extra.spmv_short", False)
    assert plain["correct"] is True
    assert set(plain["metrics"]) == {"spmv_gnnz_s", "setup_s"}
    traced = _run(tiny_bench, "tiny_extra.spmv_short", True)
    assert traced["metrics"]["calls.window"]["value"] >= 1
    # the files that were there are unchanged
    for name in ("configs/tiny_extra.json", "traffic/spmv_short.json",
                 "limits/tiny_extra.spmv_short.json",
                 "layer_metrics/calls.window.py"):
        os.remove(os.path.join(base, name))
    assert _digest(base) == before


def test_the_repository_benchmark_is_the_copied_one(tiny_bench):
    # the tiny copy differs only in its configurations and mixes
    for sub in ("ops", "layer_metrics", "limits"):
        for f in os.listdir(os.path.join(BENCH_DIR, sub)):
            if f.endswith((".py", ".json")):
                with open(os.path.join(BENCH_DIR, sub, f), "rb") as a, \
                        open(os.path.join(tiny_bench.base, sub, f), "rb") as b:
                    assert a.read() == b.read()
