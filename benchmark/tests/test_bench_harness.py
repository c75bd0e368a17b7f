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


# --- a cell over k ranks, added with new files only ------------------------

RANKS_CELL = "tiny_ranks.spmv"
ONE_CHIP_CELL = "shipsec1_spd.spmv"
DIST = "spmv_research_tpu_torch.parallel.dist"
RUN_LIMIT_S = 240     # one launcher run of a tiny cell on the CPU


def _ranks_format(spmv):
    """The port's row-sharded CSR over k ranks: its plan builder, the
    shard's format and its rank-local entry points."""
    return {"builder": f"{DIST}:plan_sharded_csr", "cache_key": "sharded_csr",
            "kwargs": {}, "format_name": "ShardedCSR", "mesh_axis": "rows",
            "entries": {"spmv": spmv,
                        "block": f"{DIST}:ShardedCSR.pad_vector",
                        "whole": f"{DIST}:ShardedCSR.unpad_vector"},
            "entry_kwargs": {"spmv": {"strategy": "allgather"}}}


def _add_ranks_cell(bench, chips=4, spmv=None):
    """A configuration of the row-sharded CSR over ``chips`` ranks on the
    tiny shipsec1 twin, its spmv cell, a limit and a reader of the ranks'
    slices; and the one-chip spmv cell of the same matrix in SELLW. Every
    file is new; the spec is written where ``benchmark.run`` reads it.
    The names of the files added, under the copy's base."""
    base = bench.base
    cfg, _ = bench.config("shipsec1_spd")
    cfg.update(name="tiny_ranks", format=_ranks_format(
        spmv or f"{DIST}:distributed_spmv"))
    added = {"configs/tiny_ranks.json": json.dumps(cfg),
             f"limits/{RANKS_CELL}.json": json.dumps({"spmv_rel_err": 1e-3}),
             f"limits/{ONE_CHIP_CELL}.json":
                 json.dumps({"spmv_rel_err": 1e-3}),
             "layer_metrics/slice_s.ranks.py":
                 '"""The slowest rank\'s traced slice, in seconds."""\n\n\n'
                 "def read(cell):\n"
                 "    info = cell.rank_info or []\n"
                 "    s = [r['window_s'] for r in info if 'window_s' in r]\n"
                 "    return max(s) if s else None\n",
             "layer_metrics/agree.ranks.py":
                 '"""The window\'s agreements in the traced slice."""\n\n\n'
                 "def read(cell):\n"
                 "    return cell.slice.count('window.agree') "
                 "if cell.slice else None\n"}
    for name, text in added.items():
        with open(os.path.join(base, name), "w") as f:
            f.write(text)
    spec = bench.spec
    spec["configs"].append({"name": "tiny_ranks", "source": "test",
                            "file": "benchmark/configs/tiny_ranks.json",
                            "reduced": [], "why": "test"})
    for name, config, k in ((RANKS_CELL, "tiny_ranks", chips),
                            (ONE_CHIP_CELL, "shipsec1_spd", 1)):
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": "spmv", "chips": k,
                                  "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "spmv_gnnz_s":
            m["workloads"] += [RANKS_CELL, ONE_CHIP_CELL]
    for name, unit in (("slice_s.ranks", "s"), ("agree.ranks", "count")):
        spec["per_layer"].append({"name": name, "unit": unit,
                                  "better": "lower", "source": "device_trace",
                                  "layer": "device", "moves": "spmv_gnnz_s",
                                  "workloads": [RANKS_CELL]})
    with open(os.path.join(os.path.dirname(base), "BENCHMARK.json"),
              "w") as f:
        json.dump(spec, f)
    return list(added)


def _launch(bench, workload, *extra, seconds=1.0, trace=0, seed=2**31 + 17,
            popen=False):
    """``python3 -m benchmark.run`` from the tiny copy's root, on the CPU
    (``--place cpu``) unless ``extra`` says otherwise."""
    import subprocess
    import sys
    root = os.path.dirname(bench.base)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               PYTHONUNBUFFERED="1")
    place = [] if "--place" in extra else ["--place", "cpu"]
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace), *place, *extra]
    if popen:
        return subprocess.Popen(cmd, cwd=root, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
    return subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=RUN_LIMIT_S)


def _result(proc):
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout   # only rank 0 writes to stdout
    return json.loads(lines[0])


def _answers(path):
    import numpy as np
    with np.load(path) as z:
        n = len({k.split("_")[0] for k in z.files})
        return [(z[f"a{i}_0"], z[f"a{i}_1"]) for i in range(n)]


@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_over_four_ranks_added_with_new_files_only(tiny_bench,
                                                          tmp_path, trace):
    before = _digest(tiny_bench.base)
    added = _add_ranks_cell(tiny_bench)
    out = _result(_launch(tiny_bench, RANKS_CELL, "--answers",
                          str(tmp_path / "ranks.npz"), trace=trace))
    assert out["correct"] is True and out["failed"] == 0
    dev = out["device"]
    assert dev["count"] == 4 and dev["platform"] == "cpu"
    ranks = dev["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    calls = {r["attempted"] for r in ranks}
    assert len(calls) == 1 and calls.pop() > 0   # the same calls on each
    assert out["attempted"] == sum(r["attempted"] for r in ranks)
    assert dev["memory_peak_bytes"] == max(r["memory_peak_bytes"]
                                           for r in ranks)
    if trace:
        assert {"build_s", "slice_s.ranks"} <= set(out["metrics"])
        # one agreement after each of the slice's calls, in its span
        assert out["metrics"]["agree.ranks"]["value"] == tiny_bench.traffic(
            "spmv")["trace_calls"]
        assert all({"busy_s", "window_s"} <= set(r) for r in ranks)
        assert {"busy_s", "window_s"} <= set(dev) and "breakdown" in out
    else:
        assert set(out["metrics"]) == {"spmv_gnnz_s", "setup_s"}
        assert all(v["value"] > 0 for v in out["metrics"].values())
        # the same matrix and seed at one chip, in SELLW: the same inputs
        # and, to float32's rounding, the same answers
        one = _result(_launch(tiny_bench, ONE_CHIP_CELL, "--answers",
                              str(tmp_path / "one.npz")))
        assert one["correct"] is True and one["device"]["count"] == 1
        assert "ranks" not in one["device"]
        import numpy as np
        got, want = _answers(tmp_path / "ranks.npz"), _answers(
            tmp_path / "one.npz")
        assert len(got) == len(want) >= 2
        for (x, y), (x1, y1) in zip(got[:-1], want[:-1]):  # the sampled
            assert x.shape == x1.shape and y.shape == y1.shape
            np.testing.assert_allclose(x, x1, rtol=1e-6, atol=1e-30)
            np.testing.assert_allclose(y, y1, rtol=1e-4,
                                       atol=1e-5 * np.abs(y1).max())
    for name in added:
        os.remove(os.path.join(tiny_bench.base, name))
    assert _digest(tiny_bench.base) == before


def test_a_killed_rank_ends_the_run_with_no_result(tiny_bench):
    import signal
    import threading
    from benchmark import ranks
    _add_ranks_cell(tiny_bench)
    proc = _launch(tiny_bench, RANKS_CELL, seconds=120, popen=True)
    lines, opened = [], threading.Event()

    def read():
        for line in proc.stderr:
            lines.append(line)
            if line.startswith("# window: open"):
                opened.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        assert opened.wait(RUN_LIMIT_S), "".join(lines)[-4000:]
        pids = json.loads([ln for ln in lines if ln.startswith("# ranks:")][0]
                          .split("pids ", 1)[1])
        assert len(pids) == 3
        time.sleep(1.0)                       # well inside the window
        os.kill(pids[1], signal.SIGKILL)      # rank 2
        t0 = time.monotonic()
        rc = proc.wait(timeout=ranks.FAIL_BOUND_S + 30)
        took = time.monotonic() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=10)
    assert rc == ranks.RANK_FAILED, "".join(lines)[-4000:]
    assert took < ranks.FAIL_BOUND_S
    assert proc.stdout.read().strip() == ""
    assert "rank 2 exited with code -9" in "".join(lines)
    for pid in pids:                           # no rank left behind
        assert not os.path.exists(f"/proc/{pid}")


def test_a_one_chip_run_starts_no_process_and_makes_no_group(
        tiny_bench, monkeypatch, capsys):
    import subprocess
    import torch.distributed as dist
    from benchmark import harness, ranks, run
    started, groups = [], []
    popen = subprocess.Popen

    def recording_popen(cmd, *a, **kw):
        started.append(cmd)
        return popen(cmd, *a, **kw)

    monkeypatch.setattr(subprocess, "Popen", recording_popen)
    for fn in ("init_process_group", "new_group"):
        monkeypatch.setattr(dist, fn, lambda *a, fn=fn, **kw:
                            groups.append(fn))
    monkeypatch.setattr(ranks, "Launch", lambda *a, **kw: started.append(a))
    monkeypatch.setattr(harness, "Bench", lambda: tiny_bench)
    monkeypatch.setattr(harness, "use_format_cache", lambda: None)
    rc = run.main(["--workload", "ldoor.spmv", "--seed", str(2**31 + 3),
                   "--seconds", "0.3", "--trace", "0", "--place", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["correct"] is True
    assert out["device"]["count"] == 1 and "ranks" not in out["device"]
    assert not any("benchmark.run" in " ".join(map(str, c))
                   for c in started), started
    assert groups == [] and not dist.is_initialized()


FAULTS_BY_RANK = {
    # the exchange between ranks left out: this rank's own x block, zero
    # elsewhere, in place of the gathered x
    "exchange": "    full = x.new_zeros(A.m_pad)\n"
                "    full[A.rank * A.rows_pad:(A.rank + 1) * A.rows_pad] = x\n"
                "    return _local_spmv(A.data, A.cols, A.rows, full, "
                "A.rows_pad)\n",
    # a step that returns its state unchanged
    "unchanged": "    return x.clone()\n",
    # an answer altered where it is produced, on one rank
    "altered": "    y = distributed_spmv(A, x, strategy)\n"
               "    if A.rank == 1:\n"
               "        y[y.numel() // 2] = y[y.numel() // 2] * 2 + 1\n"
               "    return y\n",
}


@pytest.mark.parametrize("fault", sorted(FAULTS_BY_RANK))
def test_a_broken_path_over_four_ranks_comes_out_not_correct(tiny_bench,
                                                             fault):
    root = os.path.dirname(tiny_bench.base)
    with open(os.path.join(root, "faulty_ranks.py"), "w") as f:
        f.write(f"from {DIST} import _local_spmv, distributed_spmv\n\n\n"
                "def spmv(A, x, strategy):\n" + FAULTS_BY_RANK[fault])
    _add_ranks_cell(tiny_bench, spmv="faulty_ranks:spmv")
    out = _result(_launch(tiny_bench, RANKS_CELL, seconds=0.5))
    assert out["correct"] is False and out["attempted"] > 0
    assert out["device"]["count"] == 4


@pytest.mark.gpu
def test_two_ranks_on_one_card_over_gloo(gpu, tiny_bench):
    _add_ranks_cell(tiny_bench, chips=2)
    out = _result(_launch(tiny_bench, RANKS_CELL, "--place", "one_card",
                          trace=1))
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert out["device"]["count"] == 2
    assert len({r["attempted"] for r in out["device"]["ranks"]}) == 1
    assert all(r["busy_s"] > 0 for r in out["device"]["ranks"])


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_four_ranks_on_four_cards_over_nccl(gpu, tiny_bench, trace):
    import torch
    if torch.cuda.device_count() < 4:
        pytest.skip(f"{torch.cuda.device_count()} CUDA device(s), not 4")
    _add_ranks_cell(tiny_bench, chips=4)
    out = _result(_launch(tiny_bench, RANKS_CELL, "--place", "cards",
                          trace=trace))
    assert out["correct"] is True and out["device"]["count"] == 4
    assert [r["device"] for r in out["device"]["ranks"]] == [
        f"cuda:{r}" for r in range(4)]
    assert len({r["attempted"] for r in out["device"]["ranks"]}) == 1
