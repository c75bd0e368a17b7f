"""The benchmark's CPU tests, and a ``gpu`` mark for those that need a card.

Run from the checkout's root: ``python -m pytest benchmark/tests -q``.
``tiny_bench`` is a copy of the benchmark's files in a temporary directory
whose configurations are cut to a few thousand rows, so that a whole run of
each cell fits in a test on the CPU; its caches live there too.
"""

from __future__ import annotations

import json
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
TINY_ROWS = 3000
# the mixes' sizes that set a tiny run's time on the CPU
TINY_TRAFFIC = {"k": 16, "trace_calls": 5, "host_bursts": 2,
                "trace_solves": 2}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def gpu():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def tiny_config(cfg: dict) -> dict:
    """``cfg`` with its twin line cut to ``TINY_ROWS`` rows; a CLOSGX
    configuration also to 6 nonzeros a row and chunks of 8192 slots, so
    that the port still builds a CLOSGX."""
    parts = cfg["twin_line"].split()
    parts[0] = parts[1] = str(TINY_ROWS)
    if cfg["format"]["format_name"] == "CLOSGX":
        parts[2], parts[3] = "6", "2"
        cfg["format"]["kwargs"] = {"max_N": 8192, "max_chunks": 2}
    cfg["twin_line"] = " ".join(parts)
    return cfg


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """A ``harness.Bench`` over a tiny copy of the benchmark."""
    import torch
    from benchmark import harness, matrices
    torch.set_num_threads(1)
    base = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, base,
                    ignore=shutil.ignore_patterns(".cache", "tests",
                                                  "__pycache__"))
    for path in (base / "configs").glob("*.json"):
        cfg = tiny_config(json.loads(path.read_text()))
        path.write_text(json.dumps(cfg))
    for path in (base / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update({k: min(v, TINY_TRAFFIC[k]) for k, v in mix.items()
                    if k in TINY_TRAFFIC})
        path.write_text(json.dumps(mix))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    monkeypatch.setattr(matrices, "CACHE_DIR", str(tmp_path / "matrices"))
    monkeypatch.setenv("SPARSE_FORMAT_CACHE_TORCH", str(tmp_path / "formats"))
    return harness.Bench(str(tmp_path / "BENCHMARK.json"), str(base))
