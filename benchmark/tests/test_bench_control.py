"""The comparison has to fail: the control (the reference in bfloat16 in the
program's place) and the timed path broken underneath, each cell at a tiny
size on the CPU, with the harness's look for a chip skipped. The same
cells on a card, with the port's CUDA kernels, are marked ``gpu``."""

import json
import os
import time

import pytest
import torch

from benchmark import harness
from benchmark.program import PortProgram, ReferenceProgram

from conftest import ROOT

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def _run(bench, workload, factory, device="cpu", seed=2**31 + 29):
    cell = harness.prepare(bench, workload, device, False, factory)
    return harness.run_seed(cell, seed, 0.3, time.perf_counter())


def _readings(out):
    return {k: c["value"] for k, c in out["checks"].items()}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_comes_out_not_correct(tiny_bench, workload):
    sound = _run(tiny_bench, workload, None)
    control = _run(tiny_bench, workload, ReferenceProgram)
    assert sound["correct"] is True
    assert control["correct"] is False
    for k, v in _readings(control).items():
        assert v > 3 * _readings(sound)[k], k


def _altered(t):
    """t with one element, in the middle, doubled and moved by 1."""
    t = t.clone(memory_format=torch.contiguous_format)
    flat = t.view(-1)
    flat[flat.numel() // 2] = flat[flat.numel() // 2] * 2 + 1
    return t


class Faulty(PortProgram):
    """The port with one fault planted where its answer is produced."""

    fault = None

    def spmv(self, x):
        y = super().spmv(x)
        if self.fault == "unchanged":
            return x.clone()
        return _altered(y) if self.fault == "altered" else y

    def spmm(self, X):
        Y = super().spmm(X)
        if self.fault == "unchanged":
            return X.clone()
        if self.fault == "half":
            k = X.shape[1] // 2
            Y = torch.cat([super().spmm(X[:, :k].contiguous()),
                           torch.zeros_like(Y[:, k:])], dim=1)
        return _altered(Y) if self.fault == "altered" else Y

    def cg(self, b, rtol, max_iters):
        x, info = super().cg(b, rtol, max_iters)
        if self.fault == "unchanged":
            return torch.zeros_like(b), info
        return (_altered(x) if self.fault == "altered" else x), info


# the faults each cell can have: a step that returns its state unchanged,
# an answer altered where it is produced, and for the SpMM half of X's
# columns left out; one chip, so no exchange between chips to leave out
FAULTS = [(w, f) for w in WORKLOADS for f in ("unchanged", "altered")]
FAULTS += [(w, "half") for w in WORKLOADS if w.endswith(".spmm")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_broken_timed_path_comes_out_not_correct(tiny_bench, workload,
                                                   fault, monkeypatch):
    monkeypatch.setattr(Faulty, "fault", fault)
    out = _run(tiny_bench, workload, Faulty)
    assert out["correct"] is False
    assert out["attempted"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cells_on_the_card(gpu, tiny_bench, workload):
    """The tiny cells through the port's CUDA kernels: correct; the
    control on the card: not correct."""
    out = _run(tiny_bench, workload, None, device="cuda")
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert _run(tiny_bench, workload, ReferenceProgram,
                device="cuda")["correct"] is False
