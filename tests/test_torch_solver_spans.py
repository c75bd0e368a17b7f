"""The solver's spans and ``trace_region``'s gate (``utils/trace.py``,
``solvers/cg.py``) on the CPU.

Under a profiler a solve records one root span (``solver.cg`` or
``solver.bicgstab``), one ``solver.start``, a ``solver.step`` each loop
iteration the host ran and a ``solver.poll`` each poll, all inside the
root. With no profiler a region is one shared null context: a solve enters
no ``record_function`` and gives the same x and iteration count. The
format dispatch opens no span of its own (the benchmark's spans around it
own its device operations).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from spmv_research_tpu_torch.convert import (build_csr, make_diag_dominant,
                                             make_spd)
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.ops import (build_clos_gather_xl, build_sellw,
                                         dispatch)
from spmv_research_tpu_torch.solvers import solve_bicgstab, solve_cg
from spmv_research_tpu_torch.solvers.cg import POLL_EVERY
from spmv_research_tpu_torch.utils import trace

from torch_cases import random_matrix

SOLVES = {
    # (solver, transform, kwargs): converged at a poll; stopped by
    # max_iters between polls; BiCGStab converged at a poll
    "cg": (solve_cg, make_spd, dict(max_iters=200, rtol=1e-6)),
    "cg_max_iters": (solve_cg, make_spd, dict(max_iters=6, rtol=1e-30)),
    "bicgstab": (solve_bicgstab, make_diag_dominant,
                 dict(max_iters=50, rtol=1e-6)),
}
SPANS = ("solver.start", "solver.step", "solver.poll")


def _system(transform, m=300, seed=3):
    rng = np.random.default_rng(seed)
    mat = (sp.random(m, m, 0.02, random_state=np.random.RandomState(seed))
           + sp.diags(rng.uniform(1, 2, m))).tocsr()
    host = transform(HostCSR.from_scipy(mat))
    return host, build_csr(host), rng.uniform(0, 1, m)


def _solve(case):
    fn, transform, kw = SOLVES[case]
    host, A, b = _system(transform)
    return fn(host, A, b, **kw)


def _annotations(prof):
    return [e for e in prof.events() if e.is_user_annotation]


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_a_solve_records_its_spans_inside_one_root(case, tmp_path):
    with trace.profile(str(tmp_path)) as prof:
        x, info = _solve(case)
    spans = _annotations(prof)
    root_name = "solver.bicgstab" if case == "bicgstab" else "solver.cg"
    (root,) = [e for e in spans if e.name == root_name]
    assert {e.name for e in spans} == {root_name, *SPANS}
    loops, max_iters = info["loop_iterations"], SOLVES[case][2]["max_iters"]
    polls = len(range(0, min(loops + 1, max_iters), POLL_EVERY))
    count = {n: sum(e.name == n for e in spans) for n in SPANS}
    assert count == {"solver.start": 1, "solver.step": loops,
                     "solver.poll": polls}
    assert (loops < max_iters) == (case != "cg_max_iters")
    r0, r1 = root.time_range.start, root.time_range.end
    for e in spans:
        assert r0 <= e.time_range.start <= e.time_range.end <= r1, e.name
    # the spans follow the loop: start, then a poll before every
    # POLL_EVERY-th step, and the poll that ends the loop after the last
    order = [e.name for e in sorted(spans, key=lambda e: e.time_range.start)
             if e.name != root_name]
    want = ["solver.start"]
    for it in range(loops):
        want += (["solver.poll"] if it % POLL_EVERY == 0 else []) \
            + ["solver.step"]
    want += ["solver.poll"] * (polls - want.count("solver.poll"))
    assert order == want


def _refuse(*args, **kwargs):
    raise AssertionError("record_function entered with no profiler")


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_no_profiler_enters_no_record_function(case, tmp_path,
                                               monkeypatch):
    with trace.profile(str(tmp_path)):
        x_traced, info_traced = _solve(case)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    x, info = _solve(case)
    assert torch.equal(x, x_traced)
    assert int(info["iterations"]) == int(info_traced["iterations"])
    assert info["loop_iterations"] == info_traced["loop_iterations"]


def test_trace_region_is_one_null_context_with_no_profiler(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    a, b = trace.trace_region("a"), trace.trace_region("b")
    assert a is b
    with a, b:
        pass


def test_the_profilers_warm_up_step_records_no_region():
    seen = []

    def ready(prof):
        seen.extend(e.name for e in _annotations(prof)
                    if not e.name.startswith("ProfilerStep"))

    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=ready) as prof:
        with trace.trace_region("warm"):
            torch.ones(4).sum()
        prof.step()
        with trace.trace_region("active"):
            torch.ones(4).sum()
        prof.step()
    assert seen == ["active"]


def _closgx():
    mat = random_matrix(1500, 700, 0.01, 5)
    return build_clos_gather_xl(HostCSR.from_scipy(mat), chunk_N=8192)


def _sellw():
    return build_sellw(HostCSR.from_scipy(random_matrix(600, 600, 0.03, 7)),
                       max_chunk_factor=1e9)


@pytest.mark.parametrize("build, fmt", [(_closgx, "CLOSGX"),
                                        (_sellw, "SELLW")])
def test_dispatch_opens_no_span_of_its_own(build, fmt, tmp_path):
    A = build()
    assert A.format_name == fmt
    x, X = torch.ones(A.n), torch.ones(A.n, 3)
    with trace.profile(str(tmp_path)) as prof:
        y = dispatch.spmv(A, x)
        Y = dispatch.spmm(A, X)
    assert _annotations(prof) == []
    assert any(e.name.startswith("aten::") for e in prof.events())
    assert y.shape == (A.m,) and Y.shape == (A.m, 3)
