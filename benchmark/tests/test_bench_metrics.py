"""The benchmark's arithmetic on hand-made inputs: bytes and least times,
the percentile over all solves, interval unions and gaps, and the reading
of a hand-made Chrome trace."""

import statistics

import pytest

from benchmark import metrics, trace


def test_csr_bytes_counts_each_input_once():
    # nnz values (4 B) and column indices (4 B), m + 1 row pointers, x, y
    assert metrics.csr_bytes(10, 3, 4) == 10 * 8 + 4 * 4 + (3 + 4) * 4
    assert metrics.csr_bytes(10, 3, 4, value_bytes=8) == 10 * 12 + 16 + 56


def test_spmv_least_time_of_the_ldoor_twin():
    nnz, m = 47_924_615, 952_203
    least = metrics.spmv_least_s(nnz, m, m, 3.35e12)
    assert least == pytest.approx(metrics.csr_bytes(nnz, m, m) / 3.35e12)
    assert 117e-6 < least < 119e-6


def test_spmm_bound_takes_the_larger_of_bytes_and_operations():
    nnz, m, k = 15_571_568, 140_874, 128
    bw, flops = 3.35e12, 67e12
    nbytes = nnz * 8 + (m + 1) * 4 + 2 * m * k * 4
    assert metrics.spmm_least_s(nnz, m, m, k, bw, flops) == pytest.approx(
        nbytes / bw)
    # a tiny bandwidth-free card: operations bound
    assert metrics.spmm_least_s(nnz, m, m, k, 1e30, flops) == pytest.approx(
        2 * nnz * k / flops)


def test_peaks_by_card_name():
    assert metrics.peaks("NVIDIA H100 80GB HBM3") == (3.35e12, 67e12)
    assert metrics.peaks("NVIDIA H100 NVL")[0] == 3.9e12
    assert metrics.peaks("NVIDIA A100-SXM4-80GB") is None
    assert metrics.card_peaks("cpu") is None


def test_p95_is_over_all_solves_not_over_chunks():
    times = [1.0] * 90 + [10.0] * 10
    p = metrics.percentile(times, 95)
    assert p == pytest.approx(10.0)
    # the median of per-chunk p95s (chunks of 20, the slow ones last)
    # would read 1.0: the tail lives in one chunk
    chunks = [times[i:i + 20] for i in range(0, 100, 20)]
    assert statistics.median(metrics.percentile(c, 95) for c in chunks) == 1.0
    assert metrics.percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert metrics.percentile([0.0, 10.0], 95) == pytest.approx(9.5)
    with pytest.raises(ValueError):
        metrics.percentile([], 95)


def test_union_of_kernel_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 12)]
    assert metrics.union_length(iv) == 3 + 1 + 2
    assert metrics.union_length(iv, lo=1, hi=11) == 2 + 1 + 1
    assert metrics.union_length([]) == 0.0
    assert metrics.gaps(iv, 0, 12) == [(3, 5), (6, 10)]
    assert metrics.gaps([], 0, 1) == [(0, 1)]


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def test_parse_ties_kernels_to_the_span_that_launched_them():
    events = [
        _ev("user_annotation", "window.slice", 0, 100),
        _ev("user_annotation", "dispatch.spmv", 1, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=2),
        _ev("user_annotation", "fold", 12, 4),
        _ev("cuda_runtime", "cudaLaunchKernel", 13, 1, correlation=3),
        _ev("user_annotation", "dispatch.spmv", 20, 10),
        _ev("cuda_driver", "cuLaunchKernel", 21, 1, correlation=4),
        _ev("kernel", "b1", 10, 20, tid=7, correlation=1),
        _ev("kernel", "b15", 30, 30, tid=7, correlation=2),
        _ev("kernel", "fold_add", 60, 5, tid=7, correlation=3),
        _ev("gpu_memset", "memset", 70, 10, tid=7, correlation=4),
        _ev("kernel", "unlaunched", 200, 5, tid=7, correlation=99),
    ]
    s = trace.parse({"traceEvents": events})
    assert s.window == (0.0, 100.0)
    assert s.count("dispatch.spmv") == 2
    n, dev_s = s.per_span("dispatch.spmv")
    assert n == 1.5                       # 3 operations over 2 spans
    assert dev_s == pytest.approx((20 + 30 + 10) * 1e-6 / 2)
    assert s.per_span("fold") == (1.0, pytest.approx(5e-6))
    assert s.per_span("cg.solve") is None
    assert s.busy_s == pytest.approx((50 + 5 + 10) * 1e-6)
    assert s.window_s == pytest.approx(100e-6)
    assert s.idle_frac() == pytest.approx(0.35)
    bd = s.breakdown()
    assert bd["device_ops"][0] == ["b15", pytest.approx(30e-6)]
    # idle: [0, 10) in dispatch.spmv, [65, 70) and [80, 100) outside spans
    assert bd["idle_gaps"][0] == ["host", pytest.approx(20e-6)]
    assert ["dispatch.spmv", pytest.approx(10e-6)] in bd["idle_gaps"]


def test_an_empty_slice_has_no_idle_share():
    assert trace.TraceSlice([], [], (5.0, 5.0)).idle_frac() is None


def test_parse_needs_the_slice_span():
    with pytest.raises(ValueError):
        trace.parse({"traceEvents": [_ev("kernel", "k", 0, 1)]})
