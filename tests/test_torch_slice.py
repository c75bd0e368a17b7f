"""The port's main path, end to end on the CPU, against the JAX package.

The port's bench function runs the slice (generate → RCM-if-beneficial →
build_best + CSR → bench_spmv) on the 2000-row scircuit twin with the plain
PyTorch impls, and must print bench.py's JSON fields; its CLOSG y must match
the JAX pallas path (interpret mode) within 1e-5 of |A|·|x|, and scipy.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spmv_research_tpu.convert.reorder import rcm_if_beneficial as jax_rcm
from spmv_research_tpu.gen import generate_from_line as jax_generate
from spmv_research_tpu.ops import spmv as jax_spmv
from spmv_research_tpu.ops.clos_gather import build_clos_gather as jax_build

from spmv_research_tpu_torch import bench
from spmv_research_tpu_torch.gen import ArtificialParams, generate_from_line
from spmv_research_tpu_torch.harness import (BenchConfig, csv_labels,
                                             csv_row_real, csv_row_synthetic)
from spmv_research_tpu_torch.ops import spmv

from torch_cases import TWIN_LINE

# the keys of the JSON line bench.py prints
JSON_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
DETAIL_KEYS = {"matrix", "m", "nnz", "best_format", "best_impl", "nnz_per_s",
               "gflops", "roofline_nnz_per_s", "device", "mape",
               "time_compile_s", "time_convert_s", "time_convert_cold_s",
               "total_runtime_s", "speedup_vs_xla_tpu_baseline", "candidates"}


@pytest.fixture(scope="module")
def cpu_run():
    cfg = BenchConfig(min_num_loops=8, min_time_s=0.0, warmup_iters=2)
    return bench.run("cpu", line=TWIN_LINE, config=cfg)


def test_bench_json_fields(cpu_run):
    out = json.loads(json.dumps(cpu_run.json))
    assert set(out) == JSON_KEYS and set(out["detail"]) == DETAIL_KEYS
    assert out["metric"] == "csr_spmv_roofline_frac"
    d = out["detail"]
    assert (d["matrix"], d["m"]) == ("scircuit_twin", 2000)
    assert d["device"] == "cpu"
    assert out["value"] is None and d["roofline_nnz_per_s"] is None
    # the 2000-row cut of the twin spans only 16 x2d rows, so the locality
    # engines accept it (as the JAX build_best does, test_torch_sweep.py)
    assert set(d["candidates"]) == {"SELLR/torch", "SELLW/torch",
                                    "CLOSG/torch", "CSR/torch"}
    params = ArtificialParams.from_args(TWIN_LINE.split())
    feats = generate_from_line(TWIN_LINE)[1]
    for r in cpu_run.results.values():
        assert r.num_loops >= 8 and r.time_iter_min <= r.time_iter_median
        assert r.metrics.max_rel_err < 1e-5
        assert (len(csv_row_real(r).split(","))
                == len(csv_labels().split(",")))
        assert (len(csv_row_synthetic(r, params, feats).split(","))
                == len(csv_labels(synthetic=True).split(",")))


def test_slice_y_matches_jax_pallas_and_scipy(cpu_run):
    host = cpu_run.host
    x = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, host.n)
    xf = x.astype(np.float32)
    A, _ = cpu_run.formats["CLOSG"]
    y = spmv(A, torch.from_numpy(xf)).double().numpy()

    hj, _ = jax_rcm(jax_generate(TWIN_LINE)[0])
    y_jax = np.asarray(jax_spmv(jax_build(hj), jnp.asarray(xf),
                                impl="pallas"))
    sp = host.to_scipy()
    scale = np.abs(sp) @ np.abs(x) + 1e-30
    assert np.max(np.abs(y - y_jax) / scale) <= 1e-5
    assert np.max(np.abs(y - sp @ x) / scale) <= 1e-5
    y_csr = spmv(cpu_run.formats["CSR"][0], torch.from_numpy(xf)).double()
    assert np.max(np.abs(y_csr.numpy() - sp @ x) / scale) <= 1e-5


def test_bench_main_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main([])
