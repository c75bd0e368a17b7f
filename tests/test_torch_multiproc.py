"""The port's multi-process runtime (``parallel/multihost.py``,
``parallel/comm.py``) and its three tools, on gloo processes on the CPU
(counterpart of the JAX package's ``tests/test_multiproc.py``).

Every spawned run meets on a ``file://`` store in a temporary directory
(never a fixed port) and runs through ``subprocess`` with a 120 s limit.
A one-rank group in this process checks the k = 1 paths (the ring is one
local step: no send to itself) and that the three SELLR strategies build
their one program once.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

import spmv_research_tpu.parallel as jp
from spmv_research_tpu.core.host import HostCSR as JaxHostCSR

from spmv_research_tpu_torch.convert import cache
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch import parallel as tp
from spmv_research_tpu_torch.parallel import comm

import torch_dist_cases as C

REPO = C.REPO
JAX_LABELS = ("strategy,devices,rows_per_device,nnz,time_iter_s,"
              "efficiency,efficiency_overhead")


def _run(argv, env=None, timeout=C.SPAWN_TIMEOUT):
    env = dict(os.environ, **(env or {}))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_two_process_distributed_spmv():
    out = _run(["-m", "spmv_research_tpu_torch.tools.multiproc_cpu_test"])
    assert out.returncode == 0, out.stdout + out.stderr
    assert "MULTIPROC OK" in out.stdout, out.stdout + out.stderr


def test_weak_scaling_tool_csv(tmp_path):
    """The tool's CSV at 2,000 rows a rank over 2 ranks: JAX's columns,
    both strategies at k = 1 and 2, nnz as the JAX generator's."""
    out = _run(["-m", "spmv_research_tpu_torch.tools.weak_scaling",
                "--device", "cpu", "--ranks", "2", "--rows", "2000",
                "--out-dir", str(tmp_path)])
    assert out.returncode == 0, out.stdout + out.stderr
    with open(os.path.join(REPO, "tools", "weak_scaling.py")) as f:
        assert JAX_LABELS in f.read().replace('"\n                "', "")
    lines = (tmp_path / "weak_scaling_cpu2.csv").read_text().splitlines()
    assert lines[0] == JAX_LABELS
    rows = [ln.split(",") for ln in lines[1:]]
    assert [(r[0], r[1]) for r in rows] == [
        ("allgather", "1"), ("allgather", "2"), ("ring", "1"), ("ring", "2")]
    from spmv_research_tpu.gen import (ArtificialParams,
                                       artificial_matrix_generation)
    for r in rows:
        m = 2000 * int(r[1])
        host, _ = artificial_matrix_generation(ArtificialParams(
            m, m, 8.0, 8.0 / 3, "normal", "random", bw=0.05, skew=1.0,
            avg_num_neighbours=0.5, cross_row_similarity=0.3, seed=14))
        assert int(r[3]) == host.nnz and float(r[4]) > 0


def test_launch_multihost(tmp_path):
    """Two ranks through the launcher (COORDINATOR, NUM_HOSTS, HOST_ID):
    the script runs as __main__ in a group of two with its arguments."""
    script = tmp_path / "probe.py"
    script.write_text(
        "import sys, torch.distributed as dist\n"
        "open(sys.argv[1] + str(dist.get_rank()), 'w').write(\n"
        "    f'{dist.get_world_size()} {sys.argv[2]}')\n"
        "dist.destroy_process_group()\n")
    env = {"COORDINATOR": f"file://{tmp_path / 'store'}", "NUM_HOSTS": "2"}
    argv = ["-m", "spmv_research_tpu_torch.tools.launch_multihost",
            "--backend", "gloo", str(script), str(tmp_path / "rank"), "hi"]
    other = subprocess.Popen(
        [sys.executable, *argv], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, **env, HOST_ID="1",
                 PYTHONPATH=REPO + os.pathsep + os.environ.get(
                     "PYTHONPATH", "")))
    try:
        out = _run(argv, env=dict(env, HOST_ID="0"))
        log1 = other.communicate(timeout=C.SPAWN_TIMEOUT)[0]
    finally:
        if other.poll() is None:
            other.kill()
    assert out.returncode == 0 and other.returncode == 0, (
        out.stdout + out.stderr + log1)
    for r in (0, 1):
        assert (tmp_path / f"rank{r}").read_text() == "2 hi"


@pytest.fixture
def one_rank():
    """A one-rank gloo group in this process, gone after the test."""
    assert not dist.is_initialized()
    tp.init_multihost(backend="gloo")
    try:
        yield tp.make_sparse_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_one_rank_in_process(one_rank, tmp_path, monkeypatch):
    """init_multihost with no arguments: a group of one. The ring at k = 1
    is one local step (no shift is posted), equal to the allgather; the
    three SELLR strategies share their one build (the format cache: one
    miss, two hits) and give the same y; CLOSGX with and without overlap
    and the CG step against JAX's at k = 1."""
    mesh = one_rank
    assert dist.get_world_size() == 1 and mesh.size() == 1
    with pytest.raises(ValueError, match="ring of one"):
        comm.ring_shift(torch.zeros(4))
    mat = C.csr_case()
    A = tp.build_sharded_csr(HostCSR.from_scipy(mat), mesh)
    x = A.pad_vector(C.x_for(mat))
    y_ag = tp.distributed_spmv(A, x, "allgather")
    assert torch.equal(tp.distributed_spmv(A, x, "ring"), y_ag)
    C.near(A.unpad_vector(y_ag), mat @ C.x_for(mat), 2e-5)

    monkeypatch.setenv(cache.CACHE_ENV, str(tmp_path))
    cache.reset_stats()
    mat = C.sellr_case()
    ys = [tp.dist_spmv_sellr_host(tp.build_dist_sellr(
        HostCSR.from_scipy(mat), mesh, strategy=s, max_slot_factor=30.0),
        C.x_for(mat)) for s in ("allgather", "ring", "psum_scatter")]
    assert (cache.STATS["misses"], cache.STATS["hits"]) == (1, 2)
    assert np.array_equal(ys[0], ys[1]) and np.array_equal(ys[0], ys[2])
    C.near(ys[0], mat @ C.x_for(mat), 2e-6)

    mat = C.closgx_case()
    for ov in (False, True):
        D = tp.build_dist_closgx(HostCSR.from_scipy(mat), mesh, axis="rows",
                                 chunk_N=C.CHUNK_N, overlap=ov)
        assert D.overlapped == ov
        C.near(tp.dist_spmv_closgx_host(D, C.x_for(mat)),
               mat @ C.x_for(mat), 2e-5)

    spd = C.spd_case()
    _, rr = tp.distributed_cg_step(HostCSR.from_scipy(spd), mesh)()
    _, rrj = jax.block_until_ready(jp.distributed_cg_step(
        JaxHostCSR.from_scipy(spd), jp.make_sparse_mesh(1))())
    C.near([float(rr)], [float(rrj)], 1e-5)
