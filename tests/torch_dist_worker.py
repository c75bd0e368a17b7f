"""One gloo rank of the distributed layer's CPU tests (no JAX, no
conftest): every case of ``torch_dist_cases`` through the port's
distributed entry points, the plain PyTorch versions on the CPU. Rank 0
writes each case's global y to ``<out>/results.npz`` and the weak-scaling
dict and the world's facts to ``<out>/results.json``.

    python tests/torch_dist_worker.py --k 2 --rank 0 --store <file> --out <dir>
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_dist_cases as C  # noqa: E402  (sets one torch thread)
from spmv_research_tpu_torch.core.host import HostCSR  # noqa: E402
from spmv_research_tpu_torch.parallel import (  # noqa: E402
    build_col_sharded_csr, build_dist_closgx, build_dist_sellr,
    build_sharded_csr, dist_spmv_closgx_host, dist_spmv_sellr_host,
    distributed_cg_step, distributed_spmv, distributed_spmv_psum_scatter,
    init_multihost, make_sparse_mesh, weak_scaling_efficiency)
from spmv_research_tpu_torch.parallel import comm  # noqa: E402
from spmv_research_tpu_torch.parallel.dist_sellr import (  # noqa: E402
    _pad_x, dist_cg_step_sellr)


def run(k: int, rank: int, out_dir: str) -> None:
    mesh = make_sparse_mesh(k, device="cpu")
    ys, times = {}, {}

    def case(name, fn):
        t0 = time.perf_counter()
        ys[name] = np.asarray(fn(), np.float64)
        times[name] = time.perf_counter() - t0

    h = HostCSR.from_scipy
    csr, ring = C.csr_case(), C.ring_case()
    for strategy in ("allgather", "ring"):
        for name, mat in (("csr", csr), ("ring", ring)):
            A = build_sharded_csr(h(mat), mesh)
            case(f"{name}_{strategy}", lambda: A.unpad_vector(
                distributed_spmv(A, A.pad_vector(C.x_for(mat)), strategy)))
    sk = C.skewed_case()
    A = build_sharded_csr(h(sk), mesh)
    case("skewed_allgather", lambda: A.unpad_vector(
        distributed_spmv(A, A.pad_vector(C.x_for(sk)))))
    col = C.col_case()
    Ac = build_col_sharded_csr(h(col), mesh)
    case("psum_scatter", lambda: Ac.unpad_y(distributed_spmv_psum_scatter(
        Ac, Ac.pad_x(C.x_for(col)))))
    for strategy in ("allgather", "ring"):
        step = distributed_cg_step(h(C.spd_case()), mesh, strategy=strategy)
        case(f"cg_{strategy}", lambda: step()[1].reshape(1))

    for name, mat in (("sellr", C.sellr_case()),
                      ("sellr_empty", C.sellr_empty_case())):
        for strategy in ("allgather", "ring", "psum_scatter"):
            D = build_dist_sellr(h(mat), mesh, strategy=strategy,
                                 max_slot_factor=30.0)
            case(f"{name}_{strategy}",
                 lambda: dist_spmv_sellr_host(D, C.x_for(mat)))
    D = build_dist_sellr(h(C.sellr_case()), mesh, strategy="allgather",
                         max_slot_factor=30.0)
    step, xp = dist_cg_step_sellr(D, C.x_for(C.sellr_case()))
    case("sellr_cg_step", lambda: comm.all_gather(step(xp), D.group))

    for name, mat, overlaps in (("closgx", C.closgx_case(), (False, True)),
                                ("closgx_local", C.closgx_local_case(),
                                 (True,)),
                                ("closgx_rect", C.closgx_rect_case(),
                                 (False,)),
                                ("closgx_multi", C.closgx_multichunk_case(),
                                 (False, True))):
        for ov in overlaps:
            Dx = build_dist_closgx(
                h(mat), mesh, axis="rows", overlap=ov,
                chunk_N={"closgx_local": C.CHUNK_N_LOCAL,
                         "closgx_multi": C.CHUNK_N_MULTI}.get(name,
                                                              C.CHUNK_N))
            case(f"{name}_{'overlap' if ov else 'plain'}",
                 lambda: dist_spmv_closgx_host(Dx, C.x_for(mat)))
            if name == "closgx" and not ov:
                ys["closgx_shard_nnz"] = np.array(Dx.shard_nnz, np.float64)
                ys["closgx_shard_slots"] = np.array(Dx.shard_slots,
                                                    np.float64)

    dry = C.dryrun_sellr_case(k)
    for strategy in ("ring", "allgather"):
        D = build_dist_sellr(h(dry), mesh, strategy=strategy,
                             max_slot_factor=40.0)
        case(f"dryrun_sellr_{strategy}",
             lambda: dist_spmv_sellr_host(D, C.x_for(dry)))
        xp = _pad_x(D, C.x_for(dry), D.vals.dtype)
        ys[f"dryrun_xp_{strategy}"] = np.array([xp.numel()], np.float64)

    t0 = time.perf_counter()
    weak = weak_scaling_efficiency(rows_per_device=2000, avg_nnz_per_row=5.0,
                                   device_counts=[c for c in (1, 2, 4, 8)
                                                  if c <= k],
                                   device="cpu")
    times["weak"] = time.perf_counter() - t0
    if rank == 0:
        np.savez(os.path.join(out_dir, "results.npz"), **ys)
        info = {"world": torch.distributed.get_world_size(),
                "mesh_size": mesh.size(),
                "backend": torch.distributed.get_backend(),
                "staged_bytes": comm.STAGED["bytes"]}
        with open(os.path.join(out_dir, "results.json"), "w") as f:
            json.dump({"weak": {str(kk): v for kk, v in weak.items()},
                       "info": info, "times": times}, f)
        print(json.dumps(times), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    init_multihost(f"file://{a.store}", a.k, a.rank, backend="gloo")
    try:
        run(a.k, a.rank, a.out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
