"""A real two-process distributed run on the CPU (gloo): the row-sharded
CSR SpMV with the allgather and ring strategies over two ranks, each
gated against scipy at 2e-5 of max |y|; rank 0 prints ``MULTIPROC OK``.

Counterpart of the JAX repository's ``tools/multiproc_cpu_test.py``. The
ranks meet through ``init_multihost`` (the launcher path): a ``file://``
store in a temporary directory by default, so no port is fixed::

    python -m spmv_research_tpu_torch.tools.multiproc_cpu_test
    python -m spmv_research_tpu_torch.tools.multiproc_cpu_test \\
        --coordinator tcp://127.0.0.1:29512      # a port of your choice

With ``--rank`` it runs one rank only (the parent starts rank 1 so).
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile


def run_rank(rank: int, coordinator: str) -> int:
    import numpy as np
    import scipy.sparse as sp
    import torch
    import torch.distributed as dist

    from ..core.host import HostCSR
    from ..parallel import init_multihost, make_sparse_mesh
    from ..parallel.dist import build_sharded_csr, distributed_spmv

    torch.set_num_threads(1)
    init_multihost(coordinator_address=coordinator, num_processes=2,
                   process_id=rank, backend="gloo")
    try:
        assert dist.get_world_size() == 2, dist.get_world_size()
        mesh = make_sparse_mesh(2, axis="d", device="cpu")
        rng = np.random.RandomState(0)
        A = sp.random(1600, 1600, 0.01, random_state=rng, format="csr")
        A.sort_indices()
        host = HostCSR(ia=A.indptr.astype(np.int32),
                       ja=A.indices.astype(np.int32),
                       a=A.data.astype(np.float64), m=1600, n=1600)
        S = build_sharded_csr(host, mesh, axis="d")
        x = np.random.default_rng(1).standard_normal(1600)
        ref = A @ x
        for strategy in ("allgather", "ring"):
            y = S.unpad_vector(distributed_spmv(S, S.pad_vector(x),
                                                strategy=strategy))
            err = float(np.abs(y - ref).max() / np.abs(ref).max())
            if rank == 0:
                print(f"rank0 2-process {strategy}: err={err:.2e} "
                      f"ok={err < 2e-5}", flush=True)
            assert err < 2e-5, (strategy, err)
        if rank == 0:
            print("MULTIPROC OK: 2 processes (gloo), allgather + ring",
                  flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--coordinator", default=None,
                    help="init method or host:port (default: a file:// "
                         "store in a new temporary directory)")
    args = ap.parse_args()
    if args.rank is not None:
        return run_rank(args.rank, args.coordinator)
    tmp = None
    coord = args.coordinator
    if coord is None:
        tmp = tempfile.mkdtemp(prefix="multiproc_")
        coord = f"file://{os.path.join(tmp, 'store')}"
    worker = subprocess.Popen(
        [sys.executable, "-m", __spec__.name, "--rank", "1",
         "--coordinator", coord])
    try:
        rc = run_rank(0, coord)
    finally:
        try:
            worker.wait(timeout=120)
        finally:
            if worker.poll() is None:
                worker.kill()
            if tmp:
                shutil.rmtree(tmp, ignore_errors=True)
    return rc or worker.returncode


if __name__ == "__main__":
    sys.exit(main())
