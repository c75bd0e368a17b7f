"""Run a script as one rank of a multi-process run: the process group is
made first (``init_multihost``), then the script runs as ``__main__``.

Counterpart of the JAX repository's ``tools/launch_multihost.sh`` (the
role of the reference's slurm/pbs scripts, which launch independent
single-node jobs; here the ranks form one process group). On each host,
or from a scheduler's per-node task::

    COORDINATOR=<host0-ip>:29500 NUM_HOSTS=<N> HOST_ID=<rank> \\
        python -m spmv_research_tpu_torch.tools.launch_multihost \\
        [--backend gloo] <script.py> [args...]

Under torchrun the three variables are not needed (``RANK``,
``WORLD_SIZE`` and ``MASTER_ADDR`` are read; ``env://``), so a node with
several cards runs one rank a card::

    torchrun --nproc-per-node=<cards> \\
        -m spmv_research_tpu_torch.tools.launch_multihost <script.py>
"""

import argparse
import os
import runpy
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="nccl", help="nccl or gloo")
    ap.add_argument("script")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    a = ap.parse_args()
    from ..parallel import init_multihost

    n = os.environ.get("NUM_HOSTS")
    pid = os.environ.get("HOST_ID")
    init_multihost(coordinator_address=os.environ.get("COORDINATOR"),
                   num_processes=int(n) if n else None,
                   process_id=int(pid) if pid else None, backend=a.backend)
    sys.argv = [a.script, *a.args]
    runpy.run_path(a.script, run_name="__main__")


if __name__ == "__main__":
    main()
