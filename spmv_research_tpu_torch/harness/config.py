"""Typed benchmark configuration.

Counterpart of ``spmv_research_tpu/harness/config.py``, carried over for the
fields the SpMV, SpMM, SDDMM, CG and BiCGStab protocols and the sweep
read: the timing protocol (reference ``bench_spmv.cpp:335-384``), the value
type, the matrix transforms, the K dimension and the solvers' iteration cap
and preconditioner, with the reference's env-var overrides (``from_env``).
The distribution fields follow the slice that uses them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env(name, cast, default):
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return cast(v)
    except ValueError:
        return default


@dataclasses.dataclass
class BenchConfig:
    # --- timing protocol (reference bench_spmv.cpp:335-384,634-648) ---
    min_num_loops: int = 64
    min_time_s: float = 2.0
    warmup_iters: int = 20          # role of the GPU 1000-iter warmup (:287-294)
    # calls per timed batch of the chain, the JAX field's role (calls fused
    # per timed step): here the calls between one synchronise and the next
    # of the SpMV, SpMM and SDDMM chains (None: 64)
    inner_iters: Optional[int] = None

    # --- numerics ---
    dtype: str = "float32"          # ValueType (f64 gold is always host-side)

    # --- matrix transforms (bench.cpp:588-598) ---
    # False | True | "auto" (rcm_if_beneficial: keep the reorder only when
    # mean row bandwidth drops)
    use_rcm_reordering: object = False
    fix_diagonal_zeros: bool = False
    matrix_transform: Optional[str] = None  # spd | dd (solver-dataset analogs)

    # --- workloads ---
    k_dim: int = 128                # SDDMM/SpMM K (K_DIM env, config.sh:138-143)
    cg_max_num_iters: int = 50      # CG_MAX_NUM_ITERS (config.sh:110-112)
    solver_precond: str = "jacobi"  # jacobi (ic0 | ilu0: not ported yet)

    @staticmethod
    def from_env() -> "BenchConfig":
        """Honor the reference's env-var names for these fields."""
        c = BenchConfig()
        rcm = os.environ.get("USE_RCM_REORDERING", "")
        c.use_rcm_reordering = ("auto" if rcm == "auto"
                                else bool(_env("USE_RCM_REORDERING", int, 0)))
        c.fix_diagonal_zeros = bool(_env("FIX_DIAGONAL_ZEROS", int, 0))
        c.k_dim = _env("K_DIM", int, c.k_dim)
        c.cg_max_num_iters = _env("CG_MAX_NUM_ITERS", int, c.cg_max_num_iters)
        c.min_num_loops = _env("MIN_NUM_LOOPS", int, c.min_num_loops)
        c.min_time_s = _env("MIN_TIME_S", float, c.min_time_s)
        return c
