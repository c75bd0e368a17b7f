"""Typed benchmark configuration.

Counterpart of ``spmv_research_tpu/harness/config.py``, carried over for the
fields the SpMV protocol and the sweep read: the timing protocol (reference
``bench_spmv.cpp:335-384``), the value type and the matrix transforms, with
the reference's env-var overrides (``from_env``). The workload and
distribution fields follow the slices that use them.
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

    # --- numerics ---
    dtype: str = "float32"          # ValueType (f64 gold is always host-side)

    # --- matrix transforms (bench.cpp:588-598) ---
    # False | True | "auto" (rcm_if_beneficial: keep the reorder only when
    # mean row bandwidth drops)
    use_rcm_reordering: object = False
    fix_diagonal_zeros: bool = False
    matrix_transform: Optional[str] = None  # spd | dd (solver-dataset analogs)

    @staticmethod
    def from_env() -> "BenchConfig":
        """Honor the reference's env-var names for these fields."""
        c = BenchConfig()
        rcm = os.environ.get("USE_RCM_REORDERING", "")
        c.use_rcm_reordering = ("auto" if rcm == "auto"
                                else bool(_env("USE_RCM_REORDERING", int, 0)))
        c.fix_diagonal_zeros = bool(_env("FIX_DIAGONAL_ZEROS", int, 0))
        c.min_num_loops = _env("MIN_NUM_LOOPS", int, c.min_num_loops)
        c.min_time_s = _env("MIN_TIME_S", float, c.min_time_s)
        return c
