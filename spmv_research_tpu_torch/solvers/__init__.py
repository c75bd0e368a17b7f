"""Iterative solvers on the port's SpMV (``cg.py``) and the IC(0)/ILU(0)
factorizations with their level-scheduled triangular solves
(``ilu.py``)."""

from .cg import (SolveResult, bicgstab, cg, check_precond, make_precond,
                 make_precond_state, solve_bicgstab, solve_bicgstab_ilu0,
                 solve_cg, solve_cg_ic0)
from .ilu import (BandBlockSchedule, BandScheduleError, ChunkSchedule,
                  LevelSchedule, SchedulePaddingError,
                  build_band_block_schedule, build_chunk_schedule,
                  build_level_schedule, build_schedule, ic0, ilu0,
                  ilu0_solve, sptrsv)
