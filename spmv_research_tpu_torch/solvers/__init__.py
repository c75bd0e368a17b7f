"""Iterative solvers on the port's SpMV (``cg.py``); the IC(0)/ILU(0)
preconditioners and the trisolve (``solvers/ilu.py``) are not ported yet."""

from .cg import (SolveResult, bicgstab, cg, check_precond, make_precond,
                 make_precond_state, solve_bicgstab, solve_cg)
