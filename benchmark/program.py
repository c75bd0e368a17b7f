"""The system under test behind one small interface, and the control.

``PortProgram`` is the PyTorch and CUDA port (``spmv_research_tpu_torch``):
the configuration's builder through the port's format cache, then
``ops.dispatch.spmv`` / ``spmm`` on the built format, and
``solvers.cg.cg`` with the port's Jacobi ``inv_diag``. This is the only
module of the benchmark that imports the port.

``ReferenceProgram`` puts the plain reference in the program's place,
computed in ``bfloat16``, the precision below the configurations'
float32: the control that the comparison has to fail.

Both give ``build(csr)`` → info, ``spmv(x)``, ``spmm(X)``,
``cg(b, rtol, max_iters)`` → (x, {"iterations", "converged",
"loop_iterations"}) and ``release()``.
"""

from __future__ import annotations

import importlib
import time

import torch

from . import reference


class PortProgram:
    def __init__(self, config: dict, device):
        self.fmt = config["format"]
        self.device = torch.device(device)
        self.impl = self.fmt["impl"] if self.device.type == "cuda" else "torch"
        self.A = None
        self.host = None
        self.inv_diag = None

    def build(self, csr) -> dict:
        """The configuration's format of ``csr`` on the device; the info
        of the port's ``cached_build_timed``, with the host seconds of the
        copy into the port's ``HostCSR`` and of the whole cached build
        (the cache key's digests, the build or load)."""
        from spmv_research_tpu_torch import ops  # noqa: F401  (registers)
        from spmv_research_tpu_torch.convert.cache import cached_build_timed
        from spmv_research_tpu_torch.core.host import HostCSR
        module, name = self.fmt["builder"].split(":")
        builder = getattr(importlib.import_module(module), name)
        t0 = time.perf_counter()
        self.host = HostCSR.from_arrays(csr.ia, csr.ja, csr.a, csr.m, csr.n)
        t1 = time.perf_counter()
        A, info = cached_build_timed(builder, self.host, self.fmt["cache_key"],
                                     **self.fmt.get("kwargs", {}))
        info = dict(info, host_copy_s=t1 - t0,
                    cached_build_s=time.perf_counter() - t1)
        if A.format_name != self.fmt["format_name"]:
            raise RuntimeError(f"{self.fmt['builder']} built {A.format_name}, "
                               f"the configuration states "
                               f"{self.fmt['format_name']}")
        self.A = A.to(self.device)
        return info

    def spmv(self, x):
        from spmv_research_tpu_torch.ops import dispatch
        return dispatch.spmv(self.A, x, impl=self.impl)

    def spmm(self, X):
        from spmv_research_tpu_torch.ops import dispatch
        return dispatch.spmm(self.A, X, impl=self.impl)

    def cg(self, b, rtol: float, max_iters: int):
        from spmv_research_tpu_torch.solvers.cg import cg, make_precond_state
        if self.inv_diag is None:
            _, self.inv_diag = make_precond_state(self.host, "jacobi",
                                                  torch.float32, self.device)
        x, info = cg(self.A, b, inv_diag=self.inv_diag, rtol=rtol,
                     max_iters=max_iters, impl=self.impl)
        return x, {"iterations": info["iterations"],
                   "converged": info["converged"],
                   "loop_iterations": info["loop_iterations"]}

    def release(self) -> None:
        self.A = self.host = self.inv_diag = None


class ReferenceProgram:
    """The reference in bfloat16 where the program would run."""

    dtype = torch.bfloat16

    def __init__(self, config: dict, device):
        self.device = torch.device(device)
        self.A = None

    def build(self, csr) -> dict:
        self.A = reference.RefMatrix(csr, self.device, self.dtype)
        return {"build_s": 0.0, "cold_build_s": 0.0, "from_cache": False}

    def spmv(self, x):
        return self.A.spmv(x)

    def spmm(self, X):
        return self.A.spmm(X)

    def cg(self, b, rtol: float, max_iters: int):
        x, it = reference.cg(self.A, b, rtol, max_iters)
        r = b.to(self.dtype) - self.A.spmv(x)
        converged = (float(torch.dot(r, r))
                     <= rtol ** 2 * float(torch.dot(b, b)))
        return x, {"iterations": it, "converged": converged,
                   "loop_iterations": it}

    def release(self) -> None:
        self.A = None
