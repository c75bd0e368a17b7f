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

Over k ranks (a workload whose ``chips`` is k > 1), :func:`join` makes the
process group with the port's ``parallel.init_multihost``, and
``RankProgram`` holds one rank's shard: the configuration's plan builder,
called as ``(HostCSR, k, **kwargs)`` through the port's format cache (k in
the key), ``plan.shard(rank, device, mesh, axis)``, and the rank-local
entry points that the configuration names: ``spmv(x_block)`` →
``y_block`` (and ``spmm``, ``cg`` where named), ``block(x)``: this rank's
block of a global vector, and the collective ``whole(block)``: the global
vector from every rank's block (x and y blocks laid out alike).
"""

from __future__ import annotations

import importlib
import os
import time

import torch

from . import reference
from .ranks import CONTROL_TIMEOUT


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


def resolve(path: str):
    """The object that ``"module:qualified.name"`` names."""
    module, name = path.split(":")
    obj = importlib.import_module(module)
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def join(control, axis: str) -> None:
    """Make the run's process group, on the ``file://`` store in
    ``control.store``, with the port's ``init_multihost`` (the backend
    ``control.backend``), the 1-D mesh of its ranks named ``axis``, and the
    gloo group for host-side control; sets ``control.group``, ``.mesh``
    and ``.device`` (this rank's device, the port's ``rank_device``). Every
    rank calls it first, before anything that may take long."""
    import torch.distributed as dist
    from spmv_research_tpu_torch.parallel import (init_multihost,
                                                  make_sparse_mesh)
    from spmv_research_tpu_torch.parallel.comm import rank_device
    init_multihost(f"file://{os.path.join(control.store, 'store')}",
                   control.k, control.rank, backend=control.backend)
    control.mesh = make_sparse_mesh(control.k, axis, control.device_type)
    control.group = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
    control.device = rank_device(control.device_type)


class RankProgram:
    """One rank's shard of the configuration's plan over k ranks.

    The configuration's ``format`` names the plan builder (``builder``,
    called as ``(HostCSR, k, **kwargs)``), its ``cache_key``, the
    ``format_name`` of the shard it gives (its ``format_name``, else its
    class's name), the mesh's ``mesh_axis`` and the rank-local
    ``entries`` (``"module:name"``, called as ``entry(shard, v,
    **entry_kwargs[name])``): ``spmv``, ``block`` and ``whole`` always
    (a product's blocks laid out as x's), and ``spmm`` or ``cg`` where a
    mix needs them. Rank 0 builds the plan; the harness holds the other
    ranks at a barrier until it is in the cache, so they load it."""

    def __init__(self, config: dict, device, control):
        self.fmt = config["format"]
        self.device = torch.device(device)
        self.control = control
        self.A = None
        self.entries = {}

    def build(self, csr) -> dict:
        """This rank's shard on its device; the info of the port's
        ``cached_build_timed`` of the whole plan, as ``PortProgram``'s."""
        from spmv_research_tpu_torch.convert.cache import cached_build_timed
        from spmv_research_tpu_torch.core.host import HostCSR
        builder = resolve(self.fmt["builder"])
        t0 = time.perf_counter()
        host = HostCSR.from_arrays(csr.ia, csr.ja, csr.a, csr.m, csr.n)
        t1 = time.perf_counter()
        plan, info = cached_build_timed(builder, host, self.fmt["cache_key"],
                                        k=self.control.k,
                                        **self.fmt.get("kwargs", {}))
        info = dict(info, host_copy_s=t1 - t0,
                    cached_build_s=time.perf_counter() - t1)
        del host
        A = plan.shard(self.control.rank, self.device, self.control.mesh,
                       self.fmt.get("mesh_axis", "rows"))
        name = getattr(A, "format_name", type(A).__name__)
        if name != self.fmt["format_name"]:
            raise RuntimeError(f"{self.fmt['builder']} gave a {name} shard, "
                               f"the configuration states "
                               f"{self.fmt['format_name']}")
        kwargs = self.fmt.get("entry_kwargs", {})
        self.entries = {e: (resolve(path), kwargs.get(e, {}))
                        for e, path in self.fmt["entries"].items()}
        self.A = A
        return info

    def _call(self, entry: str, v, **extra):
        if entry not in self.entries:
            raise NotImplementedError(
                f"the configuration names no rank-local {entry!r} entry")
        fn, kwargs = self.entries[entry]
        return fn(self.A, v, **kwargs, **extra)

    def spmv(self, x):
        return self._call("spmv", x)

    def spmm(self, X):
        return self._call("spmm", X)

    def cg(self, b, rtol: float, max_iters: int):
        """(this rank's block of x, the solver's info with
        ``iterations``, ``converged`` and ``loop_iterations``)."""
        return self._call("cg", b, rtol=rtol, max_iters=max_iters)

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global vector ``x``."""
        return self._call("block", x.detach().cpu().numpy())

    def whole(self, v: torch.Tensor) -> torch.Tensor:
        """The global vector from every rank's block ``v`` of it (a
        collective: every rank calls it)."""
        out = self._call("whole", v)
        return torch.as_tensor(out).to(device=v.device, dtype=v.dtype)

    def release(self) -> None:
        self.A = None
        self.entries = {}


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
