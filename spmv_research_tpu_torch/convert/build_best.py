"""Format selection for benchmarking.

Counterpart of ``spmv_research_tpu/convert/build_pallas.py:build_best``, in
the JAX order: SELLR, then SELLW (the column-locality engines; their
builders refuse matrices without locality), then CLOSG, whose entry holds
whatever ``build_clos_gather_auto`` returns: a ``ClosG``, a
``ClosGChunked``, a ``RowSplit`` or a ``ClosGX``. Where CLOSG refuses a
matrix (``ClosRoutingError``), the JAX package's format order goes on: CLOS
(which refuses past 2^20 slots), then BFLY (past 2^22 slots,
``RoutingError``); a matrix that all three refuse gets only the locality
engines that took it. This is an order of formats, not a device
fallback. The format cache (``convert/cache.py``) is not ported: every
build is a cold build, and its time is reported as such.
"""

from __future__ import annotations

import sys
import time

from ..core.host import HostCSR
from ..ops.bfly import build_bfly
from ..ops.clos import build_clos
from ..ops.clos_gather import build_clos_gather_auto
from ..ops.clos_route import ClosRoutingError
from ..ops.routing import RoutingError
from ..ops.sellr import SellRBuildError, build_sellr
from ..ops.sellw import SellWBuildError, build_sellw


def _timed(builder, host: HostCSR) -> tuple:
    t0 = time.perf_counter()
    A = builder(host)
    t = time.perf_counter() - t0
    return A, {"build_s": t, "cold_build_s": t, "from_cache": False}


def build_best(host: HostCSR) -> dict:
    """``{name: (format, info)}`` candidates for this matrix, each format on
    the CPU; ``info`` is ``{"build_s", "cold_build_s", "from_cache"}`` as the
    JAX package's cached build reports it."""
    out = {}
    for name, builder, refused in (("SELLR", build_sellr, SellRBuildError),
                                   ("SELLW", build_sellw, SellWBuildError)):
        try:
            out[name] = _timed(builder, host)
        except refused:
            pass
    try:
        out["CLOSG"] = _timed(build_clos_gather_auto, host)
    except ClosRoutingError:
        try:
            out["CLOS"] = _timed(build_clos, host)
        except ClosRoutingError:
            try:
                out["BFLY"] = _timed(build_bfly, host)
            except RoutingError:
                pass
    print("# build_best: " + ", ".join(
        f"{k} cold build {info['build_s']:.2f}s"
        for k, (_, info) in out.items()), file=sys.stderr, flush=True)
    return out
