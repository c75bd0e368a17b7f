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
fallback. Each build goes through the format cache
(``convert/cache.py:cached_build_timed``) under the JAX package's keys
``sellr``, ``sellw``, ``closg``, ``clos`` and ``bfly``, which the sweep's
builders share; the log line says of each entry "cold build X s" or "from
cache Y s (cold X s)", the cold build's time recorded when it was made.
"""

from __future__ import annotations

import sys

from ..core.host import HostCSR
from ..ops.bfly import build_bfly
from ..ops.clos import build_clos
from ..ops.clos_gather import build_clos_gather_auto
from ..ops.clos_route import ClosRoutingError
from ..ops.routing import RoutingError
from ..ops.sellr import SellRBuildError, build_sellr
from ..ops.sellw import SellWBuildError, build_sellw
from .cache import cached_build_timed, describe


def build_best(host: HostCSR) -> dict:
    """``{name: (format, info)}`` candidates for this matrix, each format on
    the CPU; ``info`` is ``cached_build_timed``'s ``{"build_s",
    "cold_build_s", "from_cache"}``."""
    out = {}
    for name, builder, refused in (("SELLR", build_sellr, SellRBuildError),
                                   ("SELLW", build_sellw, SellWBuildError)):
        try:
            out[name] = cached_build_timed(builder, host, name.lower())
        except refused:
            pass
    try:
        out["CLOSG"] = cached_build_timed(build_clos_gather_auto, host,
                                          "closg")
    except ClosRoutingError:
        try:
            out["CLOS"] = cached_build_timed(build_clos, host, "clos")
        except ClosRoutingError:
            try:
                out["BFLY"] = cached_build_timed(build_bfly, host, "bfly")
            except RoutingError:
                pass
    print("# build_best: " + ", ".join(
        f"{k} {describe(info)}" for k, (_, info) in out.items()),
        file=sys.stderr, flush=True)
    return out
