"""On-disk format cache.

Counterpart of ``spmv_research_tpu/convert/cache.py``. The reference
re-converts every matrix on every run and reports conversion time as a
metric (``bench.cpp:600-603``); building a program costs seconds (a SELLR
or BFLY build ~15 s per million nonzeros), so ``build_best`` and the sweep
cache built formats keyed by (matrix content hash, format name, build
kwargs).

The key also holds a digest of the sources of the port's ``core/``,
``convert/`` and ``ops/`` modules, where every builder and its helpers
live: an edit to a builder's code (its chunking, routing, thresholds or a
module constant) changes the key, so an entry of the old code is never
served to the new one.

An entry is three files beside each other: ``<key>.npz`` holds the format's
tensors as numpy arrays (uncompressed: large bit planes decompress slower
than they load), ``<key>.tree`` a pickle of the format with each tensor
replaced by its leaf index (the skeleton: a fresh ``dataclasses.replace``
of every dataclass, so no ``cached_property`` value lands in it), and
``<key>.meta`` the cold build's seconds. A load gives CPU tensors, as a
builder does; callers move the format with ``.to(device)``.

The directory is ``$SPARSE_FORMAT_CACHE_TORCH`` (default
``./.format_cache_torch``), read at each call, so a caller can point it
elsewhere at run time; the JAX package's ``.format_cache`` is never read.
The skeleton names the port's classes by module path: a renamed class
makes an old entry unreadable, which counts as a corrupt entry (rebuilt).
``SCHEMA_VERSION`` is in the key as well, for a change to what an entry
holds that those sources do not show.
"""

from __future__ import annotations

import functools
import hashlib
import os
import pickle
import sys
import time
import zipfile
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.formats import tree_map
from ..core.host import HostCSR

CACHE_ENV = "SPARSE_FORMAT_CACHE_TORCH"
SCHEMA_VERSION = 1   # bump when what an entry holds changes outside the
                     # sources that source_digest() reads
SOURCE_DIRS = ("core", "convert", "ops")

# what reading a missing, truncated or stale entry can raise: the entry is
# rebuilt (load_format turns a pickle naming a class the package no longer
# has into pickle.UnpicklingError)
READ_ERRORS = (OSError, EOFError, pickle.UnpicklingError, zipfile.BadZipFile,
               KeyError, ValueError)

# hits, misses, the host seconds the hits saved (their cold builds' less
# their loads) and the seconds the misses spent writing their entries, since
# the last reset_stats(), as the kernels' launch counters
STATS = {"hits": 0, "misses": 0, "saved_s": 0.0, "save_s": 0.0}


def reset_stats() -> None:
    STATS.update(hits=0, misses=0, saved_s=0.0, save_s=0.0)


def describe(info: dict) -> str:
    """The words "cold build X s" or "from cache Y s (cold X s)" for an
    info dict of :func:`cached_build_timed`."""
    if info["from_cache"]:
        return (f"from cache {info['build_s']:.2f}s "
                f"(cold {info['cold_build_s']:.2f}s)")
    return f"cold build {info['build_s']:.2f}s"


def default_cache_dir() -> str:
    """The cache directory: ``$SPARSE_FORMAT_CACHE_TORCH`` at this call, or
    ``./.format_cache_torch``."""
    return os.environ.get(CACHE_ENV) or os.path.join(".", ".format_cache_torch")


def matrix_digest(csr: HostCSR) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(csr.ia).tobytes())
    h.update(np.ascontiguousarray(csr.ja).tobytes())
    h.update(np.ascontiguousarray(csr.a).tobytes())
    h.update(f"{csr.m}x{csr.n}".encode())
    return h.hexdigest()[:24]


@functools.lru_cache(maxsize=None)
def source_digest() -> str:
    """sha256 over the ``.py`` sources of the port's ``SOURCE_DIRS``, by
    relative path, as this process first read them."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    for d in SOURCE_DIRS:
        for name in sorted(os.listdir(os.path.join(root, d))):
            if name.endswith(".py"):
                h.update(f"{d}/{name}\0".encode())
                with open(os.path.join(root, d, name), "rb") as f:
                    h.update(f.read())
    return h.hexdigest()[:16]


def _key(csr: HostCSR, fmt_name: str, kwargs: dict) -> str:
    kv = "_".join(f"{k}={kwargs[k]}" for k in sorted(kwargs))
    kv = f"v{SCHEMA_VERSION}_src{source_digest()}_{kv}"
    return (f"{matrix_digest(csr)}_{fmt_name}_"
            f"{hashlib.sha1(kv.encode()).hexdigest()[:8]}")


class _Leaf:
    """A tensor's place in a skeleton: its index in the ``.npz``."""

    def __init__(self, index: int):
        self.index = index


def save_format(path: str, fmt: Any) -> None:
    leaves = []

    def take(t):
        leaves.append(t.detach().cpu().numpy())
        return _Leaf(len(leaves) - 1)

    skeleton = tree_map(take, fmt)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".npz", **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    with open(path + ".tree", "wb") as f:
        pickle.dump(skeleton, f)


def load_format(path: str) -> Any:
    with open(path + ".tree", "rb") as f:
        try:
            skeleton = pickle.load(f)
        except (AttributeError, ImportError) as e:   # a renamed class
            raise pickle.UnpicklingError(str(e)) from e
    with np.load(path + ".npz") as z:
        return tree_map(lambda leaf: torch.from_numpy(z[f"leaf_{leaf.index}"]),
                        skeleton, leaf=_Leaf)


def cached_build(builder: Callable, csr: HostCSR, fmt_name: str,
                 cache_dir: Optional[str] = None, **kwargs) -> Any:
    """build with on-disk caching: ``cached_build(build_bfly, host, "bfly")``."""
    fmt, _ = cached_build_timed(builder, csr, fmt_name,
                                cache_dir=cache_dir, **kwargs)
    return fmt


def cached_build_timed(builder: Callable, csr: HostCSR, fmt_name: str,
                       cache_dir: Optional[str] = None, **kwargs):
    """Like :func:`cached_build` but also returns ``{"build_s": wall seconds
    of this call, "cold_build_s": the cold build's seconds (recorded at the
    first build: a hit never reports its load time as the conversion cost),
    "from_cache": bool}``. An entry that cannot be read is rebuilt, with a
    ``#`` line on stderr; an entry that cannot be written is skipped (the
    cache is best-effort)."""
    path = os.path.join(cache_dir or default_cache_dir(),
                        _key(csr, fmt_name, kwargs))
    t0 = time.perf_counter()
    if os.path.exists(path + ".npz") and os.path.exists(path + ".tree"):
        try:
            fmt = load_format(path)
            t = time.perf_counter() - t0
            cold = None
            try:
                with open(path + ".meta", "rb") as f:
                    cold = pickle.load(f).get("cold_build_s")
            except READ_ERRORS:
                pass
            cold = cold if cold is not None else t
            STATS["hits"] += 1
            STATS["saved_s"] += cold - t
            return fmt, {"build_s": t, "cold_build_s": cold,
                         "from_cache": True}
        except READ_ERRORS as e:
            print(f"# format cache: unreadable entry {path} "
                  f"({type(e).__name__}: {e}); rebuilding", file=sys.stderr,
                  flush=True)
    fmt = builder(csr, **kwargs)
    t_cold = time.perf_counter() - t0
    STATS["misses"] += 1
    t0 = time.perf_counter()
    try:
        save_format(path, fmt)
        with open(path + ".meta", "wb") as f:
            pickle.dump({"cold_build_s": t_cold}, f)
    except OSError:
        pass  # cache is best-effort
    STATS["save_s"] += time.perf_counter() - t0
    return fmt, {"build_s": t_cold, "cold_build_s": t_cold,
                 "from_cache": False}
