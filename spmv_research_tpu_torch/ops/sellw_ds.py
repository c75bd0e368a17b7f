"""SELLWDS: fp64-parity SpMV at engine speed — double-single value planes on
the SELLW routing program.

Counterpart of ``spmv_research_tpu/ops/sellw_ds.py``. The routing planes are
SELLW's (word bits, sublane binding, stage classes, part capping); the value
plane becomes an (hi, lo) fp32 pair, ``base.vals`` and ``vlo``, and the
pipeline becomes:

* gather: two picks, from the x hi and x lo planes;
* product: Dekker TwoProd(vhi, xhi) plus the cross terms vhi·xlo + vlo·xhi;
* scan: a guarded segmented TwoSum scan (the error plane rides along);
* extraction and the per-block combine: sequential TwoSum folds over the
  sublanes, then over the ``K`` yidx rows (a plain fp32 sum would throw
  the 2^-48 margin away).

The error after an n-term row is O(n·2^-48) relative, inside the
reference's fp64 gate (1e-10 against the longdouble Kahan gold).

Impls, as for SELLW: ``"cuda"`` runs kernel B13 (``sell_cuda.sellwds_planes``,
``csrc/sell.cu``) and ``"torch"`` its plain version; both then combine in
PyTorch (``_combine_y_ds``, as ``_combine_y`` does for SELLW). The
registered entries take an fp32 x with a zero lo plane (the harness's timed
chain); ``spmv_sellwds_f64`` takes an fp64 x and returns an fp64 y. The
builder refuses what the JAX builder refuses: a non-fp32 dtype, values past
``DS_MAX_ABS``, and n past ``_X_VMEM_LIMIT``. The last is a TPU limit (x
resident in VMEM) that B13, which reads x from device memory, does not
have; it is kept so that both packages take the same matrices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.formats import _move
from ..core.host import HostCSR
from .compensated import DSRangeError, _split_f64, _two_sum, check_ds_range
from .dispatch import default_impl, register_spmv
from .sellw import (SellW, SellWBuildError, _X_VMEM_LIMIT, build_sellw,
                    class_plan, sellw_from_jax)
from . import sell_cuda as K


@dataclasses.dataclass(frozen=True)
class SellWDS:
    base: SellW            # routing program and hi value plane (base.vals)
    vlo: torch.Tensor      # (8·nchunks_pad, 128) fp32 value lo plane

    format_name = "SELLWDS"

    # the SellW interface, passed through (harness and dispatch read it)
    @property
    def shape(self):
        return self.base.shape

    @property
    def m(self):
        return self.base.m

    @property
    def n(self):
        return self.base.n

    @property
    def nnz(self):
        return self.base.nnz

    @property
    def nnz_expanded(self):
        return self.base.nnz_expanded

    @property
    def device(self) -> torch.device:
        return self.base.device

    def to(self, device) -> "SellWDS":
        return _move(self, device)

    def mem_footprint_bytes(self) -> int:
        return int(self.base.mem_footprint_bytes() + self.vlo.numel() * 4)


def build_sellwds(csr: HostCSR, dtype=np.float32, group: int = 2,
                  part_cap: int = 8,
                  max_chunk_factor: float = 4.0) -> SellWDS:
    """Compile host CSR (fp64 values) into the DS program. ``dtype`` is
    accepted for builder-signature parity and must be float32."""
    if np.dtype(dtype) != np.float32:
        raise SellWBuildError("SELLWDS is an fp32-pair format")
    try:
        check_ds_range(csr.a)
    except DSRangeError as e:
        raise SellWBuildError(str(e)) from None
    if csr.n > _X_VMEM_LIMIT:
        raise SellWBuildError(
            "n too large for the VMEM-resident hi/lo x planes of the JAX "
            "kernel (stream_wins DS path not built; CSRDS covers this tier)")
    base, idxp = build_sellw(csr, dtype=np.float32, group=group,
                             part_cap=part_cap,
                             max_chunk_factor=max_chunk_factor,
                             want_idx=True)
    _, lo = _split_f64(csr.a)
    vlo = np.zeros(idxp.shape, np.float32)
    live = idxp >= 0
    vlo[live] = lo[idxp[live]]
    return SellWDS(base=base, vlo=torch.from_numpy(vlo))


def sellwds_from_jax(leaves: dict, meta: dict) -> SellWDS:
    """The port's ``SellWDS`` for a program built by the JAX package:
    ``leaves`` maps SELLW's data fields and ``vlo`` to their arrays,
    ``meta`` SELLW's meta fields to their values."""
    return SellWDS(base=sellw_from_jax(leaves, meta),
                   vlo=torch.from_numpy(np.array(leaves["vlo"],
                                                 np.float32)))


# ---------------------------------------------------------------- execution

def _combine_y_ds(B: SellW, planes: torch.Tensor):
    """Per-y-block combine of the chunk partials: a sequential TwoSum over
    the K yidx rows, in the JAX order. ``planes`` (2, G·npad + 1, 128):
    the s and e planes, each ending in the zero row."""
    idx = B.yidx.long()
    seg_s, seg_e = planes[0][idx], planes[1][idx]      # (K, nb, 128)
    S = torch.zeros_like(seg_s[0])
    E = torch.zeros_like(seg_e[0])
    for k in range(B.K):
        S, e1 = _two_sum(S, seg_s[k])
        E = E + e1 + seg_e[k]
    return S.reshape(-1)[: B.m], E.reshape(-1)[: B.m]


def _planes_args(A: SellWDS, xhi, xlo):
    B = A.base
    return (B.word, B.vals, A.vlo, B.wrow, xhi.to(torch.float32),
            xlo.to(torch.float32), class_plan(B), B.G)


def spmv_sellwds_torch_pair(A: SellWDS, xhi: torch.Tensor,
                            xlo: torch.Tensor):
    """Pair-in, pair-out SpMV in plain PyTorch (the counterpart of the JAX
    ``spmv_sellwds_xla_pair``): (xhi, xlo) → (s, e), each of length m."""
    return _combine_y_ds(A.base, K.sellwds_planes_torch(
        *_planes_args(A, xhi, xlo)))


def spmv_sellwds_cuda_pair(A: SellWDS, xhi: torch.Tensor,
                           xlo: torch.Tensor):
    """Pair-in, pair-out SpMV through kernel B13 (CUDA tensors only)."""
    if xhi.device.type != "cuda" or A.device != xhi.device:
        raise ValueError(f"SELLWDS/cuda needs the program and x on one CUDA "
                         f"device, got {A.device} and {xhi.device}")
    return _combine_y_ds(A.base, K.sellwds_planes(*_planes_args(A, xhi,
                                                                 xlo)))


_PAIRS = {"cuda": spmv_sellwds_cuda_pair, "torch": spmv_sellwds_torch_pair}


def spmv_sellwds_f64(A: SellWDS, x: np.ndarray,
                     impl: Optional[str] = None) -> np.ndarray:
    """Host fp64 x → DS pair on ``A.device`` → host fp64 y (~2^-48
    relative). ``impl`` defaults to the one ``A.device`` takes."""
    impl = impl or default_impl(SellWDS.format_name, A.device)
    xhi, xlo = _split_f64(x)
    s, e = _PAIRS[impl](A, torch.from_numpy(xhi).to(A.device),
                        torch.from_numpy(xlo).to(A.device))
    return (s.cpu().numpy().astype(np.float64)
            + e.cpu().numpy().astype(np.float64))


def _fp32_entry(pair):
    def spmv(A: SellWDS, x: torch.Tensor) -> torch.Tensor:
        """fp32-x entry (x with a zero lo plane), so the harness drives the
        format like any other; the value planes keep their fp64
        precision."""
        xhi = x.to(torch.float32)
        s, e = pair(A, xhi, torch.zeros_like(xhi))
        return s + e
    return spmv


spmv_sellwds_cuda = register_spmv("SELLWDS", "cuda")(
    _fp32_entry(spmv_sellwds_cuda_pair))
spmv_sellwds_torch = register_spmv("SELLWDS", "torch")(
    _fp32_entry(spmv_sellwds_torch_pair))

SellWDS.spmv_f64 = spmv_sellwds_f64   # the harness's fp64-gate hook

