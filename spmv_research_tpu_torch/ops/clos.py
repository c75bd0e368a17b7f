"""Clos packed-word layout and the plain in-vreg layer.

Counterpart of the parts of ``spmv_research_tpu/ops/clos.py`` that CLOSG
uses: the bit-layout constants, ``_pack``, ``_stage_bit``, the plain in-vreg
layer (``_invreg_xla``) and the ``_t_fwd``/``_t_bwd`` transposes. The CLOS
engine itself (three exact-Clos networks) is not ported yet.

Each layer word packs one slot's three in-vreg shuffle indices: bits [0,7)
lane1, [7,10) sublane rotation, [10,17) lane2; the 15 spare bits [17,32)
carry whatever follows the layer (CLOSG: λ in r1, scan guards in r3). Words
use all 32 bits, and torch's int32 ``>>`` is arithmetic, so every read
masks after shifting.
"""

from __future__ import annotations

import numpy as np
import torch

from .clos_route import BLK, LANES, SUB

LANE1_SHIFT, ROT_SHIFT, LANE2_SHIFT, SPARE_SHIFT = 0, 7, 10, 17
SPARE_BITS = 32 - SPARE_SHIFT  # 15


def _pack(p, spare: np.ndarray | None = None) -> np.ndarray:
    """Pack one layer's planes (+optional spare-bit payload) into int32."""
    w = (p.lane1.astype(np.uint32)
         | (p.subrot.astype(np.uint32) << ROT_SHIFT)
         | (p.lane2.astype(np.uint32) << LANE2_SHIFT))
    if spare is not None:
        w |= spare.reshape(w.shape).astype(np.uint32) << SPARE_SHIFT
    return w.view(np.int32)


def _stage_bit(k: int, lo_word: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Guard bit of scan stage k: bit 17+k of the r3 word for k < 15, else
    bit k-15 of the overflow plane ``hi``."""
    if k < SPARE_BITS:
        return ((lo_word >> (SPARE_SHIFT + k)) & 1) != 0
    return ((hi >> (k - SPARE_BITS)) & 1) != 0


def invreg_torch(v: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
    """One in-vreg layer on an (S, L) array: lane-pick by lane1, rotate each
    8-row group by ``rot``, lane-pick by lane2 (``_invreg_xla``)."""
    S, L = v.shape
    l1 = (word & 0x7F).long()
    rot = ((word >> ROT_SHIFT) & 0x7).long()
    l2 = ((word >> LANE2_SHIFT) & 0x7F).long()
    t1 = torch.gather(v, 1, l1)
    rows = torch.arange(S, device=v.device).unsqueeze(1)
    src = rows // SUB * SUB + (rows % SUB + rot) % SUB
    t2 = torch.gather(t1, 0, src)
    return torch.gather(t2, 1, l2)


def _t_fwd(v: torch.Tensor, V: int) -> torch.Tensor:
    """(8V, 128) slot layout -> transposed (8·1024, V/8) layout; a stack of
    C such planes (CLOSGX) is transposed plane by plane in one copy."""
    return (v.reshape(-1, V, BLK).transpose(1, 2).contiguous()
            .view(-1, V // SUB))


def _t_bwd(v: torch.Tensor, V: int) -> torch.Tensor:
    return (v.reshape(-1, BLK, V).transpose(1, 2).contiguous()
            .view(-1, LANES))
