"""Shared kernel utilities (port of ``repro.kernels.common``)."""
from __future__ import annotations


def pick_block(dim: int, pref: int, granule: int = 128) -> int:
    """Largest block <= pref that divides dim, preferring hardware granules;
    the full dimension when no divisor exists. The sliced-MVM kernel masks
    its ragged token and column edges itself and needs no divisor block; the
    update kernels of the training slice block their operands with this."""
    if dim <= pref:
        return dim
    if dim % pref == 0:
        return pref
    for cand in range(pref - (pref % granule), 0, -granule):
        if dim % cand == 0:
            return cand
    for cand in range(pref, 0, -1):
        if dim % cand == 0:
            return cand
    return dim
