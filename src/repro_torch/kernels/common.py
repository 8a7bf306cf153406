"""Shared kernel utilities (port of ``repro.kernels.common``)."""
from __future__ import annotations

import itertools


def pick_block(dim: int, pref: int, granule: int = 128) -> int:
    """Largest block <= pref that divides dim, preferring hardware granules;
    the full dimension when no divisor exists. The sliced-MVM kernel masks
    its ragged token and column edges itself and needs no divisor block, and
    so do the update kernels."""
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


def hw_tiles(M: int, N: int) -> tuple[int, int]:
    """The (bm, bn) tile of an ``[M, N]`` block that seeds the update's
    ``"hw"`` draw: the reference kernel's default blocking
    (``pick_block(M, 128)``, ``pick_block(N, 256)``)."""
    return pick_block(M, 128), pick_block(N, 256)


def layer_views(planes) -> list:
    """Each layer's ``[S, M, N]`` block of planes ``[S, *stack, M, N]``, as
    views in stack order. On the port's layer-major storage (``[*stack, S,
    M, N]``, see ``optim.panther``) every block is contiguous, so a kernel
    updates it in place with no copy of the stack."""
    stack = planes.shape[1:-2]
    return [planes[(slice(None), *idx)] for idx in itertools.product(*map(range, stack))]
