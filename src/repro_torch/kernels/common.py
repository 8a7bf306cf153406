"""Shared kernel utilities (port of ``repro.kernels.common``)."""
from __future__ import annotations

import itertools
from typing import NamedTuple


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


class Origin(NamedTuple):
    """Where an ``[m, n]`` block of planes sits in its leaf's ``[M, N]``
    layer (one rank's block on a mesh): its first row and column, the
    layer's ``M`` and ``N``, and ``layers``, the flat stack index in the
    whole leaf of each of the block's layers (None: ``0, 1, ...``). The
    update's draws are taken at global coordinates, so a block updated at
    its origin equals the same block of the whole leaf's update."""

    row: int = 0
    col: int = 0
    rows: int = 0
    cols: int = 0
    layers: tuple | None = None

    def layer(self, l: int) -> int:
        return l if self.layers is None else self.layers[l]


def whole(origin, m: int, n: int) -> Origin:
    """``origin`` completed for an ``[m, n]`` block: None is the whole
    layer at (0, 0)."""
    if origin is None:
        return Origin(0, 0, m, n)
    if origin.row + m > origin.rows or origin.col + n > origin.cols:
        raise ValueError(f"block [{m}, {n}] at ({origin.row}, {origin.col}) outside its layer "
                         f"[{origin.rows}, {origin.cols}]")
    return origin
