"""Collectives over a mesh axis (port of ``repro.distributed.collectives``):
the exact tile sum and the compressed gradient all-reduce, plus the gathers
and reductions the mesh step and the sharded read use. Each takes a live
``launch.mesh.Mesh`` and the axes to reduce or gather over; over no axis
(or axes of size 1) it returns its input. Only ``all_reduce``,
``all_gather`` and ``broadcast`` are used: both backends take them on CUDA
tensors.

Every call that crosses ranks is counted in :data:`tally` by kind (the
reference dry run's five, and ``broadcast``): its count and its result's
bytes. On a dry mesh (``launch.mesh.dry_mesh``: one rank's coordinate, no
process group) a call is counted and answered with an output of the right
shape (an all-gather's blocks are the rank's own block repeated), and sends
nothing: the dry run (``launch.dryrun``) runs one rank's step that way.

``tile_psum`` reduces per-shard crossbar partials (the forward's row-block
shift-and-add partials, the MᵀVM ``dx`` column partials) exactly, in f32:
the operands are product-grid sums, exact integers where the read is, and
the ``adc_bits=None`` identity with the float matmul relies on the sum being
exact. ``compressed_psum`` quantizes a gradient shard to 16-bit fixed point
on a scale shared across the axis before the sum, halving its bytes.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from repro_torch.core import prng

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute", "broadcast")


class Tally:
    """The collectives of this process by kind: ``counts`` and ``bytes``
    (each call's result, as the reference dry run sums its collectives'
    result operands)."""

    def __init__(self):
        self.counts = collections.Counter()
        self.bytes = collections.Counter()

    def add(self, kind: str, nbytes: int) -> None:
        self.counts[kind] += 1
        self.bytes[kind] += int(nbytes)

    def clear(self) -> None:
        self.counts.clear()
        self.bytes.clear()

    def record(self) -> dict:
        """``{"bytes", "counts", "total_bytes"}`` over every kind."""
        by = {k: self.bytes[k] for k in KINDS}
        return {"bytes": by, "counts": {k: self.counts[k] for k in KINDS}, "total_bytes": sum(by.values())}


tally = Tally()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over ``axes`` (``"sum"`` or ``"max"``), in place."""
    group = mesh.group(axes)
    if group is not None:
        tally.add("all-reduce", _nbytes(t))
        if not mesh.dry:
            dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The blocks of ``t`` over ``axes`` concatenated along ``dim`` in the
    axes' row-major coordinate order (every block of one shape)."""
    group = mesh.group(axes)
    if group is None:
        return t
    t = t.contiguous()
    n = mesh.axes_size(axes) if mesh.dry else dist.get_world_size(group)
    parts = [torch.empty_like(t) for _ in range(n)]
    tally.add("all-gather", n * _nbytes(t))
    if mesh.dry:
        parts[mesh.index(axes)].copy_(t)
    else:
        dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(t: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """``t`` from global rank ``src`` to every rank of the mesh, in place."""
    if mesh.live and mesh.size > 1:
        tally.add("broadcast", _nbytes(t))
        if not mesh.dry:
            dist.broadcast(t, src=src)
    return t


def tile_psum(partial: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Exact f32 all-reduce of per-shard crossbar-tile partials over
    ``axis``. Deliberately not ``compressed_psum``: a quantized sum would
    bring back the error the ideal-ADC identity proves away."""
    if partial.dtype != torch.float32:
        raise ValueError(f"tile_psum sums f32 partials, got {partial.dtype}")
    return all_reduce(partial, mesh, axis)


def compressed_psum(g: torch.Tensor, mesh, axis, key=None, bits: int = 16) -> torch.Tensor:
    """Quantized all-reduce of a gradient shard over ``axis``: ``g`` on a
    ``bits``-bit grid of a scale shared across the axis (the global
    ``max|g|``), stochastically rounded under the host key ``key``
    (``core.prng``, ``jax.random.uniform``'s stream) or half to even
    without, summed in int32, scaled back. Returns f32."""
    amax = all_reduce(g.detach().abs().max().to(torch.float32).reshape(1), mesh, axis, "max")[0]
    lim = float(2 ** (bits - 1) - 1)
    scale = torch.where(amax > 0, lim / amax, torch.ones_like(amax))
    y = g.to(torch.float32) * scale
    if key is not None:
        y = torch.floor(y + prng.uniform(key, tuple(y.shape), device=y.device))
    else:
        y = torch.round(y)
    q = torch.clamp(y, -lim, lim).to(torch.int32)
    return all_reduce(q, mesh, axis).to(torch.float32) / scale
