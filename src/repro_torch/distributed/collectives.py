"""Collectives over a mesh axis (port of ``repro.distributed.collectives``):
the exact tile sum and the compressed gradient all-reduce, plus the gathers
and reductions the mesh step and the sharded read use. Each takes a live
``launch.mesh.Mesh`` and the axes to reduce or gather over; over no axis
(or axes of size 1) it returns its input. Only ``all_reduce``,
``all_gather`` and ``broadcast`` are used: both backends take them on CUDA
tensors. ``all_gather_with_grad`` is the gather whose backward sums the
cotangent over the axes (an ``all_reduce``) and keeps this rank's block;
``mean_grad`` the identity whose backward averages it over the axes.

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


class _GatherSummedBack(torch.autograd.Function):
    """``all_gather`` forward; backward: the cotangent summed over the axes
    (``all_reduce``: gloo has no reduce-scatter) and this rank's block kept."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim, ctx.n = mesh, axes, dim, t.shape[dim]
        return all_gather(t, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.mesh, ctx.axes)
        return g.narrow(ctx.dim, ctx.mesh.index(ctx.axes) * ctx.n, ctx.n), None, None, None


def all_gather_with_grad(t: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """``all_gather`` of this rank's shard ``t`` for a computation that
    every rank of ``axes`` runs on the whole, each from its own loss: the
    gradient of ``t`` is the sum over those ranks of their cotangents' rows
    of ``t``."""
    if mesh.group(axes) is None:
        return t
    return _GatherSummedBack.apply(t, mesh, axes, dim)


class _MeanBack(torch.autograd.Function):
    """The identity forward; backward: the cotangent summed over the axes
    (``all_reduce``) and divided by their size."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.mesh, ctx.axes)
        return g / ctx.mesh.axes_size(ctx.axes), None, None


def mean_grad(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t`` itself, whose gradient is the mean over the ranks of ``axes``
    of their cotangents: where each rank's loss reaches a whole tensor that
    every rank computes alike through its own rows only, every rank then
    runs the backward from there on the same (the whole loss's) cotangent,
    scaled by 1/size so that the ranks' gradients summed over ``axes`` are
    the whole loss's."""
    if mesh.group(axes) is None:
        return t
    return _MeanBack.apply(t, mesh, axes)


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
