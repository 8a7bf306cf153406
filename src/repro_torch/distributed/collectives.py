"""Collectives over a mesh axis (port of ``repro.distributed.collectives``):
the exact tile sum and the compressed gradient all-reduce, plus the gathers
and reductions the mesh step and the sharded read use. Each takes a live
``launch.mesh.Mesh`` and the axes to reduce or gather over; over no axis
(or axes of size 1) it returns its input. Only ``all_reduce``,
``all_gather`` and ``broadcast`` are used: both backends take them on CUDA
tensors.

``tile_psum`` reduces per-shard crossbar partials (the forward's row-block
shift-and-add partials, the MᵀVM ``dx`` column partials) exactly, in f32:
the operands are product-grid sums, exact integers where the read is, and
the ``adc_bits=None`` identity with the float matmul relies on the sum being
exact. ``compressed_psum`` quantizes a gradient shard to 16-bit fixed point
on a scale shared across the axis before the sum, halving its bytes.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import prng


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over ``axes`` (``"sum"`` or ``"max"``), in place."""
    group = mesh.group(axes)
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The blocks of ``t`` over ``axes`` concatenated along ``dim`` in the
    axes' row-major coordinate order (every block of one shape)."""
    group = mesh.group(axes)
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(t: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """``t`` from global rank ``src`` to every rank of the mesh, in place."""
    if mesh.live and mesh.size > 1:
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
