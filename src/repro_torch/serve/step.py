"""Serving steps (port of ``repro.serve.step``): batched prefill and
single-token decode (greedy, or sampled by ``core.prng.categorical``) over
the model fns, and :func:`fidelity_params`, which wraps a served param tree
so every operand-eligible linear reads the int8 crossbar planes through the
finite-ADC engine. SLA tiers are several wraps at different ADC resolutions
over the same ``sliced`` planes. These step functions serve one request shape at
a time; mixed lengths are ``serve.engine`` and ``serve.scheduler`` over the
paged cache, which drive the same ``lm.prefill`` / ``lm.decode_step``.

On a mesh (``mesh=``, a live ``launch.mesh.Mesh``), each rank holds its
block of the planes (``train.step.shard_state``) and the served step reads
its crossbar tile blocks (the fidelity reads' mesh context,
``distributed.fidelity``); the batch shards over the data axes that divide
``global_batch``: every rank gets the whole batch, serves its rows, and
returns the whole batch's tokens and logits (all-gathered), its caches its
own rows.
"""
from __future__ import annotations

import torch

from repro_torch import plan as planlib
from repro_torch import tree
from repro_torch.core import prng
from repro_torch.distributed import blocks
from repro_torch.distributed import collectives as col
from repro_torch.distributed import fidelity as dist_fid
from repro_torch.models import lm
from repro_torch.models.common import LMConfig, ShapeDtype
from repro_torch.optim import panther


def fidelity_params(params, sliced, plan, mesh=None, specs=None):
    """Wrap a served (materialized) param tree for finite-ADC reads: each
    leaf serves at its resolved ``plan.fidelity``; leaves without one stay on
    the lossless dense path. Forward only.

    With ``mesh``: ``sliced`` is this rank's block tree and ``specs`` its
    spec tree (``train.step.storage_specs(...).sliced``); each wrap's
    fidelity carries the tile-shard hint (``plan.attach_fidelity_shard_dims``)
    and its planes are this rank's tile block (gathered over any other
    sharded dim). Serve through steps built with the same ``mesh``."""
    if mesh is None:
        return panther.fidelitize(params, sliced, plan)
    if specs is None:
        raise ValueError("fidelity_params(mesh=...) needs the planes' spec tree (specs=)")
    shapes = tree.map(lambda p, s, sp: p if s is None else ShapeDtype(
        blocks.whole_shape(sp.planes, tuple(s.planes.shape), mesh)[1:], torch.float32), params, sliced, specs)
    plan = planlib.attach_fidelity_shard_dims(plan, mesh, shapes)

    def read(s, sp, pl):
        if s is None or pl.fidelity is None or pl.grad != "operand":
            return s
        return blocks.read_block(s, sp.planes, pl.fidelity.shard_dim, mesh)

    return panther.fidelitize(params, tree.map(read, sliced, specs, plan), plan)


def _ctx(mesh, global_batch, batch: int):
    return None if mesh is None else dist_fid.ctx_for(mesh, global_batch if global_batch is not None else batch)


def _rows(t: torch.Tensor, ctx, mesh) -> torch.Tensor:
    """This rank's rows of a batch-leading tensor."""
    if ctx is None or not ctx.data_axes:
        return t
    return t[blocks.block_slices((ctx.data_axes,), (t.shape[0],), mesh)[0]]


def _whole(t: torch.Tensor, ctx, mesh) -> torch.Tensor:
    if ctx is None or not ctx.data_axes:
        return t
    return col.all_gather(t, mesh, ctx.data_axes, dim=0)


def make_prefill(cfg: LMConfig, mesh=None, global_batch: int | None = None):
    """``prefill(params, inputs [B, L]) -> (last logits [B, V], caches)``;
    on a mesh, the caches of this rank's rows."""
    def prefill(params, inputs: torch.Tensor):
        ctx = _ctx(mesh, global_batch, inputs.shape[0])
        with torch.no_grad(), dist_fid.use_sharded_fidelity(ctx):
            logits, caches = lm.prefill(cfg, params, _rows(inputs, ctx, mesh))
            return _whole(logits, ctx, mesh), caches

    return prefill


def make_decode_step(cfg: LMConfig, sample: bool = False, mesh=None, global_batch: int | None = None):
    """``decode_step(params, token, caches, pos, rng=None) -> (next token
    int32 [B], logits, caches)``: greedy, or with ``sample`` a draw from the
    softmax of the f32 logits under the host key ``rng``
    (``jax.random.categorical``'s Gumbel-max). On a mesh ``token`` and a
    vector ``pos`` are the whole batch's, ``caches`` this rank's rows."""
    def decode_step(params, token: torch.Tensor, caches, pos, rng=None):
        ctx = _ctx(mesh, global_batch, token.shape[0])
        with torch.no_grad(), dist_fid.use_sharded_fidelity(ctx):
            p = _rows(pos, ctx, mesh) if isinstance(pos, torch.Tensor) and pos.dim() else pos
            logits, caches = lm.decode_step(cfg, params, _rows(token, ctx, mesh), caches, p)
            logits = _whole(logits, ctx, mesh)
            if sample:
                nxt = prng.categorical(rng, logits)
            else:
                nxt = torch.argmax(logits, dim=-1)
        return nxt.to(torch.int32), logits, caches

    return decode_step
