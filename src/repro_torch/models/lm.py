"""Transformer LM orchestrator (port of ``repro.models.lm``): pattern-driven
block groups, the training forward and its loss, prefill with caches (and its
chunked continuation), and single-token decode at a scalar position or one
position a slot.

A config's ``pattern`` is an ordered tuple of ``(block_name, count)``
groups; a counted group keeps its params stacked on a leading ``[count,
...]`` axis and runs as a Python loop over layers (the reference's
``lax.scan``). The blocks: ``"dense"`` (attention + gated MLP),
``"local"`` (the same under the sliding window, decoding on a ring buffer),
``"gemma2_pair"`` (a local layer then a global one, caches ``{"local",
"global"}``), ``"moe"`` (attention + the capacity-bounded MoE layer),
``"mla_dense"`` and ``"mla_moe"`` (MLA, then a gated MLP of width
``dense_ff_prefix`` or the MoE layer), the SSM blocks ``"mamba2"``,
``"mlstm"`` and ``"slstm"``, and ``"zamba_unit"`` (N mamba2 layers, then
one call of the zamba shared attention + MLP block, whose params live at the
top level, ``params["shared"]``, over ``concat(h, x0)``). A block's training
``apply`` returns ``(h, aux)``, ``aux`` its MoE load-balance term (zero for
the others); ``hidden`` sums it over the layers and ``loss_fn`` adds
``aux_weight`` times it.

Remat (``hidden(remat=...)``, the reference's ``_remat_wrap``): ``"full"``
runs each layer under ``torch.utils.checkpoint`` (non-reentrant), so the
backward recomputes the layer's forward from its input and keeps nothing
else; ``"dots"`` saves the matmuls with no batch dims (``aten.mm`` /
``addmm``, the counterpart of ``dots_with_no_batch_dims_saveable``) and
recomputes the rest (batched products, the attention, the crossbar reads);
``"none"`` keeps every activation. A layer's params are picked inside the
checkpointed body, so on a mesh a dense weight's per-layer all-gather
(``LayerStack``) is freed after the layer and gathered again in the
backward. The loss head runs chunk by chunk under checkpoint whatever the
mode (``loss_parts``). No mode changes a number: the operand slots are
filled in the backward, which runs once, and no forward draws from torch's
generators (read noise is a pure function of the coordinates).

Caches are written in place at decode (and by a prefill continuation): the
K/V rows of the attention blocks, MLA's ``c_kv``/``k_rope`` rows, and the
state leaves of the SSM blocks (no sequence axis: one row a sequence),
which the blocks overwrite with their new state. Prefill returns every
sequence-axis cache at the prompt's length (``prefill_cache_specs``); a
windowed layer's ``cache_spec`` asks for at most ``window`` positions, a
ring its decode wraps around.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple

import torch

from repro_torch import tree
from repro_torch.device import resolve
from . import attention as att
from . import mamba2 as m2
from . import xlstm as xl
from .common import (
    LayerStack,
    LMConfig,
    ShapeDtype,
    XbarWeight,
    apply_rope,
    dense_init,
    embed_init,
    gelu,
    is_paged_cache,
    rms_norm,
    rms_norm_init,
    softcap,
)
from .mlp import mlp_apply, mlp_init, moe_apply, moe_init


class BlockDef(NamedTuple):
    init: Callable  # (cfg, gen, *, stack, device) -> params
    apply: Callable  # (cfg, params, h, ctx) -> (h, aux) (training forward)
    prefill: Callable  # (cfg, params, h, ctx) -> (h, cache)
    decode: Callable  # (cfg, params, h, cache, ctx) -> (h, cache)
    cache_spec: Callable  # (cfg, B, S, dtype) -> tree of ShapeDtype
    # chunked-prefill continuation: (cfg, params, h, cache, ctx) -> (h,
    # cache), ctx["positions"] absolute, against a dense cache holding the
    # positions below ctx["start"]. None: single-shot prefill only.
    cont: Callable | None = None


def _dense_init(cfg, gen, *, stack=(), device=None):
    return att.block_init(cfg, gen, stack=stack, device=device)


def _no_aux(h):
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def _dense_apply(cfg, p, h, ctx):
    return _no_aux(att.block_apply(cfg, p, h, ctx["positions"]))


def _dense_prefill(cfg, p, h, ctx):
    return att.block_prefill(cfg, p, h, ctx["positions"])


def _dense_decode(cfg, p, h, cache, ctx):
    return att.block_decode(cfg, p, h, cache, ctx["pos"])


def _dense_cont(cfg, p, h, cache, ctx):
    return att.block_cont(cfg, p, h, cache, ctx["positions"], ctx["start"])


# ------------------------ sliding window: local blocks ----------------------
# A local layer attends to the last ``cfg.window`` positions. Its decode
# stores position ``pos`` at ring slot ``pos % W``, W the cache's length
# (``table.shape[1] · page`` on pages), and masks by the window: the slot's
# stored position ``pos - ((pos - slot) mod W)`` must be in ``(pos - window,
# pos]``. A cache of ``window`` positions wraps; a longer one (prefill's,
# grown) holds every position and the window alone masks.


def _local_apply(cfg, p, h, ctx):
    return _no_aux(att.block_apply(cfg, p, h, ctx["positions"], cfg.window))


def _local_prefill(cfg, p, h, ctx):
    return att.block_prefill(cfg, p, h, ctx["positions"], cfg.window)


def _local_cont(cfg, p, h, cache, ctx):
    return att.block_cont(cfg, p, h, cache, ctx["positions"], ctx["start"], cfg.window)


def _local_cache_spec(cfg, b, s, dt):
    return att.attn_cache_spec(cfg, b, min(s, cfg.window) if cfg.window else s, dt)


def ring_mask(pos, W: int, window: int, device=None) -> torch.Tensor:
    """Additive mask over a ring of ``W`` slots holding positions ``<= pos``
    at ``position % W``: ``[1, W]`` for a scalar ``pos``, ``[B, 1, 1, 1,
    W]`` for one a slot. Python's and ``torch.remainder``'s modulo (never
    negative), as the reference's."""
    slot = torch.arange(W, device=device)[None, :]
    posb = pos[:, None] if att.is_vector(pos) else pos
    age = posb - torch.remainder(posb - slot, W)  # the position stored in each slot
    mask = att._additive((age >= 0) & (age > posb - window))
    return mask[:, None, None, None, :] if att.is_vector(pos) else mask


def _local_decode(cfg, p, h, cache, ctx):
    pa = p["attn"]
    x = rms_norm(pa["ln"], h, cfg.norm_eps)
    pos, positions = att.decode_positions(ctx["pos"], h.device)
    q, k_new, v_new = att._qkv(cfg, pa, x, positions)
    page = cache["k"]["q"].shape[1]
    W = cache["table"].shape[1] * page if is_paged_cache(cache) else page
    kd, vd = att.kv_write_read(cache, k_new, v_new, pos % W)
    mask = ring_mask(pos, W, cfg.window, device=h.device)
    o = att._sdpa(cfg, q, att._cache_load(kd, q.dtype), att._cache_load(vd, q.dtype), mask)
    return mlp_apply(cfg, p["mlp"], att._out(cfg, pa, h, o)), cache


# ------------------------------ gemma2 pair ---------------------------------
# A local (windowed) layer then a global one, their params and caches under
# "local" and "global".


def _pair_init(cfg, gen, *, stack=(), device=None):
    return {"local": att.block_init(cfg, gen, stack=stack, device=device),
            "global": att.block_init(cfg, gen, stack=stack, device=device)}


def _pair_apply(cfg, p, h, ctx):
    h = att.block_apply(cfg, p["local"], h, ctx["positions"], cfg.window)
    return _no_aux(att.block_apply(cfg, p["global"], h, ctx["positions"]))


def _pair_prefill(cfg, p, h, ctx):
    h, c1 = att.block_prefill(cfg, p["local"], h, ctx["positions"], cfg.window)
    h, c2 = att.block_prefill(cfg, p["global"], h, ctx["positions"])
    return h, {"local": c1, "global": c2}


def _pair_decode(cfg, p, h, cache, ctx):
    h, _ = _local_decode(cfg, p["local"], h, cache["local"], ctx)
    h, _ = att.block_decode(cfg, p["global"], h, cache["global"], ctx["pos"])
    return h, cache


def _pair_cache_spec(cfg, b, s, dt):
    return {"local": _local_cache_spec(cfg, b, s, dt), "global": att.attn_cache_spec(cfg, b, s, dt)}


def _pair_cont(cfg, p, h, cache, ctx):
    h, _ = _local_cont(cfg, p["local"], h, cache["local"], ctx)
    h, _ = att.block_cont(cfg, p["global"], h, cache["global"], ctx["positions"], ctx["start"])
    return h, cache


# ------------------------------ MoE block -----------------------------------
# The attention half is the dense block's, so it caches, pages and chunks
# like "dense"; the MLP half is ``mlp.moe_apply``.


def _moe_init(cfg, gen, *, stack=(), device=None):
    return {"attn": att.attn_init(cfg, gen, stack=stack, device=device),
            "moe": moe_init(cfg, gen, stack=stack, device=device)}


def _moe_apply(cfg, p, h, ctx):
    h = att.attn_apply(cfg, p["attn"], h, ctx["positions"])
    # one router read a step: the aux loss shares moe_apply's logits
    return moe_apply(cfg, p["moe"], h, with_aux=True)


def _moe_prefill(cfg, p, h, ctx):
    h, cache = att.attn_apply(cfg, p["attn"], h, ctx["positions"], with_cache=True)
    return moe_apply(cfg, p["moe"], h), cache


def _moe_decode(cfg, p, h, cache, ctx):
    h, cache = att.attn_decode(cfg, p["attn"], h, cache, ctx["pos"])
    return moe_apply(cfg, p["moe"], h), cache


def _moe_cont(cfg, p, h, cache, ctx):
    h, cache = att.attn_cont(cfg, p["attn"], h, cache, ctx["positions"], ctx["start"])
    return moe_apply(cfg, p["moe"], h), cache


# ------------------------------ MLA blocks ----------------------------------
# MLA attention, then a gated MLP (layer 0 of deepseek: width
# ``dense_ff_prefix``) or the MoE layer with its shared experts.


def _mla_dense_init(cfg, gen, *, stack=(), device=None):
    return {"attn": att.mla_init(cfg, gen, stack=stack, device=device),
            "mlp": mlp_init(cfg, gen, cfg.dense_ff_prefix or cfg.d_ff, stack=stack, device=device)}


def _mla_moe_init(cfg, gen, *, stack=(), device=None):
    return {"attn": att.mla_init(cfg, gen, stack=stack, device=device),
            "moe": moe_init(cfg, gen, stack=stack, device=device)}


def _mla_block(init, ffn, with_aux: bool) -> BlockDef:
    """The MLA block whose second half is ``ffn(cfg, p, h)`` (the gated MLP
    under "mlp" or the MoE layer under "moe"). The MoE's training apply
    returns its aux term from the same router read."""
    def apply(cfg, p, h, ctx):
        h = att.mla_apply(cfg, p["attn"], h, ctx["positions"])
        return ffn(cfg, p, h, with_aux=True) if with_aux else _no_aux(ffn(cfg, p, h))

    def prefill(cfg, p, h, ctx):
        h, cache = att.mla_apply(cfg, p["attn"], h, ctx["positions"], with_cache=True)
        return ffn(cfg, p, h), cache

    def decode(cfg, p, h, cache, ctx):
        h, cache = att.mla_decode(cfg, p["attn"], h, cache, ctx["pos"])
        return ffn(cfg, p, h), cache

    def cont(cfg, p, h, cache, ctx):
        h, cache = att.mla_cont(cfg, p["attn"], h, cache, ctx["positions"], ctx["start"])
        return ffn(cfg, p, h), cache

    return BlockDef(init, apply, prefill, decode, att.mla_cache_spec, cont)


def _mla_mlp(cfg, p, h):
    return mlp_apply(cfg, p["mlp"], h)


def _mla_moe(cfg, p, h, with_aux=False):
    return moe_apply(cfg, p["moe"], h, with_aux=with_aux)


# ------------------------------ SSM blocks ----------------------------------
# Their caches are state leaves: decode and the continuation overwrite them
# in place with the block's new state.


def _write_state(cache: dict, new: dict) -> dict:
    for k, v in new.items():
        cache[k].copy_(v)
    return cache


def _mamba_cont(cfg, p, h, cache, ctx):
    h, st = m2.mamba2_apply(cfg, p, h, with_state=True, state=cache)
    return h, _write_state(cache, st)


def _in_place(decode):
    """A block's decode that overwrites the cache with its new state."""
    def run(cfg, p, h, cache, ctx):
        h, st = decode(cfg, p, h, cache, ctx["pos"])
        return h, _write_state(cache, st)

    return run


# ------------------------------ zamba2 unit ---------------------------------
# N mamba2 layers (stacked ``[N, ...]`` inside the unit; a group of units is
# ``[units, N, ...]``), then one call of the *shared* attention + MLP block,
# whose params live at the top level (``ctx["shared"]``), over concat(h, x0),
# x0 the embedded input. The shared block's matrices are read through plain
# matmuls, once a unit: dense-gradient leaves.


def _zamba_unit_init(cfg, gen, *, stack=(), device=None):
    return {"mamba": m2.mamba2_init(cfg, gen, stack=(*stack, cfg.zamba.share_every), device=device)}


def zamba_shared_init(cfg: LMConfig, gen: torch.Generator, device=None) -> dict:
    """The shared transformer block: attention + MLP over concat(h, x0)."""
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "ln": rms_norm_init(2 * d, device=device),
        "wq": dense_init(gen, 2 * d, H * hd, device=device),
        "wk": dense_init(gen, 2 * d, cfg.n_kv_heads * hd, device=device),
        "wv": dense_init(gen, 2 * d, cfg.n_kv_heads * hd, device=device),
        "wo": dense_init(gen, H * hd, d, device=device),
        "mlp_ln": rms_norm_init(2 * d, device=device),
        "mlp_up": dense_init(gen, 2 * d, cfg.d_ff, device=device),
        "mlp_down": dense_init(gen, cfg.d_ff, d, device=device),
    }


def _zamba_shared_apply(cfg, sp, h, x0, positions=None, cache=None, pos=None):
    """The shared block over the whole sequence (``positions``, returning
    its K/V as the cache) or one decode token at ``pos`` (a scalar or one
    position a slot) against ``cache``, dense or paged, written in place."""
    B = h.shape[0]
    H, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = rms_norm(sp["ln"], torch.cat([h, x0], dim=-1), cfg.norm_eps)
    S = x.shape[1]
    q = (x @ sp["wq"].to(x.dtype)).reshape(B, S, H, hd)
    k = (x @ sp["wk"].to(x.dtype)).reshape(B, S, kv, hd)
    v = (x @ sp["wv"].to(x.dtype)).reshape(B, S, kv, hd)
    if cache is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        mask = att.causal_mask(S, S, device=h.device)
        new_cache = {"k": {"q": k}, "v": {"q": v}}
    else:
        pos, rpos = att.decode_positions(pos, h.device)
        q = apply_rope(q, rpos, cfg.rope_theta)
        k = apply_rope(k, rpos, cfg.rope_theta)
        kd, vd = att.kv_write_read(cache, k, v, pos)
        mask = att.decode_posmask(pos, kd["q"].shape[1], device=h.device)
        if att.is_vector(pos):
            mask = mask[:, None, None, None, :]
        k, v = att._cache_load(kd, q.dtype), att._cache_load(vd, q.dtype)
        new_cache = cache
    o = att._sdpa(cfg, q, k, v, mask)
    h = h + o.reshape(B, -1, H * hd) @ sp["wo"].to(h.dtype)
    xm = rms_norm(sp["mlp_ln"], torch.cat([h, x0], dim=-1), cfg.norm_eps)
    h = h + gelu(xm @ sp["mlp_up"].to(h.dtype)) @ sp["mlp_down"].to(h.dtype)
    return h, new_cache


def _zamba_unit_apply(cfg, p, h, ctx):
    for j in range(cfg.zamba.share_every):
        h = m2.mamba2_apply(cfg, layer(p["mamba"], j), h)
    h, _ = _zamba_shared_apply(cfg, ctx["shared"], h, ctx["x0"], ctx["positions"])
    return _no_aux(h)


def _zamba_unit_prefill(cfg, p, h, ctx):
    states = []
    for j in range(cfg.zamba.share_every):
        h, st = m2.mamba2_apply(cfg, layer(p["mamba"], j), h, with_state=True)
        states.append(st)
    h, scache = _zamba_shared_apply(cfg, ctx["shared"], h, ctx["x0"], ctx["positions"])
    return h, {"mamba": tree.map(lambda *xs: torch.stack(xs), *states), "shared": scache}


def _zamba_unit_decode(cfg, p, h, cache, ctx):
    for j in range(cfg.zamba.share_every):
        cj = tree.map(lambda x: x[j], cache["mamba"])  # views: written in place
        h, st = m2.mamba2_decode(cfg, layer(p["mamba"], j), h, cj, ctx["pos"])
        _write_state(cj, st)
    h, _ = _zamba_shared_apply(cfg, ctx["shared"], h, ctx["x0"], cache=cache["shared"], pos=ctx["pos"])
    return h, cache


def _zamba_unit_cache_spec(cfg, b, s, dt):
    n = cfg.zamba.share_every
    mspec = tree.map(lambda x: ShapeDtype((n, *x.shape), x.dtype), m2.mamba2_cache_spec(cfg, b, s, dt))
    return {"mamba": mspec, "shared": att.attn_cache_spec(cfg, b, s, dt)}


BLOCKS: dict[str, BlockDef] = {
    "dense": BlockDef(_dense_init, _dense_apply, _dense_prefill, _dense_decode, att.attn_cache_spec,
                      _dense_cont),
    "local": BlockDef(_dense_init, _local_apply, _local_prefill, _local_decode, _local_cache_spec, _local_cont),
    "gemma2_pair": BlockDef(_pair_init, _pair_apply, _pair_prefill, _pair_decode, _pair_cache_spec, _pair_cont),
    "moe": BlockDef(_moe_init, _moe_apply, _moe_prefill, _moe_decode, att.attn_cache_spec, _moe_cont),
    "mla_dense": _mla_block(_mla_dense_init, _mla_mlp, False),
    "mla_moe": _mla_block(_mla_moe_init, _mla_moe, True),
    "mamba2": BlockDef(m2.mamba2_init, lambda cfg, p, h, ctx: _no_aux(m2.mamba2_apply(cfg, p, h)),
                       lambda cfg, p, h, ctx: m2.mamba2_apply(cfg, p, h, with_state=True),
                       _in_place(m2.mamba2_decode),
                       m2.mamba2_cache_spec, _mamba_cont),
    "mlstm": BlockDef(xl.mlstm_init, lambda cfg, p, h, ctx: _no_aux(xl.mlstm_apply(cfg, p, h)),
                      lambda cfg, p, h, ctx: xl.mlstm_apply(cfg, p, h, with_state=True),
                      _in_place(xl.mlstm_decode),
                      xl.mlstm_cache_spec),
    "slstm": BlockDef(xl.slstm_init, lambda cfg, p, h, ctx: _no_aux(xl.slstm_apply(cfg, p, h)),
                      lambda cfg, p, h, ctx: xl.slstm_apply(cfg, p, h, with_state=True),
                      _in_place(xl.slstm_decode),
                      xl.slstm_cache_spec),
    "zamba_unit": BlockDef(_zamba_unit_init, _zamba_unit_apply, _zamba_unit_prefill, _zamba_unit_decode,
                           _zamba_unit_cache_spec),
}


def layer(group, i: int):
    """Layer ``i``'s params out of a stacked group (views, no copies)."""
    def pick(x):
        return x[i] if isinstance(x, (torch.Tensor, XbarWeight, LayerStack)) else x

    return tree.map(pick, group)


# =============================== model API ==================================


def init_params(cfg: LMConfig, gen, device=None) -> dict:
    """Random f32 params from a seed (int) or a ``torch.Generator`` on the
    target device (``cuda`` unless ``device`` says otherwise)."""
    dev = resolve(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    params: dict = {"final_ln": rms_norm_init(cfg.d_model, device=dev)}
    if cfg.input_mode == "tokens":
        params["embed"] = embed_init(gen, cfg.vocab, cfg.d_model, device=dev)
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, device=dev)
    else:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, device=dev)
    params["groups"] = [
        BLOCKS[name].init(cfg, gen, stack=() if count == 1 else (count,), device=dev)
        for name, count in cfg.pattern
    ]
    if cfg.zamba is not None:
        params["shared"] = zamba_shared_init(cfg, gen, device=dev)
    return params


def param_shapes(cfg: LMConfig) -> dict:
    """The param tree of ``init_params`` as ``ShapeDtype`` leaves, nothing
    allocated (the reference's ``jax.eval_shape`` of its init): what a plan
    resolves against before the state exists."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = init_params(cfg, 0, device="cpu")
    return tree.map(lambda p: ShapeDtype(tuple(p.shape), p.dtype), params)


def _table(cfg: LMConfig, params):
    """The embedding cast once to the activation dtype (None without one).
    A step reads it for both the gather and the tied head, as the reference
    does, so in training their gradients sum in that dtype."""
    if cfg.input_mode == "tokens" and "embed" in params:
        return params["embed"].to(cfg.dtype)
    return None


def _embed_in(cfg: LMConfig, params, tokens_or_embeds: torch.Tensor, table=None) -> torch.Tensor:
    """Embed tokens from ``table`` (``_table``, cast here when not given)."""
    if cfg.input_mode == "tokens":
        h = (table if table is not None else _table(cfg, params))[tokens_or_embeds]
    else:
        h = tokens_or_embeds.to(cfg.dtype)
    if cfg.embed_scale:
        # sqrt(d) rounds to the activation dtype first (45.25 in bf16 at d=2048)
        h = h * torch.tensor(math.sqrt(float(cfg.d_model)), dtype=torch.float32).to(cfg.dtype)
    return h


def _head_out(cfg: LMConfig, params, h: torch.Tensor, table=None) -> torch.Tensor:
    h = rms_norm(params["final_ln"], h, cfg.norm_eps)
    if cfg.tie_embeddings and cfg.input_mode == "tokens":
        logits = h @ (table if table is not None else _table(cfg, params)).T
    else:
        logits = h @ params["lm_head"].to(h.dtype)
    return softcap(logits, cfg.softcap_final)


REMAT_MODES = ("full", "dots", "none")


def remat_mode(remat) -> str:
    """``"full"``, ``"dots"`` or ``"none"``; ``True`` / ``False`` are
    aliases of ``"full"`` / ``"none"``, as in the reference's
    ``make_train_step``."""
    mode = {True: "full", False: "none"}.get(remat, remat) if isinstance(remat, bool) else remat
    if mode not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES} (or a bool), got {remat!r}")
    return mode


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn, remat="full"):
    """``fn`` run under the ``remat`` mode's checkpoint (the module
    docstring); ``"none"`` returns ``fn``."""
    mode = remat_mode(remat)
    if mode == "none":
        return fn
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {"use_reentrant": False, "preserve_rng_state": False}
    if mode == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    return lambda *args: checkpoint(fn, *args, **kw)


def _layer_apply(cfg: LMConfig, block: BlockDef, ctx: dict, gparams, i, h: torch.Tensor):
    """One layer's training forward: layer ``i`` of a stacked group (None:
    the group's one layer) picked here, inside whatever checkpoint wraps
    this body."""
    return block.apply(cfg, gparams if i is None else layer(gparams, i), h, ctx)


def hidden(cfg: LMConfig, params, inputs: torch.Tensor, table=None, remat="none"):
    """Backbone training forward without the LM head: ``(h [B, S, d],
    aux)``, ``aux`` the f32 sum of the blocks' load-balance terms in layer
    order. ``remat``: each layer's checkpoint mode (module docstring)."""
    h = _embed_in(cfg, params, inputs, table)
    ctx = {"positions": torch.arange(h.shape[1], device=h.device), "x0": h, "shared": params.get("shared")}
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for (name, count), gparams in zip(cfg.pattern, params["groups"]):
        body = remat_wrap(functools.partial(_layer_apply, cfg, BLOCKS[name], ctx), remat)
        for i in range(count):
            h, aux = body(gparams, i if count > 1 else None, h)
            aux_total = aux_total + aux
    return h, aux_total


def forward(cfg: LMConfig, params, inputs: torch.Tensor):
    """Training forward: ``(logits [B, S, V], aux)``."""
    table = _table(cfg, params)
    h, aux = hidden(cfg, params, inputs, table)
    return _head_out(cfg, params, h, table), aux


def _nll_of_chunk(cfg: LMConfig, params, h_c, labels_c, table=None) -> torch.Tensor:
    """Head and stable cross entropy of one token chunk. The label's
    shifted logit is taken in bf16 (the reference's bf16 one-hot einsum),
    so it is rounded to bf16 whatever the activation dtype."""
    logits = _head_out(cfg, params, h_c, table).to(torch.float32)
    shifted = logits - logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    ll = shifted.to(torch.bfloat16).gather(-1, labels_c.long()[..., None])[..., 0].to(torch.float32)
    return lse - ll


LOSS_CHUNK = 1024


def _nll_sum_of_chunk(cfg: LMConfig, params, table, h_c, labels_c) -> torch.Tensor:
    return _nll_of_chunk(cfg, params, h_c, labels_c, table).sum()


def loss_parts(cfg: LMConfig, params, batch, remat="none"):
    """``(nll, aux)``: the mean next-token cross entropy and the summed MoE
    load-balance term. batch: {inputs, labels, mask?}. Above ``LOSS_CHUNK``
    tokens a sequence is summed chunk by chunk, in the reference's order,
    each chunk's head and softmax under checkpoint (its f32 logits live one
    chunk at a time, forward and backward, as in the reference's scan
    body). ``remat``: the layers' checkpoint mode (``hidden``)."""
    table = _table(cfg, params)
    h, aux = hidden(cfg, params, batch["inputs"], table, remat=remat)
    labels = batch["labels"]
    mask = batch.get("mask")
    B, S, _ = h.shape
    C = min(LOSS_CHUNK, S)
    if mask is not None:
        nll = _nll_of_chunk(cfg, params, h, labels, table) * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0), aux
    if S % C == 0 and S > C:
        chunk = remat_wrap(functools.partial(_nll_sum_of_chunk, cfg, params, table), "full")
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for q in range(S // C):
            sl = slice(q * C, (q + 1) * C)
            total = total + chunk(h[:, sl], labels[:, sl])
        return total / float(B * S), aux
    return _nll_of_chunk(cfg, params, h, labels, table).sum() / float(B * S), aux


AUX_WEIGHT = 0.01  # the MoE load-balance term's weight in the loss


def loss_fn(cfg: LMConfig, params, batch, aux_weight: float = AUX_WEIGHT, remat="none") -> torch.Tensor:
    """Next-token cross entropy plus ``aux_weight`` times the MoE
    load-balance term (``loss_parts``)."""
    nll, aux = loss_parts(cfg, params, batch, remat=remat)
    return nll + aux_weight * aux


def prefill_cache_specs(cfg: LMConfig, batch: int, seq: int, dtype=None):
    """The stacked cache specs of ``prefill`` on ``seq`` tokens (and of the
    zeros a chunked continuation fills): every sequence axis at ``seq``,
    windowed layers' too (``cache_specs`` caps those at the window)."""
    return cache_specs(dataclasses.replace(cfg, window=None), batch, seq, dtype)


def cache_specs(cfg: LMConfig, batch: int, max_seq: int, dtype=None, layout: str = "stacked"):
    """Cache specs. ``layout="stacked"``: ``[count, ...]`` per counted group,
    the layout prefill returns; ``"list"``: one tree a layer, the decode
    layout."""
    dtype = dtype or cfg.dtype
    specs = []
    for name, count in cfg.pattern:
        spec = BLOCKS[name].cache_spec(cfg, batch, max_seq, dtype)
        if count > 1:
            if layout == "stacked":
                spec = tree.map(lambda s: ShapeDtype((count, *s.shape), s.dtype), spec)
            else:
                spec = [spec for _ in range(count)]
        specs.append(spec)
    return specs


def unstack_caches(cfg: LMConfig, caches):
    """Prefill's stacked group caches -> the decode list layout (views)."""
    out = []
    for (name, count), cache in zip(cfg.pattern, caches):
        out.append(cache if count == 1 else [tree.map(lambda x: x[i], cache) for i in range(count)])
    return out


def init_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=None, device=None):
    dev = resolve(device)
    return tree.map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                    cache_specs(cfg, batch, max_seq, dtype))


def prefill(cfg: LMConfig, params, inputs: torch.Tensor, caches=None, start: int = 0):
    """Full-sequence prefill. Returns (last-position logits [B, V], caches in
    the stacked layout).

    Chunked continuation: pass ``caches`` (the stacked layout, from a
    previous call or zeros at the full prompt length) and ``start``, the
    absolute position of ``inputs[:, 0]``; each block's ``cont`` processes
    the chunk against the cache, which is written in place and returned.
    Every block of the pattern needs a ``cont`` (``supports_chunked_prefill``)."""
    table = _table(cfg, params)
    h = _embed_in(cfg, params, inputs, table)
    start = int(start)
    ctx = {"positions": torch.arange(start, start + h.shape[1], device=h.device), "start": start, "x0": h,
           "shared": params.get("shared")}
    out_caches = []
    for gi, ((name, count), gparams) in enumerate(zip(cfg.pattern, params["groups"])):
        block = BLOCKS[name]
        if caches is not None:
            if block.cont is None:
                raise NotImplementedError(f"block {name!r} does not support chunked prefill (no cont)")
            cache = caches[gi]
            if count == 1:
                h, cache = block.cont(cfg, gparams, h, cache, ctx)
            else:
                for i in range(count):  # each layer writes its view of the stacked cache
                    h, _ = block.cont(cfg, layer(gparams, i), h, tree.map(lambda x: x[i], cache), ctx)
        elif count == 1:
            h, cache = block.prefill(cfg, gparams, h, ctx)
        else:
            per_layer = []
            for i in range(count):
                h, c = block.prefill(cfg, layer(gparams, i), h, ctx)
                per_layer.append(c)
            cache = tree.map(lambda *xs: torch.stack(xs), *per_layer)
        out_caches.append(cache)
    # head on the last position only: decode continues from there
    return _head_out(cfg, params, h[:, -1:], table)[:, 0], out_caches


def supports_chunked_prefill(cfg: LMConfig) -> bool:
    """Whether every block of ``cfg.pattern`` has a prefill continuation
    (``BlockDef.cont``); the serving engine prefills single-shot otherwise."""
    return all(BLOCKS[name].cont is not None for name, _ in cfg.pattern)


def decode_step(cfg: LMConfig, params, token: torch.Tensor, caches, pos):
    """One decode step. token [B] ids; caches in the list layout, dense or
    paged (``serve.kv_pages.with_tables``); ``pos`` the scalar position of
    ``token`` (an int) or one position a slot (``[B]`` on the device).
    Returns (logits [B, V], caches), the caches updated in place."""
    inp = token[:, None] if cfg.input_mode == "tokens" else token
    table = _table(cfg, params)
    h = _embed_in(cfg, params, inp, table)
    ctx = {"pos": pos if att.is_vector(pos) else int(pos), "x0": h, "shared": params.get("shared")}
    new_caches = []
    for (name, count), gparams, cache in zip(cfg.pattern, params["groups"], caches):
        block = BLOCKS[name]
        if count == 1:
            h, c = block.decode(cfg, gparams, h, cache, ctx)
        else:
            c = []
            for i in range(count):
                h, c_new = block.decode(cfg, layer(gparams, i), h, cache[i], ctx)
                c.append(c_new)
        new_caches.append(c)
    return _head_out(cfg, params, h, table)[:, -1], new_caches
