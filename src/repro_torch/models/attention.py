"""Attention block (port of the dense GQA/MQA core of
``repro.models.attention``): RoPE, optional qk-norm, sandwich norm, logit
softcap, an explicit additive mask, and a K/V cache for decode, dense or
paged (a page pool per leaf read through a slot page table), at a scalar
position or at one position a slot; the chunked-prefill continuation
(``attn_cont``) processes a chunk of a prompt against a dense cache.

Not ported yet: sliding windows, MLA, and the chunked online-softmax path
(the reference takes it above ``CHUNK_THRESHOLD`` keys; here longer
sequences raise).
"""
from __future__ import annotations

import math

import torch

from .common import (
    LMConfig,
    ShapeDtype,
    apply_rope,
    dense_init,
    is_paged_cache,
    paged_gather,
    paged_scatter,
    rms_norm,
    rms_norm_init,
    seq_scatter,
    softcap,
    xbar_linear,
)
from .mlp import mlp_apply, mlp_init

CHUNK_THRESHOLD = 2048  # the reference switches to chunked attention above this


def causal_mask(s_q: int, s_k: int, device=None, q_offset: int = 0):
    """[s_q, s_k] additive causal mask; ``q_offset`` is the absolute
    position of query 0 (a prefill continuation's chunk start)."""
    qpos = torch.arange(s_q, device=device)[:, None] + q_offset
    kpos = torch.arange(s_k, device=device)[None, :]
    ok = kpos <= qpos
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, torch.full_like(zero, -1e30))


def attn_init(cfg: LMConfig, gen: torch.Generator, *, stack: tuple = (), device=None) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        # q/k/v live as ONE fused [d, (h + 2*kv) * hd] weight: one crossbar
        # read of the shared layer input serves all three
        "wqkv": dense_init(gen, d, (h + 2 * kv) * hd, stack=stack, device=device),
        "wo": dense_init(gen, h * hd, d, stack=stack, device=device),
        "ln": rms_norm_init(d, stack=stack, device=device),
    }
    if cfg.qk_norm:
        p["qn"] = rms_norm_init(hd, stack=stack, device=device)
        p["kn"] = rms_norm_init(hd, stack=stack, device=device)
    if cfg.post_norm:
        p["post_ln"] = rms_norm_init(d, stack=stack, device=device)
    return p


def _qkv(cfg: LMConfig, p, h_in: torch.Tensor, positions: torch.Tensor):
    B, S, _ = h_in.shape
    hN, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qkv = xbar_linear(h_in, p["wqkv"], h_in.dtype)
    q, k, v = torch.split(qkv, [hN * hd, kv * hd, kv * hd], dim=-1)
    q = q.reshape(B, S, hN, hd)
    k = k.reshape(B, S, kv, hd)
    v = v.reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(p["qn"], q, cfg.norm_eps)
        k = rms_norm(p["kn"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(cfg: LMConfig, q, k, v, mask):
    """q [B,Sq,H,hd]; k/v [B,Sk,KV,hd]; mask additive, [Sq,Sk] or per slot
    [B,1,1,1,Sk]. Query heads group as [B, Sq, KV, groups, hd]; logits and
    softmax in f32."""
    B, Sq, H, hd = q.shape
    kv = k.shape[2]
    groups = H // kv
    qg = q.reshape(B, Sq, kv, groups, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32), k.to(torch.float32))
    logits = logits / math.sqrt(hd)
    logits = softcap(logits, cfg.softcap_attn)
    logits = logits + mask
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def _no_window(cfg: LMConfig):
    if cfg.window is not None:
        raise NotImplementedError(f"sliding-window attention (window={cfg.window}) is not ported yet")


def _attend(cfg: LMConfig, q, k, v):
    _no_window(cfg)
    Sq, Sk = q.shape[1], k.shape[1]
    if Sk > CHUNK_THRESHOLD:
        raise NotImplementedError(
            f"attention over {Sk} > {CHUNK_THRESHOLD} keys needs the chunked path, not ported yet"
        )
    return _sdpa(cfg, q, k, v, causal_mask(Sq, Sk, device=q.device))


def attn_apply(cfg: LMConfig, p, h, positions, with_cache=False):
    """Full-sequence attention (prefill). Returns h (+ cache)."""
    x = rms_norm(p["ln"], h, cfg.norm_eps)
    q, k, v = _qkv(cfg, p, x, positions)
    o = _attend(cfg, q, k, v)
    o = xbar_linear(o.reshape(*o.shape[:2], -1), p["wo"], h.dtype)
    if cfg.post_norm:
        o = rms_norm(p["post_ln"], o, cfg.norm_eps)
    out = h + o
    if with_cache:
        return out, {"k": {"q": k}, "v": {"q": v}}
    return out


def _cache_store(x: torch.Tensor, dtype) -> dict:
    """K/V for the cache: int8 with a per-head-dim absmax scale, or a plain
    cast for float caches."""
    if dtype != torch.int8:
        return {"q": x.to(dtype)}
    x32 = x.to(torch.float32)
    amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return {"q": torch.round(x32 / scale).to(torch.int8), "s": scale}


def _cache_load(entry: dict, dtype) -> torch.Tensor:
    if "s" not in entry:
        return entry["q"].to(dtype)
    return (entry["q"].to(torch.float32) * entry["s"]).to(dtype)


def decode_posmask(pos, S: int, device=None) -> torch.Tensor:
    """Additive decode mask over ``S`` cached positions: ``[1, S]`` for a
    scalar ``pos``, ``[B, S]`` per slot for a vector ``pos [B]`` (a dead
    slot at the out-of-range sentinel sees every position, garbage only it
    consumes)."""
    kpos = torch.arange(S, device=device)
    if is_vector(pos):
        ok = kpos[None, :] <= pos[:, None]
    else:
        ok = (kpos <= pos)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, torch.full_like(zero, -1e30))


def is_vector(pos) -> bool:
    """Whether a decode ``pos`` is one position a slot (``[B]``)."""
    return isinstance(pos, torch.Tensor) and pos.dim() == 1


def _entry_write(entry: dict, new: dict, pos, table=None) -> dict:
    """Write a decoded token's stored K or V leaves (``_cache_store``) into
    a cache entry in place: a paged scatter when a page ``table`` rides
    along, a per-slot scatter for a vector ``pos``, a slice for a scalar
    one."""
    for leaf, val in new.items():
        if table is not None:
            paged_scatter(entry[leaf], table, val, pos)
        elif is_vector(pos):
            seq_scatter(entry[leaf], val, pos)
        else:
            entry[leaf][:, pos:pos + 1] = val
    return entry


def attn_decode(cfg: LMConfig, p, h, cache, pos):
    """One-token decode. h [B,1,d]; ``pos`` a scalar (an int) or one
    position a slot (``[B]``, on the device). ``cache`` is dense ``{k, v:
    {q: [B, Smax, KV, hd] (, s)}}`` or paged ``{table, k, v}``, each leaf a
    page pool ``[P + 1, page, KV, hd]`` read through ``table [B,
    max_pages]`` (``models.common.paged_gather``). The new K/V are written
    into the cache tensors in place (the reference returns updated copies;
    writing in place keeps one resident cache); a dead slot's write lands
    on the write-only page or is dropped, and its reads are masked."""
    _no_window(cfg)
    x = rms_norm(p["ln"], h, cfg.norm_eps)
    vec = is_vector(pos)
    if vec:
        positions = pos[:, None]
    else:
        pos = int(pos)
        positions = torch.arange(pos, pos + 1, device=h.device)  # made on the device: no host copy
    q, k_new, v_new = _qkv(cfg, p, x, positions)
    cdtype = cache["k"]["q"].dtype
    table = cache["table"] if is_paged_cache(cache) else None
    wpos = pos if (table is None or vec) else torch.full((h.shape[0],), pos, device=h.device)
    _entry_write(cache["k"], _cache_store(k_new, cdtype), wpos, table)
    _entry_write(cache["v"], _cache_store(v_new, cdtype), wpos, table)
    if table is not None:
        kd = {leaf: paged_gather(c, table) for leaf, c in cache["k"].items()}
        vd = {leaf: paged_gather(c, table) for leaf, c in cache["v"].items()}
    else:
        kd, vd = cache["k"], cache["v"]
    mask = decode_posmask(pos, kd["q"].shape[1], device=h.device)
    if vec:
        mask = mask[:, None, None, None, :]  # [B,S] -> broadcast vs [B,kv,g,q,s]
    o = _sdpa(cfg, q, _cache_load(kd, q.dtype), _cache_load(vd, q.dtype), mask)
    o = xbar_linear(o.reshape(*o.shape[:2], -1), p["wo"], h.dtype)
    if cfg.post_norm:
        o = rms_norm(p["post_ln"], o, cfg.norm_eps)
    return h + o, cache


def attn_cache_spec(cfg: LMConfig, batch: int, max_seq: int, dtype) -> dict:
    hd, kv = cfg.head_dim, cfg.n_kv_heads
    shape = (batch, max_seq, kv, hd)
    entry = {"q": ShapeDtype(shape, dtype)}
    if dtype == torch.int8:
        entry["s"] = ShapeDtype((batch, max_seq, kv, 1), torch.float32)
    return {"k": dict(entry), "v": dict(entry)}


# --------------------------- standard block: attn + MLP ---------------------


def block_init(cfg: LMConfig, gen: torch.Generator, *,
               stack: tuple = (), device=None) -> dict:
    return {
        "attn": attn_init(cfg, gen, stack=stack, device=device),
        "mlp": mlp_init(cfg, gen, cfg.d_ff, stack=stack, device=device),
    }


def block_apply(cfg: LMConfig, p, h, positions):
    """Training forward of one layer (no cache)."""
    h = attn_apply(cfg, p["attn"], h, positions)
    return mlp_apply(cfg, p["mlp"], h)


def block_prefill(cfg: LMConfig, p, h, positions):
    h, cache = attn_apply(cfg, p["attn"], h, positions, with_cache=True)
    return mlp_apply(cfg, p["mlp"], h), cache


def block_decode(cfg: LMConfig, p, h, cache, pos):
    h, cache = attn_decode(cfg, p["attn"], h, cache, pos)
    return mlp_apply(cfg, p["mlp"], h), cache


# ------------------------ chunked-prefill continuation -----------------------
# A chunk of C prompt tokens at absolute positions ``start .. start+C``
# against a dense cache that already holds the first ``start`` positions
# (zeros beyond, masked). The serving engine prefills long prompts a chunk
# at a time this way, so decode slots never wait more than one chunk.


def attn_cont(cfg: LMConfig, p, h, cache, positions, start: int):
    """Prefill continuation of the GQA core. h [B,C,d]; ``positions`` [C]
    absolute; ``start`` the chunk's first position; ``cache`` dense [B,
    Stot, ...], written in place."""
    _no_window(cfg)
    x = rms_norm(p["ln"], h, cfg.norm_eps)
    q, k_new, v_new = _qkv(cfg, p, x, positions)
    cdtype = cache["k"]["q"].dtype
    C = q.shape[1]
    for name, new in (("k", k_new), ("v", v_new)):
        for leaf, val in _cache_store(new, cdtype).items():
            cache[name][leaf][:, start:start + C] = val
    mask = causal_mask(C, cache["k"]["q"].shape[1], device=h.device, q_offset=start)
    o = _sdpa(cfg, q, _cache_load(cache["k"], q.dtype), _cache_load(cache["v"], q.dtype), mask)
    o = xbar_linear(o.reshape(*o.shape[:2], -1), p["wo"], h.dtype)
    if cfg.post_norm:
        o = rms_norm(p["post_ln"], o, cfg.norm_eps)
    return h + o, cache


def block_cont(cfg: LMConfig, p, h, cache, positions, start: int):
    h, cache = attn_cont(cfg, p["attn"], h, cache, positions, start)
    return mlp_apply(cfg, p["mlp"], h), cache
