"""Attention block (port of the dense GQA/MQA core of
``repro.models.attention``): RoPE, optional qk-norm, sandwich norm, logit
softcap, an explicit additive mask, and a dense K/V cache for decode.

Not ported yet: sliding windows, MLA, the chunked online-softmax path (the
reference takes it above ``CHUNK_THRESHOLD`` keys; here longer sequences
raise), chunked-prefill continuation, paged caches and per-slot vector
positions.
"""
from __future__ import annotations

import math

import torch

from .common import (
    LMConfig,
    ShapeDtype,
    apply_rope,
    dense_init,
    rms_norm,
    rms_norm_init,
    softcap,
    xbar_linear,
)
from .mlp import mlp_apply, mlp_init

CHUNK_THRESHOLD = 2048  # the reference switches to chunked attention above this


def causal_mask(s_q: int, s_k: int, device=None):
    """[s_q, s_k] additive causal mask."""
    qpos = torch.arange(s_q, device=device)[:, None]
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
    """q [B,Sq,H,hd]; k/v [B,Sk,KV,hd]; mask [Sq,Sk] additive. Query heads
    group as [B, Sq, KV, groups, hd]; logits and softmax in f32."""
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


def decode_posmask(pos: int, S: int, device=None) -> torch.Tensor:
    """Additive ``[1, S]`` decode mask over ``S`` cached positions for a
    scalar position ``pos``."""
    ok = torch.arange(S, device=device) <= pos
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, torch.full_like(zero, -1e30))[None, :]


def attn_decode(cfg: LMConfig, p, h, cache, pos: int):
    """One-token decode against a dense cache ``{k, v: {q: [B, Smax, KV, hd]
    (, s)}}`` at scalar position ``pos``. The new K/V are written into the
    cache tensors in place (the reference returns updated copies; writing in
    place keeps one resident cache)."""
    _no_window(cfg)
    x = rms_norm(p["ln"], h, cfg.norm_eps)
    positions = torch.arange(pos, pos + 1, device=h.device)  # made on the device: no host copy
    q, k_new, v_new = _qkv(cfg, p, x, positions)
    cdtype = cache["k"]["q"].dtype
    for name, new in (("k", k_new), ("v", v_new)):
        for leaf, val in _cache_store(new, cdtype).items():
            cache[name][leaf][:, pos:pos + 1] = val
    S = cache["k"]["q"].shape[1]
    mask = decode_posmask(pos, S, device=h.device)
    o = _sdpa(cfg, q, _cache_load(cache["k"], q.dtype), _cache_load(cache["v"], q.dtype), mask)
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
