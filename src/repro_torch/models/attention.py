"""Attention blocks (port of ``repro.models.attention``): the GQA/MQA core
with RoPE, optional qk-norm, sandwich norm, logit softcap and an optional
sliding window, and DeepSeek-style MLA (multi-head latent attention: a
compressed ``c_kv`` and one shared ``k_rope`` cached a token).

Full-sequence attention takes an explicit additive mask up to
``CHUNK_THRESHOLD`` keys and the chunked online softmax (``_sdpa_chunked``)
above, under the reference's condition. Decode keeps a cache, dense or
paged (a page pool per leaf read through a slot page table), at a scalar
position or at one position a slot, and writes it in place; the
chunked-prefill continuations (``attn_cont``, ``mla_cont``) process a chunk
of a prompt against a dense cache.
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

NEG = -1e30  # a masked logit


def _additive(ok: torch.Tensor) -> torch.Tensor:
    """0 where ``ok``, ``NEG`` elsewhere, f32."""
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG))


def causal_mask(s_q: int, s_k: int, window: int | None = None, q_offset: int = 0, device=None):
    """[s_q, s_k] additive causal mask, optionally windowed (a key ``window``
    or more positions behind its query is masked); ``q_offset`` is the
    absolute position of query 0 (a prefill continuation's chunk start)."""
    qpos = torch.arange(s_q, device=device)[:, None] + q_offset
    kpos = torch.arange(s_k, device=device)[None, :]
    ok = kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return _additive(ok)


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
    """q [B,Sq,H,hd]; k [B,Sk,KV,hd]; v [B,Sk,KV,hd_v]; mask additive,
    [Sq,Sk] or per slot [B,1,1,1,Sk]. Query heads group as [B, Sq, KV,
    groups, hd]; logits and softmax in f32."""
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


CHUNK_THRESHOLD = 2048  # the chunked online softmax above this key length
_QC = 1024  # query chunk
_KC = 1024  # key chunk


def _sdpa_chunked(cfg: LMConfig, q, k, v, window: int | None):
    """Causal (optionally windowed) attention as an online softmax over
    ``_QC``-query x ``_KC``-key chunks, never forming ``[Sq, Sk]``: a query
    chunk keeps a running max ``m``, sum ``l`` and f32 accumulator over the
    key chunks in order. q [B,Sq,H,hd]; k [B,Sk,KV,hd]; v [B,Sk,KV,hd_v]
    (``hd_v`` may differ from ``hd``: MLA). The reference's arithmetic:
    softcap before the positional mask, masked logits ``NEG``, ``m`` from
    ``-inf``, ``l`` floored at 1e-30. Every chunk pair runs, fully masked
    ones too: such a pair adds ``exp(0)`` terms, which the next chunk with
    a visible key scales by ``exp(NEG - m) = 0``."""
    B, Sq, H, hd = q.shape
    Skv, kv = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    g = H // kv
    qc, kc = min(_QC, Sq), min(_KC, Skv)
    nq, nk = Sq // qc, Skv // kc
    assert Sq % qc == 0 and Skv % kc == 0, (Sq, Skv)
    f32, dev = torch.float32, q.device
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=f32, device=dev))
    neg = torch.full((), NEG, dtype=f32, device=dev)
    qpos_in = torch.arange(qc, device=dev)
    kpos_in = torch.arange(kc, device=dev)
    outs = []
    for qi in range(nq):
        qg = q[:, qi * qc:(qi + 1) * qc].reshape(B, qc, kv, g, hd).permute(0, 2, 3, 1, 4).to(f32)
        qpos = qi * qc + qpos_in
        m = torch.full((B, kv, g, qc), -math.inf, dtype=f32, device=dev)
        l = torch.zeros((B, kv, g, qc), dtype=f32, device=dev)
        acc = torch.zeros((B, kv, g, qc, hd_v), dtype=f32, device=dev)
        for ki in range(nk):
            kch = k[:, ki * kc:(ki + 1) * kc]
            vch = v[:, ki * kc:(ki + 1) * kc]
            logits = softcap(torch.einsum("bkgqh,bskh->bkgqs", qg, kch.to(f32)) * scale, cfg.softcap_attn)
            kpos = ki * kc + kpos_in
            ok = kpos[None, :] <= qpos[:, None]
            if window is not None:
                ok &= kpos[None, :] > qpos[:, None] - window
            logits = torch.where(ok, logits, neg)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p.to(vch.dtype), vch).to(f32)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # [B,kv,g,qc,hd_v]
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))  # [B,qc,kv,g,hd_v]
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd_v)


def _attend(cfg: LMConfig, q, k, v, window: int | None = None):
    """Full-sequence attention: the explicit mask, or the chunked online
    softmax above ``CHUNK_THRESHOLD`` keys when both lengths divide into
    their chunks."""
    Sq, Sk = q.shape[1], k.shape[1]
    if Sk > CHUNK_THRESHOLD and Sq % min(_QC, Sq) == 0 and Sk % min(_KC, Sk) == 0:
        return _sdpa_chunked(cfg, q, k, v, window)
    return _sdpa(cfg, q, k, v, causal_mask(Sq, Sk, window, device=q.device))


def _out(cfg: LMConfig, p, h, o):
    """The output projection, the optional sandwich norm, the residual."""
    o = xbar_linear(o.reshape(*o.shape[:2], -1), p["wo"], h.dtype)
    if cfg.post_norm:
        o = rms_norm(p["post_ln"], o, cfg.norm_eps)
    return h + o


def attn_apply(cfg: LMConfig, p, h, positions, window=None, with_cache=False):
    """Full-sequence attention (train / prefill). Returns h (+ cache)."""
    x = rms_norm(p["ln"], h, cfg.norm_eps)
    q, k, v = _qkv(cfg, p, x, positions)
    out = _out(cfg, p, h, _attend(cfg, q, k, v, window))
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


def is_vector(pos) -> bool:
    """Whether a decode ``pos`` is one position a slot (``[B]``)."""
    return isinstance(pos, torch.Tensor) and pos.dim() == 1


def decode_positions(pos, device):
    """A decode ``pos`` (an int, or ``[B]`` on the device) and the positions
    its RoPE reads: ``[B, 1]``, or ``[1]`` made on the device (no host
    copy)."""
    if is_vector(pos):
        return pos, pos[:, None]
    pos = int(pos)
    return pos, torch.arange(pos, pos + 1, device=device)


def decode_posmask(pos, S: int, window=None, device=None) -> torch.Tensor:
    """Additive decode mask over ``S`` cached positions, optionally
    windowed: ``[1, S]`` for a scalar ``pos``, ``[B, S]`` per slot for a
    vector ``pos [B]`` (a dead slot at the out-of-range sentinel sees every
    position, garbage only it consumes)."""
    kpos = torch.arange(S, device=device)[None, :]
    posb = pos[:, None] if is_vector(pos) else pos
    ok = kpos <= posb
    if window is not None:
        ok &= kpos > posb - window
    return _additive(ok)


def _entry_write(entry: dict, new: dict, pos, table=None) -> dict:
    """Write a decoded token's stored leaves (``_cache_store``'s, or MLA's
    ``c_kv``/``k_rope``) into a cache entry in place: a paged scatter when a
    page ``table`` rides along, a per-slot scatter for a vector ``pos``, a
    slice for a scalar one."""
    for leaf, val in new.items():
        if table is not None:
            paged_scatter(entry[leaf], table, val, pos)
        elif is_vector(pos):
            seq_scatter(entry[leaf], val, pos)
        else:
            entry[leaf][:, pos:pos + 1] = val
    return entry


def kv_write_read(cache, k_new, v_new, write):
    """Write one decoded token's K and V into ``cache`` (dense ``{k, v}``
    or paged ``{table, k, v}``) at ``write`` (the decode position, or its
    ring slot) in place; return the K and V entries the step reads: the
    cache's own, or the dense view of the pages."""
    cdtype = cache["k"]["q"].dtype
    table = cache["table"] if is_paged_cache(cache) else None
    if table is not None and not is_vector(write):
        write = torch.full((k_new.shape[0],), write, device=k_new.device)
    _entry_write(cache["k"], _cache_store(k_new, cdtype), write, table)
    _entry_write(cache["v"], _cache_store(v_new, cdtype), write, table)
    if table is None:
        return cache["k"], cache["v"]
    return ({leaf: paged_gather(c, table) for leaf, c in cache["k"].items()},
            {leaf: paged_gather(c, table) for leaf, c in cache["v"].items()})


def attn_decode(cfg: LMConfig, p, h, cache, pos, window=None):
    """One-token decode. h [B,1,d]; ``pos`` a scalar (an int) or one
    position a slot (``[B]``, on the device). ``cache`` is dense ``{k, v:
    {q: [B, Smax, KV, hd] (, s)}}`` or paged ``{table, k, v}``, each leaf a
    page pool ``[P + 1, page, KV, hd]`` read through ``table [B,
    max_pages]`` (``models.common.paged_gather``). The new K/V are written
    into the cache tensors in place (the reference returns updated copies;
    writing in place keeps one resident cache); a dead slot's write lands
    on the write-only page or is dropped, and its reads are masked."""
    x = rms_norm(p["ln"], h, cfg.norm_eps)
    pos, positions = decode_positions(pos, h.device)
    q, k_new, v_new = _qkv(cfg, p, x, positions)
    kd, vd = kv_write_read(cache, k_new, v_new, pos)
    mask = decode_posmask(pos, kd["q"].shape[1], window, device=h.device)
    if is_vector(pos):
        mask = mask[:, None, None, None, :]  # [B,S] -> broadcast vs [B,kv,g,q,s]
    o = _sdpa(cfg, q, _cache_load(kd, q.dtype), _cache_load(vd, q.dtype), mask)
    return _out(cfg, p, h, o), cache


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


def block_apply(cfg: LMConfig, p, h, positions, window=None):
    """Training forward of one layer (no cache)."""
    h = attn_apply(cfg, p["attn"], h, positions, window)
    return mlp_apply(cfg, p["mlp"], h)


def block_prefill(cfg: LMConfig, p, h, positions, window=None):
    h, cache = attn_apply(cfg, p["attn"], h, positions, window, with_cache=True)
    return mlp_apply(cfg, p["mlp"], h), cache


def block_decode(cfg: LMConfig, p, h, cache, pos, window=None):
    h, cache = attn_decode(cfg, p["attn"], h, cache, pos, window)
    return mlp_apply(cfg, p["mlp"], h), cache


# ------------------------ chunked-prefill continuation -----------------------
# A chunk of C prompt tokens at absolute positions ``start .. start+C``
# against a dense cache that already holds the first ``start`` positions
# (zeros beyond, masked). The serving engine prefills long prompts a chunk
# at a time this way, so decode slots never wait more than one chunk.


def attn_cont(cfg: LMConfig, p, h, cache, positions, start: int, window=None):
    """Prefill continuation of the GQA core. h [B,C,d]; ``positions`` [C]
    absolute; ``start`` the chunk's first position; ``cache`` dense [B,
    Stot, ...], written in place."""
    x = rms_norm(p["ln"], h, cfg.norm_eps)
    q, k_new, v_new = _qkv(cfg, p, x, positions)
    cdtype = cache["k"]["q"].dtype
    C = q.shape[1]
    for name, new in (("k", k_new), ("v", v_new)):
        for leaf, val in _cache_store(new, cdtype).items():
            cache[name][leaf][:, start:start + C] = val
    mask = causal_mask(C, cache["k"]["q"].shape[1], window, q_offset=start, device=h.device)
    o = _sdpa(cfg, q, _cache_load(cache["k"], q.dtype), _cache_load(cache["v"], q.dtype), mask)
    return _out(cfg, p, h, o), cache


def block_cont(cfg: LMConfig, p, h, cache, positions, start: int, window=None):
    h, cache = attn_cont(cfg, p["attn"], h, cache, positions, start, window)
    return mlp_apply(cfg, p["mlp"], h), cache


# ------------------------------- MLA ----------------------------------------
# The cache holds the compressed ``c_kv [B, S, rank]`` (after its norm) and
# the one RoPE key ``k_rope [B, S, 1, rope]`` all heads share; every step
# expands them through ``w_uk``/``w_uv`` (crossbar reads of B·Sk rows).


def mla_init(cfg: LMConfig, gen: torch.Generator, *, stack: tuple = (), device=None) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    return {
        # q and the compressed-KV down-projection read the same layer input:
        # ONE fused [d, H*qk_dim + rank + rope] weight, laid out [q | dkv]
        "wq_dkv": dense_init(gen, d, H * qk_dim + m.kv_lora_rank + m.qk_rope_dim, stack=stack, device=device),
        "w_uk": dense_init(gen, m.kv_lora_rank, H * m.qk_nope_dim, stack=stack, device=device),
        "w_uv": dense_init(gen, m.kv_lora_rank, H * m.v_head_dim, stack=stack, device=device),
        "wo": dense_init(gen, H * m.v_head_dim, d, stack=stack, device=device),
        "ln": rms_norm_init(d, stack=stack, device=device),
        "kv_ln": rms_norm_init(m.kv_lora_rank, stack=stack, device=device),
    }


def _mla_qkv(cfg: LMConfig, p, x, positions):
    """(q_nope, q_rope, c_kv, k_rope) of ``x [B, S, d]``: one read of the
    fused ``wq_dkv``, RoPE on the rope parts, the norm on ``c_kv``."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    q_dkv = xbar_linear(x, p["wq_dkv"], x.dtype)  # [B,S,H*qk+rank+rope]
    q, c_kv, k_rope = torch.split(q_dkv, [H * qk_dim, m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    q_nope, q_rope = torch.split(q.reshape(B, S, H, qk_dim), [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = rms_norm(p["kv_ln"], c_kv, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)  # [B,S,1,rope]
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(cfg: LMConfig, p, q_nope, q_rope, c_kv, k_rope, mask, dtype):
    """Attention of the queries over a cache: ``c_kv`` expanded through
    ``w_uk``/``w_uv`` (crossbar reads, so a finite-ADC wrap serves them),
    the nope and rope logits summed at scale ``1/sqrt(nope + rope)``.
    Returns ``[B, Sq, H·v]``."""
    m = cfg.mla
    B, Sk = c_kv.shape[:2]
    H = cfg.n_heads
    f32 = torch.float32
    k_nope = xbar_linear(c_kv, p["w_uk"], dtype).reshape(B, Sk, H, m.qk_nope_dim)
    v = xbar_linear(c_kv, p["w_uv"], dtype).reshape(B, Sk, H, m.v_head_dim)
    scale = 1.0 / torch.sqrt(torch.tensor(float(m.qk_nope_dim + m.qk_rope_dim), dtype=f32, device=c_kv.device))
    logits = (torch.einsum("bqhd,bshd->bhqs", q_nope.to(f32), k_nope.to(f32))
              + torch.einsum("bqhd,bsd->bhqs", q_rope.to(f32), k_rope[:, :, 0].to(f32))) * scale
    w = torch.softmax(logits + mask, dim=-1).to(dtype)
    out = torch.einsum("bhqs,bshd->bqhd", w, v)
    return out.reshape(B, -1, H * m.v_head_dim)


def mla_apply(cfg: LMConfig, p, h, positions, with_cache=False):
    """Full-sequence MLA as standard attention over the concatenated nope
    and rope sub-dims (the scale ``1/sqrt(nope + rope)`` is ``_sdpa``'s
    ``1/sqrt(hd)``), so long sequences take the chunked path at ``hd`` =
    nope + rope and a value width of ``v_head_dim``."""
    m = cfg.mla
    x = rms_norm(p["ln"], h, cfg.norm_eps)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, positions)
    B, S = x.shape[:2]
    H = cfg.n_heads
    k_nope = xbar_linear(c_kv, p["w_uk"], x.dtype).reshape(B, S, H, m.qk_nope_dim)
    v = xbar_linear(c_kv, p["w_uv"], x.dtype).reshape(B, S, H, m.v_head_dim)
    q_eff = torch.cat([q_nope, q_rope], dim=-1)
    k_eff = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_dim)], dim=-1)
    o = _attend(cfg, q_eff, k_eff.to(q_eff.dtype), v)
    out = h + xbar_linear(o.reshape(B, S, H * m.v_head_dim), p["wo"], h.dtype)
    if with_cache:
        return out, {"c_kv": c_kv, "k_rope": k_rope}
    return out


def mla_decode(cfg: LMConfig, p, h, cache, pos):
    """One-token MLA decode against the compressed cache, dense ``{c_kv,
    k_rope}`` or paged ``{table, c_kv, k_rope}`` (pools ``[P + 1, page,
    ...]``), at a scalar ``pos`` or one a slot; written in place, as
    :func:`attn_decode`. The up-projections run over the whole cache each
    step (the reference's form, not the absorbed one)."""
    x = rms_norm(p["ln"], h, cfg.norm_eps)
    pos, positions = decode_positions(pos, h.device)
    q_nope, q_rope, c_new, kr_new = _mla_qkv(cfg, p, x, positions)
    table = cache["table"] if is_paged_cache(cache) else None
    wpos = pos if (table is None or is_vector(pos)) else torch.full((h.shape[0],), pos, device=h.device)
    new = {"c_kv": c_new.to(cache["c_kv"].dtype), "k_rope": kr_new.to(cache["k_rope"].dtype)}
    _entry_write(cache, new, wpos, table)
    if table is not None:
        cd, krd = paged_gather(cache["c_kv"], table), paged_gather(cache["k_rope"], table)
    else:
        cd, krd = cache["c_kv"], cache["k_rope"]
    mask = decode_posmask(pos, cd.shape[1], device=h.device)
    if is_vector(pos):
        mask = mask[:, None, None, :]  # [B,S] -> broadcast vs [B,H,q,s]
    o = _mla_attend(cfg, p, q_nope, q_rope, cd.to(x.dtype), krd.to(x.dtype), mask, x.dtype)
    return h + xbar_linear(o, p["wo"], h.dtype), cache


def mla_cont(cfg: LMConfig, p, h, cache, positions, start: int):
    """Prefill continuation for MLA against a dense compressed cache,
    written in place."""
    x = rms_norm(p["ln"], h, cfg.norm_eps)
    q_nope, q_rope, c_new, kr_new = _mla_qkv(cfg, p, x, positions)
    C = q_nope.shape[1]
    cache["c_kv"][:, start:start + C] = c_new.to(cache["c_kv"].dtype)
    cache["k_rope"][:, start:start + C] = kr_new.to(cache["k_rope"].dtype)
    mask = causal_mask(C, cache["c_kv"].shape[1], q_offset=start, device=h.device)
    o = _mla_attend(cfg, p, q_nope, q_rope, cache["c_kv"].to(x.dtype), cache["k_rope"].to(x.dtype), mask,
                    x.dtype)
    return h + xbar_linear(o, p["wo"], h.dtype), cache


def mla_cache_spec(cfg: LMConfig, batch: int, max_seq: int, dtype) -> dict:
    m = cfg.mla
    return {
        "c_kv": ShapeDtype((batch, max_seq, m.kv_lora_rank), dtype),
        "k_rope": ShapeDtype((batch, max_seq, 1, m.qk_rope_dim), dtype),
    }
