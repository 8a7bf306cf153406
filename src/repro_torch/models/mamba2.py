"""Mamba2 (SSD) mixer block (port of ``repro.models.mamba2``): the chunked
parallel scan for training and prefill, the O(1) recurrent state update for
decode.

Per head h, with the scalar decay ``a_t = exp(A · dt_t)``:
    S_t = a_t · S_{t-1} + dt_t · (B_t ⊗ x_t)        S: [head_dim, d_state]
    y_t = S_t · C_t + D · x_t

The chunked form (chunk Q): the contributions inside a chunk through a
masked decay matrix ``L[t, s] = exp(cum_t - cum_s)``, those across chunks
through a loop over the chunk-final states (the reference's ``lax.scan``).
The sequence is padded up to a multiple of Q, as in the reference, so every
reduction has the reference's shapes; the final state runs through the
padded steps (their decay and input are zero). The projections read through
``xbar_linear`` and the causal depthwise conv through ``xbar_dwconv`` (its
taps ``conv_w`` an im2col crossbar leaf under ``plan.coverage_rules``); the
scan itself is plain PyTorch, as the reference's is plain JAX.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import LMConfig, ShapeDtype, dense_init, rms_norm, rms_norm_init, xbar_dwconv, xbar_linear


def _dims(cfg: LMConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere (torch's
    ``softplus`` returns ``x`` above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba2_init(cfg: LMConfig, gen: torch.Generator, *, stack: tuple = (), device=None) -> dict:
    """Separate projections (``w_z``/``w_x``/``w_B``/``w_C``/``w_dt``), each
    its own crossbar tile, as in the reference."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, H = _dims(cfg)
    C = d_inner + 2 * s.d_state
    conv_w = torch.zeros((*stack, s.d_conv, C), dtype=torch.float32, device=device)
    conv_w[..., -1, :] = 1.0
    full = lambda v, n: torch.full((*stack, n), v, dtype=torch.float32, device=device)  # noqa: E731
    return {
        "ln": rms_norm_init(d, stack=stack, device=device),
        "w_z": dense_init(gen, d, d_inner, stack=stack, device=device),
        "w_x": dense_init(gen, d, d_inner, stack=stack, device=device),
        "w_B": dense_init(gen, d, s.d_state, stack=stack, device=device),
        "w_C": dense_init(gen, d, s.d_state, stack=stack, device=device),
        "w_dt": dense_init(gen, d, H, stack=stack, device=device),
        "conv_w": conv_w,
        "conv_b": full(0.0, C),
        "A_log": full(0.0, H),  # A = -exp(A_log) = -1 at init
        "dt_bias": full(-2.0, H),  # softplus(-2) ~ 0.126
        "D": full(1.0, H),
        "out_ln": rms_norm_init(d_inner, stack=stack, device=device),
        "w_out": dense_init(gen, d_inner, d, stack=stack, device=device),
    }


def _causal_conv(cfg: LMConfig, xbc: torch.Tensor, conv_w, conv_b, prev=None):
    """Depthwise causal conv of ``xbc [B, S, C]`` with ``conv_w [K, C]``
    (a tensor or a crossbar wrap); ``prev [B, K - 1, C]`` the left context
    (a continuation or decode), zeros otherwise. -> (silu(conv + b), the
    last K - 1 inputs: the next call's left context)."""
    K = cfg.ssm.d_conv
    if prev is None:
        prev = torch.zeros((xbc.shape[0], K - 1, xbc.shape[2]), dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([prev, xbc], dim=1)
    out = xbar_dwconv(xp, conv_w, xbc.dtype)
    return F.silu(out + conv_b.to(xbc.dtype)), xp[:, -(K - 1):]


def _split_in(cfg: LMConfig, p, x: torch.Tensor):
    z = xbar_linear(x, p["w_z"], x.dtype)
    xbc = torch.cat([xbar_linear(x, p["w_x"], x.dtype), xbar_linear(x, p["w_B"], x.dtype),
                     xbar_linear(x, p["w_C"], x.dtype)], dim=-1)
    dt = xbar_linear(x, p["w_dt"], x.dtype)
    return z, xbc, dt


def ssd_scan(cfg: LMConfig, x, Bs, Cs, dt, A_log, D, init=None):
    """The chunked SSD of ``x [B, S, d_inner]`` (activation dtype), ``Bs``
    and ``Cs [B, S, d_state]``, ``dt [B, S, H]`` (f32, after the softplus)
    from the state ``init [B, H, hd, ds]`` (f32; zeros when None). ->
    ``(y [B, S, d_inner]`` in x's dtype, before the gate, the final state
    f32)."""
    s = cfg.ssm
    d_inner, H = _dims(cfg)
    hd, ds, Q = s.head_dim, s.d_state, s.chunk
    B, S, _ = x.shape
    loga = dt * -torch.exp(A_log)  # [B, S, H] log decay a step
    nq = -(-S // Q)
    pad = nq * Q - S
    if pad:
        x, Bs, Cs, dt, loga = (F.pad(t, (0, 0, 0, pad)) for t in (x, Bs, Cs, dt, loga))
    xh = x.reshape(B, nq, Q, H, hd)
    Bc = Bs.reshape(B, nq, Q, ds).to(torch.float32)
    Cc = Cs.reshape(B, nq, Q, ds).to(torch.float32)
    dtc = dt.reshape(B, nq, Q, H)
    cum = torch.cumsum(loga.reshape(B, nq, Q, H), dim=2)  # [B, nq, Q, H]

    # inside a chunk: y[t] = Σ_{s <= t} C_t·B_s exp(cum_t - cum_s) dt_s x_s
    Lmat = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B, nq, Q(t), Q(s), H]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    Lmat = torch.where(mask[None, None, :, :, None], torch.exp(Lmat), 0.0)
    CB = torch.einsum("bqtn,bqsn->bqts", Cc, Bc)
    G = CB[..., None] * Lmat
    xdt = xh * dtc[..., None].to(xh.dtype)
    y_intra = torch.einsum("bqtsh,bqshd->bqthd", G.to(xh.dtype), xdt)

    # chunk-final states, and the carry across chunks
    total = cum[:, :, -1, :]  # [B, nq, H]
    decay_to_end = torch.exp(total[:, :, None, :] - cum)
    contrib = torch.einsum("bqsh,bqshd,bqsn->bqhdn", decay_to_end * dtc, xh.to(torch.float32), Bc)
    state = torch.zeros((B, H, hd, ds), dtype=torch.float32, device=x.device) if init is None else init
    entering = []  # the state entering each chunk
    for q in range(nq):
        entering.append(state)
        state = state * torch.exp(total[:, q])[:, :, None, None] + contrib[:, q]
    entering = torch.stack(entering, dim=1)  # [B, nq, H, hd, ds]
    y_inter = torch.einsum("bqtn,bqth,bqhdn->bqthd", Cc, torch.exp(cum), entering).to(xh.dtype)

    y = (y_intra + y_inter).reshape(B, nq * Q, H, hd)[:, :S]
    y = y + x.reshape(B, nq * Q, H, hd)[:, :S] * D[None, None, :, None].to(y.dtype)
    return y.reshape(B, S, d_inner), state


def mamba2_apply(cfg: LMConfig, p, h: torch.Tensor, with_state: bool = False, state=None):
    """Full-sequence SSD of ``h [B, S, d]``. ``state``: a cache ``{ssd,
    conv}`` from an earlier ``with_state=True`` call or decode steps: the
    scan starts from ``state["ssd"]`` and the conv takes ``state["conv"]``
    as left context (a prompt prefilled in chunks). ``with_state`` also
    returns the new ``{ssd, conv}``."""
    d_inner, _ = _dims(cfg)
    ds = cfg.ssm.d_state
    x_in = rms_norm(p["ln"], h, cfg.norm_eps)
    z, xbc, dt_raw = _split_in(cfg, p, x_in)
    prev = None if state is None else state["conv"].to(xbc.dtype)
    xbc, conv_tail = _causal_conv(cfg, xbc, p["conv_w"], p["conv_b"], prev=prev)
    x, Bs, Cs = torch.split(xbc, [d_inner, ds, ds], dim=-1)
    dt = softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # [B, S, H]
    y, final = ssd_scan(cfg, x, Bs, Cs, dt, p["A_log"], p["D"], None if state is None else state["ssd"])
    y = rms_norm(p["out_ln"], y * F.silu(z), cfg.norm_eps)
    out = h + xbar_linear(y, p["w_out"], h.dtype)
    if with_state:
        return out, {"ssd": final, "conv": conv_tail}
    return out


def mamba2_decode(cfg: LMConfig, p, h: torch.Tensor, cache, pos):
    """One-token recurrent step. cache: ``ssd [B, H, hd, ds]`` f32, ``conv
    [B, K - 1, C]``. Returns ``(h, new state)``; the caller writes the state
    where it keeps it."""
    d_inner, H = _dims(cfg)
    hd, ds = cfg.ssm.head_dim, cfg.ssm.d_state
    B = h.shape[0]
    x_in = rms_norm(p["ln"], h, cfg.norm_eps)
    z, xbc, dt_raw = _split_in(cfg, p, x_in)
    xbc, conv_tail = _causal_conv(cfg, xbc, p["conv_w"], p["conv_b"], prev=cache["conv"].to(xbc.dtype))
    x, Bs, Cs = torch.split(xbc, [d_inner, ds, ds], dim=-1)
    dt = softplus(dt_raw.to(torch.float32) + p["dt_bias"])[:, 0]  # [B, H]
    a = torch.exp(dt * -torch.exp(p["A_log"]))
    xh = x.reshape(B, H, hd).to(torch.float32)
    state = cache["ssd"] * a[:, :, None, None] + torch.einsum("bh,bhd,bn->bhdn", dt, xh,
                                                                 Bs[:, 0].to(torch.float32))
    y = torch.einsum("bhdn,bn->bhd", state, Cs[:, 0].to(torch.float32))
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(B, 1, d_inner).to(h.dtype)
    y = rms_norm(p["out_ln"], y * F.silu(z), cfg.norm_eps)
    return h + xbar_linear(y, p["w_out"], h.dtype), {"ssd": state, "conv": conv_tail}


def mamba2_cache_spec(cfg: LMConfig, batch: int, max_seq: int, dtype) -> dict:
    s = cfg.ssm
    d_inner, H = _dims(cfg)
    return {"ssd": ShapeDtype((batch, H, s.head_dim, s.d_state), torch.float32),
            "conv": ShapeDtype((batch, s.d_conv - 1, d_inner + 2 * s.d_state), dtype)}
