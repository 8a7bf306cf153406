"""xLSTM blocks (port of ``repro.models.xlstm``, arXiv:2405.04517): mLSTM
(matrix memory, chunkwise-parallel for training and prefill, recurrent for
decode) and sLSTM (scalar memory, a sequential scan).

mLSTM, stabilized exponential gating:
    D[t, s] = exp(F[t] - F[s] + i[s] - m[t]),  F = cumsum(logsigmoid(f))
    y[t] = ((q kᵀ / sqrt(d)) ⊙ D) v / max(|row sum|, exp(-m))
Decode keeps the matrix memory C [B, H, hd, hd] and the normalizer n [B, H,
hd]. The projections read through ``xbar_linear``, the mLSTM's causal conv
through ``xbar_dwconv``; the recurrences are plain PyTorch, as the
reference's are plain JAX, the reference's ``lax.scan`` a Python loop.
sLSTM's recurrent ``r`` ``[H, hd, 4hd]`` is read once a token, so its
gradient is dense, summed over the steps by autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import LMConfig, ShapeDtype, dense_init, gelu, rms_norm, rms_norm_init, xbar_dwconv, xbar_linear


def _dims(cfg: LMConfig):
    x = cfg.xlstm
    d_up = int(x.proj_factor * cfg.d_model)
    return d_up, x.n_heads, d_up // x.n_heads


# --------------------------------- mLSTM ------------------------------------


def mlstm_init(cfg: LMConfig, gen: torch.Generator, *, stack: tuple = (), device=None) -> dict:
    d = cfg.d_model
    d_up, H, _ = _dims(cfg)
    conv_w = torch.zeros((*stack, cfg.xlstm.conv_width, d_up), dtype=torch.float32, device=device)
    conv_w[..., -1, :] = 1.0
    if_bias = torch.cat([torch.full((H,), -3.0), torch.full((H,), 3.0)]).to(device)
    return {
        "ln": rms_norm_init(d, stack=stack, device=device),
        "w_up": dense_init(gen, d, d_up, stack=stack, device=device),
        "w_gate": dense_init(gen, d, d_up, stack=stack, device=device),
        "conv_w": conv_w,
        "conv_b": torch.zeros((*stack, d_up), dtype=torch.float32, device=device),
        "wq": dense_init(gen, d_up, d_up, stack=stack, device=device),
        "wk": dense_init(gen, d_up, d_up, stack=stack, device=device),
        "wv": dense_init(gen, d_up, d_up, stack=stack, device=device),
        "w_if": dense_init(gen, d_up, 2 * H, stack=stack, device=device),  # input and forget gate preacts
        "if_bias": if_bias.expand(*stack, 2 * H).clone(),
        "out_ln": rms_norm_init(d_up, stack=stack, device=device),
        "w_down": dense_init(gen, d_up, d, stack=stack, device=device),
    }


def _mlstm_qkv(cfg: LMConfig, p, xu: torch.Tensor):
    d_up, H, hd = _dims(cfg)
    B, S, _ = xu.shape
    K = cfg.xlstm.conv_width
    xp = torch.cat([torch.zeros((B, K - 1, d_up), dtype=xu.dtype, device=xu.device), xu], dim=1)
    conv = F.silu(xbar_dwconv(xp, p["conv_w"], xu.dtype) + p["conv_b"].to(xu.dtype))
    q = xbar_linear(conv, p["wq"], xu.dtype).reshape(B, S, H, hd)
    # the square root rounds to the activation dtype first, as the reference's
    k = xbar_linear(conv, p["wk"], xu.dtype).reshape(B, S, H, hd) / torch.sqrt(
        torch.tensor(float(hd), dtype=xu.dtype, device=xu.device))
    v = xbar_linear(xu, p["wv"], xu.dtype).reshape(B, S, H, hd)
    gif = xbar_linear(xu, p["w_if"], xu.dtype).to(torch.float32) + p["if_bias"]
    i_pre, f_pre = torch.chunk(gif, 2, dim=-1)  # [B, S, H]
    return q, k, v, i_pre, f_pre


MLSTM_CHUNK = 512


def mlstm_scan(q, k, v, i_pre, logf, Q: int):
    """The chunkwise mLSTM recurrence over ``S = nq·Q`` steps from zero
    state: q, k, v ``[B, S, H, hd]`` f32, ``i_pre``/``logf`` ``[B, S, H]``.
    -> ``(y [B, S, H, hd]`` f32, ``(C, n, m)`` the final state)."""
    B, S, H, hd = q.shape
    C_prev = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=q.device)
    n_prev = torch.zeros((B, H, hd), dtype=torch.float32, device=q.device)
    m_prev = torch.zeros((B, H), dtype=torch.float32, device=q.device)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    ys = []
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        q_i, k_i, v_i, i_i, f_i = q[:, sl], k[:, sl], v[:, sl], i_pre[:, sl], logf[:, sl]
        b = torch.cumsum(f_i, dim=1)  # [B, Q, H] log decay from the chunk's start
        # inside the chunk: D[t, s] = b_t - b_s + i_s (s <= t)
        Dm = b[:, :, None, :] - b[:, None, :, :] + i_i[:, None, :, :]
        Dm = torch.where(tri[None, :, :, None], Dm, float("-inf"))
        m_intra = torch.amax(Dm, dim=2)  # [B, Q, H]
        m_inter = b + m_prev[:, None, :]  # the carried state's scale at t
        m_t = torch.maximum(m_intra, m_inter)
        Dexp = torch.exp(Dm - m_t[:, :, None, :])
        inter_w = torch.exp(m_inter - m_t)

        W = torch.einsum("bthd,bshd->btsh", q_i, k_i) * Dexp
        num = torch.einsum("btsh,bshe->bthe", W, v_i) + inter_w[..., None] * torch.einsum(
            "bthd,bhde->bthe", q_i, C_prev)
        n_t = torch.einsum("btsh,bshd->bthd", Dexp, k_i) + inter_w[..., None] * n_prev[:, None]
        denom = torch.maximum(torch.abs(torch.einsum("bthd,bthd->bth", n_t, q_i)), torch.exp(-m_t))
        ys.append(num / denom[..., None])

        # the chunk-final state, at scale m_new
        btot = b[:, -1, :]  # [B, H]
        a_end = btot[:, None, :] - b + i_i  # the weight of step s at the chunk's end
        m_new = torch.maximum(m_prev + btot, torch.amax(a_end, dim=1))
        w_end = torch.exp(a_end - m_new[:, None, :])
        carry = torch.exp(m_prev + btot - m_new)
        C_prev = C_prev * carry[:, :, None, None] + torch.einsum("bsh,bshd,bshe->bhde", w_end, k_i, v_i)
        n_prev = n_prev * carry[:, :, None] + torch.einsum("bsh,bshd->bhd", w_end, k_i)
        m_prev = m_new
    return torch.cat(ys, dim=1), (C_prev, n_prev, m_prev)


def mlstm_apply(cfg: LMConfig, p, h: torch.Tensor, with_state: bool = False):
    """Chunkwise-parallel mLSTM: the decay matrix inside each chunk of
    ``MLSTM_CHUNK`` steps, the (C, n, m) state carried across chunks, the
    same stabilized update as ``mlstm_decode``."""
    B, S, _ = h.shape
    d_up, H, hd = _dims(cfg)
    x = rms_norm(p["ln"], h, cfg.norm_eps)
    xu = xbar_linear(x, p["w_up"], h.dtype)
    gate = F.silu(xbar_linear(x, p["w_gate"], h.dtype))
    q, k, v, i_pre, f_pre = _mlstm_qkv(cfg, p, xu)
    Q = min(MLSTM_CHUNK, S)
    assert S % Q == 0, (S, Q)
    y, (C_f, n_f, m_f) = mlstm_scan(q.to(torch.float32), k.to(torch.float32), v.to(torch.float32), i_pre,
                                    F.logsigmoid(f_pre), Q)
    y = rms_norm(p["out_ln"], y.reshape(B, S, d_up).to(h.dtype), cfg.norm_eps) * gate
    out = h + xbar_linear(y, p["w_down"], h.dtype)
    if not with_state:
        return out
    K = cfg.xlstm.conv_width
    return out, {"C": C_f, "n": n_f, "m": m_f, "conv": xu[:, -(K - 1):].to(torch.float32)}


def mlstm_decode(cfg: LMConfig, p, h: torch.Tensor, cache, pos):
    """One mLSTM step. cache: ``C [B, H, hd, hd]`` f32, ``n [B, H, hd]``,
    ``m [B, H]``, ``conv [B, K - 1, d_up]``. Returns ``(h, new state)``."""
    B = h.shape[0]
    d_up, H, hd = _dims(cfg)
    x = rms_norm(p["ln"], h, cfg.norm_eps)
    xu = xbar_linear(x, p["w_up"], h.dtype)  # [B, 1, d_up]
    gate = F.silu(xbar_linear(x, p["w_gate"], h.dtype))
    K = cfg.xlstm.conv_width
    xp = torch.cat([cache["conv"].to(xu.dtype), xu], dim=1)  # [B, K, d_up]
    conv = F.silu(xbar_dwconv(xp, p["conv_w"], xu.dtype) + p["conv_b"].to(xu.dtype))
    f32 = torch.float32
    q = xbar_linear(conv, p["wq"], xu.dtype).reshape(B, H, hd).to(f32)
    k = (xbar_linear(conv, p["wk"], xu.dtype).reshape(B, H, hd) / torch.sqrt(
        torch.tensor(float(hd), dtype=xu.dtype, device=xu.device))).to(f32)
    v = xbar_linear(xu, p["wv"], xu.dtype).reshape(B, H, hd).to(f32)
    gif = xbar_linear(xu, p["w_if"], xu.dtype).to(f32)[:, 0] + p["if_bias"]
    i_pre, f_pre = torch.chunk(gif, 2, dim=-1)  # [B, H]

    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + cache["m"], i_pre)
    fw = torch.exp(logf + cache["m"] - m_new)[:, :, None]
    iw = torch.exp(i_pre - m_new)[:, :, None]
    C = cache["C"] * fw[..., None] + iw[..., None] * torch.einsum("bhd,bhe->bhde", k, v)
    n = cache["n"] * fw + iw * k
    denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n, q)), torch.exp(-m_new))
    y = (torch.einsum("bhde,bhd->bhe", C, q) / denom[..., None]).reshape(B, 1, d_up).to(h.dtype)
    y = rms_norm(p["out_ln"], y, cfg.norm_eps) * gate
    out = h + xbar_linear(y, p["w_down"], h.dtype)
    return out, {"C": C, "n": n, "m": m_new, "conv": xp[:, -(K - 1):].to(f32)}


def mlstm_cache_spec(cfg: LMConfig, batch: int, max_seq: int, dtype) -> dict:
    d_up, H, hd = _dims(cfg)
    K = cfg.xlstm.conv_width
    f32 = torch.float32
    return {"C": ShapeDtype((batch, H, hd, hd), f32), "n": ShapeDtype((batch, H, hd), f32),
            "m": ShapeDtype((batch, H), f32), "conv": ShapeDtype((batch, K - 1, d_up), f32)}


# --------------------------------- sLSTM ------------------------------------


def slstm_init(cfg: LMConfig, gen: torch.Generator, *, stack: tuple = (), device=None) -> dict:
    d = cfg.d_model
    H = cfg.xlstm.n_heads
    hd = d // H
    d_ff = int(cfg.xlstm.slstm_ff_factor * d)
    r = torch.randn((*stack, H, hd, 4 * hd), generator=gen, dtype=torch.float32, device=device)
    bias = torch.zeros((*stack, 4 * d), dtype=torch.float32, device=device)
    bias[..., d:2 * d] = 3.0  # the forget gate's bias
    return {
        "ln": rms_norm_init(d, stack=stack, device=device),
        "w_x": dense_init(gen, d, 4 * d, stack=stack, device=device),  # i, f, z, o preacts from the input
        "r": r / torch.sqrt(torch.tensor(float(hd))),
        "bias": bias,
        "ffn_ln": rms_norm_init(d, stack=stack, device=device),
        "ffn_up": dense_init(gen, d, d_ff, stack=stack, device=device),
        "ffn_down": dense_init(gen, d_ff, d, stack=stack, device=device),
    }


def _slstm_cell(cfg: LMConfig, p, xg: torch.Tensor, state: dict) -> dict:
    """One step. ``xg [B, 4d]`` the input preacts, laid out (i, f, z, o)
    each ``d = H·hd`` wide; state ``h``, ``c``, ``n``, ``m`` of ``[B, H,
    hd]``."""
    H = cfg.xlstm.n_heads
    hd = cfg.d_model // H
    # the reference's dtype promotion: an r in bf16 (a bf16 compute dtype) reads in f32
    dt = torch.promote_types(state["h"].dtype, p["r"].dtype)
    rec = torch.einsum("bhd,hde->bhe", state["h"].to(dt), p["r"].to(dt))  # [B, H, 4hd]
    xg_h = xg.reshape(-1, 4, H, hd).permute(0, 2, 1, 3).reshape(-1, H, 4 * hd)
    i_pre, f_pre, z_pre, o_pre = torch.chunk(xg_h + rec, 4, dim=-1)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + state["m"], i_pre)
    iw = torch.exp(i_pre - m_new)
    fw = torch.exp(logf + state["m"] - m_new)
    c = fw * state["c"] + iw * torch.tanh(z_pre)
    n = torch.maximum(fw * state["n"] + iw, torch.exp(-m_new))
    return {"h": torch.sigmoid(o_pre) * c / n, "c": c, "n": n, "m": m_new}


def slstm_scan(cfg: LMConfig, p, xg_all: torch.Tensor):
    """The sLSTM recurrence over ``xg_all [B, S, 4d]`` (f32) from the zero
    state (``n`` ones). -> ``(h [B, S, H, hd]``, the final state)."""
    B = xg_all.shape[0]
    H = cfg.xlstm.n_heads
    hd = cfg.d_model // H
    z = lambda: torch.zeros((B, H, hd), dtype=torch.float32, device=xg_all.device)  # noqa: E731
    st = {"h": z(), "c": z(), "n": torch.ones((B, H, hd), dtype=torch.float32, device=xg_all.device), "m": z()}
    hs = []
    for t in range(xg_all.shape[1]):
        st = _slstm_cell(cfg, p, xg_all[:, t], st)
        hs.append(st["h"])
    return torch.stack(hs, dim=1), st


def _slstm_ffn(cfg: LMConfig, p, out: torch.Tensor) -> torch.Tensor:
    xf = rms_norm(p["ffn_ln"], out, cfg.norm_eps)
    return out + xbar_linear(gelu(xbar_linear(xf, p["ffn_up"], out.dtype)), p["ffn_down"], out.dtype)


def slstm_apply(cfg: LMConfig, p, hseq: torch.Tensor, with_state: bool = False):
    B, S, d = hseq.shape
    x = rms_norm(p["ln"], hseq, cfg.norm_eps)
    xg_all = xbar_linear(x, p["w_x"], hseq.dtype).to(torch.float32) + p["bias"]
    hs, final = slstm_scan(cfg, p, xg_all)
    out = _slstm_ffn(cfg, p, hseq + hs.reshape(B, S, d).to(hseq.dtype))
    if with_state:
        return out, final
    return out


def slstm_decode(cfg: LMConfig, p, h: torch.Tensor, cache, pos):
    B = h.shape[0]
    x = rms_norm(p["ln"], h, cfg.norm_eps)
    xg = (xbar_linear(x, p["w_x"], h.dtype).to(torch.float32) + p["bias"])[:, 0]
    st = _slstm_cell(cfg, p, xg, cache)
    out = _slstm_ffn(cfg, p, h + st["h"].reshape(B, 1, cfg.d_model).to(h.dtype))
    return out, st


def slstm_cache_spec(cfg: LMConfig, batch: int, max_seq: int, dtype) -> dict:
    H = cfg.xlstm.n_heads
    sd = ShapeDtype((batch, H, cfg.d_model // H), torch.float32)
    return {"h": sd, "c": sd, "n": sd, "m": sd}
