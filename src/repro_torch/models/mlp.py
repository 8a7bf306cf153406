"""Gated MLPs, SwiGLU / GeGLU (port of the dense half of
``repro.models.mlp``; the MoE layers are not ported yet)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import LMConfig, dense_init, gelu, rms_norm, rms_norm_init, xbar_linear


def _act(name: str):
    return {"silu": F.silu, "gelu": gelu}[name]


def mlp_init(cfg: LMConfig, gen: torch.Generator, d_ff: int, *, stack: tuple = (),
             device=None) -> dict:
    d = cfg.d_model
    p = {
        "wi_gate": dense_init(gen, d, d_ff, stack=stack, device=device),
        "wi_up": dense_init(gen, d, d_ff, stack=stack, device=device),
        "wo": dense_init(gen, d_ff, d, stack=stack, device=device),
        "ln": rms_norm_init(d, stack=stack, device=device),
    }
    if cfg.post_norm:
        p["post_ln"] = rms_norm_init(d, stack=stack, device=device)
    return p


def mlp_apply(cfg: LMConfig, p, h: torch.Tensor) -> torch.Tensor:
    x = rms_norm(p["ln"], h, cfg.norm_eps)
    act = _act(cfg.act)
    y = act(xbar_linear(x, p["wi_gate"], h.dtype)) * xbar_linear(x, p["wi_up"], h.dtype)
    y = xbar_linear(y, p["wo"], h.dtype)
    if cfg.post_norm:
        y = rms_norm(p["post_ln"], y, cfg.norm_eps)
    return h + y
