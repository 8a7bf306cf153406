"""Plain PyTorch versions of the sliced-OPA kernels (port of
``repro.kernels.sliced_opa.ref`` for the ideal device, ``device=None``).

``opa_fused_ref`` follows the reference's KERNEL path, not its CPU
dispatch: the operands widen to f32 and the contraction accumulates in f32
(``src/repro/kernels/sliced_opa/kernel.py``), where the reference's CPU
oracle contracts in the operand dtype. The finalize is the kernel's: ``y =
acc · (-lr · 2^F)``, then ``floor(y + u)`` under key words or ``round(y)``
without, saturation to int32, and the digit deposit. The CPU tests run these
versions, and ``chip_smoke.py`` holds the CUDA kernels against them on the
card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fixed_point import _f32_to_i32, counter_u01, exp2i, quantize
from repro_torch.core.opa import opa_batched
from repro_torch.core.slicing import SliceSpec


def opa_deposit_ref(planes, p_q, spec: SliceSpec):
    """planes int8 [S, ...], p_q int32 [...] -> int8 [S, ...]."""
    return opa_batched(planes, p_q, spec)


def _lr32(lr) -> float:
    """The learning rate rounded to f32, as the reference's f32 ``lr``."""
    return float(np.float32(lr))


def opa_fused_ref(planes, x, dh, lr, frac_bits, spec: SliceSpec, key_words=None):
    """planes int8 [S, M, N]; x [T, M] and dh [T, N] (any float dtype);
    ``lr`` a host float; ``frac_bits`` the weight grid exponent F;
    ``key_words`` None (round half to even) or two int32 Python ints (the
    counter draw at global (row, col)) -> new int8 planes [S, M, N]."""
    acc = x.to(torch.float32).T @ dh.to(torch.float32)
    scale = exp2i(torch.as_tensor(frac_bits, dtype=torch.int32)).to(acc.device) * -_lr32(lr)
    y = acc * scale
    if key_words is not None:
        M, N = acc.shape
        r = torch.arange(M, dtype=torch.int32, device=acc.device)[:, None]
        c = torch.arange(N, dtype=torch.int32, device=acc.device)[None, :]
        y = torch.floor(y + counter_u01(r, c, *key_words))
    else:
        y = torch.round(y)
    lim = float(2**31 - 1)
    return opa_batched(planes, _f32_to_i32(torch.clamp(y, -lim, lim)), spec)


def opa_fused_update_ref(planes, x, dh, lr, frac_bits, spec: SliceSpec, *,
                         stochastic: bool = False, key=None, rng_mode: str = "counter"):
    """The whole update on any stack: ``opa_batched(planes, quantize(-lr ·
    xᵀdh))`` with the contraction in f32 and the counter draw of ``key``
    (per-layer ``fold_in(key, l)`` over the stack, inside ``quantize``).
    planes [S, *stack, M, N]; x [*stack, T, M]; dh [*stack, T, N]."""
    g = torch.einsum("...tm,...tn->...mn", x.to(torch.float32), dh.to(torch.float32))
    upd = quantize(-_lr32(lr) * g, frac_bits, stochastic=stochastic, key=key, rng_mode=rng_mode)
    return opa_batched(planes, upd, spec)
