"""Fixed-point quantization utilities (port of ``repro.core.fixed_point``).

16-bit fixed point for activations, 32-bit for weights, per-tensor
power-of-two scales. Deterministic rounding only: the counter-hash
stochastic-rounding RNG belongs to the training slice.
"""
from __future__ import annotations

import functools
import math

import torch

WEIGHT_BITS = 32
IO_BITS = 16

_I32_MAX = 2**31 - 1


def exp2i(e) -> torch.Tensor:
    """Exact ``2.0**e`` (f32) for integer exponents in [-126, 127], built from
    the IEEE exponent field — never ``torch.exp2``, which need not be exact
    for every integer exponent on every backend."""
    e = torch.as_tensor(e, dtype=torch.int32)
    return ((e + 127) << 23).view(torch.float32)


@functools.lru_cache(maxsize=None)
def _inv_ln2(dtype: torch.dtype) -> float:
    """f32 reciprocal of ``log(2)`` rounded to ``dtype``, as a Python float
    (exact in f32), so no host-to-device copy is made per call."""
    ln2 = torch.tensor(math.log(2.0), dtype=torch.float64).to(dtype).float()
    return float(1.0 / ln2)


def _ceil_log2(m: torch.Tensor) -> torch.Tensor:
    """``ceil(log2(m))`` computed the way XLA computes ``jnp.log2`` on the CPU:
    ``log`` in f32, rounded to the input dtype, times the f32 reciprocal of
    ``log(2)`` rounded to that dtype, rounded again, then ``ceil``. The
    exponent this picks decides the scale of a whole read, so it must equal
    the reference's for values just above and below a power of two, where a
    correctly rounded ``log2`` gives another answer."""
    dt = m.dtype
    log_m = torch.log(m.double()).float().to(dt).float()
    return torch.ceil((log_m * _inv_ln2(dt)).to(dt))


def choose_frac_bits(
    x: torch.Tensor,
    word_bits: int = WEIGHT_BITS,
    margin_bits: int = 2,
    clip_to_word: bool = True,
) -> torch.Tensor:
    """Pick F so that ``max|x| * 2**F`` fits ``word_bits``-bit signed with
    ``margin_bits`` of headroom. Returns an int32 0-d tensor on ``x``'s
    device (no host sync). All-zero tensors get ``word_bits-1-margin_bits``.
    ``clip_to_word`` bounds F to [0, word_bits) (weights); otherwise to
    ±64 (the free-range IO DAC scale)."""
    max_abs = x.detach().abs().max()
    int_bits = _ceil_log2(torch.clamp(max_abs, min=1e-30).to(max_abs.dtype))
    f = (word_bits - 1 - margin_bits) - int_bits
    f = torch.where(max_abs == 0, torch.full_like(f, word_bits - 1 - margin_bits), f)
    if clip_to_word:
        return torch.clamp(f, 0, word_bits - 1).to(torch.int32)
    return torch.clamp(f, -64, 64).to(torch.int32)


def _f32_to_i32(y: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 with XLA's saturating convert: a clip at
    ``float(2**31 - 1)`` lands on 2**31 in f32, which XLA converts to
    ``2**31 - 1`` where a plain ``.to(torch.int32)`` wraps it."""
    out = y.to(torch.int32)
    return torch.where(y >= 2.0**31, torch.full_like(out, _I32_MAX), out)


def quantize(x: torch.Tensor, frac_bits, word_bits: int = WEIGHT_BITS) -> torch.Tensor:
    """Quantize float -> signed fixed-point int32 with saturation, rounding
    half to even (``torch.round``, like ``jnp.round``)."""
    scale = exp2i(frac_bits).to(x.device)
    y = torch.round(x.to(torch.float32) * scale)
    lim = float(2 ** (word_bits - 1) - 1)
    y = torch.clamp(y, -lim, lim)
    return _f32_to_i32(y)


def dequantize(q: torch.Tensor, frac_bits, dtype=torch.float32) -> torch.Tensor:
    scale = exp2i(-torch.as_tensor(frac_bits, dtype=torch.int32)).to(q.device)
    return (q.to(torch.float32) * scale).to(dtype)
