"""Fixed-point quantization utilities (port of ``repro.core.fixed_point``).

16-bit fixed point for activations, 32-bit for weights, per-tensor
power-of-two scales, and the counter-hash U[0, 1) draw of stochastic
rounding: a stateless int32 hash of the global (row, col) element position
and two key words, so the update kernels and the plain versions draw the
same bits for any blocking. ``counter_gauss`` is its Box-Muller Gaussian,
the draw of the device model's write noise and read offsets. The rounding
can also draw ``jax.random.uniform``'s stream (``rng_mode="grid"``,
``core.prng.uniform``). Keys are host words (``core.prng``).
"""
from __future__ import annotations

import functools
import math

import numpy as np
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


# ------------------- counter-based stochastic-rounding noise -----------------
# int32 arithmetic that wraps (two's complement, as uint32 multiplies); torch's
# ``>>`` on int32 is arithmetic, so each right shift is masked to make it
# logical.

_FMIX_C1 = -2048144789  # 0x85ebca6b as int32
_FMIX_C2 = -1028477387  # 0xc2b2ae35 as int32
_GOLDEN = -1640531527  # 0x9e3779b9 as int32
_U24 = 2.0**-24  # u = (h >>> 8) * 2^-24


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer of an int32 word."""
    h = h ^ ((h >> 16) & 0xFFFF)
    h = h * _FMIX_C1
    h = h ^ ((h >> 13) & 0x7FFFF)
    h = h * _FMIX_C2
    return h ^ ((h >> 16) & 0xFFFF)


def counter_u01(r: torch.Tensor, c: torch.Tensor, k0: int, k1: int) -> torch.Tensor:
    """U[0, 1) f32 noise at (row ``r``, col ``c``) under the int32 key words
    ``(k0, k1)`` (Python ints)."""
    h = (r.to(torch.int32) * _GOLDEN) ^ (c.to(torch.int32) * _FMIX_C2) ^ k0
    h = _fmix32(h ^ k1)
    return ((h >> 8) & 0xFFFFFF).to(torch.float32) * _U24


def _i32(w: int) -> int:
    """A 32-bit word as a signed int32 Python int."""
    w &= 0xFFFFFFFF
    return w - (1 << 32) if w >= (1 << 31) else w


def _fmix32_host(h: int) -> int:
    """``_fmix32`` of one int32 word on the host."""
    h &= 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return _i32(h ^ (h >> 16))


_TWO_PI_F32 = float(np.float32(2.0 * np.pi))


def counter_gauss(r: torch.Tensor, c: torch.Tensor, k0: int, k1: int) -> torch.Tensor:
    """Standard-normal f32 noise at (row ``r``, col ``c``) under the int32
    key words ``(k0, k1)``: Box-Muller over two counter draws, the second
    under ``(k0 ^ GOLDEN, fmix32(k1 ^ FMIX_C1))``. Every product rounds to
    f32 on its own. ``u1 <= 1 - 2^-24``, so ``log1p(-u1)`` is finite."""
    u1 = counter_u01(r, c, k0, k1)
    u2 = counter_u01(r, c, _i32(k0 ^ _GOLDEN), _fmix32_host(k1 ^ _FMIX_C1))
    rad = torch.sqrt(-2.0 * torch.log1p(-u1))
    return rad * torch.cos(_TWO_PI_F32 * u2)


# fold_in tag of the device write-noise key stream, apart from the rounding
# stream: the write-noise key is fold_in(key, WRITE_NOISE_FOLD)
WRITE_NOISE_FOLD = 0x57A9


def device_pattern_words(seed: int, salt: int) -> tuple[int, int]:
    """Two int32 key words of a frozen device pattern (the stuck-cell masks,
    the read offsets) from a seed and a site salt: wrapping uint32
    arithmetic on the host."""
    w0 = (seed * 0x9E3779B9 + salt * 0x85EBCA6B + 0xC2B2AE35) & 0xFFFFFFFF
    w1 = (seed ^ (salt * 0x27D4EB2F) ^ 0x165667B1) & 0xFFFFFFFF
    return _i32(w0), _i32(w1)


def _counter_array(draw, key: tuple, shape: tuple, device=None) -> torch.Tensor:
    """``draw(r, c, k0, k1)`` over ``shape``: the trailing two dims are the
    (row, col) grid; each leading (layer-stack) index ``l`` draws under
    ``fold_in(key, l)``, the per-layer key of the stacked update kernel.
    Rank < 2 shapes are one row."""
    from .prng import counter_key_scalars, fold_in

    shape = tuple(shape)
    gs = shape[-2:] if len(shape) >= 2 else (1,) + shape
    r = torch.arange(gs[0], dtype=torch.int32, device=device)[:, None]
    c = torch.arange(gs[1], dtype=torch.int32, device=device)[None, :]
    lead = shape[:-2] if len(shape) >= 2 else ()
    if not lead:
        return draw(r, c, *counter_key_scalars(key)).reshape(shape)
    L = math.prod(lead)
    u = torch.empty((L, *gs), dtype=torch.float32, device=device)
    for l in range(L):
        u[l] = draw(r, c, *counter_key_scalars(fold_in(key, l)))
    return u.reshape(shape)


def counter_uniform(key: tuple, shape: tuple, device=None) -> torch.Tensor:
    """Counter-mode U[0, 1) of ``shape`` (per-layer keys over leading dims)."""
    return _counter_array(counter_u01, key, shape, device)


def counter_gauss_array(key: tuple, shape: tuple, device=None) -> torch.Tensor:
    """Counter-mode standard normal of ``shape``, with ``counter_uniform``'s
    grid and per-layer keys: the write noise a stacked leaf draws."""
    return _counter_array(counter_gauss, key, shape, device)


# the stochastic-rounding draws (PantherConfig.rng_mode), in the order of
# the update kernel's codes (opa_fused.cu's Rng, 1 + the index)
RNG_MODES = ("counter", "grid", "hw")


def check_rng_mode(rng_mode: str, *, plain: bool = True) -> str:
    """``rng_mode``, or ``ValueError`` for a mode not in ``RNG_MODES`` and,
    with ``plain``, for ``"hw"``: the update kernel's own draw, which has
    no plain one (the reference's ``rounding_noise`` and CPU path refuse
    it too; dense leaves take ``"counter"``)."""
    if rng_mode not in RNG_MODES:
        raise ValueError(f"unknown rng_mode {rng_mode!r} (expected one of {RNG_MODES})")
    if plain and rng_mode == "hw":
        raise ValueError("rng_mode='hw' is the update kernel's own draw, on CUDA planes only, and has no plain "
                         "draw; use 'counter' or 'grid' off the card")
    return rng_mode


def rounding_noise(key: tuple, shape: tuple, rng_mode: str = "counter", device=None) -> torch.Tensor:
    """The U[0, 1) stochastic-rounding draw of ``shape`` under ``rng_mode``:
    ``"counter"`` (the coordinate hash, per-layer keys over leading dims) or
    ``"grid"`` (``jax.random.uniform``'s stream over the whole shape, the
    draw of runs from before the counter draw). ``"hw"`` exists only inside
    the update kernel and raises here, as any other mode does."""
    if check_rng_mode(rng_mode) == "counter":
        return counter_uniform(key, shape, device=device)
    from .prng import uniform

    return uniform(key, shape, device=device)


def quantize(x: torch.Tensor, frac_bits, word_bits: int = WEIGHT_BITS, *,
             stochastic: bool = False, key: tuple | None = None,
             rng_mode: str = "counter") -> torch.Tensor:
    """Quantize float -> signed fixed-point int32 with saturation: round half
    to even (``torch.round``, like ``jnp.round``), or with ``stochastic``
    ``floor(y + u)`` under the ``rng_mode`` draw of ``key``."""
    scale = exp2i(frac_bits).to(x.device)
    y = x.to(torch.float32) * scale
    if stochastic:
        if key is None:
            raise ValueError("stochastic rounding requires a PRNG key")
        y = torch.floor(y + rounding_noise(key, tuple(y.shape), rng_mode, device=y.device))
    else:
        y = torch.round(y)
    lim = float(2 ** (word_bits - 1) - 1)
    return _f32_to_i32(torch.clamp(y, -lim, lim))


def dequantize(q: torch.Tensor, frac_bits, dtype=torch.float32) -> torch.Tensor:
    scale = exp2i(-torch.as_tensor(frac_bits, dtype=torch.int32)).to(q.device)
    return (q.to(torch.float32) * scale).to(dtype)
