"""The threefry2x32 key chain of JAX's default PRNG, on the host.

The training step derives every stochastic-rounding key from Python ints
(the state's ``PRNGKey(7)``, the step, the leaf index and the layer index),
so key derivation is plain integer arithmetic here and never touches a
device: no tensor, no sync. A key is a pair of uint32 words, as a tuple of
Python ints.

* ``PRNGKey(seed)`` is ``(0, seed)``;
* ``fold_in(key, data)`` is ``threefry_2x32(key, [0, data])``;
* ``counter_key_scalars(key)`` is the two words bitcast to int32 (what the
  update kernels take as their key words).

* ``split(key, n)`` is ``jax.random.split``: key ``i`` is
  ``threefry_2x32(key, [0, i])``, the same block as ``fold_in(key, i)``
  under JAX's partitionable threefry.

``uniform(key, shape)`` draws on tensors: the stream of
``jax.random.uniform(key, shape, float32)`` (the ``rng_mode="grid"``
rounding draw), whose element at flat index ``n`` is a pure function of
the key and ``n`` (JAX's partitionable threefry), so any window of it can
be drawn alone. ``normal(key, shape)`` is ``jax.random.normal``'s stream
from it, through XLA's f32 ``ErfInv`` (``erfinv``); ``gumbel(key, shape)``
is ``jax.random.gumbel``'s, and ``categorical(key, logits)`` the Gumbel-max
draw of ``jax.random.categorical`` (sampled decoding).
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(key: tuple, x0: int, x1: int) -> tuple:
    """One threefry2x32 block (20 rounds) of the counter pair ``(x0, x1)``
    under ``key``: the hash of ``jax.random``'s default implementation."""
    k0, k1 = key[0] & _MASK, key[1] & _MASK
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _MASK, (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def PRNGKey(seed: int) -> tuple:  # noqa: N802 - mirrors jax.random.PRNGKey
    """A raw key from a non-negative 32-bit seed: ``(0, seed)``."""
    return 0, int(seed) & _MASK


def fold_in(key: tuple, data: int) -> tuple:
    """``jax.random.fold_in`` for a 32-bit ``data``."""
    return threefry2x32(key, 0, int(data) & _MASK)


def split(key: tuple, n: int = 2) -> list:
    """``jax.random.split(key, n)`` as ``n`` host keys."""
    return [threefry2x32(key, 0, i) for i in range(n)]


def counter_key_scalars(key: tuple) -> tuple:
    """The two key words bitcast to int32, as Python ints."""
    return tuple(w - (1 << 32) if w >= (1 << 31) else w for w in (key[0] & _MASK, key[1] & _MASK))


# elements drawn per chunk: bounds the int64 temporaries of a draw over the
# 256000 x 2048 embedding
_CHUNK = 1 << 24


def threefry2x32_lanes(key: tuple, x0: torch.Tensor, x1: torch.Tensor) -> tuple:
    """``threefry2x32`` of every counter pair ``(x0, x1)``: int64 tensors of
    uint32 values, with every sum and rotation masked back to 32 bits (torch
    has no uint32 arithmetic). Returns the two int64 output words."""
    k0, k1 = key[0] & _MASK, key[1] & _MASK
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_MASK)
            x1 = ((x1 << r) | (x1 >> (32 - r))).bitwise_and_(_MASK).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        x1.add_((ks[(i + 2) % 3] + i + 1) & _MASK).bitwise_and_(_MASK)
    return x0, x1


def uniform(key: tuple, shape: tuple, *, offset: int = 0, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` bit for
    bit, or the window of that stream that starts at flat index ``offset``
    (of a larger draw under the same key). Element ``n`` is ``(b0 ^ b1) >>
    9`` as the mantissa of a float in [1, 2), minus 1 (multiples of 2^-23),
    with ``(b0, b1) = threefry2x32(key, (n >> 32, n & 0xFFFFFFFF))``: JAX's
    ``jax_threefry_partitionable`` stream; then ``max(minval, u · (maxval -
    minval) + minval)``. Drawn in chunks of 2^24 elements."""
    shape = tuple(shape)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    flat = out.view(-1)
    for s in range(0, flat.numel(), _CHUNK):
        n = torch.arange(offset + s, offset + min(s + _CHUNK, flat.numel()), dtype=torch.int64, device=device)
        b0, b1 = threefry2x32_lanes(key, n >> 32, n & _MASK)
        bits = (b0.bitwise_xor_(b1) >> 9) | 0x3F800000
        flat[s:s + n.numel()] = bits.to(torch.int32).view(torch.float32) - 1.0
    if (minval, maxval) != (0.0, 1.0):
        # XLA contracts u · (maxval - minval) + minval into one FMA: the f64
        # product is exact, so one rounding to f32 follows it here too
        lo, hi = np.float32(minval), np.float32(maxval)
        flat.copy_((flat.to(torch.float64) * float(hi - lo) + float(lo)).to(torch.float32)).clamp_(min=float(lo))
    return out


# XLA's f32 ErfInv (Giles' single-precision approximation, as StableHLO
# decomposes chlo.erf_inv): a degree-8 polynomial in w - 2.5 for w =
# -log1p(-x²) < 5, in sqrt(w) - 3 above; highest coefficient first
_ERFINV_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                 -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                 -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """f32 ``erfinv`` the way XLA computes it (``torch.erfinv`` uses another
    formula). XLA's CPU backend contracts each Horner step into one FMA:
    here the step is exact in f64 (a 24×24-bit product) and rounded once to
    f32, which differs from a true FMA only where the f64 sum lies on an f32
    tie; the square root is correctly rounded through f64, as XLA's is
    (torch's CPU one is not). ``torch.log1p`` and XLA's differ by up to 2
    ulps, so the result can too (``tests/test_torch_paper_mlp.py`` counts
    them)."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w.to(torch.float64)).to(torch.float32) - 3.0).to(torch.float64)
    lt_c = torch.tensor([float(np.float32(c)) for c in _ERFINV_W_LT5], dtype=torch.float64, device=x.device)
    ge_c = torch.tensor([float(np.float32(c)) for c in _ERFINV_W_GE5], dtype=torch.float64, device=x.device)
    p = torch.where(lt, lt_c[0], ge_c[0])
    for i in range(1, len(_ERFINV_W_LT5)):
        p = (torch.where(lt, lt_c[i], ge_c[i]) + p * w).to(torch.float32).to(torch.float64)
    out = p.to(torch.float32) * x
    return torch.where(x.abs() == 1.0, x * float("inf"), out)


def normal(key: tuple, shape: tuple, *, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) · erfinv(u)``
    with ``u`` uniform over ``[nextafter(-1, 0), 1)``. The uniform draw is
    bit for bit; ``erfinv`` within the ulps its docstring names."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, minval=lo, maxval=1.0, device=device)
    return erfinv(u).mul_(float(np.float32(np.sqrt(2.0))))


def gumbel(key: tuple, shape: tuple, *, device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (its default "low" mode):
    ``-log(-log(u))`` with ``u`` uniform over ``[tiny, 1)``. The uniform draw
    is bit for bit; torch's and XLA's f32 ``log`` differ by ulps, so the
    noise can too (``tests/test_torch_serve_engine.py`` bounds them)."""
    u = uniform(key, shape, minval=float(np.finfo(np.float32).tiny), maxval=1.0, device=device)
    return -torch.log(-torch.log(u))


def categorical(key: tuple, logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=dim)``: the index of the
    largest ``logits + gumbel(key, logits.shape)`` along ``dim``, in f32."""
    g = gumbel(key, tuple(logits.shape), device=logits.device)
    return torch.argmax(g + logits.to(torch.float32), dim=dim)
