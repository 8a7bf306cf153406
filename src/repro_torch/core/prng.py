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
"""
from __future__ import annotations

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


def counter_key_scalars(key: tuple) -> tuple:
    """The two key words bitcast to int32, as Python ints."""
    return tuple(w - (1 << 32) if w >= (1 << 31) else w for w in (key[0] & _MASK, key[1] & _MASK))
