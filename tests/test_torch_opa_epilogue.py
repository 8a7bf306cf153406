"""K1's packed stuck mask (``kernels/sliced_opa/ref.py`` ``stuck_bits_ref``,
``deposit_keep_ref``: the byte of slice bits a cell that the tensor-core
body caches, and the deposit that keeps the digits of the slices whose bit
is set) against the JAX package's ``_stuck_masks`` and ``_deposit``
(``repro.kernels.sliced_opa.kernel``), on the CPU.

Tolerance: none. Every comparison is bit for bit: the mask is a pure
function of the global (row, col), the seed and the slice, and the deposit
is int32 arithmetic. The deposit cases cover every digit of every plane
width of the default spec (44466555) against updates on both sides of each
rail, ``±canonical_limit``, and past them.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.slicing import DEFAULT_SPEC as JSPEC  # noqa: E402
from repro.kernels.sliced_opa.kernel import _deposit, _stuck_masks  # noqa: E402
from repro.models.common import DeviceModel as JDevice  # noqa: E402
from repro_torch.core.slicing import DEFAULT_SPEC as SPEC  # noqa: E402
from repro_torch.kernels.sliced_opa import ref as RO  # noqa: E402
from repro_torch.models.common import DeviceModel  # noqa: E402


def _unpack(bits: torch.Tensor) -> np.ndarray:
    return np.stack([((bits.numpy().astype(np.int32) >> s) & 1).astype(bool) for s in range(SPEC.n_slices)])


@pytest.mark.parametrize("seed,frac", [(3, 0.02), (7, 0.5), (0, 1e-3), (12345, 0.98)])
@pytest.mark.parametrize("i,j", [(0, 0), (2, 1), (5, 3)])
def test_stuck_bits_match_the_reference_masks_at_global_coordinates(seed, frac, i, j):
    bm, bn = 16, 24
    want = np.asarray(_stuck_masks(JDevice(stuck_frac=frac, stuck_seed=seed), JSPEC, i, j, (bm, bn)))
    bits = RO.stuck_bits_ref(DeviceModel(stuck_frac=frac, stuck_seed=seed), SPEC, (i + 1) * bm, (j + 1) * bn)
    assert bits.dtype == torch.uint8
    np.testing.assert_array_equal(_unpack(bits[i * bm:, j * bn:]), want)


def _every_digit_planes() -> np.ndarray:
    """int8 [S, K]: plane s runs through every digit in [-m_s, m_s], each
    plane at its own period so the columns mix the planes' digits."""
    k = np.arange(4 * 63)
    return np.stack([(k * (s + 1)) % (2 * m + 1) - m for s, m in enumerate(SPEC.plane_max)]).astype(np.int8)


def _rail_updates(rng) -> np.ndarray:
    """int32 updates: small ones, both sides of each rail ±canonical_limit,
    the int32 extremes and draws over all of int32."""
    lim = SPEC.canonical_limit
    near = np.arange(-40, 41)
    vals = np.concatenate([near, lim + near, -lim + near, [2**31 - 1, -(2**31), 0],
                           rng.integers(-(2**31), 2**31, 200)])
    return vals.astype(np.int64).clip(-(2**31), 2**31 - 1).astype(np.int32)


@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_deposit_keep_matches_the_reference_deposit_and_masks(frac):
    rng = np.random.default_rng(int(frac * 10))
    planes0, upd = _every_digit_planes(), _rail_updates(rng)
    K, R = planes0.shape[1], upd.size
    planes = np.broadcast_to(planes0[:, None, :], (SPEC.n_slices, R, K)).copy()
    p_q = np.broadcast_to(upd[:, None], (R, K)).copy()
    dev = DeviceModel(stuck_frac=frac, stuck_seed=5)
    masks = np.asarray(_stuck_masks(JDevice(stuck_frac=frac, stuck_seed=5), JSPEC, 0, 0, (R, K)))
    want = np.asarray(jnp.where(masks, planes, _deposit(jnp.asarray(planes, jnp.int32), jnp.asarray(p_q), JSPEC)))
    bits = RO.stuck_bits_ref(dev, SPEC, R, K)
    got = RO.deposit_keep_ref(torch.from_numpy(planes), torch.from_numpy(p_q), bits, SPEC)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int8
