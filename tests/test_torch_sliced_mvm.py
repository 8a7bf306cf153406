"""The port's plain quantize-fused sliced MVM (what the CUDA kernel is held
against) versus the JAX package: its Pallas kernel run in interpret mode and
its jnp reference, on the same numpy inputs.

Tolerances:
* ``adc_bits=None`` on f32-exact inputs (digit planes in [-2, 2], so every
  per-slice column sum stays below 2^24): bit-identical to the interpret-mode
  kernel and to the reference run eagerly — same integer sums, same
  ascending slice fold, exact power-of-two scales.
* finite ADC (9, 6) and the general ideal case: ``max|diff| <= 1e-3 * (1 +
  max|ref|)``, the kernel-vs-ref tolerance of
  ``tests/test_kernels_mvm_fused.py`` (f32 reassociation only).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.fixed_point import choose_frac_bits  # noqa: E402
from repro.core.slicing import DEFAULT_SPEC as JSPEC  # noqa: E402
from repro.kernels.sliced_mvm import ops as JO  # noqa: E402
from repro.kernels.sliced_mvm import ref as JR  # noqa: E402
from repro_torch.core.slicing import DEFAULT_SPEC as TSPEC  # noqa: E402
from repro_torch.kernels.sliced_mvm import ops as TO  # noqa: E402
from repro_torch.kernels.sliced_mvm import ref as TR  # noqa: E402

IO = 16
TOL = 1e-3


def _case(m, n, b, seed, digit=8):
    rng = np.random.default_rng(seed)
    planes = rng.integers(-digit, digit, size=(JSPEC.n_slices, m, n)).astype(np.int8)
    x = rng.normal(size=(b, m)).astype(np.float32)
    xf = int(choose_frac_bits(jnp.asarray(x), word_bits=IO, margin_bits=1, clip_to_word=False))
    return planes, x, xf


def _port(planes, x, xf, adc, transpose=False):
    return TO.mvm_sliced_fused(torch.from_numpy(planes), torch.from_numpy(x), xf, TSPEC,
                               io_bits=IO, adc_bits=adc, transpose=transpose).numpy()


def _jax_kernel(planes, x, xf, adc):
    return np.asarray(JO.mvm_sliced_fused(jnp.asarray(planes), jnp.asarray(x), jnp.int32(xf), JSPEC,
                                          io_bits=IO, adc_bits=adc, use_kernel=True, interpret=True))


def _jax_ref(planes, x, xf, adc, transpose=False):
    # eager, as the ops entry runs it off the kernel path (under jit XLA
    # re-fuses the tile and slice folds into another summation order)
    return np.asarray(JR.mvm_sliced_fused_ref(jnp.asarray(planes), jnp.asarray(x), jnp.int32(xf),
                                              JSPEC, IO, adc, transpose=transpose))


def _close(want, got):
    assert want.shape == got.shape
    assert float(np.abs(want - got).max()) <= TOL * (1.0 + float(np.abs(want).max()))


def test_ideal_adc_bit_identical_on_f32_exact_inputs():
    planes, x, xf = _case(256, 192, 16, seed=0, digit=2)
    got = _port(planes, x, xf, None)
    assert np.array_equal(got, _jax_kernel(planes, x, xf, None))
    assert np.array_equal(got, _jax_ref(planes, x, xf, None))


@pytest.mark.parametrize("adc", [9, 6, None])
def test_matches_interpret_kernel_and_ref(adc):
    planes, x, xf = _case(384, 256, 24, seed=1)
    got = _port(planes, x, xf, adc)
    _close(_jax_kernel(planes, x, xf, adc), got)
    _close(_jax_ref(planes, x, xf, adc), got)


@pytest.mark.parametrize("adc", [9, None])
@pytest.mark.parametrize("m,n,b", [(320, 192, 5), (256, 100, 1), (200, 64, 7)])
def test_ragged_tokens_and_short_last_tile_match_ref(adc, m, n, b):
    # a contraction dim off the 128 grid ends in a short tile whose ADC full
    # scale stays 128·plane_max; token counts off the 8-granule
    planes, x, xf = _case(m, n, b, seed=2)
    _close(_jax_ref(planes, x, xf, adc), _port(planes, x, xf, adc))


def test_transpose_read_matches_ref():
    rng = np.random.default_rng(3)
    planes = rng.integers(-8, 8, size=(JSPEC.n_slices, 192, 256)).astype(np.int8)
    xt = rng.normal(size=(6, 256)).astype(np.float32)
    xf = int(choose_frac_bits(jnp.asarray(xt), word_bits=IO, margin_bits=1, clip_to_word=False))
    _close(_jax_ref(planes, xt, xf, 9, transpose=True), _port(planes, xt, xf, 9, transpose=True))


def test_batched_entry_flattens_leading_dims():
    planes, _, _ = _case(256, 192, 1, seed=4)
    x = np.random.default_rng(5).normal(size=(3, 5, 256)).astype(np.float32)
    xf = int(choose_frac_bits(jnp.asarray(x), word_bits=IO, margin_bits=1, clip_to_word=False))
    want = np.asarray(JO.mvm_sliced_fused_batched(jnp.asarray(planes), jnp.asarray(x), jnp.int32(xf),
                                                  JSPEC, io_bits=IO, adc_bits=9, use_kernel=True,
                                                  interpret=True))
    got = TO.mvm_sliced_fused_batched(torch.from_numpy(planes), torch.from_numpy(x), xf, TSPEC,
                                      io_bits=IO, adc_bits=9).numpy()
    assert got.shape == (3, 5, 192)
    _close(want, got)


def test_unfused_ref_matches_reference():
    planes, x, xf = _case(256, 128, 8, seed=6)
    xq = TR.dac_quantize(torch.from_numpy(x), xf, IO)
    assert np.array_equal(xq.numpy(), np.asarray(JR.dac_quantize(jnp.asarray(x), jnp.int32(xf), IO)))
    for adc in (9, None):
        want = np.asarray(JR.mvm_sliced_ref(jnp.asarray(planes), jnp.asarray(xq.numpy()), JSPEC, IO, adc))
        _close(want, TR.mvm_sliced_ref(torch.from_numpy(planes), xq, TSPEC, IO, adc).numpy())


@pytest.mark.parametrize("adc", [9, None])
def test_core_mvm_sliced_and_mvm_fast_match_reference(adc):
    from repro.core import mvm as jmvm
    from repro_torch.core import mvm as tmvm

    planes, x, xf = _case(128, 64, 6, seed=7)
    xq = np.asarray(JR.dac_quantize(jnp.asarray(x), jnp.int32(xf), IO))
    want = np.asarray(jmvm.mvm_sliced(jnp.asarray(planes), jnp.asarray(xq), JSPEC, IO, adc))
    _close(want, tmvm.mvm_sliced(torch.from_numpy(planes), torch.from_numpy(xq), TSPEC, IO, adc).numpy())
    # the lossless anchor: one matmul on the dequantized planes
    want = np.asarray(jmvm.mvm_fast(jnp.asarray(planes), jnp.asarray(x), 30, JSPEC))
    got = tmvm.mvm_fast(torch.from_numpy(planes), torch.from_numpy(x), 30, TSPEC).numpy()
    assert float(np.abs(want - got).max()) <= 1e-5 * float(np.abs(want).max())
