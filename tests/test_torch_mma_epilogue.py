"""The tensor-core read's ADC epilogue (``kernels/sliced_mvm/ref.py``
``adc_codes_exact``, ``ideal_slice_term``: the magic-constant arithmetic
the CUDA body runs, in f32 torch ops) against ``torch.round``/``clamp`` and
against the JAX package's ADC model ``repro.core.mvm._adc`` and tile body
``repro.kernels.sliced_mvm.kernel._tile_compute``, on the CPU.

Tolerance: none. Every comparison is bit for bit: the steps are powers of
two, so the products are exact and each result rounds once, half to even.
Currents cover every integer in ``[-128·pm, 128·pm]`` for each slice width
of the default spec (44466555), and beyond the full scale up to the int8
planes' ``±128·128``; offsets are drawn from a numpy seed, plus ties.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.mvm import _adc  # noqa: E402
from repro.core.slicing import DEFAULT_SPEC as JSPEC  # noqa: E402
from repro.kernels.sliced_mvm.kernel import _tile_compute, read_offsets  # noqa: E402
from repro.models.common import DeviceModel as JDevice  # noqa: E402
from repro_torch.core.slicing import DEFAULT_SPEC as TSPEC  # noqa: E402
from repro_torch.kernels.sliced_mvm import ref as TR  # noqa: E402

WIDTHS = sorted(set(TSPEC.bits_lsb_first))  # 4, 5, 6
ROWS = 128


def _currents(bits: int) -> np.ndarray:
    """Every current of a 128-row column at this slice width, and some past
    its full scale (the int8 planes allow |c| <= 128·128)."""
    fs = ROWS * (1 << (bits - 1))
    beyond = np.array([-ROWS * 128, -fs - 1, fs + 1, ROWS * 128, -3 * fs, 2 * fs + 7])
    return np.concatenate([np.arange(-fs, fs + 1), beyond]).astype(np.int32)


def _adc_params(bits: int, adc: int):
    e = 7 + bits - adc  # step = 2·128·2^(bits-1)/2^adc = 2^e
    return 2.0 ** e, 2.0 ** -e, 1 << (adc - 1), float(ROWS * (1 << (bits - 1)))


def _jax_codes(col_sum: np.ndarray, fs: float, adc: int, step: float) -> np.ndarray:
    # _adc returns code·step; dividing by the power-of-two step is exact
    return (np.asarray(_adc(jnp.asarray(col_sum, jnp.float32), fs, adc)) / np.float32(step)).astype(np.int32)


@pytest.mark.parametrize("adc", [9, 6])
@pytest.mark.parametrize("bits", WIDTHS)
def test_codes_match_round_clamp_and_jax_adc(bits, adc):
    step, inv, half, fs = _adc_params(bits, adc)
    c = _currents(bits)
    got = TR.adc_codes_exact(torch.from_numpy(c), None, inv, half)
    want = torch.clamp(torch.round(torch.from_numpy(c).float() * inv), -half, half).to(torch.int32)
    assert torch.equal(got, want)
    assert np.array_equal(got.numpy(), _jax_codes(c.astype(np.float32), fs, adc, step))
    # the ties c·inv = k + 1/2 are there and round to even
    ties = (c % int(step)) == int(step) // 2
    assert ties.sum() > 0 and np.all(got.numpy()[ties & (np.abs(c) < fs)] % 2 == 0)


@pytest.mark.parametrize("adc", [9, 6])
@pytest.mark.parametrize("bits", WIDTHS)
def test_noisy_codes_match_round_clamp_and_jax_adc(bits, adc):
    step, inv, half, fs = _adc_params(bits, adc)
    c = _currents(bits)
    rng = np.random.default_rng(100 * bits + adc)
    # read offsets as a read-noisy device draws them (1% of full scale), and
    # offsets that put c + off on a half step (ties) or far past the rails
    noise = (rng.normal(size=c.shape) * np.float32(0.01 * fs)).astype(np.float32)
    ties = (rng.integers(-3, 3, size=c.shape) + 0.5).astype(np.float32) * np.float32(step)
    wild = (rng.normal(size=c.shape) * np.float32(4 * fs)).astype(np.float32)
    for off in (noise, ties, wild, np.zeros_like(noise)):
        col_sum = c.astype(np.float32) + off  # one rounding, as the kernel's __fadd_rn
        got = TR.adc_codes_exact(torch.from_numpy(c), torch.from_numpy(off), inv, half)
        want = torch.clamp(torch.round(torch.from_numpy(col_sum) * inv), -half, half).to(torch.int32)
        assert torch.equal(got, want)
        assert np.array_equal(got.numpy(), _jax_codes(col_sum, fs, adc, step))


@pytest.mark.parametrize("adc", [16, 12, 1])
def test_codes_exact_at_the_extreme_adc_widths(adc):
    # the addend 1.5·2^23·(1 - 2^-e) stays exact for e from 7+4-16 to 7+6-1
    for bits in WIDTHS:
        step, inv, half, _ = _adc_params(bits, adc)
        c = _currents(bits)
        got = TR.adc_codes_exact(torch.from_numpy(c), None, inv, half)
        want = torch.clamp(torch.round(torch.from_numpy(c).float() * inv), -half, half).to(torch.int32)
        assert torch.equal(got, want)


def test_bit_fold_of_the_code_bits_wraps_exactly():
    # the kernel folds the codes' float bits (0x4B400000 + code) shifted by t
    # in uint32 and takes (2^T - 1)·0x4B400000 off once
    rng = np.random.default_rng(7)
    for io in (8, 12, 16):
        T = io - 1
        codes = rng.integers(-256, 257, size=(T, 1000)).astype(np.int64)
        bits = (codes + TR.ADC_MAGIC_BITS) % 2**32
        z = (sum(bits[t] << t for t in range(T)) - TR.ADC_MAGIC_BITS * (2**T - 1)) % 2**32
        z = np.where(z >= 2**31, z - 2**32, z)
        assert np.array_equal(z, sum(codes[t] << t for t in range(T)))


@pytest.mark.parametrize("io_bits", [16, 8])
@pytest.mark.parametrize("noisy", [False, True])
def test_ideal_slice_terms_fold_as_the_jax_tile_body(io_bits, noisy):
    rng = np.random.default_rng(io_bits + 10 * noisy)
    S, bb, bn = JSPEC.n_slices, 5, 24
    lim = 2 ** (io_bits - 1) - 1
    xq = rng.integers(-lim, lim + 1, size=(bb, ROWS)).astype(np.int32)
    w = rng.integers(-8, 8, size=(S, ROWS, bn)).astype(np.int8)
    if io_bits == 16:  # keep every f32 dot exact (|z| < 2^24) for the JAX side
        xq //= 8
    dev = JDevice(read_noise=0.01, stuck_seed=3) if noisy else None
    tile, col0 = 3, 40
    want = np.asarray(_tile_compute(jnp.asarray(xq), jnp.asarray(w), spec=JSPEC, io_bits=io_bits, adc_bits=None,
                                    dev=dev, tile_idx=jnp.int32(tile), col0=jnp.int32(col0)))
    offs = None
    if noisy:  # the JAX offsets themselves, so only the epilogue is compared
        jo = read_offsets(dev, JSPEC, jnp.int32(tile), jnp.int32(col0), bn, False)
        offs = torch.from_numpy(np.array(jo)).reshape(S, bn)
    acc = None
    for s in range(S):
        z = torch.from_numpy(xq.astype(np.int64) @ w[s].astype(np.int64))
        term = TR.ideal_slice_term(z, None if offs is None else offs[s], io_bits, s)
        acc = term if acc is None else acc + term
    assert np.array_equal(acc.numpy(), want)
