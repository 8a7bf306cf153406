"""The tensor-core read's ADC epilogue (``kernels/sliced_mvm/ref.py``
``adc_codes_exact``, ``ideal_slice_term``: the magic-constant arithmetic
the CUDA body runs, in f32 torch ops) against ``torch.round``/``clamp`` and
against the JAX package's ADC model ``repro.core.mvm._adc`` and tile body
``repro.kernels.sliced_mvm.kernel._tile_compute``, on the CPU; and its K5
prologue (``int_prologue_words``: the masked 16-bit lane packing of an
unclamped int32 ``x_q``) against JAX's bit planes ``repro.core.mvm.bit_planes``
and its Pallas read ``repro.kernels.sliced_mvm.kernel.mvm_sliced`` in
interpret mode, out-of-range ``x_q`` included.

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
from repro.core.mvm import bit_planes as jax_bit_planes  # noqa: E402
from repro.core.slicing import DEFAULT_SPEC as JSPEC  # noqa: E402
from repro.kernels.sliced_mvm.kernel import _tile_compute, mvm_sliced, read_offsets  # noqa: E402
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


# ----------------------- K5's int prologue (x_q as it is) -----------------------

# out-of-range inputs: the DAC grid's edges, just past it, 2^15 and 2^20
# (their low bits 0 and not), INT_MIN (no abs) and INT_MAX
WILD = [2**15, -2**15, 2**15 + 5, -(2**15) - 3, 2**20, -(2**20), 2**20 + 77, -(2**31), 2**31 - 1, -(2**31) + 1]


def _x_q(rng, b, k, io_bits, wild: bool):
    lim = 2 ** (io_bits - 1) - 1
    x = rng.integers(-lim, lim + 1, size=(b, k)).astype(np.int32)
    if wild:
        x[0, :len(WILD)] = WILD
        x[1] = rng.integers(-(2**31), 2**31, size=k)
        x[2, :2] = [lim + 1, -lim - 1]
    return x


@pytest.mark.parametrize("io_bits", [8, 12, 16])
@pytest.mark.parametrize("k", [128, 130])  # a whole word group; a ragged last word
def test_int_prologue_words_are_the_jax_bit_planes(io_bits, k):
    # every byte of every packed word is JAX's sgn·bit_t of its row, on any
    # int32: the magnitude cut to its io-1 streamed bits never reaches the
    # neighbouring 16-bit lane
    rng = np.random.default_rng(io_bits + k)
    x = _x_q(rng, 6, k, io_bits, wild=True)
    words = TR.int_prologue_words(torch.from_numpy(x), io_bits)
    assert tuple(words.shape) == (io_bits - 1, 6, -(-k // 4)) and int(words.max()) < 2**32
    got = TR.word_bit_planes(words, k).numpy()
    assert np.array_equal(got, np.asarray(jax_bit_planes(jnp.asarray(x), io_bits)))
    # on the DAC grid the words stream x_q itself; off it, sgn·(|x_q| mod 2^(io-1))
    streamed = TR.streamed_input(torch.from_numpy(x), io_bits).numpy()
    mag = np.abs(x.astype(np.int64)) % 2 ** (io_bits - 1)
    assert np.array_equal(streamed, np.where(x < 0, -mag, mag))
    assert np.array_equal(streamed[3:], x[3:])


@pytest.mark.parametrize("io_bits", [8, 12, 16])
@pytest.mark.parametrize("adc", [9, 6, None])
@pytest.mark.parametrize("transpose", [False, True])
def test_read_of_the_streamed_input_matches_the_jax_kernel(io_bits, adc, transpose):
    # K5 as the tensor-core body reads it (the plain read of the int its
    # words stream) against the JAX Pallas read in interpret mode. At finite
    # ADC JAX bit-streams x_q itself, so it takes the out-of-range x_q as it
    # is; at the ideal ADC JAX contracts x_q whole, so it takes the streamed
    # int. Digits in [-2, 2] keep every f32 column sum exact.
    rng = np.random.default_rng(io_bits * 10 + (adc or 0) + transpose)
    m, n, b = 256, 128, 6
    planes = rng.integers(-2, 3, size=(JSPEC.n_slices, m, n)).astype(np.int8)
    x = _x_q(rng, b, n if transpose else m, io_bits, wild=True)
    streamed = TR.streamed_input(torch.from_numpy(x), io_bits)
    got = TR.mvm_sliced_ref(torch.from_numpy(planes), streamed, TSPEC, io_bits, adc, transpose=transpose).numpy()
    x_jax = x if adc is not None else streamed.numpy()
    want = np.asarray(mvm_sliced(jnp.asarray(planes), jnp.asarray(x_jax), spec=JSPEC, io_bits=io_bits,
                                 adc_bits=adc, interpret=True, transpose=transpose))
    assert np.array_equal(got, want)
    if adc is not None:  # the plain version streams the same bits of the raw x_q
        raw = TR.mvm_sliced_ref(torch.from_numpy(planes), torch.from_numpy(x), TSPEC, io_bits, adc,
                                transpose=transpose).numpy()
        assert np.array_equal(raw, want)
