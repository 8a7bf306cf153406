"""The decode body's split over crossbar tiles, on the CPU: its plain mirror
(``ref.tile_terms`` / ``ref.fold_tiles``), its host-side planner
(``kernel.decode_plan``, with the blocks it launches) and the dispatch of K4
reads by shape (``kernel.body_for``).

Tolerance: none. Every comparison is bit for bit:
* the mirror against ``mvm_sliced_fused_ref`` (the function the kernel is
  held against) at every io width, ADC and with read noise: each tile's term
  is the same float, and the fold adds them one at a time in ascending tile
  order from 0, as the plain version does;
* any grouping of tiles and columns into blocks against the whole read: a
  block's terms, computed on its own rows and columns at its global tile and
  column offsets, are the whole read's;
* the mirror against the JAX package's ``mvm_sliced_fused_ref`` in the
  f32-exact regime (io 8, where every per-slice current and fold is exact,
  and the ideal ADC on digit planes in [-2, 2]), inputs from a numpy seed;
* the decode body's ADC (``adc_codes_exact``, the tensor-core body's
  arithmetic, which the decode body shares) against JAX's ``_adc`` at the
  clamp and on exact half-step ties.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.fixed_point import choose_frac_bits  # noqa: E402
from repro.core.mvm import _adc  # noqa: E402
from repro.core.slicing import DEFAULT_SPEC as JSPEC  # noqa: E402
from repro.kernels.sliced_mvm import ref as JR  # noqa: E402
from repro_torch.core.slicing import DEFAULT_SPEC as TSPEC  # noqa: E402
from repro_torch.kernels.sliced_mvm import kernel as K  # noqa: E402
from repro_torch.kernels.sliced_mvm import ops as TO  # noqa: E402
from repro_torch.kernels.sliced_mvm import ref as TR  # noqa: E402
from repro_torch.models.common import DeviceModel  # noqa: E402

SHAPES = [(128, 100), (128, 256), (320, 100), (320, 256)]  # one tile / a short last tile; ragged / whole N
# gemma-2b's five reads (four distinct shapes), as the serving path reads them
GEMMA_READS = [(2048, 2560), (2048, 2048), (2048, 16384), (2048, 16384), (16384, 2048)]
EDGE_SHAPES = [(320, 2048), (256, 100)]
NOISY = DeviceModel(read_noise=0.01, stuck_seed=3)


def _case(m, n, b, io_bits, seed, digit=8):
    rng = np.random.default_rng(seed)
    planes = rng.integers(-digit, digit, size=(TSPEC.n_slices, m, n)).astype(np.int8)
    x = rng.normal(size=(b, m)).astype(np.float32)
    xf = int(choose_frac_bits(jnp.asarray(x), word_bits=io_bits, margin_bits=1, clip_to_word=False))
    return torch.from_numpy(planes), torch.from_numpy(x), xf


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("adc", [9, 6, None])
@pytest.mark.parametrize("io_bits", [8, 12, 16])
def test_split_and_ordered_fold_equal_the_plain_read(io_bits, adc, noisy):
    dev = NOISY if noisy else None
    for i, (m, n) in enumerate(SHAPES):
        for b in (1, 2, 3, 4):
            planes, x, xf = _case(m, n, b, io_bits, seed=100 * i + b + io_bits)
            terms = TR.tile_terms(planes, x, xf, TSPEC, io_bits, adc, device=dev, tile0=2, col0=5)
            assert tuple(terms.shape) == (-(-m // 128), b, n)
            want = TR.mvm_sliced_fused_ref(planes, x, xf, TSPEC, io_bits, adc, device=dev, tile0=2, col0=5)
            assert torch.equal(TR.fold_tiles(terms), want), (m, n, b)


def _blocks(plan, M, N, bn=K.DECODE_BN):
    """Every block of ``plan`` as ((first column, end column), (first tile,
    end tile)), in the kernel's launch order (grid x over columns of ``bn``,
    grid y over groups of ``plan.group`` tiles)."""
    tiles = -(-M // 128)
    return [((cb * bn, min(N, (cb + 1) * bn)), (g * plan.group, min(tiles, (g + 1) * plan.group)))
            for g in range(plan.tile_groups) for cb in range(plan.col_blocks)]


def _by_blocks(plan, bn, planes, x, xf, adc, dev, tile0, col0, order):
    """The workspace as the kernel's blocks fill it, in the given block order:
    each block's tile terms on its own planes' rows and columns."""
    S, M, N = planes.shape
    ws = torch.full((-(-M // 128), x.shape[0], N), float("nan"))
    blocks = _blocks(plan, M, N, bn)
    for i in order(len(blocks)):
        (c0, c1), (k0, k1) = blocks[i]
        rows = slice(128 * k0, min(M, 128 * k1))
        ws[k0:k1, :, c0:c1] = TR.tile_terms(planes[:, rows, c0:c1].contiguous(), x[:, rows].contiguous(), xf, TSPEC,
                                            16, adc, device=dev, tile0=tile0 + k0, col0=col0 + c0)
    return ws


@pytest.mark.parametrize("adc", [9, None])
@pytest.mark.parametrize("bn,group", [(32, 1), (32, 2), (64, 1), (64, 3), (16, 4)])
def test_any_grouping_of_tiles_gives_the_same_bits(bn, group, adc):
    m, n, b = 640, 100, 3  # 5 tiles (groups of 2 and 3 leave a short last group), ragged N
    planes, x, xf = _case(m, n, b, 16, seed=bn + group)
    tiles = -(-m // 128)
    plan = K.DecodePlan(group, -(-n // bn), -(-tiles // group))
    whole = TR.tile_terms(planes, x, xf, TSPEC, 16, adc, device=NOISY, tile0=2, col0=5)
    rng = np.random.default_rng(bn * group)
    for order in (range, rng.permutation):  # launch order, and blocks finishing in any order
        ws = _by_blocks(plan, bn, planes, x, xf, adc, NOISY, 2, 5, order)
        assert torch.equal(ws, whole)
        want = TR.mvm_sliced_fused_ref(planes, x, xf, TSPEC, 16, adc, device=NOISY, tile0=2, col0=5)
        assert torch.equal(TR.fold_tiles(ws), want)


def test_a_fold_from_term_zero_or_in_pairs_is_another_float():
    # why the kernel folds from 0.f one tile at a time: the sign of a zero,
    # and the rounding of a pairwise sum
    neg_zero = torch.tensor([[[-0.0]], [[-0.0]]])
    assert torch.signbit(neg_zero[0] + neg_zero[1]).item()  # from term 0: -0
    assert not torch.signbit(TR.fold_tiles(neg_zero)).item()  # from 0: +0, the plain version's
    terms = torch.tensor([[[1.0]], [[2.0**-24]], [[2.0**-24]]])
    assert float(TR.fold_tiles(terms)) == 1.0  # each half-ulp add ties to even
    assert float(terms[0] + (terms[1] + terms[2])) != 1.0


@pytest.mark.parametrize("adc", [9, 6, None])
@pytest.mark.parametrize("m,n,b", [(128, 100, 1), (320, 256, 4), (256, 192, 3)])
def test_mirror_matches_the_jax_reference_on_f32_exact_inputs(m, n, b, adc):
    for io_bits, digit in ((8, 8), (16, 2)):
        if io_bits == 16 and adc is not None:
            continue  # finite ADC at io 16: JAX's f32 bit fold sums codes·2^t past 2^24 in another order
        planes, x, xf = _case(m, n, b, io_bits, seed=m + n + b, digit=digit)
        got = TR.fold_tiles(TR.tile_terms(planes, x, xf, TSPEC, io_bits, adc)).numpy()
        want = np.asarray(JR.mvm_sliced_fused_ref(jnp.asarray(planes.numpy()), jnp.asarray(x.numpy()),
                                                  jnp.int32(xf), JSPEC, io_bits, adc))
        assert np.array_equal(got, want), (io_bits, digit)


@pytest.mark.parametrize("adc", [9, 6])
@pytest.mark.parametrize("bits", sorted(set(TSPEC.bits_lsb_first)))
def test_decode_epilogue_at_the_clamp_and_on_ties(bits, adc):
    # the decode body's accumulator starts from 0x4B400000 and ends at
    # 0x4B400000 + c; adc_codes_exact is that arithmetic. Currents and
    # offsets at the ±half clamp and on exact half steps, against JAX's ADC
    e = 7 + bits - adc
    step, inv, half = 2.0**e, 2.0**-e, 1 << (adc - 1)
    fs = float(128 * (1 << (bits - 1)))
    k = np.arange(half - 3, half + 4)
    c = np.concatenate([k * step, k * step + step / 2, -(k * step), -(k * step + step / 2)]).astype(np.int32)
    c = c[np.abs(c) <= 128 * 128]
    acc = torch.from_numpy(c) + TR.ADC_MAGIC_BITS  # the dp4a accumulator's bits
    assert torch.equal((acc.view(torch.float32) - TR.ADC_MAGIC).to(torch.int32), torch.from_numpy(c))
    for off in (None, np.full(c.shape, np.float32(step / 2)), np.full(c.shape, np.float32(-step / 2))):
        got = TR.adc_codes_exact(torch.from_numpy(c), None if off is None else torch.from_numpy(off), inv, half)
        col_sum = c.astype(np.float32) + (0.0 if off is None else off)
        want = (np.asarray(_adc(jnp.asarray(col_sum, jnp.float32), fs, adc)) / np.float32(step)).astype(np.int32)
        assert np.array_equal(got.numpy(), want)
        assert int(got.abs().max()) == half


@pytest.mark.parametrize("b", [1, 2, 3, 4])
@pytest.mark.parametrize("m,n", [*dict.fromkeys(GEMMA_READS), *EDGE_SHAPES])
def test_decode_plan_covers_every_tile_and_column_once(m, n, b):
    plan = K.decode_plan(b, m, n, TSPEC.n_slices)
    tiles = -(-m // 128)
    hits = np.zeros((tiles, n), dtype=np.int32)
    for (c0, c1), (k0, k1) in _blocks(plan, m, n):
        assert c1 - c0 <= K.DECODE_BN and k1 - k0 <= plan.group and c0 < c1 and k0 < k1
        hits[k0:k1, c0:c1] += 1
    assert (hits == 1).all()
    if (m, n) in GEMMA_READS:
        assert plan.col_blocks * plan.tile_groups >= 2 * K.H100_SMS


def test_decode_plan_refuses_what_the_body_does_not_take():
    with pytest.raises(ValueError, match="S·B"):
        K.decode_plan(5, 2048, 2048, 16)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 6])
def test_dispatch_is_by_shape_only(b, transpose):
    body = K.body_for(b, transpose)
    if b > K.DECODE_MAX_B:
        assert body == "mma" and not K.uses_decode_body(b)
    else:
        assert body == ("dp4a" if transpose else "decode") and K.uses_decode_body(b)
    name = K.instance_name(transpose, 16, body=body)
    assert name == f"{'transpose_' if transpose else ''}io16{'' if body == 'mma' else '_' + body}"
    # CPU tensors take the plain version; the kernel wrapper takes CUDA tensors only
    planes, x, xf = _case(128, 100, b, 16, seed=b)
    xt = torch.randn(b, 100) if transpose else x
    launches = (K.mvm_sliced_fused.launches, K.mvm_sliced_fused.transpose_launches)
    got = TO.mvm_sliced_fused(planes, xt, xf, TSPEC, adc_bits=9, transpose=transpose)
    assert torch.equal(got, TR.mvm_sliced_fused_ref(planes, xt, xf, TSPEC, 16, 9, transpose=transpose))
    assert (K.mvm_sliced_fused.launches, K.mvm_sliced_fused.transpose_launches) == launches
    with pytest.raises(ValueError, match="CUDA"):
        K.mvm_sliced_fused(planes, xt, torch.tensor([xf], dtype=torch.int32), spec=TSPEC, transpose=transpose)
