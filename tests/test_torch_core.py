"""The port's core numerics against ``repro.core``: fixed point and bit
slicing, bit-identical (inputs made with numpy from a seed, passed to both).

Tolerance: none — every check here is ``array_equal``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import fixed_point as JF  # noqa: E402
from repro.core import slicing as JS  # noqa: E402
from repro.kernels import common as JK  # noqa: E402
from repro.optim import panther as jpan  # noqa: E402
from repro_torch.core import fixed_point as TF  # noqa: E402
from repro_torch.core import slicing as TS  # noqa: E402
from repro_torch.kernels import common as TK  # noqa: E402
from repro_torch.optim import panther as tpan  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def test_exp2i_bit_identical_over_normal_range():
    e = np.arange(-126, 128, dtype=np.int32)
    want = np.asarray(JF.exp2i(jnp.asarray(e))).view(np.int32)
    got = TF.exp2i(_t(e)).numpy().view(np.int32)
    assert np.array_equal(want, got)
    assert TF.exp2i(3).item() == 8.0 and TF.exp2i(-126).item() == 2.0**-126


def _edge_values():
    """Powers of two, a few ulps above and below them, and all zeros."""
    vals = []
    for k in range(-60, 61, 3):
        b = np.float32(2.0) ** k
        vals.append(b)
        up = down = b
        for _ in range(3):
            up = np.nextafter(up, np.float32(np.inf))
            down = np.nextafter(down, np.float32(0))
            vals += [up, down]
    return vals


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("word_bits,margin,clip", [(32, 2, True), (16, 1, False)])
def test_choose_frac_bits_edge_cases(dtype, word_bits, margin, clip):
    # the exponent of a whole read: values just above/below a power of two
    # must land on the reference's side of it
    rng = np.random.default_rng(0)
    cases = [np.zeros(4, np.float32)]
    for v in _edge_values():
        cases.append(np.array([v, -v / 3, v / 7], np.float32))
    cases += [rng.normal(size=16).astype(np.float32) * s for s in (1e-3, 1.0, 37.0)]
    for x in cases:
        xj = jnp.asarray(x).astype(jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(x)
        xt = _t(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
        want = int(JF.choose_frac_bits(xj, word_bits, margin, clip))
        got = TF.choose_frac_bits(xt, word_bits, margin, clip)
        assert got.dtype == torch.int32 and got.dim() == 0
        assert int(got) == want, (x, want, int(got))


def test_quantize_bit_identical_with_saturation():
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(3, 64, 48)) * 0.3).astype(np.float32)
    f = JF.choose_frac_bits(jnp.asarray(w))
    assert int(TF.choose_frac_bits(_t(w))) == int(f)
    assert np.array_equal(np.asarray(JF.quantize(jnp.asarray(w), f)), TF.quantize(_t(w), int(f)).numpy())
    # the f32 clip at 2^31-1 lands on 2^31: XLA saturates the convert
    big = np.array([1e10, -1e10, 3e9, 2.5, -2.5, 0.5], np.float32)
    for wb in (32, 16):
        want = np.asarray(JF.quantize(jnp.asarray(big), 0, word_bits=wb))
        assert np.array_equal(want, TF.quantize(_t(big), 0, word_bits=wb).numpy())
    q = np.arange(-5, 6, dtype=np.int32) * 1000
    assert np.array_equal(np.asarray(JF.dequantize(jnp.asarray(q), 7)), TF.dequantize(_t(q), 7).numpy())


@pytest.mark.parametrize("shape", [(64, 48), (3, 64, 48)])
def test_slicing_round_trip_bit_identical(shape):
    rng = np.random.default_rng(2)
    spec = JS.DEFAULT_SPEC
    lim = spec.canonical_limit
    q = rng.integers(-lim, lim + 1, size=shape, dtype=np.int64).astype(np.int32)
    q.flat[:4] = [lim, -lim, 0, -1]
    pj = np.asarray(JS.slice_weights(jnp.asarray(q), spec))
    pt = TS.slice_weights(_t(q), TS.DEFAULT_SPEC)
    assert pt.dtype == torch.int8 and np.array_equal(pj, pt.numpy())
    assert np.array_equal(np.asarray(JS.unslice_weights(jnp.asarray(pj), spec)),
                          TS.unslice_weights(pt, TS.DEFAULT_SPEC).numpy())
    # dirty planes (carry headroom used): the float dequantize path
    dirty = rng.integers(-16, 17, size=(spec.n_slices, *shape)).astype(np.int8)
    for f in (0, 17, 30):
        assert np.array_equal(np.asarray(JS.dequantize_planes(jnp.asarray(dirty), f, spec)),
                              TS.dequantize_planes(_t(dirty), f, TS.DEFAULT_SPEC).numpy())


def test_slice_spec_mirrors_reference():
    for bits in ((4, 4, 4, 6, 6, 5, 5, 5), (6,) * 8, (8, 2, 5)):
        a, b = JS.SliceSpec(bits), TS.SliceSpec(bits)
        assert (a.plane_max, a.canonical_limit, a.word_bits, a.name()) == \
               (b.plane_max, b.canonical_limit, b.word_bits, b.name())
    with pytest.raises(ValueError):
        TS.SliceSpec((9, 4))


def test_init_split_stacked_leaf_uses_group_wide_scale():
    # one frac_bits for the whole [L, M, N] group: a per-layer scale would
    # give other planes; layer 1 is 8x smaller so its own scale would differ
    rng = np.random.default_rng(3)
    w = rng.normal(size=(2, 64, 96)).astype(np.float32) * 0.2
    w[1] *= 0.125
    params = {"groups": [{"mlp": {"wi_up": w}}], "norm": np.zeros(64, np.float32)}
    pj = {"groups": [{"mlp": {"wi_up": jnp.asarray(w)}}], "norm": jnp.zeros(64)}
    dj, sj = jpan.init_split(pj)
    pt = {"groups": [{"mlp": {"wi_up": _t(w)}}], "norm": _t(params["norm"])}
    dt, st = tpan.init_split(pt)
    a, b = sj["groups"][0]["mlp"]["wi_up"], st["groups"][0]["mlp"]["wi_up"]
    assert tuple(b.planes.shape) == np.asarray(a.planes).shape == (8, 2, 64, 96)
    assert np.array_equal(np.asarray(a.planes), b.planes.numpy())
    assert int(a.frac_bits) == int(b.frac_bits)
    assert dt["groups"][0]["mlp"]["wi_up"] is None and st["norm"] is None
    # per-layer planes come out contiguous once S moves behind the stack
    planes, frac = tpan._fid_leaves(b, (2,))
    assert planes[1].is_contiguous() and tuple(frac.shape) == (2,)
    dense = tpan.materialize_split(dt, st)
    want = np.asarray(jpan.materialize_split(dj, sj)["groups"][0]["mlp"]["wi_up"])
    assert np.array_equal(want, dense["groups"][0]["mlp"]["wi_up"].numpy())


@pytest.mark.parametrize("dim,pref,granule", [(1, 8, 8), (24, 8, 8), (20, 16, 4), (17, 16, 4),
                                              (384, 256, 128), (1000, 256, 128), (2560, 256, 128)])
def test_pick_block_mirrors_reference(dim, pref, granule):
    assert TK.pick_block(dim, pref, granule) == JK.pick_block(dim, pref, granule)
