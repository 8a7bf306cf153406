"""The update's two other rounding sources in the port against ``repro``:
``rng_mode="grid"`` (``jax.random.uniform``'s stream, the draw of runs from
before the counter draw) and ``rng_mode="hw"`` (the TPU's hardware PRNG in
the reference; the port's own Philox tile stream on the card). Inputs are
made with numpy from a seed and passed to both packages.

Tolerance: grid is held bit for bit to the in-process JAX, never to the
reference's stored CRCs (which fail in the reference itself): the draw, the
stochastic quantize, the K1 plain versions against the reference's CPU path
and its Pallas kernel in interpret mode, on f32-exact operands with a
power-of-two ``lr`` (``tests/test_torch_opa.py`` says why), the dense
device update and ``update_split``. With write noise, JAX and torch differ
by up to 3 ulps in ``log1p``/``cos``, so at most ``FLIPS`` updates may move
by one grid LSB, as in ``tests/test_torch_device.py``; a lossless train
step meets the bounds of ``tests/test_torch_train_slice.py``. hw has no bit
target (the reference's draw is the TPU's): its CPU dispatch raises as the
reference's does, dense leaves take the counter draw bit for bit, and its
plain stream ``hw_uniform_ref`` is held to its definition and to
statistics (unbiased rounding within 4σ).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.extend.random import threefry_2x32  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import fixed_point as JF  # noqa: E402
from repro.core import slicing as JS  # noqa: E402
from repro.data import SyntheticLMDataset as JData  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.common import DeviceModel as JDev  # noqa: E402
from repro.optim import PantherConfig as JPC  # noqa: E402
from repro.optim import panther as jpan  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro.kernels.sliced_opa import ops as jopa  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.core import fixed_point as TF  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import slicing as TS  # noqa: E402
from repro_torch.data import SyntheticLMDataset as TData  # noqa: E402
from repro_torch.kernels import sliced_opa as topa  # noqa: E402
from repro_torch.kernels.sliced_opa import ref as topa_ref  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models.common import DeviceModel as TDev  # noqa: E402
from repro_torch.optim import PantherConfig as TPC  # noqa: E402
from repro_torch.optim import panther as tpan  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

SPEC = TS.DEFAULT_SPEC
JSPEC = JS.DEFAULT_SPEC
FLIPS = 2
PHYSICS = {
    "ideal": {},
    "asym_stuck": dict(asym_up=1.2, asym_down=0.8, stuck_frac=0.05, stuck_seed=3),
    "all": dict(write_noise=4.0, asym_up=1.2, asym_down=0.8, stuck_frac=0.05, stuck_seed=3),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b):
    a, b = np.asarray(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert np.array_equal(a, b), int((a != b).sum())


def _plane_values(planes):
    p = _np(planes).astype(np.int64)
    acc = p[-1]
    for s in range(p.shape[0] - 2, -1, -1):
        acc = acc * 16 + p[s]
    return acc


def _assert_flips(want, got, allowed):
    d = np.abs(_plane_values(want) - _plane_values(got))
    assert d.max() <= 1 and int((d > 0).sum()) <= allowed, (int(d.max()), int((d > 0).sum()))


def _layer_major(planes):
    """Planes [S, *stack, M, N] as the port stores them (layer-major)."""
    lead = planes.ndim - 3
    return _t(np.ascontiguousarray(np.moveaxis(planes, 0, lead))).movedim(lead, 0)


def _devices(**kw):
    return (JDev(**kw), TDev(**kw)) if kw else (None, None)


# ------------------------------- the grid draw --------------------------------


def test_the_port_copies_the_partitionable_threefry_stream():
    # core.prng.uniform reproduces this stream; JAX's other one differs
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("shape", [(5, 7), (3, 40, 24), (9,), (1, 130)])
def test_uniform_bit_identical_to_jax(shape):
    for key_j, key_t in ((jax.random.PRNGKey(5), prng.PRNGKey(5)),
                         (jax.random.fold_in(jax.random.PRNGKey(11), 3), prng.fold_in(prng.PRNGKey(11), 3))):
        _eq(jax.random.uniform(key_j, shape, jnp.float32), prng.uniform(key_t, shape))
        _eq(JF.rounding_noise(key_j, shape, "grid"), TF.rounding_noise(key_t, shape, "grid"))


@pytest.mark.parametrize("offset,shape", [(0, (7, 9)), (40, (3, 11)), (613, (1,)), (900, (2, 50))])
def test_uniform_window_at_an_offset_is_a_slice_of_the_whole_draw(offset, shape, monkeypatch):
    whole = np.asarray(jax.random.uniform(jax.random.PRNGKey(2), (1000,), jnp.float32))
    monkeypatch.setattr(prng, "_CHUNK", 7)  # ragged chunks
    got = prng.uniform(prng.PRNGKey(2), shape, offset=offset)
    n = int(np.prod(shape))
    _eq(whole[offset:offset + n].reshape(shape), got)
    # multiples of 2^-23 in [0, 1)
    v = _np(got).astype(np.float64)
    assert v.min() >= 0.0 and v.max() < 1.0 and np.array_equal(v * 2**23, np.floor(v * 2**23))


@pytest.mark.parametrize("hi", [1, 7, 2**31 + 3, 2**32 - 1])
def test_threefry_lanes_match_jax_at_counters_past_32_bits(hi):
    rng = np.random.default_rng(hi % 1000)
    lo = rng.integers(0, 2**32, 16, dtype=np.uint64).astype(np.uint32)
    his = np.full(16, hi, np.uint32)
    key = (0x12345678, 0x9ABCDEF0)
    want = np.asarray(threefry_2x32(jnp.asarray(key, jnp.uint32), jnp.asarray(np.concatenate([his, lo]))))
    b0, b1 = prng.threefry2x32_lanes(key, torch.from_numpy(his.astype(np.int64)),
                                     torch.from_numpy(lo.astype(np.int64)))
    _eq(want, torch.cat([b0, b1]).to(torch.int64).numpy().astype(np.uint32))


@pytest.mark.parametrize("stacked", [False, True])
def test_grid_quantize_bit_identical(stacked):
    rng = np.random.default_rng(4)
    shape = (3, 24, 40) if stacked else (24, 40)
    x = (rng.normal(size=shape) * 1e-4).astype(np.float32)
    x.flat[:4] = [0.0, 1e30, -1e30, 3.0 * 2**-21]
    for f in (20, 31):
        want = JF.quantize(jnp.asarray(x), f, stochastic=True, key=jax.random.PRNGKey(9), rng_mode="grid")
        _eq(want, TF.quantize(_t(x), f, stochastic=True, key=prng.PRNGKey(9), rng_mode="grid"))


# ------------------------------- K1 under grid --------------------------------


def _opa_case(seed, stack=(2,), m=128, n=96, t=32):
    """Canonical planes and f32-exact operands: the contraction is exact in
    both packages and in any order."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-(2**27), 2**27, (*stack, m, n)).astype(np.int32)
    planes = np.asarray(JS.slice_weights(jnp.asarray(q), JSPEC))
    x = (rng.integers(-4, 5, (*stack, t, m)) * 0.125).astype(np.float32)
    dh = (rng.integers(-4, 5, (*stack, t, n)) * 2.0**-5).astype(np.float32)
    return planes, x, dh


@pytest.mark.parametrize("physics", list(PHYSICS))
@pytest.mark.parametrize("stack", [(), (3,)])
def test_opa_fused_update_grid_matches_the_reference(stack, physics):
    planes, x, dh = _opa_case(7 + len(stack), stack)
    jd, td = _devices(**PHYSICS[physics])
    allowed = FLIPS if td is not None and td.write_noise > 0 else 0
    lr, f = 2.0**-6, 12
    args = (jnp.asarray(planes), jnp.asarray(x), jnp.asarray(dh), jnp.float32(lr), f, JSPEC)
    key_j = jax.random.PRNGKey(21)
    cpu = np.asarray(jopa.opa_fused_update(*args, stochastic=True, key=key_j, rng_mode="grid", use_kernel=False,
                                           device=jd))
    kern = np.asarray(jopa.opa_fused_update(*args, stochastic=True, key=key_j, rng_mode="grid", use_kernel=True,
                                            interpret=True, device=jd))
    pt = _layer_major(planes)
    topa.opa_fused_update(pt, _t(x), _t(dh), lr, f, SPEC, stochastic=True, key=prng.PRNGKey(21), rng_mode="grid",
                          device=td)
    for want in (cpu, kern):
        _assert_flips(want, pt, allowed)
    _assert_flips(cpu, topa_ref.opa_fused_update_ref(_t(planes), _t(x), _t(dh), lr, f, SPEC, stochastic=True,
                                                     key=prng.PRNGKey(21), rng_mode="grid", device=td), allowed)
    assert (_plane_values(pt) != _plane_values(planes)).mean() > 0.3  # the update moved the weights


def test_grid_layer_draws_from_the_leaf_stream_at_its_offset():
    # layer l of a stacked leaf: the leaf key (no fold_in), flat offset l·M·N
    planes, x, dh = _opa_case(9, (3,))
    lr, f = 2.0**-6, 12
    want = np.asarray(jopa.opa_fused_update(jnp.asarray(planes), jnp.asarray(x), jnp.asarray(dh), jnp.float32(lr),
                                            f, JSPEC, stochastic=True, key=jax.random.PRNGKey(4), rng_mode="grid",
                                            use_kernel=False))
    M, N = planes.shape[-2:]
    words = prng.counter_key_scalars(prng.PRNGKey(4))
    for l in range(3):
        one = topa_ref.opa_fused_ref(_t(planes[:, l]), _t(x[l]), _t(dh[l]), lr, f, SPEC, words, rng_mode="grid",
                                     offset=l * M * N)
        _eq(want[:, l], one)
    assert topa_ref.layer_rounding(prng.PRNGKey(4), 2, True, "grid", M, N) == (words, 2 * M * N)


@pytest.mark.parametrize("physics", list(PHYSICS)[1:])
def test_opa_device_update_grid_matches_the_reference(physics):
    planes, x, dh = _opa_case(11, (2,), m=200, n=64)
    g = np.einsum("ltm,ltn->lmn", x.astype(np.float64), dh.astype(np.float64)).astype(np.float32)  # exact
    jd, td = _devices(**PHYSICS[physics])
    want = np.asarray(jopa.opa_device_update(jnp.asarray(planes), jnp.asarray(g), jnp.float32(2.0**-6), 12, JSPEC,
                                             device=jd, stochastic=True, key=jax.random.PRNGKey(6),
                                             rng_mode="grid", use_kernel=False))
    pt = _layer_major(planes)
    topa.opa_device_update(pt, _t(g), 2.0**-6, 12, SPEC, device=td, stochastic=True, key=prng.PRNGKey(6),
                           rng_mode="grid")
    _assert_flips(want, pt, FLIPS if td.write_noise > 0 else 0)
    with pytest.raises(ValueError, match="hw"):
        topa.opa_device_update(pt, _t(g), 2.0**-6, 12, SPEC, device=td, stochastic=True, key=prng.PRNGKey(6),
                               rng_mode="hw")


# ------------------------------ update_split, train ---------------------------

WIDE = dict(d_model=128, n_heads=4, head_dim=32, n_kv_heads=1, d_ff=256, vocab=256,
            n_layers=2, pattern=(("dense", 2),))
CFG_J = dataclasses.replace(jconfigs.get_smoke("gemma_2b"), dtype=jnp.float32, **WIDE)
CFG_T = dataclasses.replace(tconfigs.get_smoke("gemma_2b"), dtype=torch.float32, **WIDE)
B, SEQ, LR = 2, 16, 1e-2
LOSS_RTOL, GNORM_RTOL, DIGITAL_RTOL, WEIGHT_RTOL = 1e-5, 1e-4, 1e-5, 1e-5
LSB_SHARE = 0.005


def _state_from_jax(state):
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return convert.train_state_from_jax(int(state.step), np_tree(state.digital), np_tree(state.sliced),
                                        state.rng, device="cpu")


def _by_path(t, is_leaf=None):
    return {jcommon.path_str(p): v for p, v in jax.tree_util.tree_flatten_with_path(t, is_leaf=is_leaf)[0]}


def _t_by_path(t):
    return {tcommon.path_str(p): v for p, v in tree.leaves_with_path(t) if v is not None}


def _sliced_j(t):
    return _by_path(t, is_leaf=lambda x: isinstance(x, jpan.SlicedTensor))


@pytest.fixture(scope="module")
def start():
    return jstep.train_state_init(CFG_J, JPC(crs_every=2), jax.random.PRNGKey(0))


def _given_grads(rng, params_j):
    """Dense f32 gradients for every leaf, f32-exact operands for the
    operand leaves."""
    grads_j = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32) * 1e-2), params_j)
    for group in grads_j["groups"]:
        for sub, keys in (("attn", ("wqkv", "wo")), ("mlp", ("wi_gate", "wi_up", "wo"))):
            for k in keys:
                L, M, N = group[sub][k].shape
                x = rng.integers(-4, 5, (L, 24, M)) * 0.125
                dh = rng.integers(-4, 5, (L, 24, N)) * 2.0**-5
                group[sub][k] = jcommon.OuterProductGrad(jnp.asarray(x, jnp.float32), jnp.asarray(dh, jnp.float32))
    return grads_j


def _grads_to_port(grads_j):
    def one(g):
        if isinstance(g, jcommon.OuterProductGrad):
            return tcommon.OuterProductGrad(torch.from_numpy(np.array(g.x)), torch.from_numpy(np.array(g.dh)))
        return torch.from_numpy(np.array(g))

    return jax.tree.map(one, grads_j, is_leaf=lambda x: isinstance(x, jcommon.OuterProductGrad))


@pytest.mark.parametrize("step", [0, 1])  # crs_every=2: CRS runs after step 1
def test_update_split_grid_on_given_gradients_bit_identical(start, step):
    rng = np.random.default_rng(30 + step)
    grads_j = _given_grads(rng, jpan.materialize_split(start.digital, start.sliced, JPC()))
    cfg_j, cfg_t = JPC(crs_every=2, rng_mode="grid"), TPC(crs_every=2, rng_mode="grid")
    dj, sj = jpan.update_split(grads_j, start.digital, start.sliced, jnp.int32(step), jnp.float32(LR), cfg_j,
                               rng=start.rng)
    st = _state_from_jax(start)
    dt, stt = tpan.update_split(_grads_to_port(grads_j), st.digital, st.sliced, step, LR, cfg_t, rng=st.rng)
    want_s = _sliced_j(sj)
    for path, s in _t_by_path(stt).items():
        assert np.array_equal(np.asarray(want_s[path].planes), _np(s.planes)), path
    want_d = _by_path(dj)
    for path, d in _t_by_path(dt).items():
        assert np.array_equal(np.asarray(want_d[path]), _np(d)), path
    # grid draws other bits than counter
    _, sc = jpan.update_split(grads_j, start.digital, start.sliced, jnp.int32(step), jnp.float32(LR),
                              JPC(crs_every=2), rng=start.rng)
    assert not np.array_equal(np.asarray(_sliced_j(sc)["embed"].planes), np.asarray(want_s["embed"].planes))


def test_lossless_train_step_under_grid_matches_jax(start):
    step_j = jax.jit(jstep.make_train_step(CFG_J, JPC(crs_every=2, rng_mode="grid"), jsched.constant(LR)))
    step_t = tstep.make_train_step(CFG_T, TPC(crs_every=2, rng_mode="grid"), tsched.constant(LR), remat="none")
    st = _state_from_jax(start)
    start_v = {p: _plane_values(s.planes) for p, s in _t_by_path(st.sliced).items()}
    sj, mj = step_j(start, JData(CFG_J.vocab, SEQ, B).batch(0))
    st, mt = step_t(st, TData(CFG_T.vocab, SEQ, B, device="cpu").batch(0))
    mj, mt = {k: float(v) for k, v in mj.items()}, {k: float(v) for k, v in mt.items()}
    assert abs(mt["loss"] - mj["loss"]) <= LOSS_RTOL * abs(mj["loss"]), (mj, mt)
    assert abs(mt["grad_norm"] - mj["grad_norm"]) <= GNORM_RTOL * mj["grad_norm"], (mj, mt)
    want_s = _sliced_j(sj.sliced)
    for path, s in _t_by_path(st.sliced).items():
        vj, vt = _plane_values(want_s[path].planes), _plane_values(s.planes)
        assert np.abs(vj - vt).max() <= 1 + np.abs(vj - start_v[path]).max() * 2.0**-18, path
        if path != "embed":
            assert (np.abs(vj - vt) > 1).mean() <= LSB_SHARE, path
        assert (vt != start_v[path]).mean() > 0.5  # the step did move the weights
    want_d = _by_path(sj.digital)
    for path, d in _t_by_path(st.digital).items():
        np.testing.assert_allclose(_np(d), np.asarray(want_d[path]), rtol=DIGITAL_RTOL, atol=1e-7)


# ----------------------------------- hw ---------------------------------------


def test_hw_refuses_the_cpu_as_the_reference_does():
    planes, x, dh = _opa_case(13, ())
    with pytest.raises(ValueError, match="hw"):  # the reference's own CPU dispatch
        jopa.opa_fused_update(jnp.asarray(planes), jnp.asarray(x), jnp.asarray(dh), jnp.float32(0.1), 20, JSPEC,
                              stochastic=True, key=jax.random.PRNGKey(0), rng_mode="hw", use_kernel=False)
    pt = _t(planes)
    with pytest.raises(ValueError, match="hw"):
        topa.opa_fused_update(pt, _t(x), _t(dh), 0.1, 20, SPEC, stochastic=True, key=(0, 1), rng_mode="hw")
    with pytest.raises(ValueError, match="hw"):
        topa.opa_fused(pt, _t(x), _t(dh), 0.1, 20, SPEC, key_words=(0, 1), rng_mode="hw")
    with pytest.raises(ValueError, match="hw"):
        topa_ref.opa_fused_update_ref(pt, _t(x), _t(dh), 0.1, 20, SPEC, stochastic=True, key=(0, 1), rng_mode="hw")
    assert torch.equal(pt, _t(planes))
    # deterministic rounding draws nothing: hw then runs anywhere
    topa.opa_fused_update(pt, _t(x), _t(dh), 0.1, 20, SPEC, rng_mode="hw")
    for mode in ("hw", "other"):
        with pytest.raises(ValueError, match="rng_mode"):
            TF.rounding_noise(prng.PRNGKey(0), (4, 4), mode)


def test_hw_dense_leaves_take_the_counter_draw_as_in_the_reference():
    rng = np.random.default_rng(17)
    params = {"a": rng.normal(size=(48, 40)).astype(np.float32) * 0.1,
              "b": rng.normal(size=(2, 16, 24)).astype(np.float32) * 0.1,
              "v": rng.normal(size=(24,)).astype(np.float32)}
    grads = {k: (rng.normal(size=v.shape) * 1e-2).astype(np.float32) for k, v in params.items()}
    dj, sj = jpan.init_split(jax.tree.map(jnp.asarray, params), JPC())
    dj, sj = jpan.update_split(jax.tree.map(jnp.asarray, grads), dj, sj, jnp.int32(0), jnp.float32(LR),
                               JPC(rng_mode="hw"), rng=jax.random.PRNGKey(3))
    dt, st = tpan.init_split({k: _t(v) for k, v in params.items()}, TPC())
    dt, st = tpan.update_split({k: _t(v) for k, v in grads.items()}, dt, st, 0, LR, TPC(rng_mode="hw"),
                               rng=prng.PRNGKey(3))
    for k in ("a", "b"):
        _eq(sj[k].planes, st[k].planes)
    _eq(dj["v"], dt["v"])
    dt2, st2 = tpan.init_split({k: _t(v) for k, v in params.items()}, TPC())
    tpan.update_split({k: _t(v) for k, v in grads.items()}, dt2, st2, 0, LR, TPC(rng_mode="counter"),
                      rng=prng.PRNGKey(3))
    for k in ("a", "b"):
        assert torch.equal(st[k].planes, st2[k].planes)


@pytest.mark.parametrize("m,n", [(128, 256), (320, 100), (100, 336), (2, 6)])
def test_hw_uniform_ref_is_on_the_24_bit_grid_and_follows_its_definition(m, n):
    k0, k1 = prng.counter_key_scalars(prng.fold_in(prng.PRNGKey(5), 2))
    u = topa_ref.hw_uniform_ref(k0, k1, m, n)
    assert u.shape == (m, n) and u.dtype == torch.float32
    v = _np(u).astype(np.float64)
    assert v.min() >= 0.0 and v.max() < 1.0 and np.array_equal(v * 2**24, np.floor(v * 2**24))
    # one cell from the definition, on the host: the seed of its tile, then
    # word e % 4 of Philox counter (e // 4, 0, 0, 0)
    bm, bn = topa_ref.hw_tiles(m, n)
    r, c = m - 1, n - 1
    tid = (r // bm) * (n // bn) + c // bn
    seed = TF._fmix32_host(k0 ^ TF._fmix32_host(k1 ^ tid)) & 0xFFFFFFFF
    e = (r % bm) * bn + c % bn
    words = topa_ref.philox4x32_10((e // 4, 0, 0, 0), seed, 0)
    assert float(u[r, c]) == (words[e % 4] >> 8) * 2.0**-24


def test_philox_known_answers():
    # Random123's known-answer vectors of Philox4x32-10
    cases = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        lanes = tuple(torch.tensor([w], dtype=torch.int64) for w in ctr)
        assert tuple(int(w) for w in topa_ref.philox4x32_10(lanes, *key)) == want
        assert topa_ref.philox4x32_10(ctr, *key) == want


def test_hw_rounding_is_unbiased():
    m, n = 256, 512
    y = torch.full((m, n), 0.3711)
    ups = torch.stack([torch.floor(y + topa_ref.hw_uniform_ref(k, -k, m, n)) for k in range(4)])
    p, cells = 0.3711, ups.numel()
    assert abs(float(ups.mean()) - p) <= 4.0 * np.sqrt(p * (1 - p) / cells)


def test_hw_draw_is_the_same_under_any_row_window_of_one_tile_grid():
    full = topa_ref.hw_uniform_ref(3, 4, 256, 512)
    # a taller block with the same (bm, bn) tile and N: its first rows are the same cells
    assert topa_ref.hw_tiles(256, 512) == topa_ref.hw_tiles(512, 512)
    assert torch.equal(topa_ref.hw_uniform_ref(3, 4, 512, 512)[:256], full)
    # a window of rows drawn alone (write_rows' r0 chunks) is the slice of the block's draw
    for r0, rows in ((0, 256), (37, 90), (128, 128), (250, 6)):
        assert torch.equal(topa_ref.rounding_u((3, 4), "hw", r0, rows, 512, M=256), full[r0:r0 + rows])


def test_hw_streams_differ_by_key_and_by_tile():
    a = topa_ref.hw_uniform_ref(3, 4, 256, 512)
    assert not torch.equal(a, topa_ref.hw_uniform_ref(3, 5, 256, 512))
    assert not torch.equal(a, topa_ref.hw_uniform_ref(-7, 4, 256, 512))
    bm, bn = topa_ref.hw_tiles(256, 512)  # (128, 256): 4 tiles
    tiles = [a[i:i + bm, j:j + bn] for i in (0, bm) for j in (0, bn)]
    assert all(not torch.equal(s, t) for k, s in enumerate(tiles) for t in tiles[k + 1:])
    assert float((a[:bm, :bn] == a[:bm, bn:]).float().mean()) < 1e-3
