"""The device-physics slice of the port against the JAX package: the frozen
device patterns and the counter Gaussian, the write physics of the update
(asymmetry, write noise, stuck cells) on operand and dense gradients, the
read noise, the reads at ``io_bits`` 8 and 12, the int-input read (K5), the
optimizer's device branches and whole train steps on a non-ideal device.
Inputs are made with numpy from a seed and passed to both packages; the
reference's update runs through its jnp oracle (``use_kernel=False``).

Tolerances, and why:
* ``device_pattern_words``, the stuck-cell masks, the reads at io 8 and 12,
  K5 on f32-exact inputs against the reference's interpret-mode kernel: bit
  for bit (integer hashes and exact sums).
* ``counter_gauss`` and everything drawn from it (``counter_gauss_array``,
  the read offsets): within ``GAUSS_ULPS`` = 4 f32 ulps. XLA's and torch's
  CPU ``log1p``/``cos`` differ in their last bits (3 ulps at most seen, on
  ~8% of draws).
* The update under write noise: those ulps move ``σ_w · g`` by up to ``σ_w
  · 4 · 2^-23 · |g|`` grid LSB, so an update whose analog value lies that
  close to a rounding boundary may round the other way: a ±1 LSB flip. At
  ``σ_w = 4e5`` (``write_device``) at most ``FLIP_SHARE`` = 1% of the
  updates flip, by one LSB; at the small ``σ_w = 4`` of the update tests
  the move is below ``2^-18`` LSB and at most ``FLIPS`` = 2 elements of a
  case may flip. Without write noise: bit for bit.
* Noisy reads at finite ADC: an offset ulp can move a column current across
  an ADC rounding boundary; at most ``FLIP_SHARE`` of the outputs differ.
  At the ideal ADC within ``1e-6 · (1 + max|out|)`` (offset ulps times
  ``2^(io_bits-1) - 1``).
* Whole train steps: as ``tests/test_torch_train_slice.py`` holds them after
  its second step, after each step here (the deposit saturates planes that
  the noisy update drives to their rails, so a one-LSB flip can carry into a
  higher plane from the first step on), with the write noise at ``σ_w =
  4e4``, where its ulps move an update by less than 0.02 LSB; adc9 steps
  read by read.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import fixed_point as JF  # noqa: E402
from repro.core import mvm as jmvm  # noqa: E402
from repro.core import slicing as JS  # noqa: E402
from repro.data import SyntheticLMDataset as JData  # noqa: E402
from repro.kernels.sliced_mvm import ops as jmvm_ops  # noqa: E402
from repro.kernels.sliced_mvm import ref as jmvm_ref  # noqa: E402
from repro.kernels.sliced_opa import ops as jopa  # noqa: E402
from repro.kernels.sliced_opa import ref as jopa_ref  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.optim import PantherConfig as JPC  # noqa: E402
from repro.optim import panther as jpan  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.plan import default_rules as jrules  # noqa: E402
from repro.plan import resolve_plan as jresolve  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.core import fixed_point as TF  # noqa: E402
from repro_torch.core import mvm as tmvm  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import slicing as TS  # noqa: E402
from repro_torch.data import SyntheticLMDataset as TData  # noqa: E402
from repro_torch.kernels import sliced_mvm as tmvm_ops  # noqa: E402
from repro_torch.kernels import sliced_opa as topa  # noqa: E402
from repro_torch.kernels.sliced_mvm import ref as tmvm_ref  # noqa: E402
from repro_torch.kernels.sliced_opa import ref as topa_ref  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.optim import PantherConfig as TPC  # noqa: E402
from repro_torch.optim import panther as tpan  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

SPEC, JSPEC = TS.DEFAULT_SPEC, JS.DEFAULT_SPEC
GAUSS_ULPS = 4
FLIP_SHARE = 0.01
FLIPS = 2
PHYSICS = {
    "asym": dict(asym_up=1.2, asym_down=0.8),
    "noise": dict(write_noise=4.0),
    "stuck": dict(stuck_frac=0.02, stuck_seed=3),
    "all": dict(asym_up=1.2, asym_down=0.8, write_noise=4.0, stuck_frac=0.02, stuck_seed=3),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _devices(**kw):
    return jcommon.DeviceModel(**kw), tcommon.DeviceModel(**kw)


def _ulps(a, b):
    """f32 ulp distance (same-sign values; ±0 are 0 apart)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _plane_values(planes):
    p = _np(planes).astype(np.int64)
    acc = p[-1]
    for s in range(p.shape[0] - 2, -1, -1):
        acc = acc * 16 + p[s]
    return acc


def _layer_major(planes):
    """Planes [S, *stack, M, N] in the port's layer-major storage."""
    lead = planes.ndim - 3
    return _t(np.ascontiguousarray(np.moveaxis(planes, 0, lead))).movedim(lead, 0)


# ------------------------- patterns and the Gaussian -------------------------


def test_device_pattern_words_bit_identical():
    rng = np.random.default_rng(0)
    seeds = [0, 1, 3, 7, 2**31 - 1, 2**32 - 1, *rng.integers(0, 2**32, 8).tolist()]
    salts = [0, 1, 7, tmvm_ref.READ_SALT, tmvm_ref.READ_SALT_T, *rng.integers(0, 2**16, 4).tolist()]
    for seed in seeds:
        for salt in salts:
            assert TF.device_pattern_words(seed, salt) == JF.device_pattern_words(seed, salt), (seed, salt)
    assert (tmvm_ref.READ_SALT, tmvm_ref.READ_SALT_T, TF.WRITE_NOISE_FOLD) == (
        jmvm_ref.READ_SALT, jmvm_ref.READ_SALT_T, JF.WRITE_NOISE_FOLD)


def test_counter_gauss_within_ulps():
    rng = np.random.default_rng(1)
    r = rng.integers(0, 2**31 - 1, (128, 1), dtype=np.int32)
    c = rng.integers(0, 2**31 - 1, (1, 192), dtype=np.int32)
    for k0, k1 in [(0, 0), (-1, 1), (2**31 - 1, -(2**31)), (123456789, -987654321)]:
        want = np.asarray(JF.counter_gauss(jnp.asarray(r), jnp.asarray(c), jnp.int32(k0), jnp.int32(k1)))
        got = TF.counter_gauss(_t(r), _t(c), k0, k1).numpy()
        assert _ulps(want, got).max() <= GAUSS_ULPS
        assert abs(float(got.mean())) < 0.02 and abs(float(got.std()) - 1.0) < 0.02
    for shape in [(40, 24), (3, 40, 24), (2, 3, 8, 5)]:
        want = np.asarray(JF.counter_gauss_array(jax.random.PRNGKey(5), shape))
        got = TF.counter_gauss_array(prng.PRNGKey(5), shape).numpy()
        assert got.shape == want.shape and _ulps(want, got).max() <= GAUSS_ULPS


@pytest.mark.parametrize("shape", [(8, 64, 96), (8, 3, 40, 24)])
def test_stuck_mask_bit_identical(shape):
    jd, td = _devices(stuck_frac=0.05, stuck_seed=3)
    want = np.asarray(jopa_ref.stuck_mask_ref(jd, JSPEC, shape))
    got = topa_ref.stuck_mask_ref(td, SPEC, shape).numpy()
    assert got.shape == want.shape and np.array_equal(want, got)
    assert 0.03 < got.mean() < 0.07  # the same mask on every layer of a stack


@pytest.mark.parametrize("transpose", [False, True])
def test_read_offsets_within_ulps(transpose):
    jd, td = _devices(read_noise=0.01, stuck_seed=3)
    for gtile, col0 in ((0, 0), (5, 96)):
        want = np.asarray(jmvm_ref.read_offsets_ref(jd, JSPEC, gtile, col0, 64, transpose))
        got = tmvm_ref.read_offsets_ref(td, SPEC, gtile, col0, 64, transpose).numpy()
        assert got.shape == want.shape == (8, 64) and _ulps(want, got).max() <= GAUSS_ULPS


# ------------------------------- write physics -------------------------------


@pytest.mark.parametrize("stochastic", [False, True])
def test_write_device_within_one_lsb(stochastic):
    rng = np.random.default_rng(2)
    y = (rng.normal(size=(2, 96, 64)) * 3e5).astype(np.float32)
    kw = dict(write_noise=4e5, asym_up=1.2, asym_down=0.8)
    jd, td = _devices(**kw)
    want = np.asarray(jopa_ref.write_device(jnp.asarray(y), jd, key=jax.random.PRNGKey(4), stochastic=stochastic,
                                            rng_mode="counter"))
    got = topa_ref.write_device(_t(y), td, key=prng.PRNGKey(4), stochastic=stochastic).numpy()
    d = np.abs(want.astype(np.int64) - got)
    assert d.max() <= 1 and (d > 0).mean() <= FLIP_SHARE
    # without noise the rest of the finalize is bit for bit
    jd, td = _devices(asym_up=1.2, asym_down=0.8)
    want = np.asarray(jopa_ref.write_device(jnp.asarray(y), jd, key=jax.random.PRNGKey(4), stochastic=stochastic,
                                            rng_mode="counter"))
    assert np.array_equal(want, topa_ref.write_device(_t(y), td, key=prng.PRNGKey(4), stochastic=stochastic).numpy())


def _opa_case(seed, stack=(2,), m=256, n=192, t=32):
    """Canonical planes and f32-exact operands, so the contraction is exact
    in both frameworks and only the physics can differ."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-(2**27), 2**27, (*stack, m, n)).astype(np.int32)
    planes = np.asarray(JS.slice_weights(jnp.asarray(q), JSPEC))
    x = (rng.integers(-4, 5, (*stack, t, m)) * 0.125).astype(np.float32)
    dh = (rng.integers(-4, 5, (*stack, t, n)) * 2.0**-5).astype(np.float32)
    return planes, x, dh


def _assert_flips(want, got, allowed):
    d = np.abs(_plane_values(want) - _plane_values(got))
    assert d.max() <= 1 and int((d > 0).sum()) <= allowed, (int(d.max()), int((d > 0).sum()))


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("physics", list(PHYSICS))
def test_opa_fused_update_with_device_matches_jax_oracle(physics, stochastic):
    planes, x, dh = _opa_case(3)
    jd, td = _devices(**PHYSICS[physics])
    allowed = FLIPS if td.write_noise > 0 else 0
    for lr, f in ((1e-2, 12), (2.0**-6, 12)):
        want = np.asarray(jopa.opa_fused_update(jnp.asarray(planes), jnp.asarray(x), jnp.asarray(dh),
                                                jnp.float32(lr), f, JSPEC, stochastic=stochastic,
                                                key=jax.random.PRNGKey(3), use_kernel=False, device=jd))
        pt = _layer_major(planes)
        topa.opa_fused_update(pt, _t(x), _t(dh), lr, f, SPEC, stochastic=stochastic, key=prng.PRNGKey(3),
                              device=td)
        _assert_flips(want, pt, allowed)
        # the plain whole-stack version is the same update
        _assert_flips(want, topa_ref.opa_fused_update_ref(_t(planes), _t(x), _t(dh), lr, f, SPEC,
                                                          stochastic=stochastic, key=prng.PRNGKey(3),
                                                          device=td), allowed)
        if td.stuck_frac > 0:  # stuck digits held
            mask = topa_ref.stuck_mask_ref(td, SPEC, planes.shape).numpy()
            assert np.array_equal(np.where(mask, planes, 0), np.where(mask, _np(pt), 0))
            assert (np.where(mask, 0, planes) != np.where(mask, 0, _np(pt))).mean() > 0.1


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("physics", list(PHYSICS))
def test_opa_device_update_matches_jax_oracle(physics, stochastic):
    planes, x, dh = _opa_case(4)
    g = np.einsum("ltm,ltn->lmn", x.astype(np.float64), dh.astype(np.float64)).astype(np.float32)  # exact
    jd, td = _devices(**PHYSICS[physics])
    want = np.asarray(jopa.opa_device_update(jnp.asarray(planes), jnp.asarray(g), jnp.float32(1e-2), 12, JSPEC,
                                             device=jd, stochastic=stochastic, key=jax.random.PRNGKey(5),
                                             use_kernel=False))
    pt = _layer_major(planes)
    out = topa.opa_device_update(pt, _t(g), 1e-2, 12, SPEC, device=td, stochastic=stochastic,
                                 key=prng.PRNGKey(5))
    assert out is pt  # in place
    _assert_flips(want, pt, FLIPS if td.write_noise > 0 else 0)


def test_write_noise_applies_under_deterministic_rounding_and_ideal_device_is_ideal():
    planes, x, dh = _opa_case(5, stack=())
    base = _t(planes)
    topa.opa_fused_update(base, _t(x), _t(dh), 1e-2, 12, SPEC)
    ideal = _t(planes)
    topa.opa_fused_update(ideal, _t(x), _t(dh), 1e-2, 12, SPEC, key=prng.PRNGKey(1),
                          device=tcommon.DeviceModel(read_noise=0.5))
    assert torch.equal(base, ideal)  # no write field: the ideal update
    noisy = _t(planes)
    topa.opa_fused_update(noisy, _t(x), _t(dh), 1e-2, 12, SPEC, key=prng.PRNGKey(1),
                          device=tcommon.DeviceModel(write_noise=4.0))
    assert not torch.equal(base, noisy)
    with pytest.raises(ValueError, match="write-nonideal"):
        topa.opa_device_update(_t(planes), _t(x.T @ dh), 1e-2, 12, SPEC, device=tcommon.DeviceModel())


# --------------------------------- the reads ---------------------------------


def _read_case(seed, m, n, b, io_bits, transpose, digit=8):
    rng = np.random.default_rng(seed)
    planes = rng.integers(-digit, digit, size=(8, m, n)).astype(np.int8)
    x = rng.normal(size=(b, n if transpose else m)).astype(np.float32)
    xf = int(JF.choose_frac_bits(jnp.asarray(x), word_bits=io_bits, margin_bits=1, clip_to_word=False))
    return planes, x, xf


def _jax_read(planes, x, xf, io_bits, adc, transpose, device=None, tile0=0, col0=0):
    # the reference's eager oracle (its CPU dispatch)
    return np.asarray(jmvm_ref.mvm_sliced_fused_ref(jnp.asarray(planes), jnp.asarray(x), jnp.int32(xf), JSPEC,
                                                    io_bits, adc, transpose=transpose, device=device,
                                                    tile0=tile0, col0=col0))


@pytest.mark.parametrize("io_bits", [8, 12])
@pytest.mark.parametrize("transpose", [False, True])
def test_reads_at_io_bits_8_and_12_bit_identical(io_bits, transpose):
    planes, x, xf = _read_case(io_bits, 384, 256, 24, io_bits, transpose)
    for adc in (9, 6, None):
        want = _jax_read(planes, x, xf, io_bits, adc, transpose)
        got = tmvm_ops.mvm_sliced_fused_batched(_t(planes), _t(x).reshape(4, 6, -1), xf, SPEC, io_bits=io_bits,
                                                adc_bits=adc, transpose=transpose).numpy()
        assert np.array_equal(want, got.reshape(24, -1)), adc


@pytest.mark.parametrize("transpose", [False, True])
def test_noisy_reads_match_jax(transpose):
    jd, td = _devices(read_noise=0.01, stuck_seed=3)
    for (m, n, b), io_bits in (((384, 256, 24), 16), ((320, 100, 5), 12)):
        planes, x, xf = _read_case(m + n, m, n, b, io_bits, transpose)
        for adc in (9, 6, None):
            want = _jax_read(planes, x, xf, io_bits, adc, transpose, jd, tile0=2, col0=5)
            got = tmvm_ops.mvm_sliced_fused(_t(planes), _t(x), xf, SPEC, io_bits=io_bits, adc_bits=adc,
                                            transpose=transpose, device=td, tile0=2, col0=5).numpy()
            clean = _jax_read(planes, x, xf, io_bits, adc, transpose)
            assert not np.array_equal(want, clean)  # the offsets moved the read
            if adc is None:
                assert np.abs(want - got).max() <= 1e-6 * (1.0 + np.abs(want).max())
            elif io_bits != 16:
                assert (want != got).mean() <= FLIP_SHARE, adc
            else:  # io16 finite ADC: the reference's own f32 folds (tests/test_torch_sliced_mvm.py)
                assert np.abs(want - got).max() <= 1e-3 * (1.0 + np.abs(want).max())


def test_noisy_read_fidelity_read_passes_the_device():
    jd, td = _devices(read_noise=0.01, stuck_seed=3)
    planes, x, _ = _read_case(7, 256, 128, 6, 16, False)
    fj = jcommon.FidelityConfig(adc_bits_fwd=9, device=jd)
    ft = tcommon.FidelityConfig(adc_bits_fwd=9, device=td)
    want = np.asarray(jmvm.fidelity_read(jnp.asarray(planes), jnp.int32(30), jnp.asarray(x), fj))
    got = tmvm.fidelity_read(_t(planes), 30, _t(x), ft).numpy()
    # io 16 under the reference's jit: its f32 folds (tests/test_torch_sliced_mvm.py)
    assert np.abs(want - got).max() <= 1e-3 * (1.0 + np.abs(want).max())
    clean = tmvm.fidelity_read(_t(planes), 30, _t(x), dataclasses.replace(ft, device=tcommon.DeviceModel()))
    assert torch.equal(clean, tmvm.fidelity_read(_t(planes), 30, _t(x), dataclasses.replace(ft, device=None)))
    assert not np.array_equal(got, clean.numpy())


@pytest.mark.parametrize("io_bits", [8, 12, 16])
@pytest.mark.parametrize("transpose", [False, True])
def test_mvm_sliced_bit_identical_on_f32_exact_inputs(io_bits, transpose):
    # digit planes in [-2, 2]: every column sum stays below 2^24; both dims
    # multiples of 128, so the reference takes its kernel in both directions
    rng = np.random.default_rng(io_bits)
    m, n = 256, 384
    planes = rng.integers(-2, 3, size=(8, m, n)).astype(np.int8)
    lim = 2 ** (io_bits - 1) - 1
    x_q = rng.integers(-lim, lim + 1, size=(2, 5, n if transpose else m)).astype(np.int32)
    for adc in (9, None):
        kern = np.asarray(jmvm_ops.mvm_sliced_batched(jnp.asarray(planes), jnp.asarray(x_q), JSPEC, io_bits=io_bits,
                                                      adc_bits=adc, transpose=transpose, use_kernel=True,
                                                      interpret=True))
        ref = np.asarray(jmvm_ref.mvm_sliced_ref(jnp.asarray(planes), jnp.asarray(x_q.reshape(10, -1)), JSPEC,
                                                 io_bits, adc, transpose=transpose))
        got = tmvm_ops.mvm_sliced_batched(_t(planes), _t(x_q), SPEC, io_bits=io_bits, adc_bits=adc,
                                          transpose=transpose).numpy()
        assert got.shape == kern.shape == (2, 5, m if transpose else n)
        assert np.array_equal(kern, got), adc
        # the reference's oracle folds bits and slices in one f32 einsum, in
        # another order than its kernel (and the port) at finite ADC
        assert np.abs(ref - got.reshape(10, -1)).max() <= 1e-6 * np.abs(ref).max(), adc
        if adc is None:
            assert np.array_equal(ref, got.reshape(10, -1))
        one = tmvm_ops.mvm_sliced(_t(planes), _t(x_q[1]), SPEC, io_bits=io_bits, adc_bits=adc,
                                  transpose=transpose).numpy()
        assert np.array_equal(one, got[1])


# ------------------------- the optimizer and the step ------------------------

WIDE = dict(d_model=128, n_heads=4, head_dim=32, n_kv_heads=1, d_ff=256, vocab=256,
            n_layers=2, pattern=(("dense", 2),))
CFG_J = dataclasses.replace(jconfigs.get_smoke("gemma_2b"), dtype=jnp.float32, **WIDE)
CFG_T = dataclasses.replace(tconfigs.get_smoke("gemma_2b"), dtype=torch.float32, **WIDE)
B, SEQ, LR = 2, 16, 1e-2
DEVICE = dict(write_noise=4e4, asym_up=1.2, asym_down=0.8, stuck_frac=0.02, stuck_seed=3, read_noise=0.01)
LOSS_RTOL, GNORM_RTOL, DIGITAL_RTOL, LSB_SHARE = 1e-5, 1e-4, 1e-5, 0.005


def _state_from_jax(state):
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return convert.train_state_from_jax(int(state.step), np_tree(state.digital), np_tree(state.sliced),
                                        state.rng, device="cpu")


def _by_path(t, is_leaf=None):
    return {jcommon.path_str(p): v for p, v in jax.tree_util.tree_flatten_with_path(t, is_leaf=is_leaf)[0]}


def _t_by_path(t):
    return {tcommon.path_str(p): v for p, v in tree.leaves_with_path(t) if v is not None}


def _sliced_by_path(t):
    return _by_path(t, is_leaf=lambda x: isinstance(x, jpan.SlicedTensor))


@pytest.fixture(scope="module")
def start():
    return jstep.train_state_init(CFG_J, JPC(crs_every=2), jax.random.PRNGKey(0))


def _fids(**fid):
    jd, td = _devices(**DEVICE)
    return jcommon.FidelityConfig(device=jd, **fid), tcommon.FidelityConfig(device=td, **fid)


@pytest.mark.parametrize("step", [0, 1])  # crs_every=2: CRS runs after step 1
def test_update_split_with_a_device_plan_matches_jax(start, step):
    rng = np.random.default_rng(20 + step)
    params_j = jpan.materialize_split(start.digital, start.sliced, JPC())
    grads_j = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32) * 1e-2), params_j)
    for group in grads_j["groups"]:
        for sub, keys in (("attn", ("wqkv", "wo")), ("mlp", ("wi_gate", "wi_up", "wo"))):
            for k in keys:
                L, M, N = group[sub][k].shape
                x = rng.integers(-4, 5, (L, 24, M)) * 0.125
                dh = rng.integers(-4, 5, (L, 24, N)) * 2.0**-5
                group[sub][k] = jcommon.OuterProductGrad(jnp.asarray(x, jnp.float32), jnp.asarray(dh, jnp.float32))
    fj, ft = _fids()
    plan_j = jresolve(params_j, jrules(JPC(), fidelity=fj))
    dj, sj = jpan.update_split(grads_j, start.digital, start.sliced, jnp.int32(step), jnp.float32(LR),
                               JPC(crs_every=2), rng=start.rng, plan=plan_j)
    st = _state_from_jax(start)
    plan_t = tplan.resolve_plan(tstep.param_shapes(st.digital, st.sliced), tplan.default_rules(TPC(), fidelity=ft))
    devs = {p: pl.fidelity.device for p, pl in _t_by_path(plan_t).items() if pl.mapped}
    assert devs and all(d == ft.device for d in devs.values())  # dense leaves keep their device
    grads_t = jax.tree.map(
        lambda g: tcommon.OuterProductGrad(_t(g.x), _t(g.dh)) if isinstance(g, jcommon.OuterProductGrad) else _t(g),
        grads_j, is_leaf=lambda g: isinstance(g, jcommon.OuterProductGrad))
    dt, stt = tpan.update_split(grads_t, st.digital, st.sliced, step, LR, TPC(crs_every=2), rng=st.rng,
                                plan=plan_t)
    want_s = _sliced_by_path(sj)
    for path, s in _t_by_path(stt).items():
        d = np.abs(_plane_values(want_s[path].planes) - _plane_values(s.planes))
        assert d.max() <= 1 and (d > 0).mean() <= FLIP_SHARE, path
    want_d = _by_path(dj)
    for path, d in _t_by_path(dt).items():
        assert np.array_equal(np.asarray(want_d[path]), _np(d)), path


def _planes_of(state):
    return {p: s.planes.clone() for p, s in _t_by_path(state.sliced).items()}


def test_an_all_ideal_device_trains_as_no_device(start):
    fid = tcommon.FidelityConfig(adc_bits_fwd=9, adc_bits_bwd=9)
    data = TData(CFG_T.vocab, SEQ, B, device="cpu")
    out = []
    for dev in (None, tcommon.DeviceModel()):
        st = _state_from_jax(start)
        rules = tplan.default_rules(TPC(), fidelity=dataclasses.replace(fid, device=dev))
        st, m = tstep.make_train_step(CFG_T, TPC(crs_every=2), tsched.constant(LR), plan_rules=rules,
                                      remat="none")(st, data.batch(0))
        out.append((float(m["loss"]), _planes_of(st)))
    assert out[0][0] == out[1][0]
    for path, p in out[0][1].items():
        assert torch.equal(p, out[1][1][path]), path


@pytest.fixture(scope="module")
def noisy_lossless_runs(start):
    """Two steps of both packages on the non-ideal device with lossless
    (dense) reads: its write physics end to end. The read offsets, which
    are as large as the signal at the ideal ADC, would amplify the
    Gaussian's ulps into the gradients; they are held read by read below."""
    fj, ft = _fids(fwd=False, bwd=False)
    step_j = jax.jit(jstep.make_train_step(CFG_J, JPC(crs_every=2), jsched.constant(LR),
                                           plan_rules=jrules(JPC(), fidelity=fj)))
    step_t = tstep.make_train_step(CFG_T, TPC(crs_every=2), tsched.constant(LR),
                                   plan_rules=tplan.default_rules(TPC(), fidelity=ft), remat="none")
    dj, dt = JData(CFG_J.vocab, SEQ, B), TData(CFG_T.vocab, SEQ, B, device="cpu")
    sj, st = start, _state_from_jax(start)
    before = _planes_of(st)
    mj, mt, first = [], [], None
    for i in range(2):
        sj, m = step_j(sj, dj.batch(i))
        mj.append({k: float(v) for k, v in m.items()})
        st, m = step_t(st, dt.batch(i))
        mt.append({k: float(v) for k, v in m.items()})
        if i == 0:
            first = (_sliced_by_path(sj.sliced), _planes_of(st))
    return {"jax": sj, "port": st, "mj": mj, "mt": mt, "first": first, "before": before}


def test_noisy_train_steps_match_jax_end_to_end(noisy_lossless_runs):
    r = noisy_lossless_runs
    for mj, mt in zip(r["mj"], r["mt"]):
        assert abs(mt["loss"] - mj["loss"]) <= LOSS_RTOL * abs(mj["loss"]), (mj, mt)
        assert abs(mt["grad_norm"] - mj["grad_norm"]) <= GNORM_RTOL * mj["grad_norm"], (mj, mt)
    _, td = _devices(**DEVICE)
    want_1, got_1 = r["first"]
    for path, p in got_1.items():  # after the first step (no CRS)
        vj, vt = _plane_values(want_1[path].planes), _plane_values(p)
        assert np.abs(vj - vt).max() <= 1e-5 * np.abs(vj).max(), path
        if path != "embed":
            assert (np.abs(vj - vt) > 1).mean() <= LSB_SHARE, path
        mask = topa_ref.stuck_mask_ref(td, SPEC, p.shape).expand(p.shape).numpy()
        assert np.array_equal(_np(p)[mask], _np(r["before"][path])[mask]), path  # stuck digits held
    want_s = _sliced_by_path(r["jax"].sliced)
    for path, s in _t_by_path(r["port"].sliced).items():  # after both steps (CRS)
        vj, vt = _plane_values(want_s[path].planes), _plane_values(s.planes)
        assert np.abs(vj - vt).max() <= 1e-5 * np.abs(vj).max(), path
        if path != "embed":
            assert (np.abs(vj - vt) > 1).mean() <= LSB_SHARE, path
    want_d = _by_path(r["jax"].digital)
    for path, d in _t_by_path(r["port"].digital).items():
        np.testing.assert_allclose(_np(d), np.asarray(want_d[path]), rtol=DIGITAL_RTOL, atol=1e-7)


def test_adc9_device_step_reads_match_jax_read_by_read(start, monkeypatch):
    reads = []
    real = tmvm.fidelity_read

    def recording(planes, frac_bits, x, fid, transpose=False):
        out = real(planes, frac_bits, x, fid, transpose=transpose)
        reads.append((_np(planes).copy(), int(frac_bits), _np(x).copy(), transpose, _np(out).copy()))
        return out

    monkeypatch.setattr(tmvm, "fidelity_read", recording)
    fj, ft = _fids(adc_bits_fwd=9, adc_bits_bwd=9)
    st = _state_from_jax(start)
    before = _planes_of(st)
    step = tstep.make_train_step(CFG_T, TPC(crs_every=2), tsched.constant(LR),
                                 plan_rules=tplan.default_rules(TPC(), fidelity=ft), remat="none")
    st, m = step(st, TData(CFG_T.vocab, SEQ, B, device="cpu").batch(0))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert len(reads) == 2 * 5 * CFG_T.n_layers and sum(r[3] for r in reads) == len(reads) // 2
    for planes, f, x, transpose, out in reads:
        want = np.asarray(jmvm.fidelity_read(jnp.asarray(planes), jnp.int32(f), jnp.asarray(x), fj,
                                             transpose=transpose))
        assert want.shape == out.shape
        assert float(np.abs(want - out).max()) <= 1e-3 * (1.0 + float(np.abs(want).max())), transpose
    for path, p in _planes_of(st).items():  # the device step moved every leaf, stuck digits held
        assert not torch.equal(p, before[path]), path
        mask = topa_ref.stuck_mask_ref(ft.device, SPEC, p.shape).expand(p.shape)
        assert torch.equal(p[mask], before[path][mask]), path
