"""The paper-MLP slice of the port against the JAX package: the key split
and the normal draw, the teacher-student data, the float baselines, the
non-split PANTHER optimizer (``init``/``materialize``/``update``, momentum
and Tiki-Taka, the device branch), the Fig-9 rows and the quickstart.
Inputs are made with numpy from a seed, or drawn from the same
``jax.random`` keys, and passed to both packages; the reference runs
eagerly (op by op) where the test holds bits, jitted where it holds whole
runs.

Tolerances, and why:
* ``split``: bit for bit (integer threefry).
* ``normal`` and everything drawn from it: within ``NORMAL_ULPS`` = 4 f32
  ulps, at most ``NORMAL_SHARE`` = 2% of the draws off (3 ulps and ~1%
  measured). The uniform draw is bit for bit; XLA's ``log1p`` inside its
  ``ErfInv`` differs from torch's by up to 2 ulps. The teacher's outputs
  within ``1e-5`` relative (f32 sums of 128 such inputs).
* ``sgd_update``, ``adamw_update`` (3 steps; ``b2 ** step`` differs between
  XLA's and torch's ``pow`` from step 6 on), ``init``, ``materialize`` and
  one ``update`` on given gradients (deterministic and counter rounding,
  the CRS step, momentum and Tiki-Taka buffers, operand leaves with
  f32-exact operands, alone and materialized under momentum): bit for bit.
* The device branch of ``update`` (write noise 4 LSB, asymmetry): ±1 LSB,
  at most ``FLIPS`` = 2 elements a leaf, as ``tests/test_torch_device.py``
  counts them (``counter_gauss`` within 4 ulps).
* Whole runs, final losses relative to the in-process reference (the same
  steps, lr and keys; the port's init from its own draws):
  ``RUN_RTOL`` = 1e-3 for ``run()``'s 4-bit, period-64 configuration and
  the float-SGD baseline, and for ``dev_wn0``. Their gradients differ in
  f32 ulps, so some deterministic roundings land a grid LSB apart; over
  300-400 steps that moved the final loss by 7e-6 relative at most
  (measured: 1e-7 SGD, 6.6e-6 the configuration, 6.9e-6 ``dev_wn0``);
  1e-3 leaves a margin of 100 and stays far under 5%.
* ``dev_wn4e6`` and ``dev_wn4e6_tt``: the reference itself is chaotic at
  this write noise. One ulp on one input element moves its final loss from
  1.248 to 1.021, one ulp on one weight to 15.38 (SGD; Tiki-Taka 0.190 ->
  0.389 / 0.121), so no tolerance under 5% can hold a final loss there.
  The test holds what is reproducible: the first step's flips (the write
  noise's ulps: ``counter_gauss`` is off on ~8% of draws by up to 4 ulps,
  which at 4e6 LSB moves a write by up to ``NOISE_LSB`` - 1 LSB; 3-5% of
  the elements, by 1-2 LSB, measured); the port and the reference, from
  the same converted state, step by step within ``TRACK_RTOL`` = 1e-4
  for ``TRACK_STEPS`` = 30 steps (before the flips have crossed a
  saturated plane; 1.7e-6 / 4.3e-6 measured, printed); both finite at 300 steps;
  and the reference's own one-ulp spread, asserted, so the statement
  stays true.
* The quickstart at 50 steps: the same loss within ``1e-3`` relative
  (counter stochastic rounding: a ±1-LSB gradient difference flips a
  draw's outcome rarely).
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the reference's benchmarks/ and examples/

from benchmarks import fig9_slice_crs as JF9  # noqa: E402
from examples import quickstart as JQ  # noqa: E402
from repro.core import SliceSpec as JSpec  # noqa: E402
from repro.data import TeacherStudentDataset as JTS  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.optim import PantherConfig as JPC  # noqa: E402
from repro.optim import baselines as jbase  # noqa: E402
from repro.optim import panther as jpan  # noqa: E402
from repro.plan import default_rules as jrules  # noqa: E402
from repro.plan import resolve_plan as jresolve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.benchmarks import fig9_slice_crs as TF9  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.slicing import SliceSpec as TSpec  # noqa: E402
from repro_torch.data import TeacherStudentDataset as TTS  # noqa: E402
from repro_torch.examples import quickstart as TQ  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.optim import PantherConfig as TPC  # noqa: E402
from repro_torch.optim import baselines as tbase  # noqa: E402
from repro_torch.optim import panther as tpan  # noqa: E402

NORMAL_ULPS, NORMAL_SHARE = 4, 0.02
FLIPS = 2
RUN_RTOL = 1e-3
TRACK_RTOL, TRACK_STEPS = 1e-4, 30
# counter_gauss: ~8% of draws off by up to 4 ulps (tests/test_torch_device.py); at 4e6 LSB
# an ulp of a |z| <= 5 draw moves the write by 4e6 * 2^-23 * 5 ~ 2.4 LSB
NOISE_LSB, NOISE_SHARE = 1 + int(4 * 4e6 * 2.0**-23 * 5), 0.08
SIZES = (24, 40, 32, 8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ulps(a, b):
    """f32 ulp distance (same-sign values; ±0 are 0 apart)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _check_normal(want, got, what):
    d = _ulps(want, got)
    print(f"{what}: {int((d > 0).sum())} of {d.size} draws off, by at most {int(d.max())} ulps")
    assert d.max() <= NORMAL_ULPS and (d > 0).mean() <= NORMAL_SHARE, (what, int(d.max()), (d > 0).mean())


def _plane_values(planes):
    p = _np(planes).astype(np.int64)
    acc = p[-1]
    for s in range(p.shape[0] - 2, -1, -1):
        acc = acc * 16 + p[s]
    return acc


def _np_params(seed, sizes=SIZES):
    rng = np.random.default_rng(seed)
    p = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        p[f"w{i}"] = (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
        p[f"b{i}"] = (rng.standard_normal(b) * 0.1).astype(np.float32)
    return p


def _np_grads(seed, params, scale=1e-2):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(v.shape) * scale).astype(np.float32) for k, v in params.items()}


def _exact_operands(seed, m, n, t=12):
    """f32-exact operands: every product and sum is exact in f32, so the
    contraction order cannot matter."""
    rng = np.random.default_rng(seed)
    return ((rng.integers(-4, 5, (t, m)) * 0.125).astype(np.float32),
            (rng.integers(-4, 5, (t, n)) * 2.0**-5).astype(np.float32))


def _jax_tree(t):
    return jax.tree.map(jnp.asarray, t)


def _port_tree(t):
    return {k: _t(v) for k, v in t.items()}


# --------------------------------- draws -------------------------------------


@pytest.mark.parametrize("n", [2, 3, 4, 7])
def test_split_bit_for_bit(n):
    for key in (jax.random.PRNGKey(0), jax.random.PRNGKey(7), jax.random.fold_in(jax.random.PRNGKey(3), 5)):
        want = np.asarray(jax.random.split(key, n)).tolist()
        words = tuple(int(w) for w in np.asarray(key))
        assert [list(k) for k in prng.split(words, n)] == want


@pytest.mark.parametrize("shape", [(512, 64), (64, 256), (7, 3)])
def test_normal_within_ulps(shape):
    for seed in (0, 11):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        words = tuple(int(w) for w in np.asarray(key))
        _check_normal(np.asarray(jax.random.normal(key, shape, jnp.float32)),
                      prng.normal(words, shape, device="cpu").numpy(), f"normal{shape} seed {seed}")
    # the bounded uniform under it, bit for bit
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax.random.uniform(key, shape, jnp.float32, -0.5, 3.0))
    assert np.array_equal(want, prng.uniform((0, 4), shape, minval=-0.5, maxval=3.0).numpy())


@pytest.mark.parametrize("seed", [0, 3])
def test_teacher_student_dataset_within_ulps(seed):
    want = JTS(d_in=32, d_out=8, batch=256, seed=seed)
    got = TTS(d_in=32, d_out=8, batch=256, seed=seed, device="cpu")
    for name in ("w1", "w2", "x"):
        _check_normal(np.asarray(getattr(want, name)), getattr(got, name).numpy(), f"{name} seed {seed}")
    x, y = got.batch(5)
    assert x is got.x and y.shape == (256, 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(want.y), rtol=1e-5, atol=1e-6)


# ------------------------------- baselines -----------------------------------


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_update_bit_for_bit(momentum):
    params = _np_params(1)
    pj, sj = _jax_tree(params), jbase.sgd_init(_jax_tree(params), momentum)
    pt, st = _port_tree(params), tbase.sgd_init(_port_tree(params), momentum)
    for i in range(3):
        g = _np_grads(10 + i, params)
        pj, sj = jbase.sgd_update(_jax_tree(g), sj, pj, 0.03, momentum)
        pt, st = tbase.sgd_update(_port_tree(g), st, pt, 0.03, momentum)
        for k in params:
            assert np.array_equal(np.asarray(pj[k]), pt[k].numpy()), (i, k)
            if momentum:
                assert np.array_equal(np.asarray(sj.momentum[k]), st.momentum[k].numpy()), (i, k)
    assert st.step == int(sj.step) == 3


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adamw_update_bit_for_bit(wd):
    params = _np_params(2)
    pj, sj = _jax_tree(params), jbase.adamw_init(_jax_tree(params))
    pt, st = _port_tree(params), tbase.adamw_init(_port_tree(params))
    for i in range(3):
        g = _np_grads(20 + i, params)
        pj, sj = jbase.adamw_update(_jax_tree(g), sj, pj, 1e-3, wd=wd)
        pt, st = tbase.adamw_update(_port_tree(g), st, pt, 1e-3, wd=wd)
        for k in params:
            assert np.array_equal(np.asarray(pj[k]), pt[k].numpy()), (i, k)
            assert np.array_equal(np.asarray(sj.mu[k]), st.mu[k].numpy()), (i, k)
            assert np.array_equal(np.asarray(sj.nu[k]), st.nu[k].numpy()), (i, k)


# -------------------------- non-split PANTHER API ----------------------------


@pytest.mark.parametrize("momentum", [0.0, 0.875])
def test_init_and_materialize_bit_for_bit(momentum):
    params = _np_params(3)
    for spec in (None, 5):
        cj = JPC(momentum=momentum, **({} if spec is None else {"spec": JSpec.uniform(spec)}))
        ct = TPC(momentum=momentum, **({} if spec is None else {"spec": TSpec.uniform(spec)}))
        sj = jpan.init(_jax_tree(params), cj)
        st = tpan.init(_port_tree(params), ct)
        assert st.step == int(sj.step) == 0
        for k in params:
            if sj.sliced[k] is None:
                assert st.sliced[k] is None
            else:
                assert np.array_equal(np.asarray(sj.sliced[k].planes), st.sliced[k].planes.numpy()), k
                assert int(sj.sliced[k].frac_bits) == int(st.sliced[k].frac_bits), k
            if momentum:
                assert np.array_equal(np.asarray(sj.momentum[k]), st.momentum[k].numpy())
            else:
                assert sj.momentum[k] is None and st.momentum[k] is None
        mj = jpan.materialize(_jax_tree(params), sj, cj)
        mt = tpan.materialize(_port_tree(params), st, ct)
        for k in params:
            assert np.array_equal(np.asarray(mj[k]), mt[k].numpy()), k
        # a state carried across by convert is the same state
        cs = convert.panther_state_from_jax(jax.tree.map(np.asarray, sj), device="cpu")
        for k in params:
            if cs.sliced[k] is not None:
                assert torch.equal(cs.sliced[k].planes, st.sliced[k].planes)


UPDATE_CASES = {
    "deterministic": dict(cfg=dict(stochastic_round=False), operand=None),
    "counter": dict(cfg=dict(), operand=None),
    "crs": dict(cfg=dict(crs_every=3), operand=None),
    "tiki_taka": dict(cfg=dict(stochastic_round=False, momentum=0.875), operand=None),
    "operand": dict(cfg=dict(), operand="w1"),
    "operand_under_momentum": dict(cfg=dict(momentum=0.875), operand="w1"),
}


def _update_grads(seed, params, operand, jax_side):
    """Given gradients: dense f32 leaves, and with ``operand`` that leaf as
    f32-exact operands (an ``OuterProductGrad``)."""
    g = _np_grads(seed, params)
    if jax_side:
        out = _jax_tree(g)
        if operand:
            x, dh = _exact_operands(seed, *params[operand].shape)
            out[operand] = jcommon.OuterProductGrad(jnp.asarray(x), jnp.asarray(dh))
        return out
    out = _port_tree(g)
    if operand:
        x, dh = _exact_operands(seed, *params[operand].shape)
        out[operand] = tcommon.OuterProductGrad(_t(x), _t(dh))
    return out


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_update_on_given_gradients_bit_for_bit(case):
    """Three reference steps from ``init``; the third (a CRS step under
    ``crs_every=3``) is held: the port takes the reference's state before
    it through ``convert`` and makes the same step."""
    spec = UPDATE_CASES[case]
    params = _np_params(4)
    cj, ct = JPC(**spec["cfg"]), TPC(**spec["cfg"])
    pj = _jax_tree(params)
    sj = jpan.init(pj, cj)
    pj = jpan.materialize(pj, sj, cj)
    lr = 0.05
    for i in range(2):
        pj, sj = jpan.update(_update_grads(30 + i, params, spec["operand"], True), sj, pj, jnp.float32(lr), cj,
                             rng=jax.random.PRNGKey(9))
    st = convert.panther_state_from_jax(jax.tree.map(np.asarray, sj), device="cpu")
    pt = {k: _t(v) for k, v in pj.items()}
    pj, sj = jpan.update(_update_grads(32, params, spec["operand"], True), sj, pj, jnp.float32(lr), cj,
                         rng=jax.random.PRNGKey(9))
    pt, st2 = tpan.update(_update_grads(32, params, spec["operand"], False), st, pt, lr, ct, rng=prng.PRNGKey(9))
    assert st2.step == int(sj.step) == 3 and st2.sliced is st.sliced
    for k in params:
        assert np.array_equal(np.asarray(pj[k]), pt[k].numpy()), k
        if sj.sliced[k] is not None:
            assert np.array_equal(np.asarray(sj.sliced[k].planes), st2.sliced[k].planes.numpy()), k
        if ct.momentum:
            assert np.array_equal(np.asarray(sj.momentum[k]), st2.momentum[k].numpy()), k
            assert np.abs(np.asarray(sj.momentum[k])).max() > 0
    if case == "crs":  # the held step ran CRS: every plane canonical
        assert all(np.abs(st2.sliced[k].planes.numpy()).max() <= 8 for k in ("w0", "w1", "w2"))


@pytest.mark.parametrize("rule", ["sgd", "tiki-taka"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_update_device_branch_counts_flips(rule, stochastic):
    """A plan with a write-nonideal device: dense and operand leaves write
    through the device physics; ±1 LSB, at most FLIPS elements a leaf."""
    params = _np_params(5)
    dj = jcommon.DeviceModel(write_noise=4.0, asym_up=1.2, asym_down=0.8)
    dt = tcommon.DeviceModel(write_noise=4.0, asym_up=1.2, asym_down=0.8)
    kw = dict(stochastic_round=stochastic)
    cj, ct = JPC(**kw), TPC(**kw)
    if rule == "tiki-taka":
        cj, ct = jpan.tiki_taka(cj), tpan.tiki_taka(ct)
    plan_j = jresolve(_jax_tree(params), jrules(cj, fidelity=jcommon.FidelityConfig(spec=cj.spec, device=dj)))
    plan_t = tplan.resolve_plan(_port_tree(params), tplan.default_rules(
        ct, fidelity=tcommon.FidelityConfig(spec=ct.spec, device=dt)))
    sj = jpan.init(_jax_tree(params), cj, plan=plan_j)
    st = convert.panther_state_from_jax(jax.tree.map(np.asarray, sj), device="cpu")
    pj = jpan.materialize(_jax_tree(params), sj, cj)
    pt = {k: _t(v) for k, v in pj.items()}
    for i in range(2):
        pj, sj = jpan.update(_update_grads(40 + i, params, "w1", True), sj, pj, jnp.float32(0.05), cj,
                             rng=jax.random.PRNGKey(11), plan=plan_j)
        pt, st = tpan.update(_update_grads(40 + i, params, "w1", False), st, pt, 0.05, ct,
                             rng=prng.PRNGKey(11), plan=plan_t)
        for k in ("w0", "w1", "w2"):
            d = np.abs(_plane_values(sj.sliced[k].planes) - _plane_values(st.sliced[k].planes))
            assert d.max() <= 1 and int((d > 0).sum()) <= FLIPS, (i, k, int(d.max()), int((d > 0).sum()))
        for k in ("b0", "b1", "b2"):
            assert np.array_equal(np.asarray(pj[k]), pt[k].numpy())


def test_update_split_refuses_momentum_and_points_at_update():
    with pytest.raises(NotImplementedError, match=r"panther\.update"):
        tpan.update_split({}, {}, {}, 0, 0.1, tpan.tiki_taka(TPC()))
    assert tpan.tiki_taka(TPC()).momentum == 0.875 and tpan.tiki_taka(TPC(), 0.5).variant == "tiki-taka"


def test_saturation_report_takes_a_state_or_a_sliced_tree():
    params = _np_params(6)
    cj = JPC(spec=JSpec.uniform(3))
    sj = jpan.init(_jax_tree(params), cj)
    st = convert.panther_state_from_jax(jax.tree.map(np.asarray, sj), device="cpu")
    want = jpan.saturation_report(sj, cj)
    for arg in (st, st.sliced):
        got = tpan.saturation_report(arg, TPC(spec=TSpec.uniform(3)))
        for k in params:
            if want[k] is None:
                assert got[k] is None
            else:
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)


# ------------------------------ whole runs -----------------------------------


def _jax_task(seed, nudge=False):
    """The reference's task draws; ``nudge`` moves the first input element
    by one ulp."""
    key = jax.random.PRNGKey(seed)
    params0 = JF9._mlp(jax.random.fold_in(key, 1))
    teacher = JF9._mlp(jax.random.fold_in(key, 2))
    x = jax.random.normal(jax.random.fold_in(key, 3), (512, 64), jnp.float32)
    if nudge:
        x = np.array(x)
        x.view(np.int32).reshape(-1)[0] += 1
        x = jnp.asarray(x)
    return params0, (x, JF9._fwd(teacher, x))


def _jax_sgd(params0, batch, steps, lr):
    p, s = dict(params0), jbase.sgd_init(params0)
    step = jax.jit(lambda p, s: jbase.sgd_update(jax.grad(JF9._loss)(p, batch), s, p, lr))
    for _ in range(steps):
        p, s = step(p, s)
    return float(JF9._loss(p, batch))


def _jax_panther(params0, batch, cfg, steps, lr, plan=None, rng=None, losses=None):
    state = jpan.init(params0, cfg, plan=plan)
    p = jpan.materialize(params0, state, cfg)
    step = jax.jit(lambda p, s: jpan.update(jax.grad(JF9._loss)(p, batch), s, p, jnp.float32(lr), cfg,
                                            rng=rng, plan=plan))
    for _ in range(steps):
        p, state = step(p, state)
        if losses is not None:
            losses.append(float(JF9._loss(p, batch)))
    return float(JF9._loss(p, batch))


def test_fig9_run_configuration_matches_jax():
    """``run()``'s 4-bit, CRS-64 row at its full 400 steps: the float-SGD
    loss and the configuration's loss relative to it."""
    pj, bj = _jax_task(0)
    ref_j = _jax_sgd(pj, bj, 400, 0.03)
    loss_j = _jax_panther(pj, bj, JPC(spec=JSpec.uniform(4), crs_every=64, stochastic_round=False), 400, 0.03)
    pt, bt = TF9._task(0, torch.device("cpu"))
    ref_t, _ = TF9.sgd_reference(pt, bt, 400, 0.03)
    loss_t, *_ = TF9.train_config(pt, bt, 4, 64, 400, 0.03)
    assert abs(ref_t - ref_j) <= RUN_RTOL * ref_j, (ref_t, ref_j)
    assert abs(loss_t - loss_j) <= RUN_RTOL * loss_j, (loss_t, loss_j)
    assert abs(loss_t / ref_t - loss_j / ref_j) <= 2 * RUN_RTOL * loss_j / ref_j


def test_paper_claims_of_the_reference_rows():
    rows = [(3, c, 0.6, 0.0, 3.3) for c in TF9.CRS_PERIODS] + [(4, c, 0.4, 0.0, 2.7) for c in TF9.CRS_PERIODS] + \
        [(5, c, 0.2, 0.0, 2.0) for c in TF9.CRS_PERIODS] + [(6, c, 0.1, 0.0, 1.6) for c in TF9.CRS_PERIODS]
    assert all(TF9.paper_claims(rows).values())
    rows[6] = (5, 64, 0.2, 0.0, 2.3)  # 5-bit at CRS 64 above 2.2x float SGD
    assert TF9.paper_claims(rows) == {"3bit_worst": True, "56bit_robust": False,
                                      "hi_le_lo_saturation": True, "sat_monotone": True}


def _dev_plan_j(cfg, sigma, params0):
    dev = None if sigma == 0 else jcommon.DeviceModel() if sigma is None else \
        jcommon.DeviceModel(write_noise=sigma, asym_up=1.2, asym_down=0.8)
    fid = jcommon.FidelityConfig(spec=cfg.spec, device=dev) if dev is not None else None
    return jresolve(params0, jrules(cfg, fidelity=fid))


def test_device_sweep_anchor_rows_match_jax():
    """``dev_wn0`` at its full 300 steps within RUN_RTOL of the reference;
    ``dev_ideal`` equal to it bit for bit, in the port as in the
    reference."""
    pj, bj = _jax_task(7)
    plain = JPC(stochastic_round=False, crs_every=1 << 20)
    want = _jax_panther(pj, bj, plain, 300, 0.03, plan=_dev_plan_j(plain, 0, pj), rng=jax.random.PRNGKey(11))
    task = TF9._task(7, torch.device("cpu"))
    wn0, _ = TF9.device_row(0, "sgd", 300, task=task)
    ideal, _ = TF9.device_row(None, "sgd", 300, task=task)
    assert ideal == wn0
    assert abs(wn0 - want) <= RUN_RTOL * want, (wn0, want)


@pytest.mark.parametrize("rule", ["sgd", "tiki-taka"])
def test_device_sweep_noisy_rows_track_jax(rule):
    """``dev_wn4e6`` (SGD) and ``dev_wn4e6_tt``: from the same converted
    start, per-step losses within TRACK_RTOL for TRACK_STEPS steps, the
    first step's flips counted; both runs finite at 300 steps; the
    reference's own final loss moves by more than 5% under a one-ulp
    nudge of one input element (module docstring)."""
    pj, bj = _jax_task(7)
    cfg = JPC(stochastic_round=False, crs_every=1 << 20)
    tcfg = TPC(stochastic_round=False, crs_every=1 << 20)
    if rule == "tiki-taka":
        cfg, tcfg = jpan.tiki_taka(cfg), tpan.tiki_taka(tcfg)
    plan_j = _dev_plan_j(cfg, 4e6, pj)
    losses_j = []
    final_j = _jax_panther(pj, bj, cfg, 300, 0.03, plan=plan_j, rng=jax.random.PRNGKey(11), losses=losses_j)
    pt0 = {k: _t(v) for k, v in pj.items()}
    bt = tuple(_t(a) for a in bj)
    dev = tcommon.DeviceModel(write_noise=4e6, asym_up=1.2, asym_down=0.8)
    plan_t = tplan.resolve_plan(pt0, tplan.default_rules(tcfg, fidelity=tcommon.FidelityConfig(device=dev)))
    st = tpan.init(pt0, tcfg, plan=plan_t)
    pt = tpan.materialize(pt0, st, tcfg)
    sj0 = jpan.init(pj, cfg, plan=plan_j)
    track = []
    for i in range(300):
        pt, st = tpan.update(TF9._grad(pt, bt), st, pt, 0.03, tcfg, rng=prng.PRNGKey(11), plan=plan_t)
        if i == 0:  # one-LSB flips of the write noise's ulps, counted
            pj1, sj1 = jpan.update(jax.grad(JF9._loss)(jpan.materialize(pj, sj0, cfg), bj), sj0,
                                   jpan.materialize(pj, sj0, cfg), jnp.float32(0.03), cfg,
                                   rng=jax.random.PRNGKey(11), plan=plan_j)
            for k in ("w0", "w1", "w2"):
                d = np.abs(_plane_values(sj1.sliced[k].planes) - _plane_values(st.sliced[k].planes))
                print(f"step 1, {k}: {int((d > 0).sum())} of {d.size} elements off, by at most {int(d.max())} LSB")
                assert d.max() <= NOISE_LSB and (d > 0).mean() <= NOISE_SHARE, (k, int(d.max()), (d > 0).mean())
        if i < TRACK_STEPS:
            lt = float(TF9._loss(pt, bt))
            track.append(abs(lt - losses_j[i]) / losses_j[i])
            assert track[-1] <= TRACK_RTOL, (i, lt, losses_j[i])
    final_t = float(TF9._loss(pt, bt))
    assert np.isfinite(final_t) and np.isfinite(final_j)
    nudged = _jax_panther(pj, _jax_task(7, nudge=True)[1], cfg, 300, 0.03, plan=plan_j,
                          rng=jax.random.PRNGKey(11))
    print(f"{rule} at 4e6: losses of the first {TRACK_STEPS} steps within {max(track):.1e} relative; final: "
          f"reference {final_j:.5f}, one ulp nudged {nudged:.5f}, port {final_t:.5f}")
    assert abs(nudged - final_j) > 0.05 * final_j


def test_quickstart_matches_jax_at_50_steps():
    got = TQ.main(steps=50, device="cpu")
    ds = JTS(d_in=32, d_out=8, batch=256)
    x, y = ds.batch()
    loss = lambda p: jnp.mean((JQ.fwd(p, x) - y) ** 2)  # noqa: E731
    params = JQ.mlp(jax.random.PRNGKey(0))
    ds_t = TTS(32, 8, 256, device="cpu")
    for crs_every in TQ.CRS_PERIODS:
        cfg = JPC(spec=JSpec((4, 4, 4, 6, 6, 5, 5, 5)), crs_every=crs_every)
        state = jpan.init(params, cfg)
        p = jpan.materialize(params, state, cfg)
        step = jax.jit(lambda p, s, _c=cfg: jpan.update(jax.grad(loss)(p), s, p, jnp.float32(0.05), _c))
        first = None
        for i in range(50):
            p, state = step(p, state)
            first = float(loss(p)) if i == 0 else first
        hist, st, tcfg = got["panther"][crs_every]
        assert st.step == 50
        assert abs(hist[0] - first) <= 1e-5 * first
        p_t = tpan.materialize({k: None for k in st.sliced}, st, tcfg)
        final_t = float(torch.mean((TQ.fwd(p_t, ds_t.x) - ds_t.y) ** 2))
        final_j = float(loss(p))
        assert abs(final_t - final_j) <= 1e-3 * final_j, (crs_every, final_t, final_j)


def _spread(sigma, keys):
    """The reference's and the port's final losses at write noise ``sigma``
    over noise keys ``keys``, both rules, and the reference's under a
    one-ulp nudge of one input element and of one weight."""
    pj, bj = _jax_task(7)
    pt, bt = TF9._task(7, torch.device("cpu"))
    w0 = np.array(pj["w0"])
    w0.view(np.int32).reshape(-1)[0] += 1
    pj_nudged = {**pj, "w0": jnp.asarray(w0)}
    for rule in ("sgd", "tiki-taka"):
        cfg = JPC(stochastic_round=False, crs_every=1 << 20)
        tcfg = TPC(stochastic_round=False, crs_every=1 << 20)
        if rule == "tiki-taka":
            cfg, tcfg = jpan.tiki_taka(cfg), tpan.tiki_taka(tcfg)
        plan_j = _dev_plan_j(cfg, sigma, pj)
        dev = tcommon.DeviceModel(write_noise=sigma, asym_up=1.2, asym_down=0.8)
        plan_t = tplan.resolve_plan(pt, tplan.default_rules(tcfg, fidelity=tcommon.FidelityConfig(device=dev)))
        run_j = lambda p, b, k: _jax_panther(p, b, cfg, 300, 0.03, plan=plan_j,  # noqa: E731
                                            rng=jax.random.PRNGKey(k))

        def run_t(k):
            st = tpan.init(pt, tcfg, plan=plan_t)
            p = tpan.materialize(pt, st, tcfg)
            for _ in range(300):
                p, st = tpan.update(TF9._grad(p, bt), st, p, 0.03, tcfg, rng=prng.PRNGKey(k), plan=plan_t)
            return float(TF9._loss(p, bt))

        print(f"write noise {sigma:g}, {rule}: reference {run_j(pj, bj, 11):.5f}, input nudged one ulp "
              f"{run_j(pj, _jax_task(7, nudge=True)[1], 11):.5f}, w0 nudged one ulp {run_j(pj_nudged, bj, 11):.5f}",
              flush=True)
        for name, finals in (("reference", [run_j(pj, bj, k) for k in keys]), ("port", [run_t(k) for k in keys])):
            print(f"  {name} over keys {keys[0]}-{keys[-1]}: median {np.median(finals):.4f}, min "
                  f"{min(finals):.4f}, max {max(finals):.4f}; " + " ".join(f"{v:.4f}" for v in finals), flush=True)


if __name__ == "__main__":
    # the spread of the noisy device-sweep rows (module docstring), printed:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_paper_mlp.py [sigma ...]
    for s in [float(a) for a in sys.argv[1:]] or [4e6, 1e7]:
        _spread(s, list(range(11, 43)))
