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
* The whole runs (Fig 9's configuration, the device sweep's rows): in
  ``tests/torch_paper_mlp_runs.py``, with the files that hold them.
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
from torch_paper_mlp_runs import _plane_values, _t  # noqa: E402

NORMAL_ULPS, NORMAL_SHARE = 4, 0.02
FLIPS = 2
SIZES = (24, 40, 32, 8)


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




def test_paper_claims_of_the_reference_rows():
    rows = [(3, c, 0.6, 0.0, 3.3) for c in TF9.CRS_PERIODS] + [(4, c, 0.4, 0.0, 2.7) for c in TF9.CRS_PERIODS] + \
        [(5, c, 0.2, 0.0, 2.0) for c in TF9.CRS_PERIODS] + [(6, c, 0.1, 0.0, 1.6) for c in TF9.CRS_PERIODS]
    assert all(TF9.paper_claims(rows).values())
    rows[6] = (5, 64, 0.2, 0.0, 2.3)  # 5-bit at CRS 64 above 2.2x float SGD
    assert TF9.paper_claims(rows) == {"3bit_worst": True, "56bit_robust": False,
                                      "hi_le_lo_saturation": True, "sat_monotone": True}


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


