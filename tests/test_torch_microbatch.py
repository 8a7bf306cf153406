"""Microbatches and the operand-stash rule of the port against the JAX
package: the stash threshold, ``plan_summary``, a microbatched step on the
f32 gemma-2b smoke config against the reference's microbatched step and
against the port's own full-batch step, and the ``stash_fallback`` step
against the operand step.

Tolerances (deterministic rounding):
* the port's microbatched step against its full-batch step, at the bounds
  of ``tests/test_operand_pipeline.py::
  test_fused_step_microbatch_matches_full_batch``: loss within ``1e-5``;
  operand leaves within one weight-grid ulp (the same token set and one
  contraction over it); dense-gradient leaves (the embedding) within 32
  (the f32 gradient summed over microbatches in another order);
* the microbatches' operands merged and deposited, on given f32-exact
  operands, against the reference's merge (concatenation along the token
  axis, ``scale_dh(1/G)``) and update: planes bit for bit;
* the port's microbatched step against the reference's microbatched step:
  loss within ``1e-5``, and the planes at the cross-framework bound of
  ``tests/test_torch_train_slice.py`` after one step, within ``1 + 2^-18 ·
  max|update|`` grid LSB, at most 0.5% of an operand leaf's elements more
  than one LSB off. The two frameworks' f32 forward and backward differ in
  their last bits, and the weight grid (``2^-30`` here) is finer than the
  f32 ulp of an update, so a step moves some weights by a few f32 ulps of
  the update: 32 grid ulps on ``attn/wo`` (measured), where within one
  framework the microbatches move nothing;
* the threshold, the summary string and the stash-fallback step against
  the operand step: exact.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import plan as jplan  # noqa: E402
from repro.core import slicing as JS  # noqa: E402
from repro.data import SyntheticLMDataset as JData  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import PantherConfig as JPC  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.core.slicing import dequantize_planes  # noqa: E402
from repro_torch.data import SyntheticLMDataset as TData  # noqa: E402
from repro_torch.models.common import OuterProductGrad  # noqa: E402
from repro_torch.optim import PantherConfig as TPC  # noqa: E402
from repro_torch.optim import panther as tpan  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

CFG_J = dataclasses.replace(jconfigs.get_smoke("gemma_2b"), dtype=jnp.float32)
CFG_T = dataclasses.replace(tconfigs.get_smoke("gemma_2b"), dtype=torch.float32)
LOSS_TOL, OPERAND_ULPS, DENSE_ULPS = 1e-5, 1, 32
LSB_SHARE = 0.005
G, B, SEQ, LR = 4, 8, 16, 0.1


def _state_from_jax(state):
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return convert.train_state_from_jax(int(state.step), np_tree(state.digital), np_tree(state.sliced),
                                        state.rng, device="cpu")


def _grid_ulps(a, b) -> dict:
    """Per mapped leaf, the largest weight difference in grid ulps."""
    out = {}
    for (path, sa), (_, sb) in zip(tree.leaves_with_path(a), tree.leaves_with_path(b)):
        if sa is None:
            continue
        wa = dequantize_planes(sa.planes, sa.frac_bits).double()
        wb = dequantize_planes(sb.planes, sb.frac_bits).double()
        out["/".join(map(str, path))] = float((wa - wb).abs().max()) * 2.0 ** float(sa.frac_bits)
    return out


def _check_ulps(ulps: dict):
    assert ulps
    for path, d in ulps.items():
        limit = OPERAND_ULPS if tplan.operand_eligible_path(path) else DENSE_ULPS
        assert d <= limit, (path, d, limit)


def _batches():
    jb = JData(CFG_J.vocab, SEQ, B, seed=5).batch(0)
    tb = TData(CFG_T.vocab, SEQ, B, seed=5, device="cpu").batch(0)
    split = lambda b, f: {k: f(v) for k, v in b.items()}  # noqa: E731
    return (jb, split(jb, lambda v: v.reshape(G, B // G, *v.shape[1:])),
            tb, split(tb, lambda v: v.reshape(G, B // G, *v.shape[1:])))


@pytest.fixture(scope="module")
def start():
    return jstep.train_state_init(CFG_J, JPC(stochastic_round=False, crs_every=1000), jax.random.PRNGKey(0))


def test_stash_threshold_both_sides():
    """tokens > M·N/(M+N) flips to dense; at or below stays operand. For
    M=64, N=128 the threshold is 8192/192 = 42.67: 42 stays, 43 flips."""
    rules = tplan.default_rules(TPC(), stash_fallback=True)
    path = "groups/0/attn/wqkv"
    assert tplan.resolve_leaf(path, (64, 128), torch.float32, rules, tokens=42).grad == "operand"
    assert tplan.resolve_leaf(path, (64, 128), torch.float32, rules, tokens=43).grad == "dense"
    # tokens unknown: the rule stays inert
    assert tplan.resolve_leaf(path, (64, 128), torch.float32, rules).grad == "operand"
    # stacked leaves use the matrix dims, not the layer-stack dim
    assert tplan.resolve_leaf(path, (12, 64, 128), torch.float32, rules, tokens=43).grad == "dense"
    # the same verdicts as the reference's, on both sides
    jrules = jplan.default_rules(JPC(), stash_fallback=True)
    for shape, tokens in (((64, 128), 42), ((64, 128), 43), ((2048, 2560), 1280), ((2048, 16384), 1280)):
        want = jplan.resolve_leaf(path, shape, jnp.float32, jrules, tokens=tokens).grad
        assert tplan.resolve_leaf(path, shape, torch.float32, rules, tokens=tokens).grad == want


@pytest.mark.parametrize("tokens", [None, 16, 128])
def test_plan_summary_matches_jax(tokens):
    fid_j, fid_t = jconfigs.fidelity_presets()["adc9"], tconfigs.fidelity_presets()["adc9"]
    shapes = jax.eval_shape(lambda: jlm.init_params(CFG_J, jax.random.PRNGKey(0)))
    want = jplan.resolve_plan(shapes, jplan.default_rules(JPC(), fidelity=fid_j, stash_fallback=True),
                              tokens=tokens)
    state = tstep.train_state_init(CFG_T, TPC(), 0, device="cpu")
    got = tplan.resolve_plan(tstep.param_shapes(state.digital, state.sliced),
                             tplan.default_rules(TPC(), fidelity=fid_t, stash_fallback=True), tokens=tokens)
    assert tplan.plan_summary(got) == jplan.plan_summary(want)
    assert list(tplan.plan_by_path(got)) == list(jplan.plan_by_path(want))
    assert [p.category for p in tplan.plan_by_path(got).values()] == \
        [p.category for p in jplan.plan_by_path(want).values()]


def _plane_values(planes):
    p = planes.numpy().astype(np.int64)
    acc = p[-1]
    for s in range(p.shape[0] - 2, -1, -1):
        acc = acc * 16 + p[s]
    return acc


def test_microbatched_step_matches_jax(start):
    jb, jmb, tb, tmb = _batches()
    opt_j, opt_t = JPC(stochastic_round=False, crs_every=1000), TPC(stochastic_round=False, crs_every=1000)
    sj, mj = jax.jit(jstep.make_train_step(CFG_J, opt_j, jsched.constant(LR), microbatches=G))(start, jmb)
    st, mt = tstep.make_train_step(CFG_T, opt_t, tsched.constant(LR), microbatches=G,
                                   remat="none")(_state_from_jax(start), tmb)
    assert abs(float(mt["loss"]) - float(mj["loss"])) < LOSS_TOL
    assert abs(float(mt["grad_norm"]) - float(mj["grad_norm"])) <= 1e-4 * float(mj["grad_norm"])
    start_v = {p: _plane_values(s.planes) for p, s in tree.leaves_with_path(_state_from_jax(start).sliced)
               if s is not None}
    want = dict(tree.leaves_with_path(_state_from_jax(sj).sliced))
    for path, s in tree.leaves_with_path(st.sliced):
        if s is None:
            continue
        vj, vt = _plane_values(want[path].planes), _plane_values(s.planes)
        assert np.abs(vj - vt).max() <= 1 + np.abs(vj - start_v[path]).max() * 2.0**-18, path
        if path != ("embed",):
            assert (np.abs(vj - vt) > 1).mean() <= LSB_SHARE, path
        assert (vt != start_v[path]).mean() > 0.5  # the step did move the weights


def test_microbatch_merge_matches_jax_on_given_operands():
    """Per-microbatch operands (f32-exact) of a stacked leaf, merged and
    deposited: the port's merge and update against the reference's
    concatenation, ``scale_dh(1/G)`` and update, planes bit for bit."""
    from repro.models.common import OuterProductGrad as JOPG
    from repro.optim import panther as jpan
    from repro_torch.train.step import _merge_operands

    rng = np.random.default_rng(3)
    stack, t, m, n = (2,), 8, 64, 48
    q = rng.integers(-(2**26), 2**26, (*stack, m, n)).astype(np.int32)
    planes = np.asarray(JS.slice_weights(jnp.asarray(q)))
    xs = [(rng.integers(-4, 5, (*stack, t, m)) * 0.125).astype(np.float32) for _ in range(G)]
    dhs = [(rng.integers(-4, 5, (*stack, t, n)) * 2.0**-5).astype(np.float32) for _ in range(G)]
    frac = np.int32(20)
    for stochastic in (False, True):
        opt_j, opt_t = JPC(stochastic_round=stochastic), TPC(stochastic_round=stochastic)
        gj = JOPG(jnp.concatenate(xs, axis=-2), jnp.concatenate(dhs, axis=-2)).scale_dh(1.0 / G)
        sl_j = {"w": jpan.SlicedTensor(jnp.asarray(planes), jnp.asarray(frac))}
        _, want = jpan.update_split({"w": gj}, {"w": None}, sl_j, 3, jnp.float32(LR), opt_j)
        sl_t = convert.sliced_from_jax({"w": jpan.SlicedTensor(planes, frac)}, device="cpu")
        gt = _merge_operands([OuterProductGrad(torch.from_numpy(x), torch.from_numpy(d)) for x, d in zip(xs, dhs)],
                             G)
        assert tuple(gt.x.shape) == (*stack, G * t, m)
        tpan.update_split({"w": gt}, {"w": None}, sl_t, 3, LR, opt_t)
        assert np.array_equal(np.asarray(want["w"].planes), sl_t["w"].planes.numpy()), stochastic


def test_microbatched_step_matches_full_batch(start, monkeypatch):
    """The port's microbatched step against its own full-batch step, and
    each operand leaf reaching the update as one gradient of G·T tokens."""
    jb, jmb, tb, tmb = _batches()
    opt = TPC(stochastic_round=False, crs_every=1000)
    sf, mf = tstep.make_train_step(CFG_T, opt, tsched.constant(LR), remat="none")(_state_from_jax(start), tb)
    seen = {}
    real = tpan.update_split

    def spy(grads, *a, **k):
        seen.update({p: tuple(g.x.shape) for p, g in tree.leaves_with_path(grads) if isinstance(g, OuterProductGrad)})
        return real(grads, *a, **k)

    monkeypatch.setattr(tpan, "update_split", spy)
    sm, mm = tstep.make_train_step(CFG_T, opt, tsched.constant(LR), microbatches=G,
                                   remat="none")(_state_from_jax(start), tmb)
    assert abs(float(mm["loss"]) - float(mf["loss"])) < LOSS_TOL
    _check_ulps(_grid_ulps(sf.sliced, sm.sliced))
    assert seen and all(shape[-2] == B * SEQ for shape in seen.values()), seen


def test_stash_fallback_step_bit_identical_to_operand_step():
    """With smoke-sized layers every operand leaf crosses the threshold (T =
    256 > M·N/(M+N)), so the whole step runs the dense deposit, which is
    bit-compatible with the operand pipeline: planes equal, bit for bit."""
    opt = TPC(stochastic_round=True, crs_every=64)
    batch = TData(CFG_T.vocab, 32, 8, seed=1, device="cpu").batch(0)
    sa, ma = tstep.make_train_step(CFG_T, opt, tsched.constant(0.5), remat="none")(
        tstep.train_state_init(CFG_T, opt, 0, device="cpu"), batch)
    step = tstep.make_train_step(CFG_T, opt, tsched.constant(0.5), stash_fallback=True, remat="none")
    sb, mb = step(tstep.train_state_init(CFG_T, opt, 0, device="cpu"), batch)
    assert float(ma["loss"]) == float(mb["loss"])
    for (_, a), (_, b) in zip(tree.leaves_with_path(sa.sliced), tree.leaves_with_path(sb.sliced)):
        if a is not None:
            assert torch.equal(a.planes, b.planes)
    plan = tplan.resolve_plan(tstep.param_shapes(sb.digital, sb.sliced),
                              tplan.default_rules(opt, stash_fallback=True), tokens=256)
    assert "operand" not in tplan.plan_summary(plan)


def test_stash_fallback_with_explicit_rules_raises():
    rules = tplan.default_rules(TPC())
    with pytest.raises(ValueError, match="stash_fallback"):
        tstep.make_train_step(CFG_T, TPC(), tsched.constant(LR), plan_rules=rules, stash_fallback=True, remat="none")
    state = tstep.train_state_init(CFG_T, TPC(), 0, device="cpu")
    plan = tplan.resolve_plan(tstep.param_shapes(state.digital, state.sliced), rules)
    with pytest.raises(ValueError, match="stash_fallback"):
        tstep.make_train_step(CFG_T, TPC(), tsched.constant(LR), plan=plan, stash_fallback=True, remat="none")
    with pytest.raises(ValueError, match="microbatches"):
        tstep.make_train_step(CFG_T, TPC(), tsched.constant(LR), microbatches=4, remat="none")(
            state, TData(CFG_T.vocab, 8, 2, device="cpu").batch(0))
