"""The MoE block family of the port against the JAX package, at
granite-moe-1b-a400m's SMOKE widths (d_model 64, 4 experts top-2, expert
d_ff 32, 2 layers), f32, JAX weights and states carried across by
``repro_torch.convert``.

Tolerances:
* routing (top-k with ties, capacity positions, the dropped assignments):
  exact;
* ``moe_apply``'s output and aux term: within ``MOE_RTOL`` of max|value|
  (the frameworks sum in other orders);
* the grouped adc9/adc6 read with ``expert_groups``: each expert within
  ``1e-3 · (1 + max|out|)`` of the reference's read, as every finite-ADC
  read is held in ``tests/test_torch_train_slice.py`` (the read is
  discontinuous in its input);
* the expert-group deposit: bit for bit;
* one lossless train step (and a ``microbatches=2`` one): the loss within
  ``1e-5`` relative, every mapped leaf within ``1 + 2^-18 · max|update|``
  grid LSB of the reference's with at most 0.5% of its elements off by more
  than one (the embedding's grid is finer than f32 resolves its update),
  digital leaves within ``1e-5`` relative;
* plans, summaries and manifests: equal.
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
from repro.core.fixed_point import quantize as jquantize  # noqa: E402
from repro.core.slicing import DEFAULT_SPEC as JSPEC  # noqa: E402
from repro.core.slicing import slice_weights as jslice  # noqa: E402
from repro.data import SyntheticLMDataset as JData  # noqa: E402
from repro.kernels.sliced_opa import opa_deposit as jdeposit  # noqa: E402
from repro.kernels.sliced_opa import opa_fused_update as jopa  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import PantherConfig as JPC  # noqa: E402
from repro.optim import panther as jpan  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.core.slicing import DEFAULT_SPEC, slice_weights  # noqa: E402
from repro_torch.data import SyntheticLMDataset as TData  # noqa: E402
from repro_torch.examples import train_lm as TL  # noqa: E402
from repro_torch.kernels.sliced_opa import opa_dense_update, opa_fused_update  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.optim import PantherConfig as TPC  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCH = "granite_moe_1b_a400m"
CFG_J = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=jnp.float32)
CFG_T = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype=torch.float32)
MOE_RTOL = 1e-5
LOSS_RTOL, DIGITAL_RTOL, LSB_SHARE = 1e-5, 1e-5, 0.005
B, SEQ, LR = 2, 16, 1e-2


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cfgs(cf: float, shared: bool):
    def one(cfg, mod):
        m = dataclasses.replace(cfg.moe, capacity_factor=cf, n_shared=1 if shared else 0,
                                d_ff_shared=48 if shared else 0)
        return dataclasses.replace(cfg, moe=m)

    return one(CFG_J, jcommon), one(CFG_T, tcommon)


def _moe_params(cfg_j, seed=0):
    pj = jmlp.moe_init(cfg_j, jax.random.PRNGKey(seed))
    return pj, convert.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")


def _jax_route(m, logits, C):
    """The reference's routing lines of ``moe_apply`` (``src/repro/models/
    mlp.py``), on given logits."""
    gates = jax.nn.softmax(logits, axis=-1)
    topw, topi = jax.lax.top_k(gates, m.top_k)
    G, sg, E = logits.shape
    onehot = jax.nn.one_hot(topi, E, dtype=jnp.int32)
    flat = onehot.reshape(G, sg * m.top_k, E)
    pos = ((jnp.cumsum(flat, axis=1) - flat).reshape(G, sg, m.top_k, E) * onehot).sum(-1)
    return topi, pos, pos < C


def _hidden(d, seq, clustered, seed=1):
    """Activations ``[B, seq, d]``: independent, or all near one direction
    (then every token prefers the same experts and capacity drops)."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, seq, d)).astype(np.float32)
    if clustered:
        h = rng.normal(size=(1, 1, d)).astype(np.float32) + 0.05 * h
    return h


@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
@pytest.mark.parametrize("cf", [8.0, 1.25], ids=["cf8", "cf1.25"])
def test_moe_apply_matches_the_reference(cf, shared):
    cfg_j, cfg_t = _cfgs(cf, shared)
    pj, pt = _moe_params(cfg_j)
    h = _hidden(cfg_t.d_model, SEQ, clustered=cf < 2)
    out_j, aux_j = jmlp.moe_apply(cfg_j, pj, jnp.asarray(h), with_aux=True)
    with torch.no_grad():
        out_t, aux_t = tmlp.moe_apply(cfg_t, pt, torch.from_numpy(h), with_aux=True)
        alone = tmlp.moe_apply(cfg_t, pt, torch.from_numpy(h))
    assert torch.equal(alone, out_t)
    out_j = np.asarray(out_j)
    assert np.abs(_np(out_t) - out_j).max() <= MOE_RTOL * np.abs(out_j).max()
    assert abs(float(aux_t) - float(aux_j)) <= MOE_RTOL * abs(float(aux_j))
    aux_alone = float(jmlp.moe_aux_loss(cfg_j, pj, jnp.asarray(h)))
    with torch.no_grad():
        assert abs(float(tmlp.moe_aux_loss(cfg_t, pt, torch.from_numpy(h))) - aux_alone) <= MOE_RTOL * aux_alone
    # the same routing decisions, capacity positions and drops
    T = B * SEQ
    C = tmlp.moe_capacity(cfg_t.moe, T)
    assert C == max(cfg_j.moe.top_k, int(cfg_j.moe.capacity_factor * T * cfg_j.moe.top_k / cfg_j.moe.n_experts))
    x = np.asarray(jcommon.rms_norm(pj["ln"], jnp.asarray(h), cfg_j.norm_eps)).reshape(1, T, -1)
    logits = (x @ np.asarray(pj["router"])).astype(np.float32)
    topi_j, pos_j, keep_j = _jax_route(cfg_j.moe, jnp.asarray(logits), C)
    _, topi_t, pos_t, keep_t = tmlp.moe_route(cfg_t.moe, torch.from_numpy(logits), C)
    assert np.array_equal(_np(topi_t), np.asarray(topi_j))
    assert np.array_equal(_np(pos_t), np.asarray(pos_j))
    assert np.array_equal(_np(keep_t), np.asarray(keep_j))
    assert (int((~keep_t).sum()) > 0) == (cf < 2)  # 1.25 on clustered tokens drops, 8 never


def test_router_ties_pick_the_lowest_experts_first():
    """A zero router weight: every gate is 1/E, and ``lax.top_k`` takes the
    lower index first among ties, so every token routes to experts 0..K-1
    (and at capacity 1.25 the later tokens drop in the reference's order)."""
    cfg_j, cfg_t = _cfgs(1.25, False)
    pj, _ = _moe_params(cfg_j)
    pj = {**pj, "router": jnp.zeros_like(pj["router"])}
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    h = _hidden(cfg_t.d_model, SEQ, clustered=False)
    out_j = np.asarray(jmlp.moe_apply(cfg_j, pj, jnp.asarray(h)))
    with torch.no_grad():
        out_t = _np(tmlp.moe_apply(cfg_t, pt, torch.from_numpy(h)))
    assert np.abs(out_t - out_j).max() <= MOE_RTOL * np.abs(out_j).max()
    K, T = cfg_t.moe.top_k, B * SEQ
    C = tmlp.moe_capacity(cfg_t.moe, T)
    topw, topi, pos, keep = tmlp.moe_route(cfg_t.moe, torch.zeros(1, T, cfg_t.moe.n_experts), C)
    assert torch.equal(topi, torch.arange(K).expand(1, T, K))
    assert torch.equal(topw, torch.full((1, T, K), 1.0 / K))
    # token s sits at slot s of both experts: the first C tokens stay
    assert torch.equal(keep[0, :, 0], torch.arange(T) < C)
    topi_j, pos_j, _ = _jax_route(cfg_j.moe, jnp.zeros((1, T, cfg_j.moe.n_experts)), C)
    assert np.array_equal(np.asarray(topi_j), _np(topi)) and np.array_equal(np.asarray(pos_j), _np(pos))


def _expert_planes(rng, E, d, f):
    """One expert bank sliced by the reference: its ``SlicedTensor``, and
    the port's (layer-major storage)."""
    w = jnp.asarray(rng.normal(size=(E, d, f)) * 0.1, jnp.float32)
    _, sliced = jpan.init_split({"w": w}, JPC())
    s = sliced["w"]
    return s, convert.sliced_from_jax({"w": jax.tree.map(np.asarray, s)}, device="cpu")["w"]


@pytest.mark.parametrize("transpose", [False, True], ids=["mvm", "mtvm"])
def test_grouped_read_with_expert_groups_matches_the_reference(transpose):
    """``expert_groups=((1, adc6), (2, None))`` over 4 experts: expert 0
    reads at 6 bits, 1-2 at the base adc9, the tail (3) at the base too;
    each expert its own DAC exponent and frac_bits."""
    rng = np.random.default_rng(5)
    E, T, d, f = 4, 12, 64, 32
    sj, st = _expert_planes(rng, E, d, f)
    seg = ((1, jcommon.FidelityConfig(adc_bits_fwd=6, adc_bits_bwd=6)), (2, None))
    fid_j = jcommon.FidelityConfig(adc_bits_fwd=9, adc_bits_bwd=9, expert_groups=seg)
    fid_t = tcommon.FidelityConfig(adc_bits_fwd=9, adc_bits_bwd=9, expert_groups=(
        (1, tcommon.FidelityConfig(adc_bits_fwd=6, adc_bits_bwd=6)), (2, None)))
    segs_j = [(a, b, g.adc_bits_fwd) for a, b, g in fid_j.group_slices(E)]
    assert [(a, b, g.adc_bits_fwd) for a, b, g in fid_t.group_slices(E)] == segs_j == [(0, 1, 6), (1, 3, 9), (3, 4, 9)]
    v = rng.normal(size=(E, T, f if transpose else d)).astype(np.float32)
    v[2] *= 40.0  # one expert's buffer at another scale: another DAC exponent
    ww_j = jcommon.XbarWeight(None, None, planes=jnp.moveaxis(sj.planes, 0, 1),
                              frac_bits=jnp.broadcast_to(sj.frac_bits, (E,)), fid=fid_j)
    ww_t = tcommon.XbarWeight(None, st.planes.movedim(0, 1), st.frac_bits.expand(E), fid_t)
    want = np.asarray(jcommon._grouped_fid_read(ww_j, jnp.asarray(v), transpose=transpose))
    got = _np(tcommon._grouped_fid_read(ww_t, torch.from_numpy(v), transpose))
    assert got.shape == want.shape == (E, T, d if transpose else f)
    for e in range(E):
        assert np.abs(got[e] - want[e]).max() <= 1e-3 * (1.0 + np.abs(want[e]).max()), e
    if not transpose:  # the serving wrap reads the same
        np.testing.assert_array_equal(_np(tcommon.xbar_grouped_linear(torch.from_numpy(v), ww_t)), got)


def test_expert_group_deposit_matches_per_expert_dense():
    """Mirror of ``tests/test_operand_pipeline.py``'s test: the grouped
    operands (expert axis in the stack) deposit bit for bit as each
    expert's own dense gradient does, and as the reference's stacked fused
    update does."""
    rng = np.random.default_rng(23)
    E, Ct, d, f = 4, 24, 32, 16
    x = rng.normal(size=(E, Ct, d)).astype(np.float32)
    w = rng.normal(size=(E, d, f)).astype(np.float32)
    co = (rng.normal(size=(E, Ct, f)) * 1e-2).astype(np.float32)
    ww = tcommon.XbarWeight(torch.from_numpy(w), None, None, None, tcommon.OperandSlot((E,), grouped=True))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tcommon.xbar_grouped_linear(xt, ww) * torch.from_numpy(co)).sum().backward()
    g = ww.slot.grad()
    assert np.array_equal(_np(g.x), x) and np.array_equal(_np(g.dh), co)
    np.testing.assert_allclose(_np(xt.grad), np.einsum("ecf,edf->ecd", co, w), rtol=1e-5, atol=1e-6)

    q = rng.integers(-(2**27), 2**27, size=(E, d, f)).astype(np.int32)
    lr, fbits = 0.05, 20
    got = opa_fused_update(slice_weights(torch.from_numpy(q), DEFAULT_SPEC), g.x, g.dh, lr, fbits, DEFAULT_SPEC)
    want = jopa(jslice(jnp.asarray(q), JSPEC), jnp.asarray(x), jnp.asarray(co), jnp.float32(lr), jnp.int32(fbits),
                JSPEC, stochastic=False)
    assert np.array_equal(_np(got), np.asarray(want))
    planes0 = slice_weights(torch.from_numpy(q), DEFAULT_SPEC)
    for e in range(E):
        dense_e = torch.from_numpy(np.einsum("tm,tn->mn", x[e], co[e]))
        want_e = opa_dense_update(planes0[:, e].clone(), dense_e, lr, fbits, DEFAULT_SPEC)
        assert torch.equal(got[:, e], want_e), e
        ref_e = jdeposit(jslice(jnp.asarray(q[e]), JSPEC), jquantize(-jnp.float32(lr) * jnp.asarray(_np(dense_e)),
                                                                     jnp.int32(fbits), stochastic=False), JSPEC)
        assert np.array_equal(_np(want_e), np.asarray(ref_e)), e


def test_expert_slot_holds_the_capacity_tokens():
    """An expert wrap's slot takes ``G · C`` tokens an expert (the train
    step's ``expert_tokens``), and refuses any other count."""
    assert tstep.expert_tokens(CFG_T, 32) == 1 * tmlp.moe_capacity(CFG_T.moe, 32) == 128
    big = dataclasses.replace(CFG_T, moe=dataclasses.replace(CFG_T.moe, capacity_factor=1.25))
    assert tstep.expert_tokens(big, 4096) == 4 * max(2, int(1.25 * 1024 * 2 / 4))
    assert tstep.expert_tokens(dataclasses.replace(CFG_T, moe=None), 32) is None
    slot = tcommon.OperandSlot((2, 4), grouped=True, tokens=5)
    assert slot.layers == (2,)
    with pytest.raises(RuntimeError, match="expected 5"):
        slot.put(0, torch.zeros(4, 6, 3), torch.zeros(4, 6, 2))
    slot.put(0, torch.zeros(4, 5, 3), torch.zeros(4, 5, 2))
    slot.put(1, torch.ones(4, 5, 3), torch.ones(4, 5, 2))
    assert slot.grad().x.shape == (2, 4, 5, 3)


def _state_from_jax(state):
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return convert.train_state_from_jax(int(state.step), np_tree(state.digital), np_tree(state.sliced),
                                        state.rng, device="cpu")


def _plane_values(planes):
    p = _np(planes).astype(np.int64)
    acc = p[-1]
    for s in range(p.shape[0] - 2, -1, -1):
        acc = acc * 16 + p[s]
    return acc


@pytest.fixture(scope="module")
def start():
    return jstep.train_state_init(CFG_J, JPC(crs_every=2), jax.random.PRNGKey(0))


RULES = {"coverage": (jplan.coverage_rules, tplan.coverage_rules),
         "default": (jplan.default_rules, tplan.default_rules)}


@pytest.mark.parametrize("rules,microbatches", [("coverage", 1), ("default", 1), ("coverage", 2)],
                         ids=["coverage", "default", "coverage-mb2"])
def test_granite_smoke_step_matches_the_reference(start, rules, microbatches):
    """One lossless step from the same state and batch: under
    ``coverage_rules`` the router and the three expert banks are operand
    leaves (the banks ``group="expert"``), under ``default_rules`` dense."""
    rj, rt = RULES[rules]
    step_j = jax.jit(jstep.make_train_step(CFG_J, JPC(crs_every=2), jsched.constant(LR), plan_rules=rj(JPC()),
                                           microbatches=microbatches))
    step_t = tstep.make_train_step(CFG_T, TPC(crs_every=2), tsched.constant(LR), plan_rules=rt(TPC()),
                                   microbatches=microbatches, remat="none")
    bj, bt = JData(CFG_J.vocab, SEQ, B).batch(0), TData(CFG_T.vocab, SEQ, B, device="cpu").batch(0)
    if microbatches > 1:
        bj = jax.tree.map(lambda a: a.reshape(microbatches, B // microbatches, SEQ), bj)
        bt = {k: v.reshape(microbatches, B // microbatches, SEQ) for k, v in bt.items()}
    st = _state_from_jax(start)
    start_v = {tcommon.path_str(p): _plane_values(s.planes) for p, s in tree.leaves_with_path(st.sliced)
               if s is not None}
    sj, mj = step_j(start, bj)
    st, mt = step_t(st, bt)
    assert abs(float(mt["loss"]) - float(mj["loss"])) <= LOSS_RTOL * abs(float(mj["loss"]))
    assert float(mt["aux"]) > 0
    want = {jcommon.path_str(p): s for p, s in jax.tree_util.tree_flatten_with_path(
        sj.sliced, is_leaf=lambda x: isinstance(x, jpan.SlicedTensor))[0]}
    kinds = {pl.group for _, pl in tree.leaves_with_path(tplan.resolve_plan(
        tstep.param_shapes(st.digital, st.sliced), rt(TPC())))}
    assert ("expert" in kinds) == (rules == "coverage")
    for path, s in tree.leaves_with_path(st.sliced):
        if s is None:
            continue
        path = tcommon.path_str(path)
        vj, vt = _plane_values(want[path].planes), _plane_values(s.planes)
        assert np.abs(vj - vt).max() <= 1 + np.abs(vj - start_v[path]).max() * 2.0**-18, path
        if path != "embed":
            assert (np.abs(vj - vt) > 1).mean() <= LSB_SHARE, path
    want_d = {jcommon.path_str(p): v for p, v in jax.tree_util.tree_flatten_with_path(sj.digital)[0]}
    for path, d in tree.leaves_with_path(st.digital):
        if d is not None:
            np.testing.assert_allclose(_np(d), np.asarray(want_d[tcommon.path_str(path)]), rtol=DIGITAL_RTOL,
                                       atol=1e-7)


def _jax_moe_hetero_plan():
    """``examples/train_lm.py``'s ``--plan moe-hetero`` plan, as its
    ``main`` resolves it."""
    from examples import train_lm as JL

    opt = JPC(stochastic_round=True, crs_every=1024)
    cfg = dataclasses.replace(JL.config_100m(), arch_id="gemma-moe-100m", dtype=jnp.float32, pattern=(("moe", 12),),
                              d_ff=512, moe=jcommon.MoECfg(n_experts=16, top_k=4, d_ff_expert=512))
    rules = jplan.coverage_rules(opt) + (
        jplan.PlanRule("*/experts_*", expert_groups=(
            (4, jcommon.FidelityConfig(adc_bits_fwd=9, adc_bits_bwd=9)),
            (12, jcommon.FidelityConfig(adc_bits_fwd=6, adc_bits_bwd=6)),
        )),
    )
    from repro.models import lm as jlm

    return jplan.resolve_plan(jax.eval_shape(lambda: jlm.init_params(cfg, jax.random.PRNGKey(0))), rules)


def test_moe_hetero_plan_is_the_reference_s():
    jp = _jax_moe_hetero_plan()
    cfg, tp = TL.build_plan(TL.config_100m(), TPC(stochastic_round=True, crs_every=1024), "moe-hetero", False)
    assert cfg.pattern == (("moe", 12),) and cfg.moe.n_experts == 16 and cfg.moe.top_k == 4
    assert tplan.plan_summary(tp) == jplan.plan_summary(jp)
    assert tplan.plan_manifest(tp) == jplan.plan_manifest(jp)
    by = tplan.plan_by_path(tp)
    for key in ("experts_gate", "experts_up", "experts_down"):
        pl = by[f"groups/0/moe/{key}"]
        assert pl.group == "expert" and pl.grad == "operand"
        assert [(a, b, g.adc_bits_fwd) for a, b, g in pl.fidelity.group_slices(16)] == [(0, 4, 9), (4, 16, 6)]
    assert by["groups/0/moe/router"].grad == "operand" and by["groups/0/moe/router"].group is None
    lines = TL.expert_segments(tp)
    assert len(lines) == 3 and all("experts 0-3 adc(fwd,bwd)=(9, 9); experts 4-15 adc(fwd,bwd)=(6, 6)" in ln
                                   for ln in lines)


def test_expert_group_manifests_restore_in_both_packages():
    """A plan with ``group="expert"`` and ``expert_groups`` (at the leaf,
    folded into the fidelity, with a device model in a segment): each
    package's manifest reads back in the other, leaf for leaf."""
    dev = dict(write_noise=0.5, stuck_frac=0.01, stuck_seed=7, read_noise=0.02)
    jp = _jax_moe_hetero_plan()
    tp = TL.build_plan(TL.config_100m(), TPC(stochastic_round=True, crs_every=1024), "moe-hetero", False)[1]
    jpl = jplan.LeafPlan(mapped=True, grad="operand", group="expert", fidelity=jcommon.FidelityConfig(adc_bits_fwd=6),
                         expert_groups=((4, jcommon.FidelityConfig(adc_bits_fwd=9, device=jcommon.DeviceModel(**dev))),
                                        (12, None)))
    tpl = tplan.LeafPlan(mapped=True, grad="operand", group="expert", fidelity=tcommon.FidelityConfig(adc_bits_fwd=6),
                         expert_groups=((4, tcommon.FidelityConfig(adc_bits_fwd=9, device=tcommon.DeviceModel(**dev))),
                                        (12, None)))
    pairs = [(jplan.plan_manifest(jp), tplan.plan_manifest(tp)),
             ({"w": jplan.leaf_plan_to_dict(jpl)}, {"w": tplan.leaf_plan_to_dict(tpl)})]
    for mj, mt in pairs:
        assert mt == mj
        for path, d in mj.items():
            pt = tplan.leaf_plan_from_dict(d, path)
            assert tplan.leaf_plan_to_dict(pt) == d
            assert jplan.leaf_plan_to_dict(jplan.leaf_plan_from_dict(mt[path])) == mt[path]
    assert tplan.leaf_plan_from_dict(tplan.leaf_plan_to_dict(tpl)) == tpl
    # the resolved form folds the leaf's segments into its fidelity
    rj = jplan.resolve_leaf("g/experts_up", (4, 16, 16), jnp.float32,
                            (jplan.PlanRule("*", mapped=True, grad="operand", group="expert",
                                            expert_groups=jpl.expert_groups),))
    rt = tplan.resolve_leaf("g/experts_up", (4, 16, 16), torch.float32,
                            (tplan.PlanRule("*", mapped=True, grad="operand", group="expert",
                                            expert_groups=tpl.expert_groups),))
    assert tplan.leaf_plan_to_dict(rt) == jplan.leaf_plan_to_dict(rj)
    assert rt.fidelity.expert_groups == tpl.expert_groups
