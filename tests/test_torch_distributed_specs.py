"""The port's sharding rules (``repro_torch.distributed.sharding``), the
train state's and gradients' specs (``train.step``), the plan's shard hints
and ``attach_fidelity_shard_dims``, against the JAX package's pure
functions of the same shapes. Both sides take the same duck-typed logical
mesh (``launch.mesh.Mesh`` without a process group: only ``shape`` and
``axis_names`` are read). A spec compares as its tuple of entries."""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import plan as jplan  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.isa import plan_compile as jpc  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import PantherConfig as JPC  # noqa: E402
from repro.optim.panther import SlicedTensor as JSliced  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.isa import plan_compile as tpc  # noqa: E402
from repro_torch.launch.mesh import logical_mesh, make_debug_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import PantherConfig as TPC  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCHS = ("gemma_2b", "granite_moe_1b_a400m", "deepseek_v2_lite_16b", "zamba2_1p2b")
MESHES = ((2, 4), (4, 2), (1, 16))


def _norm(spec):
    """A spec as a plain tuple (None for an absent spec)."""
    return None if spec is None else tuple(spec)


def _jleaves(t, leaf=lambda x: isinstance(x, JP)):
    flat, _ = jax.tree_util.tree_flatten_with_path(t, is_leaf=lambda x: x is None or leaf(x))
    return flat


def _shapes(arch):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    return jcfg, tcfg, jax.eval_shape(lambda: jlm.init_params(jcfg, jax.random.PRNGKey(0))), tlm.param_shapes(tcfg)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_grad_specs_match_the_reference(arch, shape):
    """``param_specs`` and ``grad_specs`` (dense, and with ``operand`` the
    ``OuterProductGrad`` of specs of the matmul, im2col and expert groups,
    under the coverage plan) on every leaf of the SMOKE config."""
    jcfg, tcfg, jshapes, tshapes = _shapes(arch)
    mesh = logical_mesh(shape, ("data", "model"))
    jp = [_norm(s) for _, s in _jleaves(jshd.param_specs(jshapes, mesh))]
    tp = [_norm(s) for _, s in tree.leaves_sorted(shd.param_specs(tshapes, mesh))]
    assert jp == tp
    jplan_ = jplan.resolve_plan(jshapes, jplan.coverage_rules(JPC()))
    tplan_ = tplan.resolve_plan(tshapes, tplan.coverage_rules(TPC()))
    for fsdp in (False, True):
        for operand in (False, True):
            js = jstep.grad_specs(jcfg, JPC(), mesh=mesh, fsdp=fsdp, operand=operand, mb_batch=8, plan=jplan_)
            ts = tstep.grad_specs(tcfg, TPC(), mesh=mesh, fsdp=fsdp, operand=operand, mb_batch=8, plan=tplan_)
            want = [(_norm(s.x), _norm(s.dh), s.kind) if isinstance(s, jcommon.OuterProductGrad) else _norm(s)
                    for _, s in _jleaves(js, lambda x: isinstance(x, (JP, jcommon.OuterProductGrad)))]
            got = [(_norm(s.x), _norm(s.dh), s.kind) if isinstance(s, tcommon.OuterProductGrad) else _norm(s)
                   for _, s in tree.leaves_sorted(ts)]
            assert got == want, (fsdp, operand)
    if operand:
        kinds = {k for k in (g[2] for g in got if isinstance(g, tuple) and len(g) == 3 and isinstance(g[2], str))}
        assert "matmul" in kinds


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_match_the_reference(arch, fsdp):
    """Digital leaves by the name rules, planes ``[S, *w]`` like their
    matrix (and over 'data' under FSDP), ``frac_bits`` replicated."""
    jcfg, tcfg, _, _ = _shapes(arch)
    mesh = logical_mesh((2, 4), ("data", "model"))
    js = jstep.train_state_specs(jcfg, JPC(), mesh, fsdp=fsdp)
    ts = tstep.train_state_specs(tcfg, TPC(), mesh, fsdp=fsdp)
    assert [_norm(s) for _, s in _jleaves(js.digital)] == [_norm(s) for _, s in tree.leaves_sorted(ts.digital)]
    want = [None if s is None else (_norm(s.planes), _norm(s.frac_bits))
            for _, s in _jleaves(js.sliced, lambda x: isinstance(x, JSliced))]
    got = [None if s is None else (_norm(s.planes), _norm(s.frac_bits)) for _, s in tree.leaves_sorted(ts.sliced)]
    assert got == want
    assert _norm(ts.step) == _norm(js.step) == () and _norm(ts.rng) == _norm(js.rng)
    for B, G in ((8, 1), (8, 2), (3, 1)):
        jb, tb = jstep.batch_specs(jcfg, mesh, B, G), tstep.batch_specs(tcfg, mesh, B, G)
        assert {k: _norm(v) for k, v in tb.items()} == {k: _norm(v) for k, v in jb.items()}


def test_sanitize_spec_relocates_granite_vocab():
    """granite's vocab 49155 cannot shard 16-way: 'model' moves to the
    embedding's d_model axis, as in the reference, and the stored planes
    follow."""
    mesh = make_production_mesh()
    assert not mesh.live and mesh.shape == {"data": 16, "model": 16}
    cfg = tconfigs.get("granite_moe_1b_a400m")
    assert cfg.vocab == 49155
    for spec, shape in ((("model", None), (cfg.vocab, cfg.d_model)), (("model", None), (131, 64)),
                        (("model", None), (131, 33)), ((None, "model"), (64, 49155))):
        assert _norm(shd.sanitize_spec(shd.P(*spec), shape, mesh)) == _norm(jshd.sanitize_spec(JP(*spec), shape, mesh))
    assert shd.sanitize_spec(shd.P("model", None), (cfg.vocab, cfg.d_model), mesh) == shd.P(None, "model")
    ts = tstep.train_state_specs(cfg, TPC(), mesh)
    assert ts.sliced["embed"].planes == shd.P(None, None, "model")
    jcfg = jconfigs.get("granite_moe_1b_a400m")
    assert _norm(jstep.train_state_specs(jcfg, JPC(), mesh).sliced["embed"].planes) == (None, None, "model")


def test_fsdp_cache_and_page_pool_specs_match_the_reference():
    mesh = logical_mesh((4, 2), ("data", "model"))
    for spec, shape, n, tail in (((None, "model"), (4096, 1024), 16, 2), ((None, None, "model"), (48, 4096, 1024), 16, 2),
                                 ((None, "model"), (33, 1024), 16, 2), ((None, None, None), (8, 64, 48), 4, None)):
        assert _norm(shd.fsdp_spec(shd.P(*spec), shape, n, n_tail=tail)) == \
            _norm(jshd.fsdp_spec(JP(*spec), shape, n, n_tail=tail))
    for arch in ARCHS:
        for B in (8, 1, 3):
            jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
            jc = jlm.cache_specs(jcfg, B, 64)
            tc = tlm.cache_specs(tcfg, B, 64)
            want = [_norm(s) for _, s in _jleaves(jshd.cache_specs(mesh, jc, B))]
            got = [_norm(s) for _, s in tree.leaves_sorted(shd.cache_specs(mesh, tc, B))]
            assert got == want, (arch, B)
    for shape, lead in (((33, 16, 4, 64), 2), ((17, 16, 6, 12), 2), ((8, 4, 16, 64), 1), ((5, 7), 1)):
        assert _norm(shd.page_pool_spec(shape, mesh, lead)) == _norm(jshd.page_pool_spec(shape, mesh, lead))
    for B in (8, 6, 1, None):
        assert shd.data_axes_for(mesh, B) == jshd.data_axes_for(mesh, B)
        if B is not None:
            assert _norm(shd.activation_spec(mesh, B)) == _norm(jshd.activation_spec(mesh, B))
    pod = make_production_mesh(multi_pod=True)
    assert pod.axis_names == ("pod", "data", "model") and shd.batch_axes(pod) == ("pod", "data")
    assert _norm(shd.data_spec(pod, 64, 2)) == _norm(jshd.data_spec(pod, 64, 2)) == (("pod", "data"), None)
    assert make_debug_mesh().shape == {"data": 2, "model": 2}


@pytest.mark.parametrize("group", [None, "im2col", "expert"])
def test_operand_grad_spec_matches_the_reference(group):
    mesh = logical_mesh((2, 4), ("data", "model"))
    cases = {None: ("groups/0/attn/wqkv", (2, 64, 96)), "im2col": ("groups/0/mamba/conv_w", (2, 4, 64)),
             "expert": ("groups/0/moe/experts_up", (2, 8, 64, 32))}
    path, shape = cases[group]
    for mb in (8, 3, None):
        j = jshd.operand_grad_spec(path, shape, mesh, mb, group=group)
        t = shd.operand_grad_spec(path, shape, mesh, mb, group=group)
        assert (_norm(t.x), _norm(t.dh), t.kind) == (_norm(j.x), _norm(j.dh), j.kind)
        for hint in (("model", None), (None, "model")):
            j = jshd.operand_grad_spec(path, shape, mesh, mb, hint=hint, group=group)
            t = shd.operand_grad_spec(path, shape, mesh, mb, hint=hint, group=group)
            assert (_norm(t.x), _norm(t.dh)) == (_norm(j.x), _norm(j.dh))
    j = jshd.fidelity_plane_specs(path, shape, mesh)
    t = shd.fidelity_plane_specs(path, shape, mesh)
    assert [_norm(s) for s in t] == [_norm(s) for s in j]


@pytest.mark.parametrize("arch", ARCHS)
def test_attach_fidelity_shard_dims_matches_the_reference(arch):
    """Column-parallel fidelity leaves read with shard_dim 1, row-parallel
    0, a plan hint wins over the name rules, a model-less mesh leaves the
    plan as it is; under the coverage rules the expert banks and the conv
    taps too."""
    _, _, jshapes, tshapes = _shapes(arch)
    extra = ("*/mlp/wo", (None, "model"))
    for rules in ("default_rules", "coverage_rules"):
        jr = getattr(jplan, rules)(JPC(), fidelity=jcommon.FidelityConfig()) + (jplan.PlanRule(extra[0], shard=extra[1]),)
        tr = getattr(tplan, rules)(TPC(), fidelity=tcommon.FidelityConfig()) + (tplan.PlanRule(extra[0], shard=extra[1]),)
        for shape in ((2, 4), (8, 1)):
            mesh = logical_mesh(shape, ("data", "model"))
            for jparams, tparams in ((jshapes, tshapes), (None, None)):
                jp = jplan.attach_fidelity_shard_dims(jplan.resolve_plan(jshapes, jr), mesh, jparams)
                tp = tplan.attach_fidelity_shard_dims(tplan.resolve_plan(tshapes, tr), mesh, tparams)
                want = {p: (pl.fidelity.shard_dim if pl.fidelity else "-", pl.shard)
                        for p, pl in jplan.plan_by_path(jp).items()}
                got = {p: (pl.fidelity.shard_dim if pl.fidelity else "-", pl.shard)
                       for p, pl in tplan.plan_by_path(tp).items()}
                assert got == want, (rules, shape)
    if arch == "gemma_2b":
        mesh = logical_mesh((2, 4), ("data", "model"))
        tp = tplan.attach_fidelity_shard_dims(tplan.resolve_plan(tshapes, tr), mesh, tshapes)
        dims = {p: pl.fidelity.shard_dim for p, pl in tplan.plan_by_path(tp).items() if pl.fidelity is not None}
        assert dims and all(d == (1 if p.endswith(("wqkv", "wi_gate", "wi_up", "mlp/wo")) else 0)
                            for p, d in dims.items())
        assert "shard=(None, 'model')" in tplan.plan_summary(tp)
        assert tplan.plan_summary(tp) == jplan.plan_summary(jplan.attach_fidelity_shard_dims(
            jplan.resolve_plan(jshapes, jr), mesh, jshapes))


def test_plan_manifest_carries_shard_hints_both_ways():
    """A manifest's ``shard`` and ``fidelity.shard_dim`` read back and
    write out as the reference's, in both directions."""
    _, _, jshapes, tshapes = _shapes("gemma_2b")
    mesh = logical_mesh((2, 2), ("data", "model"))
    jr = jplan.default_rules(JPC(), fidelity=jcommon.FidelityConfig(adc_bits_fwd=9)) + (
        jplan.PlanRule("*/attn/wo", shard=("model", None)),)
    tr = tplan.default_rules(TPC(), fidelity=tcommon.FidelityConfig(adc_bits_fwd=9)) + (
        tplan.PlanRule("*/attn/wo", shard=("model", None)),)
    jp = jplan.attach_fidelity_shard_dims(jplan.resolve_plan(jshapes, jr), mesh, jshapes)
    tp = tplan.attach_fidelity_shard_dims(tplan.resolve_plan(tshapes, tr), mesh, tshapes)
    jm, tm = jplan.plan_manifest(jp), tplan.plan_manifest(tp)
    assert jm == tm
    by = tplan.plan_by_path(tp)
    for path, d in jm.items():
        assert tplan.leaf_plan_from_dict(d, path) == by[path]
        assert jplan.leaf_plan_from_dict(tm[path]) == jplan.plan_by_path(jp)[path]


def test_compile_reads_shard_hints_like_the_reference():
    """``plan_compile._shard_dim`` from ``FidelityConfig.shard_dim`` or a
    ``LeafPlan.shard`` hint, and the compiled step of a hinted plan split
    over 2 shards, equal the reference's."""
    _, _, jshapes, tshapes = _shapes("gemma_2b")
    for hint, fid_dim in (((None, "model"), None), (("model", None), None), (None, 1), (("model", None), 1)):
        jfid = jcommon.FidelityConfig(adc_bits_fwd=9, shard_dim=fid_dim)
        tfid = tcommon.FidelityConfig(adc_bits_fwd=9, shard_dim=fid_dim)
        assert tpc._shard_dim(tplan.LeafPlan(mapped=True, grad="operand", fidelity=tfid, shard=hint)) == \
            jpc._shard_dim(jplan.LeafPlan(mapped=True, grad="operand", fidelity=jfid, shard=hint))
    jr = jplan.default_rules(JPC()) + (jplan.PlanRule("*/mlp/*", shard=(None, "model")),)
    tr = tplan.default_rules(TPC()) + (tplan.PlanRule("*/mlp/*", shard=(None, "model")),)
    jprog = jpc.compile_plan(jshapes, jplan.resolve_plan(jshapes, jr), tokens=16, n_shards=2)
    tprog = tpc.compile_plan(tshapes, tplan.resolve_plan(tshapes, tr), tokens=16, n_shards=2)
    assert {c: [repr(i) for i in v] for c, v in tprog.cores.items()} == \
        {c: [repr(i) for i in v] for c, v in jprog.cores.items()}
    assert tprog.meta["n_shards"] == jprog.meta["n_shards"] == 2


def test_fidelity_config_shard_dim_is_a_field_like_the_reference():
    assert dataclasses.replace(tcommon.FidelityConfig(), shard_dim=0).shard_dim == 0
    assert {f.name for f in dataclasses.fields(tcommon.FidelityConfig)} >= {"shard_dim"}
    assert tplan.LeafPlan(shard=["model", None]).shard == ("model", None)
