"""The port's checkpoints (``repro_torch.checkpoint``) and plan serialization
against the JAX package: every case of ``tests/test_checkpoint.py`` on the
port, checkpoints crossing between the two packages in both directions,
the plan manifest, and a resumed launcher run against an uninterrupted one.

Tolerances: none. Every comparison is bit for bit: checkpoints store the
leaves as they are (int8 planes, int32 ``frac_bits``, f32 digital leaves,
the int32 step and the uint32 rng words), the manifests are equal dicts, and
a resumed run on the CPU repeats the uninterrupted run's arithmetic exactly.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import plan as jplan  # noqa: E402
from repro.checkpoint import restore_latest as jrestore  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.core import SliceSpec as JSpec  # noqa: E402
from repro.data import SyntheticLMDataset as JData  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import PantherConfig as JPC  # noqa: E402
from repro.optim.schedules import constant as jconstant  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, list_checkpoints, restore_latest, save_checkpoint  # noqa: E402
from repro_torch.core.slicing import SliceSpec as TSpec  # noqa: E402
from repro_torch.core.slicing import slice_weights, unslice_weights  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import PantherConfig as TPC  # noqa: E402
from repro_torch.optim.panther import SlicedTensor  # noqa: E402
from repro_torch.train.step import TrainState, param_shapes, train_state_init  # noqa: E402


@pytest.fixture
def state():
    return train_state_init(tconfigs.get_smoke("gemma_2b"), TPC(), 0, device="cpu")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(t):
    """``[(path, numpy), ...]`` of a port tree, SlicedTensors as their planes
    (``[S, *stack, M, N]``) and frac_bits, host values as arrays."""
    out = []
    for path, leaf in tree.leaves_sorted(t._asdict() if isinstance(t, TrainState) else t):
        if isinstance(leaf, SlicedTensor):
            out += [(path + ("planes",), _np(leaf.planes)), (path + ("frac_bits",), _np(leaf.frac_bits))]
        elif leaf is not None:
            out.append((path, np.asarray(_np(leaf))))
    return out


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), p


# ------------------------- tests/test_checkpoint.py --------------------------


def test_save_restore_roundtrip(tmp_path, state):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 10, state)
    restored, step = restore_latest(d, state)
    assert step == 10
    _assert_same(state, restored)
    assert isinstance(restored.step, int) and isinstance(restored.rng, tuple) and restored.rng == state.rng
    # the port's layout: a stacked leaf's planes come back as a view of [*stack, S, M, N] storage
    for (_, a), (_, b) in zip(tree.leaves_with_path(state.sliced), tree.leaves_with_path(restored.sliced)):
        if a is not None:
            assert a.planes.stride() == b.planes.stride() and b.frac_bits.dtype == torch.int32


def test_uncommitted_tmp_ignored(tmp_path, state):
    """A crash mid-write leaves only .tmp: restore skips it, and the next
    save collects it."""
    d = str(tmp_path / "ck")
    save_checkpoint(d, 5, state)
    os.makedirs(os.path.join(d, "step_000000007.tmp"))
    _, step = restore_latest(d, state)
    assert step == 5
    save_checkpoint(d, 8, state)
    assert not any(e.endswith(".tmp") for e in os.listdir(d))


def test_gc_keeps_last(tmp_path, state):
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(d, s, state, keep_last=2)
    assert list_checkpoints(d) == [4, 5]


def test_resave_of_a_committed_step_keeps_the_first_commit(tmp_path, state):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 3, state)
    other = state._replace(digital=tree.map(lambda x: None if x is None else x + 1, state.digital))
    save_checkpoint(d, 3, other)
    restored, _ = restore_latest(d, state)
    _assert_same(state, restored)


def test_manager_save_every(tmp_path, state):
    m = CheckpointManager(str(tmp_path / "ck"), every=10)
    assert m.maybe_save(5, state) is None
    assert m.maybe_save(0, state) is None
    assert m.maybe_save(10, state) is not None


def test_restore_into_training_continues(tmp_path, state):
    """The restored planes are byte-identical, and a step from the restored
    state equals a step from the original bit for bit."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.optim.schedules import constant
    from repro_torch.train.step import make_train_step

    d = str(tmp_path / "ck")
    save_checkpoint(d, 3, state)
    restored, _ = restore_latest(d, state)
    cfg = tconfigs.get_smoke("gemma_2b")
    step = make_train_step(cfg, TPC(crs_every=1), constant(3e-2), remat="none")  # a CRS step on the restored planes
    batch = SyntheticLMDataset(cfg.vocab, 8, 2, device="cpu").batch(0)
    a, ma = step(restored, batch)
    b, mb = step(state, batch)
    assert float(ma["loss"]) == float(mb["loss"]) and float(ma["grad_norm"]) == float(mb["grad_norm"])
    _assert_same(a, b)


def test_restore_by_path_survives_key_reordering(tmp_path):
    tree_ = {"alpha": torch.arange(4.0), "beta": torch.ones((2, 2))}
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, tree_)
    restored, step = restore_latest(d, {"beta": torch.zeros((2, 2)), "alpha": torch.zeros(4)})
    assert step == 1 and list(restored) == ["beta", "alpha"]
    assert torch.equal(restored["alpha"], torch.arange(4.0)) and torch.equal(restored["beta"], torch.ones((2, 2)))


def test_restore_migrates_mla_wq_dkv_fusion(tmp_path):
    """Separate ``wq``/``w_dkv`` float leaves restore into a fused ``wq_dkv``
    template, concatenated exactly."""
    rng = np.random.default_rng(0)
    wq = rng.normal(size=(2, 16, 24)).astype(np.float32)
    w_dkv = rng.normal(size=(2, 16, 12)).astype(np.float32)
    d = str(tmp_path / "ck")
    save_checkpoint(d, 2, {"groups": [{"attn": {"wq": torch.from_numpy(wq), "w_dkv": torch.from_numpy(w_dkv),
                                                "wo": torch.ones((4, 4))}}]})
    template = {"groups": [{"attn": {"wq_dkv": torch.zeros((2, 16, 36)), "wo": torch.zeros((4, 4))}}]}
    restored, step = restore_latest(d, template)
    assert step == 2
    assert np.array_equal(_np(restored["groups"][0]["attn"]["wq_dkv"]), np.concatenate([wq, w_dkv], axis=-1))
    assert bool((restored["groups"][0]["attn"]["wo"] == 1.0).all())


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_restore_migrates_sliced_wq_dkv(tmp_path, writer):
    """The sliced migration is integer-exact on the shared grid, values past
    the f32 mantissa included (|q| > 2^24), from a checkpoint written by
    either package, and the same as the reference's migration."""
    rng = np.random.default_rng(1)
    spec = TSpec()
    qa = rng.integers(-(2**30), 2**30, size=(8, 12)).astype(np.int32)
    qb = rng.integers(-(2**30), 2**30, size=(8, 6)).astype(np.int32)
    fq, fd = 28, 30
    d = str(tmp_path / "ck")
    if writer == "port":
        save_checkpoint(d, 4, {"attn": {
            "wq": SlicedTensor(slice_weights(torch.from_numpy(qa), spec), torch.tensor(fq, dtype=torch.int32)),
            "w_dkv": SlicedTensor(slice_weights(torch.from_numpy(qb), spec), torch.tensor(fd, dtype=torch.int32))}})
    else:
        from repro.core import slice_weights as jslice
        from repro.optim.panther import SlicedTensor as JST

        jsave(d, 4, {"attn": {"wq": JST(jslice(jnp.asarray(qa), JSpec()), jnp.int32(fq)),
                              "w_dkv": JST(jslice(jnp.asarray(qb), JSpec()), jnp.int32(fd))}})
    template = {"attn": {"wq_dkv": SlicedTensor(torch.zeros((8, 8, 18), dtype=torch.int8),
                                                torch.tensor(0, dtype=torch.int32))}}
    st = restore_latest(d, template)[0]["attn"]["wq_dkv"]
    f = int(st.frac_bits)
    got = unslice_weights(st.planes, spec).numpy().astype(np.int64)
    lim = spec.canonical_limit
    want = np.concatenate([np.clip(qa.astype(np.int64), -lim, lim) * 2 ** (f - fq),
                           np.rint(np.clip(qb.astype(np.int64), -lim, lim) * 2.0 ** (f - fd)).astype(np.int64)],
                          axis=-1)
    assert np.array_equal(got, np.clip(want, -lim, lim))
    from repro.optim.panther import SlicedTensor as JST

    jt = {"attn": {"wq_dkv": JST(jnp.zeros((8, 8, 18), jnp.int8), jnp.int32(0))}}
    ref = jrestore(d, jt)[0]["attn"]["wq_dkv"]
    assert int(ref.frac_bits) == f and np.array_equal(np.asarray(ref.planes), _np(st.planes))


def test_restore_missing_path_errors(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, {"a": torch.zeros(3)})
    with pytest.raises(KeyError):
        restore_latest(d, {"b": torch.zeros(3)})


def test_legacy_positional_manifest(tmp_path, state):
    """A manifest without leaf paths restores positionally into a template
    of the same structure, and refuses one of another leaf count."""
    d = str(tmp_path / "ck")
    path = save_checkpoint(d, 6, state)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    for m in manifest["leaves"]:
        del m["path"]
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    restored, step = restore_latest(d, state)
    assert step == 6
    _assert_same(state, restored)
    with pytest.raises(ValueError, match="legacy"):
        restore_latest(d, {"a": torch.zeros(3)})


def test_bf16_leaves_are_refused_by_name(tmp_path):
    with pytest.raises(ValueError, match="w_bf16"):
        save_checkpoint(str(tmp_path / "ck"), 1, {"w_bf16": torch.zeros(3, dtype=torch.bfloat16)})
    d = str(tmp_path / "ref")
    jsave(d, 1, {"w_bf16": jnp.zeros(3, jnp.bfloat16)})  # the reference writes it through ml_dtypes
    with pytest.raises(ValueError, match="w_bf16"):
        restore_latest(d, {"w_bf16": torch.zeros(3)})


def test_restore_places_tensors_where_asked(tmp_path, state):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, state)
    restored, _ = restore_latest(d, state, device="cpu")
    sl = [s for _, s in tree.leaves_with_path(restored.sliced) if s is not None]
    assert all(s.planes.device.type == "cpu" and s.frac_bits.device.type == "cpu" for s in sl)


# ------------------------- across the two packages ---------------------------


@pytest.fixture(scope="module")
def jax_state():
    """The reference's smoke train state after one step: step 1, planes
    that the update moved."""
    cfg = jget_smoke("gemma_2b")
    opt = JPC()
    st = jstep.train_state_init(cfg, opt, jax.random.PRNGKey(0))
    step = jax.jit(jstep.make_train_step(cfg, opt, jconstant(3e-2)))
    st, _ = step(st, JData(cfg.vocab, 8, 2).batch(0))
    return st


def _port_of(st):
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return convert.train_state_from_jax(np.asarray(st.step), np_tree(st.digital), np_tree(st.sliced),
                                        np.asarray(st.rng), device="cpu")


def test_a_port_checkpoint_restores_in_the_reference(tmp_path, jax_state):
    st = jax_state
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, _port_of(st))
    restored, step = jrestore(d, st)
    assert step == 1
    want, got = jax.tree.leaves(st), jax.tree.leaves(restored)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_a_reference_checkpoint_restores_in_the_port(tmp_path, jax_state):
    st = jax_state
    d = str(tmp_path / "ck")
    jsave(d, 1, st)
    template = train_state_init(tconfigs.get_smoke("gemma_2b"), TPC(), 0, device="cpu")
    restored, step = restore_latest(d, template)
    assert step == 1 and restored.step == 1 and restored.rng == (0, 7)
    _assert_same(_port_of(st), restored)


# ------------------------------ plan manifests --------------------------------

DEV = dict(write_noise=4.0, asym_up=1.2, asym_down=0.8, stuck_frac=0.02, stuck_seed=3, read_noise=0.01)


def _plans(extra=()):
    """The same rules resolved by both packages on the smoke gemma-2b in two
    groups: the default mapping, a device on every operand leaf, group 0 at
    uniform-6 with 9-bit reads, group 1 at 6-bit reads."""
    jcfg = dataclasses.replace(jget_smoke("gemma_2b"), pattern=(("dense", 2), ("dense", 2)), n_layers=4)
    tcfg = dataclasses.replace(tconfigs.get_smoke("gemma_2b"), pattern=(("dense", 2), ("dense", 2)), n_layers=4)
    jrules = jplan.default_rules(JPC(), fidelity=jcommon.FidelityConfig(device=jcommon.DeviceModel(**DEV))) + (
        jplan.PlanRule("groups/0/*", spec=JSpec.uniform(6),
                       fidelity=jcommon.FidelityConfig(adc_bits_fwd=9, adc_bits_bwd=9,
                                                       device=jcommon.DeviceModel(**DEV))),
        jplan.PlanRule("groups/1/*", fidelity=jcommon.FidelityConfig(adc_bits_fwd=6, adc_bits_bwd=6)),
    )
    trules = tplan.default_rules(TPC(), fidelity=tcommon.FidelityConfig(device=tcommon.DeviceModel(**DEV))) + (
        tplan.PlanRule("groups/0/*", spec=TSpec.uniform(6),
                       fidelity=tcommon.FidelityConfig(adc_bits_fwd=9, adc_bits_bwd=9,
                                                       device=tcommon.DeviceModel(**DEV))),
        tplan.PlanRule("groups/1/*", fidelity=tcommon.FidelityConfig(adc_bits_fwd=6, adc_bits_bwd=6)),
    )
    shapes = jax.eval_shape(lambda: jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    return jplan.resolve_plan(shapes, jrules), tplan.resolve_plan(tlm.param_shapes(tcfg), trules)


def test_plan_manifests_of_both_packages_are_equal():
    jp, tp = _plans()
    want, got = jplan.plan_manifest(jp), tplan.plan_manifest(tp)
    assert got == want
    assert json.loads(json.dumps(got)) == want  # JSON-safe
    assert {m["spec"] for m in got.values() if m["mapped"]} == {"44466555", "66666666"}


def test_leaf_plans_read_back_from_either_package():
    jp, tp = _plans()
    by = tplan.plan_by_path(tp)
    for path, d in jplan.plan_manifest(jp).items():
        assert tplan.leaf_plan_from_dict(d, path) == by[path]
        assert tplan.leaf_plan_to_dict(tplan.leaf_plan_from_dict(d, path)) == d


@pytest.mark.parametrize("field,value", [("shard", ["model", None]), ("group", "expert"),
                                         ("expert_groups", [[4, None]]), ("fidelity.shard_dim", 0),
                                         ("fidelity.expert_groups", [[4, None]])])
def test_unported_plan_fields_raise_naming_the_leaf(field, value):
    """Every plan field of the reference's manifests is ported now: the
    shard hints (the mesh slice), the operand group kind and the expert
    segments (the MoE slice) read back and write out unchanged."""
    d = tplan.leaf_plan_to_dict(tplan.LeafPlan(mapped=True, grad="operand", fidelity=tcommon.FidelityConfig()))
    if field.startswith("fidelity."):
        d["fidelity"][field.split(".")[1]] = value
    else:
        d[field] = value
    assert tplan.leaf_plan_to_dict(tplan.leaf_plan_from_dict(d, "groups/0/attn/wqkv")) == d
    d2 = tplan.leaf_plan_to_dict(tplan.LeafPlan(mapped=True, grad="operand", fidelity=tcommon.FidelityConfig()))
    d2["fidelity"].update(use_kernel=True, interpret=True)  # JAX runtime switches: ignored
    assert tplan.leaf_plan_from_dict(d2).fidelity == tcommon.FidelityConfig()


def test_check_plan_compat_raises_where_the_reference_does():
    jp, tp = _plans()
    saved = jplan.plan_manifest(jp)
    tplan.check_plan_compat(saved, tp)  # the same plan
    # an ADC or read-noise difference is a runtime choice
    path = "groups/1/attn/wqkv"
    s2 = json.loads(json.dumps(saved))
    s2[path]["fidelity"]["adc_bits_fwd"] = 9
    tplan.check_plan_compat(s2, tp)
    jplan.check_plan_compat(s2, jp)
    for mutate in ("spec", "mapped", "write_noise", "stuck_seed"):
        s3 = json.loads(json.dumps(saved))
        p = "groups/0/mlp/wo" if mutate in ("write_noise", "stuck_seed") else path
        if mutate == "spec":
            s3[p]["spec"] = "55555555"
        elif mutate == "mapped":
            s3[p]["mapped"] = False
        else:
            s3[p]["fidelity"]["device"][mutate] += 1
        with pytest.raises(ValueError, match=p):
            tplan.check_plan_compat(s3, tp)
        with pytest.raises(ValueError, match=p):
            jplan.check_plan_compat(s3, jp)


def test_restore_under_another_spec_refuses(tmp_path, state):
    shapes = param_shapes(state.digital, state.sliced)
    plan = tplan.resolve_plan(shapes, tplan.default_rules(TPC()))
    d = str(tmp_path / "ck")
    CheckpointManager(d, every=1, plan=plan).maybe_save(1, state)
    other = tplan.resolve_plan(shapes, tplan.default_rules(TPC()) + (tplan.PlanRule("embed", spec=TSpec.uniform(6)),))
    with pytest.raises(ValueError, match="embed"):
        CheckpointManager(d, plan=other).restore(state)
    assert CheckpointManager(d, plan=plan).restore(state)[1] == 1


# ------------------------------ the launcher ---------------------------------


def test_resumed_launcher_run_equals_the_uninterrupted_one(tmp_path):
    """2 steps, then a resume to 4, against 4 uninterrupted steps: the
    resumed steps' loss and grad norm and every leaf of the last commit bit
    for bit. Step 2 is a CRS step (``--crs-every 3``). The resume starts at
    the step after the checkpoint's (``rstep + 1``): the reference's launcher
    starts at ``rstep`` and trains that batch twice."""
    args = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16", "--crs-every", "3", "--ckpt-every", "2",
            "--log-every", "1", "--fidelity", "adc9"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    first = tlaunch.main(args + ["--steps", "2", "--ckpt-dir", a])
    resumed = tlaunch.main(args + ["--steps", "4", "--ckpt-dir", a])
    whole = tlaunch.main(args + ["--steps", "4", "--ckpt-dir", b])
    assert len(first) == 2 and len(resumed) == 2 and len(whole) == 4
    for k in ("loss", "grad_norm"):
        assert [m[k] for m in first + resumed] == [m[k] for m in whole], k
    assert list_checkpoints(a) == [1, 2, 3] and list_checkpoints(b) == [2, 3]
    template = train_state_init(tconfigs.get_smoke("gemma_2b"), TPC(), 0, device="cpu")
    ra, sa = restore_latest(a, template)
    rb, sb = restore_latest(b, template)
    assert sa == sb == 3 and ra.step == 4
    _assert_same(ra, rb)
