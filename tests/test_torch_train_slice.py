"""The training slice against the JAX package: a gemma-family config at
kernel-shaped widths (d_model 128, 4 heads x 32, MQA, GeGLU d_ff 256, vocab
256, 2 layers, f32), the JAX train state carried across by
``repro_torch.convert``.

Tolerances:
* the update's leaf order and the synthetic batches: exact; the
  learning-rate schedules within ``4e-7`` relative (an f32 ulp or two of
  ``cos``, whose libm differs);
* ``update_split`` on given gradients (dense leaves, and operand leaves with
  f32-exact operands): planes bit for bit, digital leaves bit for bit;
* whole lossless train steps: loss within ``1e-5`` relative, grad norm
  within ``1e-4`` relative, digital leaves within ``1e-5`` relative. The two
  frameworks sum the f32 gradients in other orders, so some stochastic
  roundings land a grid step apart, and where the weight grid (``2^-31``
  for the embedding) is finer than f32 resolves the update, several. After
  the first step every mapped leaf is within ``1 + 2^-18 · max|update|``
  grid LSB of the reference's, and at most 0.5% of an operand leaf's
  elements are off by more than one LSB. Over both steps (the second runs
  CRS) a one-LSB difference can cross a saturated plane and become a digit
  of a higher plane, so there every mapped leaf's dequantized weights are
  held within ``1e-5 · max|w|``, with the same 0.5% share;
* the operand and dense pipelines of the port: bit for bit (the same f32
  contraction and the same draw);
* adc9 training: every crossbar read of a step, forward and transpose,
  against the reference's read on the same planes and input, within
  ``1e-3 · (1 + max|out|)``. The adc9 read is discontinuous in its input, so
  whole adc9 steps of two frameworks are not held to each other (see
  ``tests/test_torch_serve_slice.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import mvm as jmvm  # noqa: E402
from repro.data import SyntheticLMDataset as JData  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import PantherConfig as JPC  # noqa: E402
from repro.optim import panther as jpan  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data import SyntheticLMDataset as TData  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import PantherConfig as TPC  # noqa: E402
from repro_torch.optim import panther as tpan  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

WIDE = dict(d_model=128, n_heads=4, head_dim=32, n_kv_heads=1, d_ff=256, vocab=256,
            n_layers=2, pattern=(("dense", 2),))
CFG_J = dataclasses.replace(jconfigs.get_smoke("gemma_2b"), dtype=jnp.float32, **WIDE)
CFG_T = dataclasses.replace(tconfigs.get_smoke("gemma_2b"), dtype=torch.float32, **WIDE)
B, SEQ, LR, STEPS = 2, 16, 1e-2, 2
LOSS_RTOL, GNORM_RTOL, DIGITAL_RTOL, WEIGHT_RTOL = 1e-5, 1e-4, 1e-5, 1e-5
LSB_SHARE = 0.005


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _state_from_jax(state):
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return convert.train_state_from_jax(int(state.step), np_tree(state.digital), np_tree(state.sliced),
                                        state.rng, device="cpu")


def _copy_state(state):
    """A deep copy that keeps the layer-major plane storage."""
    def cp(s):
        if s is None:
            return None
        lead = s.planes.dim() - 3
        return tpan.SlicedTensor(s.planes.movedim(0, lead).clone().movedim(lead, 0), s.frac_bits.clone())

    return tstep.TrainState(state.step, tree.map(lambda d: None if d is None else d.clone(), state.digital),
                            tree.map(cp, state.sliced), state.rng)


def _plane_values(planes):
    p = _np(planes).astype(np.int64)
    acc = p[-1]
    for s in range(p.shape[0] - 2, -1, -1):
        acc = acc * 16 + p[s]
    return acc


def _by_path(t, is_leaf=None):
    return {jcommon.path_str(p): v for p, v in jax.tree_util.tree_flatten_with_path(t, is_leaf=is_leaf)[0]}


def _t_by_path(t):
    return {tcommon.path_str(p): v for p, v in tree.leaves_with_path(t) if v is not None}


@pytest.fixture(scope="module")
def start():
    state_j = jstep.train_state_init(CFG_J, JPC(crs_every=2), jax.random.PRNGKey(0))
    return state_j


def test_update_leaf_order_matches_jax_flatten(start):
    params_j = jlm.init_params(jconfigs.get_smoke("gemma_2b"), jax.random.PRNGKey(0))
    params_t = tlm.init_params(tconfigs.get_smoke("gemma_2b"), 0, device="cpu")
    want = [jcommon.path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(params_j)[0]]
    got = [tcommon.path_str(p) for p, _ in tree.leaves_sorted(params_t)]
    assert got == want
    assert got[:2] == ["embed", "final_ln/scale"]  # not init_params' insertion order
    # the operand gradient tree flattens the same way: one leaf per OuterProductGrad
    grads_j = jax.tree.map(lambda p: p, params_j)
    grads_j["groups"][0]["attn"]["wqkv"] = jcommon.OuterProductGrad(jnp.zeros((2, 3, 64)), jnp.zeros((2, 3, 96)))
    flat_j = [jcommon.path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(
        grads_j, is_leaf=lambda x: isinstance(x, jcommon.OuterProductGrad))[0]]
    assert flat_j == want


def test_synthetic_data_and_schedules_match_jax():
    dj, dt = JData(256, SEQ, B, seed=3), TData(256, SEQ, B, seed=3, device="cpu")
    for step in (0, 5):
        bj, bt = dj.batch(step), dt.batch(step)
        for k in ("inputs", "labels"):
            assert np.array_equal(np.asarray(bj[k]), _np(bt[k]))
    pairs = [(jsched.constant(3e-2), tsched.constant(3e-2)),
             (jsched.cosine(3e-2, 5, 100), tsched.cosine(3e-2, 5, 100)),
             (jsched.wsd(3e-2, 5, 70, 25), tsched.wsd(3e-2, 5, 70, 25))]
    for fj, ft in pairs:
        for step in (0, 1, 4, 5, 6, 50, 74, 75, 76, 90, 99, 120):
            want, got = float(fj(step)), ft(step)
            assert abs(want - got) <= 4e-7 * abs(want), (step, want, got)


def test_outer_product_grad_matches_jax(monkeypatch):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 40, 24)).astype(np.float32)
    dh = rng.normal(size=(2, 40, 16)).astype(np.float32)
    gj = jcommon.OuterProductGrad(jnp.asarray(x), jnp.asarray(dh))
    gt = tcommon.OuterProductGrad(torch.from_numpy(x), torch.from_numpy(dh))
    assert gt.shape == gj.shape == (2, 24, 16)
    np.testing.assert_allclose(_np(gt.materialize()), np.asarray(gj.materialize()), rtol=1e-5, atol=1e-5)
    want = float(gj.sq_norm())
    assert abs(float(gt.sq_norm()) - want) <= 1e-5 * want
    monkeypatch.setattr(tcommon.OuterProductGrad, "SQ_NORM_CHUNK", 16)  # ragged blocks: 16 + 16 + 8
    assert abs(float(gt.sq_norm()) - want) <= 1e-5 * want
    np.testing.assert_allclose(_np(gt.scale_dh(0.5).dh), np.asarray(gj.scale_dh(0.5).dh))


def test_operand_slot_written_twice_raises():
    w = torch.randn(8, 8)
    ww = tcommon.XbarWeight(w, None, None, None, tcommon.OperandSlot(()))
    x = torch.randn(3, 8, requires_grad=True)
    y = tcommon.xbar_linear(x, ww) + tcommon.xbar_linear(x, ww)
    with pytest.raises(RuntimeError, match="twice"):
        y.sum().backward()
    ww = tcommon.XbarWeight(w, None, None, None, tcommon.OperandSlot(()))
    tcommon.xbar_linear(x, ww).sum().backward()
    g = ww.slot.grad()
    torch.testing.assert_close(g.materialize(), x.detach().T @ torch.ones(3, 8))
    assert w.grad is None  # the weight gets no dense gradient
    with pytest.raises(RuntimeError, match="not filled"):
        tcommon.OperandSlot((2,)).grad()


def _given_grads(rng, params_j):
    """Dense f32 gradients for every leaf, and f32-exact operands for the
    operand leaves (so both frameworks' f32 contractions are exact)."""
    grads_j = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32) * 1e-2), params_j)
    for gi, group in enumerate(grads_j["groups"]):
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
def test_update_split_on_given_gradients_bit_identical(start, step):
    rng = np.random.default_rng(10 + step)
    params_j = jpan.materialize_split(start.digital, start.sliced, JPC())
    grads_j = _given_grads(rng, params_j)
    # the reference's CPU dispatch (its jnp oracle): with f32 operands its f32
    # contraction is exact here, as the port's is
    dj, sj = jpan.update_split(grads_j, start.digital, start.sliced, jnp.int32(step), jnp.float32(LR),
                               JPC(crs_every=2), rng=start.rng)
    st = _state_from_jax(start)
    dt, stt = tpan.update_split(_grads_to_port(grads_j), st.digital, st.sliced, step, LR, TPC(crs_every=2),
                                rng=st.rng)
    want_s = _by_path(sj, is_leaf=lambda x: isinstance(x, jpan.SlicedTensor))
    for path, s in _t_by_path(stt).items():
        assert np.array_equal(np.asarray(want_s[path].planes), _np(s.planes)), path
    want_d = _by_path(dj)
    for path, d in _t_by_path(dt).items():
        assert np.array_equal(np.asarray(want_d[path]), _np(d)), path
    rep_j = _by_path(jpan.saturation_report(jpan.PantherState(0, sj, None)))
    for path, sat in _t_by_path(tpan.saturation_report(stt)).items():
        np.testing.assert_allclose(_np(sat), np.asarray(rep_j[path + "/"] if path + "/" in rep_j else rep_j[path]),
                                   rtol=1e-6, atol=1e-7)
    gn_j = float(jpan.global_grad_norm(grads_j))
    assert abs(float(tpan.global_grad_norm(_grads_to_port(grads_j))) - gn_j) <= GNORM_RTOL * gn_j


@pytest.fixture(scope="module")
def lossless_runs(start):
    """STEPS lossless steps of both packages from the same state and data."""
    step_j = jax.jit(jstep.make_train_step(CFG_J, JPC(crs_every=2), jsched.constant(LR)))
    step_t = tstep.make_train_step(CFG_T, TPC(crs_every=2), tsched.constant(LR), remat="none")
    dj, dt = JData(CFG_J.vocab, SEQ, B), TData(CFG_T.vocab, SEQ, B, device="cpu")
    sj, st = start, _state_from_jax(start)
    st0 = _copy_state(st)
    mj, mt, first = [], [], None
    for i in range(STEPS):
        sj, m = step_j(sj, dj.batch(i))
        mj.append({k: float(v) for k, v in m.items()})
        st, m = step_t(st, dt.batch(i))
        mt.append({k: float(v) for k, v in m.items()})
        if i == 0:
            first = (_by_path(sj.sliced, is_leaf=lambda x: isinstance(x, jpan.SlicedTensor)),
                     {p: _plane_values(s.planes) for p, s in _t_by_path(st.sliced).items()})
    return {"jax": sj, "port": st, "port0": st0, "mj": mj, "mt": mt, "data": dt, "first": first}


def test_lossless_train_steps_match_jax(lossless_runs):
    r = lossless_runs
    for mj, mt in zip(r["mj"], r["mt"]):
        assert abs(mt["loss"] - mj["loss"]) <= LOSS_RTOL * abs(mj["loss"]), (mj, mt)
        assert abs(mt["grad_norm"] - mj["grad_norm"]) <= GNORM_RTOL * mj["grad_norm"], (mj, mt)
        assert mt["lr"] == mj["lr"]
    assert r["port"].step == int(r["jax"].step) == STEPS
    start_v = {p: _plane_values(s.planes) for p, s in _t_by_path(r["port0"].sliced).items()}
    want_1, got_1 = r["first"]
    for path, vt in got_1.items():  # after the first step
        vj = _plane_values(want_1[path].planes)
        assert np.abs(vj - vt).max() <= 1 + np.abs(vj - start_v[path]).max() * 2.0**-18, path
        if path != "embed":
            assert (np.abs(vj - vt) > 1).mean() <= LSB_SHARE, path
    want_s = _by_path(r["jax"].sliced, is_leaf=lambda x: isinstance(x, jpan.SlicedTensor))
    for path, s in _t_by_path(r["port"].sliced).items():  # after both steps
        vj, vt = _plane_values(want_s[path].planes), _plane_values(s.planes)
        assert int(want_s[path].frac_bits) == int(s.frac_bits)
        assert np.abs(vj - vt).max() <= WEIGHT_RTOL * np.abs(vj).max(), path
        if path != "embed":
            assert (np.abs(vj - vt) > 1).mean() <= LSB_SHARE, path
        assert (vt != start_v[path]).mean() > 0.5  # the steps did move the weights
    want_d = _by_path(r["jax"].digital)
    for path, d in _t_by_path(r["port"].digital).items():
        np.testing.assert_allclose(_np(d), np.asarray(want_d[path]), rtol=DIGITAL_RTOL, atol=1e-7)


def test_operand_and_dense_pipelines_agree(lossless_runs):
    r = lossless_runs
    dense_step = tstep.make_train_step(CFG_T, TPC(crs_every=2), tsched.constant(LR), operand_grads=False, remat="none")
    op_step = tstep.make_train_step(CFG_T, TPC(crs_every=2), tsched.constant(LR), remat="none")
    a, b = _copy_state(r["port0"]), _copy_state(r["port0"])
    batch = r["data"].batch(0)
    a, ma = op_step(a, batch)
    b, mb = dense_step(b, batch)
    assert float(ma["loss"]) == float(mb["loss"])
    assert abs(float(ma["grad_norm"]) - float(mb["grad_norm"])) <= GNORM_RTOL * float(mb["grad_norm"])
    for (path, sa), (_, sb) in zip(tree.leaves_with_path(a.sliced), tree.leaves_with_path(b.sliced)):
        if sa is not None:
            assert torch.equal(sa.planes, sb.planes), path
    for (path, da), (_, db) in zip(tree.leaves_with_path(a.digital), tree.leaves_with_path(b.digital)):
        if da is not None:
            assert torch.equal(da, db), path


def test_adc9_step_reads_match_jax_read_by_read(lossless_runs, monkeypatch):
    from repro_torch.core import mvm as tmvm

    reads = []
    real = tmvm.fidelity_read

    def recording(planes, frac_bits, x, fid, transpose=False):
        out = real(planes, frac_bits, x, fid, transpose=transpose)
        reads.append((_np(planes).copy(), int(frac_bits), _np(x).copy(), transpose, _np(out).copy()))
        return out

    monkeypatch.setattr(tmvm, "fidelity_read", recording)
    fid_t = tconfigs.fidelity_presets()["adc9"]
    fid_j = jconfigs.fidelity_presets()["adc9"]
    step = tstep.make_train_step(CFG_T, TPC(crs_every=2), tsched.constant(LR),
                                 plan_rules=tplan.default_rules(TPC(), fidelity=fid_t), remat="none")
    state = _copy_state(lossless_runs["port0"])
    for i in range(2):
        state, m = step(state, lossless_runs["data"].batch(i))
        assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert len(reads) == 2 * 2 * 5 * CFG_T.n_layers  # forward and MᵀVM per operand leaf, layer, step
    assert sum(r[3] for r in reads) == len(reads) // 2
    for planes, f, x, transpose, out in reads:
        want = np.asarray(jmvm.fidelity_read(jnp.asarray(planes), jnp.int32(f), jnp.asarray(x), fid_j,
                                             transpose=transpose))
        assert want.shape == out.shape
        tol = 1e-3 * (1.0 + float(np.abs(want).max()))
        assert float(np.abs(want - out).max()) <= tol, (transpose, x.shape)
    # the crossbar state moved: adc9 training writes the planes it reads
    before = _t_by_path(lossless_runs["port0"].sliced)
    for path, s in _t_by_path(state.sliced).items():
        assert not torch.equal(s.planes, before[path].planes), path
    # the fidelity wraps keep no dense copy
    wrapped = tpan.operandize({"w": None}, {"w": state.sliced["groups"][0]["mlp"]["wo"]},
                              {"w": tplan.LeafPlan(mapped=True, grad="operand", fidelity=fid_t)})
    assert wrapped["w"].w is None and wrapped["w"].planes[0].is_contiguous()


def test_make_train_step_refuses_what_is_not_ported():
    """Meshes are ported (``tests/test_torch_distributed_step.py``), and the
    MoE blocks at data > 1, on whole dispatch groups and on groups a rank
    does not hold whole (``tests/test_torch_distributed_archs.py``; here
    the latter steps on a dry mesh, the dry run's); a logical mesh cannot
    run a step."""
    from repro_torch.launch.mesh import dry_mesh, logical_mesh

    sched = tsched.constant(LR)
    moe = tconfigs.get_smoke("granite_moe_1b_a400m")
    dm = dry_mesh(logical_mesh((2, 1), ("data", "model")), device="cpu")
    step = tstep.make_train_step(moe, TPC(), sched, mesh=dm, remat="none")
    state = tstep.shard_state(tstep.train_state_init(moe, TPC(), 0, device="cpu", plan=step.plan), step.specs, dm)
    _, m = step(state, TData(moe.vocab, 8, 2, device="cpu").batch(0))  # a dry mesh's gathers hold no other rank's rows
    assert {"loss", "aux", "grad_norm"} <= set(m)
    with pytest.raises(ValueError, match="live mesh"):
        tstep.make_train_step(CFG_T, TPC(), sched, mesh=logical_mesh((2, 2), ("data", "model")), fsdp=True,
                              remat="none")
    fid_cfg = dataclasses.replace(CFG_T, fidelity=tconfigs.fidelity_presets()["adc9"])
    step = tstep.make_train_step(fid_cfg, TPC(), sched, operand_grads=False, remat="none")
    state = tstep.train_state_init(CFG_T, TPC(), 0, device="cpu")
    with pytest.raises(ValueError, match="operand pipeline"):
        step(state, TData(CFG_T.vocab, 8, 1, device="cpu").batch(0))
    with pytest.raises(NotImplementedError, match="momentum"):
        tpan.update_split({}, {}, {}, 0, LR, TPC(momentum=0.9))


def test_launcher_trains_on_the_cpu_and_refuses_what_is_not_ported():
    hist = tlaunch.main(["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "8",
                         "--crs-every", "2", "--log-every", "1"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist)
    hist = tlaunch.main(["--smoke", "--device", "cpu", "--steps", "1", "--batch", "1", "--seq", "8",
                         "--fidelity", "adc9"])
    assert np.isfinite(hist[0]["loss"])
    # checkpoints (--ckpt-dir: tests/test_torch_checkpoint.py) and --mesh debug
    # (tests/test_torch_distributed_step.py) are ported; other meshes are refused
    with pytest.raises(SystemExit):
        tlaunch.main(["--mesh", "production"])
    assert prng.PRNGKey(7) == (0, 7)


def test_training_forward_and_loss_match_jax(start):
    params_j = jpan.materialize_split(start.digital, start.sliced, JPC())
    params_t = tpan.materialize_split(_state_from_jax(start).digital, _state_from_jax(start).sliced, TPC())
    bj, bt = JData(CFG_J.vocab, SEQ, B).batch(0), TData(CFG_T.vocab, SEQ, B, device="cpu").batch(0)
    want = np.asarray(jlm.forward(CFG_J, params_j, bj["inputs"], remat=False)[0])
    got = _np(tlm.forward(CFG_T, params_t, bt["inputs"])[0])
    assert float(np.abs(want - got).max()) <= LOSS_RTOL * float(np.abs(want).max())
    lj = float(jlm.loss_fn(CFG_J, params_j, bj, remat=False))
    assert abs(float(tlm.loss_fn(CFG_T, params_t, bt)) - lj) <= LOSS_RTOL * lj
    # the label logit is read in bf16, as the reference's one-hot einsum reads it
    d = CFG_T.d_model
    logits = torch.tensor([0.0, 0.3, 0.7, 1.0 + 2.0**-8])
    table = logits[:, None].repeat(1, d) / d  # rms_norm(ones) @ table.T = logits
    head = {"final_ln": {"scale": torch.zeros(d)}}
    nll = tlm._nll_of_chunk(CFG_T, head, torch.ones(1, 1, d), torch.tensor([[1]]), table)
    shifted = tlm._head_out(CFG_T, head, torch.ones(1, 1, d), table)[0, 0]
    shifted = shifted - shifted.max()
    lse = torch.log(torch.exp(shifted).sum())
    assert float(nll) == float(lse - shifted[1].bfloat16().float()) != float(lse - shifted[1])
