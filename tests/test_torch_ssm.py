"""The port's SSM family (``repro_torch.models.mamba2`` / ``xlstm``, the
zamba unit of ``models.lm``, the depthwise conv on the crossbar and its
im2col deposit) against the JAX package, at the SMOKE sizes of xlstm-125m
and zamba2-1.2b, f32, JAX weights and states carried across by
``repro_torch.convert``; mirrors of ``tests/test_chunked_paths.py``'s SSM
cases, ``tests/test_operand_pipeline.py``'s im2col cases and
``tests/test_plan.py``'s xlstm case.

Tolerances:
* chunk-size invariance and prefill-then-decode (the port against itself):
  the reference tests' bounds, ``1e-4`` (``2e-4`` for the continued
  decode);
* the blocks (``mlstm_apply``, ``slstm_apply``, ``mamba2_apply`` with their
  states, and their decodes) against the reference's on the same weights:
  within ``BLOCK_RTOL`` of max|value| (the frameworks sum in other orders);
* ``_dwconv_fidelity_read``: ideal ADC within ``BLOCK_RTOL``; adc9 per read
  within ``1e-3 · (1 + max|out|)``, as every finite-ADC read is held (the
  read is discontinuous in its input, so it is held read by read, not end
  to end);
* the im2col operands, their ``materialize()`` and the im2col deposit: bit
  for bit (the deposit under half to even, the counter draw and the grid
  draw, flat, stacked and on zamba's nested ``[units, layers]`` stack);
* one lossless train step from the same state and batch, under
  ``coverage_rules`` and ``default_rules``: the loss and the gradient norm
  within ``1e-5`` relative, every mapped leaf within ``1 + 2^-15 ·
  max|update|`` grid LSB of the reference's (the recurrences' f32 weight
  gradients differ from the reference's by up to ~1.4e-5 of their max:
  the mLSTM's stabilized exponentials reassociate), digital leaves within
  ``DIGITAL_RTOL``.
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
from repro.core.slicing import DEFAULT_SPEC as JSPEC  # noqa: E402
from repro.core.slicing import slice_weights as jslice  # noqa: E402
from repro.data import SyntheticLMDataset as JData  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro.optim import PantherConfig as JPC  # noqa: E402
from repro.optim import panther as jpan  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.fixed_point import quantize  # noqa: E402
from repro_torch.core.slicing import DEFAULT_SPEC, slice_weights  # noqa: E402
from repro_torch.data import SyntheticLMDataset as TData  # noqa: E402
from repro_torch.kernels.sliced_opa import opa_deposit, opa_im2col_update  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402
from repro_torch.models import xlstm as txl  # noqa: E402
from repro_torch.optim import PantherConfig as TPC  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

BLOCK_RTOL = 1e-5
LOSS_RTOL, DIGITAL_RTOL = 1e-5, 1e-4
ARCHS = ("xlstm_125m", "zamba2_1p2b")
B, SEQ, LR = 4, 16, 5e-2


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _cfgs(arch):
    return (dataclasses.replace(jconfigs.get_smoke(arch), dtype=jnp.float32),
            dataclasses.replace(tconfigs.get_smoke(arch), dtype=torch.float32))


def _port(tree_j):
    return convert.params_from_jax(jax.tree.map(np.asarray, tree_j), device="cpu")


def _close(got, want, rtol=BLOCK_RTOL):
    want = np.asarray(want, np.float32)
    assert np.abs(_np(got) - want).max() <= rtol * np.abs(want).max()


def _mk_cfg(**kw):
    base = dict(arch_id="test", d_model=64, n_layers=1, vocab=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                dtype=torch.float32)
    return tcommon.LMConfig(**{**base, **kw})


def _hidden(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


# --------------- mirrors of tests/test_chunked_paths.py (the port alone) ---------------


def test_mlstm_chunk_size_invariance(monkeypatch):
    cfg = _mk_cfg(xlstm=tcommon.XLSTMCfg(proj_factor=2.0, n_heads=2, conv_width=4))
    params = txl.mlstm_init(cfg, torch.Generator().manual_seed(0))
    h = _hidden((2, 512, 64), 1)
    with torch.no_grad():
        monkeypatch.setattr(txl, "MLSTM_CHUNK", 512)
        out_big, state_big = txl.mlstm_apply(cfg, params, h, with_state=True)
        monkeypatch.setattr(txl, "MLSTM_CHUNK", 64)
        out_small, state_small = txl.mlstm_apply(cfg, params, h, with_state=True)
        np.testing.assert_allclose(_np(out_small), _np(out_big), rtol=1e-4, atol=1e-4)
        # the carried state continues as the one-chunk state does
        h_next = _hidden((2, 1, 64), 2)
        o1, _ = txl.mlstm_decode(cfg, params, h_next, state_small, 512)
        o2, _ = txl.mlstm_decode(cfg, params, h_next, state_big, 512)
    np.testing.assert_allclose(_np(o1), _np(o2), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunks", [(8, 64), (16, 128)])
def test_mamba2_chunk_size_invariance(chunks):
    c1, c2 = chunks
    cfg1 = _mk_cfg(ssm=tcommon.SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=c1))
    cfg2 = dataclasses.replace(cfg1, ssm=dataclasses.replace(cfg1.ssm, chunk=c2))
    params = tm2.mamba2_init(cfg1, torch.Generator().manual_seed(0))
    h = _hidden((2, 128, 64), 1)
    with torch.no_grad():
        o1, s1 = tm2.mamba2_apply(cfg1, params, h, with_state=True)
        o2, s2 = tm2.mamba2_apply(cfg2, params, h, with_state=True)
    np.testing.assert_allclose(_np(o1), _np(o2), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(s1["ssd"]), _np(s2["ssd"]), rtol=1e-4, atol=1e-4)


def test_mamba2_prefill_state_continues_decode():
    cfg = _mk_cfg(ssm=tcommon.SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16))
    params = tm2.mamba2_init(cfg, torch.Generator().manual_seed(0))
    h = _hidden((2, 65, 64), 1)
    with torch.no_grad():
        full = tm2.mamba2_apply(cfg, params, h)
        _, state = tm2.mamba2_apply(cfg, params, h[:, :64], with_state=True)
        out, _ = tm2.mamba2_decode(cfg, params, h[:, 64:65], state, 64)
    np.testing.assert_allclose(_np(out[:, 0]), _np(full[:, 64]), rtol=2e-4, atol=2e-4)


# ------------------------- the blocks against the reference -------------------------

BLOCKS = {
    "mlstm": ("xlstm_125m", jxl.mlstm_init, jxl.mlstm_apply, jxl.mlstm_decode, txl.mlstm_apply, txl.mlstm_decode),
    "slstm": ("xlstm_125m", jxl.slstm_init, jxl.slstm_apply, jxl.slstm_decode, txl.slstm_apply, txl.slstm_decode),
    "mamba2": ("zamba2_1p2b", jm2.mamba2_init, jm2.mamba2_apply, jm2.mamba2_decode, tm2.mamba2_apply,
               tm2.mamba2_decode),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_matches_the_reference(block):
    """The block over 40 tokens (zamba's SMOKE chunk is 32: two chunks, the
    second padded) with its final state, then two decode steps from that
    state, against the reference's on the same weights."""
    arch, jinit, japply, jdecode, tapply, tdecode = BLOCKS[block]
    cfg_j, cfg_t = _cfgs(arch)
    pj = jinit(cfg_j, jax.random.PRNGKey(0))
    pt = _port(pj)
    japply = jax.jit(lambda p, x: BLOCKS[block][2](cfg_j, p, x, with_state=True))  # jitted: seconds, not tens
    jdecode = jax.jit(lambda p, x, st, pos: BLOCKS[block][3](cfg_j, p, x, st, pos))
    h = np.random.default_rng(1).normal(size=(2, 40, cfg_t.d_model)).astype(np.float32)
    oj, sj = japply(pj, jnp.asarray(h))
    with torch.no_grad():
        ot, st = tapply(cfg_t, pt, torch.from_numpy(h), with_state=True)
    _close(ot, oj)
    for k in sorted(sj):
        _close(st[k], sj[k])
    for i in range(2):
        hn = np.random.default_rng(2 + i).normal(size=(2, 1, cfg_t.d_model)).astype(np.float32)
        oj, sj = jdecode(pj, jnp.asarray(hn), sj, jnp.int32(40 + i))
        with torch.no_grad():
            ot, st = tdecode(cfg_t, pt, torch.from_numpy(hn), st, 40 + i)
        _close(ot, oj)
        for k in sorted(sj):
            _close(st[k], sj[k])


# ---------------------- the depthwise conv on the crossbar ----------------------


@pytest.mark.parametrize("transpose", [False, True], ids=["forward", "transpose"])
@pytest.mark.parametrize("adc", [None, 9], ids=["ideal", "adc9"])
def test_dwconv_fidelity_read_matches_the_reference(adc, transpose):
    """``_dwconv_fidelity_read`` on random ``[S, 4, 16]`` planes, the padded
    input (forward) or the output gradient (transposed), against the
    reference's, read by read."""
    rng = np.random.default_rng(3)
    K, C, Bn, L = 4, 16, 2, 12
    q = rng.integers(-(2**26), 2**26, size=(K, C)).astype(np.int32)
    planes_j = jslice(jnp.asarray(q), JSPEC)
    planes_t = torch.from_numpy(np.array(planes_j))
    frac = 24
    fj = jcommon.FidelityConfig(adc_bits_fwd=adc, adc_bits_bwd=adc)
    ft = tcommon.FidelityConfig(adc_bits_fwd=adc, adc_bits_bwd=adc)
    jread = jax.jit(lambda p, f, v: jcommon._dwconv_fidelity_read(p, f, v, fj, transpose=transpose))
    for i in range(3):
        v = rng.normal(size=(Bn, L if transpose else L + K - 1, C)).astype(np.float32) * 10.0 ** (i - 1)
        want = np.asarray(jread(planes_j, jnp.int32(frac), jnp.asarray(v)))
        got = tcommon._dwconv_fidelity_read(planes_t, torch.tensor(frac, dtype=torch.int32), torch.from_numpy(v),
                                            ft, transpose=transpose)
        assert got.shape == want.shape
        if adc is None:
            _close(got, want)
        else:
            # Every column sum ahead of an ADC is a small exact integer, so both
            # packages take the same ADC codes. Only the f32 shift-and-add over
            # the (bit cycle, slice) terms is summed in another order: XLA's
            # einsum against torch's, and the port's transposed read adds the
            # bit cycles one at a time. Measured: at most 4.2e-7 of
            # 1 + max|want| over seeds 3-5, both directions.
            assert np.abs(_np(got) - want).max() <= 1e-6 * (1 + np.abs(want).max())


def test_dwconv_im2col_cotangent_matches_dense_grad():
    """The conv's weight gradient in im2col operand form: ``materialize()``
    bit for bit equal to the patch einsum, close to plain autograd of the
    windowed sum; ``dx`` through the wrap close to plain autograd."""
    rng = np.random.default_rng(0)
    Bn, L, K, C = 3, 40, 4, 32
    xp = torch.from_numpy(rng.normal(size=(Bn, L + K - 1, C)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(K, C)).astype(np.float32))
    co = torch.from_numpy(rng.normal(size=(Bn, L, C)).astype(np.float32))
    xd, wd = xp.clone().requires_grad_(True), w.clone().requires_grad_(True)
    torch.sum(tcommon._dwconv_val(xd, wd) * co).backward()
    slot = tcommon.OperandSlot((), tokens=Bn * L, kind="im2col")
    xo = xp.clone().requires_grad_(True)
    torch.sum(tcommon.xbar_dwconv(xo, tcommon.XbarWeight(w, None, None, None, slot)) * co).backward()
    g = slot.grad()
    assert g.kind == "im2col" and g.shape == (K, C)
    pat = torch.stack([xp[:, k:k + L] for k in range(K)], dim=-1)
    assert torch.equal(g.materialize(), torch.einsum("blck,blc->kc", pat, co))
    np.testing.assert_allclose(_np(g.materialize()), _np(wd.grad), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(xo.grad), _np(xd.grad), rtol=1e-5, atol=1e-6)
    # the reference's operands, element for element
    ww = jcommon.XbarWeight(jnp.asarray(w.numpy()), jcommon.OuterProductGrad(
        jnp.zeros((C, Bn * L, K)), jnp.zeros((C, Bn * L, 1)), kind="im2col"))
    gj = jax.grad(lambda ww: jnp.sum(jcommon.xbar_dwconv(jnp.asarray(xp.numpy()), ww) * jnp.asarray(co.numpy())))(ww)
    assert np.array_equal(_np(g.x), np.asarray(gj.g.x)) and np.array_equal(_np(g.dh), np.asarray(gj.g.dh))


def _im2col_case(rng, lead, K=4, C=48, t=96):
    x = rng.normal(size=(*lead, C, t, K)).astype(np.float32)
    dh = (rng.normal(size=(*lead, C, t, 1)) * 1e-2).astype(np.float32)
    q = rng.integers(-(2**27), 2**27, size=(*lead, K, C)).astype(np.int32)
    return x, dh, q


def _planes_t(planes_j):
    """Reference planes ``[S, *lead, K, C]`` in the port's layer-major
    storage."""
    p = np.asarray(planes_j)
    lead = p.ndim - 3
    return torch.from_numpy(np.array(np.moveaxis(p, 0, lead))).movedim(lead, 0)


@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_im2col_operand_update_matches_dense_deposit(stacked):
    """The im2col deposit (each channel's ``[K, 1]`` tile of the stored
    ``[.., K, C]`` planes) bit for bit equal to ``quantize(-lr · dense)`` and
    the deposit on the stored layout, and to the reference's."""
    rng = np.random.default_rng(1)
    lead = (3,) if stacked else ()
    x, dh, q = _im2col_case(rng, lead)
    g = tcommon.OuterProductGrad(torch.from_numpy(x), torch.from_numpy(dh), "im2col")
    dense = torch.einsum("...ctk,...cto->...kc", g.x, g.dh)
    assert torch.equal(g.materialize(), dense) and g.shape == tuple(dense.shape)
    planes = slice_weights(torch.from_numpy(q), DEFAULT_SPEC)
    lr, fbits = 0.05, 20
    want = opa_deposit(planes.clone(), quantize(-np.float32(lr) * dense, fbits), DEFAULT_SPEC)
    got = opa_im2col_update(planes.clone(), g.x, g.dh, lr, fbits, DEFAULT_SPEC)
    assert torch.equal(got, want)
    gj = jcommon.OuterProductGrad(jnp.asarray(x), jnp.asarray(dh), kind="im2col")
    ref = jpan._opa_operand_update(jslice(jnp.asarray(q), JSPEC), gj, jnp.float32(lr), jnp.int32(fbits), JSPEC,
                                   stochastic=False)
    assert np.array_equal(_np(got), np.asarray(ref))


@pytest.mark.parametrize("rng_mode", ["counter", "grid"])
@pytest.mark.parametrize("lead", [(), (3,), (2, 3)], ids=["flat", "stacked", "nested"])
def test_im2col_stochastic_deposit_matches_the_reference(lead, rng_mode):
    """Under a key, tile c of layer block l rounds under the reference's
    flattened stack index ``l·C + c`` (``(unit, layer)`` row-major on
    zamba's nested stack): bit for bit with the reference's deposit."""
    rng = np.random.default_rng(2)
    x, dh, q = _im2col_case(rng, lead, C=8, t=24)
    planes_j = jslice(jnp.asarray(q), JSPEC)
    gj = jcommon.OuterProductGrad(jnp.asarray(x), jnp.asarray(dh), kind="im2col")
    ref = jpan._opa_operand_update(planes_j, gj, jnp.float32(0.3), jnp.int32(22), JSPEC, stochastic=True,
                                   key=jax.random.PRNGKey(5), rng_mode=rng_mode)
    got = opa_im2col_update(_planes_t(planes_j), torch.from_numpy(x), torch.from_numpy(dh), 0.3, 22, DEFAULT_SPEC,
                            stochastic=True, key=prng.PRNGKey(5), rng_mode=rng_mode)
    assert np.array_equal(_np(got), np.asarray(ref))


def test_nested_stack_wrap_writes_the_flat_layer_entry():
    """A train-side wrap over zamba's ``[units, layers, K, C]`` conv taps,
    indexed unit then layer, writes its operands at the row-major flat
    index, the order of the reference's per-layer keys; an unindexed layer
    dim refuses to read."""
    units, layers, K, C, L = 2, 3, 4, 8, 5
    w = torch.randn(units, layers, K, C)
    slot = tcommon.OperandSlot((units, layers), tokens=L, kind="im2col")
    ww = tcommon.XbarWeight(w, None, None, None, slot)
    xs = {}
    for u in range(units):
        for j in range(layers):
            xp = torch.randn(1, L + K - 1, C, requires_grad=True)
            tcommon.xbar_dwconv(xp, ww[u][j]).sum().backward()
            xs[(u, j)] = xp.detach()
    g = slot.grad()
    assert g.x.shape == (units, layers, C, L, K) and g.shape == (units, layers, K, C)
    for (u, j), xp in xs.items():
        assert torch.equal(slot.x[u * layers + j], tcommon._dwconv_operands(xp, torch.ones(1, L, C))[0])
        assert torch.equal(g.x[u, j, :, :, 0], xp[0, :L].T)
    with pytest.raises(RuntimeError, match="index every layer dim"):
        tcommon.xbar_dwconv(torch.randn(1, L + K - 1, C, requires_grad=True), ww[0]).sum().backward()


def test_microbatch_merge_keeps_the_im2col_kind():
    """``microbatches=G``: each microbatch's im2col operands concatenate
    along the token axis (-2, as for every kind), ``dh`` scaled by 1/G, as
    the reference's step merges them: the merged gradient is the mean of the
    microbatches' dense conv gradients."""
    rng = np.random.default_rng(4)
    parts = [tcommon.OuterProductGrad(*map(torch.from_numpy, _im2col_case(rng, (2,), C=8, t=6)[:2]), "im2col")
             for _ in range(3)]
    merged = tstep._merge_operands(parts, 3)
    assert merged.kind == "im2col" and merged.x.shape == (2, 8, 18, 4) and merged.dh.shape == (2, 8, 18, 1)
    want = sum(p.materialize() for p in parts) / 3
    np.testing.assert_allclose(_np(merged.materialize()), _np(want), rtol=1e-6, atol=1e-7)


# ----------------------------------- plans -----------------------------------


def test_xlstm_wq_style_leaves_resolve_dense():
    """mLSTM projections named like the attention's operand keys stay dense
    under the default rules (their blocks have no attn/mlp segment)."""
    for cfg in (tconfigs.get("xlstm_125m"), tconfigs.get_smoke("xlstm_125m")):
        plan = tplan.plan_by_path(tplan.resolve_plan(tlm.param_shapes(cfg), tplan.default_rules(TPC())))
        hits = 0
        for ps, pl in plan.items():
            if ps.split("/")[-1] in ("wq", "wk", "wv"):
                hits += 1
                assert pl.mapped and pl.grad == "dense", ps
        assert hits >= 3


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_step_runs_on_non_attention_archs(arch):
    """The default pipeline (no operand leaf: the blocks' weights take the
    dense write, ``conv_w`` stays digital) trains both archs."""
    cfg = tconfigs.get_smoke(arch)
    opt = TPC(stochastic_round=False, crs_every=1000)
    state = tstep.train_state_init(cfg, opt, 0, device="cpu")
    plan = tplan.resolve_plan(tstep.param_shapes(state.digital, state.sliced), tplan.default_rules(opt))
    assert not any(pl.grad == "operand" for _, pl in tree.leaves_with_path(plan))
    assert not any(pl.mapped for p, pl in tree.leaves_with_path(plan) if p[-1] == "conv_w")
    step = tstep.make_train_step(cfg, opt, tsched.constant(0.1), remat="none")
    state, m = step(state, TData(cfg.vocab, 16, 4, device="cpu").batch(9))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_adc9_coverage_step_reads_the_taps_through_the_crossbar(arch, monkeypatch):
    """Under ``coverage_rules`` at adc9 the conv taps are read through the
    finite-ADC im2col read both ways (one forward and one transposed read
    a layer block) and deposited from their im2col operands."""
    cfg = tconfigs.get_smoke(arch)
    opt = TPC(crs_every=2)
    adc9 = tconfigs.fidelity_presets()["adc9"]
    reads = []
    real = tcommon._dwconv_fidelity_read
    monkeypatch.setattr(tcommon, "_dwconv_fidelity_read",
                        lambda *a, transpose=False: reads.append(transpose) or real(*a, transpose=transpose))
    state = tstep.train_state_init(cfg, opt, 0, device="cpu")
    step = tstep.make_train_step(cfg, opt, tsched.constant(LR), plan_rules=tplan.coverage_rules(opt, adc9),
                                 remat="none")
    before = {p: s.planes.clone() for p, s in tree.leaves_with_path(state.sliced) if s is not None}
    state, m = step(state, TData(cfg.vocab, SEQ, B, device="cpu").batch(0))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    blocks = sum(s.planes[0].numel() // np.prod(s.planes.shape[-2:]) for p, s in tree.leaves_with_path(state.sliced)
                 if s is not None and p[-1] == "conv_w")
    assert sorted(reads) == [False] * blocks + [True] * blocks
    for p, s in tree.leaves_with_path(state.sliced):
        if s is not None and p[-1] == "conv_w":
            assert not torch.equal(s.planes, before[p])


# --------------------------- one train step, both packages ---------------------------

RULES = {"coverage": (jplan.coverage_rules, tplan.coverage_rules),
         "default": (jplan.default_rules, tplan.default_rules)}


def _plane_values(planes):
    p = _np(planes).astype(np.int64)
    acc = p[-1]
    for s in range(p.shape[0] - 2, -1, -1):
        acc = acc * 16 + p[s]
    return acc


@pytest.mark.parametrize("rules", ["coverage", "default"])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_step_matches_the_reference(arch, rules):
    """One lossless step from the same state and batch. Under
    ``coverage_rules`` the projections are operand leaves and ``conv_w``
    an im2col leaf (zamba's nested ``[units, layers]`` stacks included);
    under ``default_rules`` every mapped leaf is dense."""
    cfg_j, cfg_t = _cfgs(arch)
    rj, rt = RULES[rules]
    start = jstep.train_state_init(cfg_j, JPC(crs_every=2), jax.random.PRNGKey(0))
    step_j = jax.jit(jstep.make_train_step(cfg_j, JPC(crs_every=2), jsched.constant(LR), plan_rules=rj(JPC())))
    step_t = tstep.make_train_step(cfg_t, TPC(crs_every=2), tsched.constant(LR), plan_rules=rt(TPC()), remat="none")
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    st = convert.train_state_from_jax(0, np_tree(start.digital), np_tree(start.sliced), start.rng, device="cpu")
    start_v = {tcommon.path_str(p): _plane_values(s.planes) for p, s in tree.leaves_with_path(st.sliced)
               if s is not None}
    groups = {pl.group for _, pl in tree.leaves_with_path(tplan.resolve_plan(
        tstep.param_shapes(st.digital, st.sliced), rt(TPC())))}
    assert ("im2col" in groups) == (rules == "coverage")
    sj, mj = step_j(start, JData(cfg_j.vocab, SEQ, B).batch(0))
    st, mt = step_t(st, TData(cfg_t.vocab, SEQ, B, device="cpu").batch(0))
    for k in ("loss", "grad_norm"):
        assert abs(float(mt[k]) - float(mj[k])) <= LOSS_RTOL * abs(float(mj[k])), k
    want = {jcommon.path_str(p): s for p, s in jax.tree_util.tree_flatten_with_path(
        sj.sliced, is_leaf=lambda x: isinstance(x, jpan.SlicedTensor))[0]}
    for path, s in tree.leaves_with_path(st.sliced):
        if s is None:
            continue
        path = tcommon.path_str(path)
        vj, vt = _plane_values(want[path].planes), _plane_values(s.planes)
        assert np.abs(vj - vt).max() <= 1 + np.abs(vj - start_v[path]).max() * 2.0**-15, path
    want_d = {jcommon.path_str(p): v for p, v in jax.tree_util.tree_flatten_with_path(sj.digital)[0]}
    for path, d in tree.leaves_with_path(st.digital):
        if d is not None:
            np.testing.assert_allclose(_np(d), np.asarray(want_d[tcommon.path_str(path)]), rtol=DIGITAL_RTOL,
                                       atol=1e-7)
