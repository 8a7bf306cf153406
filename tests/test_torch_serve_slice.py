"""The serving slice against the JAX package: a gemma-family config at
kernel-shaped widths (d_model 128, 4 heads x 32, MQA, GeGLU d_ff 256, vocab
256, 2 layers, f32), JAX weights carried across by ``repro_torch.convert``.

Tolerances:
* sliced state (planes, frac_bits) and its dequantized copy: bit-identical;
* lossless serving end to end: logits ``max|diff| <= 1e-5 * max|logit|``
  (f32 reassociation, and libm ulps in rsqrt/sin/cos/exp/tanh), greedy tokens
  equal;
* adc9 serving: every attention and MLP sub-block, prefill and 8 decode
  steps, fed the reference's input, within ``1e-3 * (1 + max|out|)``; logits
  within ``1e-3 * (1 + max|logit|)``; greedy tokens equal.

Why adc9 is held sub-block by sub-block: the adc9 read is discontinuous in
its input. A one-ulp change of an activation can move a DAC code across a
rounding boundary, and then a top-slice ADC code, worth O(1) in the output —
the reference itself moves its adc9 logits by far more than 1e-3 under a
one-ulp perturbation of the embedding (``test_adc9_reference_is_discontinuous``).
Two frameworks whose libm differs by ulps therefore cannot agree end to end
at adc9; each sub-block given the same input does.
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
from repro.models import attention as jatt  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import PantherConfig as JPC  # noqa: E402
from repro.optim import panther as jpan  # noqa: E402
from repro.serve import kv_pages as jkv  # noqa: E402
from repro.serve.step import fidelity_params as jfidelity_params  # noqa: E402
from repro.serve.step import make_decode_step as jmake_decode_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.optim import PantherConfig as TPC  # noqa: E402
from repro_torch.optim import panther as tpan  # noqa: E402
from repro_torch.serve import kv_pages as tkv  # noqa: E402
from repro_torch.serve.step import fidelity_params, make_decode_step, make_prefill  # noqa: E402

SEED = 0  # every step's top-2 logit margin exceeds the tolerances (asserted)
B, P, NT = 2, 12, 8
WIDE = dict(d_model=128, n_heads=4, head_dim=32, n_kv_heads=1, d_ff=256, vocab=256,
            n_layers=2, pattern=(("dense", 2),))
LOSSLESS_RTOL = 1e-5
ADC_TOL = 1e-3

CFG_J = dataclasses.replace(jconfigs.get_smoke("gemma_2b"), dtype=jnp.float32, **WIDE)
CFG_T = dataclasses.replace(tconfigs.get_smoke("gemma_2b"), dtype=torch.float32, **WIDE)


@pytest.fixture(scope="module")
def slice_state():
    pj = jlm.init_params(CFG_J, jax.random.PRNGKey(SEED))
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    dj, sj = jpan.init_split(pj, JPC())
    dt, st = tpan.init_split(pt, TPC())
    prompts = np.random.default_rng(SEED).integers(0, CFG_J.vocab, size=(B, P)).astype(np.int32)
    return {
        "dense_j": jpan.materialize_split(dj, sj, JPC()), "sliced_j": sj,
        "dense_t": tpan.materialize_split(dt, st, TPC()), "sliced_t": st,
        "prompts": prompts,
    }


def _fid_trees(state, preset="adc9"):
    fj = jconfigs.fidelity_presets()[preset]
    ft = tconfigs.fidelity_presets()[preset]
    plan_j = jplan.resolve_plan(state["dense_j"], jplan.default_rules(JPC(), fidelity=fj))
    plan_t = tplan.resolve_plan(state["dense_t"], tplan.default_rules(TPC(), fidelity=ft))
    return (jfidelity_params(state["dense_j"], state["sliced_j"], plan=plan_j),
            fidelity_params(state["dense_t"], state["sliced_t"], plan=plan_t))


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_margin(logits, tol):
    top2 = np.sort(_np(logits), axis=-1)[:, -2:]
    assert float((top2[:, 1] - top2[:, 0]).min()) > 2 * tol


def test_sliced_state_matches_jax(slice_state):
    flat_j = jax.tree_util.tree_flatten_with_path(
        slice_state["sliced_j"], is_leaf=lambda x: isinstance(x, jpan.SlicedTensor))[0]
    flat_t = {tcommon.path_str(p): s for p, s in tree.leaves_with_path(slice_state["sliced_t"])}
    mapped = 0
    for path, sj in flat_j:
        st = flat_t[jcommon.path_str(path)]
        assert np.array_equal(np.asarray(sj.planes), _np(st.planes))
        assert int(sj.frac_bits) == int(st.frac_bits)
        mapped += 1
    assert mapped == sum(s is not None for s in flat_t.values()) == 6  # embed + 5 per group
    for (pa, a), (pb, b) in zip(
        sorted(jax.tree_util.tree_flatten_with_path(slice_state["dense_j"])[0],
               key=lambda kv: jcommon.path_str(kv[0])),
        sorted(tree.leaves_with_path(slice_state["dense_t"]), key=lambda kv: tcommon.path_str(kv[0])),
    ):
        assert jcommon.path_str(pa) == tcommon.path_str(pb)
        assert np.array_equal(np.asarray(a), _np(b))


def _serve_jax(params, prompts):
    logits, caches = jax.jit(lambda p, x: jlm.prefill(CFG_J, p, x))(params, jnp.asarray(prompts))
    caches = jkv.grow_caches(CFG_J, jlm.unstack_caches(CFG_J, caches), P + NT)
    decode = jax.jit(jmake_decode_step(CFG_J))
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks, all_logits = [np.asarray(tok)], [np.asarray(logits)]
    for i in range(NT - 1):
        tok, logits, caches = decode(params, tok, caches, jnp.int32(P + i))
        toks.append(np.asarray(tok))
        all_logits.append(np.asarray(logits))
    return np.stack(toks, 1), all_logits


def _serve_port(params, prompts):
    logits, caches = make_prefill(CFG_T)(params, torch.from_numpy(prompts).long())
    caches = tkv.grow_caches(CFG_T, tlm.unstack_caches(CFG_T, caches), P + NT)
    decode = make_decode_step(CFG_T)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    toks, all_logits = [_np(tok)], [_np(logits)]
    for i in range(NT - 1):
        tok, logits, caches = decode(params, tok.long(), caches, P + i)
        toks.append(_np(tok))
        all_logits.append(_np(logits))
    return np.stack(toks, 1), all_logits


def test_lossless_serve_matches_jax(slice_state):
    tok_j, log_j = _serve_jax(slice_state["dense_j"], slice_state["prompts"])
    tok_t, log_t = _serve_port(slice_state["dense_t"], slice_state["prompts"])
    for a, b in zip(log_j, log_t):
        tol = LOSSLESS_RTOL * float(np.abs(a).max())
        assert float(np.abs(a - b).max()) <= tol
        _assert_margin(a, tol)
    assert np.array_equal(tok_j, tok_t)


def _close(want, got, tol_fn):
    want, got = _np(want), _np(got)
    assert want.shape == got.shape
    tol = tol_fn(float(np.abs(want).max()))
    assert float(np.abs(want - got).max()) <= tol, (float(np.abs(want - got).max()), tol)
    return tol


def _forced_run(pj, pt, prompts, tol_fn):
    """Prefill + NT-1 decode steps, each attention and MLP sub-block of the
    port fed the reference's input; returns both token streams."""
    layers = CFG_J.n_layers
    hj = jlm._embed_in(CFG_J, pj, jnp.asarray(prompts))
    _close(hj, tlm._embed_in(CFG_T, pt, torch.from_numpy(prompts).long()), lambda m: 0.0)
    pos_j, pos_t = jnp.arange(P), torch.arange(P)
    lj = [jax.tree.map(lambda x: x[i], pj["groups"][0]) for i in range(layers)]
    lt = [tlm.layer(pt["groups"][0], i) for i in range(layers)]
    cj, ct = [], []
    for i in range(layers):
        aj, cache_j = jatt.attn_apply(CFG_J, lj[i]["attn"], hj, pos_j, with_cache=True)
        at, cache_t = tatt.attn_apply(CFG_T, lt[i]["attn"], _t(hj), pos_t,
                                      with_cache=True)
        _close(aj, at, tol_fn)
        hj = jmlp.mlp_apply(CFG_J, lj[i]["mlp"], aj)
        _close(hj, tmlp.mlp_apply(CFG_T, lt[i]["mlp"], _t(aj)), tol_fn)
        pad = ((0, 0), (0, NT), (0, 0), (0, 0))
        cj.append(jax.tree.map(lambda c: jnp.pad(c, pad), cache_j))
        ct.append(tree.map(lambda c: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, NT)), cache_t))
    toks_j, toks_t = [], []
    for step in range(NT):
        logits_j = jlm._head_out(CFG_J, pj, hj[:, -1:])[:, 0]
        logits_t = tlm._head_out(CFG_T, pt, _t(hj[:, -1:]))[:, 0]
        tol = _close(logits_j, logits_t, tol_fn)
        _assert_margin(logits_j, tol)
        tok = jnp.argmax(logits_j, axis=-1).astype(jnp.int32)
        toks_j.append(np.asarray(tok))
        toks_t.append(_np(torch.argmax(logits_t, dim=-1)))
        if step == NT - 1:
            break
        pos = P + step
        hj = jlm._embed_in(CFG_J, pj, tok[:, None])
        for i in range(layers):
            aj, cj[i] = jatt.attn_decode(CFG_J, lj[i]["attn"], hj, cj[i], jnp.int32(pos))
            at, ct[i] = tatt.attn_decode(CFG_T, lt[i]["attn"], _t(hj), ct[i], pos)
            _close(aj, at, tol_fn)
            hj = jmlp.mlp_apply(CFG_J, lj[i]["mlp"], aj)
            _close(hj, tmlp.mlp_apply(CFG_T, lt[i]["mlp"], _t(aj)), tol_fn)
    return np.stack(toks_j, 1), np.stack(toks_t, 1)


def test_lossless_sub_blocks_match_jax(slice_state):
    tj, tt = _forced_run(slice_state["dense_j"], slice_state["dense_t"], slice_state["prompts"],
                         lambda m: LOSSLESS_RTOL * m)
    assert np.array_equal(tj, tt)


def test_adc9_serve_matches_jax_sub_block_by_sub_block(slice_state):
    fj, ft = _fid_trees(slice_state)
    assert isinstance(ft["groups"][0]["mlp"]["wi_gate"], tcommon.XbarWeight)
    assert ft["groups"][0]["mlp"]["wi_gate"].w is None  # serving drops the dense copy
    tj, tt = _forced_run(fj, ft, slice_state["prompts"], lambda m: ADC_TOL * (1.0 + m))
    assert np.array_equal(tj, tt)


def test_adc9_serve_end_to_end_runs(slice_state):
    _, ft = _fid_trees(slice_state)
    tok, logits = _serve_port(ft, slice_state["prompts"])
    _, lossless = _serve_port(slice_state["dense_t"], slice_state["prompts"])
    assert tok.shape == (B, NT)
    assert all(np.isfinite(lg).all() and lg.shape == (B, CFG_T.vocab) for lg in logits)
    gap = float(np.abs(logits[0] - lossless[0]).max())
    assert np.isfinite(gap) and gap > 0.0


def test_adc9_reference_is_discontinuous(slice_state):
    # the reason adc9 is compared sub-block by sub-block (module docstring)
    fj, _ = _fid_trees(slice_state)
    prefill = jax.jit(lambda p, x: jlm.prefill(CFG_J, p, x)[0])
    x = jnp.asarray(slice_state["prompts"])

    def bumped(params):
        return dict(params, embed=params["embed"] * (1.0 + 2.0**-23))

    a, b = prefill(fj, x), prefill(bumped(fj), x)
    assert float(jnp.abs(a - b).max()) > 10 * ADC_TOL * (1.0 + float(jnp.abs(a).max()))
    dense = slice_state["dense_j"]
    a, b = prefill(dense, x), prefill(bumped(dense), x)
    assert float(jnp.abs(a - b).max()) <= LOSSLESS_RTOL * float(jnp.abs(a).max())


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32) * 3
    scale = rng.normal(size=(32,)).astype(np.float32) * 0.1
    want = np.asarray(jcommon.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    got = tcommon.rms_norm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    _close(want, got, lambda m: LOSSLESS_RTOL * m)
    pos = np.arange(5) + 3
    want = np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    _close(want, got, lambda m: LOSSLESS_RTOL * m)
    g = rng.normal(size=(64,)).astype(np.float32) * 3
    _close(np.asarray(jax.nn.gelu(jnp.asarray(g))), tcommon.gelu(torch.from_numpy(g)),
           lambda m: LOSSLESS_RTOL * m)
    # the embedding scale rounds to the activation dtype first: 45.25 in bf16
    h = tlm._embed_in(tconfigs.get("gemma_2b"), {"embed": torch.ones(4, 2048)}, torch.tensor([[1]]))
    assert h.dtype == torch.bfloat16 and float(h[0, 0, 0]) == 45.25


def test_sliced_from_jax_feeds_the_same_planes(slice_state):
    # the JAX sliced tree carried across serves exactly like the port's own
    st = convert.sliced_from_jax(jax.tree.map(np.asarray, slice_state["sliced_j"]), device="cpu")
    mine = slice_state["sliced_t"]["groups"][0]["mlp"]["wo"]
    theirs = st["groups"][0]["mlp"]["wo"]
    assert tuple(theirs.planes.shape) == tuple(mine.planes.shape) == (8, 2, 256, 128)
    assert torch.equal(theirs.planes, mine.planes) and int(theirs.frac_bits) == int(mine.frac_bits)
    planes, _ = tpan._fid_leaves(theirs, (2,))
    assert planes[1].is_contiguous()
    assert st["groups"][0]["attn"]["ln"]["scale"] is None


def test_attention_options_and_int8_cache_match_jax():
    # qk-norm, sandwich norm and logit softcap (gemma2/chameleon options) and
    # the int8 KV cache, each against the reference on the same inputs
    cfg_j = dataclasses.replace(CFG_J, qk_norm=True, post_norm=True, softcap_attn=50.0)
    cfg_t = dataclasses.replace(CFG_T, qk_norm=True, post_norm=True, softcap_attn=50.0)
    rng = np.random.default_rng(8)
    pj = jatt.attn_init(cfg_j, jax.random.PRNGKey(1))
    pj = jax.tree.map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32), pj)
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    h = rng.normal(size=(2, 6, 128)).astype(np.float32)
    want, cache_j = jatt.attn_apply(cfg_j, pj, jnp.asarray(h), jnp.arange(6), with_cache=True)
    got, cache_t = tatt.attn_apply(cfg_t, pt, _t(h), torch.arange(6), with_cache=True)
    _close(want, got, lambda m: LOSSLESS_RTOL * m)
    kv = _np(cache_t["k"]["q"])
    sj, st = jatt._cache_store(jnp.asarray(kv), jnp.int8), tatt._cache_store(_t(kv), torch.int8)
    assert np.array_equal(np.asarray(sj["q"]), _np(st["q"])) and np.array_equal(np.asarray(sj["s"]), _np(st["s"]))
    _close(jatt._cache_load(sj, jnp.float32), tatt._cache_load(st, torch.float32), lambda m: 0.0)


def test_grow_caches_pads_seq_axis_only():
    # batch == prompt length: a size-sniffing grow would pad the batch axis
    cfg = dataclasses.replace(CFG_T, pattern=(("dense", 2),))
    caches = tlm.unstack_caches(cfg, tlm.init_cache(cfg, 6, 6, device="cpu"))
    grown = tkv.grow_caches(cfg, caches, 10)
    assert tuple(grown[0][1]["k"]["q"].shape) == (6, 10, 1, 32)


def test_sliding_window_matches_jax():
    # a window config gets windowed attention, not full causal attention:
    # the prefill and decodes past the window against the reference's
    cfg_j, cfg_t = dataclasses.replace(CFG_J, window=4), dataclasses.replace(CFG_T, window=4)
    pj = jatt.attn_init(cfg_j, jax.random.PRNGKey(2))
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    rng = np.random.default_rng(9)
    h = rng.normal(size=(1, 6, 128)).astype(np.float32)
    want, cj = jatt.attn_apply(cfg_j, pj, jnp.asarray(h), jnp.arange(6), 4, with_cache=True)
    got, ct = tatt.attn_apply(cfg_t, pt, _t(h), torch.arange(6), 4, with_cache=True)
    _close(want, got, lambda m: LOSSLESS_RTOL * m)
    full = tatt.attn_apply(cfg_t, pt, _t(h), torch.arange(6))
    assert not torch.allclose(full, got)  # the window changed the answer
    cj = jax.tree.map(lambda a: jnp.pad(a, ((0, 0), (0, 2), (0, 0), (0, 0))), cj)
    ct = tree.map(lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 2)), ct)
    for pos in (6, 7):
        x = rng.normal(size=(1, 1, 128)).astype(np.float32)
        want, cj = jatt.attn_decode(cfg_j, pj, jnp.asarray(x), cj, jnp.int32(pos), 4)
        got, ct = tatt.attn_decode(cfg_t, pt, _t(x), ct, pos, 4)
        _close(want, got, lambda m: LOSSLESS_RTOL * m)
