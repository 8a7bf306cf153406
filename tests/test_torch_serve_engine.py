"""The port's serving engine (``repro_torch.serve.engine`` / ``scheduler`` /
``trace``) against its own solo serving and against the JAX package, case
by case with ``tests/test_serve_engine.py``, at its sizes (d_model 48, 2
layers, f32), JAX weights carried across by ``repro_torch.convert``.

* Scheduling is invisible: every request decodes the tokens it would have
  decoded served solo (dense caches, scalar positions), however requests
  pack into slots, rounds bucket, neighbours come and go, or a long prompt
  prefills chunked. The block kinds are ``"attn"`` (the dense block),
  ``"moe"`` (granite-moe-1b-a400m's SMOKE config, capacity factor 8: no
  expert ever overflows, so a token's experts do not depend on its
  neighbours), ``"mamba2"`` (state rows a slot, its prompts prefilled in
  chunks), ``"zamba"`` (zamba2-1.2b's SMOKE config: stacked mamba state
  rows beside the shared block's paged K/V, single-shot prefill),
  ``"gemma2"`` (gemma2-9b's SMOKE config: local/global pairs, window 16,
  the local layers decoding on their pages as a ring of ``max_seq``) and
  ``"mla"`` (the reference test's MLA config: paged ``c_kv``/``k_rope``).
* End to end: both engines on the same weights and the same trace, each
  with its own package's ``IsaClock(s_per_token, n_slots)`` as the cost
  table (it prices every key, so neither calibrates), give the same tokens,
  the same ``token_times`` and the same summary, exactly.
* Module by module, f32: the continuation prefill and the vector-position
  decode (dense and paged, with a dead slot) within ``LOGIT_RTOL`` of the
  reference's logits; sampled decoding's Gumbel noise within
  ``GUMBEL_ULPS`` ulps of ``jax.random.gumbel`` (of ``max(|g|, 1)``: XLA's
  and torch's f32 ``log`` differ), its tokens equal wherever the top-two
  gap exceeds that bound and the logits' tolerance.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import kv_pages as jkv  # noqa: E402
from repro.serve import scheduler as jsch  # noqa: E402
from repro.serve import trace as jtrace  # noqa: E402
from repro.serve.step import make_decode_step as jmake_decode_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import kv_pages as tkv  # noqa: E402
from repro_torch.serve import scheduler as sch  # noqa: E402
from repro_torch.serve import trace as ttrace  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.step import make_decode_step  # noqa: E402

LOGIT_RTOL = 1e-5  # f32 logits, port vs reference, relative to max|logit|
GUMBEL_ULPS = 2  # |Δg| <= GUMBEL_ULPS · ulp(max(|g|, 1))
S_PER_TOKEN = 1e-3  # the IsaClock's price, seconds a token

BASE = dict(arch_id="serve-test", d_model=48, n_layers=2, vocab=96, n_heads=4, n_kv_heads=2, head_dim=12, d_ff=96)
PATTERNS = {"attn": (("dense", 2),), "moe": (("moe", 2),), "mamba2": (("mamba2", 2),),
            "zamba": (("zamba_unit", 2), ("mamba2", 1)), "gemma2": (("gemma2_pair", 2),),
            "mla": (("mla_dense", 2),)}
# their SMOKE configs serve these kinds
SMOKE_ARCHS = {"moe": "granite_moe_1b_a400m", "zamba": "zamba2_1p2b", "gemma2": "gemma2_9b"}
SSM = dict(d_state=16, d_conv=4, expand=2, head_dim=12, chunk=8)  # the reference test's mamba2 kind
MLA = dict(kv_lora_rank=24, qk_nope_dim=12, qk_rope_dim=8, v_head_dim=12)  # the reference test's "mla" kind


@pytest.fixture(scope="module")
def models():
    """kind -> (JAX cfg, port cfg, JAX params, port params)."""
    out = {}
    for kind, pattern in PATTERNS.items():
        if kind in SMOKE_ARCHS:
            cfg_j = dataclasses.replace(jconfigs.get_smoke(SMOKE_ARCHS[kind]), dtype=jnp.float32)
            cfg_t = dataclasses.replace(tconfigs.get_smoke(SMOKE_ARCHS[kind]), dtype=torch.float32)
            assert cfg_t.pattern == pattern and (cfg_t.moe is None or cfg_t.moe.capacity_factor == 8.0)
        else:
            ssm = ({"ssm": (jcommon.SSMCfg(**SSM), tcommon.SSMCfg(**SSM))} if kind == "mamba2" else
                   {"mla": (jcommon.MLACfg(**MLA), tcommon.MLACfg(**MLA))} if kind == "mla" else {})
            cfg_j = jcommon.LMConfig(dtype=jnp.float32, pattern=pattern, **BASE, **{k: v[0] for k, v in ssm.items()})
            cfg_t = tcommon.LMConfig(dtype=torch.float32, pattern=pattern, **BASE,
                                     **{k: v[1] for k, v in ssm.items()})
        pj = jlm.init_params(cfg_j, jax.random.PRNGKey(0))
        out[kind] = cfg_j, cfg_t, pj, convert.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    return out


def _engine(cfg, params, **kw):
    return Engine(cfg, params, device="cpu", **kw)


def _solo_tokens(cfg, params, prompt: np.ndarray, out_len: int) -> list:
    """Greedy tokens of single-request serving: batch 1, dense caches grown
    to the full length, scalar positions."""
    L = int(prompt.shape[0])
    with torch.no_grad():
        logits, caches = tlm.prefill(cfg, params, torch.from_numpy(prompt.astype(np.int64))[None])
        caches = tkv.grow_caches(cfg, tlm.unstack_caches(cfg, caches), L + out_len)
        tok = torch.argmax(logits, dim=-1)
        out = [int(tok[0])]
        for i in range(out_len - 1):
            logits, caches = tlm.decode_step(cfg, params, tok, caches, L + i)
            tok = torch.argmax(logits, dim=-1)
            out.append(int(tok[0]))
    return out


def _mk_trace(cfg, seed, n, prompt_lens, out_lens):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        L = int(rng.choice(prompt_lens))
        reqs.append(sch.Request(rid=i, arrival=0.0, tokens=rng.integers(0, cfg.vocab, size=L).astype(np.int32),
                                out_len=int(rng.choice(out_lens))))
    return reqs


@pytest.mark.parametrize("kind", sorted(PATTERNS))
@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_engine_matches_solo_serving(models, kind, policy):
    """More requests than slots: admission waits on evictions, pages
    recycle, rounds run beside other requests: tokens must not notice."""
    _, cfg, _, params = models[kind]
    trace = _mk_trace(cfg, seed=3, n=5, prompt_lens=(4, 6), out_lens=(2, 5, 8))
    eng = _engine(cfg, params, n_slots=3, max_seq=16, page=4)
    res = sch.run_trace({"default": eng}, trace, policy=policy)
    assert len(res["requests"]) == len(trace)
    by_rid = {r.rid: r for r in res["requests"]}
    for req in trace:
        want = _solo_tokens(cfg, params, req.tokens, req.out_len)
        assert by_rid[req.rid].tokens == want, f"{kind}/{policy} rid={req.rid}"


def test_chunked_prefill_matches_single_shot(models):
    _, cfg, _, params = models["attn"]
    prompt = np.random.default_rng(7).integers(0, cfg.vocab, size=12).astype(np.int32)
    outs = {}
    for chunk in (None, 4):
        eng = _engine(cfg, params, n_slots=2, max_seq=32, page=4, chunk_size=chunk)
        job = eng.start(prompt)
        assert job.chunked == (chunk is not None)
        n_calls = 0
        while not job.finished:
            eng.prefill_step(job)
            n_calls += 1
        assert n_calls == (3 if chunk else 1)  # 12 tokens / chunk 4
        _, first = eng.admit(job)
        toks, _ = eng.decode_round(4)
        outs[chunk] = [first] + [int(toks[i, 0]) for i in range(4)]
    assert outs[4] == outs[None]
    assert set(eng._costs) == {("cont", 4, 12), ("round", 4)}


def test_admit_evict_any_order_recycles_pages(models):
    """Interleaved admit/evict in any slot order: pages recycle through the
    free list and later tenants do not see earlier ones."""
    _, cfg, _, params = models["attn"]
    rng = np.random.default_rng(11)
    # a pool for exactly 2 tenants at full length: recycling is load-bearing
    eng = _engine(cfg, params, n_slots=2, max_seq=16, page=4, num_pages=8)
    total = eng.alloc.free_pages()

    def serve_one(L, out_len):
        prompt = rng.integers(0, cfg.vocab, size=L).astype(np.int32)
        job = eng.start(prompt)
        while not job.finished:
            eng.prefill_step(job)
        slot, first = eng.admit(job)
        got = [first]
        while len(got) < out_len:
            toks, _ = eng.decode_round(2)
            got += [int(toks[i, slot]) for i in range(min(2, out_len - len(got)))]
        return slot, prompt, got

    s0, p0, g0 = serve_one(6, 5)
    s1, _, _ = serve_one(4, 3)
    assert s0 != s1
    eng.evict(s0)  # the first tenant leaves; the second keeps decoding
    s2, p2, g2 = serve_one(6, 5)
    assert s2 == s0  # the slot and its recycled pages reused
    eng.evict(s1)
    eng.evict(s2)
    assert eng.alloc.free_pages() == total
    assert g2 == _solo_tokens(cfg, params, p2, 5)
    assert g0 == _solo_tokens(cfg, params, p0, 5)


def test_engine_on_a_mesh_raises(models):
    """The engine on a mesh is ported, one data rank and more
    (``tests/test_torch_distributed_serve.py``,
    ``tests/test_torch_distributed_step.py``); a logical mesh cannot serve,
    whatever its shape."""
    from repro_torch.launch.mesh import logical_mesh

    _, cfg, _, params = models["attn"]
    with pytest.raises(ValueError, match="live mesh"):
        _engine(cfg, params, n_slots=2, max_seq=16, page=4, mesh=logical_mesh((2, 1), ("data", "model")))
    with pytest.raises(ValueError, match="live mesh"):
        _engine(cfg, params, n_slots=2, max_seq=16, page=4, mesh=logical_mesh((1, 2), ("data", "model")))


def test_sla_tiers_route_and_share_clock(models):
    """Two engines (different cost scales) on one clock: every request lands
    on its tier's engine, and the pricier tier's tokens cost more time."""
    _, cfg, _, params = models["attn"]
    rng = np.random.default_rng(9)
    reqs = [sch.Request(rid=i, arrival=0.0, tokens=rng.integers(0, cfg.vocab, size=4).astype(np.int32),
                        out_len=4, tier=tier) for i, tier in enumerate(["premium", "bulk"] * 2)]
    costs = {}
    engines = {"premium": _engine(cfg, params, n_slots=2, max_seq=16, page=4, costs=costs, cost_scale=4.0),
               "bulk": _engine(cfg, params, n_slots=2, max_seq=16, page=4, costs=costs, cost_scale=1.0)}
    res = sch.run_trace(engines, reqs, policy="continuous")
    assert {r.rid for r in res["requests"]} == {0, 1, 2, 3}
    for r in res["requests"]:
        assert r.tier == reqs[r.rid].tier
        assert r.tokens == _solo_tokens(cfg, params, reqs[r.rid].tokens, reqs[r.rid].out_len)
    itl = {t: np.mean([np.diff(r.token_times).mean() for r in res["requests"] if r.tier == t])
           for t in engines}
    assert itl["premium"] > itl["bulk"]


def test_unrouted_tier_raises(models):
    _, cfg, _, params = models["attn"]
    eng = _engine(cfg, params, n_slots=2, max_seq=16, page=4)
    req = sch.Request(rid=0, arrival=0.0, tokens=np.zeros(4, np.int32), out_len=2, tier="gold")
    with pytest.raises(ValueError, match="unrouted"):
        sch.run_trace({"default": eng}, [req])


# ----------------------------- against the reference --------------------------

TRACE = dict(seed=3, n_requests=6, rate=2e3, prompt_lens=(4, 6, 12), out_choices=((2, 0.5), (9, 0.5)))
GRID = dict(n_slots=3, max_seq=24, page=4, chunk_size=4)


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_engine_equals_the_reference_end_to_end(models, policy):
    """The same trace (``synth_trace`` held field by field) through both
    engines on the same weights, each priced by its package's ``IsaClock``:
    the same tokens, ``token_times``, clock and summary, exactly (the long
    prompts prefill chunked, the rounds run with dead and exhausted slots)."""
    _engines_agree(models["attn"], policy)


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_moe_engine_equals_the_reference_end_to_end(models, policy):
    """As above, on the MoE block: its attention half pages and chunks like
    the dense block's, and its expert buffers route each round's live and
    dead slots as the reference's do."""
    _engines_agree(models["moe"], policy)


@pytest.mark.parametrize("policy", ["continuous", "static"])
@pytest.mark.parametrize("kind", ["mamba2", "zamba"])
def test_ssm_engine_equals_the_reference_end_to_end(models, kind, policy):
    """As above, on the SSM kinds: each slot's state rows admitted over its
    predecessor's and updated in place by every round (the mamba2 kind's
    long prompts prefill chunked through its state; zamba prefills
    single-shot, its shared block's K/V paged beside the states)."""
    _engines_agree(models[kind], policy)


@pytest.mark.parametrize("policy", ["continuous", "static"])
@pytest.mark.parametrize("kind", ["gemma2", "mla"])
def test_gemma2_and_mla_engines_equal_the_reference_end_to_end(models, kind, policy):
    """As above, on gemma2-9b's pairs (the long prompts chunked through the
    local layers' windowed continuation, the rounds decoding past the
    window of 16 on the local layers' pages) and on MLA's paged
    ``c_kv``/``k_rope`` pools (chunked through ``mla_cont``)."""
    _engines_agree(models[kind], policy)


def _engines_agree(model, policy):
    cfg_j, cfg_t, pj, pt = model
    trace_j = jtrace.synth_trace(vocab=cfg_j.vocab, **TRACE)
    trace_t = ttrace.synth_trace(vocab=cfg_t.vocab, **TRACE)
    for rj, rt in zip(trace_j, trace_t, strict=True):
        assert (rt.rid, rt.arrival, rt.out_len, rt.tier) == (rj.rid, rj.arrival, rj.out_len, rj.tier)
        np.testing.assert_array_equal(rt.tokens, rj.tokens)
    assert len({len(r.tokens) for r in trace_t}) > 1 and any(len(r.tokens) > GRID["chunk_size"] for r in trace_t)
    assert tlm.supports_chunked_prefill(cfg_t) == jlm.supports_chunked_prefill(cfg_j)

    eng_j = jengine.Engine(cfg_j, pj, costs=jsch.IsaClock(S_PER_TOKEN, GRID["n_slots"]), **GRID)
    res_j = jsch.run_trace({"default": eng_j}, trace_j, policy=policy)
    eng_t = _engine(cfg_t, pt, costs=sch.IsaClock(S_PER_TOKEN, GRID["n_slots"]), **GRID)
    res_t = sch.run_trace({"default": eng_t}, trace_t, policy=policy)
    assert not dict.keys(eng_t._costs)  # every key priced: nothing calibrated
    assert res_t["clock"] == res_j["clock"]
    for rt, rj in zip(res_t["requests"], res_j["requests"], strict=True):
        assert (rt.rid, rt.tokens, rt.token_times, rt.ttft) == (rj.rid, rj.tokens, rj.token_times, rj.ttft)
    assert sch.summarize(res_t) == jsch.summarize(res_j)


ISA_TRACE = dict(seed=5, n_requests=8, rate=2e3, prompt_lens=(4, 6, 12), out_choices=((2, 0.5), (9, 0.5)))


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_engine_on_the_crossbar_clock_equals_the_reference(models, policy):
    """Each engine on the ``IsaClock.from_plan`` its own package compiled
    from its own lossless plan over the same weights: the same per-token
    price, so the same tokens, ``token_times`` and summary, exactly, with
    nothing calibrated."""
    from repro import plan as jplan
    from repro_torch import plan as tplan

    cfg_j, cfg_t, pj, pt = models["attn"]
    clk_j = jsch.IsaClock.from_plan(pj, jplan.resolve_plan(pj, jplan.default_rules()), n_slots=GRID["n_slots"])
    clk_t = sch.IsaClock.from_plan(pt, tplan.resolve_plan(pt, tplan.default_rules()), n_slots=GRID["n_slots"])
    assert clk_t.s_per_token == clk_j.s_per_token > 0
    eng_j = jengine.Engine(cfg_j, pj, costs=clk_j, **GRID)
    res_j = jsch.run_trace({"default": eng_j}, jtrace.synth_trace(vocab=cfg_j.vocab, **ISA_TRACE), policy=policy)
    eng_t = _engine(cfg_t, pt, costs=clk_t, **GRID)
    res_t = sch.run_trace({"default": eng_t}, ttrace.synth_trace(vocab=cfg_t.vocab, **ISA_TRACE), policy=policy)
    assert not dict.keys(clk_t)  # every key priced: nothing calibrated
    assert len(res_t["requests"]) == ISA_TRACE["n_requests"] and res_t["clock"] == res_j["clock"]
    for rt, rj in zip(res_t["requests"], res_j["requests"], strict=True):
        assert (rt.rid, rt.tokens, rt.token_times, rt.ttft) == (rj.rid, rj.tokens, rj.token_times, rj.ttft)
    assert sch.summarize(res_t) == jsch.summarize(res_j)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


def test_continuation_prefill_matches_the_reference(models):
    """``prefill(caches=, start=)`` (``attn_cont``/``block_cont``) chunk by
    chunk against the reference's, from the same zero caches."""
    cfg_j, cfg_t, pj, pt = models["attn"]
    prompt = np.random.default_rng(5).integers(0, cfg_t.vocab, size=(2, 10)).astype(np.int32)
    cj = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jlm.cache_specs(cfg_j, 2, 10))
    ct = tree.map(lambda s: torch.zeros(s.shape, dtype=s.dtype), tlm.cache_specs(cfg_t, 2, 10))
    assert tlm.supports_chunked_prefill(cfg_t)
    for start, stop in ((0, 4), (4, 8), (8, 10)):
        lj, cj = jlm.prefill(cfg_j, pj, jnp.asarray(prompt[:, start:stop]), caches=cj, start=jnp.int32(start))
        with torch.no_grad():
            lt, out = tlm.prefill(cfg_t, pt, torch.from_numpy(prompt[:, start:stop].astype(np.int64)),
                                  caches=ct, start=start)
        assert all(o is c for o, c in zip(out, ct, strict=True))  # written in place
        assert _rel(lt, lj) <= LOGIT_RTOL
    for (_, leaf_t), leaf_j in zip(tree.leaves_sorted(ct), jax.tree.leaves(cj), strict=True):
        assert _rel(leaf_t, leaf_j) <= LOGIT_RTOL
    with torch.no_grad():
        single, _ = tlm.prefill(cfg_t, pt, torch.from_numpy(prompt.astype(np.int64)))
    assert torch.equal(single.argmax(-1), lt.argmax(-1))


@pytest.mark.parametrize("paged", [False, True])
def test_vector_position_decode_matches_the_reference(models, paged):
    """``decode_step`` at one position a slot, slot 2 dead at the sentinel,
    on dense per-slot caches or on page pools: the live slots' logits within
    ``LOGIT_RTOL`` of the reference's, the caches' data pages too."""
    cfg_j, cfg_t, pj, pt = models["attn"]
    B, page, max_seq = 3, 4, 12
    spec = tkv.pool_spec(B, max_seq, page=page)
    alloc = tkv.PageAllocator(spec)
    alloc.ensure(0, 9)
    alloc.ensure(1, 5)  # slot 2 has no pages: dead
    if paged:
        ct = tkv.with_tables(tkv.make_paged_caches(cfg_t, spec, device="cpu"), alloc.device_table("cpu"))
        cj = jax.tree.map(lambda s: jnp.zeros((spec.num_pages, page) + tuple(s.shape[2:]), s.dtype),
                          jlm.cache_specs(cfg_j, B, max_seq, layout="list"))
        cj = jkv.with_tables(cj, jnp.asarray(alloc.table))
    else:
        ct = tlm.unstack_caches(cfg_t, tlm.init_cache(cfg_t, B, max_seq, device="cpu"))
        cj = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jlm.cache_specs(cfg_j, B, max_seq, layout="list"))
    decode_j = jax.jit(lambda p, t, c, pos: jlm.decode_step(cfg_j, p, t, c, pos))
    rng = np.random.default_rng(4)
    for step in range(5):
        tok = rng.integers(0, cfg_t.vocab, size=B)
        pos = np.asarray([3 + step, step, max_seq])  # slot 2 at the sentinel
        lj, cj = decode_j(pj, jnp.asarray(tok, jnp.int32), cj, jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            lt, ct = tlm.decode_step(cfg_t, pt, torch.from_numpy(tok), ct, torch.from_numpy(pos))
        assert _rel(lt[:2], np.asarray(lj)[:2]) <= LOGIT_RTOL
    for (_, leaf_t), leaf_j in zip(tree.leaves_sorted(tkv.strip_tables(ct)),
                                   jax.tree.leaves(jkv.strip_tables(cj)), strict=True):
        got = leaf_t[: spec.num_pages] if paged else leaf_t[:2]
        want = np.asarray(leaf_j) if paged else np.asarray(leaf_j)[:2]
        assert _rel(got, want) <= LOGIT_RTOL


def test_sampled_decode_matches_the_reference(models):
    """``make_decode_step(cfg, sample=True)``: ``core.prng.gumbel`` within
    ``GUMBEL_ULPS`` of ``jax.random.gumbel``, and the sampled tokens equal to
    the reference's wherever the top-two gap of logits + noise exceeds the
    noise's and the logits' bounds."""
    cfg_j, cfg_t, pj, pt = models["attn"]
    B, L, V = 4, 6, cfg_t.vocab
    prompt = np.random.default_rng(6).integers(0, V, size=(B, L)).astype(np.int32)
    lj, cj = jlm.prefill(cfg_j, pj, jnp.asarray(prompt))
    cj = jkv.grow_caches(cfg_j, jlm.unstack_caches(cfg_j, cj), L + 4)
    with torch.no_grad():
        lt, ct = tlm.prefill(cfg_t, pt, torch.from_numpy(prompt.astype(np.int64)))
    ct = tkv.grow_caches(cfg_t, tlm.unstack_caches(cfg_t, ct), L + 4)
    tok = np.asarray(jnp.argmax(lj, -1), np.int32)
    step_j, step_t = jmake_decode_step(cfg_j, sample=True), make_decode_step(cfg_t, sample=True)
    checked = 0
    for i, seed in enumerate((11, 12, 13)):
        key = prng.PRNGKey(seed)
        g_j = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (B, V), jnp.float32))
        g_t = prng.gumbel(key, (B, V)).numpy()
        bound = GUMBEL_ULPS * np.spacing(np.maximum(np.abs(g_j), 1.0).astype(np.float32))
        assert (np.abs(g_t.astype(np.float64) - g_j) <= bound).all()
        nj, logits_j, cj = step_j(pj, jnp.asarray(tok), cj, jnp.int32(L + i), rng=jax.random.PRNGKey(seed))
        nt, logits_t, ct = step_t(pt, torch.from_numpy(tok.astype(np.int64)), ct, L + i, rng=key)
        logits_j = np.asarray(logits_j)
        assert _rel(logits_t, logits_j) <= LOGIT_RTOL
        noisy = np.sort(logits_j + g_j, axis=-1)
        slack = bound.max() + LOGIT_RTOL * np.abs(logits_j).max()
        sure = noisy[:, -1] - noisy[:, -2] > 2 * slack
        assert (nt.numpy()[sure] == np.asarray(nj)[sure]).all()
        checked += int(sure.sum())
        tok = np.asarray(nj, np.int32)
    assert checked >= 10
