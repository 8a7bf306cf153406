"""deepseek-v2-lite-16b's blocks in the port against the JAX package: MLA
(the fused ``wq_dkv`` read, the compressed ``c_kv``/``k_rope`` cache, its
prefill, continuation and decode on dense and paged caches, the chunked path
at a value width other than the query's: a mirror of
``tests/test_chunked_paths.py::test_sdpa_chunked_different_vdim``), the
``mla_dense``/``mla_moe`` blocks, the capacity rows at full size, and one
SMOKE train step. f32; JAX weights carried across by ``repro_torch.convert``.

Tolerances: the chunked attention within the reference test's ``2e-5``; the
blocks and decodes within ``BLOCK_RTOL`` of max|value|; the train step as
``tests/torch_smoke_step.py`` holds it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_smoke_step import check_smoke_step  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import kv_pages as tkv  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

BLOCK_RTOL = 1e-5
ARCH = "deepseek_v2_lite_16b"


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, rtol=BLOCK_RTOL):
    want = np.asarray(want, np.float32)
    assert np.abs(_np(got) - want).max() <= rtol * np.abs(want).max()


def _cfgs():
    return (dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=jnp.float32),
            dataclasses.replace(tconfigs.get_smoke(ARCH), dtype=torch.float32))


def _port(tree_j):
    return convert.params_from_jax(jax.tree.map(np.asarray, tree_j), device="cpu")


@pytest.fixture(scope="module")
def mla():
    """SMOKE configs and one MLA layer's params (nudged off their init so
    the norms' scales are not zero), both packages'."""
    cfg_j, cfg_t = _cfgs()
    rng = np.random.default_rng(0)
    pj = jax.tree.map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32),
                      jatt.mla_init(cfg_j, jax.random.PRNGKey(1)))
    return cfg_j, cfg_t, pj, _port(pj)


def test_sdpa_chunked_different_vdim():
    """The reference test's case (q/k width 24, v width 16, 2048 keys): the
    port's chunked attention against the reference's and against its own
    explicit mask."""
    cfg_j = jcommon.LMConfig(arch_id="t", d_model=64, n_layers=1, vocab=64, n_heads=4, n_kv_heads=2, head_dim=16,
                             d_ff=128, dtype=jnp.float32)
    cfg_t = tcommon.LMConfig(arch_id="t", d_model=64, n_layers=1, vocab=64, n_heads=4, n_kv_heads=2, head_dim=16,
                             d_ff=128, dtype=torch.float32)
    rng = np.random.default_rng(1)
    q = rng.normal(size=(1, 2048, 4, 24)).astype(np.float32)
    k = rng.normal(size=(1, 2048, 4, 24)).astype(np.float32)
    v = rng.normal(size=(1, 2048, 4, 16)).astype(np.float32)
    want = jax.jit(lambda a, b, c: jatt._sdpa_chunked(cfg_j, a, b, c, None))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tatt._sdpa_chunked(cfg_t, tq, tk, tv, None)
    assert got.shape == (1, 2048, 4, 16)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(got), _np(tatt._sdpa(cfg_t, tq, tk, tv, tatt.causal_mask(2048, 2048))),
                               rtol=2e-5, atol=2e-5)


def test_mla_apply_above_the_threshold_matches_the_reference(mla):
    """``mla_apply`` over 3072 positions takes the chunked path at ``hd`` =
    nope + rope and ``hd_v`` = v_head_dim, against the reference's."""
    cfg_j, cfg_t, pj, pt = mla
    h = np.random.default_rng(2).normal(size=(1, 3072, cfg_t.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: jatt.mla_apply(cfg_j, p, x, jnp.arange(3072)))(pj, h)
    with torch.no_grad():
        got = tatt.mla_apply(cfg_t, pt, torch.from_numpy(h), torch.arange(3072))
    _close(got, want)


def test_mla_prefill_and_continuation_match_the_reference(mla):
    """``mla_apply`` with its cache (``c_kv`` after ``kv_ln``, ``k_rope``
    [B, S, 1, rope]) and ``mla_cont`` chunk by chunk into a zero cache
    written in place, against the reference's."""
    cfg_j, cfg_t, pj, pt = mla
    h = np.random.default_rng(3).normal(size=(2, 12, cfg_t.d_model)).astype(np.float32)
    want, cj = jax.jit(lambda p, x: jatt.mla_apply(cfg_j, p, x, jnp.arange(12), with_cache=True))(pj, h)
    with torch.no_grad():
        got, ct = tatt.mla_apply(cfg_t, pt, torch.from_numpy(h), torch.arange(12), with_cache=True)
    _close(got, want)
    assert tuple(ct["k_rope"].shape) == (2, 12, 1, cfg_t.mla.qk_rope_dim)
    for k in ("c_kv", "k_rope"):
        _close(ct[k], cj[k])
    zj = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jatt.mla_cache_spec(cfg_j, 2, 12, jnp.float32))
    zt = tree.map(lambda s: torch.zeros(s.shape, dtype=s.dtype), tatt.mla_cache_spec(cfg_t, 2, 12, torch.float32))
    cont_j = jax.jit(lambda p, x, c, pos, start: jatt.mla_cont(cfg_j, p, x, c, pos, start))
    for start in (0, 5):
        sl = slice(start, start + (5 if start == 0 else 7))
        want, zj = cont_j(pj, jnp.asarray(h[:, sl]), zj, jnp.arange(12)[sl], jnp.int32(start))
        with torch.no_grad():
            got, out = tatt.mla_cont(cfg_t, pt, torch.from_numpy(h[:, sl]), zt, torch.arange(12)[sl], start)
        assert out is zt
        _close(got, want)
    for k in ("c_kv", "k_rope"):
        _close(zt[k], zj[k])


@pytest.mark.parametrize("case", ["dense-scalar", "dense-vector", "paged"])
def test_mla_decode_matches_the_reference(mla, case):
    """``mla_decode`` from a 6-token prefill, 5 steps: a dense cache at a
    scalar position, at one position a slot (slot 1 two positions behind),
    or page pools read through a table (vector positions), against the
    reference's; the caches at the end too."""
    cfg_j, cfg_t, pj, pt = mla
    rng = np.random.default_rng(4)
    B, L, S = 2, 6, 12
    h = rng.normal(size=(B, L, cfg_t.d_model)).astype(np.float32)
    _, pre = jatt.mla_apply(cfg_j, pj, jnp.asarray(h), jnp.arange(L), with_cache=True)
    dense = {k: np.pad(np.asarray(v), [(0, 0), (0, S - L)] + [(0, 0)] * (v.ndim - 2)) for k, v in pre.items()}
    if case == "paged":
        spec = tkv.pool_spec(B, S, page=4)
        alloc = tkv.PageAllocator(spec)
        for slot in range(B):
            alloc.ensure(slot, S)
        pools = {k: np.zeros((spec.num_pages, 4) + v.shape[2:], np.float32) for k, v in dense.items()}
        for slot in range(B):
            for j, page in enumerate(alloc.table[slot]):
                for k in pools:
                    pools[k][page] = dense[k][slot, 4 * j:4 * (j + 1)]
        cj = {"table": jnp.asarray(alloc.table), **{k: jnp.asarray(v) for k, v in pools.items()}}
        ct = {"table": alloc.device_table("cpu"),
              **{k: torch.from_numpy(np.concatenate([v, np.zeros_like(v[:1])])) for k, v in pools.items()}}
    else:
        cj = {k: jnp.asarray(v) for k, v in dense.items()}
        ct = {k: torch.from_numpy(v.copy()) for k, v in dense.items()}
    dec_j = jax.jit(lambda p, x, c, pos: jatt.mla_decode(cfg_j, p, x, c, pos))
    for t in range(5):
        x = rng.normal(size=(B, 1, cfg_t.d_model)).astype(np.float32)
        pos = np.int32(L + t) if case == "dense-scalar" else np.asarray([L + t, L + t - 2], np.int32)
        want, cj = dec_j(pj, jnp.asarray(x), cj, jnp.asarray(pos))
        with torch.no_grad():
            got, ct = tatt.mla_decode(cfg_t, pt, torch.from_numpy(x), ct,
                                      L + t if case == "dense-scalar" else torch.from_numpy(pos.astype(np.int64)))
        _close(got, want)
    for k in ("c_kv", "k_rope"):
        want = np.asarray(cj[k])
        _close(ct[k][: want.shape[0]], want)


@pytest.mark.parametrize("block", ["mla_dense", "mla_moe"])
def test_mla_block_matches_the_reference(block):
    """One ``mla_dense`` (the MLP at ``dense_ff_prefix``) or ``mla_moe``
    (shared experts beside the routed ones) layer of the SMOKE config:
    training apply with its aux term, prefill and one decode step."""
    cfg_j, cfg_t = _cfgs()
    pj = jlm.BLOCKS[block].init(cfg_j, jax.random.PRNGKey(2))
    pt = _port(pj)
    if block == "mla_dense":
        assert tuple(pt["mlp"]["wi_gate"].shape) == (cfg_t.d_model, cfg_t.dense_ff_prefix)
    else:
        assert cfg_t.moe.n_shared == 1 and "shared" in pt["moe"]
    h = np.random.default_rng(5).normal(size=(2, 10, cfg_t.d_model)).astype(np.float32)
    ctx_t = {"positions": torch.arange(10)}
    (oj, aj), (pre_j, cj) = jax.jit(lambda p, x: (
        jlm.BLOCKS[block].apply(cfg_j, p, x, {"positions": jnp.arange(10)}),
        jlm.BLOCKS[block].prefill(cfg_j, p, x, {"positions": jnp.arange(10)})))(pj, h)
    with torch.no_grad():
        ot, at = tlm.BLOCKS[block].apply(cfg_t, pt, torch.from_numpy(h), ctx_t)
        pre_t, ct = tlm.BLOCKS[block].prefill(cfg_t, pt, torch.from_numpy(h), ctx_t)
    _close(ot, oj)
    _close(pre_t, pre_j)
    assert abs(float(at) - float(aj)) <= BLOCK_RTOL * max(abs(float(aj)), 1e-30)
    cj = {k: jnp.pad(v, [(0, 0), (0, 1)] + [(0, 0)] * (v.ndim - 2)) for k, v in cj.items()}
    ct = tree.map(lambda a: torch.cat([a, torch.zeros_like(a[:, :1])], dim=1), ct)
    x = np.random.default_rng(6).normal(size=(2, 1, cfg_t.d_model)).astype(np.float32)
    want, _ = jax.jit(lambda p, y, c: jlm.BLOCKS[block].decode(cfg_j, p, y, c, {"pos": jnp.int32(10)}))(pj, x, cj)
    with torch.no_grad():
        got, _ = tlm.BLOCKS[block].decode(cfg_t, pt, torch.from_numpy(x), ct, {"pos": 10})
    _close(got, want)


def test_capacity_rows_and_the_fused_projection_at_full_size():
    """deepseek-v2-lite-16b at full size: 30 capacity rows an expert at 4 x
    64 tokens (64 experts top-6, factor 1.25), the reference's capacity;
    the fused ``wq_dkv`` [2048, 3648] (16 x 192 + 512 + 64: 28.5 crossbar
    tiles of 128 columns)."""
    cfg = tconfigs.get(ARCH)
    m = jconfigs.get(ARCH).moe
    sg = min(jmlp.MOE_GROUP, 256)  # one dispatch group, C slots an expert: its moe_apply's arithmetic
    cap_j = (256 // sg) * max(m.top_k, int(m.capacity_factor * sg * m.top_k / m.n_experts))
    assert tstep.expert_tokens(cfg, 256) == cap_j == 30
    shapes = tlm.param_shapes(cfg)
    assert shapes["groups"][1]["attn"]["wq_dkv"].shape == (26, 2048, 3648)
    assert shapes["groups"][0]["mlp"]["wi_gate"].shape == (2048, 10944)
    assert shapes["lm_head"].shape == (2048, 102400)


@pytest.mark.parametrize("rules", ["coverage", "default"])
def test_smoke_step_matches_the_reference(rules):
    """One lossless step of deepseek-v2-lite-16b's SMOKE config: under
    ``coverage_rules`` the expert banks are an expert group and the shared
    experts dense (multi-use), under ``default_rules`` every bank dense."""
    cfg_j, cfg_t = _cfgs()
    groups = check_smoke_step(cfg_j, cfg_t, rules, batch=4, seq=16)
    assert ("expert" in groups) == (rules == "coverage")


def test_fidelity_step_mla_arch_runs():
    """``tests/test_fidelity_training.py::test_fidelity_step_mla_arch_runs``
    on the port: an adc9 step under ``default_rules`` reads the fused MLA
    projections (``wq_dkv``, ``w_uk``, ``w_uv``, ``wo``) through the
    finite-ADC planes; its loss is finite."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.optim import PantherConfig
    from repro_torch.optim.schedules import constant
    from repro_torch.plan import default_rules, plan_by_path, resolve_plan

    _, cfg = _cfgs()
    opt = PantherConfig(stochastic_round=False, crs_every=1000)
    rules = default_rules(opt, fidelity=tconfigs.fidelity_presets()["adc9"])
    s0 = tstep.train_state_init(cfg, opt, 0, device="cpu")
    plan = plan_by_path(resolve_plan(tstep.param_shapes(s0.digital, s0.sliced), rules))
    for leaf in ("wq_dkv", "w_uk", "w_uv", "wo"):
        assert all(pl.fidelity is not None for path, pl in plan.items() if path.endswith(f"attn/{leaf}"))
    _, m = tstep.make_train_step(cfg, opt, constant(0.1), plan_rules=rules, remat="none")(
        s0, SyntheticLMDataset(cfg.vocab, 16, 2, device="cpu").batch(0))
    assert np.isfinite(float(m["loss"]))
