"""The port's paged KV cache (``repro_torch.serve.kv_pages`` and the paged
primitives of ``repro_torch.models.common``) against the JAX package, case
by case with ``tests/test_kv_pages.py``, on the same numpy inputs.

Held bit for bit: the leaf layouts, the pool specs, the allocator's tables
through every call, the gathers and the scatters (the port's pools carry
one write-only page past the reference's, so their first ``P`` pages are
compared), and the sentinel's dropped writes. The grown prefill caches
hold the port's own prefix exactly and the reference's within f32
reassociation (``PREFILL_RTOL``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import kv_pages as jkv  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import kv_pages as tkv  # noqa: E402

PREFILL_RTOL = 1e-5  # f32 prefill caches, port vs reference, relative to max|K/V|
INT8_RTOL = 5e-2  # int8-cache decode logits, port vs reference, relative to max|logit|

BASE = dict(arch_id="kv-test", d_model=32, n_layers=2, vocab=64, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
            pattern=(("dense", 2),))


def _cfgs(**kw):
    base = dict(BASE, **kw)
    return jcommon.LMConfig(dtype=jnp.float32, **base), tcommon.LMConfig(dtype=torch.float32, **base)


def _same_layout(lj, lt):
    assert (lt.batch_axis, lt.seq_axis, lt.shape) == (lj.batch_axis, lj.seq_axis, tuple(lj.shape))
    assert str(lt.dtype).removeprefix("torch.") == np.dtype(lj.dtype).name


def test_cache_layouts_attn():
    cfg_j, cfg_t = _cfgs()
    (lay_j,), (lay_t,) = jkv.cache_layouts(cfg_j), tkv.cache_layouts(cfg_t)
    leaves_j = jax.tree.leaves(lay_j, is_leaf=lambda x: isinstance(x, jkv.LeafLayout))
    leaves_t = [leaf for _, leaf in tree.leaves_sorted(lay_t)]
    assert len(leaves_t) == len(leaves_j) == 2
    for lj, lt in zip(leaves_j, leaves_t):
        _same_layout(lj, lt)
        assert lt.batch_axis == 0 and lt.seq_axis == 1  # K/V caches are [B, S, KV, hd]


def test_cache_layouts_mamba2_state_is_not_paged():
    """The mamba2 state leaves (``ssd``, ``conv``) have no sequence axis:
    the same layouts as the reference's, none paged; the pools keep them
    as ``n_slots`` dense rows, and zamba's stacked states ``[N, B, ...]``
    carry the batch on axis 1."""
    ssm = dict(d_state=16, d_conv=4, expand=2, head_dim=8, chunk=8)
    cfg_j = dataclasses.replace(_cfgs()[0], pattern=(("mamba2", 2),), ssm=jcommon.SSMCfg(**ssm))
    cfg_t = dataclasses.replace(_cfgs()[1], pattern=(("mamba2", 2),), ssm=tcommon.SSMCfg(**ssm))
    (lay_j,), (lay_t,) = jkv.cache_layouts(cfg_j), tkv.cache_layouts(cfg_t)
    leaves_j = jax.tree.leaves(lay_j, is_leaf=lambda x: isinstance(x, jkv.LeafLayout))
    leaves_t = [leaf for _, leaf in tree.leaves_sorted(lay_t)]
    assert len(leaves_t) == len(leaves_j) == 2
    for lj, lt in zip(leaves_j, leaves_t):
        _same_layout(lj, lt)
        assert lt.seq_axis is None and lt.batch_axis is not None and not lt.is_paged
    spec = tkv.pool_spec(3, 16, page=4)
    for c in tkv.make_paged_caches(cfg_t, spec, device="cpu")[0]:
        assert c["ssd"].shape == (3, 8, 8, 16) and c["conv"].shape == (3, 3, 96)
    cfg_z = dataclasses.replace(cfg_t, pattern=(("zamba_unit", 2),), zamba=tcommon.ZambaCfg(share_every=3))
    (lay_z,) = tkv.cache_layouts(cfg_z)
    assert lay_z["mamba"]["ssd"].batch_axis == 1 and lay_z["shared"]["k"]["q"].is_paged
    ((unit, _),) = tkv.make_paged_caches(cfg_z, spec, device="cpu")
    assert unit["mamba"]["ssd"].shape == (3, 3, 8, 8, 16) and unit["shared"]["k"]["q"].shape == (13, 4, 2, 8)


@pytest.fixture(scope="module")
def weights():
    cfg_j, cfg_t = _cfgs()
    pj = jlm.init_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, pj, convert.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")


@pytest.mark.parametrize("B,L,grow", [(2, 8, 32), (4, 4, 16)])  # the second: batch == prompt_len
def test_grow_caches_pads_seq_axis_only(weights, B, L, grow):
    """Both mirrored cases of the reference (``batch == prompt_len`` too,
    where every axis size-sniffs as the sequence axis): the seq axis is
    padded, the batch axis untouched, the prefix kept."""
    cfg_j, cfg_t, pj, pt = weights
    x = (np.arange(B * L, dtype=np.int32).reshape(B, L) % cfg_j.vocab)
    _, cj = jax.jit(lambda p, xx: jlm.prefill(cfg_j, p, xx))(pj, jnp.asarray(x))
    want = jax.tree.leaves(jkv.grow_caches(cfg_j, jlm.unstack_caches(cfg_j, cj), grow))
    with torch.no_grad():
        _, ct = tlm.prefill(cfg_t, pt, torch.from_numpy(x.astype(np.int64)))
    ct = tlm.unstack_caches(cfg_t, ct)
    grown = [leaf for _, leaf in tree.leaves_sorted(tkv.grow_caches(cfg_t, ct, grow))]
    before = [leaf for _, leaf in tree.leaves_sorted(ct)]
    assert len(grown) == len(want) == 4
    for g, b, w in zip(grown, before, want):
        assert tuple(g.shape) == tuple(w.shape) == (B, grow, cfg_t.n_kv_heads, cfg_t.head_dim)
        assert torch.equal(g[:, :L], b) and not g[:, L:].any()
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= PREFILL_RTOL * np.abs(w).max()


def test_pool_spec_validation():
    for kv in (jkv, tkv):
        with pytest.raises(ValueError, match="multiple"):
            kv.pool_spec(2, 17, page=4)
    spec = tkv.pool_spec(2, 16, page=4)
    assert dataclasses.astuple(spec) == dataclasses.astuple(jkv.pool_spec(2, 16, page=4))
    assert (spec.max_pages, spec.num_pages, spec.max_seq) == (4, 8, 16)  # fully backed by default


def test_paged_gather_scatter_roundtrip():
    spec_j, spec_t = jkv.pool_spec(2, 16, page=4), tkv.pool_spec(2, 16, page=4)
    alloc_j, alloc_t = jkv.PageAllocator(spec_j), tkv.PageAllocator(spec_t)
    for alloc in (alloc_j, alloc_t):
        alloc.ensure(0, 6)
        alloc.ensure(1, 3)
    np.testing.assert_array_equal(alloc_t.table, alloc_j.table)
    P = spec_t.num_pages
    pool_j = jnp.zeros((P, spec_j.page, 3), jnp.float32)
    pool_t = torch.zeros((P + 1, spec_t.page, 3))
    table_j, table_t = alloc_j.device_table(), alloc_t.device_table("cpu")
    rng = np.random.default_rng(0)
    for pos in range(6):
        new = rng.normal(size=(2, 1, 3)).astype(np.float32)
        p = np.asarray([pos, pos], np.int32)
        pool_j = jcommon.paged_scatter(pool_j, table_j, jnp.asarray(new), jnp.asarray(p))
        out = tcommon.paged_scatter(pool_t, table_t, torch.from_numpy(new), torch.from_numpy(p))
        assert out is pool_t  # in place
        np.testing.assert_array_equal(pool_t[:P].numpy(), np.asarray(pool_j))
    got = tcommon.paged_gather(pool_t, table_t).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcommon.paged_gather(pool_j, table_j)))
    # slot 1 has pages for 3 tokens only: its positions 4..5 went to the
    # write-only page, not into any data page
    np.testing.assert_array_equal(got[1, 4:6], 0.0)
    assert pool_t[P].abs().sum() > 0


def test_paged_scatter_sentinel_row_drops():
    spec = tkv.pool_spec(2, 8, page=4)
    P = spec.num_pages
    table = np.full((2, 2), P, np.int32)  # all-sentinel: dead slots
    new = np.ones((2, 1, 2), np.float32)
    pos = np.asarray([0, 5], np.int32)
    want = jcommon.paged_scatter(jnp.zeros((P, 4, 2), jnp.float32), jnp.asarray(table), jnp.asarray(new),
                                 jnp.asarray(pos))
    pool = torch.zeros((P + 1, 4, 2))
    tcommon.paged_scatter(pool, torch.from_numpy(table), torch.from_numpy(new), torch.from_numpy(pos))
    np.testing.assert_array_equal(pool[:P].numpy(), np.asarray(want))
    assert not pool[:P].any() and pool[P].any()


def test_seq_scatter_drops_the_sentinel_like_the_reference():
    rng = np.random.default_rng(1)
    cache = rng.normal(size=(3, 5, 2)).astype(np.float32)
    new = rng.normal(size=(3, 1, 2)).astype(np.float32)
    pos = np.asarray([4, 5, 0], np.int32)  # slot 1 at the sentinel (out of range)
    want = jcommon.seq_scatter(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos))
    got = torch.from_numpy(cache.copy())
    tcommon.seq_scatter(got, torch.from_numpy(new), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_allocator_recycles_and_exhausts():
    """Every call on both allocators; the tables equal after each."""
    allocs = [kv.PageAllocator(kv.pool_spec(2, 16, page=4, num_pages=5)) for kv in (jkv, tkv)]

    def both(fn):
        for a in allocs:
            fn(a)
        np.testing.assert_array_equal(allocs[1].table, allocs[0].table)
        assert allocs[1].free_pages() == allocs[0].free_pages()

    both(lambda a: a.ensure(0, 16))  # 4 pages
    assert allocs[1].free_pages() == 1
    both(lambda a: a.ensure(1, 4))  # the last page
    assert allocs[1].free_pages() == 0
    for kv, a in zip((jkv, tkv), allocs):
        with pytest.raises(kv.OutOfPages):
            a.ensure(1, 8)
    pages0 = set(allocs[1].table[0, :4].tolist())
    both(lambda a: a.release(0))
    assert allocs[1].free_pages() == 4 and (allocs[1].table[0] == allocs[1].sentinel).all()
    both(lambda a: a.ensure(1, 16))  # recycled pages back a different slot
    assert set(allocs[1].table[1, 1:4].tolist()) <= pages0
    free = allocs[1].free_pages()
    both(lambda a: a.ensure(1, 16))  # idempotent at the current length
    assert allocs[1].free_pages() == free == 1


def test_with_tables_strip_tables_roundtrip():
    cache = [{"k": {"q": torch.zeros((2, 2))}, "v": {"q": torch.zeros((2, 2))}}, {"ssd": torch.zeros((2, 3))}]
    table = torch.zeros((2, 4), dtype=torch.int32)
    tagged = tkv.with_tables(cache, table)
    assert "table" in tagged[0] and tagged[0]["table"] is table
    assert "table" not in tagged[1]  # a state dict is not a KV unit
    stripped = tkv.strip_tables(tagged)
    assert stripped == cache and "table" not in cache[0]  # the input is untouched


def test_int8_cache_pages_like_any_seq_leaf():
    """The int8 cache's scale leaf ``s`` pages beside ``q``: a paged decode
    of every slot at its own position equals the dense per-slot decode bit
    for bit, and the reference's paged decode within the int8 rounding of
    its K/V (a code can round the other way on a ulp of difference)."""
    cfg_j, cfg_t = _cfgs()
    pj = jlm.init_params(cfg_j, jax.random.PRNGKey(1))
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    B, page, T = 3, 4, 5
    spec = tkv.pool_spec(B, 12, page=page)
    alloc = tkv.PageAllocator(spec)
    for s in range(B):
        alloc.ensure(s, spec.max_seq)
    table = alloc.device_table("cpu")
    P = spec.num_pages
    specs_t = tlm.cache_specs(cfg_t, B, spec.max_seq, torch.int8, layout="list")
    paged = tree.map(lambda s: torch.zeros((P + 1, page, *s.shape[2:]), dtype=s.dtype), specs_t)
    dense = tree.map(lambda s: torch.zeros(s.shape, dtype=s.dtype), specs_t)
    jpaged = jax.tree.map(lambda a: jnp.zeros((P, page) + tuple(a.shape[2:]), a.dtype),
                          jlm.cache_specs(cfg_j, B, spec.max_seq, jnp.int8, layout="list"))
    jpaged = jkv.with_tables(jpaged, jnp.asarray(alloc.table))
    assert sorted(paged[0][0]["k"]) == ["q", "s"]
    decode_j = jax.jit(lambda p, t, c, pos: jlm.decode_step(cfg_j, p, t, c, pos))
    rng = np.random.default_rng(2)
    pos = np.asarray([0, 2, 1])
    for t in range(T):
        tok = rng.integers(0, cfg_t.vocab, size=B)
        p = pos + t
        with torch.no_grad():
            lp, _ = tlm.decode_step(cfg_t, pt, torch.from_numpy(tok), tkv.with_tables(paged, table),
                                    torch.from_numpy(p))
            ld, _ = tlm.decode_step(cfg_t, pt, torch.from_numpy(tok), dense, torch.from_numpy(p))
        assert torch.equal(lp, ld)
        lj, jpaged = decode_j(pj, jnp.asarray(tok, jnp.int32), jpaged, jnp.asarray(p, jnp.int32))
        lj = np.asarray(lj)
        assert np.abs(lp.numpy() - lj).max() <= INT8_RTOL * np.abs(lj).max()
    for leaf in ("q", "s"):
        view = tcommon.paged_gather(paged[0][0]["k"][leaf], table)
        assert torch.equal(view, dense[0][0]["k"][leaf])
