"""gemma2-9b's blocks in the port against the JAX package: the chunked online
softmax (mirrors of ``tests/test_chunked_paths.py``'s attention cases), the
sliding window, the local layers' ring-buffer decode, the local/global pair
and its chunked prefill, the int8 cache on the ring (a mirror of
``tests/test_kv_quant.py::test_int8_decode_close_to_bf16``, on phi4-mini's
SMOKE config as that test reads it and on gemma2-9b's), and one SMOKE train
step. f32 throughout; JAX weights carried across by ``repro_torch.convert``.

Tolerances:
* ``_sdpa_chunked`` against the reference's and against the explicit mask:
  the reference test's ``2e-5``;
* the blocks and the decodes against the reference's on the same weights:
  within ``BLOCK_RTOL`` of max|value| (the frameworks sum in other orders);
* the int8 cache: the reference test's bound, ``0.08`` of max|logit| from the
  forward, and within ``INT8_RTOL`` of the reference's int8 decode (a code
  may round the other way where the frameworks' f32 K/V differ by an ulp);
* the train step: ``tests/torch_smoke_step.py``.
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
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import kv_pages as tkv  # noqa: E402

BLOCK_RTOL = 1e-5
INT8_RTOL = 2e-2
ARCH = "gemma2_9b"


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, rtol=BLOCK_RTOL):
    want = np.asarray(want, np.float32)
    assert np.abs(_np(got) - want).max() <= rtol * np.abs(want).max()


def _cfgs(arch=ARCH, **kw):
    return (dataclasses.replace(jconfigs.get_smoke(arch), dtype=jnp.float32, **kw),
            dataclasses.replace(tconfigs.get_smoke(arch), dtype=torch.float32, **kw))


def _port(tree_j):
    return convert.params_from_jax(jax.tree.map(np.asarray, tree_j), device="cpu")


def _mk_cfgs(**kw):
    base = dict(arch_id="test", d_model=64, n_layers=1, vocab=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128)
    return jcommon.LMConfig(**base, dtype=jnp.float32, **kw), tcommon.LMConfig(**base, dtype=torch.float32, **kw)


def _qkv(rng, B, S, H, KV, hd, hd_v=None):
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32), rng.normal(size=(B, S, KV, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd_v or hd)).astype(np.float32))


# ------------------- the chunked online softmax and the window -------------------


@pytest.mark.parametrize("window", [None, 256], ids=["global", "win256"])
@pytest.mark.parametrize("cap", [None, 50.0], ids=["nocap", "cap50"])
def test_sdpa_chunked_matches_exact(window, cap):
    """``tests/test_chunked_paths.py::test_sdpa_chunked_matches_exact``'s
    case: the port's chunked attention against the reference's and against
    its own explicit-mask attention."""
    cfg_j, cfg_t = _mk_cfgs(softcap_attn=cap)
    q, k, v = _qkv(np.random.default_rng(0), 2, 2048, 4, 2, 16)
    want = jax.jit(lambda a, b, c: jatt._sdpa_chunked(cfg_j, a, b, c, window))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tatt._sdpa_chunked(cfg_t, tq, tk, tv, window)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)
    exact = tatt._sdpa(cfg_t, tq, tk, tv, tatt.causal_mask(2048, 2048, window))
    np.testing.assert_allclose(_np(got), _np(exact), rtol=2e-5, atol=2e-5)


def test_attend_takes_the_chunked_path_above_the_threshold(monkeypatch):
    """``_attend`` above ``CHUNK_THRESHOLD`` keys (3072, windowed, capped)
    takes the chunked path and agrees with the reference's ``_attend``;
    at the threshold it takes the explicit mask."""
    cfg_j, cfg_t = _mk_cfgs(softcap_attn=50.0)
    q, k, v = _qkv(np.random.default_rng(2), 1, 3072, 2, 1, 8)
    want = jax.jit(lambda a, b, c: jatt._attend(cfg_j, a, b, c, 1500))(q, k, v)
    calls = []
    chunked = tatt._sdpa_chunked
    monkeypatch.setattr(tatt, "_sdpa_chunked", lambda *a: calls.append(a[1].shape[1]) or chunked(*a))
    got = tatt._attend(cfg_t, *(torch.from_numpy(a) for a in (q, k, v)), 1500)
    assert calls == [3072]
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)
    tatt._attend(cfg_t, *(torch.from_numpy(a[:, :2048]) for a in (q, k, v)), 1500)
    assert calls == [3072]


def test_sliding_window_attention_matches_the_reference():
    """``attn_apply`` and ``attn_cont`` under a window shorter than the
    sequence, and ``attn_decode`` past it (scalar position, dense cache
    grown from the prefill), against the reference's."""
    cfg_j, cfg_t = _mk_cfgs(post_norm=True, softcap_attn=50.0)
    rng = np.random.default_rng(3)
    pj = jax.tree.map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32),
                      jatt.attn_init(cfg_j, jax.random.PRNGKey(1)))
    pt = _port(pj)
    h = rng.normal(size=(2, 12, 64)).astype(np.float32)
    apply_j = jax.jit(lambda p, x: jatt.attn_apply(cfg_j, p, x, jnp.arange(12), 5, with_cache=True))
    decode_j = jax.jit(lambda p, x, c, pos: jatt.attn_decode(cfg_j, p, x, c, pos, 5))
    cont_j = jax.jit(lambda p, x, c, pos, start: jatt.attn_cont(cfg_j, p, x, c, pos, start, 5))
    want, cj = apply_j(pj, jnp.asarray(h))
    with torch.no_grad():
        got, ct = tatt.attn_apply(cfg_t, pt, torch.from_numpy(h), torch.arange(12), 5, with_cache=True)
    _close(got, want)
    grow = lambda c, n: {k: {"q": jnp.pad(c[k]["q"], ((0, 0), (0, n), (0, 0), (0, 0)))} for k in c}  # noqa: E731
    cj = grow(cj, 4)
    ct = tree.map(lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 4)), ct)
    for pos in range(12, 16):
        hn = rng.normal(size=(2, 1, 64)).astype(np.float32)
        want, cj = decode_j(pj, jnp.asarray(hn), cj, jnp.int32(pos))
        with torch.no_grad():
            got, ct = tatt.attn_decode(cfg_t, pt, torch.from_numpy(hn), ct, pos, 5)
        _close(got, want)
    c0j = {k: {"q": jnp.zeros((2, 12, 2, 16))} for k in ("k", "v")}
    c0t = {k: {"q": torch.zeros((2, 12, 2, 16))} for k in ("k", "v")}
    for start in (0, 6):
        sl = slice(start, start + 6)
        want, c0j = cont_j(pj, jnp.asarray(h[:, sl]), c0j, jnp.arange(12)[sl], jnp.int32(start))
        with torch.no_grad():
            got, c0t = tatt.attn_cont(cfg_t, pt, torch.from_numpy(h[:, sl]), c0t, torch.arange(12)[sl], start, 5)
        _close(got, want)


# ------------------------------ the local ring buffer ------------------------------


def _ring_caches(cfg_j, cfg_t, B, paged):
    """Zero caches of a ring of ``window`` positions, both packages': the
    block's ``cache_spec`` (dense) or page pools of 4 pages of 4 positions a
    slot (W = 16) with the table beside them."""
    W = cfg_t.window
    if not paged:
        spec_t = tlm.BLOCKS["local"].cache_spec(cfg_t, B, 64, torch.float32)
        spec_j = jlm.BLOCKS["local"].cache_spec(cfg_j, B, 64, jnp.float32)
        assert spec_t["k"]["q"].shape[1] == W
        return (jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), spec_j),
                tree.map(lambda s: torch.zeros(s.shape, dtype=s.dtype), spec_t))
    spec = tkv.pool_spec(B, W, page=4)
    alloc = tkv.PageAllocator(spec)
    for slot in range(B):
        alloc.ensure(slot, W)
    shape = (spec.num_pages, 4, cfg_t.n_kv_heads, cfg_t.head_dim)
    cj = {"table": jnp.asarray(alloc.table), **{k: {"q": jnp.zeros(shape, jnp.float32)} for k in ("k", "v")}}
    ct = {"table": alloc.device_table("cpu"),
          **{k: {"q": torch.zeros((shape[0] + 1, *shape[1:]))} for k in ("k", "v")}}
    return cj, ct


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
def test_local_ring_decode_matches_the_reference(vector, paged):
    """The "local" block's decode at SMOKE (window 16) from zero ring
    caches of 16 positions, 28 steps: the ring wraps and the window masks.
    A vector ``pos`` puts the two slots 5 positions apart. Outputs step by
    step and the rings at the end against the reference's."""
    cfg_j, cfg_t = _cfgs()
    pj = jax.tree.map(lambda a: a + 0.05 * np.random.default_rng(4).normal(size=a.shape).astype(np.float32),
                      jatt.block_init(cfg_j, jax.random.PRNGKey(1)))
    pt = _port(pj)
    B = 2
    cj, ct = _ring_caches(cfg_j, cfg_t, B, paged)
    dec_j = jax.jit(lambda p, h, c, pos: jlm.BLOCKS["local"].decode(cfg_j, p, h, c, {"pos": pos}))
    rng = np.random.default_rng(5)
    for t in range(28):
        h = rng.normal(size=(B, 1, cfg_t.d_model)).astype(np.float32)
        pos = np.asarray([t, t + 5], np.int32) if vector else np.int32(t)
        want, cj = dec_j(pj, jnp.asarray(h), cj, jnp.asarray(pos))
        with torch.no_grad():
            got, ct = tlm.BLOCKS["local"].decode(cfg_t, pt, torch.from_numpy(h), ct,
                                                 {"pos": torch.from_numpy(pos.astype(np.int64)) if vector else t})
        _close(got, want)
    for k in ("k", "v"):
        want = np.asarray(cj[k]["q"])
        _close(ct[k]["q"][: want.shape[0]], want)


def test_ring_mask_is_the_window_not_the_ring():
    """A ring longer than the window masks by the window; slots not yet
    written (stored position < 0) are masked; Python's modulo on negative
    differences (``torch.remainder``)."""
    m = tlm.ring_mask(5, 8, 3)
    assert (m[0] == 0).tolist() == [False, False, False, True, True, True, False, False]
    m = tlm.ring_mask(torch.tensor([9, 1]), 8, 3)[:, 0, 0, 0]
    assert (m[0] == 0).tolist() == [True, True, False, False, False, False, False, True]
    assert (m[1] == 0).tolist() == [True, True, False, False, False, False, False, False]


def test_pair_chunked_prefill_matches_the_reference():
    """The gemma2 pair's continuation: a 40-token prompt (past the window)
    in chunks of 16 into zero caches at the prompt's length
    (``prefill_cache_specs``), against the reference's chunks and against
    the port's single-shot prefill."""
    cfg_j, cfg_t = _cfgs()
    pj = jlm.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = _port(pj)
    prompt = np.random.default_rng(6).integers(0, cfg_t.vocab, size=(2, 40)).astype(np.int32)
    _, c_single = jlm.prefill(cfg_j, pj, jnp.asarray(prompt))
    cj = jax.tree.map(jnp.zeros_like, c_single)
    ct = tree.map(lambda s: torch.zeros(s.shape, dtype=s.dtype), tlm.prefill_cache_specs(cfg_t, 2, 40))
    prefill_j = jax.jit(lambda p, x, c, s: jlm.prefill(cfg_j, p, x, caches=c, start=s))
    for start in (0, 16, 32):
        x = prompt[:, start:start + 16]
        lj, cj = prefill_j(pj, jnp.asarray(x), cj, jnp.int32(start))
        with torch.no_grad():
            lt, ct = tlm.prefill(cfg_t, pt, torch.from_numpy(x.astype(np.int64)), caches=ct, start=start)
        _close(lt, lj)
    with torch.no_grad():
        single, cs = tlm.prefill(cfg_t, pt, torch.from_numpy(prompt.astype(np.int64)))
    _close(single, lj)
    for (_, a), (_, b) in zip(tree.leaves_sorted(ct), tree.leaves_sorted(cs), strict=True):
        _close(a, _np(b))


# ------------------------------- the int8 cache -------------------------------


@pytest.mark.parametrize("arch", ["phi4_mini_3p8b", ARCH])
def test_int8_decode_close_to_forward(arch):
    """``tests/test_kv_quant.py::test_int8_decode_close_to_bf16`` on the
    port: an int8 cache built by decoding 24 tokens one at a time from
    zeros, the last logits within 0.08 of the forward's. On gemma2-9b the
    local layers' caches are rings of 16 (``cache_specs``): their in-place
    int8 writes wrap. Both against the reference's int8 decode."""
    cfg_j, cfg_t = _cfgs(arch)
    B, S = 2, 24
    pj = jlm.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = _port(pj)
    inp = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, cfg_t.vocab))
    ct = tree.map(lambda s: torch.zeros(s.shape, dtype=s.dtype), tlm.cache_specs(cfg_t, B, S, torch.int8, "list"))
    cj = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jlm.cache_specs(cfg_j, B, S, jnp.int8, layout="list"))
    if arch == ARCH:
        assert ct[0][0]["local"]["k"]["q"].shape[1] == cfg_t.window < S
    dec_j = jax.jit(lambda p, t, c, pos: jlm.decode_step(cfg_j, p, t, c, pos))
    with torch.no_grad():
        full, _ = tlm.forward(cfg_t, pt, torch.from_numpy(inp.astype(np.int64)))
        for t in range(S):
            logits, ct = tlm.decode_step(cfg_t, pt, torch.from_numpy(inp[:, t].astype(np.int64)), ct, t)
            lj, cj = dec_j(pj, jnp.asarray(inp[:, t]), cj, jnp.int32(t))
    ref, got = _np(full[:, -1]), _np(logits)
    assert np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9) < 0.08
    _close(logits, lj, INT8_RTOL)


# ------------------------------- one train step -------------------------------


@pytest.mark.parametrize("rules", ["coverage", "default"])
def test_smoke_step_matches_the_reference(rules):
    """One lossless step of gemma2-9b's SMOKE config at 4 x 32 tokens (past
    the window of 16) from the same state and batch: the pairs' ``[2,
    ...]`` leaves nest under ``local``/``global``."""
    cfg_j, cfg_t = _cfgs()
    assert check_smoke_step(cfg_j, cfg_t, rules, batch=4, seq=32) == {None}
