"""The port's architecture registry against the JAX package: all ten
architectures (the dense-block gemma-2b, minicpm-2b, phi4-mini-3.8b,
chameleon-34b with qk-norm and an untied head, musicgen-large on frame
embeddings, gemma2-9b's windowed local/global pairs, the MoE
granite-moe-1b-a400m, deepseek-v2-lite-16b's MLA with shared experts, and
the SSM xlstm-125m and zamba2-1.2b), mirroring
``tests/test_arch_smoke.py`` and ``tests/test_plan.py``'s category counts.

Tolerances:
* configs, plans and their manifests: equal, field by field;
* the forward at SMOKE size, f32, JAX weights carried across: logits within
  ``LOGIT_RTOL`` of max|logit|, the aux term within ``LOGIT_RTOL``
  relative;
* prefill then one decode step against the forward's last logits (the
  port's own paths): the reference test's bounds, ``1e-3`` in f32 and
  ``5e-2`` in bf16. The prefill's caches grow along their sequence axes
  only (``serve.kv_pages.grow_caches``): the SSM blocks' state leaves have
  none.
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
from repro.models import lm as jlm  # noqa: E402
from repro.optim import PantherConfig as JPC  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import PantherConfig as TPC  # noqa: E402
from repro_torch.serve.kv_pages import grow_caches  # noqa: E402

ARCHS = tconfigs.ARCH_IDS
LOGIT_RTOL = 1e-5
B, S = 2, 32

# tests/test_plan.py's golden partitions
GOLDEN_PARTITION = {
    "zamba2_1p2b": {"digital": 17, "dense": 19, "operand": 0},
    "deepseek_v2_lite_16b": {"digital": 4, "dense": 13, "operand": 11},
    "gemma2_9b": {"digital": 1, "dense": 9, "operand": 10},
    "xlstm_125m": {"digital": 17, "dense": 23, "operand": 0},
    "musicgen_large": {"digital": 1, "dense": 3, "operand": 5},
    "granite_moe_1b_a400m": {"digital": 1, "dense": 7, "operand": 2},
    "minicpm_2b": {"digital": 1, "dense": 3, "operand": 5},
    "gemma_2b": {"digital": 1, "dense": 3, "operand": 5},
    "phi4_mini_3p8b": {"digital": 1, "dense": 3, "operand": 5},
    "chameleon_34b": {"digital": 1, "dense": 6, "operand": 5},
}
GOLDEN_COVERAGE = {
    "zamba2_1p2b": {"digital": 15, "dense": 7, "operand": 14, "im2col": 2, "expert": 0},
    "deepseek_v2_lite_16b": {"digital": 4, "dense": 9, "operand": 15, "im2col": 0, "expert": 3},
    "gemma2_9b": {"digital": 1, "dense": 9, "operand": 10, "im2col": 0, "expert": 0},
    "xlstm_125m": {"digital": 15, "dense": 3, "operand": 22, "im2col": 2, "expert": 0},
    "musicgen_large": {"digital": 1, "dense": 3, "operand": 5, "im2col": 0, "expert": 0},
    "granite_moe_1b_a400m": {"digital": 1, "dense": 3, "operand": 6, "im2col": 0, "expert": 3},
    "minicpm_2b": {"digital": 1, "dense": 3, "operand": 5, "im2col": 0, "expert": 0},
    "gemma_2b": {"digital": 1, "dense": 3, "operand": 5, "im2col": 0, "expert": 0},
    "phi4_mini_3p8b": {"digital": 1, "dense": 3, "operand": 5, "im2col": 0, "expert": 0},
    "chameleon_34b": {"digital": 1, "dense": 6, "operand": 5, "im2col": 0, "expert": 0},
}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    return rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)


def _t(a):
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)


def _fields(cfg) -> dict:
    """A config as plain values (dtypes and nested configs by name)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "dtype":
            v = str(v).split(".")[-1] if isinstance(v, torch.dtype) else np.dtype(v).name
        out[f.name] = _fields(v) if dataclasses.is_dataclass(v) else v
    return out


def test_registry_matches_the_reference():
    assert ARCHS == jconfigs.ARCH_IDS and tconfigs.UNPORTED == []
    assert {k: v for k, v in jconfigs.ALIASES.items()} == tconfigs.ALIASES
    assert tconfigs.SHAPES == jconfigs.SHAPES
    for arch in ARCHS:
        for get_t, get_j in ((tconfigs.get, jconfigs.get), (tconfigs.get_smoke, jconfigs.get_smoke)):
            assert _fields(get_t(arch)) == _fields(get_j(arch)), arch
        assert tconfigs.shape_cells(arch) == jconfigs.shape_cells(arch)
    alias = {v: k for k, v in tconfigs.ALIASES.items()}
    for arch in ARCHS:  # the canonical names resolve to the same configs
        if arch in alias:
            assert tconfigs.get(alias[arch]) == tconfigs.get(arch)
    cfg = tconfigs.with_fidelity(tconfigs.get_smoke("granite-moe-1b-a400m"), "adc9")
    assert cfg.fidelity == tconfigs.fidelity_presets()["adc9"]


def _counts(plan, groups: bool) -> dict:
    cats = {"digital": 0, "dense": 0, "operand": 0, **({"im2col": 0, "expert": 0} if groups else {})}
    for pl in plan.values():
        cats[pl.category] += 1
        if groups and pl.group:
            cats[pl.group] += 1
    return cats


@pytest.mark.parametrize("rules", ["default", "coverage"])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_categories_match_the_reference(arch, rules):
    """At full size, from shapes only: the same per-leaf plan as the
    reference's (manifests equal), and ``tests/test_plan.py``'s counts."""
    rj, rt = {"default": (jplan.default_rules, tplan.default_rules),
              "coverage": (jplan.coverage_rules, tplan.coverage_rules)}[rules]
    cfg_j = jconfigs.get(arch)
    jp = jplan.resolve_plan(jax.eval_shape(lambda: jlm.init_params(cfg_j, jax.random.PRNGKey(0))), rj(JPC()))
    tp = tplan.resolve_plan(tlm.param_shapes(tconfigs.get(arch)), rt(TPC()))
    assert tplan.plan_manifest(tp) == jplan.plan_manifest(jp)
    assert tplan.plan_summary(tp) == jplan.plan_summary(jp)
    golden = GOLDEN_PARTITION if rules == "default" else GOLDEN_COVERAGE
    assert _counts(tplan.plan_by_path(tp), rules == "coverage") == golden[arch]


def _models(arch, dtype_j, dtype_t):
    cfg_j = dataclasses.replace(jconfigs.get_smoke(arch), dtype=dtype_j)
    cfg_t = dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype_t)
    pj = jlm.init_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, pj, convert.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference(arch):
    cfg_j, cfg_t, pj, pt = _models(arch, jnp.float32, torch.float32)
    inp = _inputs(cfg_t)
    lj, aj = jlm.forward(cfg_j, pj, jnp.asarray(inp), remat=False)
    with torch.no_grad():
        lt, at = tlm.forward(cfg_t, pt, _t(inp))
    lj = np.asarray(lj)
    assert lt.shape == (B, S, cfg_t.vocab) and np.isfinite(_np(lt)).all()
    assert np.abs(_np(lt) - lj).max() <= LOGIT_RTOL * np.abs(lj).max()
    assert abs(float(at) - float(aj)) <= LOGIT_RTOL * abs(float(aj))
    assert (float(at) > 0) == (cfg_t.moe is not None)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 5e-2)], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch, dtype, tol):
    """decode(prefill(x[:-1]), x[-1]) logits == forward(x)'s last ones."""
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype)
    params = tlm.init_params(cfg, 0, device="cpu")
    inp = _t(_inputs(cfg))
    with torch.no_grad():
        full, _ = tlm.forward(cfg, params, inp)
        prefix = inp[:, :S - 1]
        last = inp[:, S - 1] if cfg.input_mode == "tokens" else inp[:, S - 1:]
        _, caches = tlm.prefill(cfg, params, prefix)
        grown = grow_caches(cfg, tlm.unstack_caches(cfg, caches), S)
        dec, _ = tlm.decode_step(cfg, params, last, grown, S - 1)
    np.testing.assert_allclose(_np(dec), _np(full[:, -1]), rtol=tol, atol=tol)


def test_local_blocks_match_the_reference():
    # the "local" block (no config's pattern uses it alone): gemma2-9b's
    # SMOKE widths as two windowed layers; the forward against the
    # reference's, prefill + decode against the forward
    cfg_j = dataclasses.replace(jconfigs.get_smoke("gemma2_9b"), dtype=jnp.float32, pattern=(("local", 2),))
    cfg_t = dataclasses.replace(tconfigs.get_smoke("gemma2_9b"), dtype=torch.float32, pattern=(("local", 2),))
    assert cfg_t.window < S
    pj = jlm.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    inp = _inputs(cfg_t)
    lj, _ = jlm.forward(cfg_j, pj, jnp.asarray(inp), remat=False)
    with torch.no_grad():
        lt, _ = tlm.forward(cfg_t, pt, _t(inp))
        _, caches = tlm.prefill(cfg_t, pt, _t(inp[:, :S - 1]))
        dec, _ = tlm.decode_step(cfg_t, pt, _t(inp[:, S - 1]), grow_caches(cfg_t, tlm.unstack_caches(cfg_t, caches), S),
                                 S - 1)
    lj = np.asarray(lj)
    assert np.abs(_np(lt) - lj).max() <= LOGIT_RTOL * np.abs(lj).max()
    np.testing.assert_allclose(_np(dec), _np(lt[:, -1]), rtol=1e-3, atol=1e-3)
