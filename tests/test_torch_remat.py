"""Remat in the train step (``make_train_step(remat=...)``, ``lm.hidden``,
``lm.loss_parts``) on the CPU.

* One SMOKE train step (f32, adc9 reads under ``coverage_rules``) from one
  state under ``remat="none"``, ``"full"`` and ``"dots"``: loss, aux, grad
  norm, every plane and every digital leaf equal bit for bit, for gemma-2b,
  granite (MoE: the aux term, the expert banks' grouped slots), zamba2 (the
  conv taps' im2col slot, the shared block), gemma2-9b (local/global pairs)
  and deepseek (MLA); gemma-2b also with ``microbatches=2`` and with
  ``stash_fallback``. Remat recomputes a layer's forward in the backward
  from the same inputs, and the operand slots are filled once, in the
  backward.
* The chunked loss (S = 2 · ``LOSS_CHUNK``, the chunk cut to 64 tokens in
  both packages for the test) against the reference's chunked
  ``loss_fn`` on the same weights within ``1e-5`` relative (f32); its
  lossless steps bit for bit across the modes; and the bytes autograd saves for the
  backward (``saved_tensors_hooks``): under ``"full"`` and ``"dots"``
  below ``"none"``, and the loss head's share under ``"none"`` (what the
  loss saves beyond the layers) below a quarter of one chunk's f32 logits,
  which the chunks' checkpoint keeps from being saved.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch import plan as planlib  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import PantherConfig  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.train import step as S  # noqa: E402

MODES = ("none", "full", "dots")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the modes' steps are compared bit for bit, and a
    multithreaded CPU matmul may split its sums by the threads it gets."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ARCHS = ("gemma_2b", "granite_moe_1b_a400m", "zamba2_1p2b", "gemma2_9b", "deepseek_v2_lite_16b")
CASES = [(a, {}) for a in ARCHS] + [("gemma_2b", {"microbatches": 2}), ("gemma_2b", {"stash_fallback": True})]


def _snapshot(state, metrics) -> dict:
    out = {k: float(metrics[k]) for k in ("loss", "aux", "grad_norm")}
    out.update({("s",) + p: s.planes.clone() for p, s in tree.leaves_with_path(state.sliced) if s is not None})
    out.update({("d",) + p: d.clone() for p, d in tree.leaves_with_path(state.digital) if d is not None})
    return out


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else a[k] == b[k] for k in a)


def _steps(cfg, batch, adc9: bool = True, **kw) -> dict:
    """One step from the seed-0 state under each mode, snapshotted: adc9
    reads under ``coverage_rules``, or (``adc9=False``, and with
    ``stash_fallback``) the default rules' lossless step."""
    opt = PantherConfig(crs_every=1, stochastic_round=True)
    rules = planlib.coverage_rules(opt, dataclasses.replace(configs.fidelity_presets()["adc9"], spec=opt.spec)) \
        if adc9 and not kw.get("stash_fallback", False) else None
    out = {}
    for mode in MODES:
        step = S.make_train_step(cfg, opt, constant(1e-2), remat=mode, plan_rules=rules, **kw)
        state = S.train_state_init(cfg, opt, 0, device="cpu")
        if rules is not None:
            plan = planlib.resolve_plan(S.param_shapes(state.digital, state.sliced), rules,
                                        tokens=batch["labels"].numel() // kw.get("microbatches", 1))
            state = S.train_state_init(cfg, opt, 0, device="cpu", plan=plan)
        out[mode] = _snapshot(*step(state, batch))
    return out


@pytest.mark.parametrize("arch,kw", CASES, ids=[f"{a}-{'-'.join(k) or 'plain'}" for a, k in CASES])
def test_remat_modes_step_bit_for_bit(arch, kw):
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32)
    batch = SyntheticLMDataset(cfg.vocab, 16, 4, device="cpu").batch(0)
    if "microbatches" in kw:
        batch = {k: v.reshape(kw["microbatches"], -1, *v.shape[1:]) for k, v in batch.items()}
    got = _steps(cfg, batch, **kw)
    assert np.isfinite(got["none"]["loss"])
    assert _equal(got["full"], got["none"]) and _equal(got["dots"], got["none"])


def test_remat_aliases_and_refusals():
    got = [lm.remat_mode(m) for m in (True, False, "full", "dots", "none")]
    assert got == ["full", "none", "full", "dots", "none"]
    with pytest.raises(ValueError, match="remat"):
        lm.remat_mode("offload")


CHUNK_CFG = dict(vocab=2048, n_layers=2, pattern=(("dense", 2),))


def _saved_bytes(fn) -> int:
    """Bytes of the storages autograd saves for the backward of ``fn()``
    (outside a checkpoint: a checkpointed region saves through its own
    hooks, and keeps only its inputs)."""
    seen = {}

    def pack(t):
        seen[t.untyped_storage()._cdata] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    del out
    return sum(seen.values())


LOSS_CHUNK = 64  # both packages' loss chunk in this test (the model's 1024): two chunks of a 128-token row


def test_chunked_loss_is_the_reference_s_and_checkpoints_each_chunk(monkeypatch):
    monkeypatch.setattr(lm, "LOSS_CHUNK", LOSS_CHUNK)
    monkeypatch.setattr(jlm, "LOSS_CHUNK", LOSS_CHUNK)
    S_ = 2 * LOSS_CHUNK
    cfg_j = dataclasses.replace(jconfigs.get_smoke("gemma_2b"), dtype=jnp.float32, **CHUNK_CFG)
    cfg = dataclasses.replace(configs.get_smoke("gemma_2b"), dtype=torch.float32, **CHUNK_CFG)
    params_j = jlm.init_params(cfg_j, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (1, S_ + 1)).astype(np.int32)
    bj = {"inputs": jnp.asarray(tokens[:, :-1]), "labels": jnp.asarray(tokens[:, 1:])}
    bt = {k: torch.from_numpy(np.array(v)).long() for k, v in bj.items()}
    want = float(jlm.loss_fn(cfg_j, params_j, bj, remat=False))
    for mode in MODES:
        nll, aux = lm.loss_parts(cfg, params, bt, remat=mode)
        assert abs(float(nll) - want) <= 1e-5 * want
    leaves = [p.requires_grad_(True) for _, p in tree.leaves_with_path(params)]
    assert leaves
    saved = {mode: _saved_bytes(lambda: lm.loss_parts(cfg, params, bt, remat=mode)) for mode in MODES}
    assert saved["full"] < saved["none"] and saved["dots"] < saved["none"]
    # the head's share: what the loss saves beyond the layers, under a
    # quarter of one chunk's f32 logits (unchecked, a chunk saves them whole)
    layers = _saved_bytes(lambda: lm.hidden(cfg, params, bt["inputs"], lm._table(cfg, params), remat="none"))
    assert saved["none"] - layers < lm.LOSS_CHUNK * cfg.vocab * 4 // 4
    # the (lossless) step at S > LOSS_CHUNK, bit for bit across the modes
    batch = SyntheticLMDataset(cfg.vocab, S_, 1, device="cpu").batch(0)
    got = _steps(cfg, batch, adc9=False)
    assert _equal(got["full"], got["none"]) and _equal(got["dots"], got["none"])
