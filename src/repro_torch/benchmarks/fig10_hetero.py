"""Fig 10 on the port: heterogeneous weight slicing (counterpart of
``benchmarks/fig10_hetero.py``).

``spec_sweep``: the paper's study at tensor granularity. Fig 9's
teacher-student MLP (the same draws, ``fig9_slice_crs._task(0)``) trains 400
steps under each slice configuration of ``CONFIGS``; each row is the final
loss, the MVM energy factor of the configuration's widest slice
(``_adc_energy_factor``) and the trained planes read back through 6- and
9-bit ADCs. The paper's claims: configurations with extra bits on the
low-order slices beat uniform ones, and any 3-bit slice degrades.

``io_sweep``: the IO (DAC) width axis at the paper's 44466555: train once,
read the planes back at IO 8/12/16 through a 9-bit ADC, and price each
width's packed MVM round (``isa.energy.DEFAULT_ENERGY.mvm_packed``).

``hetero_plan_demo``: one model whose two layer groups run different
crossbar configurations at once (group 0 uniform-6 slices behind a 9-bit
ADC, group 1 the paper's 44466555 behind a 6-bit ADC), set by a
``PlanRule`` list, trained end to end (finite-ADC forward and MᵀVM reads,
each leaf's update at its own spec) and served through the same plan.

Every function takes ``device=`` (default ``cuda``). On the card the MLP's
leaves run K2's dense write every step and K4 for the ADC reads; the demo
runs K1, K2, K3 and K4/K4ᵀ at both specs. ``main`` prints the rows and
writes them as JSON only to a path it is given (``--json``).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig10_hetero [--device cpu] [--json PATH]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import prng
from repro_torch.core.slicing import SliceSpec
from repro_torch.device import resolve
from repro_torch.optim import PantherConfig, panther

from .fig9_slice_crs import _fwd_fidelity, _grad, _loss, _task, _train, fidelity_loss

# MSB->LSB configurations (the paper's Fig 10 uses sixteen; a representative set)
CONFIGS = [
    "44444444",
    "55555555",
    "66666666",
    "44466555",  # the paper's pick
    "44455566",
    "66655444",  # heterogeneous the wrong way (extra bits on the MSB)
    "44444555",
    "33344455",
    "43333334",
]


def _spec(name: str) -> SliceSpec:
    return SliceSpec(tuple(int(c) for c in name))


def _adc_energy_factor(spec: SliceSpec) -> float:
    """MVM energy against the 2-bit-slice baseline: ADC bits ~ log2(rows) +
    the widest slice's bits; energy ~ 2^adc_bits / adc_sample (Murmann
    survey trend ~4x per +2 bits at these resolutions)."""
    base_bits = 7 + 2  # 128 rows, 2-bit cells
    bits = 7 + max(spec.bits)
    return 2.0 ** ((bits - base_bits) * 0.5)


def _train_spec(params0, batch, spec: SliceSpec, steps: int, lr: float):
    """``steps`` deterministic-rounding PANTHER steps at ``spec`` (CRS every
    1024): ``(params, state, cfg, µs/step)``."""
    cfg = PantherConfig(spec=spec, crs_every=1024, stochastic_round=False)
    state = panther.init(params0, cfg)

    def step(c):
        p, s = c
        return panther.update(_grad(p, batch), s, p, lr, cfg)

    (p, state), us = _train(step, (panther.materialize(params0, state, cfg), state), steps, batch[0].device)
    return p, state, cfg, us


def spec_sweep(steps: int = 400, lr: float = 0.03, device=None) -> dict:
    """One row per configuration of ``CONFIGS``: ``{loss, mvm_energy_x,
    total_bits, loss_adc6, loss_adc9, us_per_step}``, and the paper's claims
    printed (``paper_claims``)."""
    params0, batch = _task(0, resolve(device))
    results = {}
    for name in CONFIGS:
        spec = _spec(name)
        p, state, cfg, us = _train_spec(params0, batch, spec, steps, lr)
        with torch.no_grad():
            loss = float(_loss(p, batch))
        e = _adc_energy_factor(spec)
        # the trained planes read through the sliced-MVM engine at the priced ADC widths
        adc = {a: fidelity_loss(p, state, cfg, batch, a) for a in (6, 9)}
        results[name] = {"loss": loss, "mvm_energy_x": e, "total_bits": spec.total_bits,
                         "loss_adc6": adc[6], "loss_adc9": adc[9], "us_per_step": us}
        print(f"fig10/{name}: {us:.1f} us/step; loss={loss:.4f};mvm_energy_x={e:.2f};"
              f"total_bits={spec.total_bits};loss_adc6={adc[6]:.4f};loss_adc9={adc[9]:.4f}", flush=True)
    print("fig10/paper_claims: " + ";".join(f"{k}={v}" for k, v in paper_claims(results).items()))
    return results


def paper_claims(results) -> dict:
    """The reference's printed claims: the paper pick's loss, every config
    with a 3-bit slice worse than every config without, and the paper pick
    below uniform-4."""
    paper_pick = results["44466555"]["loss"]
    best_3bit = min(r["loss"] for k, r in results.items() if "3" in k)
    worst_non3 = max(r["loss"] for k, r in results.items() if "3" not in k)
    return {"paper_pick_loss": paper_pick, "3bit_always_worst": best_3bit > worst_non3,
            "hetero_beats_uniform4": paper_pick < results["44444444"]["loss"]}


def io_sweep(steps: int = 400, lr: float = 0.03, device=None) -> dict:
    """Train once at 44466555, then read the planes back at IO 8/12/16
    through a 9-bit ADC, each width priced by ``mvm_packed``: rows
    ``io{8,12,16}: {io_bits, adc_bits, loss, mvm_tile_nj, mvm_tile_ns}``."""
    from repro_torch.isa.energy import DEFAULT_ENERGY, PAPER_BITS

    params0, batch = _task(0, resolve(device))
    x, y = batch
    p, state, cfg, _ = _train_spec(params0, batch, _spec("44466555"), steps, lr)
    results = {}
    for io in (8, 12, 16):
        with torch.no_grad():
            loss = float(torch.mean((_fwd_fidelity(p, state, cfg, x, adc_bits=9, io_bits=io) - y) ** 2))
        e_nj, lat_ns = DEFAULT_ENERGY.mvm_packed(PAPER_BITS, io, 9)
        results[f"io{io}"] = {"io_bits": io, "adc_bits": 9, "loss": loss, "mvm_tile_nj": e_nj, "mvm_tile_ns": lat_ns}
        print(f"fig10/io{io}: loss={loss:.4f};mvm_tile_nj={e_nj:.2f};mvm_tile_ns={lat_ns:.2f}", flush=True)
    return results


# ------------------------ per-layer heterogeneity ----------------------------

# the whole per-layer configuration, as the plan API says it: group 0 gets
# uniform-6 crossbars behind a 9-bit ADC, group 1 the paper's 44466555 behind
# a 6-bit ADC (both read paths finite)
HETERO_SPECS = {"groups/0": "66666666", "groups/1": "44466555"}
HETERO_ADC = {"groups/0": 9, "groups/1": 6}


def _hetero_rules(opt_cfg):
    from repro_torch.models.common import FidelityConfig
    from repro_torch.plan import PlanRule, default_rules

    return default_rules(opt_cfg) + tuple(
        PlanRule(f"{g}/*", spec=_spec(HETERO_SPECS[g]),
                 fidelity=FidelityConfig(adc_bits_fwd=HETERO_ADC[g], adc_bits_bwd=HETERO_ADC[g]))
        for g in sorted(HETERO_SPECS)
    )


def hetero_smoke_config():
    """The demo's model: the smoke gemma-2b, f32, in two groups of 2."""
    from repro_torch.configs import get_smoke

    return dataclasses.replace(get_smoke("gemma_2b"), dtype=torch.float32,
                               pattern=(("dense", 2), ("dense", 2)), n_layers=4)


def hetero_plan(cfg):
    """``(opt_cfg, plan)`` of the demo on ``cfg``, the plan resolved against
    the param shapes; raises unless it holds two distinct slice specs and
    two distinct ADC settings (the demo's contract)."""
    from repro_torch.models import lm
    from repro_torch.plan import plan_by_path, resolve_plan

    opt = PantherConfig(stochastic_round=False, crs_every=1 << 20)
    plan = resolve_plan(lm.param_shapes(cfg), _hetero_rules(opt))
    mapped = [pl for pl in plan_by_path(plan).values() if pl.mapped]
    specs = {pl.spec.name() for pl in mapped}
    adcs = {(pl.fidelity.adc_bits_fwd, pl.fidelity.adc_bits_bwd) for pl in mapped if pl.fidelity is not None}
    if len(specs) < 2 or len(adcs) < 2:
        raise AssertionError(f"hetero plan: specs {specs}, ADC settings {adcs}: two of each expected")
    return opt, plan


def _lm_params(cfg, key: tuple, device) -> dict:
    """The reference's ``lm.init_params(cfg, key)`` draws for a dense-block
    pattern, from its ``jax.random`` keys (``core.prng``: the key tree bit
    for bit, the normal draws within the ulps of ``prng.normal``), so both
    packages start the demo from the same weights."""
    def dense(k, d_in, d_out):
        scale = float(np.float32(1.0) / np.sqrt(np.float32(d_in)))
        return prng.normal(k, (d_in, d_out), device=device) * scale

    def norm(d):
        return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}

    def block(k):
        k_attn, k_mlp = prng.split(k)
        ka, km = prng.split(k_attn, 6), prng.split(k_mlp, 3)
        d, hd = cfg.d_model, cfg.head_dim
        return {"attn": {"wqkv": dense(ka[0], d, (cfg.n_heads + 2 * cfg.n_kv_heads) * hd),
                         "wo": dense(ka[3], cfg.n_heads * hd, d), "ln": norm(d)},
                "mlp": {"wi_gate": dense(km[0], d, cfg.d_ff), "wi_up": dense(km[1], d, cfg.d_ff),
                        "wo": dense(km[2], cfg.d_ff, d), "ln": norm(d)}}

    keys = prng.split(key, len(cfg.pattern) + 3)
    groups = []
    for gi, (name, count) in enumerate(cfg.pattern):
        if name != "dense" or cfg.qk_norm or cfg.post_norm or not cfg.tie_embeddings:
            raise NotImplementedError("the keyed init covers gemma's dense blocks only")
        layers = [block(k) for k in prng.split(keys[2 + gi], count)]
        groups.append(layers[0] if count == 1 else tree.map(lambda *xs: torch.stack(xs), *layers))
    return {"final_ln": norm(cfg.d_model),
            "embed": prng.normal(keys[0], (cfg.vocab, cfg.d_model), device=device) * 0.02, "groups": groups}


def hetero_plan_demo(steps: int = 40, lr: float = 0.3, device=None) -> dict:
    """One model (``hetero_smoke_config()``), two layer groups, two slice
    specs, two ADC resolutions: ``steps`` steps at 8 x 32 tokens from the
    reference's initial weights (``_lm_params``), then the forward loss of
    a held-out batch served through the heterogeneous plan (its prefill's
    logits checked finite) and through the lossless dequantized weights."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import lm
    from repro_torch.optim.schedules import constant
    from repro_torch.plan import plan_by_path, plan_summary
    from repro_torch.serve.step import fidelity_params
    from repro_torch.train.step import TrainState, make_train_step

    dev = resolve(device)
    cfg = hetero_smoke_config()
    opt, plan = hetero_plan(cfg)
    print("hetero plan:\n" + plan_summary(plan))
    mapped = [pl for pl in plan_by_path(plan).values() if pl.mapped]

    ds = SyntheticLMDataset(cfg.vocab, seq_len=32, global_batch=8, seed=3, device=dev)
    digital, sliced = panther.init_split(_lm_params(cfg, prng.PRNGKey(0), dev), opt, plan=plan)
    state = TrainState(step=0, digital=digital, sliced=sliced, rng=prng.PRNGKey(7))
    # every activation kept: the smoke model's steps, timed across PRs since before remat
    step = make_train_step(cfg, opt, constant(lr), plan=plan, remat="none")
    losses = []
    for i in range(steps):
        state, m = step(state, ds.batch(i))
        losses.append(float(m["loss"]))

    # serve through the heterogeneous plan (each group's ADC on the forward
    # read) and, beside it, the lossless dequantized weights: the forward LM
    # loss of a held-out batch, the prefill's logits checked finite
    params = panther.materialize_split(state.digital, state.sliced, opt)
    batch = ds.batch(steps)

    def serve_loss(p):
        with torch.no_grad():
            logits, _ = lm.prefill(cfg, p, batch["inputs"])
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError("hetero plan: prefill logits not finite")
            del logits
            return float(lm.loss_fn(cfg, p, batch))

    serve_hetero = serve_loss(fidelity_params(params, state.sliced, plan))
    serve_lossless = serve_loss(params)
    record = {
        "arch": cfg.arch_id, "steps": steps, "lr": lr, "specs": HETERO_SPECS, "adc": HETERO_ADC,
        "n_distinct_specs": len({pl.spec.name() for pl in mapped}),
        "n_distinct_adc": len({(pl.fidelity.adc_bits_fwd, pl.fidelity.adc_bits_bwd)
                               for pl in mapped if pl.fidelity is not None}),
        "train_losses": losses, "serve_loss_hetero": serve_hetero, "serve_loss_lossless": serve_lossless,
    }
    print(f"fig10/hetero_plan: specs={record['n_distinct_specs']};adcs={record['n_distinct_adc']};"
          f"loss0={losses[0] if losses else float('nan'):.4f};lossN={losses[-1] if losses else float('nan'):.4f};"
          f"serve_hetero={serve_hetero:.4f};serve_lossless={serve_lossless:.4f}", flush=True)
    if not (all(map(math.isfinite, losses)) and math.isfinite(serve_hetero)):
        raise AssertionError(f"hetero plan: losses {losses}, served loss {serve_hetero}")
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    ap.add_argument("--json", default=None, help="write the results here (nothing is written without it)")
    args = ap.parse_args(argv)
    results = {"hetero_plan": hetero_plan_demo(device=args.device),
               "spec_sweep": spec_sweep(device=args.device),
               "io_sweep": io_sweep(device=args.device)}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2, sort_keys=True)
        print(f"fig10/json: wrote={args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
