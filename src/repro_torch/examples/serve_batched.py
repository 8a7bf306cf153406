"""Two-SLA-tier serving demo over one set of sliced crossbar planes (port of
``examples/serve_batched.py``).

Builds a small LM, splits its weights into the PANTHER digital/sliced
representation, then derives TWO servable param trees from the SAME sliced
planes with ``serve.fidelity_params``:

  * premium: 9-bit ADC reads (higher fidelity, slower samples)
  * bulk: 6-bit ADC reads (cheaper, ~2.8x faster samples)

A seeded Poisson trace tagged with tier names is replayed through one
continuous-batching engine per tier on a shared virtual clock (the ADC
resolution prices each tier's readout latency), and the per-tier
latency/fidelity table is printed.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs, plan
from repro_torch.device import resolve
from repro_torch.launch.serve import adc_latency_factor
from repro_torch.models import lm
from repro_torch.optim import PantherConfig, panther
from repro_torch.serve import Engine, fidelity_params, run_trace, summarize, synth_trace


def main(argv=None) -> dict:
    """Returns ``{"result": run_trace result, "losses": {tier: loss},
    "lossless": loss}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    cfg = configs.get_smoke(args.arch)
    params0 = lm.init_params(cfg, args.seed, device=device)
    digital, sliced = panther.init_split(params0, PantherConfig())
    params = panther.materialize_split(digital, sliced, PantherConfig())

    presets = configs.fidelity_presets()
    tier_defs = {"premium": "adc9", "bulk": "adc6"}
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 32), generator=gen, device=device) for k in ("inputs", "labels")}
    with torch.no_grad():
        lossless = float(lm.loss_fn(cfg, params, batch))

    costs: dict = {}  # shared per-shape cost table: tiers differ only by scale
    engines, trees = {}, {}
    for tier, adc in tier_defs.items():
        # both trees read the SAME sliced planes: only the ADC differs
        tier_plan = plan.resolve_plan(params, plan.default_rules(PantherConfig(), fidelity=presets[adc]))
        trees[tier] = fidelity_params(params, sliced, plan=tier_plan)
        engines[tier] = Engine(cfg, trees[tier], n_slots=4, max_seq=48, page=16, costs=costs,
                               cost_scale=adc_latency_factor(presets[adc].adc_bits_fwd), device=device)

    trace = synth_trace(seed=args.seed, n_requests=args.requests, rate=1e4, prompt_lens=(8, 16), vocab=cfg.vocab,
                        out_choices=((4, 0.7), (24, 0.3)), tiers=(("premium", 0.3), ("bulk", 0.7)))
    print(f"replaying {len(trace)} requests over tiers {sorted(engines)} ...")
    result = run_trace(engines, trace, policy="continuous")

    hdr = (f"{'tier':<8} {'adc':>4} {'reqs':>5} {'tok/s':>8} "
           f"{'p50 ms/tok':>11} {'ttft p50 ms':>12} {'loss':>8} {'d-loss':>8}")
    print(hdr)
    print("-" * len(hdr))
    losses = {}
    for tier, adc in tier_defs.items():
        sub = summarize({"requests": [r for r in result["requests"] if r.tier == tier]})
        with torch.no_grad():
            losses[tier] = loss = float(lm.loss_fn(cfg, trees[tier], batch))
        print(f"{tier:<8} {presets[adc].adc_bits_fwd:>3}b {sub['requests']:>5} "
              f"{sub.get('tokens_per_sec', 0.0):>8.0f} {sub.get('per_token_p50_ms', 0.0):>11.2f} "
              f"{sub.get('ttft_p50_ms', 0.0):>12.2f} {loss:>8.4f} {loss - lossless:>+8.4f}")
    print(f"{'lossless':<8} {'--':>4} {'--':>5} {'--':>8} {'--':>11} {'--':>12} "
          f"{lossless:>8.4f} {0.0:>+8.4f}")
    return {"result": result, "losses": losses, "lossless": lossless}


if __name__ == "__main__":
    main()
