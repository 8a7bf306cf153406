"""Serving launcher (port of ``repro.launch.serve``): the fixed-batch decode,
or the serving-engine bench.

Default: prefill one fixed batch of equal-length prompts, then decode N
tokens in a Python loop, the baseline the continuous-batching engine is
measured against.

``--trace``: replay a seeded open-loop Poisson trace (mixed prompt and
output lengths) through ``serve.engine``/``serve.scheduler`` under the
static barrier policy and continuous batching, on one cost table, and
report p50/p99 per-token latency, TTFT and tokens/s. A second, tier-tagged
trace serves two ``fidelity_params`` trees built over the SAME sliced
planes (premium/adc9 and bulk/adc6) and reports the per-tier
fidelity/throughput frontier: the tier's ADC resolution prices its readout
latency (~2x sample cost per +2 bits, the trend ``benchmarks.fig10_hetero``
prices energy with). The results are written as JSON only to ``--out
PATH``; without it nothing is written.

``--isa-clock`` prices the virtual clock in compiled crossbar cycles
(``serve.scheduler.IsaClock.from_plan``) instead of host calibration: the
headline clock from the lossless plan at ``N_SLOTS``, each tier's from its
own plan at ``TIER_SLOTS`` (its ADC factor composing through
``cost_scale``), and the record gains a ``crossbar_clock`` section. Nothing
is calibrated then, so every tokens/s of the record is the reference's
exactly, on any device and for any weights; only the tiers' losses depend
on the weights.

Runs on the card (``--device cuda``, the default; without one it raises) or
on the CPU with the plain versions (``--device cpu``). Random weights from
seed 0 (torch's generator: the reference's draws come from
``jax.random``).

``python -m repro_torch.launch.serve --smoke --device cpu --tokens 8``
``python -m repro_torch.launch.serve --trace --smoke --device cpu --out serve.json``
``python -m repro_torch.launch.serve --trace --isa-clock --device cpu --out serve.json``
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch


def adc_latency_factor(bits: int, base_bits: int = 9) -> float:
    """Relative ADC sample latency at ``bits`` resolution vs ``base_bits``
    (~2x per +2 bits). A 6-bit bulk tier reads ~2.8x faster than the 9-bit
    premium."""
    return 2.0 ** ((bits - base_bits) * 0.5)


def _tier_summaries(result, sch):
    out = {}
    for tier in sorted({r.tier for r in result["requests"]}):
        sub = {"requests": [r for r in result["requests"] if r.tier == tier]}
        out[tier] = sch.summarize(sub)
    return out


# the bench's traffic: the reference's own parameters
PROMPT_LENS = (8, 16, 32)
OUT_CHOICES = ((4, 0.75), (120, 0.25))  # bimodal: chat turns + long generations
N_SLOTS, PAGE, CHUNK, MAX_SEQ = 8, 16, 16, 160
TIER_DEFS = {"premium": "adc9", "bulk": "adc6"}
TIER_SLOTS, TIER_MAX_SEQ, TIER_PAGE = 4, 48, 16


def bench_config(arch: str, smoke: bool = False):
    """The trace bench's model: the smoke config, or (the default) the
    reference's CPU-sized one (d_model 256, 4 layers, vocab 512), which
    isolates the scheduling policy and the tier frontier."""
    from repro_torch import configs

    cfg = configs.get_smoke(arch)
    if smoke:
        return cfg
    return dataclasses.replace(cfg, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32, d_ff=512, vocab=512,
                               pattern=(("dense", 4),))


def bench_trace(cfg, n_requests: int, seed: int, rate: float):
    from repro_torch.serve import trace as tracelib

    return tracelib.synth_trace(seed=seed, n_requests=n_requests, rate=rate, prompt_lens=PROMPT_LENS,
                                vocab=cfg.vocab, out_choices=OUT_CHOICES)


def tier_trace(cfg, n_requests: int, seed: int, rate: float):
    from repro_torch.serve import trace as tracelib

    return tracelib.synth_trace(seed=seed + 1, n_requests=max(6, n_requests // 4), rate=rate,
                                prompt_lens=(8, 16), vocab=cfg.vocab, out_choices=((4, 0.7), (24, 0.3)),
                                tiers=(("premium", 0.3), ("bulk", 0.7)))


def run_policies(cfg, params, trace, device, costs=None, policies=("continuous", "static")):
    """Each policy on a fresh engine over ``params``, all on one cost table
    (``costs``, calibrated by the first engine that meets a key). Returns
    ``{policy: run_trace result}`` and the cost table."""
    from repro_torch.serve import scheduler as sch
    from repro_torch.serve.engine import Engine

    costs = {} if costs is None else costs
    results = {}
    for policy in policies:
        eng = Engine(cfg, params, n_slots=N_SLOTS, max_seq=MAX_SEQ, page=PAGE, chunk_size=CHUNK, costs=costs,
                     device=device)
        t0 = time.time()
        results[policy] = sch.run_trace({"default": eng}, trace, policy=policy)
        s = sch.summarize(results[policy])
        print(f"{policy}: {s['tokens_per_sec']:.0f} tok/s (ttft p50 {s['ttft_p50_ms']:.1f}ms, "
              f"wall {time.time() - t0:.0f}s)", flush=True)
    return results, costs


def tier_engines(cfg, params, sliced, opt_cfg, device, isa_clock: bool = False):
    """The two SLA tiers' param trees over the same sliced planes and their
    engines (4 slots, ``max_seq`` 48), each tier's cost scaled by its ADC
    resolution. Each engine calibrates its own keys, or with ``isa_clock``
    runs on its own ``IsaClock`` from its tier plan at ``TIER_SLOTS``."""
    from repro_torch import configs
    from repro_torch import plan as planlib
    from repro_torch.serve import scheduler as sch
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.step import fidelity_params

    presets = configs.fidelity_presets()
    engines, trees = {}, {}
    for tier, adc in TIER_DEFS.items():
        tier_plan = planlib.resolve_plan(params, planlib.default_rules(opt_cfg, fidelity=presets[adc]))
        trees[tier] = fidelity_params(params, sliced, plan=tier_plan)
        costs = sch.IsaClock.from_plan(params, tier_plan, n_slots=TIER_SLOTS) if isa_clock else None
        engines[tier] = Engine(cfg, trees[tier], n_slots=TIER_SLOTS, max_seq=TIER_MAX_SEQ, page=TIER_PAGE,
                               costs=costs, cost_scale=adc_latency_factor(presets[adc].adc_bits_fwd),
                               device=device)
    return engines, trees


def _weights(cfg, device):
    """Random weights from seed 0, served from the sliced crossbar state
    (the same cells training writes). Returns (params, sliced, opt_cfg)."""
    from repro_torch.models import lm
    from repro_torch.optim import PantherConfig, panther

    opt_cfg = PantherConfig()
    params0 = lm.init_params(cfg, 0, device=device)
    digital, sliced = panther.init_split(params0, opt_cfg)
    return panther.materialize_split(digital, sliced, opt_cfg), sliced, opt_cfg


def run_trace_bench(args, device):
    from repro_torch import configs
    from repro_torch import plan as planlib
    from repro_torch.models import lm
    from repro_torch.serve import scheduler as sch

    cfg = bench_config(args.arch, args.smoke)
    params, sliced, opt_cfg = _weights(cfg, device)
    n_requests = args.requests or (24 if args.smoke else 32)
    trace = bench_trace(cfg, n_requests, args.seed, args.rate)

    # headline: static barrier vs continuous batching, lossless params, on
    # one shared cost table: calibrated, or the crossbar clock of the
    # lossless plan
    costs = None
    if args.isa_clock:
        serve_plan = planlib.resolve_plan(params, planlib.default_rules(opt_cfg))
        costs = sch.IsaClock.from_plan(params, serve_plan, n_slots=N_SLOTS)
    runs, _ = run_policies(cfg, params, trace, device, costs)
    results = {p: sch.summarize(r) for p, r in runs.items()}
    speedup = results["continuous"]["tokens_per_sec"] / results["static"]["tokens_per_sec"]
    print(f"continuous/static speedup: {speedup:.2f}x")

    # SLA tiers: two fidelity trees over the SAME sliced planes
    ttrace = tier_trace(cfg, n_requests, args.seed, args.rate)
    gen = torch.Generator(device=device).manual_seed(7)
    batch = {k: torch.randint(0, cfg.vocab, (2, 32), generator=gen, device=device) for k in ("inputs", "labels")}
    with torch.no_grad():
        lossless_loss = float(lm.loss_fn(cfg, params, batch))
    engines, trees = tier_engines(cfg, params, sliced, opt_cfg, device, isa_clock=args.isa_clock)
    t0 = time.time()
    tier_res = sch.run_trace(engines, ttrace, policy="continuous")
    print(f"tier trace wall {time.time() - t0:.0f}s")
    tier_sums = _tier_summaries(tier_res, sch)
    presets = configs.fidelity_presets()
    tiers = {}
    for tier, adc in TIER_DEFS.items():
        with torch.no_grad():
            loss = float(lm.loss_fn(cfg, trees[tier], batch))
        tiers[tier] = {"adc": adc, "adc_bits": presets[adc].adc_bits_fwd, "loss": loss,
                       "loss_delta_vs_lossless": loss - lossless_loss,
                       **tier_sums.get(tier, {"requests": 0})}
        print(f"tier {tier} ({adc}): loss {loss:.4f} (+{loss - lossless_loss:.4f}), "
              f"{tiers[tier].get('tokens_per_sec', 0):.0f} tok/s")

    backend = device.type if device.type != "cuda" else f"cuda ({torch.cuda.get_device_name(device)})"
    out = {
        "_meta": {
            "smoke": bool(args.smoke), "arch": args.arch, "backend": backend, "seed": args.seed,
            "n_requests": n_requests, "rate": args.rate, "n_slots": N_SLOTS, "page": PAGE, "chunk": CHUNK,
            "max_seq": MAX_SEQ, "isa_clock": bool(args.isa_clock),
            "note": ("virtual clock priced in compiled crossbar cycles (repro.isa.plan_compile); tier latency "
                     "scaled by ADC resolution") if args.isa_clock else
                    "virtual clock from per-shape calibrated device costs; tier latency priced by ADC resolution",
        },
        "static": results["static"],
        "continuous": results["continuous"],
        "speedup": speedup,
        "lossless_loss": lossless_loss,
        "tiers": tiers,
    }
    if args.isa_clock:
        # the headline summaries above already ran on the crossbar clock;
        # this section restates them by name, as the reference's record does
        out["crossbar_clock"] = {
            "static_tokens_per_sec": results["static"]["tokens_per_sec"],
            "continuous_tokens_per_sec": results["continuous"]["tokens_per_sec"],
            "speedup": speedup,
            "note": "tokens/sec priced in compiled crossbar cycles (repro.isa.plan_compile schedules), not host "
                    "wall time",
        }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
        print(f"wrote {args.out}")
    return out


def run_legacy(args, device):
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve import kv_pages
    from repro_torch.serve.step import make_decode_step, make_prefill

    from repro_torch.data import FrameStub

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    params, _, _ = _weights(cfg, device)
    max_seq = args.prompt_len + args.tokens
    gen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen, device=device)
    # a model on frame embeddings reads its prompt and each decoded codebook
    # token through the stand-in frontend
    frames = FrameStub(cfg.vocab, cfg.d_model, device=device) if cfg.input_mode != "tokens" else None
    if frames is not None:
        prompts = frames(prompts)

    t0 = time.time()
    logits, caches = make_prefill(cfg)(params, prompts)
    caches = kv_pages.grow_caches(cfg, lm.unstack_caches(cfg, caches), max_seq)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    print(f"prefill [{args.batch}x{args.prompt_len}] in {time.time() - t0:.2f}s")

    decode = make_decode_step(cfg)
    out = [tok]
    t0 = time.time()
    for i in range(args.tokens - 1):
        inp = tok.long() if frames is None else frames(tok.long())[:, None]
        tok, logits, caches = decode(params, inp, caches, args.prompt_len + i)
        out.append(tok)
    toks = torch.stack(out, dim=1).cpu()
    dt = time.time() - t0
    print(f"decoded {args.tokens - 1} steps x {args.batch} seqs in {dt:.2f}s "
          f"({(args.tokens - 1) * args.batch / max(dt, 1e-9):.1f} tok/s)")
    print("sample:", toks[0][:16].tolist())
    return toks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--trace", action="store_true", help="run the continuous-batching trace bench")
    ap.add_argument("--isa-clock", action="store_true",
                    help="price the virtual clock in compiled crossbar cycles (isa.plan_compile) instead of host "
                    "calibration")
    ap.add_argument("--requests", type=int, default=0, help="trace length (0 = mode default)")
    ap.add_argument("--rate", type=float, default=1e4, help="open-loop Poisson arrival rate (requests/sec)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the trace bench's JSON here (nothing is written without it)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve

    device = resolve(args.device)
    if args.trace:
        return run_trace_bench(args, device)
    return run_legacy(args, device)


if __name__ == "__main__":
    main()
