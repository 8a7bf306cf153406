"""End to end on the port (counterpart of ``examples/train_lm.py``): train a
~100M-parameter LM with the PANTHER optimizer on synthetic bigram data, with
checkpoint and restart.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 [--device cpu]

The config is a gemma-style dense decoder (12L x 768, vocab 8192, ~100M
params). The loss should fall from ~ln(8192) = 9.0 toward the bigram
structure's entropy floor. Kill it and relaunch with the same
``--ckpt-dir`` to test the restart: it resumes at the step after the
newest checkpoint's.

``--plan default`` resolves and prints the behaviour-preserving plan;
``--plan hetero`` splits the 12 layers into two groups, gives group 0
uniform-6 slices read through a 9-bit ADC and group 1 the paper's spec at 6
bits (two slice specs and two ADC resolutions in one model);
``--plan moe-hetero`` swaps in a granite-style MoE variant (12 MoE layers,
16 experts top-4, expert d_ff 512), maps the expert banks as grouped
crossbar tiles (``coverage_rules``: ``group="expert"``) and reads the first
4 experts of every bank through a 9-bit ADC and the other 12 through a
6-bit one (``expert_groups``: Fig 10's heterogeneity within one leaf). The
plan rides every checkpoint manifest, so a restore under another layout
fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch


def config_100m():
    from repro_torch.configs import gemma_2b

    return dataclasses.replace(
        gemma_2b.CONFIG,
        arch_id="gemma-100m",
        d_model=768,
        n_layers=12,
        vocab=8192,
        n_heads=12,
        n_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        pattern=(("dense", 12),),
    )


def build_plan(cfg, opt_cfg, which: str, fidelity: bool):
    """``(cfg, plan)`` for ``--plan which``: the config the plan runs (the
    hetero plan's in two groups, f32) and the resolved plan."""
    from repro_torch.core.slicing import SliceSpec
    from repro_torch.models import lm
    from repro_torch.models.common import FidelityConfig
    from repro_torch.plan import PlanRule, default_rules, resolve_plan

    if fidelity and which in ("hetero", "moe-hetero"):
        raise SystemExit(f"--plan {which} attaches per-leaf fidelity itself; drop --fidelity")
    if which == "moe-hetero":
        from repro_torch.models.common import MoECfg
        from repro_torch.plan import coverage_rules

        cfg = dataclasses.replace(cfg, arch_id="gemma-moe-100m", dtype=torch.float32, pattern=(("moe", 12),),
                                  d_ff=512, moe=MoECfg(n_experts=16, top_k=4, d_ff_expert=512))
        rules = coverage_rules(opt_cfg) + (
            PlanRule("*/experts_*", expert_groups=(
                (4, FidelityConfig(adc_bits_fwd=9, adc_bits_bwd=9)),
                (12, FidelityConfig(adc_bits_fwd=6, adc_bits_bwd=6)),
            )),
        )
    elif which == "hetero":
        # two groups, so that rules can give each its own crossbar configuration
        cfg = dataclasses.replace(cfg, dtype=torch.float32, pattern=(("dense", 6), ("dense", 6)))
        rules = default_rules(opt_cfg) + (
            PlanRule("groups/0/*", spec=SliceSpec.uniform(6),
                     fidelity=FidelityConfig(adc_bits_fwd=9, adc_bits_bwd=9)),
            PlanRule("groups/1/*", fidelity=FidelityConfig(adc_bits_fwd=6, adc_bits_bwd=6)),
        )
    else:
        rules = default_rules(opt_cfg, fidelity=cfg.fidelity)
        cfg = dataclasses.replace(cfg, fidelity=None)  # rides the plan now
    return cfg, resolve_plan(lm.param_shapes(cfg), rules)


def expert_segments(plan) -> list:
    """One line a leaf whose fidelity splits its expert axis: the path and
    each segment's experts and ADC (fwd, bwd)."""
    from repro_torch.plan import plan_by_path

    lines = []
    for path, pl in plan_by_path(plan).items():
        fid = pl.fidelity
        if fid is None or fid.expert_groups is None:
            continue
        segs = []
        start = 0
        for n, g in fid.expert_groups:
            g = g if g is not None else fid
            segs.append(f"experts {start}-{start + n - 1} adc(fwd,bwd)=({g.adc_bits_fwd}, {g.adc_bits_bwd})")
            start += n
        lines.append(f"  {path}: " + "; ".join(segs))
    return lines


def main(argv=None) -> float:
    """Run the example; returns the last step's loss."""
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager, save_checkpoint
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.device import resolve
    from repro_torch.optim import PantherConfig
    from repro_torch.optim.schedules import wsd
    from repro_torch.plan import plan_summary
    from repro_torch.train.step import make_train_step, train_state_init

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "panther_100m_ckpt"))
    ap.add_argument("--fidelity", default=None,
                    help="crossbar-in-the-loop preset (ideal|adc9|adc6|adc6_bwd|adc6_fwd): the forward MVM and "
                         "the backward MᵀVM read the live planes at finite ADC resolution")
    ap.add_argument("--plan", default=None, choices=["default", "hetero", "moe-hetero"],
                    help="per-leaf mapping plan: 'default' resolves and prints the behaviour-preserving plan; "
                         "'hetero' two slice specs and two ADC resolutions in one model; 'moe-hetero' a MoE "
                         "variant whose expert banks read at 9 bits (4 experts) and 6 bits (12)")
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    cfg = config_100m()
    if args.fidelity:
        cfg = dataclasses.replace(cfg, dtype=torch.float32, fidelity=configs.fidelity_presets()[args.fidelity])
        print(f"fidelity mode: {cfg.fidelity}")
    opt_cfg = PantherConfig(stochastic_round=True, crs_every=1024)

    plan = None
    if args.plan:
        cfg, plan = build_plan(cfg, opt_cfg, args.plan, bool(args.fidelity))
        print(f"--plan {args.plan} resolved:\n{plan_summary(plan)}")
        for line in expert_segments(plan):
            print(line)
    n_params = cfg.vocab * cfg.d_model + cfg.n_layers * (
        2 * cfg.d_model * cfg.n_heads * cfg.head_dim + 2 * cfg.d_model * cfg.n_kv_heads * cfg.head_dim
        + 3 * cfg.d_model * cfg.d_ff)
    print(f"params ~{n_params / 1e6:.0f}M; PANTHER spec {opt_cfg.spec.name()}, CRS every {opt_cfg.crs_every}")

    sched = wsd(args.lr, warmup=20, stable=int(args.steps * 0.6), decay=max(args.steps // 5, 1))
    ds = SyntheticLMDataset(cfg.vocab, args.seq, args.batch, seed=3, device=device)
    step_fn = make_train_step(cfg, opt_cfg, sched, plan=plan)
    state = train_state_init(cfg, opt_cfg, 0, plan=plan, device=device)

    # the plan persists in every manifest: a restore under another slicing
    # layout fails instead of misreading the planes
    ckpt = CheckpointManager(args.ckpt_dir, every=100, plan=plan)
    restored, rstep = ckpt.restore(state)
    start = 0
    if restored is not None:
        state, start = restored, rstep + 1
        print(f"resumed from step {rstep}")

    loss = float("nan")
    t0 = time.time()
    for step in range(start, args.steps):
        state, m = step_fn(state, ds.batch(step))
        if step % 10 == 0 or step == args.steps - 1:
            loss = float(m["loss"])
            print(f"step {step:4d} loss {loss:.4f} lr {m['lr']:.3f} ({time.time() - t0:.0f}s)", flush=True)
        ckpt.maybe_save(step, state)
    save_checkpoint(args.ckpt_dir, args.steps - 1, state, plan=plan)
    print("final loss:", loss)
    return loss


if __name__ == "__main__":
    main()
