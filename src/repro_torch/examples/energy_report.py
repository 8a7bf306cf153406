"""Per-leaf energy report from the plan-compile pipeline: resolve a
``CrossbarPlan`` over a transformer's param shapes, lower it to packed
per-leaf tile schedules (``repro_torch.isa.plan_compile``), and print the
joules/step table under PANTHER plus the ratios against the digital and
serial-write baselines. Counterpart of ``examples/energy_report.py`` on the
port: the same table, line for line.

``--plan hetero`` swaps in the fig10 heterogeneous rules (uniform-6/adc9
group + 44466555/adc6 group) so the per-leaf rows show two ADC prices in
one model; ``--tiki`` compiles with the Tiki-Taka rule so the digital
momentum buffer's read-modify-write traffic shows up in the mem column.
Everything is analytic (``lm.param_shapes``: no weights, nothing allocated,
no device):

    PYTHONPATH=src python -m repro_torch.examples.energy_report
    PYTHONPATH=src python -m repro_torch.examples.energy_report --plan hetero --tokens 256
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plan", choices=("default", "hetero"), default="default")
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--tiki", action="store_true", help="compile with the Tiki-Taka momentum rule")
    args = ap.parse_args(argv)

    from repro_torch.benchmarks.fig10_hetero import _hetero_rules, hetero_smoke_config
    from repro_torch.isa import plan_compile as pc
    from repro_torch.models import lm
    from repro_torch.optim import PantherConfig, tiki_taka
    from repro_torch.plan import default_rules, plan_summary, resolve_plan

    opt = PantherConfig(stochastic_round=False)
    if args.tiki:
        opt = tiki_taka(opt)
    shapes = lm.param_shapes(hetero_smoke_config())
    rules = _hetero_rules(opt) if args.plan == "hetero" else default_rules(opt)
    plan = resolve_plan(shapes, rules)
    print(f"plan ({args.plan}):\n{plan_summary(plan)}\n")

    prog = pc.compile_plan(shapes, plan, tokens=args.tokens, opt_cfg=opt)
    rep = pc.report(prog)
    cats = sorted({c for row in rep["per_leaf_nj"].values() for c in row})
    width = max(len(leaf) for leaf in rep["per_leaf_nj"])
    header = f"{'leaf':<{width}} " + " ".join(f"{c:>12}" for c in cats) + f" {'total':>12}"
    print(f"per-leaf nJ/step (tokens={args.tokens}, {prog.meta['n_shards']} shard(s)):")
    print(header)
    print("-" * len(header))
    for leaf, row in sorted(rep["per_leaf_nj"].items()):
        cells = " ".join(f"{row.get(c, 0.0):>12.1f}" for c in cats)
        print(f"{leaf:<{width}} {cells} {sum(row.values()):>12.1f}")
    print("-" * len(header))
    print(f"{'TOTAL':<{width}} {'':>{13 * len(cats)}} {rep['total_nj']:>12.1f}")

    s = pc.systems_summary(prog)
    print(f"\ntime: {rep['time_ns'] / 1e3:.2f} us over {rep['n_instrs']} instrs")
    print(f"energy: {s['panther_nj']:.0f} nJ — {s['vs_digital']:.2f}x below "
          f"digital, {s['vs_serial_write']:.2f}x below serial-write ReRAM")
    print(f"time ratios: {s['time_vs_digital']:.2f}x vs digital, "
          f"{s['time_vs_serial_write']:.2f}x vs serial-write")


if __name__ == "__main__":
    main()
