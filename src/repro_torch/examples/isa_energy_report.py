"""Compile the paper's MLP-L4 workload to the PANTHER ISA and print the
per-layer energy/latency report against all three baselines — the Fig 11/13
pipeline end to end (graph capture -> partition -> fuse -> schedule ->
cycle/energy simulation). Counterpart of ``examples/isa_energy_report.py``
on the port: host arithmetic, the reference's report line for line.

This is the seed-era *layer-list* pipeline (the public ``compile_model``
entry was removed; this example drives the internal ``_compile_layers``
stage directly); the modern plan-aware report — per-leaf schedules compiled
from a resolved ``CrossbarPlan`` — is ``repro_torch.examples.energy_report``.

    PYTHONPATH=src python -m repro_torch.examples.isa_energy_report
"""
from repro_torch.isa.compiler import _compile_layers
from repro_torch.isa.graph import MLP_L4
from repro_torch.isa.simulator import model_report, simulate


def main():
    # the legacy looped-schedule pipeline, on purpose
    g, placements, prog = _compile_layers(MLP_L4, batch=1, variant="v2")
    n_tiles = sum(m.n_tiles() for m in g.matrices.values())
    print(f"graph: {len(g.nodes)} nodes; {n_tiles} crossbar tiles placed; "
          f"{prog.total_instrs()} instructions on {len(prog.cores)} cores")
    mcu = sum(1 for instrs in prog.cores.values() for i in instrs if i.op.value == "mcu")
    print(f"mcu instructions after fusion: {mcu}")

    r = simulate(prog)
    print(f"\ninstruction-level sim: {r.total_energy_nj:.0f} nJ, {r.time_ns / 1e3:.2f} us")
    print("by category:", {k: round(v, 1) for k, v in r.energy_by_category().items()})

    print(f"\n{'system':>14} {'energy/batch (nJ)':>18} {'time (us)':>10}")
    for sys_name in ("panther", "base_digital", "base_mvm", "base_opa_mvm"):
        rep = model_report(MLP_L4, sys_name, batch=1)
        print(f"{sys_name:>14} {rep['total_nj']:>18.0f} {rep['time_ns'] / 1e3:>10.2f}")
    p = model_report(MLP_L4, "panther", 1)
    d = model_report(MLP_L4, "base_digital", 1)
    m = model_report(MLP_L4, "base_mvm", 1)
    print(f"\nenergy reductions: {d['total_nj'] / p['total_nj']:.2f}x vs digital "
          f"(paper <=8.02x), {m['total_nj'] / p['total_nj']:.2f}x vs ReRAM-mvm "
          f"(paper <=54.21x)")


if __name__ == "__main__":
    main()
