"""Fig 12 reproduction: mini-batch SGD (batch=64) energy vs baselines.
Paper targets: FC 1.61-2.16x vs Base_mvm/Base_opa-mvm; conv 1.18-1.63x
(Base_mvm) and 1.22-2.45x (Base_opa-mvm); batch-1024 ~1.18x (§7.4).

Counterpart of ``benchmarks/fig12_minibatch_energy.py`` on the port: host arithmetic over
``repro_torch.isa``, the reference's CSV rows character for character.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig12_minibatch_energy
"""
from __future__ import annotations

from repro_torch.isa.graph import MLP_L4, VGG16
from repro_torch.isa.simulator import layer_energy

from .common import emit


def main():
    for model, mname in ((MLP_L4, "mlp"), (VGG16, "vgg16")):
        fc_r, conv_m, conv_o = [], [], []
        for ly in model:
            e = {s: sum(layer_energy(ly, s, batch=64).values())
                 for s in ("panther", "base_digital", "base_mvm", "base_opa_mvm")}
            r_mvm = e["base_mvm"] / e["panther"]
            r_opa = e["base_opa_mvm"] / e["panther"]
            if ly.name.startswith("Dense"):
                fc_r.append(r_mvm)
            else:
                conv_m.append(r_mvm)
                conv_o.append(r_opa)
            emit(f"fig12/{mname}/{ly.name}", 0.0, f"vs_mvm={r_mvm:.2f}x;vs_opa_mvm={r_opa:.2f}x")
        if fc_r:
            emit(f"fig12/{mname}/summary_fc", 0.0,
                 f"vs_mvm={min(fc_r):.2f}-{max(fc_r):.2f}x(paper:1.61-2.16x)")
        if conv_m:
            emit(f"fig12/{mname}/summary_conv", 0.0,
                 f"vs_mvm={min(conv_m):.2f}-{max(conv_m):.2f}x(paper:1.18-1.63x);"
                 f"vs_opa_mvm={min(conv_o):.2f}-{max(conv_o):.2f}x(paper:1.22-2.45x)")
    # very large batch (§7.4): writes fully amortized -> ~1.18x
    from repro_torch.isa.graph import MLP_L4 as M
    e_p = sum(sum(layer_energy(ly, "panther", 1024).values()) for ly in M)
    e_m = sum(sum(layer_energy(ly, "base_mvm", 1024).values()) for ly in M)
    emit("fig12/batch1024", 0.0, f"vs_mvm={e_m / e_p:.2f}x(paper:~1.18x)")


if __name__ == "__main__":
    main()
