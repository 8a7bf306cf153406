"""Fig 11 reproduction: layer-wise SGD (batch=1) energy vs the three
baselines, on MLP-L4 and VGG16 (Table 4). Paper headline targets:
Base_digital 7.01-8.02x; Base_mvm 31.03-54.21x (FC), 1.47-31.56x (conv).

Counterpart of ``benchmarks/fig11_sgd_energy.py`` on the port: host arithmetic over
``repro_torch.isa``, the reference's CSV rows character for character.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig11_sgd_energy
"""
from __future__ import annotations

from repro_torch.isa.graph import MLP_L4, VGG16
from repro_torch.isa.simulator import layer_energy

from .common import emit


def main():
    for model, mname in ((MLP_L4, "mlp"), (VGG16, "vgg16")):
        fc_r, conv_r, dig_r = [], [], []
        for ly in model:
            e = {s: sum(layer_energy(ly, s, batch=1).values())
                 for s in ("panther", "base_digital", "base_mvm", "base_opa_mvm")}
            r_mvm = e["base_mvm"] / e["panther"]
            r_dig = e["base_digital"] / e["panther"]
            r_opa = e["base_opa_mvm"] / e["panther"]
            (fc_r if ly.name.startswith("Dense") else conv_r).append(r_mvm)
            dig_r.append(r_dig)
            emit(f"fig11/{mname}/{ly.name}", 0.0,
                 f"vs_digital={r_dig:.2f}x;vs_mvm={r_mvm:.2f}x;vs_opa_mvm={r_opa:.2f}x")
        if fc_r:
            emit(f"fig11/{mname}/summary_fc", 0.0,
                 f"vs_mvm_range={min(fc_r):.1f}-{max(fc_r):.1f}x(paper:31.03-54.21x)")
        if conv_r:
            emit(f"fig11/{mname}/summary_conv", 0.0,
                 f"vs_mvm_range={min(conv_r):.2f}-{max(conv_r):.2f}x(paper:1.47-31.56x)")
        emit(f"fig11/{mname}/summary_digital", 0.0,
             f"range={min(dig_r):.2f}-{max(dig_r):.2f}x(paper:7.01-8.02x)")


if __name__ == "__main__":
    main()
