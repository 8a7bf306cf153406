"""Fig 13 reproduction: execution time vs batch size (V2 pipeline model).
Paper: consistently faster than Base_digital (up to 7.16x); faster than
Base_mvm at all batch sizes, with MLP/small-batch suffering hugely on
Base_mvm (un-amortized serial writes).

Counterpart of ``benchmarks/fig13_time.py`` on the port: host arithmetic over
``repro_torch.isa``, the reference's CSV rows character for character.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig13_time
"""
from __future__ import annotations

from repro_torch.isa.graph import MLP_L4, VGG16
from repro_torch.isa.simulator import model_report

from .common import emit


def main():
    for model, mname in ((MLP_L4, "mlp"), (VGG16, "vgg16")):
        for batch in (1, 16, 64, 256, 1024):
            t = {s: model_report(model, s, batch)["time_ns"]
                 for s in ("panther", "base_digital", "base_mvm", "base_opa_mvm")}
            emit(
                f"fig13/{mname}/b{batch}",
                t["panther"] / 1e3,
                f"vs_digital={t['base_digital'] / t['panther']:.2f}x;"
                f"vs_mvm={t['base_mvm'] / t['panther']:.2f}x;"
                f"vs_opa_mvm={t['base_opa_mvm'] / t['panther']:.2f}x",
            )


if __name__ == "__main__":
    main()
