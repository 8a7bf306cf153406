"""Fig 1 table: CMOS vs ReRAM primitive energy/latency ratios as modeled.

Counterpart of ``benchmarks/fig1_primitives.py`` on the port: host arithmetic over
``repro_torch.isa``, the reference's CSV rows character for character.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig1_primitives
"""
from __future__ import annotations

from repro_torch.isa.energy import DEFAULT_ENERGY as E

from .common import emit


def main():
    emit("fig1/mvm_energy_ratio", 0.0,
         f"cmos/reram={E.e_mvm_cmos / E.e_mvm_reram:.1f}x(paper:10.4x)")
    emit("fig1/mvm_latency_ratio", 0.0,
         f"cmos/reram={E.l_mvm_cmos / E.l_mvm_reram:.1f}x(paper:8.9x)")
    emit("fig1/write_vs_read", 0.0,
         f"reram_write/read_energy={E.e_write_reram / E.e_read_reram:.1f}x;"
         f"write/compute={E.e_write_reram / E.e_mvm_reram:.0f}x")
    emit("fig1/opa", 0.0,
         f"reram_opa_nj={E.e_opa_reram};cmos_opa_nj={E.e_opa_cmos};reram_mvm_nj={E.e_mvm_reram}")


if __name__ == "__main__":
    main()
