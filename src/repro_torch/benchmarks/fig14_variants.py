"""Fig 14 reproduction: Variant 2 vs Variant 3 — shared-memory footprint
and energy vs batch size. Paper: V2 wins storage+energy at small batch; V3
wins storage density at very large batch at comparable energy.

Counterpart of ``benchmarks/fig14_variants.py`` on the port: host arithmetic over
``repro_torch.isa``, the reference's CSV rows character for character.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig14_variants
"""
from __future__ import annotations

from repro_torch.isa.compiler import XBAR
from repro_torch.isa.graph import MLP_L4
from repro_torch.isa.simulator import _layer_reps, _layer_tiles, layer_energy

from .common import emit


def shared_mem_bytes(model, batch: int, variant: str) -> float:
    """V2 saves both OPA operand vectors per example until halt; V3 applies
    OPA eagerly on the third crossbar copy (no saved vectors) but triples
    crossbar storage."""
    if variant == "v2":
        return sum(2 * XBAR * 2 * _layer_tiles(ly) * _layer_reps(ly) * batch for ly in model)
    return 0.0


def crossbar_copies(variant: str) -> int:
    return {"v1": 1, "v2": 2, "v3": 3}[variant]


def main():
    model = MLP_L4
    weight_cells = sum(_layer_tiles(ly) * XBAR * XBAR for ly in model)
    for batch in (1, 64, 256, 1024, 4096):
        rows = {}
        for v in ("v2", "v3"):
            e = sum(sum(layer_energy(ly, "panther", batch, variant=v).values()) for ly in model)
            mem = shared_mem_bytes(model, batch, v)
            xbar = crossbar_copies(v) * weight_cells
            # storage density ~ total state bytes (crossbar cells ~5 bits -> 0.6B + shared mem)
            storage = xbar * 0.61 + mem
            rows[v] = (e, mem, storage)
        e2, m2, s2 = rows["v2"]
        e3, m3, s3 = rows["v3"]
        emit(f"fig14/b{batch}", 0.0,
             f"v2_energy_nj={e2:.0f};v3_energy_nj={e3:.0f};v2_sharedmem_kb={m2/1024:.0f};"
             f"v3_sharedmem_kb={m3/1024:.0f};v3_storage_wins={s3 < s2}")


if __name__ == "__main__":
    main()
