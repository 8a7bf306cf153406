"""Fig 15 reproduction: PANTHER (V2) vs RTX 2080-Ti — speedup and energy
efficiency for SGD (b=1) and mini-batch (b=64, b=1k). Paper: large wins at
small batch (GPUs can't amortize; worst case 2358x energy / 119x time for
SGD-MLP), shrinking with batch (headline 103x energy / 16x time).

Counterpart of ``benchmarks/fig15_gpu.py`` on the port: host arithmetic over
``repro_torch.isa``, the reference's CSV rows character for character.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig15_gpu
"""
from __future__ import annotations

from repro_torch.isa.energy import DEFAULT_GPU
from repro_torch.isa.graph import FCLayer, MLP_L4, VGG16
from repro_torch.isa.simulator import model_report

from .common import emit


def _model_flops_bytes(model, batch):
    flops = sum(ly.flops_fwd() * 3 for ly in model) * batch  # fwd+bwd+wgrad
    bytes_moved = sum(ly.weight_bytes() * 3 for ly in model) + batch * 4 * sum(
        (ly.d_out if isinstance(ly, FCLayer) else ly.M * ly.E * ly.E) for ly in model
    )
    return flops, bytes_moved


def main():
    for model, mname in ((MLP_L4, "mlp"), (VGG16, "vgg16")):
        for batch in (1, 64, 1024):
            rep = model_report(model, "panther", batch)
            t_p = rep["time_ns"] * 1e-9
            e_p = rep["total_nj"] * 1e-9
            flops, byts = _model_flops_bytes(model, batch)
            t_g, e_g = DEFAULT_GPU.step_time_energy(flops, byts, batch)
            emit(f"fig15/{mname}/b{batch}", t_p * 1e6,
                 f"speedup={t_g / t_p:.1f}x;energy_eff={e_g / e_p:.1f}x")


if __name__ == "__main__":
    main()
