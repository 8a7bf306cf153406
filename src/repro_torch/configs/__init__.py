"""Architecture registry (port of ``repro.configs``): ``get(arch_id)`` for the
full config, ``get_smoke(arch_id)`` for the reduced same-family one, the
shape cells, and the finite-ADC presets. All ten of the reference's
architectures are ported, in its order: the dense-block ones (gemma-2b,
minicpm-2b, phi4-mini-3.8b, chameleon-34b, musicgen-large), gemma2-9b's
local/global pairs, the MoE one (granite-moe-1b-a400m), deepseek-v2-lite-16b
(MLA and MoE with shared experts) and the SSM ones (xlstm-125m,
zamba2-1.2b). ``UNPORTED`` is empty."""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = [
    "zamba2_1p2b",
    "musicgen_large",
    "deepseek_v2_lite_16b",
    "granite_moe_1b_a400m",
    "xlstm_125m",
    "minicpm_2b",
    "gemma2_9b",
    "gemma_2b",
    "phi4_mini_3p8b",
    "chameleon_34b",
]

# the reference's architectures whose blocks are not ported (none)
UNPORTED: list = []

# canonical hyphenated names -> module ids
ALIASES = {
    "musicgen-large": "musicgen_large",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "minicpm-2b": "minicpm_2b",
    "gemma-2b": "gemma_2b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "chameleon-34b": "chameleon_34b",
    "zamba2-1.2b": "zamba2_1p2b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "xlstm-125m": "xlstm_125m",
    "gemma2-9b": "gemma2_9b",
}

SHAPES = {
    "train_4k": {"kind": "train", "seq_len": 4096, "global_batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32768, "global_batch": 32},
    "decode_32k": {"kind": "decode", "seq_len": 32768, "global_batch": 128},
    "long_500k": {"kind": "decode", "seq_len": 524288, "global_batch": 1},
}


def _module(arch_id: str):
    arch_id = ALIASES.get(arch_id, arch_id)
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r} (known: {ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get(arch_id: str):
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str):
    return _module(arch_id).SMOKE


def shape_cells(arch_id: str):
    """The shape cells this arch participates in."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if get(arch_id).supports_long_context:
        cells.append("long_500k")
    return cells


def fidelity_presets():
    """Name -> FidelityConfig map of the finite-ADC presets."""
    from repro_torch.models.common import FidelityConfig

    return {
        "ideal": FidelityConfig(adc_bits_fwd=None, adc_bits_bwd=None),
        "adc9": FidelityConfig(adc_bits_fwd=9, adc_bits_bwd=9),
        "adc6": FidelityConfig(adc_bits_fwd=6, adc_bits_bwd=6),
        "adc6_bwd": FidelityConfig(adc_bits_fwd=None, adc_bits_bwd=6),
        "adc6_fwd": FidelityConfig(adc_bits_fwd=6, adc_bits_bwd=None),
    }


def with_fidelity(cfg, preset):
    """``cfg`` with a fidelity preset (a name or a FidelityConfig) attached."""
    fid = fidelity_presets()[preset] if isinstance(preset, str) else preset
    return dataclasses.replace(cfg, fidelity=fid)
