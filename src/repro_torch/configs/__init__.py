"""Architecture registry (port of ``repro.configs``): ``get(arch_id)`` for the
full config, ``get_smoke(arch_id)`` for the reduced same-family one. Only
gemma-2b is ported; the other nine architectures raise until their blocks
land."""
from __future__ import annotations

import importlib

ARCH_IDS = ["gemma_2b"]

ALIASES = {"gemma-2b": "gemma_2b"}


def _module(arch_id: str):
    arch_id = ALIASES.get(arch_id, arch_id)
    if arch_id not in ARCH_IDS:
        raise NotImplementedError(f"architecture {arch_id!r} is not ported yet (ported: {ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get(arch_id: str):
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str):
    return _module(arch_id).SMOKE


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
