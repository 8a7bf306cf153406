"""PANTHER core (port): fixed point, bit-sliced weights, sliced MVM."""
from .fixed_point import IO_BITS, WEIGHT_BITS, choose_frac_bits, dequantize, exp2i, quantize
from .slicing import (
    DEFAULT_SPEC,
    LOGICAL_BITS,
    RADIX,
    SliceSpec,
    dequantize_planes,
    slice_weights,
    unslice_weights,
)
from .mvm import fidelity_read, mvm_fast, mvm_sliced

__all__ = [
    "IO_BITS",
    "WEIGHT_BITS",
    "choose_frac_bits",
    "dequantize",
    "exp2i",
    "quantize",
    "DEFAULT_SPEC",
    "LOGICAL_BITS",
    "RADIX",
    "SliceSpec",
    "dequantize_planes",
    "slice_weights",
    "unslice_weights",
    "fidelity_read",
    "mvm_fast",
    "mvm_sliced",
]
