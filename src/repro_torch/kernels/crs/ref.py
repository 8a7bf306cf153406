"""Plain PyTorch version of the CRS kernel (port of
``repro.kernels.crs.ref``): ``core.slicing.crs``. The CPU tests run it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card."""
from __future__ import annotations

from repro_torch.core.slicing import SliceSpec, crs


def crs_ref(planes, spec: SliceSpec):
    """planes int8 [S, ...] -> canonical planes (carry propagation and the
    ±canonical_limit rails)."""
    return crs(planes, spec)
