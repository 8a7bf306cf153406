"""Public entry point of the CRS kernel (port of ``repro.kernels.crs.ops``).

CUDA planes launch the kernel once per layer block, in place; CPU planes run
the plain version and are overwritten with its result. There is no fallback
from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.core.slicing import SliceSpec
from repro_torch.kernels.common import layer_views, on_card
from . import kernel as _k
from . import ref as _ref


def crs(planes: torch.Tensor, spec: SliceSpec) -> torch.Tensor:
    """Canonicalize planes int8 ``[S, *stack, M, N]`` in place (a stacked
    leaf's storage is layer-major, see ``optim.panther``); returns
    ``planes``."""
    if on_card(planes):
        for block in layer_views(planes):
            _k.crs(block, spec=spec)
        return planes
    if planes.device.type != "cpu":
        raise ValueError(f"no CRS implementation for device {planes.device}")
    return planes.copy_(_ref.crs_ref(planes, spec))
