"""Bit-sliced outer-product accumulate (port of ``repro.core.opa``): the
production form, which decomposes an int32 update on the weight grid into
balanced base-16 digits and deposits them with one saturating add."""
from __future__ import annotations

import torch

from .slicing import DEFAULT_SPEC, SliceSpec, product_digits, saturating_add


def opa_batched(planes: torch.Tensor, p_q: torch.Tensor, spec: SliceSpec = DEFAULT_SPEC) -> torch.Tensor:
    """Deposit an int32 grid-quantized update ``p_q`` (the weight's shape)
    into the int8 planes ``[S, *shape]``."""
    return saturating_add(planes, product_digits(p_q, spec), spec)
