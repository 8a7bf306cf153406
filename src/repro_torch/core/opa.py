"""Bit-sliced outer-product accumulate (port of ``repro.core.opa``), in both
of the reference's forms:

``opa_stream``   the hardware-exact form (paper §3.1, Fig 3): the row input
                 ``x`` is bit-streamed one magnitude bit a cycle, the column
                 input ``a`` is shifted each cycle and carved into 4-bit
                 chunks, one a slice; each cycle deposits ``±x_bit · chunk``
                 into its plane with per-cycle saturation, so carries stay
                 within a slice's headroom.

``opa_batched``  the production form: an int32 update on the weight grid,
                 decomposed into balanced base-16 digits and deposited with
                 one saturating add. Value-equivalent to streaming each
                 example while no plane saturates mid-batch.
"""
from __future__ import annotations

import torch

from .slicing import DEFAULT_SPEC, LOGICAL_BITS, SliceSpec, product_digits, saturating_add

IO_MAG_BITS = 15  # 16-bit signed magnitude inputs


def opa_stream(planes: torch.Tensor, x_q: torch.Tensor, a_q: torch.Tensor, spec: SliceSpec = DEFAULT_SPEC,
               io_bits: int = 16) -> torch.Tensor:
    """Hardware-exact OPA of one example onto the digit planes: ``planes``
    int8 ``[S, M, N]``, ``x_q`` int ``[M]`` row input, ``a_q`` int ``[N]``
    column input (signed fixed point, magnitudes below ``2**(io_bits-1)``).
    """
    sx, mx = torch.sign(x_q).to(torch.int32), x_q.abs().to(torch.int32)
    sa, ma = torch.sign(a_q).to(torch.int32), a_q.abs().to(torch.int32)
    mask = (1 << LOGICAL_BITS) - 1
    out = planes
    for t in range(io_bits - 1):
        bt = ((mx >> t) & 1) * sx  # [M] signed row pulse this cycle
        v = ma << t  # [N] shifted column magnitude
        deltas = [bt[:, None] * (((v >> (LOGICAL_BITS * s)) & mask) * sa)[None, :] for s in range(spec.n_slices)]
        out = saturating_add(out, torch.stack(deltas), spec)
    return out


def opa_stream_batch(planes: torch.Tensor, x_q: torch.Tensor, a_q: torch.Tensor, spec: SliceSpec = DEFAULT_SPEC,
                     io_bits: int = 16) -> torch.Tensor:
    """Sequential per-example OPA over a batch (paper Table 2, steps 9-12):
    ``x_q`` ``[B, M]``, ``a_q`` ``[B, N]``, applied in order, since
    saturation depends on the order, as in the crossbar."""
    out = planes
    for x, a in zip(x_q, a_q):
        out = opa_stream(out, x, a, spec, io_bits)
    return out


def opa_batched(planes: torch.Tensor, p_q: torch.Tensor, spec: SliceSpec = DEFAULT_SPEC) -> torch.Tensor:
    """Deposit an int32 grid-quantized update ``p_q`` (the weight's shape)
    into the int8 planes ``[S, *shape]``."""
    return saturating_add(planes, product_digits(p_q, spec), spec)


def outer_product_int(x_q: torch.Tensor, a_q: torch.Tensor) -> torch.Tensor:
    """Summed int32 outer product over a batch, ``P = sum_b x_b a_bᵀ``,
    wrapping on overflow as the reference's int32 accumulation does. CUDA
    has no integer matmul, so the sum runs in int64 (no float type) and is
    cast back: the low 32 bits of the int64 sum are the int32 sum's."""
    x, a = x_q.to(torch.int64), a_q.to(torch.int64)
    acc = torch.zeros((x.shape[1], a.shape[1]), dtype=torch.int64, device=x.device)
    for xb, ab in zip(x, a):
        acc += xb[:, None] * ab[None, :]
    return acc.to(torch.int32)
