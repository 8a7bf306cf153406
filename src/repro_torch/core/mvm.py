"""Bit-sliced MVM with a finite-ADC fidelity model (port of
``repro.core.mvm``).

``mvm_sliced`` is the hardware-exact form: the 16-bit input is bit-streamed,
each (slice, bit) column sum passes an ``adc_bits`` ADC, then the digital
shift-and-add. ``fidelity_read`` is the float-world door into the engine: it
picks the DAC exponent from ``max|x|`` and hands the float activation to the
quantize-fused read (``kernels.sliced_mvm``), whose CUDA kernel does the DAC,
the bit planes, the per-tile ADC and the shift-and-add on the card.
``mvm_fast`` is the lossless read: dequantize once, one matmul.
"""
from __future__ import annotations

import torch

from .fixed_point import choose_frac_bits, exp2i
from .slicing import DEFAULT_SPEC, LOGICAL_BITS, SliceSpec, dequantize_planes


def _adc(col_sum: torch.Tensor, full_scale, adc_bits: int | None) -> torch.Tensor:
    """SAR-ADC model: uniform mid-tread quantizer over ±full_scale
    (``full_scale`` broadcastable against ``col_sum``)."""
    if adc_bits is None:
        return col_sum.to(torch.float32)
    full_scale = torch.as_tensor(full_scale, dtype=torch.float32, device=col_sum.device)
    step = (2.0 * full_scale) / (2**adc_bits)
    q = torch.round(col_sum.to(torch.float32) / step) * step
    return torch.minimum(torch.maximum(q, -full_scale), full_scale)


def bit_planes(x_q: torch.Tensor, io_bits: int = 16) -> torch.Tensor:
    """Signed magnitude bit planes of ``x_q``: int32 ``[io_bits-1, *x.shape]``
    with plane ``t`` equal to ``((|x| >> t) & 1) * sign(x)``."""
    sx = torch.sign(x_q).to(torch.int32)
    mx = torch.abs(x_q).to(torch.int32)
    t = torch.arange(io_bits - 1, dtype=torch.int32, device=x_q.device)
    t = t.reshape((io_bits - 1,) + (1,) * x_q.dim())
    return ((mx[None] >> t) & 1) * sx[None]


def shift_add_scales(spec: SliceSpec, io_bits: int = 16, device=None) -> torch.Tensor:
    """Static shift-and-add weight grid ``[io_bits-1, S]``: ``2^t * 16^s``
    (exact powers of two, built in Python)."""
    return torch.tensor(
        [[2.0 ** (t + LOGICAL_BITS * s) for s in range(spec.n_slices)]
         for t in range(io_bits - 1)],
        dtype=torch.float32, device=device,
    )


def mvm_sliced(
    planes: torch.Tensor,
    x_q: torch.Tensor,
    spec: SliceSpec = DEFAULT_SPEC,
    io_bits: int = 16,
    adc_bits: int | None = None,
    transpose: bool = False,
) -> torch.Tensor:
    """Bit-exact sliced MVM (no crossbar tiling). planes int8 [S, M, N]; x_q
    int [..., M] ([..., N] when ``transpose``) -> f32 on the product grid."""
    w = planes.to(torch.float32)
    if transpose:
        w = w.transpose(1, 2)
    n_rows = w.shape[1]
    full_scale = n_rows * torch.tensor(spec.plane_max, dtype=torch.float32, device=w.device)
    if adc_bits is None:
        y = torch.einsum("...m,smn->...sn", x_q.to(torch.float32), w)
        s_scale = torch.tensor([float(2 ** (LOGICAL_BITS * s)) for s in range(spec.n_slices)],
                               dtype=torch.float32, device=w.device)
        return torch.einsum("...sn,s->...n", y, s_scale)
    bp = bit_planes(x_q, io_bits).to(torch.float32)  # [T, ..., M]
    cols = torch.einsum("t...m,smn->t...sn", bp, w)
    cols = _adc(cols, full_scale[:, None], adc_bits)
    return torch.einsum("t...sn,ts->...n", cols, shift_add_scales(spec, io_bits, w.device))


def dac_frac_bits(x: torch.Tensor, fid) -> torch.Tensor:
    """The DAC exponent of a read of ``x``: ``choose_frac_bits`` over
    ``max|x|``, the global one on a mesh (all-reduced MAX over the data axes
    of the active ``distributed.fidelity`` scope), so every data shard
    quantizes against the range a single device sees."""
    from repro_torch.distributed.fidelity import ShardCtx, active  # lazy: distributed imports the models

    ctx = active()
    src = x
    if isinstance(ctx, ShardCtx) and ctx.mesh.group(ctx.data_axes) is not None:
        from repro_torch.distributed.collectives import all_reduce

        amax = all_reduce(x.detach().abs().max().to(torch.float32).reshape(1), ctx.mesh, ctx.data_axes, "max")
        src = amax.to(x.dtype)
    return choose_frac_bits(src, word_bits=fid.io_bits, margin_bits=fid.margin_bits, clip_to_word=False)


def fidelity_read(
    planes: torch.Tensor,
    frac_bits,
    x: torch.Tensor,
    fid,
    transpose: bool = False,
) -> torch.Tensor:
    """Finite-ADC crossbar read of a float tensor: ``planes`` int8 [S, M, N]
    on the ``2^-frac_bits`` weight grid, ``x`` float [..., M]. Only the DAC
    exponent is chosen here (it needs the global ``max|x|``); the quantize,
    bit planes, ADC and shift-and-add run inside the fused read. The result
    is rescaled by ``2^-(x_frac + frac_bits)``; everything stays on the
    device, with no host sync.

    On a mesh (a ``distributed.fidelity.use_sharded_fidelity`` scope),
    ``planes`` are this rank's block (split over the model axis along
    ``fid.shard_dim``) and ``x`` its tokens: ``max|x|`` is all-reduced
    (MAX) over the scope's data axes before the exponent is chosen, so every
    shard quantizes against the range the single-device read sees, and the
    read runs through ``mvm_sliced_sharded``. In a ``FoldCtx`` scope the
    whole planes are read through ``mvm_sliced_folded``."""
    from repro_torch.distributed.fidelity import FoldCtx, active  # lazy: kernels import core
    from repro_torch.kernels.sliced_mvm import mvm_sliced_folded, mvm_sliced_fused_batched, mvm_sliced_sharded

    adc_bits = fid.adc_bits_bwd if transpose else fid.adc_bits_fwd
    device = getattr(fid, "device", None)
    if device is not None and not device.reads_nonideal():
        device = None
    xf = dac_frac_bits(x, fid)
    ctx = active() if planes.dim() == 3 else None
    if isinstance(ctx, FoldCtx):
        acc = mvm_sliced_folded(planes, x, xf, fid.spec, parts=ctx.parts, shard_dim=getattr(fid, "shard_dim", None),
                                io_bits=fid.io_bits, adc_bits=adc_bits, transpose=transpose, device=device)
    elif ctx is not None:
        acc = mvm_sliced_sharded(
            planes, x, fid.spec, mesh=ctx.mesh, data_axes=ctx.data_axes, model_axis=ctx.model_axis,
            shard_dim=getattr(fid, "shard_dim", None), io_bits=fid.io_bits, adc_bits=adc_bits,
            transpose=transpose, frac_bits=xf, device=device,
        )
    else:
        acc = mvm_sliced_fused_batched(
            planes, x, xf, fid.spec, io_bits=fid.io_bits, adc_bits=adc_bits,
            transpose=transpose, device=device,
        )
    f = torch.as_tensor(frac_bits, dtype=torch.int32, device=xf.device)
    return acc * exp2i(-(xf + f))


def mvm_fast(
    planes: torch.Tensor,
    x: torch.Tensor,
    frac_bits,
    spec: SliceSpec = DEFAULT_SPEC,
    transpose: bool = False,
    dtype=torch.float32,
) -> torch.Tensor:
    """Lossless read: dequantize the planes once, one matmul."""
    w = dequantize_planes(planes, frac_bits, spec, dtype=dtype)
    if transpose:
        w = w.T
    return x @ w
