"""Plain PyTorch versions of the sliced-MVM kernel (port of
``repro.kernels.sliced_mvm.ref``).

They model the physical 128x128 crossbar tiling: the logical [M, N] matrix
is cut into 128-row tiles, each tile's column sums pass through their own
ADC per (slice, input bit) before the digital shift-and-add combines bits,
slices and tiles. The op order follows the reference, so in the f32-exact
regime the results are bit-identical to it.

``mvm_sliced_fused_ref`` is what the CUDA kernel is held against: the CPU
tests run it, and ``chip_smoke.py`` compares the kernel with it on the card.
The ops entry takes it only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.fixed_point import exp2i
from repro_torch.core.mvm import _adc, bit_planes, shift_add_scales
from repro_torch.core.slicing import LOGICAL_BITS, SliceSpec

XBAR_ROWS = 128


def dac_quantize(x: torch.Tensor, frac_bits, io_bits: int) -> torch.Tensor:
    """The DAC prologue: float -> ``io_bits`` fixed point on the ``2^-F``
    grid (round half to even, saturate) — ``core.fixed_point.quantize``'s
    arithmetic at the IO width."""
    lim = float(2 ** (io_bits - 1) - 1)
    scale = exp2i(frac_bits).to(x.device)
    y = torch.round(x.to(torch.float32) * scale)
    return torch.clamp(y, -lim, lim).to(torch.int32)


def _slice_scales(spec: SliceSpec, device) -> torch.Tensor:
    return torch.tensor([float(2 ** (LOGICAL_BITS * s)) for s in range(spec.n_slices)],
                        dtype=torch.float32, device=device)


def _slice_fold(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_s y[:, s] * w[s]`` for y [B, S, n], summed in ascending s — the
    order XLA's ``einsum("bsn,s->bn")`` sums in on the CPU and the order the
    CUDA kernel sums in, so all three agree bit for bit wherever the
    per-slice terms agree."""
    acc = y[:, 0] * w[0]
    for s in range(1, y.shape[1]):
        acc = acc + y[:, s] * w[s]
    return acc


def mvm_sliced_ref(
    planes: torch.Tensor,
    x_q: torch.Tensor,
    spec: SliceSpec,
    io_bits: int = 16,
    adc_bits: int | None = None,
    transpose: bool = False,
) -> torch.Tensor:
    """planes int8 [S, M, N]; x_q int [B, M] ([B, N] when ``transpose``) ->
    f32 [B, N] ([B, M]) on the product grid, tile by tile."""
    w = planes.to(torch.float32)
    if transpose:
        w = w.transpose(1, 2)
    S, M, N = w.shape
    B = x_q.shape[0]
    if tuple(x_q.shape) != (B, M):
        raise ValueError(f"x_q {tuple(x_q.shape)} does not match planes {tuple(planes.shape)}")
    n_tiles = -(-M // XBAR_ROWS)
    out = torch.zeros((B, N), dtype=torch.float32, device=w.device)
    if adc_bits is None:
        xf = x_q.to(torch.float32)
        s_scale = _slice_scales(spec, w.device)
        for tile in range(n_tiles):
            lo, hi = tile * XBAR_ROWS, min((tile + 1) * XBAR_ROWS, M)
            y = torch.einsum("bm,smn->bsn", xf[:, lo:hi], w[:, lo:hi])
            out = out + torch.einsum("bsn,s->bn", y, s_scale)
        return out
    full_scale = XBAR_ROWS * torch.tensor(spec.plane_max, dtype=torch.float32, device=w.device)
    bp = bit_planes(x_q, io_bits).to(torch.float32)  # [T, B, M]
    scales = shift_add_scales(spec, io_bits, w.device)  # [T, S]
    for tile in range(n_tiles):
        lo, hi = tile * XBAR_ROWS, min((tile + 1) * XBAR_ROWS, M)
        y = torch.einsum("tbm,smn->tbsn", bp[:, :, lo:hi], w[:, lo:hi])
        y = _adc(y, full_scale[:, None], adc_bits)
        out = out + torch.einsum("tbsn,ts->bn", y, scales)
    return out


def mvm_sliced_fused_ref(
    planes: torch.Tensor,
    x: torch.Tensor,
    frac_bits,
    spec: SliceSpec,
    io_bits: int = 16,
    adc_bits: int | None = None,
    transpose: bool = False,
) -> torch.Tensor:
    """Quantize-fused packed MVM, the plain version of the kernel: planes int8
    [S, M, N]; x FLOAT [B, M] ([B, N] when ``transpose``); frac_bits the
    int32 DAC exponent -> f32 [B, N] ([B, M]) on the product grid (the
    caller applies ``2^-(xf+F)``).

    The DAC quantize happens here. At finite ADC the planes are prescaled by
    ``1/step`` (exact: the step is a power of two), so the ADC is a bare
    round+clip to integer codes, then a bit fold and a slice fold with the
    step folded into the slice weights — the reference's schedule. A
    contraction dim that is not a multiple of 128 ends in a short last tile
    whose ADC full scale stays ``128·plane_max``."""
    w = planes.to(torch.float32)
    if transpose:
        w = w.transpose(1, 2)
    S, M, N = w.shape
    B = x.shape[0]
    if tuple(x.shape) != (B, M):
        raise ValueError(f"x {tuple(x.shape)} does not match planes {tuple(planes.shape)}")
    x_q = dac_quantize(x, frac_bits, io_bits)
    n_tiles = -(-M // XBAR_ROWS)
    out = torch.zeros((B, N), dtype=torch.float32, device=w.device)

    if adc_bits is None:
        xf = x_q.to(torch.float32)
        s_scale = _slice_scales(spec, w.device)
        for tile in range(n_tiles):
            lo, hi = tile * XBAR_ROWS, min((tile + 1) * XBAR_ROWS, M)
            y = torch.einsum("bm,smn->bsn", xf[:, lo:hi], w[:, lo:hi])
            out = out + _slice_fold(y, s_scale)
        return out

    T = io_bits - 1
    bp = bit_planes(x_q, io_bits).to(torch.float32)  # [T, B, M]
    full_scale = XBAR_ROWS * torch.tensor(spec.plane_max, dtype=torch.float32, device=w.device)
    step = 2.0 * full_scale / float(2**adc_bits)
    half = float(2 ** (adc_bits - 1))
    w2 = w * (1.0 / step)[:, None, None]
    tw = torch.tensor([float(2**t) for t in range(T)], dtype=torch.float32, device=w.device)
    sw = step * _slice_scales(spec, w.device)
    for tile in range(n_tiles):
        lo, hi = tile * XBAR_ROWS, min((tile + 1) * XBAR_ROWS, M)
        y = torch.einsum("tbm,smn->tbsn", bp[:, :, lo:hi], w2[:, lo:hi])
        q = torch.clamp(torch.round(y), -half, half)  # integer ADC codes
        z = torch.tensordot(tw, q, dims=([0], [0]))  # bit fold -> [B, S, n]
        out = out + _slice_fold(z, sw)  # slice fold (step folded)
    return out
