"""Plain PyTorch versions of the sliced-MVM kernel (port of
``repro.kernels.sliced_mvm.ref``).

They model the physical 128x128 crossbar tiling: the logical [M, N] matrix
is cut into 128-row tiles, each tile's column sums pass through their own
ADC per (slice, input bit) before the digital shift-and-add combines bits,
slices and tiles. The op order follows the reference, so in the f32-exact
regime the results are bit-identical to it.

``mvm_sliced_fused_ref`` (the quantize-fused read, K4) and
``mvm_sliced_ref`` (the read of a pre-quantized int input, K5) are what the
CUDA kernels are held against: the CPU tests run them, and ``chip_smoke.py``
compares the kernels with them on the card. The ops entries take them only
for tensors that lie on the CPU.

A read-noisy ``DeviceModel`` adds its frozen per-(crossbar tile, slice,
output column) offsets (``read_offsets_ref``) to the column currents: at
finite ADC to the current of every bit cycle before the ADC, at the ideal
ADC once, times ``2^(io_bits-1) - 1``, the sum over the bit cycles. Each
product and sum rounds to f32 on its own, as in the reference's source.
"""
from __future__ import annotations

import torch

import numpy as np

from repro_torch.core.fixed_point import counter_gauss, device_pattern_words, exp2i
from repro_torch.core.mvm import bit_planes
from repro_torch.core.slicing import LOGICAL_BITS, SliceSpec

XBAR_ROWS = 128
# salts of the frozen read-offset patterns (the MVM and the MᵀVM ADC banks),
# apart from the stuck-cell mask's (salt = slice index)
READ_SALT = 0x52D
READ_SALT_T = 0x52E


def read_offset_scales(device, spec: SliceSpec) -> list:
    """Per slice, ``f32(read_noise · 128 · plane_max[s])``: the product in
    Python floats, rounded to f32 once."""
    return [float(np.float32(device.read_noise * float(XBAR_ROWS * m))) for m in spec.plane_max]


def read_offsets_ref(device, spec: SliceSpec, gtile: int, col0: int, n_cols: int, transpose: bool,
                     on=None) -> torch.Tensor:
    """The frozen read offsets of crossbar tile ``gtile`` (global) at output
    columns ``col0 + arange(n_cols)``, in current units: f32 ``[S,
    n_cols]``, slice ``s`` the counter Gaussian at row ``gtile·S + s`` under
    ``device_pattern_words(stuck_seed, READ_SALT[_T])``, times its scale."""
    S = spec.n_slices
    words = device_pattern_words(device.stuck_seed, READ_SALT_T if transpose else READ_SALT)
    c = torch.arange(col0, col0 + n_cols, dtype=torch.int32, device=on)[None, :]
    r = torch.tensor([[gtile * S + s] for s in range(S)], dtype=torch.int32, device=on)
    return counter_gauss(r, c, *words) * torch.tensor(read_offset_scales(device, spec), device=on)[:, None]


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
    f32 [B, N] ([B, M]) on the product grid, tile by tile: the read of the
    fused version below on an input that is already on the DAC grid (the
    plain version of K5). At finite ADC the bits of ``|x_q|`` at and above
    ``io_bits - 1`` are not streamed; the ideal ADC contracts ``x_q``
    whole."""
    w = planes.to(torch.float32)
    if transpose:
        w = w.transpose(1, 2)
    if x_q.dim() != 2 or x_q.shape[1] != w.shape[1]:
        raise ValueError(f"x_q {tuple(x_q.shape)} does not match planes {tuple(planes.shape)}")
    return _read(w, x_q, spec, io_bits, adc_bits, transpose, None, 0, 0)


def mvm_sliced_fused_ref(
    planes: torch.Tensor,
    x: torch.Tensor,
    frac_bits,
    spec: SliceSpec,
    io_bits: int = 16,
    adc_bits: int | None = None,
    transpose: bool = False,
    device=None,
    tile0: int = 0,
    col0: int = 0,
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
    whose ADC full scale stays ``128·plane_max``. ``device`` with
    ``read_noise > 0`` adds the read offsets; ``tile0``/``col0`` are the
    global crossbar-tile and output-column offsets of these planes."""
    w = planes.to(torch.float32)
    if transpose:
        w = w.transpose(1, 2)
    if x.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not match planes {tuple(planes.shape)}")
    noisy = device is not None and device.read_noise > 0.0
    return _read(w, dac_quantize(x, frac_bits, io_bits), spec, io_bits, adc_bits, transpose,
                 device if noisy else None, tile0, col0)


def _read(w, x_q, spec: SliceSpec, io_bits: int, adc_bits, transpose: bool, device, tile0: int,
          col0: int) -> torch.Tensor:
    """The packed read of int ``x_q`` [B, M] through f32 planes ``w`` [S, M,
    N] (already transposed for the MᵀVM read), with read offsets when
    ``device`` is not None."""
    S, M, N = w.shape
    B = x_q.shape[0]
    n_tiles = -(-M // XBAR_ROWS)
    out = torch.zeros((B, N), dtype=torch.float32, device=w.device)

    def offs(tile):
        return read_offsets_ref(device, spec, tile0 + tile, col0, N, transpose, w.device)

    if adc_bits is None:
        xf = x_q.to(torch.float32)
        s_scale = _slice_scales(spec, w.device)
        for tile in range(n_tiles):
            lo, hi = tile * XBAR_ROWS, min((tile + 1) * XBAR_ROWS, M)
            y = torch.einsum("bm,smn->bsn", xf[:, lo:hi], w[:, lo:hi])
            if device is not None:  # each of the io_bits-1 bit cycles reads the offset
                y = y + offs(tile)[None] * float(2 ** (io_bits - 1) - 1)
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
        if device is not None:  # on the raw current, pre-round (the prescaled grid)
            y = y + (offs(tile) / step[:, None])[None, None]
        q = torch.clamp(torch.round(y), -half, half)  # integer ADC codes
        z = torch.tensordot(tw, q, dims=([0], [0]))  # bit fold -> [B, S, n]
        out = out + _slice_fold(z, sw)  # slice fold (step folded)
    return out
