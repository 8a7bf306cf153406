"""Public entry points of the sliced MVM (port of
``repro.kernels.sliced_mvm.ops``).

``mvm_sliced_fused`` / ``mvm_sliced_fused_batched`` are the quantize-fused
reads ``core.mvm.fidelity_read`` calls: the float activation and the DAC
exponent go in, and the DAC, the bit planes, the per-tile ADC and the
shift-and-add happen in the read. A read-noisy ``DeviceModel`` adds its
frozen read offsets; an ideal one runs the ideal read. ``mvm_sliced`` /
``mvm_sliced_batched`` read an input already on the DAC grid (int).

Dispatch is by where the tensors lie: CUDA tensors launch the hand-written
kernels (``kernel.py``) or raise, CPU tensors run the plain PyTorch versions
(``ref.py``). There is no fallback from one to the other. The kernels mask
ragged token counts, ragged output columns and a short last crossbar tile
themselves, so the reference's zero padding of the token axis is not needed.
"""
from __future__ import annotations

import torch

from repro_torch.core.slicing import SliceSpec
from . import kernel as _k
from . import ref as _ref


def _normalize_read_device(device):
    """None unless the read path is non-ideal: an ideal or write-only
    DeviceModel runs the exact ideal read."""
    if device is None or not device.reads_nonideal():
        return None
    return device


def _check_device(planes: torch.Tensor, x: torch.Tensor) -> None:
    if planes.device != x.device:
        raise ValueError(f"planes on {planes.device} but x on {x.device}")
    if not planes.is_cuda and planes.device.type != "cpu":
        raise ValueError(f"no sliced-MVM implementation for device {planes.device}")


def _batched(read, planes: torch.Tensor, x: torch.Tensor, transpose: bool) -> torch.Tensor:
    """``read`` of ``x`` [..., contract] with the leading dims flattened into
    one token axis."""
    contract = planes.shape[2] if transpose else planes.shape[1]
    if x.shape[-1] != contract:
        raise ValueError(f"x {tuple(x.shape)} does not contract with planes {tuple(planes.shape)}")
    out = read(x.reshape(-1, contract))
    return out.reshape(*x.shape[:-1], out.shape[-1])


def mvm_sliced_fused(
    planes: torch.Tensor,
    x: torch.Tensor,
    frac_bits,
    spec: SliceSpec,
    *,
    io_bits: int = 16,
    adc_bits: int | None = None,
    transpose: bool = False,
    device=None,
    tile0: int = 0,
    col0: int = 0,
) -> torch.Tensor:
    """Quantize-fused vector entry: ``x`` FLOAT [B, M] ([B, N] when
    ``transpose``) plus the int32 DAC exponent ``frac_bits`` -> f32 [B, N]
    on the product grid. ``device``: a DeviceModel or None; its read noise
    offsets the column currents. ``tile0``/``col0`` (host ints) are the
    global crossbar-tile and output-column offsets of these planes, which
    key the offsets."""
    _check_device(planes, x)
    device = _normalize_read_device(device)
    frac = torch.as_tensor(frac_bits, dtype=torch.int32, device=planes.device).reshape(1)
    xf = x.to(torch.float32).contiguous()
    if planes.is_cuda:
        return _k.mvm_sliced_fused(planes, xf, frac, spec=spec, io_bits=io_bits, adc_bits=adc_bits,
                                   transpose=transpose, dev=device, tile0=tile0, col0=col0)
    return _ref.mvm_sliced_fused_ref(planes, xf, frac[0], spec, io_bits, adc_bits, transpose=transpose,
                                     device=device, tile0=tile0, col0=col0)


def mvm_sliced_fused_batched(
    planes: torch.Tensor,
    x: torch.Tensor,
    frac_bits,
    spec: SliceSpec,
    *,
    io_bits: int = 16,
    adc_bits: int | None = None,
    transpose: bool = False,
    device=None,
    tile0: int = 0,
    col0: int = 0,
) -> torch.Tensor:
    """Token-batched quantize-fused read: FLOAT ``x`` [..., M] ([..., N]
    when ``transpose``), leading dims flattened into one token axis. The
    read offsets are per output column, the same on every token."""
    return _batched(lambda x2: mvm_sliced_fused(
        planes, x2, frac_bits, spec, io_bits=io_bits, adc_bits=adc_bits, transpose=transpose,
        device=device, tile0=tile0, col0=col0), planes, x, transpose)


def mvm_sliced(
    planes: torch.Tensor,
    x_q: torch.Tensor,
    spec: SliceSpec,
    *,
    io_bits: int = 16,
    adc_bits: int | None = None,
    transpose: bool = False,
) -> torch.Tensor:
    """Vector entry on a pre-quantized input: ``x_q`` int [B, M] ([B, N]
    when ``transpose``) on the ``io_bits`` DAC grid -> f32 [B, N] ([B, M])
    on the product grid."""
    _check_device(planes, x_q)
    if planes.is_cuda:
        return _k.mvm_sliced(planes, x_q.to(torch.int32).contiguous(), spec=spec, io_bits=io_bits,
                             adc_bits=adc_bits, transpose=transpose)
    return _ref.mvm_sliced_ref(planes, x_q, spec, io_bits, adc_bits, transpose=transpose)


def mvm_sliced_batched(
    planes: torch.Tensor,
    x_q: torch.Tensor,
    spec: SliceSpec,
    *,
    io_bits: int = 16,
    adc_bits: int | None = None,
    transpose: bool = False,
) -> torch.Tensor:
    """Token-batched read of a pre-quantized input: ``x_q`` int [..., M]
    ([..., N] when ``transpose``), leading dims flattened into one token
    axis."""
    return _batched(lambda x2: mvm_sliced(planes, x2, spec, io_bits=io_bits, adc_bits=adc_bits,
                                          transpose=transpose), planes, x_q, transpose)
