"""Public entry points of the quantize-fused sliced MVM (port of
``repro.kernels.sliced_mvm.ops``).

Dispatch is by where the tensors lie: CUDA tensors launch the hand-written
kernel (``kernel.py``) or raise, CPU tensors run the plain PyTorch version
(``ref.py``). There is no fallback from one to the other. The kernel masks
ragged token counts, ragged output columns and a short last crossbar tile
itself, so the reference's zero padding of the token axis is not needed.
"""
from __future__ import annotations

import torch

from repro_torch.core.slicing import SliceSpec
from . import kernel as _k
from . import ref as _ref


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
) -> torch.Tensor:
    """Quantize-fused vector entry: ``x`` FLOAT [B, M] ([B, N] when
    ``transpose``) plus the int32 DAC exponent ``frac_bits`` -> f32 [B, N]
    on the product grid. ``device`` is a read-noisy ``DeviceModel`` (or
    None); read noise is not ported."""
    if device is not None and device.reads_nonideal():
        raise NotImplementedError("device read noise is not ported yet")
    if planes.device != x.device:
        raise ValueError(f"planes on {planes.device} but x on {x.device}")
    frac = torch.as_tensor(frac_bits, dtype=torch.int32, device=planes.device).reshape(1)
    xf = x.to(torch.float32).contiguous()
    if planes.is_cuda:
        return _k.mvm_sliced_fused(planes, xf, frac, spec=spec, io_bits=io_bits,
                                   adc_bits=adc_bits, transpose=transpose)
    if planes.device.type != "cpu":
        raise ValueError(f"no sliced-MVM implementation for device {planes.device}")
    return _ref.mvm_sliced_fused_ref(planes, xf, frac[0], spec, io_bits, adc_bits,
                                     transpose=transpose)


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
) -> torch.Tensor:
    """Token-batched quantize-fused read: FLOAT ``x`` [..., M] ([..., N]
    when ``transpose``), leading dims flattened into one token axis."""
    contract = planes.shape[2] if transpose else planes.shape[1]
    if x.shape[-1] != contract:
        raise ValueError(f"x {tuple(x.shape)} does not contract with planes {tuple(planes.shape)}")
    lead = x.shape[:-1]
    out = mvm_sliced_fused(
        planes, x.reshape(-1, contract), frac_bits, spec, io_bits=io_bits,
        adc_bits=adc_bits, transpose=transpose, device=device,
    )
    return out.reshape(*lead, out.shape[-1])
