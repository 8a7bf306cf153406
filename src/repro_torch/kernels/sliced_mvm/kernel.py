"""CUDA kernel for the quantize-fused sliced MVM on Hopper, bound through
``ctypes`` (port of the Pallas kernel ``repro.kernels.sliced_mvm.kernel``).

The kernel (``csrc/mvm_sliced_fused.cu``) replaces ``mvm_sliced_fused`` of
``src/repro/kernels/sliced_mvm/kernel.py`` — both its double-buffered and
its 3-D-grid lowerings, which compute the same numbers — for the forward
and the transpose (MᵀVM) read without device read noise: per 128-row
crossbar tile (128-column tile for the transpose) it does the DAC, the
sign·magnitude bit planes, the int32 column currents, the per-slice ADC and
the shift-and-add, and accumulates the tiles in f32. The transpose reads the
same row-major planes in place. The source comment says what bounds it on
the card and what the simple design leaves for later.

The library builds at first use (``kernels.build``); nothing is compiled or
loaded at import, so CPU-only machines import this module freely. The
wrapper launches on the current stream and counts its launches in
``mvm_sliced_fused.launches`` (forward) and
``mvm_sliced_fused.transpose_launches`` (MᵀVM).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.core.slicing import SliceSpec
from repro_torch.kernels import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "mvm_sliced_fused.cu"
IO_BITS_BUILT = (16,)  # io widths the source instantiates (every preset reads at 16)
MAX_SLICES = 16


def build_kernel() -> _build.Built:
    """Compile the kernel (or reuse an identical build)."""
    return _build.build("mvm_sliced_fused", [SOURCE])


@functools.lru_cache(maxsize=1)
def _entry():
    lib = ctypes.CDLL(str(build_kernel().path))
    fn = lib.panther_mvm_sliced_fused
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def mvm_sliced_fused(
    planes: torch.Tensor,
    x: torch.Tensor,
    frac_bits: torch.Tensor,
    *,
    spec: SliceSpec,
    io_bits: int = 16,
    adc_bits: int | None = None,
    transpose: bool = False,
    dev=None,
) -> torch.Tensor:
    """planes int8 [S, M, N]; x float32 [B, M] ([B, N] when ``transpose``);
    frac_bits int32 1-element tensor (the DAC exponent, read by the kernel
    on the device) -> f32 [B, N] ([B, M]) on the product grid. All CUDA
    tensors on one device, contiguous. Raises on what the kernel does not
    take: device read noise has no kernel yet."""
    if dev is not None:
        raise NotImplementedError("mvm_sliced_fused: device read noise has no CUDA kernel yet")
    if not (planes.is_cuda and x.is_cuda and frac_bits.is_cuda):
        raise ValueError("mvm_sliced_fused kernel takes CUDA tensors only")
    if not (planes.device == x.device == frac_bits.device):
        raise ValueError(f"tensors on different devices: {planes.device}, {x.device}, {frac_bits.device}")
    if planes.dtype != torch.int8 or planes.dim() != 3 or not planes.is_contiguous():
        raise ValueError(f"planes must be contiguous int8 [S, M, N], got {planes.dtype} {tuple(planes.shape)}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32 [B, M], got {x.dtype} {tuple(x.shape)}")
    if frac_bits.dtype != torch.int32 or frac_bits.numel() != 1:
        raise ValueError("frac_bits must be a 1-element int32 tensor")
    S, M, N = planes.shape
    B = x.shape[0]
    contract, out_dim = (N, M) if transpose else (M, N)
    if x.shape[1] != contract or S != spec.n_slices:
        raise ValueError(f"x {tuple(x.shape)} / spec S={spec.n_slices} do not match planes {tuple(planes.shape)}")
    if S > MAX_SLICES:
        raise ValueError(f"at most {MAX_SLICES} slices, got {S}")
    if io_bits not in IO_BITS_BUILT:
        raise ValueError(f"io_bits {io_bits} not built; the kernel takes {IO_BITS_BUILT}")
    if adc_bits is not None and not 1 <= adc_bits <= 16:
        raise ValueError(f"adc_bits must be in [1, 16] or None, got {adc_bits}")
    out = torch.empty((B, out_dim), dtype=torch.float32, device=x.device)
    if B == 0 or out_dim == 0:
        return out
    if contract == 0:
        return out.zero_()
    bits = (ctypes.c_int * S)(*spec.bits_lsb_first)
    vec = int(N % 4 == 0 and planes.data_ptr() % 4 == 0)
    fn = _entry()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = fn(planes.data_ptr(), x.data_ptr(), frac_bits.data_ptr(), out.data_ptr(),
                 B, M, N, S, io_bits, 0 if adc_bits is None else adc_bits,
                 ctypes.cast(bits, ctypes.c_void_p), vec, int(transpose), stream)
    if err != 0:
        raise RuntimeError(f"mvm_sliced_fused kernel launch failed (cudaError {err})")
    if transpose:
        mvm_sliced_fused.transpose_launches += 1
    else:
        mvm_sliced_fused.launches += 1
    return out


mvm_sliced_fused.launches = 0
mvm_sliced_fused.transpose_launches = 0
