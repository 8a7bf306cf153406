"""CUDA kernels for the sliced MVM on Hopper, bound through ``ctypes`` (port
of the Pallas kernels ``repro.kernels.sliced_mvm.kernel``).

One source (``csrc/mvm_sliced_fused.cu``) holds both reads:

* ``mvm_sliced_fused`` replaces ``mvm_sliced_fused`` of
  ``src/repro/kernels/sliced_mvm/kernel.py`` (K4) — both its double-buffered
  and its 3-D-grid lowerings, which compute the same numbers — for the
  forward and the transpose (MᵀVM) read, at ``io_bits`` 8, 12 and 16, with
  or without a device model's read noise: per 128-row crossbar tile
  (128-column tile for the transpose) it does the DAC, the sign·magnitude
  bit planes, the int32 column currents, the read offsets, the per-slice
  ADC and the shift-and-add, and accumulates the tiles in f32;
* ``mvm_sliced`` replaces ``mvm_sliced`` (K5): the same read on an int32
  input already on the DAC grid, with no DAC prologue.

The transpose reads the same row-major planes in place. The source comment
says what bounds it on the card and what the simple design leaves for later.

The library builds at first use (``kernels.build``); nothing is compiled or
loaded at import, so CPU-only machines import this module freely. The
wrappers launch on the current stream and count their launches:
``launches`` (forward) and ``transpose_launches`` (MᵀVM) over every
instance, and ``instances`` by instance name (``instance_name``).
"""
from __future__ import annotations

import collections
import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.core.fixed_point import device_pattern_words
from repro_torch.core.slicing import SliceSpec
from repro_torch.kernels import build as _build
from .ref import READ_SALT, READ_SALT_T, read_offset_scales

SOURCE = Path(__file__).resolve().parent / "csrc" / "mvm_sliced_fused.cu"
IO_BITS_BUILT = (8, 12, 16)  # io widths the source instantiates (the fig9 io sweep reads at 8 and 12)
MAX_SLICES = 16


def build_kernel() -> _build.Built:
    """Compile the kernel (or reuse an identical build)."""
    return _build.build("mvm_sliced_fused", [SOURCE])


@functools.lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(str(build_kernel().path))
    lib.panther_mvm_sliced_fused.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.panther_mvm_sliced.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.panther_mvm_sliced_fused, lib.panther_mvm_sliced):
        fn.restype = ctypes.c_int
    return lib


def instance_name(transpose: bool, io_bits: int, noisy: bool = False) -> str:
    """The key of a read's instance in ``instances``: e.g. ``"io16"``,
    ``"transpose_io8"``, ``"io16_read_noise"``."""
    return f"{'transpose_' if transpose else ''}io{io_bits}{'_read_noise' if noisy else ''}"


def _check_read(planes: torch.Tensor, x: torch.Tensor, x_dtype, spec: SliceSpec, io_bits: int, adc_bits,
                transpose: bool):
    if not (planes.is_cuda and x.is_cuda):
        raise ValueError("the sliced-MVM kernels take CUDA tensors only")
    if planes.device != x.device:
        raise ValueError(f"tensors on different devices: {planes.device}, {x.device}")
    if planes.dtype != torch.int8 or planes.dim() != 3 or not planes.is_contiguous():
        raise ValueError(f"planes must be contiguous int8 [S, M, N], got {planes.dtype} {tuple(planes.shape)}")
    if x.dtype != x_dtype or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous {x_dtype} [B, M], got {x.dtype} {tuple(x.shape)}")
    S, M, N = planes.shape
    contract = N if transpose else M
    if x.shape[1] != contract or S != spec.n_slices:
        raise ValueError(f"x {tuple(x.shape)} / spec S={spec.n_slices} do not match planes {tuple(planes.shape)}")
    if S > MAX_SLICES:
        raise ValueError(f"at most {MAX_SLICES} slices, got {S}")
    if io_bits not in IO_BITS_BUILT:
        raise ValueError(f"io_bits {io_bits} not built; the kernel takes {IO_BITS_BUILT}")
    if adc_bits is not None and not 1 <= adc_bits <= 16:
        raise ValueError(f"adc_bits must be in [1, 16] or None, got {adc_bits}")


def _run(name: str, planes: torch.Tensor, x: torch.Tensor, spec: SliceSpec, adc_bits, transpose: bool,
         call) -> tuple:
    """Allocate the output and launch ``call(out, B, M, N, S, adc_bits,
    slice_bits, vec, transpose, stream)``; -> (out, launched)."""
    S, M, N = planes.shape
    B = x.shape[0]
    out = torch.empty((B, M if transpose else N), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out, False
    if (N if transpose else M) == 0:
        return out.zero_(), False
    bits = (ctypes.c_int * S)(*spec.bits_lsb_first)
    vec = int(N % 4 == 0 and planes.data_ptr() % 4 == 0)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = call(out.data_ptr(), B, M, N, S, 0 if adc_bits is None else adc_bits,
                   ctypes.cast(bits, ctypes.c_void_p), vec, int(transpose), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")
    return out, True


def _count(wrapper, transpose: bool, io_bits: int, noisy: bool = False) -> None:
    if transpose:
        wrapper.transpose_launches += 1
    else:
        wrapper.launches += 1
    wrapper.instances[instance_name(transpose, io_bits, noisy)] += 1


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
    tile0: int = 0,
    col0: int = 0,
) -> torch.Tensor:
    """planes int8 [S, M, N]; x float32 [B, M] ([B, N] when ``transpose``);
    frac_bits int32 1-element tensor (the DAC exponent, read by the kernel
    on the device) -> f32 [B, N] ([B, M]) on the product grid. All CUDA
    tensors on one device, contiguous. ``dev``: None, or a DeviceModel with
    ``read_noise > 0`` for the noisy instance, whose offsets are keyed at
    the global crossbar tile ``tile0 + k`` and column ``col0 + n``. Raises on
    what the kernel does not take."""
    _check_read(planes, x, torch.float32, spec, io_bits, adc_bits, transpose)
    if not frac_bits.is_cuda or frac_bits.device != planes.device:
        raise ValueError(f"frac_bits on {frac_bits.device}, planes on {planes.device}")
    if frac_bits.dtype != torch.int32 or frac_bits.numel() != 1:
        raise ValueError("frac_bits must be a 1-element int32 tensor")
    if dev is not None and not dev.read_noise > 0.0:
        raise ValueError("the noisy instance takes a DeviceModel with read_noise > 0 (None for the ideal one)")
    off, words = None, (0, 0)
    if dev is not None:
        off = ctypes.cast((ctypes.c_float * spec.n_slices)(*read_offset_scales(dev, spec)), ctypes.c_void_p)
        words = device_pattern_words(dev.stuck_seed, READ_SALT_T if transpose else READ_SALT)
    fn = _lib().panther_mvm_sliced_fused

    def call(out, B, M, N, S, adc, bits, vec, trans, stream):
        return fn(planes.data_ptr(), x.data_ptr(), frac_bits.data_ptr(), out, B, M, N, S, io_bits, adc,
                  bits, vec, trans, off, *words, int(tile0), int(col0), stream)

    out, launched = _run("mvm_sliced_fused", planes, x, spec, adc_bits, transpose, call)
    if launched:
        _count(mvm_sliced_fused, transpose, io_bits, dev is not None)
    return out


def mvm_sliced(
    planes: torch.Tensor,
    x_q: torch.Tensor,
    *,
    spec: SliceSpec,
    io_bits: int = 16,
    adc_bits: int | None = None,
    transpose: bool = False,
) -> torch.Tensor:
    """planes int8 [S, M, N]; x_q int32 [B, M] ([B, N] when ``transpose``)
    on the ``io_bits`` DAC grid (``|x_q| <= 2^(io_bits-1) - 1``: the bits
    at and above ``io_bits - 1`` are not streamed) -> f32 [B, N] ([B, M])
    on the product grid. CUDA tensors on one device, contiguous."""
    _check_read(planes, x_q, torch.int32, spec, io_bits, adc_bits, transpose)
    fn = _lib().panther_mvm_sliced

    def call(out, B, M, N, S, adc, bits, vec, trans, stream):
        return fn(planes.data_ptr(), x_q.data_ptr(), out, B, M, N, S, io_bits, adc, bits, vec, trans, stream)

    out, launched = _run("mvm_sliced", planes, x_q, spec, adc_bits, transpose, call)
    if launched:
        _count(mvm_sliced, transpose, io_bits)
    return out


for _wrapper in (mvm_sliced_fused, mvm_sliced):
    _wrapper.launches = 0
    _wrapper.transpose_launches = 0
    _wrapper.instances = collections.Counter()
