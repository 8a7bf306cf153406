"""CUDA kernel for the Carry Resolution Step on Hopper, bound through
``ctypes`` (port of the Pallas kernel ``repro.kernels.crs.kernel``).

The kernel (``csrc/crs.cu``) rewrites one ``[S, M, N]`` block of digit
planes in place; its source says what bounds it. The library builds at
first use (``kernels.build``), never at import. The wrapper launches on the
current stream and counts its launches in ``crs.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.core.slicing import SliceSpec, _digits_of
from repro_torch.kernels import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "crs.cu"
MAX_SLICES = 8  # canonical_limit fits int32


def build_kernel() -> _build.Built:
    return _build.build("crs", [SOURCE])


@functools.lru_cache(maxsize=1)
def _entry():
    fn = ctypes.CDLL(str(build_kernel().path)).panther_crs
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def crs(planes: torch.Tensor, *, spec: SliceSpec) -> torch.Tensor:
    """planes int8 [S, M, N], contiguous on a CUDA device, canonicalized in
    place; returns ``planes``."""
    if not planes.is_cuda:
        raise ValueError("crs kernel takes CUDA tensors only")
    if planes.dtype != torch.int8 or planes.dim() != 3 or not planes.is_contiguous():
        raise ValueError(f"planes must be contiguous int8 [S, M, N], got {planes.dtype} {tuple(planes.shape)}")
    S = planes.shape[0]
    if S != spec.n_slices or S > MAX_SLICES:
        raise ValueError(f"planes S={S} vs spec S={spec.n_slices} (at most {MAX_SLICES})")
    mn = planes.shape[1] * planes.shape[2]
    if mn == 0:
        return planes
    lim = spec.canonical_limit
    pos = (ctypes.c_int * S)(*_digits_of(lim, S))
    neg = (ctypes.c_int * S)(*_digits_of(-lim, S))
    vec = int(mn % 4 == 0 and planes.data_ptr() % 4 == 0)
    fn = _entry()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = fn(planes.data_ptr(), mn, S, ctypes.cast(pos, ctypes.c_void_p),
                 ctypes.cast(neg, ctypes.c_void_p), vec, stream)
    if err != 0:
        raise RuntimeError(f"crs kernel launch failed (cudaError {err})")
    crs.launches += 1
    return planes


crs.launches = 0
