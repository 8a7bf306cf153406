"""CUDA kernel for the Carry Resolution Step on Hopper, bound through
``ctypes`` (port of the Pallas kernel ``repro.kernels.crs.kernel``).

The kernel (``csrc/crs.cu``) rewrites one ``[S, M, N]`` block of digit
planes in place, 4 elements a 32-bit word in byte lanes, ``S`` a template
argument, the bytes moving by TMA bulk copies through a ring of
shared-memory stages; its source says what bounds it. Where ``M·N`` is a
multiple of 16 the elements before the planes' first 16-byte boundary and
after their last take a per-element routine in the same launch; for other
shapes every element does. The library builds at first use
(``kernels.build``), never at import. The wrapper launches on the current
stream and counts its launches in ``crs.launches``; on fake tensors
(``kernels.common.is_fake``) it records the launch and its work in
``common.fake_work`` and launches nothing.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.core.slicing import SliceSpec
from repro_torch.kernels import build as _build
from repro_torch.kernels.common import crs_work, fake_work, is_fake, on_card

SOURCE = Path(__file__).resolve().parent / "csrc" / "crs.cu"
MAX_SLICES = 8  # canonical_limit fits int32


def build_kernel() -> _build.Built:
    return _build.build("crs", [SOURCE])


@functools.lru_cache(maxsize=1)
def _entry():
    fn = ctypes.CDLL(str(build_kernel().path)).panther_crs
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def crs(planes: torch.Tensor, *, spec: SliceSpec) -> torch.Tensor:
    """planes int8 [S, M, N], contiguous on a CUDA device, canonicalized in
    place; returns ``planes``."""
    if not on_card(planes):
        raise ValueError("crs kernel takes CUDA tensors only")
    if planes.dtype != torch.int8 or planes.dim() != 3 or not planes.is_contiguous():
        raise ValueError(f"planes must be contiguous int8 [S, M, N], got {planes.dtype} {tuple(planes.shape)}")
    S = planes.shape[0]
    if S != spec.n_slices or S > MAX_SLICES:
        raise ValueError(f"planes S={S} vs spec S={spec.n_slices} (at most {MAX_SLICES})")
    mn = planes.shape[1] * planes.shape[2]
    if mn == 0:
        return planes
    if is_fake(planes):
        fake_work.add("crs", "crs", crs_work(S * mn))
        return planes
    fn = _entry()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = fn(planes.data_ptr(), mn, S, stream)
    if err != 0:
        raise RuntimeError(f"crs kernel launch failed (cudaError {err})")
    crs.launches += 1
    return planes


crs.launches = 0
