"""CUDA kernels for the sliced-OPA update on Hopper, bound through ``ctypes``
(port of the Pallas kernels ``repro.kernels.sliced_opa.kernel``).

* ``opa_deposit`` (``csrc/opa_deposit.cu``) deposits an int32 update on the
  weight grid into one ``[S, M, N]`` block of digit planes, in place; its
  ``stuck`` instance then keeps a device model's stuck digits.
* ``opa_fused`` (``csrc/opa_fused.cu``) forms ``xᵀdh`` tile by tile, scales
  it by ``-lr · 2^F``, rounds it (stochastically under key words, by the
  draw of ``rng_mode``: the counter hash, the ``"grid"`` threefry stream
  of ``jax.random.uniform`` or the ``"hw"`` Philox tile stream; or half to
  even without) and deposits it in the same pass: the gradient never
  reaches device memory, nor does any draw. Its ``device`` instance adds a
  write-nonideal device model's physics to the finalize: asymmetry, write
  noise, stuck cells. It has two bodies with the same finalize, chosen by
  the operands' dtype (``body_for``): bf16 operands (the training path)
  run on the bf16 tensor cores (``mma.sync``), f32 operands on the CUDA
  cores (``fma``). Where the f32 sums are exact, the two give the same
  bits.

Each source says what bounds it. The libraries build at first use
(``kernels.build``), never at import. The wrappers launch on the current
stream and count their launches: ``launches`` over every instance, and
``instances`` by instance (``instance_name``: ``"ideal"``, ``"device"``,
with ``"_grid"``/``"_hw"`` for those draws and ``"_fma"`` for the
CUDA-core body, for ``opa_fused``; ``"ideal"``, ``"stuck"`` for
``opa_deposit``).
"""
from __future__ import annotations

import collections
import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.fixed_point import RNG_MODES, check_rng_mode, device_pattern_words
from repro_torch.core.slicing import SliceSpec
from repro_torch.kernels import build as _build
from repro_torch.kernels.common import hw_tiles

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"opa_deposit": [CSRC / "opa_deposit.cu"], "opa_fused": [CSRC / "opa_fused.cu"]}
MAX_SLICES = 8  # canonical_limit fits int32
_OPERAND_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_RNG_CODES = {mode: 1 + i for i, mode in enumerate(RNG_MODES)}  # opa_fused.cu's Rng; 0: half to even


def body_for(dtype: torch.dtype) -> str:
    """The K1 body that takes operands of ``dtype``: ``"mma"`` (bf16 tensor
    cores) for bfloat16, ``"fma"`` (f32 FMAs on the CUDA cores) for float32.
    bf16 products are exact in f32; f32 operands have no exact tensor-core
    route (TF32 is not f32)."""
    if dtype == torch.bfloat16:
        return "mma"
    if dtype == torch.float32:
        return "fma"
    raise ValueError(f"opa_fused takes float32 or bfloat16 operands, got {dtype}")


def instance_name(dev: bool, body: str, rng_mode: str = "counter") -> str:
    """The key of a K1 launch in ``opa_fused.instances``: ``"ideal"`` or
    ``"device"``, then ``"_grid"`` or ``"_hw"`` for those rounding draws
    (the counter draw and half to even keep the bare name), then ``"_fma"``
    for the CUDA-core body."""
    draw = "" if rng_mode == "counter" else "_" + rng_mode
    return ("device" if dev else "ideal") + draw + ("_fma" if body == "fma" else "")


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    return _bind(_build.build(name, SOURCES[name]).path, name)


def _bind(path, name: str):
    """The C entry point of library ``path`` (built from ``SOURCES[name]``),
    its argument types set."""
    lib = ctypes.CDLL(str(path))
    if name == "opa_deposit":
        fn = lib.panther_opa_deposit
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                       ctypes.c_void_p]
    else:
        fn = lib.panther_opa_fused
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_ulonglong] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_planes(planes: torch.Tensor, spec: SliceSpec) -> None:
    if planes.dtype != torch.int8 or planes.dim() != 3 or not planes.is_contiguous():
        raise ValueError(f"planes must be contiguous int8 [S, M, N], got {planes.dtype} {tuple(planes.shape)}")
    S = planes.shape[0]
    if S != spec.n_slices or S > MAX_SLICES:
        raise ValueError(f"planes S={S} vs spec S={spec.n_slices} (at most {MAX_SLICES})")


def _plane_max(spec: SliceSpec):
    return (ctypes.c_int * spec.n_slices)(*spec.plane_max)


def _stuck_words(dev, spec: SliceSpec):
    """Host int[2·S]: the stuck-cell pattern's key words of each slice."""
    words = [w for s in range(spec.n_slices) for w in device_pattern_words(dev.stuck_seed, s)]
    return (ctypes.c_int * len(words))(*words)


# the tensor-core body's stuck-cell masks, one byte of slice bits a cell
# (ref.stuck_bits_ref), by (card, stuck_seed, f32 stuck_frac, S, M, N): the
# mask is frozen, so the first launch at a block shape writes it and later
# launches read it. A memo of a pure function of its key: which caller
# fills an entry changes no result.
_STUCK_BITS: dict = {}


def _ptr(arr) -> ctypes.c_void_p:
    return None if arr is None else ctypes.cast(arr, ctypes.c_void_p)


def _launch(name: str, planes: torch.Tensor, *args) -> None:
    fn = _entry(name)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")


def opa_deposit(planes: torch.Tensor, p_q: torch.Tensor, *, spec: SliceSpec, stuck=None) -> torch.Tensor:
    """planes int8 [S, M, N] updated in place by p_q int32 [M, N], both
    contiguous on one CUDA device; returns ``planes``. ``stuck``: a
    DeviceModel with ``stuck_frac > 0`` (the stuck instance: its stuck
    digits keep their value), or None."""
    if not (planes.is_cuda and p_q.is_cuda) or planes.device != p_q.device:
        raise ValueError("opa_deposit kernel takes CUDA tensors on one device only")
    _check_planes(planes, spec)
    if p_q.dtype != torch.int32 or tuple(p_q.shape) != tuple(planes.shape[1:]) or not p_q.is_contiguous():
        raise ValueError(f"p_q must be contiguous int32 {tuple(planes.shape[1:])}, got {p_q.dtype} {tuple(p_q.shape)}")
    if stuck is not None and not stuck.stuck_frac > 0.0:
        raise ValueError("the stuck instance takes a DeviceModel with stuck_frac > 0")
    mn = p_q.numel()
    if mn == 0:
        return planes
    vec = int(mn % 4 == 0 and planes.data_ptr() % 4 == 0 and p_q.data_ptr() % 16 == 0)
    words = None if stuck is None else _stuck_words(stuck, spec)
    frac = 0.0 if stuck is None else float(np.float32(stuck.stuck_frac))
    _launch("opa_deposit", planes, planes.data_ptr(), p_q.data_ptr(), mn, planes.shape[2], spec.n_slices,
            _ptr(_plane_max(spec)), spec.canonical_limit, vec, frac, _ptr(words))
    opa_deposit.launches += 1
    opa_deposit.instances["ideal" if stuck is None else "stuck"] += 1
    return planes


def opa_fused(planes: torch.Tensor, x: torch.Tensor, dh: torch.Tensor, lr: float,
              frac_bits: torch.Tensor, *, spec: SliceSpec, key_words=None, rng_mode: str = "counter",
              offset: int = 0, dev=None, noise_words=None, body=None) -> torch.Tensor:
    """planes int8 [S, M, N] updated in place by ``-lr · xᵀdh`` on the
    ``2^-F`` grid; x [T, M] and dh [T, N] contiguous f32 or bf16 (one
    dtype); frac_bits a 1-element int32 tensor read on the device; lr a host
    float; key_words None (round half to even) or two int32 Python ints,
    the key of the stochastic rounding's ``rng_mode`` draw: ``"counter"``,
    ``"grid"`` (at flat index ``offset + row·N + col``: ``offset`` is the
    block's first element in its leaf) or ``"hw"`` (``ref.hw_uniform_ref``);
    the plain version of each draw is ``ref.rounding_u``. ``dev``: None for
    the ideal instance, or a write-nonideal DeviceModel for the device instance, with
    ``noise_words`` the write-noise key words when ``dev.write_noise > 0``.
    ``body``: None takes ``body_for(x.dtype)``; ``"fma"`` runs the CUDA-core
    body on either dtype (the same-work yardstick); ``"mma"`` takes bf16
    only. Returns ``planes``."""
    if not (planes.is_cuda and x.is_cuda and dh.is_cuda and frac_bits.is_cuda):
        raise ValueError("opa_fused kernel takes CUDA tensors only")
    if not (planes.device == x.device == dh.device == frac_bits.device):
        raise ValueError("opa_fused: tensors on different devices")
    _check_planes(planes, spec)
    S, M, N = planes.shape
    if x.dtype not in _OPERAND_DTYPES or dh.dtype != x.dtype:
        raise ValueError(f"x and dh must share a dtype in {list(_OPERAND_DTYPES)}, got {x.dtype}, {dh.dtype}")
    if x.dim() != 2 or dh.dim() != 2 or x.shape[1] != M or dh.shape[1] != N or x.shape[0] != dh.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} / dh {tuple(dh.shape)} do not match planes {tuple(planes.shape)}")
    if not (x.is_contiguous() and dh.is_contiguous()):
        raise ValueError("x and dh must be contiguous")
    if frac_bits.dtype != torch.int32 or frac_bits.numel() != 1:
        raise ValueError("frac_bits must be a 1-element int32 tensor")
    if body is None:
        body = body_for(x.dtype)
    elif body not in ("mma", "fma") or (body == "mma" and x.dtype != torch.bfloat16):
        raise ValueError(f"opa_fused body {body!r} does not take {x.dtype} operands")
    if dev is not None and not dev.writes_nonideal():
        raise ValueError("the device instance takes a write-nonideal DeviceModel (None for the ideal one)")
    if dev is not None and dev.write_noise > 0.0 and noise_words is None:
        raise ValueError("DeviceModel.write_noise requires write-noise key words")
    check_rng_mode(rng_mode, plain=False)
    if not (0 <= offset and offset + M * N <= 2**64):
        raise ValueError(f"opa_fused grid offset {offset} out of the 64-bit counter range")
    if M == 0 or N == 0:
        return planes
    k0, k1 = (0, 0) if key_words is None else key_words
    rng = 0 if key_words is None else _RNG_CODES[rng_mode]
    bm, bn = hw_tiles(M, N) if rng == _RNG_CODES["hw"] else (0, 0)
    offset = offset if rng == _RNG_CODES["grid"] else 0
    physics = stuck = None
    nk0 = nk1 = 0
    if dev is not None:
        physics = (ctypes.c_float * 4)(dev.asym_up, dev.asym_down, dev.write_noise, dev.stuck_frac)
        if dev.write_noise > 0.0:
            nk0, nk1 = noise_words
        if dev.stuck_frac > 0.0:
            stuck = _stuck_words(dev, spec)
    word = 16 if body == "mma" else 8  # bytes of a plane row a thread moves at once
    vec = int(N % word == 0 and planes.data_ptr() % word == 0)
    mask = key = None
    fresh = False
    if stuck is not None and body == "mma":
        key = (planes.device, dev.stuck_seed, float(np.float32(dev.stuck_frac)), S, M, N)
        mask = _STUCK_BITS.get(key)
        fresh = mask is None
        if fresh:
            mask = torch.empty((M, N), dtype=torch.uint8, device=planes.device)
    _launch("opa_fused", planes, planes.data_ptr(), x.data_ptr(), dh.data_ptr(), frac_bits.data_ptr(),
            float(np.float32(lr)), x.shape[0], M, N, S, _ptr(_plane_max(spec)), spec.canonical_limit,
            _OPERAND_DTYPES[x.dtype], int(body == "mma"), rng, k0, k1, offset, bm, bn, vec,
            _ptr(physics), nk0, nk1, _ptr(stuck), None if mask is None else mask.data_ptr(),
            0 if mask is None else 1 if fresh else 2)
    if fresh:  # written by this launch, in stream order before any later one
        _STUCK_BITS[key] = mask
    opa_fused.launches += 1
    opa_fused.instances[instance_name(dev is not None, body, rng_mode if rng else "counter")] += 1
    return planes


opa_deposit.launches = 0
opa_deposit.instances = collections.Counter()
opa_fused.launches = 0
opa_fused.instances = collections.Counter()
