"""CUDA kernels for the sliced-OPA update on Hopper, bound through ``ctypes``
(port of the Pallas kernels ``repro.kernels.sliced_opa.kernel``).

* ``opa_dense`` (``csrc/opa_deposit.cu``) writes a dense gradient ``g``
  ``[M, N]`` (f32 or bf16) into one ``[S, M, N]`` block of digit planes, in
  place, in one pass: ``-lr · g`` on the ``2^-F`` grid, rounded (half to
  even, or by the counter or ``"grid"`` draw under key words) and
  deposited; its ``device`` instances add a write-nonideal device model's
  asymmetry, write noise and stuck cells. ``opa_deposit`` is the same
  kernel on an int32 update already on the grid (the reference's
  ``opa_deposit``); its ``stuck`` instance keeps a device model's stuck
  digits.
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
* ``opa_im2col`` (``csrc/opa_im2col.cu``) is ``opa_fused``'s function on a
  depthwise conv's taps: one ``[S, K, C]`` layer block of planes updated in
  place from the im2col operands ``x [C, T, K]`` / ``dh [C, T, 1]``, one
  launch a layer block where the reference runs one ``[K, 1]`` tile a
  channel; each channel tile rounds under ``fold_in(key, layer·C + c)``,
  derived in the kernel (on a block at an origin, the leaf's channel and
  C). Counter draw or half to even, ideal write; its instances are by
  operand dtype (``"bf16"``, ``"f32"``).

Each source says what bounds it. The libraries build at first use
(``kernels.build``), never at import. On fake tensors
(``kernels.common.is_fake``: the dry run's) a wrapper allocates what its
launch would, records the launch and its work in ``common.fake_work``
and launches nothing; its own counters count real launches only. The
wrappers launch on the current stream and count their launches:
``launches`` over every instance, and ``instances`` by instance
(``instance_name``: ``"ideal"``, ``"device"``, with ``"_grid"``/``"_hw"``
for those draws and ``"_fma"`` for the CUDA-core body, for ``opa_fused``; ``dense_instance`` for ``opa_dense``;
``"ideal"``, ``"stuck"`` for ``opa_deposit``). The stuck-cell mask is
frozen: the device instances of both libraries cache it a byte a cell
(``_STUCK_BITS``).

A launch may update a block of a larger leaf (``origin``, a
``kernels.common.Origin``; one rank's block on a mesh): the kernels take
its first row and column and the layer's column count, and draw every cell
at its global (row, col); None is the whole layer at (0, 0), the launch of
a single device.
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
from repro_torch.kernels.common import (dense_work, deposit_work, fake_work, hw_tiles, im2col_work, is_fake, on_card,
                                        opa_work, whole)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"opa_deposit": [CSRC / "opa_deposit.cu"], "opa_fused": [CSRC / "opa_fused.cu"],
           "opa_im2col": [CSRC / "opa_im2col.cu"]}
MAX_SLICES = 8  # canonical_limit fits int32
_OPERAND_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_RNG_CODES = {mode: 1 + i for i, mode in enumerate(RNG_MODES)}  # finalize.cuh's Rng; 0: half to even
_DENSE_INPUTS = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}  # opa_deposit.cu's Input
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


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


def dense_instance(dtype: torch.dtype, draw: str, dev: bool) -> str:
    """The key of an ``opa_dense`` launch in ``opa_dense.instances``: the
    gradient's dtype (``"f32"``, ``"bf16"``), the rounding (``"rint"`` half
    to even, ``"counter"``, ``"grid"``), then ``"_device"`` for the
    instance with the write physics."""
    return f"{_DTYPE_NAMES[dtype]}_{draw}" + ("_device" if dev else "")


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    return _bind(_build.build(name, SOURCES[name]).path, name)


def _bind(path, name: str):
    """The C entry point of library ``path`` (built from ``SOURCES[name]``),
    its argument types set."""
    lib = ctypes.CDLL(str(path))
    if name == "opa_deposit":
        fn = lib.panther_opa_deposit
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
                       ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [
            ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    elif name == "opa_im2col":
        fn = lib.panther_opa_im2col
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p] + [
            ctypes.c_int] * 3 + [ctypes.c_uint] * 3 + [ctypes.c_int] * 2 + [ctypes.c_uint, ctypes.c_void_p]
    else:
        fn = lib.panther_opa_fused
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_ulonglong] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_planes(planes: torch.Tensor, spec: SliceSpec) -> None:
    if planes.dtype != torch.int8 or planes.dim() != 3 or not planes.is_contiguous():
        raise ValueError(f"planes must be contiguous int8 [S, M, N], got {planes.dtype} {tuple(planes.shape)}")
    S = planes.shape[0]
    if S != spec.n_slices or S > MAX_SLICES:
        raise ValueError(f"planes S={S} vs spec S={spec.n_slices} (at most {MAX_SLICES})")


# the host arrays a launch passes, built once per spec or device model: a
# launch on a small leaf costs its host time
@functools.lru_cache(maxsize=None)
def _plane_max(spec: SliceSpec):
    return (ctypes.c_int * spec.n_slices)(*spec.plane_max)


@functools.lru_cache(maxsize=None)
def _stuck_words(stuck_seed: int, S: int):
    """Host int[2·S]: the stuck-cell pattern's key words of each slice."""
    words = [w for s in range(S) for w in device_pattern_words(stuck_seed, s)]
    return (ctypes.c_int * len(words))(*words)


@functools.lru_cache(maxsize=None)
def _physics(asym_up: float, asym_down: float, write_noise: float, stuck_frac: float):
    return (ctypes.c_float * 4)(asym_up, asym_down, write_noise, stuck_frac)


# the stuck-cell masks, one byte of slice bits a cell (ref.stuck_bits_ref),
# by (card, stuck_seed, f32 stuck_frac, S, M, N, row0, col0): the mask is
# frozen, so the first launch on a block writes it and later launches read
# it. A memo of a pure function of its key: which caller fills an entry
# changes no result.
_STUCK_BITS: dict = {}


def _stuck_mask(planes: torch.Tensor, dev, origin=None):
    """``(key, mask, mask_mode)`` of the stuck-cell mask of a launch on
    planes ``[S, M, N]`` at ``origin`` (None: (0, 0)): mode 2 reads the
    cached mask, mode 1 has the launch write a new one, to be stored under
    ``key`` once launched."""
    S, M, N = planes.shape
    at = (0, 0) if origin is None else (origin.row, origin.col)
    key = (planes.device, dev.stuck_seed, float(np.float32(dev.stuck_frac)), S, M, N) + ((at,) if at != (0, 0) else ())
    mask = _STUCK_BITS.get(key)
    if mask is not None:
        return key, mask, 2
    return key, torch.empty((M, N), dtype=torch.uint8, device=planes.device), 1


def _ptr(arr) -> ctypes.c_void_p:
    return None if arr is None else ctypes.cast(arr, ctypes.c_void_p)


def _launch(name: str, planes: torch.Tensor, *args) -> None:
    fn = _entry(name)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")


def _deposit_launch(planes: torch.Tensor, src: torch.Tensor, spec: SliceSpec, *, frac_bits=None, lr=0.0,
                    rng: int = 0, key_words=None, offset: int = 0, physics=None, dev=None,
                    noise_words=None, origin=None) -> None:
    """One launch of ``csrc/opa_deposit.cu`` on planes ``[S, M, N]`` and its
    input ``src`` ``[M, N]`` (int32 p_q, f32 or bf16 g). ``physics``: None,
    or the device instance's host float[4]; ``dev`` the DeviceModel whose
    stuck cells it keeps; ``origin`` the block's place in its layer."""
    S, M, N = planes.shape
    o = whole(origin, M, N)
    k0, k1 = (0, 0) if key_words is None else key_words
    nk0, nk1 = (0, 0) if noise_words is None else noise_words
    words = key = mask = None
    mode = 0
    if dev is not None and dev.stuck_frac > 0.0:
        words = _stuck_words(dev.stuck_seed, S)
        key, mask, mode = _stuck_mask(planes, dev, o)
    if is_fake(planes):  # the mask allocated as the launch would; nothing launched, nothing kept
        return
    vec = int(M * N % 16 == 0 and planes.data_ptr() % 16 == 0 and src.data_ptr() % 16 == 0
              and (N % 16 == 0 or N == o.cols))
    _launch("opa_deposit", planes, planes.data_ptr(), src.data_ptr(), _DENSE_INPUTS[src.dtype],
            None if frac_bits is None else frac_bits.data_ptr(), float(np.float32(lr)), M * N, N, S,
            _ptr(_plane_max(spec)), spec.canonical_limit, rng, k0, k1, offset, vec, _ptr(physics), nk0, nk1,
            _ptr(words), None if mask is None else mask.data_ptr(), mode, o.row, o.col, o.cols)
    if mode == 1:  # written by this launch, in stream order before any later one
        _STUCK_BITS[key] = mask


def opa_deposit(planes: torch.Tensor, p_q: torch.Tensor, *, spec: SliceSpec, stuck=None) -> torch.Tensor:
    """planes int8 [S, M, N] updated in place by p_q int32 [M, N], both
    contiguous on one CUDA device; returns ``planes``. ``stuck``: a
    DeviceModel with ``stuck_frac > 0`` (the stuck instance: its stuck
    digits keep their value), or None."""
    if not (on_card(planes) and on_card(p_q)) or planes.device != p_q.device:
        raise ValueError("opa_deposit kernel takes CUDA tensors on one device only")
    _check_planes(planes, spec)
    if p_q.dtype != torch.int32 or tuple(p_q.shape) != tuple(planes.shape[1:]) or not p_q.is_contiguous():
        raise ValueError(f"p_q must be contiguous int32 {tuple(planes.shape[1:])}, got {p_q.dtype} {tuple(p_q.shape)}")
    if stuck is not None and not stuck.stuck_frac > 0.0:
        raise ValueError("the stuck instance takes a DeviceModel with stuck_frac > 0")
    if p_q.numel() == 0:
        return planes
    physics = None if stuck is None else _physics(1.0, 1.0, 0.0, stuck.stuck_frac)
    _deposit_launch(planes, p_q, spec, physics=physics, dev=stuck)
    instance = "ideal" if stuck is None else "stuck"
    if is_fake(planes):
        fake_work.add("opa_deposit", instance, deposit_work(*p_q.shape, planes.shape[0], stuck=stuck is not None))
        return planes
    opa_deposit.launches += 1
    opa_deposit.instances[instance] += 1
    return planes


def opa_dense(planes: torch.Tensor, g: torch.Tensor, lr: float, frac_bits: torch.Tensor, *, spec: SliceSpec,
              key_words=None, rng_mode: str = "counter", offset: int = 0, dev=None,
              noise_words=None, origin=None) -> torch.Tensor:
    """planes int8 [S, M, N] updated in place by ``-lr · g`` on the ``2^-F``
    grid, g [M, N] contiguous f32 or bf16 on the planes' CUDA device, read as
    it is; frac_bits a 1-element int32 tensor read on the device; lr a host
    float; key_words None (round half to even) or two int32 Python ints,
    the key of the stochastic rounding's ``rng_mode`` draw: ``"counter"``
    or ``"grid"`` (at flat index ``offset + row·N + col``); ``"hw"`` has no
    dense draw and raises. ``dev``: None for the ideal instance, which
    rounds ``(-lr · g) · 2^F`` as ``quantize`` does, or a write-nonideal
    DeviceModel for the device instance, which rounds ``g · (2^F · -lr)``
    with the physics as ``opa_device_update`` does, ``noise_words`` the
    write-noise key words when ``dev.write_noise > 0``. ``origin``: the
    block's place in its layer (module docstring). Returns ``planes``."""
    if not (on_card(planes) and on_card(g) and on_card(frac_bits)):
        raise ValueError("opa_dense kernel takes CUDA tensors only")
    if not (planes.device == g.device == frac_bits.device):
        raise ValueError("opa_dense: tensors on different devices")
    _check_planes(planes, spec)
    if g.dtype not in _DTYPE_NAMES or tuple(g.shape) != tuple(planes.shape[1:]) or not g.is_contiguous():
        raise ValueError(f"g must be contiguous f32 or bf16 {tuple(planes.shape[1:])}, got {g.dtype} "
                         f"{tuple(g.shape)}")
    if frac_bits.dtype != torch.int32 or frac_bits.numel() != 1:
        raise ValueError("frac_bits must be a 1-element int32 tensor")
    if dev is not None and not dev.writes_nonideal():
        raise ValueError("the device instance takes a write-nonideal DeviceModel (None for the ideal one)")
    if dev is not None and dev.write_noise > 0.0 and noise_words is None:
        raise ValueError("DeviceModel.write_noise requires write-noise key words")
    draw = "rint" if key_words is None else check_rng_mode(rng_mode)
    o = whole(origin, *g.shape)
    if not (0 <= offset and offset + o.rows * o.cols <= 2**64):
        raise ValueError(f"opa_dense grid offset {offset} out of the 64-bit counter range")
    if g.numel() == 0:
        return planes
    physics = None if dev is None else _physics(dev.asym_up, dev.asym_down, dev.write_noise, dev.stuck_frac)
    _deposit_launch(planes, g, spec, frac_bits=frac_bits, lr=lr, rng=_RNG_CODES.get(draw, 0),
                    key_words=key_words, offset=offset if draw == "grid" else 0, physics=physics, dev=dev,
                    noise_words=noise_words, origin=o)
    instance = dense_instance(g.dtype, draw, dev is not None)
    if is_fake(planes):
        fake_work.add("opa_dense", instance, dense_work(*g.shape, planes.shape[0], grad_bytes=g.element_size(),
                                                        draw=draw, dev=dev is not None))
        return planes
    opa_dense.launches += 1
    opa_dense.instances[instance] += 1
    return planes


def opa_fused(planes: torch.Tensor, x: torch.Tensor, dh: torch.Tensor, lr: float,
              frac_bits: torch.Tensor, *, spec: SliceSpec, key_words=None, rng_mode: str = "counter",
              offset: int = 0, dev=None, noise_words=None, body=None, origin=None) -> torch.Tensor:
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
    only. ``origin``: the block's place in its layer (module docstring;
    under ``"hw"`` on the layer's tile grid). Returns ``planes``."""
    if not (on_card(planes) and on_card(x) and on_card(dh) and on_card(frac_bits)):
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
    o = whole(origin, M, N)
    if not (0 <= offset and offset + o.rows * o.cols <= 2**64):
        raise ValueError(f"opa_fused grid offset {offset} out of the 64-bit counter range")
    if M == 0 or N == 0:
        return planes
    k0, k1 = (0, 0) if key_words is None else key_words
    rng = 0 if key_words is None else _RNG_CODES[rng_mode]
    bm, bn = hw_tiles(o.rows, o.cols) if rng == _RNG_CODES["hw"] else (0, 0)
    if bm and (o.row % bm or o.col % bn or M % bm or N % bn):
        raise ValueError(f"opa_fused: block [{M}, {N}] at ({o.row}, {o.col}) is off the hw draw's ({bm}, {bn}) "
                         f"tile grid of its [{o.rows}, {o.cols}] layer")
    offset = offset if rng == _RNG_CODES["grid"] else 0
    physics = stuck = None
    nk0 = nk1 = 0
    if dev is not None:
        physics = _physics(dev.asym_up, dev.asym_down, dev.write_noise, dev.stuck_frac)
        if dev.write_noise > 0.0:
            nk0, nk1 = noise_words
        if dev.stuck_frac > 0.0:
            stuck = _stuck_words(dev.stuck_seed, S)
    mask = key = None
    mode = 0
    if stuck is not None and body == "mma":
        key, mask, mode = _stuck_mask(planes, dev, o)
    instance = instance_name(dev is not None, body, rng_mode if rng else "counter")
    if is_fake(planes):  # the mask allocated as the launch would; nothing launched, nothing kept
        fake_work.add("opa_fused", instance, opa_work(x.shape[0], M, N, S, dev=dev is not None,
                                                      draw=rng_mode if rng else "counter",
                                                      operand_bytes=x.element_size()))
        return planes
    word = 16 if body == "mma" else 8  # bytes of a plane row a thread moves at once
    vec = int(N % word == 0 and planes.data_ptr() % word == 0)
    _launch("opa_fused", planes, planes.data_ptr(), x.data_ptr(), dh.data_ptr(), frac_bits.data_ptr(),
            float(np.float32(lr)), x.shape[0], M, N, S, _ptr(_plane_max(spec)), spec.canonical_limit,
            _OPERAND_DTYPES[x.dtype], int(body == "mma"), rng, k0, k1, offset, bm, bn, vec,
            _ptr(physics), nk0, nk1, _ptr(stuck), None if mask is None else mask.data_ptr(), mode, o.row, o.col,
            o.cols)
    if mode == 1:  # written by this launch, in stream order before any later one
        _STUCK_BITS[key] = mask
    opa_fused.launches += 1
    opa_fused.instances[instance] += 1
    return planes


def opa_im2col(planes: torch.Tensor, x: torch.Tensor, dh: torch.Tensor, lr: float, frac_bits: torch.Tensor, *,
               spec: SliceSpec, key=None, layer: int = 0, origin=None) -> torch.Tensor:
    """planes int8 [S, K, C] (one layer block of a conv-tap leaf) updated in
    place by ``-lr · xᵀdh`` of each channel on the ``2^-F`` grid: x [C, T,
    K] and dh [C, T, 1] contiguous f32 or bf16 (one dtype) on the planes'
    CUDA device; frac_bits a 1-element int32 tensor read on the device; lr a
    host float; key None (round half to even) or the leaf's host key
    (``core.prng``), channel c rounding by the counter draw under
    ``fold_in(key, layer·C + c)`` at its tile's cell (k, 0); ``layer`` the
    block's flat index in the leaf's stack. ``origin``: the block's place
    in the leaf's ``[K, C]`` layer (``common.Origin``; None the whole
    layer): channel c is the leaf's ``origin.col + c``, keyed by the leaf's
    C, and cell k sits at the tile's row ``origin.row + k``. Returns
    ``planes``."""
    if not (on_card(planes) and on_card(x) and on_card(dh) and on_card(frac_bits)):
        raise ValueError("opa_im2col kernel takes CUDA tensors only")
    if not (planes.device == x.device == dh.device == frac_bits.device):
        raise ValueError("opa_im2col: tensors on different devices")
    _check_planes(planes, spec)
    S, K, C = planes.shape
    o = whole(origin, K, C)
    if x.dtype not in _OPERAND_DTYPES or dh.dtype != x.dtype:
        raise ValueError(f"x and dh must share a dtype in {list(_OPERAND_DTYPES)}, got {x.dtype}, {dh.dtype}")
    if x.dim() != 3 or tuple(x.shape[::2]) != (C, K) or tuple(dh.shape) != (C, x.shape[1], 1):
        raise ValueError(f"x {tuple(x.shape)} / dh {tuple(dh.shape)} do not match planes {tuple(planes.shape)}")
    if not (x.is_contiguous() and dh.is_contiguous()):
        raise ValueError("x and dh must be contiguous")
    if frac_bits.dtype != torch.int32 or frac_bits.numel() != 1:
        raise ValueError("frac_bits must be a 1-element int32 tensor")
    if K > 8 or not 0 <= (layer + 1) * o.cols <= 2**32:
        raise ValueError(f"opa_im2col takes K <= 8 taps and a flat tile index under 2^32 (K {K}, layer {layer})")
    if K == 0 or C == 0:
        return planes
    instance = _DTYPE_NAMES[x.dtype]
    if is_fake(planes):
        fake_work.add("opa_im2col", instance, im2col_work(C, x.shape[1], K, S, x.element_size()))
        return planes
    k0, k1 = (0, 0) if key is None else (key[0] & 0xFFFFFFFF, key[1] & 0xFFFFFFFF)
    _launch("opa_im2col", planes, planes.data_ptr(), x.data_ptr(), dh.data_ptr(), frac_bits.data_ptr(),
            float(np.float32(lr)), x.shape[1], K, C, S, _ptr(_plane_max(spec)), spec.canonical_limit,
            _OPERAND_DTYPES[x.dtype], 0 if key is None else _RNG_CODES["counter"], k0, k1, layer, o.row, o.col,
            o.cols)
    opa_im2col.launches += 1
    opa_im2col.instances[instance] += 1
    return planes


opa_deposit.launches = 0
opa_deposit.instances = collections.Counter()
opa_dense.launches = 0
opa_dense.instances = collections.Counter()
opa_fused.launches = 0
opa_fused.instances = collections.Counter()
opa_im2col.launches = 0
opa_im2col.instances = collections.Counter()
