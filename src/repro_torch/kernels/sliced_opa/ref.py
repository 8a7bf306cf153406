"""Plain PyTorch versions of the sliced-OPA kernels (port of
``repro.kernels.sliced_opa.ref``).

``opa_fused_ref`` follows the reference's KERNEL path, not its CPU
dispatch: the operands widen to f32 and the contraction accumulates in f32
(``src/repro/kernels/sliced_opa/kernel.py``), where the reference's CPU
oracle contracts in the operand dtype. The finalize is the kernel's, in its
physical order: ``y = acc · (-lr · 2^F)``; with a device model the
asymmetry gain on the sign of ``y`` and the write noise ``σ_w · gauss(r,
c)``; then ``floor(y + u)`` under key words or ``round(y)`` without,
saturation to int32, the digit deposit, and last the stuck-cell mask (stuck
cells keep their old digit). ``u`` is the draw of ``rng_mode``
(``rounding_u``): the counter hash at (row, col), the ``"grid"`` stream of
``jax.random.uniform`` at the flat index, or the ``"hw"`` Philox stream of
the port's kernel (``hw_uniform_ref``). Each product and sum rounds to f32 on its own,
as in the reference's source and its jnp oracle. ``opa_dense_ref`` is the
dense write's (the reference's ``quantize`` and ``opa_deposit``, or its
``opa_device_update``) on one block. The CPU tests run these versions, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.

Every draw is a function of the cell's global (row, col) in its leaf's
``[M, N]`` layer. A block of a layer (one rank's block on a mesh) takes its
``kernels.common.Origin``: its cells draw at ``(origin.row + r, origin.col
+ c)``, the ``"grid"`` stream at ``offset + row·origin.cols + col``, the
``"hw"`` stream on the layer's tile grid, so the block's update equals the
same block of the whole layer's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fixed_point import (
    _U24,
    WRITE_NOISE_FOLD,
    _f32_to_i32,
    check_rng_mode,
    _fmix32,
    counter_gauss,
    counter_u01,
    device_pattern_words,
    exp2i,
    quantize,
)
from repro_torch.core.opa import opa_batched
from repro_torch.core.prng import counter_key_scalars, fold_in, uniform
from repro_torch.core.slicing import SliceSpec
from repro_torch.kernels.common import Origin, hw_tiles, whole

_MASK = 0xFFFFFFFF


def opa_deposit_ref(planes, p_q, spec: SliceSpec):
    """planes int8 [S, ...], p_q int32 [...] -> int8 [S, ...]."""
    return opa_batched(planes, p_q, spec)


def _lr32(lr) -> float:
    """The learning rate rounded to f32, as the reference's f32 ``lr``."""
    return float(np.float32(lr))


def _f32(v) -> float:
    return float(np.float32(v))


def _coords(r0: int, rows: int, cols: int, device, c0: int = 0):
    r = torch.arange(r0, r0 + rows, dtype=torch.int32, device=device)[:, None]
    c = torch.arange(c0, c0 + cols, dtype=torch.int32, device=device)[None, :]
    return r, c


def _mulhilo(a: int, b: torch.Tensor) -> tuple:
    """(hi, lo) words of the 64-bit product of the constant ``a`` and the
    uint32 values ``b`` (int64 lanes), in 16-bit halves: ``a · b`` itself
    would overflow int64."""
    t = a * (b & 0xFFFF)
    u = a * (b >> 16) + (t >> 16)
    return u >> 16, ((u & 0xFFFF) << 16) | (t & 0xFFFF)


def philox4x32_10(ctr: tuple, k0, k1) -> tuple:
    """Philox4x32-10 (Random123's constants) of the four counter words
    ``ctr`` under key ``(k0, k1)``, uint32 values in int64 lanes (tensors or
    ints): ``philox4x32_10`` of ``counter.cuh``."""
    c0, c1, c2, c3 = ctr
    for i in range(10):
        if i > 0:
            k0, k1 = (k0 + 0x9E3779B9) & _MASK, (k1 + 0xBB67AE85) & _MASK
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def hw_uniform_ref(k0: int, k1: int, M: int, N: int, device=None, *, r0: int = 0, rows: int | None = None,
                   c0: int = 0, cols: int | None = None) -> torch.Tensor:
    """The ``"hw"`` draw of an ``[M, N]`` block under the int32 key words
    ``(k0, k1)``, f32 ``[M, N]``: tile ``tid = (r // bm)·(N // bn) + c // bn``
    (``hw_tiles``) seeds Philox4x32-10 with key ``(fmix32(k0 ^ fmix32(k1 ^
    tid)), 0)``; the in-tile cell ``e = (r % bm)·bn + c % bn`` takes word
    ``e % 4`` of counter ``(e // 4, 0, 0, 0)``, as ``(word >> 8) · 2^-24``.
    ``hw_u01`` of ``counter.cuh``, bit for bit. ``r0``/``rows`` and
    ``c0``/``cols`` pick a block of the layer (default the whole)."""
    bm, bn = hw_tiles(M, N)
    rows = M - r0 if rows is None else rows
    cols = N - c0 if cols is None else cols
    r, c = _coords(r0, rows, cols, device, c0)
    tid = (r // bm) * (N // bn) + c // bn
    seed = _fmix32(k0 ^ _fmix32(tid ^ k1)).to(torch.int64) & _MASK
    e = ((r % bm) * bn + c % bn).to(torch.int64)
    zero = torch.zeros_like(e)
    words = philox4x32_10((e >> 2, zero, zero, zero), seed, 0)
    w = (e & 3).expand(rows, cols)
    word = torch.where(w == 0, words[0], torch.where(w == 1, words[1], torch.where(w == 2, words[2], words[3])))
    return (word >> 8).to(torch.float32) * _U24


def rounding_u(key_words, rng_mode: str, r0: int, rows: int, N: int, *, offset: int = 0, M=None,
               device=None, c0: int = 0, ld: int | None = None) -> torch.Tensor:
    """The U[0, 1) rounding draw of the ``[rows, N]`` cells at rows ``r0..``
    and columns ``c0..`` of an ``[M, ld]`` layer (``M`` defaults to ``r0 +
    rows``, ``ld`` to ``c0 + N``) under the int32 key words: ``"counter"``
    the hash at (row, col); ``"grid"`` ``jax.random.uniform``'s stream at
    flat index ``offset + row·ld + col`` (``offset`` the layer's first
    element in its leaf); ``"hw"`` ``hw_uniform_ref``'s tile stream."""
    ld = c0 + N if ld is None else ld
    if check_rng_mode(rng_mode, plain=False) == "hw":
        return hw_uniform_ref(*key_words, r0 + rows if M is None else M, ld, device, r0=r0, rows=rows, c0=c0,
                              cols=N)
    if rng_mode == "grid":
        if ld == N:
            return uniform(key_words, (rows, N), offset=offset + r0 * N, device=device)
        span = uniform(key_words, ((rows - 1) * ld + N,), offset=offset + r0 * ld + c0, device=device)
        return span.as_strided((rows, N), (ld, 1)).clone()
    r, c = _coords(r0, rows, N, device, c0)
    return counter_u01(r, c, *key_words)


def write_rows(y: torch.Tensor, device, r0: int = 0, noise_words=None, key_words=None, *,
               rng_mode: str = "counter", offset: int = 0, M=None, c0: int = 0, ld: int | None = None) -> torch.Tensor:
    """The update's finalize before the deposit, on the cells at rows
    ``r0..`` and columns ``c0..`` of an ``[M, ld]`` layer: ``y`` f32 ``[rows,
    N]`` the grid-scaled increment; ``device`` a DeviceModel or None;
    ``noise_words`` / ``key_words`` the int32 key words of the write noise /
    the rounding draw (None: no noise / round half to even), the draw
    ``rounding_u``'s of ``rng_mode``, ``offset``, ``M`` and ``ld`` -> int32
    ``[rows, N]``."""
    r, c = _coords(r0, *y.shape, y.device, c0)
    if device is not None and (device.asym_up != 1.0 or device.asym_down != 1.0):
        y = torch.where(y >= 0.0, y * _f32(device.asym_up), y * _f32(device.asym_down))
    if device is not None and device.write_noise > 0.0:
        if noise_words is None:
            raise ValueError("DeviceModel.write_noise requires a PRNG key")
        y = y + counter_gauss(r, c, *noise_words) * _f32(device.write_noise)
    if key_words is not None:
        y = torch.floor(y + rounding_u(key_words, rng_mode, r0, *y.shape, offset=offset, M=M, device=y.device,
                                       c0=c0, ld=ld))
    else:
        y = torch.round(y)
    lim = float(2**31 - 1)
    return _f32_to_i32(torch.clamp(y, -lim, lim))


def stuck_rows(device, spec: SliceSpec, r0: int, rows: int, cols: int, on=None, c0: int = 0) -> torch.Tensor:
    """The frozen per-slice stuck-cell mask of the cells at rows ``r0..``
    and columns ``c0..`` of a layer: bool ``[S, rows, cols]``, slice ``s``
    keyed by ``device_pattern_words(stuck_seed, s)``, on torch device
    ``on``. The same on every layer."""
    r, c = _coords(r0, rows, cols, on, c0)
    frac = _f32(device.stuck_frac)
    return torch.stack([counter_u01(r, c, *device_pattern_words(device.stuck_seed, s)) < frac
                        for s in range(spec.n_slices)])


def stuck_bits_ref(device, spec: SliceSpec, rows: int, cols: int, on=None, *, r0: int = 0,
                   c0: int = 0) -> torch.Tensor:
    """The stuck-cell mask of an ``[rows, cols]`` block at ``(r0, c0)``
    packed a byte a cell, bit ``s`` set where slice ``s`` is stuck: the mask
    K1's tensor-core body caches (``kernel._STUCK_BITS``). uint8 ``[rows,
    cols]``."""
    mask = stuck_rows(device, spec, r0, rows, cols, on, c0)
    bits = torch.zeros((rows, cols), dtype=torch.int32, device=mask.device)
    for s in range(spec.n_slices):
        bits |= mask[s].to(torch.int32) << s
    return bits.to(torch.uint8)


def deposit_keep_ref(planes, p_q, bits, spec: SliceSpec):
    """The deposit of int32 ``p_q`` into planes int8 ``[S, rows, cols]``
    whose slices with a set bit in the packed mask ``bits`` (uint8 ``[rows,
    cols]``, as ``stuck_bits_ref``) keep their old digit: ``deposit_keep``
    of ``deposit.cuh``."""
    keep = torch.stack([(bits.to(torch.int32) >> s) & 1 for s in range(spec.n_slices)]).bool()
    return torch.where(keep, planes, opa_batched(planes, p_q, spec))


def stuck_mask_ref(device, spec: SliceSpec, shape, on=None) -> torch.Tensor:
    """The stuck-cell mask for planes of ``shape`` ``[S, *stack, M, N]``,
    broadcast over the stack: bool ``[S, 1, ..., M, N]``."""
    S, (M, N) = shape[0], shape[-2:]
    mask = stuck_rows(device, spec, 0, M, N, on)
    return mask.reshape((S,) + (1,) * (len(shape) - 3) + (M, N))


def layer_key_words(key, l: int, stacked: bool):
    """The int32 key words layer ``l`` of a leaf draws under: ``fold_in(key,
    l)`` on a stacked leaf, ``key`` itself otherwise; None for no key."""
    return None if key is None else counter_key_scalars(fold_in(key, l) if stacked else key)


def layer_rounding(key, l: int, stacked: bool, rng_mode: str, M: int, N: int) -> tuple:
    """``(key_words, offset)`` of layer ``l``'s rounding draw, for ``[M, N]``
    layers: ``"grid"`` draws one stream over the whole leaf, so every layer
    takes the leaf key and starts at flat offset ``l·M·N``; ``"counter"``
    and ``"hw"`` key each layer of a stack by ``fold_in(key, l)``.
    ``(None, 0)`` without a key (round half to even)."""
    if key is None:
        return None, 0
    if rng_mode == "grid":
        return counter_key_scalars(key), l * M * N
    return layer_key_words(key, l, stacked), 0


def write_device(y: torch.Tensor, device, *, key, stochastic: bool, rng_mode: str = "counter") -> torch.Tensor:
    """Asymmetry, write noise and the rounding on the grid-scaled increment
    ``y`` ``[*stack, M, N]`` -> int32: layer ``l`` of a stack draws its
    noise under ``fold_in(fold_in(key, WRITE_NOISE_FOLD), l)`` and its
    rounding as ``layer_rounding`` says. ``"hw"`` has no plain draw here and
    raises, as the reference's ``rounding_noise`` does."""
    if stochastic:
        check_rng_mode(rng_mode)
    if (stochastic or device.write_noise > 0.0) and key is None:
        raise ValueError("stochastic rounding and DeviceModel.write_noise require a PRNG key")
    M, N = y.shape[-2:]
    stacked = y.dim() > 2
    y3 = y.reshape(-1, M, N)
    dk = fold_in(key, WRITE_NOISE_FOLD) if device.write_noise > 0.0 else None
    out = torch.empty(y3.shape, dtype=torch.int32, device=y.device)
    for l in range(y3.shape[0]):
        words, offset = layer_rounding(key if stochastic else None, l, stacked, rng_mode, M, N)
        out[l] = write_rows(y3[l], device, 0, layer_key_words(dk, l, stacked), words, rng_mode=rng_mode,
                            offset=offset)
    return out.reshape(y.shape)


def opa_fused_ref(planes, x, dh, lr, frac_bits, spec: SliceSpec, key_words=None, device=None,
                  noise_words=None, *, rng_mode: str = "counter", offset: int = 0, origin=None):
    """planes int8 [S, M, N]; x [T, M] and dh [T, N] (any float dtype);
    ``lr`` a host float; ``frac_bits`` the weight grid exponent F;
    ``key_words`` None (round half to even) or two int32 Python ints, the
    key of the ``rng_mode`` draw (``rounding_u``; ``offset`` the layer's
    flat offset in its leaf under ``"grid"``); ``device`` a write-nonideal
    DeviceModel or None, with ``noise_words`` the write-noise key words;
    ``origin`` the block's ``Origin`` in its layer (None: the whole layer)
    -> new int8 planes [S, M, N]."""
    acc = x.to(torch.float32).T @ dh.to(torch.float32)
    o = whole(origin, *acc.shape)
    scale = exp2i(torch.as_tensor(frac_bits, dtype=torch.int32)).to(acc.device) * -_lr32(lr)
    p_q = write_rows(acc * scale, device, o.row, noise_words, key_words, rng_mode=rng_mode, offset=offset,
                     M=o.rows, c0=o.col, ld=o.cols)
    if device is not None and device.stuck_frac > 0.0:
        bits = stuck_bits_ref(device, spec, *acc.shape, acc.device, r0=o.row, c0=o.col)
        return deposit_keep_ref(planes, p_q, bits, spec)
    return opa_batched(planes, p_q, spec)


def opa_im2col_ref(planes, x, dh, lr, frac_bits, spec: SliceSpec, key=None, layer: int = 0, *,
                   rng_mode: str = "counter", device=None, noise_key=None, origin=None):
    """The reference's route for a conv-tap layer block: planes int8 ``[S,
    K, C]``, x ``[C, T, K]``, dh ``[C, T, 1]`` -> new int8 planes. Channel
    c is the ``[K, 1]`` tile ``planes[:, :, c]`` of the channel-as-stack
    view, flat stack index ``i = layer·C + c``, updated by ``opa_fused_ref``
    with ``layer_rounding(key, i)``'s draw (``key`` None: half to even) and,
    with a write-nonideal ``device``, the write noise under
    ``fold_in(noise_key, i)``. ``origin``: the block's place in the leaf's
    ``[K, C]`` layer (None the whole layer): channel c is the leaf's
    ``origin.col + c`` (``i`` with the leaf's C) and its cells sit at the
    tile's rows ``origin.row + k``. ``kernel.opa_im2col``'s plain version
    (the counter draw and half to even on the ideal write)."""
    K, C = planes.shape[-2:]
    row0, col0, K_leaf, C_leaf = (0, 0, K, C) if origin is None else (origin.row, origin.col, origin.rows,
                                                                       origin.cols)
    tile = None if K_leaf == K else Origin(row0, 0, K_leaf, 1)
    out = planes.clone()
    for c in range(C):
        i = layer * C_leaf + col0 + c
        words, offset = layer_rounding(key, i, True, rng_mode, K_leaf, 1)
        out[:, :, c:c + 1] = opa_fused_ref(planes[:, :, c:c + 1], x[c], dh[c], lr, frac_bits, spec, words, device,
                                           layer_key_words(noise_key, i, True), rng_mode=rng_mode, offset=offset,
                                           origin=tile)
    return out


def dense_increment(g: torch.Tensor, lr, frac_bits, device=None) -> torch.Tensor:
    """The grid-scaled increment of a dense gradient, f32: ``(-lr · g) ·
    2^F`` for the ideal write, rounded twice as the reference's dense path
    (``quantize(-lr · g, F)``) rounds it; ``g · (2^F · -lr)`` with a
    write-nonideal ``device``, once, as its ``opa_device_update``. They
    differ only where ``-lr · g`` is subnormal."""
    p2f = exp2i(torch.as_tensor(frac_bits, dtype=torch.int32)).to(g.device)
    if device is None:
        return (-_lr32(lr) * g.to(torch.float32)) * p2f
    return g.to(torch.float32) * (p2f * -_lr32(lr))


def opa_dense_ref(planes, g, lr, frac_bits, spec: SliceSpec, key_words=None, device=None, noise_words=None, *,
                  rng_mode: str = "counter", offset: int = 0, r0: int = 0, origin=None):
    """The dense write of rows ``r0..`` of one ``[M, N]`` block: planes int8
    ``[S, rows, N]``, g ``[rows, N]`` (any float dtype); ``lr`` a host
    float; ``frac_bits`` F; ``key_words`` None (round half to even) or the
    int32 words of the ``rng_mode`` draw (``"counter"``, or ``"grid"`` at
    flat offset ``offset`` of the layer); ``device`` a write-nonideal
    DeviceModel or None, ``noise_words`` its write-noise key words;
    ``origin`` the block's ``Origin`` in its layer (None: the block is the
    whole layer) -> new int8 planes: the finalize (``write_rows`` of
    ``dense_increment``), the deposit and, on a device with stuck cells, the
    stuck mask. ``kernel.opa_dense``'s plain version."""
    y = dense_increment(g, lr, frac_bits, device)
    row0, col0, ld = (0, 0, None) if origin is None else (origin.row, origin.col, origin.cols)
    p_q = write_rows(y, device, row0 + r0, noise_words, key_words, rng_mode=rng_mode, offset=offset, c0=col0, ld=ld)
    new = opa_batched(planes, p_q, spec)
    if device is not None and device.stuck_frac > 0.0:
        new = torch.where(stuck_rows(device, spec, row0 + r0, *y.shape, y.device, col0), planes, new)
    return new


def opa_fused_update_ref(planes, x, dh, lr, frac_bits, spec: SliceSpec, *,
                         stochastic: bool = False, key=None, rng_mode: str = "counter", device=None):
    """The whole update on any stack: ``opa_batched(planes, q(-lr · xᵀdh))``
    with the contraction in f32, the ``rng_mode`` draw of ``key`` (counter:
    per-layer ``fold_in(key, l)`` over the stack; grid: one stream over the
    whole leaf; hw raises ``ValueError``, as the reference's CPU path does)
    and, with a write-nonideal ``device``, its physics (``write_device``,
    then the stuck mask). planes [S, *stack, M, N]; x [*stack, T, M]; dh
    [*stack, T, N]."""
    g = torch.einsum("...tm,...tn->...mn", x.to(torch.float32), dh.to(torch.float32))
    if device is None or not device.writes_nonideal():
        upd = quantize(-_lr32(lr) * g, frac_bits, stochastic=stochastic, key=key, rng_mode=rng_mode)
        return opa_batched(planes, upd, spec)
    scale = exp2i(torch.as_tensor(frac_bits, dtype=torch.int32)).to(g.device) * -_lr32(lr)
    new = opa_batched(planes, write_device(g * scale, device, key=key, stochastic=stochastic,
                                           rng_mode=rng_mode), spec)
    if device.stuck_frac > 0.0:
        new = torch.where(stuck_mask_ref(device, spec, planes.shape, new.device), planes, new)
    return new
