"""Public entry points of the sliced-OPA update (port of
``repro.kernels.sliced_opa.ops``).

Dispatch is by where the planes lie: CUDA planes launch the kernels once per
layer block, in place, or raise; CPU planes run the plain versions and are
overwritten with their result. There is no fallback from one to the other.
The planes are updated in place on both (the reference returns new arrays):
one resident copy of the ~20 GB plane state of gemma-2b.

Planes are ``[S, *stack, M, N]`` with layer-major storage (see
``optim.panther``). A stacked leaf updates layer by layer. Under the counter
draw (``rng_mode="counter"``) layer ``l`` draws its rounding noise under
``fold_in(key, l)``: the derivation of the dense path's ``counter_uniform``,
so both pipelines draw the same bits. Under ``"grid"`` the leaf draws one
``jax.random.uniform`` stream under its key, layer ``l`` from flat offset
``l·M·N``, as the dense path's ``quantize`` does. ``"hw"`` (the kernel's
Philox tile stream, keyed per layer like counter) runs on CUDA planes only:
on CPU planes it raises, as the reference's CPU path does. Keys are host
words (``core.prng``).

A write-nonideal ``DeviceModel`` (``device``) adds its physics to the
update: asymmetry and write noise before the rounding, the stuck-cell mask
after the deposit. The write noise draws under ``fold_in(key,
WRITE_NOISE_FOLD)``, with the same per-layer ``fold_in(·, l)``. An
all-ideal model runs the ideal update, bit for bit.

A depthwise conv's taps (``opa_im2col_update``) take im2col operands:
planes ``[S, *lead, K, C]``, ``x [*lead, C, T, K]``, ``dh [*lead, C, T,
1]``. Channel c of layer block l is the ``[K, 1]`` tile of the reference's
channel-as-stack view ``[S, *lead, C, K, 1]``, at flat stack index ``l·C +
c``: its keys derive from that index. Under the counter draw or half to
even on the ideal write, CUDA planes take ``kernel.opa_im2col``, one launch
a layer block; the other draws and a write-nonideal device take one
``opa_fused`` launch a channel tile on a channel-major copy of the block
(correct, and slow). CPU planes run ``ref.opa_im2col_ref`` a block.

On a mesh each rank updates its block of a leaf (``origin``, a
``kernels.common.Origin``: the block's first row and column in the leaf's
``[M, N]`` layer, that layer's shape, and the block's layers' flat indices
in the leaf's stack). Every draw then keys on the leaf's coordinates: the
layer keys and grid offsets on the global layer index and ``M·N``, the
counter hash, the write noise and the stuck mask on the global (row, col),
the grid stream at ``offset + row·N + col``, the hw stream on the layer's
tile grid (an origin off that grid raises). So a block's update equals the
same block of the whole leaf's. A conv-tap leaf's im2col entry takes no
origin: the name rules replicate ``conv_w``.

Dense gradients (``opa_dense_update``, ``opa_device_update``) write in one
kernel launch a layer block on CUDA planes: the gradient in, the rounding
draw, the physics and the deposit in one pass, with no update tensor in
device memory. Their plain version, on CPU planes, is ``ref.opa_dense_ref``
a layer block: the reference's ``quantize`` and deposit, or its device
finalize, deposit and stuck mask.
"""
from __future__ import annotations

import torch

from repro_torch.core.fixed_point import WRITE_NOISE_FOLD, check_rng_mode
from repro_torch.core.prng import fold_in
from repro_torch.core.slicing import SliceSpec
from repro_torch.kernels.common import Origin, hw_tiles, layer_views, on_card, whole
from . import kernel as _k
from . import ref as _ref

def _normalize_device(device):
    """None unless some write-path field is non-ideal: an all-ideal
    DeviceModel runs the exact ideal kernels."""
    if device is None or not device.writes_nonideal():
        return None
    return device


def _check_keys(device, stochastic: bool, key, rng_mode: str, *, plain: bool) -> None:
    """The keys the update needs, and its rounding draw: with ``plain`` one
    that has a plain draw (``check_rng_mode``)."""
    if stochastic and key is None:
        raise ValueError("stochastic rounding requires a PRNG key")
    if stochastic:
        check_rng_mode(rng_mode, plain=plain)
    if device is not None and device.write_noise > 0.0 and key is None:
        raise ValueError("DeviceModel.write_noise requires a PRNG key")


def opa_deposit(planes: torch.Tensor, p_q: torch.Tensor, spec: SliceSpec, *, stuck=None) -> torch.Tensor:
    """Saturating digit deposit of int32 ``p_q`` ``[*stack, M, N]`` into
    planes ``[S, *stack, M, N]``, in place; returns ``planes``. ``stuck``:
    a DeviceModel with ``stuck_frac > 0`` whose stuck cells keep their
    digit, or None."""
    if stuck is not None and not stuck.stuck_frac > 0.0:
        stuck = None
    if on_card(planes):
        p3 = p_q.reshape(-1, *p_q.shape[-2:])
        for l, block in enumerate(layer_views(planes)):
            _k.opa_deposit(block, p3[l].contiguous(), spec=spec, stuck=stuck)
        return planes
    if planes.device.type != "cpu":
        raise ValueError(f"no OPA implementation for device {planes.device}")
    new = _ref.opa_deposit_ref(planes, p_q, spec)
    if stuck is not None:
        new = torch.where(_ref.stuck_mask_ref(stuck, spec, planes.shape), planes, new)
    return planes.copy_(new)


def check_origin(origin, m: int, n: int, rng_mode: str | None):
    """``origin`` completed for an ``[m, n]`` block (``common.whole``); under
    the hw draw the block must sit on the layer's tile grid."""
    o = whole(origin, m, n)
    if rng_mode == "hw" and (o.row, o.col) != (0, 0):
        bm, bn = hw_tiles(o.rows, o.cols)
        if o.row % bm or o.col % bn or m % bm or n % bn:
            raise ValueError(f"block [{m}, {n}] at ({o.row}, {o.col}) is off the hw draw's ({bm}, {bn}) tile grid "
                             f"of its [{o.rows}, {o.cols}] layer")
    return o


def opa_fused(planes: torch.Tensor, x: torch.Tensor, dh: torch.Tensor, lr: float, frac_bits,
              spec: SliceSpec, *, key_words=None, rng_mode: str = "counter", offset: int = 0, device=None,
              noise_words=None, origin=None) -> torch.Tensor:
    """One ``[S, M, N]`` block: ``planes <- deposit(planes, q(-lr · xᵀdh ·
    2^F))``, in place; ``key_words``, ``rng_mode``, ``offset``, ``device``,
    ``noise_words`` and ``origin`` (the block's place in its layer, None
    the whole layer) as in ``kernel.opa_fused``."""
    device = _normalize_device(device)
    if key_words is not None:
        check_rng_mode(rng_mode, plain=not on_card(planes))
    origin = check_origin(origin, *planes.shape[1:], rng_mode if key_words is not None else None)
    if on_card(planes):
        frac = torch.as_tensor(frac_bits, dtype=torch.int32, device=planes.device).reshape(1)
        return _k.opa_fused(planes, x.contiguous(), dh.contiguous(), lr, frac, spec=spec, key_words=key_words,
                            rng_mode=rng_mode, offset=offset, dev=device, noise_words=noise_words, origin=origin)
    if planes.device.type != "cpu":
        raise ValueError(f"no OPA implementation for device {planes.device}")
    return planes.copy_(_ref.opa_fused_ref(planes, x, dh, lr, frac_bits, spec, key_words, device, noise_words,
                                           rng_mode=rng_mode, offset=offset, origin=origin))


def opa_fused_update(planes: torch.Tensor, x: torch.Tensor, dh: torch.Tensor, lr: float,
                     frac_bits, spec: SliceSpec, *, stochastic: bool = False, key=None,
                     rng_mode: str = "counter", device=None, origin=None) -> torch.Tensor:
    """The PANTHER update from gradient operands: planes ``[S, *stack, M,
    N]``, x ``[*stack, T, M]``, dh ``[*stack, T, N]``; ``lr`` a host float;
    ``key`` a host key (``core.prng``); ``rng_mode`` the rounding draw
    (module docstring); ``device`` a DeviceModel or None; ``origin`` this
    block's place in the leaf (module docstring; None the whole leaf). In
    place; returns ``planes``. The write noise applies under deterministic
    rounding too."""
    device = _normalize_device(device)
    _check_keys(device, stochastic, key, rng_mode, plain=not on_card(planes))
    stacked = planes.dim() > 3
    m, n = planes.shape[-2:]
    o = whole(origin, m, n)
    x3 = x.reshape(-1, x.shape[-2], m)
    dh3 = dh.reshape(-1, dh.shape[-2], n)
    dk = fold_in(key, WRITE_NOISE_FOLD) if device is not None and device.write_noise > 0.0 else None
    for l, block in enumerate(layer_views(planes)):
        gl = o.layer(l)
        words, offset = _ref.layer_rounding(key if stochastic else None, gl, stacked, rng_mode, o.rows, o.cols)
        opa_fused(block, x3[l], dh3[l], lr, frac_bits, spec, key_words=words, rng_mode=rng_mode, offset=offset,
                  device=device, noise_words=_ref.layer_key_words(dk, gl, stacked), origin=o)
    return planes


def opa_im2col_update(planes: torch.Tensor, x: torch.Tensor, dh: torch.Tensor, lr: float, frac_bits,
                      spec: SliceSpec, *, stochastic: bool = False, key=None, rng_mode: str = "counter",
                      device=None, origin=None) -> torch.Tensor:
    """The PANTHER update of a conv-tap leaf from its im2col operands
    (module docstring): planes ``[S, *lead, K, C]``, x ``[*lead, C, T,
    K]``, dh ``[*lead, C, T, 1]``; ``lr``, ``key``, ``rng_mode`` and
    ``device`` as in ``opa_fused_update``. ``origin``: this block's place
    in the leaf (its first tap row and channel in the leaf's ``[K, C]``
    layer, the layer's K and C, its layers' flat indices; None the whole
    leaf): channel c is the leaf's ``origin.col + c`` and its tile's key
    index ``l·C + origin.col + c`` with the leaf's C, its cells at the
    tile's rows ``origin.row + k``. In place; returns ``planes``."""
    device = _normalize_device(device)
    _check_keys(device, stochastic, key, rng_mode, plain=not on_card(planes))
    if not on_card(planes) and planes.device.type != "cpu":
        raise ValueError(f"no OPA implementation for device {planes.device}")
    K, C = planes.shape[-2:]
    o = whole(origin, K, C)
    T = x.shape[-2]
    x4 = x.reshape(-1, C, T, K)
    dh4 = dh.reshape(-1, C, T, 1)
    rkey = key if stochastic else None
    dk = fold_in(key, WRITE_NOISE_FOLD) if device is not None and device.write_noise > 0.0 else None
    entry = device is None and (rkey is None or rng_mode == "counter")
    for l, block in enumerate(layer_views(planes)):
        gl = o.layer(l)
        if entry and on_card(planes):
            frac = torch.as_tensor(frac_bits, dtype=torch.int32, device=planes.device).reshape(1)
            _k.opa_im2col(block, x4[l].contiguous(), dh4[l].contiguous(), lr, frac, spec=spec, key=rkey, layer=gl,
                          origin=o)
        elif not on_card(planes):
            block.copy_(_ref.opa_im2col_ref(block, x4[l], dh4[l], lr, frac_bits, spec, rkey, gl, rng_mode=rng_mode,
                                            device=device, noise_key=dk, origin=o))
        else:
            im2col_tiles(block, x4[l], dh4[l], lr, frac_bits, spec, gl, rkey, rng_mode=rng_mode, device=device,
                         noise_key=dk, origin=o)
    return planes


def im2col_tiles(block: torch.Tensor, x: torch.Tensor, dh: torch.Tensor, lr: float, frac_bits, spec: SliceSpec,
                 layer: int, key=None, *, rng_mode: str = "counter", device=None, noise_key=None,
                 origin=None) -> torch.Tensor:
    """One ``[S, K, C]`` layer block of a conv-tap leaf (x ``[C, T, K]``, dh
    ``[C, T, 1]``) the reference's way on the card: one ``opa_fused`` launch
    a channel tile, tile c keyed by its flat index ``layer·C + c`` as in
    ``ref.opa_im2col_ref``, each tile ``[S, K, 1]`` contiguous in a
    channel-major copy of the block. Any draw and device model; ``origin``
    as in ``opa_im2col_update`` (each tile then at row ``origin.row`` of
    its ``[K_leaf, 1]`` tile). In place."""
    K, C = block.shape[-2:]
    o = whole(origin, K, C)
    tile_origin = Origin(o.row, 0, o.rows, 1) if o.rows != K else None
    tiles = block.permute(2, 0, 1).contiguous()  # [C, S, K]
    for c in range(C):
        i = layer * o.cols + o.col + c
        words, offset = _ref.layer_rounding(key, i, True, rng_mode, o.rows, 1)
        opa_fused(tiles[c].unsqueeze(-1), x[c].contiguous(), dh[c].contiguous(), lr, frac_bits, spec, key_words=words,
                  rng_mode=rng_mode, offset=offset, device=device, noise_words=_ref.layer_key_words(noise_key, i, True),
                  origin=tile_origin)
    return block.copy_(tiles.permute(1, 2, 0))


def opa_dense_update(planes: torch.Tensor, g: torch.Tensor, lr: float, frac_bits, spec: SliceSpec, *,
                     stochastic: bool = False, key=None, rng_mode: str = "counter", device=None,
                     origin=None) -> torch.Tensor:
    """The PANTHER update from a dense gradient: planes ``[S, *stack, M,
    N]``, g ``[*stack, M, N]``; ``lr`` a host float; ``key`` a host key;
    ``rng_mode`` the rounding draw, ``"counter"`` or ``"grid"`` (``"hw"``
    has no dense draw and raises, as in the reference); ``device`` a
    DeviceModel or None. Without write physics it is the reference's
    ``opa_deposit(planes, quantize(-lr · g, F, stochastic, key,
    rng_mode))``, with them its ``opa_device_update``. On CUDA planes one
    ``opa_dense`` launch a layer block (f32 and bf16 gradients read as they
    are, other dtypes widened to f32 first). ``origin``: this block's place
    in the leaf (module docstring; None the whole leaf). In place; returns
    ``planes``."""
    device = _normalize_device(device)
    _check_keys(device, stochastic, key, rng_mode, plain=True)
    stacked = planes.dim() > 3
    m, n = planes.shape[-2:]
    o = whole(origin, m, n)
    if g.dtype not in (torch.float32, torch.bfloat16):
        g = g.to(torch.float32)
    g3 = g.reshape(-1, m, n)
    dk = fold_in(key, WRITE_NOISE_FOLD) if device is not None and device.write_noise > 0.0 else None
    if not on_card(planes) and planes.device.type != "cpu":
        raise ValueError(f"no OPA implementation for device {planes.device}")
    frac = torch.as_tensor(frac_bits, dtype=torch.int32, device=planes.device).reshape(1)
    for l, block in enumerate(layer_views(planes)):
        gl = o.layer(l)
        words, offset = _ref.layer_rounding(key if stochastic else None, gl, stacked, rng_mode, o.rows, o.cols)
        noise_words = _ref.layer_key_words(dk, gl, stacked)
        if on_card(planes):
            _k.opa_dense(block, g3[l].contiguous(), lr, frac, spec=spec, key_words=words, rng_mode=rng_mode,
                         offset=offset, dev=device, noise_words=noise_words, origin=o)
        else:
            block.copy_(_ref.opa_dense_ref(block, g3[l], lr, frac_bits, spec, words, device, noise_words,
                                           rng_mode=rng_mode, offset=offset, origin=o))
    return planes


def opa_device_update(planes: torch.Tensor, g: torch.Tensor, lr: float, frac_bits, spec: SliceSpec, *,
                      device, stochastic: bool = False, key=None, rng_mode: str = "counter",
                      origin=None) -> torch.Tensor:
    """The dense-gradient update under a write-nonideal ``device``: the
    physics of ``opa_fused_update`` (asymmetry, write noise, rounding,
    deposit, stuck mask) on a materialized gradient ``g`` ``[*stack, M,
    N]``, for the plan leaves whose gradient is dense (the embedding, the
    norm-scale stacks): ``opa_dense_update`` with ``device``. ``"hw"`` has
    no dense draw and raises, as in the reference. Returns ``planes``."""
    if not device.writes_nonideal():
        raise ValueError("opa_device_update takes a write-nonideal DeviceModel")
    return opa_dense_update(planes, g, lr, frac_bits, spec, stochastic=stochastic, key=key, rng_mode=rng_mode,
                            device=device, origin=origin)
