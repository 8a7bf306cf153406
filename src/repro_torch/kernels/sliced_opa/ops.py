"""Public entry points of the sliced-OPA update (port of
``repro.kernels.sliced_opa.ops``).

Dispatch is by where the planes lie: CUDA planes launch the kernels once per
layer block, in place, or raise; CPU planes run the plain versions and are
overwritten with their result. There is no fallback from one to the other.
The planes are updated in place on both (the reference returns new arrays):
one resident copy of the ~20 GB plane state of gemma-2b.

Planes are ``[S, *stack, M, N]`` with layer-major storage (see
``optim.panther``). A stacked leaf updates layer by layer, and layer ``l``
draws its rounding noise under ``fold_in(key, l)``: the derivation of the
dense path's ``counter_uniform``, so both pipelines draw the same bits. Keys
are host words (``core.prng``).
"""
from __future__ import annotations

import torch

from repro_torch.core.prng import counter_key_scalars, fold_in
from repro_torch.core.slicing import SliceSpec
from repro_torch.kernels.common import layer_views
from . import kernel as _k
from . import ref as _ref


def opa_deposit(planes: torch.Tensor, p_q: torch.Tensor, spec: SliceSpec) -> torch.Tensor:
    """Saturating digit deposit of int32 ``p_q`` ``[*stack, M, N]`` into
    planes ``[S, *stack, M, N]``, in place; returns ``planes``."""
    if planes.is_cuda:
        p3 = p_q.reshape(-1, *p_q.shape[-2:])
        for l, block in enumerate(layer_views(planes)):
            _k.opa_deposit(block, p3[l].contiguous(), spec=spec)
        return planes
    if planes.device.type != "cpu":
        raise ValueError(f"no OPA implementation for device {planes.device}")
    return planes.copy_(_ref.opa_deposit_ref(planes, p_q, spec))


def opa_fused(planes: torch.Tensor, x: torch.Tensor, dh: torch.Tensor, lr: float, frac_bits,
              spec: SliceSpec, *, key_words=None) -> torch.Tensor:
    """One ``[S, M, N]`` block: ``planes <- deposit(planes, q(-lr · xᵀdh ·
    2^F))``, in place; ``key_words`` as in ``kernel.opa_fused``."""
    if planes.is_cuda:
        frac = torch.as_tensor(frac_bits, dtype=torch.int32, device=planes.device).reshape(1)
        return _k.opa_fused(planes, x.contiguous(), dh.contiguous(), lr, frac, spec=spec,
                            key_words=key_words)
    if planes.device.type != "cpu":
        raise ValueError(f"no OPA implementation for device {planes.device}")
    return planes.copy_(_ref.opa_fused_ref(planes, x, dh, lr, frac_bits, spec, key_words))


def opa_fused_update(planes: torch.Tensor, x: torch.Tensor, dh: torch.Tensor, lr: float,
                     frac_bits, spec: SliceSpec, *, stochastic: bool = False, key=None,
                     rng_mode: str = "counter", device=None) -> torch.Tensor:
    """The PANTHER update from gradient operands: planes ``[S, *stack, M,
    N]``, x ``[*stack, T, M]``, dh ``[*stack, T, N]``; ``lr`` a host float;
    ``key`` a host key (``core.prng``). In place; returns ``planes``.

    Only the counter draw and the ideal device are ported: ``rng_mode``
    ``"grid"``/``"hw"`` and a ``device`` with write physics raise."""
    if device is not None and device.writes_nonideal():
        raise NotImplementedError("device write physics in the OPA update is not ported yet")
    if stochastic and key is None:
        raise ValueError("stochastic rounding requires a PRNG key")
    if stochastic and rng_mode != "counter":
        raise NotImplementedError(f"rng_mode {rng_mode!r} is not ported; use 'counter'")
    stacked = planes.dim() > 3
    M, N = planes.shape[-2:]
    x3 = x.reshape(-1, x.shape[-2], M)
    dh3 = dh.reshape(-1, dh.shape[-2], N)
    for l, block in enumerate(layer_views(planes)):
        words = None
        if stochastic:
            words = counter_key_scalars(fold_in(key, l) if stacked else key)
        opa_fused(block, x3[l], dh3[l], lr, frac_bits, spec, key_words=words)
    return planes
