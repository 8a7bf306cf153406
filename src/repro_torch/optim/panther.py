"""PANTHER crossbar state (port of the serving half of
``repro.optim.panther``): slicing a param tree into int8 digit planes,
reading it back, and the forward-only fidelity wrap for serving.

The update family (``update``/``update_split``, the OPA deposit kernels, CRS)
belongs to the training slice.

Layout: a ``SlicedTensor``'s planes are ``[S, *stack, M, N]`` as in the
reference, but a stacked leaf's storage is laid out ``[*stack, S, M, N]``
(the planes tensor is a permuted view). The serving wrap moves S behind the
stack dims, as the reference's ``_fid_leaves`` does, and here that move is
free: each layer's ``[S, M, N]`` planes come out contiguous, ready for the
kernel, with no copy of the ~16 GB plane state of gemma-2b.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import tree
from repro_torch.core.fixed_point import choose_frac_bits, quantize
from repro_torch.core.slicing import DEFAULT_SPEC, SliceSpec, dequantize_planes, slice_weights
from repro_torch.models.common import XbarWeight
from repro_torch.plan import default_rules, resolve_plan

# elements sliced per chunk: bounds the int32 temporaries of slicing a large
# leaf (the 256000 x 2048 embedding, an [18, 2048, 16384] layer stack)
_SLICE_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class PantherConfig:
    spec: SliceSpec = DEFAULT_SPEC
    min_ndim: int = 2  # crossbar-map params with ndim >= this
    min_dim: int = 8  # ... and every matrix dim >= this
    margin_bits: int = 2  # headroom when choosing the per-tensor scale
    compute_dtype: Any = torch.float32


class SlicedTensor(NamedTuple):
    """Crossbar state of one mapped parameter."""

    planes: torch.Tensor  # int8 [S, *shape]
    frac_bits: torch.Tensor  # int32 0-d: weight grid = 2^-F


def _default_plan(params, cfg: PantherConfig):
    return resolve_plan(params, default_rules(cfg))


def _slice_leaf(p: torch.Tensor, spec: SliceSpec, margin_bits: int) -> SlicedTensor:
    """One frac_bits for the whole leaf (stack included), then quantize and
    slice chunk by chunk into ``[*stack, S, M, N]`` storage."""
    f = choose_frac_bits(p, margin_bits=margin_bits)
    stack, (M, N) = p.shape[:-2], p.shape[-2:]
    S = spec.n_slices
    store = torch.empty((*stack, S, M, N), dtype=torch.int8, device=p.device)
    mats = p.reshape(-1, M, N)
    store3 = store.view(-1, S, M, N)
    rows = max(1, _SLICE_CHUNK // max(N, 1))
    for l in range(mats.shape[0]):
        for r0 in range(0, M, rows):
            q = quantize(mats[l, r0:r0 + rows], f)
            store3[l, :, r0:r0 + rows] = slice_weights(q, spec)
    planes = store.movedim(len(stack), 0)  # [S, *stack, M, N] view
    return SlicedTensor(planes=planes, frac_bits=f)


def init_split(params, cfg: PantherConfig = PantherConfig(), plan=None):
    """-> (digital, sliced): complementary trees (None at the other's
    leaves). ``plan`` decides the partition and per-leaf spec; ``None``
    resolves the default plan from ``cfg``. The caller may free ``params``
    afterwards: nothing here keeps a reference to the float leaves."""
    if plan is None:
        plan = _default_plan(params, cfg)
    digital = tree.map(lambda p, pl: None if pl.mapped else p, params, plan)
    sliced = tree.map(
        lambda p, pl: _slice_leaf(p, pl.spec, cfg.margin_bits) if pl.mapped else None,
        params, plan,
    )
    return digital, sliced


def materialize_split(digital, sliced, cfg: PantherConfig = PantherConfig()):
    """Rebuild the compute-dtype param tree (the crossbar read = dequantize)."""
    def pick(d, s):
        if s is None:
            return d
        return dequantize_planes(s.planes, s.frac_bits, cfg.spec, dtype=cfg.compute_dtype)

    return tree.map(pick, digital, sliced)


def _fid_leaves(s: SlicedTensor, stack: tuple):
    """Planes/frac_bits of one leaf laid out for the layer loop: S moves
    behind the stack dims and frac_bits broadcasts over the stack."""
    planes = s.planes.movedim(0, len(stack))
    frac = s.frac_bits.expand(stack)
    return planes, frac


def fidelitize(params, sliced, plan):
    """Forward-only fidelity wrap for serving: each operand-eligible leaf with
    a resolved ``plan.fidelity`` becomes ``XbarWeight(None, planes,
    frac_bits, fid)`` so prefill/decode read the crossbar through the
    finite-ADC engine; leaves without one stay dense. The dense copy of a
    wrapped leaf is dropped unless ``fid.fwd`` is off."""
    def wrap(path, p, s, pl):
        fid = pl.fidelity if pl.grad == "operand" else None
        if s is None or fid is None:
            return p
        planes, frac = _fid_leaves(s, tuple(p.shape[:-2]))
        return XbarWeight(None if fid.fwd else p, planes, frac, fid)

    return tree.map_with_path(wrap, params, sliced, plan)
