"""PANTHER sliced SGD (port of ``repro.optim.panther``): slicing a param
tree into int8 digit planes, reading it back, the fidelity wraps for serving
(``fidelitize``) and training (``operandize``), and the two forms of the
update: ``init``/``materialize``/``update`` on a ``PantherState`` (params
kept beside the planes, digital-VFU momentum and Tiki-Taka; the paper
MLP's optimizer) and the split state of the LM trainer (``init_split``,
``materialize_split``, ``update_split``).

The update quantizes ``-lr · grad`` onto each leaf's ``2^-F`` grid with
stochastic rounding (the ``rng_mode`` draw) and deposits it into the planes:
operand-form gradients through the fused update kernel (``opa_fused``),
dense gradients through the dense-write kernel (``opa_dense``: the
reference's ``quantize`` and ``opa_deposit`` in one pass). Every
``crs_every`` steps the CRS kernel canonicalizes every mapped leaf. The
planes update in place. Vector leaves take plain float SGD. Keys, the
step and the learning rate are host values, so the update makes no device
sync.

A leaf whose plan carries a write-nonideal ``DeviceModel`` writes through
its physics: operand leaves in the fused update kernel, dense-gradient
leaves in the dense write's device instance. Momentum lives in
``update`` only: ``update_split`` refuses it (the reference's ignores
it). An MoE expert bank under ``group="expert"`` is an operand leaf whose
stack is ``(layers, experts)``: its operands carry the expert axis
(``x [L, E, T_e, M]``), and the update writes one block a (layer, expert)
through the same stacked path. A depthwise conv's taps under
``group="im2col"`` are an operand leaf whose operands are im2col patches
(``x [*lead, C, T, K]``, ``dh [*lead, C, T, 1]``): the update deposits
each channel's ``[K, 1]`` outer product into the stored ``[S, *lead, K,
C]`` planes (``opa_im2col_update``: one launch a layer block), and CRS runs
on that stored layout.

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

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import prng
from repro_torch.core.fixed_point import choose_frac_bits, quantize
from repro_torch.core.slicing import (
    DEFAULT_SPEC,
    SliceSpec,
    dequantize_planes,
    slice_weights,
)
from repro_torch.models.common import OperandSlot, OuterProductGrad, XbarWeight, path_str
from repro_torch.plan import default_rules, resolve_plan

# elements sliced per chunk: bounds the int32 temporaries of slicing a large
# leaf (the 256000 x 2048 embedding, an [18, 2048, 16384] layer stack)
_SLICE_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class PantherConfig:
    spec: SliceSpec = DEFAULT_SPEC
    crs_every: int = 1024
    stochastic_round: bool = True
    momentum: float = 0.0  # digital-VFU momentum (``update``; Tiki-Taka rides it)
    min_ndim: int = 2  # crossbar-map params with ndim >= this
    min_dim: int = 8  # ... and every matrix dim >= this
    variant: str = "v2"  # informational: v1 (SGD), v2 (mini-batch), v3 (large-batch)
    margin_bits: int = 2  # headroom when choosing the per-tensor scale
    compute_dtype: Any = torch.float32
    # the stochastic-rounding draw: "counter" (coordinate hash), "grid" (the
    # jax.random.uniform stream of runs from before the counter draw), or
    # "hw" (the update kernel's own Philox stream, on the card only; dense
    # leaves then take "counter", as in the reference)
    rng_mode: str = "counter"


class SlicedTensor(NamedTuple):
    """Crossbar state of one mapped parameter."""

    planes: torch.Tensor  # int8 [S, *shape]
    frac_bits: torch.Tensor  # int32 0-d: weight grid = 2^-F


class PantherState(NamedTuple):
    """The non-split optimizer state: ``step`` a host int, ``sliced`` a
    ``SlicedTensor`` (or None) per param leaf, ``momentum`` an f32 buffer
    (or None) per param leaf."""

    step: int
    sliced: Any
    momentum: Any


def tiki_taka(cfg: PantherConfig = PantherConfig(), beta: float = 0.875) -> PantherConfig:
    """Tiki-Taka-style noise-resilient training (Gokmen & Haensch): the
    gradient accumulates in a digital momentum buffer and the averaged
    update is what is written to the noisy device, so the per-write noise
    averages down by ~sqrt(1/(1-beta)) while the signal accumulates. Rides
    ``PantherConfig.momentum``; operand gradients materialize into the
    buffer; the write keeps the full device physics."""
    return dataclasses.replace(cfg, momentum=beta, variant="tiki-taka")


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


def init(params, cfg: PantherConfig = PantherConfig(), plan=None) -> PantherState:
    """Planes for every mapped leaf (``plan``, default from ``cfg``), zero
    momentum buffers for every leaf when ``cfg.momentum > 0``. Drive the
    state with the same ``plan`` everywhere, as in the reference."""
    if plan is None:
        plan = _default_plan(params, cfg)
    sliced = tree.map(lambda p, pl: _slice_leaf(p, pl.spec, cfg.margin_bits) if pl.mapped else None,
                      params, plan)
    mom = tree.map(lambda p: torch.zeros_like(p) if cfg.momentum > 0 else None, params)
    return PantherState(step=0, sliced=sliced, momentum=mom)


def materialize(params, state: PantherState, cfg: PantherConfig = PantherConfig()):
    """The compute-dtype param tree: mapped leaves dequantized from their
    planes with ``cfg.spec``, the others as they are."""
    return materialize_split(params, state.sliced, cfg)


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
    finite-ADC engine (an MoE expert bank through the grouped read, each
    expert segment at its own ADC); leaves without one stay dense. The
    dense copy of a wrapped leaf is dropped unless ``fid.fwd`` is off, and
    ``params`` may hold None there (``needs_dense``)."""
    def wrap(path, p, s, pl):
        fid = pl.fidelity if pl.grad == "operand" else None
        if s is None or fid is None:
            return p
        planes, frac = _fid_leaves(s, tuple(s.planes.shape[1:-2]))
        return XbarWeight(None if fid.fwd else p, planes, frac, fid)

    return tree.map_with_path(wrap, params, sliced, plan)


# ------------------------------ training wrap --------------------------------


def needs_dense(s, pl) -> bool:
    """Whether a mapped leaf needs its dense (dequantized) copy in the train
    step: every leaf except an operand leaf read through the finite-ADC
    engine in both directions."""
    fid = pl.fidelity if pl.grad == "operand" else None
    return s is not None and not (fid is not None and fid.fwd and fid.bwd)


def operandize(params, sliced, plan, expert_tokens: int | None = None, tokens: int | None = None, cut=None):
    """Wrap each operand leaf of a param tree (``plan.grad == "operand"``,
    mapped) in a train-side ``XbarWeight`` with an ``OperandSlot``: the
    model's backward then leaves ``(x, dh)`` there instead of a dense
    gradient. A leaf with a ``plan.fidelity`` also carries its planes, so
    its forward and its ``dx`` read them through the finite-ADC engine.
    An expert leaf (``plan.group == "expert"``) gets a grouped slot whose
    last stack dim is the expert axis; ``expert_tokens``, the MoE capacity
    tokens a forward (``G · C``), is the token count each expert's operands
    must have (checked as the backward writes the slot). A conv-tap leaf
    (``plan.group == "im2col"``) gets an im2col slot, ``tokens`` (the
    flattened tokens of one forward, ``B·L``) the token count of its
    patches. ``cut`` (path -> a slot's ``OperandSlot.cut`` or None): what
    each slot keeps of its entries (on a mesh, this rank's model block).
    ``params`` may hold None where ``needs_dense`` is False."""
    def wrap(path, p, s, pl):
        if s is None or pl.grad != "operand":
            return p
        stack = tuple(s.planes.shape[1:-2])
        keep = cut(path) if cut is not None else None
        if pl.group == "im2col":
            slot = OperandSlot(stack, tokens=tokens, kind="im2col", cut=keep)
        else:
            grouped = pl.group == "expert"
            slot = OperandSlot(stack, grouped=grouped, tokens=expert_tokens if grouped else None, cut=keep)
        if pl.fidelity is None:
            return XbarWeight(p, None, None, None, slot)
        planes, frac = _fid_leaves(s, stack)
        return XbarWeight(p, planes, frac, pl.fidelity, slot)

    return tree.map_with_path(wrap, params, sliced, plan)


# --------------------------------- update ------------------------------------


def global_grad_norm(grads) -> torch.Tensor:
    """Global L2 norm of a mixed dense/operand gradient tree, in the
    reference's leaf order; operand leaves by the Gram identity."""
    return torch.sqrt(grad_sq_norm(grads))


def grad_sq_norm(grads, keep=None) -> torch.Tensor:
    """The squared L2 norm of a gradient tree, summed in the reference's
    leaf order over the leaves whose path ``keep`` accepts (every leaf
    without it); an f32 zero when it accepts none."""
    leaves = tree.leaves_sorted(grads)
    total = None
    for path, g in leaves:
        if keep is not None and not keep(path):
            continue
        t = g.sq_norm() if isinstance(g, OuterProductGrad) else torch.sum(g.to(torch.float32) ** 2)
        total = t if total is None else total + t
    if total is None:
        g = leaves[0][1]
        total = torch.zeros((), dtype=torch.float32, device=(g.x if isinstance(g, OuterProductGrad) else g).device)
    return total


def _leaf_device(pl):
    if pl is None or pl.fidelity is None or pl.fidelity.device is None:
        return None
    dev = pl.fidelity.device
    return dev if dev.writes_nonideal() else None


def update_split(grads, digital, sliced, step: int, lr: float, cfg: PantherConfig = PantherConfig(),
                 rng=None, plan=None, origins=None):
    """One OPA step on the split state. Returns ``(digital', sliced)``: the
    sliced leaves' planes are updated in place (the same tree comes back),
    the digital leaves are new tensors.

    ``step`` is a host int, ``lr`` a host float, ``rng`` a host key
    (``core.prng``, default ``PRNGKey(0)``). Leaf ``i`` of the gradient tree
    in the reference's order (``jax.tree.flatten``: dict keys sorted, an
    ``OuterProductGrad`` one leaf) rounds under ``fold_in(fold_in(rng,
    step), i)``; under the counter draw a stacked leaf's layer ``l`` under
    ``fold_in(·, l)``, under ``"grid"`` the leaf's one stream from offset
    ``l·M·N``. So the operand and dense pipelines, and the reference, draw
    the same bits.
    A leaf whose plan carries a write-nonideal device model updates through
    its physics (operand leaves in K1, dense leaves in K2's device
    instance). CRS runs on every mapped leaf when ``step %
    crs_every == crs_every - 1``: a host branch; as in the reference, it
    does not hold stuck cells. ``origins`` (path -> ``kernels.common.Origin``,
    on a mesh): where each mapped leaf's planes sit in the whole leaf, so
    that a rank's block draws as that block of the whole update does; a
    leaf not in it is whole."""
    if cfg.momentum > 0:
        raise NotImplementedError("update_split takes no momentum: digital-VFU momentum and Tiki-Taka "
                                  "live in panther.update (PantherState)")
    do_crs = step % cfg.crs_every == cfg.crs_every - 1
    base = prng.fold_in(rng if rng is not None else prng.PRNGKey(0), step)
    lr32 = float(np.float32(lr))
    d_at = dict(tree.leaves_with_path(digital))
    s_at = dict(tree.leaves_with_path(sliced))
    pl_at = dict(tree.leaves_with_path(plan)) if plan is not None else {}
    origins = origins or {}
    new_d = {}
    for i, (path, g) in enumerate(tree.leaves_sorted(grads)):
        s = s_at[path]
        if s is None:
            if isinstance(g, OuterProductGrad):
                g = g.materialize()
            d = d_at[path]
            new_d[path] = (d - lr32 * g.to(d.dtype)).to(d.dtype)
            continue
        _write_leaf(s, g, lr32, prng.fold_in(base, i), pl_at.get(path), cfg, do_crs, origins.get(path))
    return tree.map_with_path(lambda path, d: new_d.get(path, d), digital), sliced


def _write_leaf(s: SlicedTensor, g, lr32: float, key: tuple, pl, cfg: PantherConfig, do_crs: bool,
                origin=None) -> None:
    """One mapped leaf's write, in place: operand gradients through the
    fused update (K1; a conv-tap leaf's im2col operands through its im2col
    entry), dense ones through the dense write (K2,
    ``opa_dense_update``: the quantize and the deposit, or on a
    write-nonideal device its physics, in one pass); then CRS (K3) when
    ``do_crs``. A mesh step at ``data > 1`` hands an operand leaf's block
    here as a dense gradient, its outer product summed over the data axes
    (``train.step._Blocks.operand_block``): K2 then writes it, each layer
    under the rounding and write-noise keys K1 would draw, so the two
    writes agree bit for bit where the f32 sums are exact. The "hw" draw
    exists only inside the fused kernel: dense leaves then take the counter
    draw, as in the reference (so a mesh step under "hw" keeps its operand
    leaves' operands gathered, for K1). ``origin``: the block's place in
    the whole leaf (None: the whole leaf)."""
    from repro_torch.kernels.crs import crs
    from repro_torch.kernels.sliced_opa import opa_dense_update, opa_fused_update, opa_im2col_update

    spec = pl.spec if pl is not None else cfg.spec
    dev = _leaf_device(pl)
    if isinstance(g, OuterProductGrad) and g.kind == "im2col":
        opa_im2col_update(s.planes, g.x, g.dh, lr32, s.frac_bits, spec, stochastic=cfg.stochastic_round, key=key,
                          rng_mode=cfg.rng_mode, device=dev, origin=origin)
    elif isinstance(g, OuterProductGrad):
        opa_fused_update(s.planes, g.x, g.dh, lr32, s.frac_bits, spec,
                         stochastic=cfg.stochastic_round, key=key, rng_mode=cfg.rng_mode, device=dev, origin=origin)
    else:
        opa_dense_update(s.planes, g, lr32, s.frac_bits, spec, stochastic=cfg.stochastic_round, key=key,
                         rng_mode="counter" if cfg.rng_mode == "hw" else cfg.rng_mode, device=dev, origin=origin)
    if do_crs:
        crs(s.planes, spec)


def update(grads, state: PantherState, params, lr: float, cfg: PantherConfig = PantherConfig(),
           rng=None, plan=None):
    """One PANTHER step on a ``PantherState``. Returns ``(params',
    state')``: the planes update in place (``state'.sliced`` is
    ``state.sliced``), the mapped leaves of ``params'`` are dequantized from
    them at the leaf's dtype with ``cfg.spec``, the digital leaves take
    float SGD. ``step`` is a host int, ``lr`` a host float, ``rng`` a host
    key; leaf ``i`` (``jax.tree.flatten`` order) rounds under
    ``fold_in(fold_in(rng, step), i)``. With ``cfg.momentum > 0`` every
    leaf's gradient (an operand gradient materialized) goes through its
    buffer ``m = momentum · m + g`` first, and the write takes ``m``."""
    step = state.step
    do_crs = step % cfg.crs_every == cfg.crs_every - 1
    base = prng.fold_in(rng if rng is not None else prng.PRNGKey(0), step)
    lr32 = float(np.float32(lr))
    p_at = dict(tree.leaves_with_path(params))
    s_at = dict(tree.leaves_with_path(state.sliced))
    m_at = dict(tree.leaves_with_path(state.momentum))
    pl_at = dict(tree.leaves_with_path(plan)) if plan is not None else {}
    new_p, new_m = {}, {}
    for i, (path, g) in enumerate(tree.leaves_sorted(grads)):
        p, s, m = p_at[path], s_at[path], m_at[path]
        momentum = cfg.momentum > 0 and m is not None
        if isinstance(g, OuterProductGrad) and (s is None or momentum):
            g = g.materialize()  # the VFU buffers are dense by nature
        if momentum:
            m = cfg.momentum * m + g
            g = m
        new_m[path] = m
        if s is None:
            new_p[path] = (p - lr32 * g).to(p.dtype)
            continue
        _write_leaf(s, g, lr32, prng.fold_in(base, i), pl_at.get(path), cfg, do_crs)
        new_p[path] = dequantize_planes(s.planes, s.frac_bits, cfg.spec, dtype=p.dtype)
    rebuild = lambda t, by: tree.map_with_path(lambda path, _: by[path], t)  # noqa: E731
    return rebuild(params, new_p), PantherState(step + 1, state.sliced, rebuild(params, new_m))


def saturation_report(state, cfg: PantherConfig = PantherConfig(), plan=None):
    """Per-leaf per-plane saturation fractions (the paper's Fig-9 metric),
    f32 ``[S]``, of a ``PantherState`` or a sliced tree; one plane of one
    layer at a time, so no wide copy of a whole leaf is made."""
    from repro_torch.kernels.common import layer_views

    sliced = state.sliced if isinstance(state, PantherState) else state

    def rep(s, pl=None):
        if s is None:
            return None
        spec = pl.spec if pl is not None else cfg.spec
        views = layer_views(s.planes)
        out = torch.zeros(spec.n_slices, dtype=torch.float32, device=s.planes.device)
        for v in views:
            for k, m in enumerate(spec.plane_max):
                out[k] += (v[k].to(torch.int16).abs() >= m).to(torch.float32).mean()
        return out / len(views)

    if plan is None:
        return tree.map(rep, sliced)
    return tree.map(rep, sliced, plan)
