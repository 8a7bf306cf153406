"""Shared model components (port of ``repro.models.common``): configs,
the crossbar linear (``xbar_linear``) with its operand-form weight gradient
and its finite-ADC fidelity reads, norms, RoPE, initializers.

Parameters are plain nested dicts of tensors with the JAX trees' layout:
layer groups are stacked on a leading ``[L, ...]`` axis, and a leaf's path is
its keys and list indices joined by '/' (``groups/0/attn/wqkv``).
Initializers draw from an explicit ``torch.Generator`` on the target device
(``jax.random`` streams cannot be reproduced in torch; tests carry JAX
weights across with ``repro_torch.convert``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.slicing import DEFAULT_SPEC, SliceSpec


class ShapeDtype(NamedTuple):
    """Shape and dtype of a tensor not yet allocated (cache specs)."""

    shape: tuple
    dtype: torch.dtype


# ------------------------- operand-form gradients ----------------------------
#
# PANTHER's update is an in-crossbar outer product: the weight gradient of a
# crossbar linear is never formed as a dense [M, N] matrix; the optimizer
# consumes the operands (x, dh) and deposits ``-lr·xᵀdh`` through the fused
# update kernel. A ``torch.autograd.Function`` cannot return such a pair as a
# gradient, so the train-side wrap carries an ``OperandSlot``: the backward
# writes ``(x, dh)`` of its layer there and returns no weight gradient.


class OuterProductGrad:
    """A weight gradient in operand form, ``dW = xᵀ·dh`` unmaterialized.
    ``kind`` names how the pair folds into the crossbar layout:

    * ``"matmul"``: ``x`` ``[*stack, T, M]`` layer inputs, ``dh`` ``[*stack,
      T, N]`` output gradients, leading stack dims one crossbar tile per
      stacked layer (or expert);
    * ``"im2col"``: a depthwise conv's taps, ``x`` ``[*stack, C, T, K]``
      the windowed input patches of each channel, ``dh`` ``[*stack, C, T,
      1]`` its output gradients; the dense gradient is the conv weight's
      ``[*stack, K, C]`` (the channel axis joins the stack: one ``[K, 1]``
      outer product a channel).

    The token axis is -2 for both kinds."""

    __slots__ = ("x", "dh", "kind")
    SQ_NORM_CHUNK = 2048  # token rows per Gram block in sq_norm
    GRAM_ELEMENTS = 1 << 26  # f32 elements of a Gram block in sq_norm (256 MB)

    def __init__(self, x: torch.Tensor, dh: torch.Tensor, kind: str = "matmul"):
        self.x = x
        self.dh = dh
        self.kind = kind

    @property
    def shape(self) -> tuple:
        """Shape of the (virtual) dense gradient, in the weight's layout."""
        if self.kind == "im2col":
            return (*self.x.shape[:-3], self.x.shape[-1], self.x.shape[-3])
        return (*self.x.shape[:-2], self.x.shape[-1], self.dh.shape[-1])

    def materialize(self, dtype=None) -> torch.Tensor:
        """The dense gradient (f32 accumulation) in the weight's layout, for
        the dense fallback."""
        g = torch.einsum("...tm,...tn->...mn", self.x.to(torch.float32), self.dh.to(torch.float32))
        if self.kind == "im2col":
            g = g[..., 0].transpose(-1, -2)  # [*stack, C, K] -> the conv weight's [*stack, K, C]
        return g if dtype is None else g.to(dtype)

    def scale_dh(self, c: float) -> "OuterProductGrad":
        """dW is linear in dh: fold a scalar into it."""
        return OuterProductGrad(self.x, (self.dh.to(torch.float32) * c).to(self.dh.dtype), self.kind)

    def sq_norm(self) -> torch.Tensor:
        """``||xᵀdh||_F^2`` by the Gram identity ``<x xᵀ, dh dhᵀ>_F``,
        without the [M, N] product; token rows in blocks of
        ``SQ_NORM_CHUNK``, and the stack entries (the im2col channels are
        stack entries too: thousands of ``[T, T]`` Grams a layer) in blocks
        of at most ``GRAM_ELEMENTS`` Gram elements."""
        T = self.x.shape[-2]
        x = self.x.to(torch.float32).reshape(-1, T, self.x.shape[-1])
        dh = self.dh.to(torch.float32).reshape(-1, T, self.dh.shape[-1])
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        rows = max(1, min(T, self.SQ_NORM_CHUNK))
        per = max(1, self.GRAM_ELEMENTS // (rows * max(1, T)))
        for l0 in range(0, x.shape[0], per):
            xl, dl = x[l0:l0 + per], dh[l0:l0 + per]
            for t0 in range(0, T, rows):
                gx = torch.einsum("ltm,lsm->lts", xl[:, t0:t0 + rows], xl)
                gh = torch.einsum("ltn,lsn->lts", dl[:, t0:t0 + rows], dl)
                total = total + torch.sum(gx * gh)
        return total


class OperandSlot:
    """Where the backward of a train-side wrap leaves each layer's operands.
    ``stack`` is the wrap's stack shape (``()`` for an unstacked leaf); a
    nested stack (zamba's ``[units, layers]`` mamba leaves) has one entry a
    (unit, layer), in row-major order. A grouped slot (an MoE expert bank,
    ``grouped=True``) keeps its last stack dim, the expert axis, inside each
    entry: a layer's backward puts ``x [E, T_e, M]`` / ``dh [E, T_e, N]`` at
    once, and ``layers`` are the stack dims before it. ``kind`` is the
    operands' (``OuterProductGrad.kind``): an ``"im2col"`` entry is ``x [C,
    T, K]`` / ``dh [C, T, 1]``. ``tokens``, when given, is the token count
    each entry must have (an expert bank's capacity rows, the reference's
    exact cotangent shape). A slot written twice in one backward raises:
    operand gradients do not sum, and each operand weight is used once per
    layer. ``cut``, when given, maps each entry's ``(x, dh)`` to what the
    slot keeps (on a mesh, copies of a rank's block of them, so that the
    backward's whole operands are freed as it goes)."""

    __slots__ = ("stack", "layers", "tokens", "kind", "cut", "x", "dh")

    def __init__(self, stack: tuple = (), grouped: bool = False, tokens: int | None = None,
                 kind: str = "matmul", cut=None):
        self.stack = tuple(stack)
        self.layers = self.stack[:-1] if grouped else self.stack
        self.tokens = tokens
        self.kind = kind
        self.cut = cut
        n = math.prod(self.layers)
        self.x = [None] * n
        self.dh = [None] * n

    @classmethod
    def holding(cls, g: OuterProductGrad, grouped: bool = False, cut=None) -> "OperandSlot":
        """A slot of a matmul leaf with the operands ``g`` (``x [*stack, T,
        M]``, ``dh [*stack, T, N]``; an expert bank's stack ends in its
        expert axis, ``grouped``) put into it entry by entry, as a backward
        puts them."""
        slot = cls(tuple(g.x.shape[:-2]), grouped=grouped, cut=cut)
        n = len(slot.layers)
        x, dh = g.x.reshape(-1, *g.x.shape[n:]), g.dh.reshape(-1, *g.dh.shape[n:])
        for i in range(x.shape[0]):
            slot.put(i, x[i], dh[i])
        return slot

    def put(self, i: int, x: torch.Tensor, dh: torch.Tensor) -> None:
        if self.tokens is not None and x.shape[-2] != self.tokens:
            raise RuntimeError(f"operands of {x.shape[-2]} tokens a tile, expected {self.tokens}")
        if self.x[i] is not None:
            raise RuntimeError(f"operand slot of layer {i} written twice in one backward: "
                               "an operand-form weight must be used once per layer")
        self.x[i], self.dh[i] = (x, dh) if self.cut is None else self.cut(x, dh)

    def drain(self):
        """Each entry's ``(x, dh)`` in order, released from the slot as it
        is yielded."""
        if any(v is None for v in self.x):
            raise RuntimeError("operand slot not filled: a layer's weight was never read")
        for i in range(len(self.x)):
            entry = self.x[i], self.dh[i]
            self.x[i] = self.dh[i] = None
            yield entry
            del entry

    def grad(self) -> OuterProductGrad:
        """The operands as one ``OuterProductGrad`` (layers stacked)."""
        if any(v is None for v in self.x):
            raise RuntimeError("operand slot not filled: a layer's weight was never read")
        if not self.layers:
            return OuterProductGrad(self.x[0], self.dh[0], self.kind)
        x, dh = torch.stack(self.x), torch.stack(self.dh)
        return OuterProductGrad(x.reshape(*self.layers, *x.shape[1:]),
                                dh.reshape(*self.layers, *dh.shape[1:]), self.kind)


# ------------------------ fidelity (finite-ADC) mode -------------------------


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """Non-ideal ReRAM device physics, applied where code touches crossbar
    state: the update's deposit (write path) and the MVM/MᵀVM reads.

    Write path (the finalize of ``kernels.sliced_opa``, in this order):

    * ``asym_up`` / ``asym_down``: gain on positive / negative update
      increments (1.0 / 1.0 is symmetric);
    * ``write_noise``: sigma of Gaussian write noise in weight-grid LSB, a
      counter-hash draw per (row, col) under its own key stream, added
      before the update rounds to the grid;
    * ``stuck_frac`` / ``stuck_seed``: the share of cells stuck at their
      value, a frozen per-slice pattern keyed by ``stuck_seed``. A stuck
      cell keeps its digit through the update, and every read sees it.

    Read path (``kernels.sliced_mvm``): ``read_noise`` is the sigma of a
    frozen per-(crossbar tile, slice, output column) offset relative to the
    slice's ADC full scale, keyed by ``stuck_seed`` and salted apart for the
    MᵀVM read, added to the column current before the ADC.

    ``DeviceModel()`` is all-ideal and runs the ideal kernels.
    """

    write_noise: float = 0.0
    asym_up: float = 1.0
    asym_down: float = 1.0
    stuck_frac: float = 0.0
    stuck_seed: int = 0
    read_noise: float = 0.0

    def writes_nonideal(self) -> bool:
        """True when the write path deviates from the ideal deposit."""
        return (
            self.write_noise > 0.0
            or self.asym_up != 1.0
            or self.asym_down != 1.0
            or self.stuck_frac > 0.0
        )

    def reads_nonideal(self) -> bool:
        return self.read_noise > 0.0


@dataclasses.dataclass(frozen=True)
class FidelityConfig:
    """Crossbar-in-the-loop read configuration: ``io_bits`` DAC width,
    ``adc_bits_fwd``/``adc_bits_bwd`` ADC resolution per read direction
    (``None`` = ideal ADC), ``fwd``/``bwd`` gates (a disabled path takes the
    dense matmul), ``spec`` the plane layout, ``margin_bits`` DAC headroom,
    ``device`` the non-ideal physics (None = ideal), ``shard_dim`` the
    matrix dim of the dense ``[M, N]`` weight the mesh's 'model' axis
    shards for reads on a mesh (0 rows, 1 columns, None replicated;
    ``plan.attach_fidelity_shard_dims`` sets it)."""

    io_bits: int = 16
    adc_bits_fwd: int | None = None
    adc_bits_bwd: int | None = None
    fwd: bool = True
    bwd: bool = True
    spec: SliceSpec = DEFAULT_SPEC
    margin_bits: int = 1
    device: DeviceModel | None = None
    # per-expert-group ADC of a grouped (MoE expert) leaf: ``((count,
    # FidelityConfig | None), ...)`` segments over the expert axis in order,
    # None reading at this config; None = every expert at this config
    expert_groups: tuple | None = None
    shard_dim: int | None = None

    def group_slices(self, n_experts: int):
        """``(start, stop, fid)`` per expert segment, covering ``[0,
        n_experts)``: the declared segments, then the tail at the base
        config (this one, ``expert_groups`` cleared)."""
        base = dataclasses.replace(self, expert_groups=None)
        start = 0
        for count, gfid in self.expert_groups or ():
            stop = min(start + int(count), n_experts)
            if stop > start:
                yield start, stop, (gfid if gfid is not None else base)
            start = stop
        if start < n_experts:
            yield start, n_experts, base


class XbarWeight:
    """A crossbar-mapped weight as the model sees it.

    * ``w``: the dense copy (dequantized planes), or None where no read
      needs it (fidelity reads in both directions);
    * ``planes``/``frac_bits``/``fid``: the int8 digit planes (slice dim
      behind any layer-stack dims), the per-tensor ``frac_bits`` broadcast
      over the stack, and the ``FidelityConfig`` of the finite-ADC reads
      (all None for a lossless train-side wrap);
    * ``slot``: the ``OperandSlot`` of a train-side wrap (None when
      serving), and ``index`` the entry this wrap writes in it.

    Indexing selects one layer of a stacked group; a nested stack is
    indexed one dim at a time (unit, then layer), and ``index`` is then the
    row-major flat index over the slot's ``layers``, the order the
    reference flattens a stack in for its per-layer keys. ``depth`` counts
    the stack dims indexed so far: a train-side wrap reads only once every
    layer dim is indexed."""

    __slots__ = ("w", "planes", "frac_bits", "fid", "slot", "index", "depth")

    def __init__(self, w, planes, frac_bits, fid, slot=None, index=0, depth=0):
        self.w = w
        self.planes = planes
        self.frac_bits = frac_bits
        self.fid = fid
        self.slot = slot
        self.index = index
        self.depth = depth

    def __getitem__(self, i) -> "XbarWeight":
        index = i
        if self.slot is not None:
            if self.depth >= len(self.slot.layers):
                raise IndexError("every layer-stack dim of this wrap is indexed already")
            index = self.index * self.slot.layers[self.depth] + i
        pick = lambda t: None if t is None else t[i]  # noqa: E731
        return XbarWeight(pick(self.w), pick(self.planes), pick(self.frac_bits), self.fid,
                          self.slot, index, self.depth + 1)

    def check_indexed(self) -> None:
        """A train-side wrap reads one layer: every layer dim indexed."""
        if self.depth != len(self.slot.layers):
            raise RuntimeError(f"a wrap indexed over {self.depth} of its {len(self.slot.layers)} stack dims was "
                               "read: index every layer dim first")

    def put(self, x: torch.Tensor, dh: torch.Tensor) -> None:
        """The backward's operands into this wrap's slot entry."""
        self.slot.put(self.index, x, dh)


class LayerStack:
    """A stacked leaf whose layers are made at use: ``stack[i]`` is
    ``make(i)``. On a mesh, a sharded dense weight is all-gathered one layer
    at a time this way (``train.step``), as ``lm.layer`` picks it."""

    __slots__ = ("make",)

    def __init__(self, make):
        self.make = make

    def __getitem__(self, i):
        return self.make(i)


def path_str(path) -> str:
    """'/'-join a key path (dict keys and list indices) — the canonical leaf
    path string of the plan rules, as in the JAX package."""
    return "/".join(str(k) for k in path)


# Param-dict keys consumed through ``xbar_linear`` (each used exactly once per
# layer application). ``embed`` is excluded: it is read by a gather.
OPERAND_LINEAR_KEYS = frozenset(
    {"wqkv", "wq_dkv", "wo", "wi_gate", "wi_up", "w_uk", "w_uv"}
)


def _xbar_read(v: torch.Tensor, ww: XbarWeight, transpose: bool) -> torch.Tensor:
    """``v @ w`` (``v @ wᵀ`` when ``transpose``) in ``v``'s dtype: through
    the finite-ADC engine where the wrap's fidelity reads that direction
    (forward MVM, MᵀVM), else through the dense copy."""
    fid = ww.fid
    if fid is not None and (fid.bwd if transpose else fid.fwd):
        from repro_torch.core.mvm import fidelity_read  # lazy: core stays model-free

        return fidelity_read(ww.planes, ww.frac_bits, v, fid, transpose=transpose).to(v.dtype)
    w = ww.w.to(v.dtype)
    return v @ (w.T if transpose else w)


class _XbarLinear(torch.autograd.Function):
    """``x @ w`` whose backward returns ``dx`` and leaves the weight's
    gradient in operand form: ``(x, dy)`` flattened over tokens go into the
    wrap's slot, and the weight gets no gradient."""

    @staticmethod
    def forward(ctx, x, ww):
        ww.check_indexed()
        ctx.ww = ww
        ctx.save_for_backward(x)
        return _xbar_read(x, ww, transpose=False)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        ww = ctx.ww
        dx = _xbar_read(dy, ww, transpose=True) if ctx.needs_input_grad[0] else None
        ww.put(x.detach().reshape(-1, x.shape[-1]), dy.reshape(-1, dy.shape[-1]))
        return dx, None


def xbar_linear(x: torch.Tensor, w, dtype=None) -> torch.Tensor:
    """``x @ w`` where ``w`` may be a plain tensor or an ``XbarWeight``.

    A plain tensor takes the ordinary matmul with a dense gradient. A
    train-side wrap (with a slot) takes ``_XbarLinear``: forward through the
    finite-ADC engine or the dense copy, backward ``dx`` through the MᵀVM
    read or the dense copy, and the weight gradient as operands in the slot.
    A serving wrap reads forward only. ``dtype`` is the compute dtype (the
    activation dtype at every model site)."""
    if isinstance(w, XbarWeight):
        if dtype is not None:
            x = x.to(dtype)
        if w.slot is not None:
            return _XbarLinear.apply(x, w)
        return _xbar_read(x, w, transpose=False)
    return x @ w.to(dtype if dtype is not None else x.dtype)


# ------------------- grouped (per-expert) crossbar linears -------------------
#
# Each MoE expert is its own crossbar tile: ``y[e] = x[e] @ w[e]`` over the
# per-expert capacity buffers ``x [E, T_e, d]``. The weight gradient keeps
# the expert axis as a stack dim (``x [E, T_e, M]``, ``dh [E, T_e, N]``), so
# the update deposits each expert's own outer product, one block an expert.


def _grouped_fid_read(ww: XbarWeight, v: torch.Tensor, transpose: bool) -> torch.Tensor:
    """Finite-ADC read of every expert tile: one ``fidelity_read`` an
    expert, in expert order, each at its segment's config of
    ``fid.group_slices``, on its own ``[S, M, N]`` planes, with its own
    ``frac_bits`` and its own DAC exponent over its capacity buffer."""
    from repro_torch.core.mvm import fidelity_read  # lazy: core stays model-free

    E = v.shape[0]
    fb = torch.as_tensor(ww.frac_bits, dtype=torch.int32, device=v.device).expand(E)
    outs = [fidelity_read(ww.planes[e], fb[e], v[e], gfid, transpose=transpose)
            for start, stop, gfid in ww.fid.group_slices(E) for e in range(start, stop)]
    return torch.stack(outs)


def _grouped_read(v: torch.Tensor, ww: XbarWeight, transpose: bool) -> torch.Tensor:
    """``v[e] @ w[e]`` (``v[e] @ w[e]ᵀ`` when ``transpose``) in ``v``'s
    dtype: through the grouped finite-ADC read where the wrap's fidelity
    reads that direction, else through the dense copy."""
    fid = ww.fid
    if fid is not None and (fid.bwd if transpose else fid.fwd):
        return _grouped_fid_read(ww, v, transpose).to(v.dtype)
    w = ww.w.to(v.dtype)
    return torch.einsum("ecf,edf->ecd", v, w) if transpose else torch.einsum("ecd,edf->ecf", v, w)


class _XbarGrouped(torch.autograd.Function):
    """``x[e] @ w[e]`` whose backward returns ``dx`` and leaves the weight's
    gradient in operand form with the expert axis kept: ``(x, dy)`` ``[E,
    T_e, ·]`` go into the wrap's grouped slot."""

    @staticmethod
    def forward(ctx, x, ww):
        ww.check_indexed()
        ctx.ww = ww
        ctx.save_for_backward(x)
        return _grouped_read(x, ww, transpose=False)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        ww = ctx.ww
        dx = _grouped_read(dy, ww, transpose=True) if ctx.needs_input_grad[0] else None
        ww.put(x.detach(), dy)
        return dx, None


def xbar_grouped_linear(x: torch.Tensor, w, dtype=None) -> torch.Tensor:
    """Per-expert batched linear ``y[e] = x[e] @ w[e]`` (``ecd,edf->ecf``),
    ``w`` a plain ``[E, d, f]`` tensor or an ``XbarWeight``: a plain tensor
    takes one batched product with a dense gradient; a train-side wrap
    ``_XbarGrouped``; a serving wrap reads forward only, through the
    grouped finite-ADC read (honouring ``fid.expert_groups``) or the dense
    copy."""
    if isinstance(w, XbarWeight):
        if dtype is not None:
            x = x.to(dtype)
        if w.slot is not None:
            return _XbarGrouped.apply(x, w)
        return _grouped_read(x, w, transpose=False)
    return torch.einsum("ecd,edf->ecf", x, w.to(dtype if dtype is not None else x.dtype))


# ------------------- depthwise conv on the crossbar (im2col) -----------------
#
# A depthwise causal conv ``out[b, t, c] = Σ_k xp[b, t + k, c] · w[k, c]``
# maps onto a crossbar as K rows a column (one column a channel). Its weight
# gradient is a sum of per-channel ``[K, 1]`` outer products of the windowed
# input patches and the output gradient: the im2col operand form, deposited
# one channel tile at a time without forming the dense ``[K, C]`` gradient.


def _dwconv_val(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: ``out[b, t, c] = Σ_k xp[b, t + k, c] · w[k,
    c]`` with ``xp`` left-padded ``[B, L + K - 1, C]`` and ``w [K, C]``,
    summed over k in order."""
    K = w.shape[0]
    L = xp.shape[1] - K + 1
    out = xp[:, 0:L] * w[0]
    for k in range(1, K):
        out = out + xp[:, k:k + L] * w[k]
    return out


def _dwconv_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of the depthwise conv: ``dxp[b, t + k, c] += dy[b, t,
    c] · w[k, c]`` over k in order, in ``dy``'s dtype."""
    K = w.shape[0]
    B, L, C = dy.shape
    dxp = torch.zeros((B, L + K - 1, C), dtype=dy.dtype, device=dy.device)
    for k in range(K):
        dxp[:, k:k + L] += dy * w[k]
    return dxp


def _dwconv_operands(xp: torch.Tensor, dy: torch.Tensor) -> tuple:
    """The conv's weight gradient in im2col operand form: patches ``x [C,
    B·L, K]`` (``x[c, (b, t), k] = xp[b, t + k, c]``) against ``dh [C, B·L,
    1]``; ``OuterProductGrad(x, dh, "im2col").materialize()`` is the dense
    ``[K, C]`` gradient."""
    B, L, C = dy.shape
    K = xp.shape[1] - L + 1
    pat = torch.stack([xp[:, k:k + L] for k in range(K)], dim=-1)  # [B, L, C, K]
    return pat.permute(2, 0, 1, 3).reshape(C, B * L, K), dy.permute(2, 0, 1).reshape(C, B * L, 1)


def _dwconv_fidelity_read(planes: torch.Tensor, frac_bits, v: torch.Tensor, fid,
                          transpose: bool = False) -> torch.Tensor:
    """Finite-ADC crossbar read of the depthwise conv (the im2col mapping),
    in plain PyTorch on ``core.mvm``'s ADC, bit planes and shift-and-add
    scales. ``planes`` int8 ``[S, K, C]``.

    Forward: ``v`` the padded input ``[B, L + K - 1, C]``; each output (t, c)
    is the analog sum of the K cells of channel c's column driven by the
    windowed input bits, so the ADC full scale is ``K · plane_max`` (the
    MVM's ``n_rows`` rule). Transposed (the layer-gradient read): ``v`` is
    ``dy [B, L, C]``; each (k, c) cell is driven from its one output column
    (``n_rows = 1``) and the digitized per-cell products scatter-add back
    over the K taps, one bit cycle at a time (the ``[B, L, S, K, C]``
    intermediate of a cycle, not of all of them). With ``adc_bits=None``
    both directions are exact in f32. -> f32 ``[B, L, C]`` or ``[B, L + K -
    1, C]``."""
    from repro_torch.core.fixed_point import exp2i, quantize
    from repro_torch.core.mvm import _adc, bit_planes, dac_frac_bits, shift_add_scales
    from repro_torch.core.slicing import LOGICAL_BITS

    spec = fid.spec
    adc_bits = fid.adc_bits_bwd if transpose else fid.adc_bits_fwd
    xf = dac_frac_bits(v, fid)
    v_q = quantize(v, xf, fid.io_bits)
    w = planes.to(torch.float32)  # [S, K, C]
    K = planes.shape[-2]
    dev = v.device
    pm = torch.tensor(spec.plane_max, dtype=torch.float32, device=dev)  # [S]
    s_scale = torch.tensor([float(2 ** (LOGICAL_BITS * s)) for s in range(spec.n_slices)], dtype=torch.float32,
                           device=dev)
    if not transpose:
        L = v.shape[1] - K + 1
        if adc_bits is None:
            win = torch.stack([v_q[:, k:k + L] for k in range(K)], dim=2).to(torch.float32)  # [B, L, K, C]
            acc = torch.einsum("btsc,s->btc", torch.einsum("btkc,skc->btsc", win, w), s_scale)
        else:
            bp = bit_planes(v_q, fid.io_bits).to(torch.float32)  # [T, B, L + K - 1, C]
            bw = torch.stack([bp[:, :, k:k + L] for k in range(K)], dim=3)  # [T, B, L, K, C]
            cols = _adc(torch.einsum("tblkc,skc->tblsc", bw, w), (K * pm)[:, None], adc_bits)
            acc = torch.einsum("tblsc,ts->blc", cols, shift_add_scales(spec, fid.io_bits, dev))
    else:
        B, L, C = v.shape
        if adc_bits is None:
            g = torch.einsum("btc,skc->btskc", v_q.to(torch.float32), w)
            g = torch.einsum("btskc,s->btkc", g, s_scale)
        else:
            bp = bit_planes(v_q, fid.io_bits).to(torch.float32)  # [T, B, L, C]
            scales = shift_add_scales(spec, fid.io_bits, dev)
            g = torch.zeros((B, L, K, C), dtype=torch.float32, device=dev)
            for t in range(bp.shape[0]):
                cols = _adc(torch.einsum("blc,skc->blskc", bp[t], w), pm[:, None, None], adc_bits)
                g += torch.einsum("blskc,s->blkc", cols, scales[t])
        acc = torch.zeros((B, L + K - 1, C), dtype=torch.float32, device=dev)
        for k in range(K):
            acc[:, k:k + L] += g[:, :, k]
    f = torch.as_tensor(frac_bits, dtype=torch.int32, device=dev)
    return acc * exp2i(-(xf + f))


def _dwconv_read(xp: torch.Tensor, ww: XbarWeight, transpose: bool) -> torch.Tensor:
    """The conv (``transpose``: its input gradient ``dxp`` from ``xp = dy``)
    in ``xp``'s dtype: through the finite-ADC im2col read where the wrap's
    fidelity reads that direction, else through the dense copy."""
    fid = ww.fid
    if fid is not None and (fid.bwd if transpose else fid.fwd):
        return _dwconv_fidelity_read(ww.planes, ww.frac_bits, xp, fid, transpose=transpose).to(xp.dtype)
    w = ww.w.to(xp.dtype)
    return _dwconv_dx(xp, w) if transpose else _dwconv_val(xp, w)


class _XbarDwconv(torch.autograd.Function):
    """The depthwise conv whose backward returns ``dxp`` and leaves the
    weight's gradient in im2col operand form in the wrap's slot."""

    @staticmethod
    def forward(ctx, xp, ww):
        ww.check_indexed()
        ctx.ww = ww
        ctx.save_for_backward(xp)
        return _dwconv_read(xp, ww, transpose=False)

    @staticmethod
    def backward(ctx, dy):
        (xp,) = ctx.saved_tensors
        ww = ctx.ww
        dxp = _dwconv_read(dy, ww, transpose=True) if ctx.needs_input_grad[0] else None
        ww.put(*_dwconv_operands(xp.detach(), dy))
        return dxp, None


def xbar_dwconv(xp: torch.Tensor, w, dtype=None) -> torch.Tensor:
    """Depthwise causal conv of the left-padded ``xp [B, L + K - 1, C]``
    with ``w [K, C]`` -> ``[B, L, C]``. A plain tensor takes the windowed
    sum with a dense gradient; a train-side ``XbarWeight`` takes
    ``_XbarDwconv`` (forward and ``dxp`` through the finite-ADC im2col read
    or the dense copy, the weight gradient as im2col operands in the slot);
    a serving wrap reads forward only."""
    if isinstance(w, XbarWeight):
        if dtype is not None:
            xp = xp.to(dtype)
        if w.slot is not None:
            return _XbarDwconv.apply(xp, w)
        return _dwconv_read(xp, w, transpose=False)
    return _dwconv_val(xp, w.to(dtype if dtype is not None else xp.dtype))


# ------------------------------- configs -------------------------------------


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class XLSTMCfg:
    proj_factor: float = 2.0
    n_heads: int = 4
    conv_width: int = 4
    slstm_ff_factor: float = 4 / 3


@dataclasses.dataclass(frozen=True)
class ZambaCfg:
    share_every: int = 6
    n_shared_invocations: int = 6


@dataclasses.dataclass(frozen=True)
class LMConfig:
    arch_id: str
    d_model: int
    n_layers: int
    vocab: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    # (block_name, count) groups applied in order; a counted group keeps its
    # params stacked on a leading axis
    pattern: tuple = ()
    act: str = "silu"  # gated-MLP activation: silu (SwiGLU) | gelu (GeGLU)
    rope_theta: float = 10000.0
    window: int | None = None
    softcap_attn: float | None = None
    softcap_final: float | None = None
    qk_norm: bool = False
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model) (gemma)
    tie_embeddings: bool = True
    input_mode: str = "tokens"
    post_norm: bool = False
    norm_eps: float = 1e-6
    moe: MoECfg | None = None
    mla: MLACfg | None = None
    ssm: SSMCfg | None = None
    xlstm: XLSTMCfg | None = None
    zamba: ZambaCfg | None = None
    fidelity: FidelityConfig | None = None
    dense_ff_prefix: int | None = None
    dtype: Any = torch.bfloat16
    supports_long_context: bool = False

    @property
    def kv_groups(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)


# ---------------------------------------------------------------------------


def rms_norm_init(d: int, *, stack: tuple = (), device=None) -> dict:
    return {"scale": torch.zeros((*stack, d), dtype=torch.float32, device=device)}


def rms_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x) * (1 + scale)`` in f32, cast back to ``x``'s dtype."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + params["scale"])
    return out.to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    e = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** e)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]. Rotates the two
    halves of the head dim (not interleaved pairs), in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., :, None, None].to(torch.float32) * freqs
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def dense_init(gen: torch.Generator, d_in: int, d_out: int, scale: float | None = None,
               *, stack: tuple = (), device=None) -> torch.Tensor:
    """N(0, 1/d_in) f32 weights ``[*stack, d_in, d_out]``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((*stack, d_in, d_out), generator=gen, dtype=torch.float32, device=device)
    return w.mul_(scale)


def embed_init(gen: torch.Generator, vocab: int, d: int, *, device=None) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=device)
    return w.mul_(0.02)


# ----------------------- paged KV-cache primitives ---------------------------
# The serving engine (``repro_torch.serve``) keeps seq-axis cache leaves in a
# shared page pool ``[P + 1, page, *tail]`` with a per-slot page table
# ``table [n_slots, max_pages]`` (int32) mapping a logical page to a physical
# one. The sentinel ``P`` marks unallocated and evicted entries. Pages
# ``0..P-1`` hold data; page ``P`` is write-only: a write through the
# sentinel lands there and nothing reads it as data, so a dead slot is inert
# without a branch or a host sync (the reference drops such writes with
# ``mode="drop"``, which torch's ``index_put_`` has no counterpart of; an
# out-of-range index would be a device-side assert on the card, and clamping
# the sentinel to ``P - 1`` would race a live slot's write to that page).
# Reads clip the sentinel to page ``P - 1``, as the reference does: garbage,
# masked by every consumer. Blocks detect a paged cache by the ``"table"``
# key beside the leaves (``attention.attn_decode``).


def is_paged_cache(cache) -> bool:
    return isinstance(cache, dict) and "table" in cache


def paged_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The dense logical view ``[n_slots, max_pages*page, *tail]`` of a paged
    leaf; sentinel entries read page ``P - 1``."""
    P, page = pool.shape[0] - 1, pool.shape[1]
    g = pool[table.clamp(0, P - 1)]  # [n_slots, max_pages, page, *tail]
    return g.reshape(table.shape[0], table.shape[1] * page, *pool.shape[2:])


def paged_scatter(pool: torch.Tensor, table: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Write one token a slot into ``pool`` in place at logical position
    ``pos [n_slots]``; ``new [n_slots, 1, *tail]``. A slot whose logical
    page is the sentinel (a dead slot, or ``pos`` past its pages) writes
    the write-only page ``P``. Returns ``pool``."""
    n_slots, max_pages = table.shape
    P, page = pool.shape[0] - 1, pool.shape[1]
    page_idx = torch.div(pos, page, rounding_mode="floor")
    rows = torch.arange(n_slots, device=table.device)
    phys = torch.where(page_idx < max_pages, table[rows, page_idx.clamp(0, max_pages - 1)].long(), P)
    pool.index_put_((phys, torch.remainder(pos, page).long()), new[:, 0].to(pool.dtype))
    return pool


def seq_scatter(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Per-slot one-token write into a dense seq-axis leaf in place:
    ``cache [B, S, *tail]``, ``new [B, 1, *tail]``, ``pos [B]``. A position
    out of range (the dead-slot sentinel) is dropped: that row writes its
    own old value back, and no other row shares it. Returns ``cache``."""
    B, S = cache.shape[0], cache.shape[1]
    rows = torch.arange(B, device=cache.device)
    ok = (pos >= 0) & (pos < S)
    at = pos.clamp(0, S - 1).long()
    keep = ok.reshape(B, *([1] * (cache.dim() - 2)))
    cache[rows, at] = torch.where(keep, new[:, 0].to(cache.dtype), cache[rows, at])
    return cache
