"""Sharding rules for the (pod, data, model) mesh (port of
``repro.distributed.sharding``).

Name-based rules assign a spec to the *trailing* dims of each parameter;
leading dims (stacked layer groups, the S slice-plane dim of the PANTHER
state, MoE expert stacks handled explicitly) are padded with None. The same
rules therefore cover params, grads and the int8 digit planes, which shard
exactly like their matrix: the paper's crossbar tiling maps one-to-one onto
tensor parallelism.

DP axes: the batch shards over ('pod', 'data'); TP axis: 'model' (attention
heads, FFN hidden, vocab, experts, mamba d_inner).

A spec is a :class:`P`, a tuple with one entry a dim: None (replicated), an
axis name, or a tuple of axis names. Every function here is a pure function
of shapes and a mesh's ``shape`` (axis -> size) and ``axis_names``: a
logical mesh (``launch.mesh.Mesh`` without a process group) serves, as
JAX's ``AbstractMesh`` does.
"""
from __future__ import annotations

import re

from repro_torch import tree
from repro_torch.models.common import OuterProductGrad, path_str as _path_str

MODEL = "model"

# (regex over the '/'-joined param path, trailing-dims spec)
_RULES: list[tuple[str, tuple]] = [
    (r"embed$", (MODEL, None)),  # vocab-sharded embedding
    (r"lm_head$", (None, MODEL)),
    # MoE expert stacks [E, d, f] / [E, f, d]: expert-parallel on 'model'
    (r"(experts_gate|experts_up|experts_down)$", (MODEL, None, None)),
    (r"router$", (None, None)),
    # column-parallel (output dim sharded); wq_dkv is the fused MLA q +
    # compressed-KV down-projection (shards like its dominant q half)
    (r"(wqkv|wq_dkv|wq|wk|wv|wi_gate|wi_up|w_up|w_gate|w_z|w_x|w_dt|ffn_up|mlp_up|w_uk|w_uv)$", (None, MODEL)),
    # row-parallel (input dim sharded)
    (r"(wo|w_down|w_out|ffn_down|mlp_down)$", (MODEL, None)),
    # small / replicated
    (r"(w_B|w_C|r|conv_w|conv_b|A_log|dt_bias|D|bias|scale|if_bias)$", ()),
]


def _entry(e):
    """A spec entry in normal form, as JAX's ``PartitionSpec`` keeps it: a
    one-axis tuple is its axis, an empty one None."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """A partition spec: ``P("model", None)``, one entry a dim (None, an
    axis name, or a tuple of axis names). A tuple, so specs compare and
    hash as their entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self):
        return f"P{tuple(self)!r}"


def axes_of(entry) -> tuple:
    """The mesh axes of one spec entry, as a tuple (``()`` for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def trailing_spec(path_str: str, hint: tuple | None = None) -> tuple:
    """Trailing-dims mesh-axis assignment for a leaf: an explicit ``hint``
    (a ``LeafPlan.shard`` from the resolved plan) wins; otherwise the name
    rules above apply."""
    if hint is not None:
        return tuple(hint)
    for pat, spec in _RULES:
        if re.search(pat, path_str):
            return spec
    return ()


def leaf_spec(path_str: str, ndim: int, hint: tuple | None = None) -> P:
    t = trailing_spec(path_str, hint=hint)
    if len(t) > ndim:
        t = t[-ndim:]
    return P(*((None,) * (ndim - len(t)) + tuple(t)))


def sanitize_spec(spec, shape: tuple, mesh) -> P:
    """Drop (or relocate) mesh axes that do not divide their dimension:
    granite's vocab 49155 cannot shard 16-way, so 'model' moves to the
    d_model axis of the embedding."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = list(spec)
    homeless = []
    for i, (s, d) in enumerate(zip(spec, shape)):
        names = axes_of(s)
        size = 1
        for n in names:
            size *= mesh.shape[n]
        if names and d % size != 0:
            homeless.extend(names)
            out[i] = None
    for n in homeless:
        for i, (s, d) in enumerate(zip(out, shape)):
            if s is None and d % mesh.shape[n] == 0 and d >= mesh.shape[n]:
                out[i] = n
                break
    return P(*out)


def _hints(plan) -> dict:
    if plan is None:
        return {}
    from repro_torch.plan import plan_by_path  # local: the plan imports models, not this module

    return {p: pl.shard for p, pl in plan_by_path(plan).items()}


def param_specs(params, mesh=None, plan=None):
    """Spec tree for a parameter (or gradient) tree whose leaves have a
    ``shape``; ``plan`` (a resolved plan mirroring ``params``) supplies
    per-leaf shard hints overriding the name rules."""
    hints = _hints(plan)

    def spec(path, leaf):
        ps = _path_str(path)
        s = leaf_spec(ps, len(leaf.shape), hint=hints.get(ps))
        if mesh is not None:
            s = sanitize_spec(s, tuple(leaf.shape), mesh)
        return s

    return tree.map_with_path(spec, params)


def operand_grad_spec(path_str: str, wshape: tuple, mesh, mb_batch: int | None, hint: tuple | None = None,
                      group: str | None = None) -> OuterProductGrad:
    """Specs of the operand gradient ``OuterProductGrad(x, dh)`` of the
    weight at ``path_str`` with dense shape ``wshape`` [*stack, M, N]: the
    token axis over the DP axes, the feature axes inheriting the weight's M
    / N rule. By the plan leaf's ``group``: a matmul ``x [*stack, T, M]``,
    ``dh [*stack, T, N]``; ``"im2col"`` (weight ``[*lead, K, C]``) ``x
    [*lead, C, T, K]``, ``dh [*lead, C, T, 1]``; ``"expert"`` the capacity
    buffers, whose token axis replicates."""
    base = sanitized_leaf_spec(path_str, wshape, mesh, hint=hint)
    stack = base[:-2]
    m_ax, n_ax = base[-2], base[-1]
    dp = None
    if mesh is not None and mb_batch is not None:
        dp = tuple(data_spec(mesh, mb_batch, 1))[0]
    if group == "im2col":
        return OuterProductGrad(P(*stack, n_ax, dp, m_ax), P(*stack, n_ax, dp, None), "im2col")
    if group == "expert":
        return OuterProductGrad(P(*stack, None, m_ax), P(*stack, None, n_ax))
    return OuterProductGrad(P(*stack, dp, m_ax), P(*stack, dp, n_ax))


def sanitized_leaf_spec(path_str: str, shape: tuple, mesh, hint: tuple | None = None) -> tuple:
    """The effective per-dim mesh axes of the leaf at ``path_str`` as
    stored: the name rules (or ``hint``), ``sanitize_spec`` against
    ``shape``, right-padded to ``len(shape)``. Shared by
    :func:`fidelity_plane_specs` and ``plan.attach_fidelity_shard_dims``, so
    the read's tile hint and the planes' layout agree."""
    base = leaf_spec(path_str, len(shape), hint=hint)
    if mesh is not None:
        base = sanitize_spec(base, shape, mesh)
    return tuple(base) + (None,) * (len(shape) - len(tuple(base)))


def fidelity_plane_specs(path_str: str, wshape: tuple, mesh, hint: tuple | None = None) -> tuple:
    """``(planes_spec, frac_bits_spec)`` of a fidelity wrap's planes
    ``[*stack, S, M, N]`` and its ``frac_bits`` ``[*stack]``: the matrix
    dims shard like the dense weight, S and the stack dims replicate."""
    base = sanitized_leaf_spec(path_str, wshape, mesh, hint=hint)
    stack = base[:-2]
    return P(*stack, None, base[-2], base[-1]), P(*stack)


def fsdp_spec(spec, shape: tuple, data_size: int, n_tail: int | None = None) -> P:
    """ZeRO-3: additionally shard the first unsharded, divisible axis over
    'data'. ``n_tail`` restricts it to the trailing matrix axes (never a
    layer-stack axis or the slice-plane axis)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = list(spec)
    start = len(shape) - (n_tail if n_tail is not None else len(shape))
    for i in range(max(start, 0), len(shape)):
        s, d = spec[i], shape[i]
        if s is None and d % data_size == 0 and d >= data_size:
            out[i] = "data"
            return P(*out)
    return P(*spec)


def batch_axes(mesh) -> tuple:
    """The DP axes of ``mesh``: ('pod', 'data') multi-pod, ('data',) single."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_axes_for(mesh, global_batch: int | None) -> tuple:
    """DP axes whose sizes cumulatively divide ``global_batch`` (all of them
    when None): the one walk behind the batch sharding and the fidelity
    reads' token sharding."""
    axes = []
    rem = global_batch
    for a in batch_axes(mesh):
        size = mesh.shape[a]
        if rem is None:
            axes.append(a)
        elif rem % size == 0:
            axes.append(a)
            rem //= size
    return tuple(axes)


def data_spec(mesh, global_batch: int, ndim: int) -> P:
    """Shard the batch dim over as many DP axes as divide it; the rest
    replicated."""
    axes = data_axes_for(mesh, global_batch)
    return P(tuple(axes) if axes else None, *((None,) * (ndim - 1)))


def activation_spec(mesh, global_batch: int) -> P:
    """[B, S, d] activations: the batch over the DP axes, d replicated."""
    return data_spec(mesh, global_batch, 3)


def cache_specs(mesh, cache_shapes, global_batch: int):
    """Cache sharding: the batch axis (the first of size ``global_batch``)
    over the DP axes that divide it; then the first remaining axis from the
    back divisible by 'model' takes TP (head_dim, then kv heads; never the
    sequence axis first)."""
    msize = mesh.shape[MODEL]
    dp = []
    rem = global_batch
    for a in batch_axes(mesh):
        if rem % mesh.shape[a] == 0:
            dp.append(a)
            rem //= mesh.shape[a]

    def one(leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        b_ax = next((i for i, d in enumerate(shape) if d == global_batch), None)
        if b_ax is not None and dp:
            spec[b_ax] = tuple(dp) if len(dp) > 1 else dp[0]
        for i in range(len(shape) - 1, -1, -1):
            d = shape[i]
            if i != b_ax and spec[i] is None and d % msize == 0 and d >= msize:
                spec[i] = MODEL
                break
        return P(*spec)

    return tree.map(one, cache_shapes)


def page_pool_spec(shape: tuple, mesh, n_leading: int = 2) -> P:
    """A serving page-pool leaf's spec: paged leaves ``[P, page, *tail]``
    (``n_leading=2``) keep the page axes replicated, so a page moves between
    slots without a reshuffle; dense per-slot state leaves (``n_leading=1``)
    their slot axis. TP on the first trailing dim divisible by 'model' from
    the back, as in :func:`cache_specs`."""
    msize = mesh.shape[MODEL]
    spec = [None] * len(shape)
    for i in range(len(shape) - 1, n_leading - 1, -1):
        if shape[i] % msize == 0 and shape[i] >= msize:
            spec[i] = MODEL
            break
    return P(*spec)


def page_pool_specs(mesh, pool_shapes, n_leading: int = 2):
    """:func:`page_pool_spec` over a tree of leaves with a ``shape``."""
    return tree.map(lambda a: page_pool_spec(tuple(a.shape), mesh, n_leading), pool_shapes)
