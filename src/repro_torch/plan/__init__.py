"""Declarative per-leaf crossbar mapping plans (port of ``repro.plan``).

A :class:`LeafPlan` says how one parameter leaf maps to hardware: ``mapped``
(int8 digit planes vs digital), its ``spec``, its ``grad`` path
(``"operand"`` | ``"dense"``), an optional ``fidelity`` for finite-ADC
reads, the operand ``group`` kind (``None`` for a matmul, ``"im2col"`` for
depthwise-conv taps, ``"expert"`` for an MoE bank whose expert axis rides
the operand stack) and ``expert_groups`` (``((count, FidelityConfig |
None), ...)`` segments giving contiguous experts their own read fidelity,
folded into ``fidelity.expert_groups`` at resolution). An ordered list of
:class:`PlanRule` s resolves one
plan per leaf: every matching rule applies in order, later rules overriding
earlier ones field by field. Rules match a glob over the '/'-joined leaf
path plus an optional predicate over :class:`LeafInfo`; the paths are the
JAX package's, so one rule list means the same thing on both trees.

Token-dependent rules see ``LeafInfo.tokens``, the flattened tokens of one
differentiated forward (one microbatch): ``operand_stash_rule`` flips a
leaf whose operand stash outweighs its dense gradient to ``grad="dense"``
(``default_rules(stash_fallback=True)``). ``coverage_rules`` layers the
generalized operand mapping on the default rules: routers and the
structured matmul keys flow operands, expert banks map as ``group=
"expert"`` tiles, conv taps as ``"im2col"``. ``plan_by_path`` and
``plan_summary`` read a resolved plan.

Serialization (checkpoint manifests): ``plan_manifest`` writes a resolved
plan in the reference's format, key for key, so each package reads the
other's manifests; ``check_plan_compat`` refuses a restore whose stored
planes were laid out or written under another plan.

``shard`` is a trailing-dims sharding hint overriding the name rules of
``distributed.sharding``; ``attach_fidelity_shard_dims`` threads the mesh's
tile split into each fidelity leaf's ``FidelityConfig.shard_dim``.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import warnings
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree
from repro_torch.core.slicing import DEFAULT_SPEC, SliceSpec
from repro_torch.models.common import OPERAND_LINEAR_KEYS, DeviceModel, FidelityConfig, path_str


class _Unset:
    """Sentinel distinguishing "no override" from "override with None"."""

    __slots__ = ()

    def __repr__(self):  # pragma: no cover - debugging aid
        return "UNSET"


UNSET = _Unset()


class LeafInfo(NamedTuple):
    """What a rule predicate can see about a parameter leaf."""

    path: str
    shape: tuple
    dtype: Any
    tokens: int | None = None  # flattened tokens per differentiated forward, if known


GROUP_KINDS = (None, "im2col", "expert")


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How one parameter leaf maps to hardware. See module docstring."""

    mapped: bool = False
    spec: SliceSpec = DEFAULT_SPEC
    grad: str = "dense"  # "operand" | "dense"
    fidelity: FidelityConfig | None = None
    shard: tuple | None = None  # trailing-dims sharding hint (None: the name rules)
    group: str | None = None  # operand group kind: None (matmul) | "im2col" | "expert"
    expert_groups: tuple | None = None  # ((count, FidelityConfig | None), ...)

    def __post_init__(self):
        if self.grad not in ("operand", "dense"):
            raise ValueError(f"LeafPlan.grad must be 'operand' or 'dense', got {self.grad!r}")
        if self.group not in GROUP_KINDS:
            raise ValueError(f"LeafPlan.group must be one of {GROUP_KINDS}, got {self.group!r}")
        if self.shard is not None:
            object.__setattr__(self, "shard", _tuplify(self.shard))
        if self.expert_groups is not None:
            object.__setattr__(self, "expert_groups", tuple((int(n), g) for n, g in self.expert_groups))

    @property
    def category(self) -> str:
        """'digital' | 'operand' | 'dense': the three-way leaf partition."""
        if not self.mapped:
            return "digital"
        return "operand" if self.grad == "operand" else "dense"


_OVERRIDE_FIELDS = ("mapped", "spec", "grad", "fidelity", "shard", "group", "expert_groups")


@dataclasses.dataclass(frozen=True)
class PlanRule:
    """``glob (+ optional predicate) -> field overrides``, applied in order."""

    pattern: str = "*"
    where: Callable[[LeafInfo], bool] | None = None
    mapped: Any = UNSET
    spec: Any = UNSET
    grad: Any = UNSET
    fidelity: Any = UNSET
    shard: Any = UNSET
    group: Any = UNSET
    expert_groups: Any = UNSET

    def matches(self, info: LeafInfo) -> bool:
        if not fnmatch.fnmatchcase(info.path, self.pattern):
            return False
        return self.where is None or bool(self.where(info))

    def apply(self, plan: LeafPlan, info: LeafInfo) -> LeafPlan:
        if not self.matches(info):
            return plan
        kw = {f: getattr(self, f) for f in _OVERRIDE_FIELDS if getattr(self, f) is not UNSET}
        return dataclasses.replace(plan, **kw) if kw else plan


# ------------------------------ default rules -------------------------------

_FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def crossbar_eligible(shape, dtype, min_ndim: int = 2, min_dim: int = 8) -> bool:
    """Eligibility is a property of the matrix dims ``[-2:]`` (leading dims
    are layer stacks, each slice its own crossbar tile)."""
    return len(shape) >= min_ndim and min(shape[-2:]) >= min_dim and dtype in _FLOAT_DTYPES


def operand_eligible_path(path: str) -> bool:
    """Single-use matmul weights directly under an ``attn``/``mlp`` subtree,
    never under a ``shared`` one."""
    parts = path.split("/")
    return (
        parts[-1] in OPERAND_LINEAR_KEYS
        and len(parts) >= 2
        and parts[-2] in ("attn", "mlp")
        and "shared" not in parts
    )


def stash_exceeds_dense(info: LeafInfo) -> bool:
    """True when the operand stash (``T·(M+N)`` activations) would outweigh
    the dense ``[M, N]`` gradient it replaces: ``tokens · (M + N) > M ·
    N``. False while the tokens are unknown."""
    if info.tokens is None or len(info.shape) < 2:
        return False
    m, n = info.shape[-2], info.shape[-1]
    return info.tokens * (m + n) > m * n


def operand_stash_rule() -> PlanRule:
    """A leaf whose operand stash outweighs its dense gradient flips to
    ``grad="dense"``: a memory lever, bit-compatible on the lossless path.
    A flipped leaf sheds its read fidelity (``plan_summary`` shows it)."""
    return PlanRule("*", where=stash_exceeds_dense, grad="dense")


def default_rules(cfg=None, fidelity: FidelityConfig | None = None, stash_fallback: bool = False) -> tuple:
    """The reference's historical mapping: matrix-shaped float leaves map to
    planes at ``cfg.spec``, single-use attn/mlp matmul weights take operand
    gradients, ``fidelity`` (if given) attaches to every operand leaf, and
    with ``stash_fallback`` the ``operand_stash_rule`` comes last (it needs
    ``tokens`` at resolution). ``cfg`` is anything with
    ``spec``/``min_ndim``/``min_dim``."""
    spec = getattr(cfg, "spec", DEFAULT_SPEC)
    min_ndim = getattr(cfg, "min_ndim", 2)
    min_dim = getattr(cfg, "min_dim", 8)
    rules = [
        PlanRule("*", where=lambda i: crossbar_eligible(i.shape, i.dtype, min_ndim, min_dim),
                 mapped=True, spec=spec),
        PlanRule("*", where=lambda i: operand_eligible_path(i.path), grad="operand"),
    ]
    if fidelity is not None:
        rules.append(PlanRule("*", fidelity=fidelity))
    if stash_fallback:
        rules.append(operand_stash_rule())
    return tuple(rules)


# Single-use matmul projections beyond the attn/mlp set, the reference's
# list: mamba2's input heads and out-projection, xLSTM's mLSTM projections
# and its sLSTM FFN. Their blocks are not ported, so no ported config has
# them; the rules are here so that one rule list means the same on both trees.
_STRUCTURED_MATMUL_KEYS = (
    "w_z", "w_x", "w_B", "w_C", "w_dt", "w_out",  # mamba2
    "wq", "wk", "wv", "w_if", "w_up", "w_gate", "w_down",  # xlstm mlstm
    "ffn_up", "ffn_down",  # xlstm slstm FFN
)


def coverage_rules(cfg=None, fidelity: FidelityConfig | None = None) -> tuple:
    """``default_rules`` plus the generalized operand mapping: every
    structurally eligible matmul weight flows operands, the MoE router
    reads once a step as an operand leaf, expert banks map as ``group=
    "expert"`` grouped tiles, depthwise conv taps as ``group="im2col"``
    ``[K, C]`` tiles (only the channel count must clear ``min_dim``).
    ``shared`` subtrees, the embedding and sLSTM's ``r`` stay dense."""
    spec = getattr(cfg, "spec", DEFAULT_SPEC)
    min_ndim = getattr(cfg, "min_ndim", 2)
    min_dim = getattr(cfg, "min_dim", 8)

    def eligible(i: LeafInfo) -> bool:
        return crossbar_eligible(i.shape, i.dtype, min_ndim, min_dim) and "shared" not in i.path.split("/")

    def conv_eligible(i: LeafInfo) -> bool:
        return (len(i.shape) >= 2 and i.shape[-1] >= min_dim and i.dtype in _FLOAT_DTYPES
                and "shared" not in i.path.split("/"))

    rules = list(default_rules(cfg, fidelity=fidelity))
    for key in _STRUCTURED_MATMUL_KEYS:
        rules.append(PlanRule(f"*/{key}", where=eligible, grad="operand"))
    # the router: one crossbar read a step (moe_apply(with_aux=True) takes
    # the load-balance loss from the same logits)
    rules.append(PlanRule("*/router", where=eligible, grad="operand"))
    rules.append(PlanRule("*/conv_w", where=conv_eligible, mapped=True, spec=spec, grad="operand",
                          group="im2col"))
    for key in ("experts_gate", "experts_up", "experts_down"):
        rules.append(PlanRule(f"*/{key}", where=eligible, grad="operand", group="expert"))
    return tuple(rules)


# ------------------------------- resolution ---------------------------------

# Leaf keys the operand pipeline can never serve (gather / recurrent reads);
# a rule that makes them operand leaves demotes to dense with one warning.
_UNMAPPABLE_OPERAND_KEYS = frozenset({"r", "embed"})


def _operand_unmappable(path: str) -> str | None:
    parts = path.split("/")
    if "shared" in parts:
        return "lives under a 'shared' subtree (applied more than once per step)"
    if parts[-1] in _UNMAPPABLE_OPERAND_KEYS:
        return "is consumed by gather/recurrent ops, not a single xbar matmul site"
    return None


def _sync_fid_spec(fid: FidelityConfig, spec: SliceSpec) -> FidelityConfig:
    """``fid`` with its spec, and every expert segment's, equal to the
    leaf's plane layout (the engine must read the planes the optimizer
    writes)."""
    groups = fid.expert_groups
    if groups is not None:
        groups = tuple((n, g if g is None or g.spec == spec else dataclasses.replace(g, spec=spec))
                       for n, g in groups)
    if fid.spec == spec and groups == fid.expert_groups:
        return fid
    return dataclasses.replace(fid, spec=spec, expert_groups=groups)


def _normalize(plan: LeafPlan, path: str = "", warned: set | None = None) -> LeafPlan:
    """Demote unmappable operand leaves; drop ``group``/``expert_groups``
    off non-operand leaves and fold an operand leaf's ``expert_groups`` into
    its fidelity; drop a fidelity that cannot apply (unmapped leaf, or a
    non-operand leaf without a device model); sync an attached fidelity's
    spec, and its segments', to the leaf's plane layout."""
    if plan.grad == "operand" and path:
        reason = _operand_unmappable(path)
        if reason is not None:
            if warned is not None and path not in warned:
                warned.add(path)
                warnings.warn(
                    f"plan: leaf {path!r} {reason}; the operand gradient path "
                    "cannot serve it — demoting to grad='dense'. Narrow the "
                    "rule pattern to silence this.",
                    UserWarning,
                    stacklevel=3,
                )
            plan = dataclasses.replace(plan, grad="dense")
    if plan.grad != "operand" and (plan.group is not None or plan.expert_groups is not None):
        plan = dataclasses.replace(plan, group=None, expert_groups=None)
    if plan.expert_groups is not None:
        base = plan.fidelity if plan.fidelity is not None else FidelityConfig(spec=plan.spec)
        plan = dataclasses.replace(plan, fidelity=dataclasses.replace(base, expert_groups=plan.expert_groups))
    if plan.fidelity is not None:
        if not plan.mapped or (plan.grad != "operand" and plan.fidelity.device is None):
            return dataclasses.replace(plan, fidelity=None)
        synced = _sync_fid_spec(plan.fidelity, plan.spec)
        if synced is not plan.fidelity:
            return dataclasses.replace(plan, fidelity=synced)
    return plan


def resolve_leaf(path: str, shape, dtype, rules, warned: set | None = None, tokens: int | None = None) -> LeafPlan:
    info = LeafInfo(path=path, shape=tuple(shape), dtype=dtype, tokens=tokens)
    plan = LeafPlan()
    for r in rules:
        plan = r.apply(plan, info)
    return _normalize(plan, path, warned)


def resolve_plan(params, rules, tokens: int | None = None):
    """A tree of :class:`LeafPlan` mirroring ``params`` (only ``.shape`` and
    ``.dtype`` of each leaf are read). ``tokens``, the flattened tokens per
    differentiated forward, feeds token-dependent rules. Each demoted leaf
    warns once per call."""
    warned: set = set()
    return tree.map_with_path(
        lambda p, leaf: resolve_leaf(path_str(p), leaf.shape, leaf.dtype, rules, warned, tokens),
        params,
    )


def plan_by_path(plan_tree) -> dict:
    """``{'/'-joined path: LeafPlan}``, in ``jax.tree.flatten``'s order."""
    return {path_str(p): pl for p, pl in tree.leaves_sorted(plan_tree)}


def plan_summary(plan_tree) -> str:
    """One line per distinct (category, spec, ADC, shard) combination with
    its leaf count, most frequent first: the reference's digest, line for
    line."""
    combos: dict[tuple, int] = {}
    for pl in plan_by_path(plan_tree).values():
        fid = pl.fidelity
        adc = None if fid is None else (fid.adc_bits_fwd, fid.adc_bits_bwd)
        key = (pl.category, pl.spec.name() if pl.mapped else "-", adc, pl.shard)
        combos[key] = combos.get(key, 0) + 1
    lines = []
    for (cat, spec, adc, shard), n in sorted(combos.items(), key=lambda kv: -kv[1]):
        extra = f" adc(fwd,bwd)={adc}" if adc is not None else ""
        if shard is not None:
            extra += f" shard={shard}"
        lines.append(f"  {n:4d} x {cat:8s} spec={spec}{extra}")
    return "\n".join(lines)


# --------------------------- mesh (sharded fidelity) ------------------------


def attach_fidelity_shard_dims(plan_tree, mesh, params=None):
    """A copy of ``plan_tree`` whose fidelity leaves carry ``shard_dim``:
    the matrix dim of the dense ``[M, N]`` weight the mesh's 'model' axis
    shards (0 rows, 1 columns, None replicated), from the leaf's ``shard``
    hint or the name rules. ``params`` (a tree mirroring ``plan_tree`` whose
    leaves have a ``shape``) puts the hint through ``sanitize_spec``, as the
    stored planes' specs are, so a relocated 'model' axis gives the dim the
    planes really have. A None or model-less mesh returns the tree as it
    is."""
    if mesh is None:
        return plan_tree
    from repro_torch.distributed import sharding as shd  # lazy: sharding imports the models

    if shd.MODEL not in mesh.axis_names or mesh.shape[shd.MODEL] <= 1:
        return plan_tree
    shapes = {} if params is None else {path_str(p): tuple(leaf.shape) for p, leaf in tree.leaves_sorted(params)}

    def has_model(entry) -> bool:
        return shd.MODEL in shd.axes_of(entry)

    def one(path, pl: LeafPlan) -> LeafPlan:
        if pl.fidelity is None:
            return pl
        ps = path_str(path)
        shape = shapes.get(ps)
        if shape is not None and len(shape) >= 2:
            trailing = shd.sanitized_leaf_spec(ps, shape, mesh, hint=pl.shard)
        else:
            trailing = shd.trailing_spec(ps, hint=pl.shard)
        sd = None
        if len(trailing) >= 2:
            sd = 0 if has_model(trailing[-2]) else (1 if has_model(trailing[-1]) else None)
        if sd == pl.fidelity.shard_dim:
            return pl
        return dataclasses.replace(pl, fidelity=dataclasses.replace(pl.fidelity, shard_dim=sd))

    return tree.map_with_path(one, plan_tree)


# ----------------------- serialization (checkpoints) ------------------------
#
# The reference's manifest format. The port's FidelityConfig has no
# ``use_kernel`` or ``interpret`` (JAX runtime switches): they are written at
# the reference's defaults and ignored on reading. Shard hints are lists.
# Expert segments are ``[[count, fidelity dict | None], ...]``, at the leaf
# and inside a fidelity.

_FIDELITY_DEFAULTS = {"use_kernel": None, "interpret": None}
_FIDELITY_RUNTIME = ("use_kernel", "interpret")


def _expert_groups_to_list(groups) -> list | None:
    if groups is None:
        return None
    return [[int(n), None if g is None else _fidelity_to_dict(g)] for n, g in groups]


def _expert_groups_from_list(raw, path=None) -> tuple | None:
    if raw is None:
        return None
    return tuple((int(n), None if g is None else _fidelity_from_dict(g, path)) for n, g in raw)


def _fidelity_to_dict(fid: FidelityConfig) -> dict:
    d = {f.name: getattr(fid, f.name) for f in dataclasses.fields(fid)}
    d.update(_FIDELITY_DEFAULTS, spec=fid.spec.name(),
             device=None if fid.device is None else dataclasses.asdict(fid.device),
             expert_groups=_expert_groups_to_list(fid.expert_groups))
    return d


def _tuplify(x):
    return tuple(_tuplify(e) for e in x) if isinstance(x, (list, tuple)) else x


def _fidelity_from_dict(d: dict, path=None) -> FidelityConfig:
    d = {k: v for k, v in d.items() if k not in _FIDELITY_RUNTIME}
    d["spec"] = SliceSpec(tuple(int(c) for c in d["spec"]))
    if d.get("device") is not None:
        d["device"] = DeviceModel(**d["device"])
    d["expert_groups"] = _expert_groups_from_list(d.get("expert_groups"), path)
    return FidelityConfig(**d)


def leaf_plan_to_dict(pl: LeafPlan) -> dict:
    """JSON-safe form (specs as their '44466555' names), the reference's
    keys: what checkpoint manifests persist."""
    return {
        "mapped": pl.mapped,
        "spec": pl.spec.name(),
        "grad": pl.grad,
        "fidelity": None if pl.fidelity is None else _fidelity_to_dict(pl.fidelity),
        "shard": None if pl.shard is None else [list(s) if isinstance(s, tuple) else s for s in pl.shard],
        "group": pl.group,
        "expert_groups": _expert_groups_to_list(pl.expert_groups),
    }


def leaf_plan_from_dict(d: dict, path=None) -> LeafPlan:
    """The inverse of ``leaf_plan_to_dict`` (reads the reference's
    manifests too)."""
    return LeafPlan(
        mapped=bool(d["mapped"]),
        spec=SliceSpec(tuple(int(c) for c in d["spec"])),
        grad=d["grad"],
        fidelity=None if d.get("fidelity") is None else _fidelity_from_dict(d["fidelity"], path),
        shard=None if d.get("shard") is None else _tuplify(d["shard"]),
        group=d.get("group"),
        expert_groups=_expert_groups_from_list(d.get("expert_groups"), path),
    )


def plan_manifest(plan_tree) -> dict:
    """``{path: leaf_plan_to_dict(...)}`` for a resolved plan tree."""
    return {p: leaf_plan_to_dict(pl) for p, pl in plan_by_path(plan_tree).items()}


# DeviceModel fields that make stored planes physically device-specific:
# planes deposited under write noise / asymmetry / stuck cells are not the
# planes an ideal deposit would have produced. Read-path fields (read_noise)
# and ADC settings stay runtime choices.
_DEVICE_WRITE_FIELDS = ("write_noise", "asym_up", "asym_down", "stuck_frac", "stuck_seed")
_DEVICE_WRITE_IDEAL = {"write_noise": 0.0, "asym_up": 1.0, "asym_down": 1.0, "stuck_frac": 0.0, "stuck_seed": 0}


def _device_write_sig(fid) -> tuple:
    """The write-physics signature of a fidelity entry (a FidelityConfig or
    a manifest dict, either may be None). An ideal device equals none."""
    dev = fid.get("device") if isinstance(fid, dict) else None if fid is None else fid.device
    if isinstance(dev, dict):
        return tuple(dev.get(f, _DEVICE_WRITE_IDEAL[f]) for f in _DEVICE_WRITE_FIELDS)
    if dev is not None:
        return tuple(getattr(dev, f) for f in _DEVICE_WRITE_FIELDS)
    return tuple(_DEVICE_WRITE_IDEAL[f] for f in _DEVICE_WRITE_FIELDS)


def check_plan_compat(saved: dict, plan_tree, context: str = "checkpoint") -> None:
    """Raise ``ValueError`` when a persisted plan manifest and the current
    plan disagree on storage layout (mapped, slice spec) or on write physics
    (the ``DeviceModel`` write fields) for any shared path. ``grad``, ADC and
    read-noise settings are runtime choices and may differ."""
    errors = []
    for path, pl in plan_by_path(plan_tree).items():
        meta = saved.get(path)
        if meta is None:
            continue  # a new or renamed leaf: the restore's path matching handles it
        if bool(meta["mapped"]) != pl.mapped:
            errors.append(f"  {path}: saved mapped={meta['mapped']} vs current mapped={pl.mapped}")
        elif pl.mapped and meta["spec"] != pl.spec.name():
            errors.append(f"  {path}: saved spec={meta['spec']} vs current spec={pl.spec.name()}")
        elif pl.mapped:
            ssig, csig = _device_write_sig(meta.get("fidelity")), _device_write_sig(pl.fidelity)
            if ssig != csig:
                errors.append(f"  {path}: saved device write physics {dict(zip(_DEVICE_WRITE_FIELDS, ssig))} "
                              f"vs current {dict(zip(_DEVICE_WRITE_FIELDS, csig))}")
    if errors:
        raise ValueError(
            f"{context} plan is layout-incompatible with the current plan ({len(errors)} leaves): restoring "
            "would misread the stored digit planes. Re-resolve with the saved plan or migrate the "
            "checkpoint:\n" + "\n".join(errors))
