"""The PANTHER train step (port of ``repro.train.step``), on one device or a mesh.

The int8 digit planes are the only copy of every crossbar-mapped weight.
Each step reads them, runs the forward and backward, and writes the update
back into them:

* the forward reads each mapped leaf through its dense (dequantized) copy,
  or, for an operand leaf with a finite-ADC plan, through the fidelity
  engine in both directions (forward MVM, backward MᵀVM ``dx``), with no
  dense copy at all;
* operand leaves (``OPERAND_LINEAR_KEYS`` under ``attn``/``mlp``, and
  under ``plan.coverage_rules`` the MoE router and the expert banks)
  return their weight gradient as operands ``(x, dh)``, which the fused
  update kernel deposits without forming ``[M, N]``; an expert bank's
  operands keep the expert axis (``x [L, E, G·C, M]``, ``G·C`` the MoE
  capacity tokens), and a depthwise conv's taps (``conv_w`` under
  ``coverage_rules``, ``group="im2col"``) return im2col patches of the
  step's B·L tokens (``x [*lead, C, B·L, K]``); every other leaf (the
  embedding, sLSTM's ``r``, the zamba shared block's matrices and the
  vector leaves) gets a dense gradient;
* ``optim.panther.update_split`` quantizes and deposits the update in
  place, and runs CRS every ``crs_every`` steps.

``operand_grads=False`` is the dense pipeline: every mapped leaf gets a
dense gradient, quantized and deposited by ``opa_deposit``. The reference
holds the two bit-compatible.

``microbatches=G`` takes batch leaves shaped ``[G, B/G, S]`` and makes one
update per global batch: the microbatches run forward and backward one
after another, each one's activations freed before the next; dense leaves
sum their gradients in ``grad_dtype``, then divide by G; operand leaves
take each microbatch's ``(x, dh)`` out of their slots and concatenate them
along the token axis, ``dh`` scaled by 1/G, so each block's update is one
fused-update launch at G·T tokens. The plan is resolved per microbatch
token count, so ``stash_fallback`` (``plan.operand_stash_rule``) sees the
tokens of one microbatch, as in the reference.

The loss is ``lm.loss_fn``'s: the cross entropy plus ``lm.AUX_WEIGHT``
times the MoE load-balance term; ``metrics["aux"]`` is that term, zero for
dense models.

The state's step and rng are host values, and the learning-rate schedule is
a host function, so nothing in the step waits on the device.

``remat`` (``"full"``, the reference's default; ``"dots"``; ``"none"``;
``True``/``False`` as aliases) is each layer's checkpoint mode
(``lm.hidden``): ``"full"`` keeps a layer's input and recomputes its
forward in the backward (its crossbar reads and, on a mesh, its weights'
all-gathers too), ``"dots"`` also keeps the matmuls with no batch dims. The
loss head runs chunk by chunk under checkpoint above ``lm.LOSS_CHUNK``
tokens whatever the mode. No mode changes a number.

On a ``(data, model)`` mesh (``make_train_step(mesh=...)``, one process per
mesh coordinate, ``launch.mesh``) each rank holds its block of every leaf
(``train_state_specs``; ``shard_state`` cuts a whole state into this
rank's blocks, ``gather_state`` puts it back together) and reads its share
of the batch (``batch_specs``: the batch over the data axes). A dense
weight is all-gathered at use, a layer at a time for a stacked group, and
its gradient is that of this rank's block; a fidelity leaf's planes are
never gathered over the model axis: its reads run on the rank's crossbar
tile block (``kernels.sliced_mvm.mvm_sliced_sharded``), the DAC range
global over the data axes. The loss on a rank is scaled by its share of
the tokens, so the sum of the dense gradients over the data axes
(``all_reduce``) is the batch's gradient; an operand leaf's ``(x, dh)`` are
cut to the block's rows and columns and all-gathered along the token axis
in global token order; each rank's update then writes its own block at its
global origin (``kernels.common.Origin``), so the state equals the
single-device step's up to the order of float sums. ``fsdp=True``
additionally shards the planes over 'data' (``sharding.fsdp_spec``),
gathered at use; a conv-tap leaf's im2col operands are cut to the block
(its taps or channels) like any other. MoE blocks at ``data > 1`` train
where a rank's tokens are whole dispatch groups of the global batch
(``models.mlp.groups_aligned``; capacity is set per group), their
load-balance term over the batch; otherwise they raise. One step body
serves both cases: ``_Whole`` (one device, every hook the
identity) and ``_Blocks`` (a rank's blocks) say where the leaves live.
"""
from __future__ import annotations

import contextlib
import itertools
import math
from typing import Any, NamedTuple

import torch

from repro_torch import plan as planlib
from repro_torch import tree
from repro_torch.core import prng
from repro_torch.core.slicing import dequantize_planes
from repro_torch.distributed import blocks
from repro_torch.distributed import collectives as col
from repro_torch.distributed import fidelity as dist_fid
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.common import Origin
from repro_torch.models import lm
from repro_torch.models.common import LayerStack, LMConfig, OuterProductGrad, ShapeDtype, XbarWeight
from repro_torch.optim import PantherConfig, panther
from repro_torch.optim.panther import SlicedTensor


class TrainState(NamedTuple):
    step: int  # host step
    digital: Any  # float leaves (VFU path); None at crossbar leaves
    sliced: Any  # SlicedTensor leaves; None at digital leaves
    rng: tuple  # host key words (core.prng)


def train_state_init(cfg: LMConfig, opt_cfg: PantherConfig, seed=0, plan=None, device=None) -> TrainState:
    """Random params from ``seed`` (an int or a ``torch.Generator``),
    sliced into planes; ``rng`` is ``PRNGKey(7)``, the reference's."""
    params = lm.init_params(cfg, seed, device=device)
    digital, sliced = panther.init_split(params, opt_cfg, plan=plan)
    return TrainState(step=0, digital=digital, sliced=sliced, rng=prng.PRNGKey(7))


def param_shapes(digital, sliced):
    """The param tree's shapes and dtypes (f32, as the reference's params),
    read off the split state: what a plan resolves against."""
    return tree.map(
        lambda d, s: d if s is None else ShapeDtype(tuple(s.planes.shape[1:]), torch.float32),
        digital, sliced,
    )


def make_train_step(cfg: LMConfig, opt_cfg: PantherConfig, lr_schedule, mesh=None, global_batch: int | None = None,
                    remat="full", microbatches: int = 1, fsdp: bool = False, grad_dtype=torch.float32,
                    operand_grads: bool = True, plan=None, plan_rules=None, stash_fallback: bool = False):
    """Returns ``train_step(state, batch) -> (state', metrics)``; ``metrics``
    holds ``loss``, ``aux`` and ``grad_norm`` (device scalars) and ``lr`` (a
    float).

    ``cfg.fidelity``, or per leaf ``plan``/``plan_rules``, turns on
    crossbar-in-the-loop training; it rides the operand pipeline. The
    sliced state's planes are updated in place. ``remat``,
    ``microbatches``, ``grad_dtype`` and ``stash_fallback`` as in the
    module docstring; ``stash_fallback`` only augments the default rules.

    ``mesh``, a live ``launch.mesh.Mesh``: the mesh step (module
    docstring) on this rank's blocks (``shard_state(train_state_init(...,
    plan=step.plan), step.specs, mesh)``), the whole batch given to every
    rank (``global_batch``, when given, must be its batch size); ``fsdp``
    shards the planes over 'data' too. Without a mesh
    ``fsdp`` changes nothing, as in the reference."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    remat = lm.remat_mode(remat)
    fidelity = cfg.fidelity
    if (plan is not None or plan_rules is not None) and fidelity is not None:
        raise ValueError("with an explicit plan, attach fidelity per leaf via PlanRule(fidelity=...) "
                         "instead of cfg.fidelity")
    if plan is not None and plan_rules is not None:
        raise ValueError("pass either a resolved plan or plan_rules, not both")
    if stash_fallback and (plan is not None or plan_rules is not None):
        raise ValueError("stash_fallback only augments the default rules; append "
                         "plan.operand_stash_rule() to your plan_rules (or resolve it into your plan)")
    if fidelity is not None and fidelity.spec != opt_cfg.spec:
        raise ValueError(f"FidelityConfig.spec {fidelity.spec} must match the optimizer plane layout {opt_cfg.spec}")
    rules = tuple(plan_rules) if plan_rules is not None else planlib.default_rules(
        opt_cfg, fidelity=fidelity, stash_fallback=stash_fallback)
    lay = _Blocks(cfg, opt_cfg, mesh, fsdp, operand_grads, plan, rules, global_batch) if mesh is not None \
        else _Whole()
    resolved = {}  # tokens per microbatch -> plan

    def plan_of(state: TrainState, tokens: int):
        if lay.plan is not None:
            return lay.plan
        if tokens not in resolved:
            p = plan if plan is not None else planlib.resolve_plan(
                param_shapes(state.digital, state.sliced), rules, tokens=tokens)
            resolved[tokens] = _check_operand_pipeline(p, operand_grads)
        return resolved[tokens]

    def leaf_param(path, d, s, pl):
        """``(owner, use)``: the differentiated copy of one leaf (a digital
        leaf, or a mapped leaf's dequantized planes), and what the forward
        reads (the same, or on a mesh gathered at use); None where the
        fidelity reads need no dense copy."""
        if s is None:
            t = lay.digital(path, d).detach().requires_grad_(True)
            return t, t
        if operand_grads and not panther.needs_dense(s, pl):
            return None, None
        w = lay.owned(path, dequantize_planes(s.planes, s.frac_bits, pl.spec, dtype=opt_cfg.compute_dtype))
        w.requires_grad_(not (operand_grads and pl.grad == "operand"))
        return w, lay.at_use(path, w)

    def grads_of(params, wrt, sliced, plan_t, batch, tokens, dp, D):
        """One forward and backward: the loss, the aux term and the gradient
        tree (dense tensors; ``OuterProductGrad`` at operand leaves, cut to
        this rank's block). Fresh slots each call, so every microbatch's
        operands land in their own. The loss is scaled by this rank's
        share of the tokens (1 on one device) before the backward."""
        if operand_grads:
            params = panther.operandize(params, sliced, plan_t, expert_tokens=expert_tokens(cfg, tokens),
                                        tokens=tokens)
        with lay.reads(dp):
            nll, aux = lm.loss_parts(cfg, params, batch, remat=remat)
            loss = nll + lm.AUX_WEIGHT * aux
            # a leaf the loss never reads (the shared experts' norm scale: the
            # reference's shared MLP has one, and its moe_apply skips it) gets a
            # zero gradient, as under jax.grad
            gs = torch.autograd.grad(loss * (1.0 / D), [p for _, p in wrt], allow_unused=True)
        dense = {path: torch.zeros_like(p) if g is None else g for (path, p), g in zip(wrt, gs)}
        grads = tree.map_with_path(
            lambda path, p: lay.operand_block(path, p.slot.grad(), dp) if isinstance(p, XbarWeight)
            else dense[path], params)
        return loss.detach(), aux.detach(), grads

    def train_step(state: TrainState, batch):
        if microbatches > 1 and batch["inputs"].shape[0] != microbatches:
            raise ValueError(f"microbatches={microbatches} takes batch leaves shaped [G, B/G, S], "
                             f"got inputs {tuple(batch['inputs'].shape)}")
        batch, dp, D = lay.local_batch(batch, microbatches)
        inp = batch["inputs"]
        lead = inp.shape if cfg.input_mode == "tokens" else inp.shape[:-1]  # embeddings: [..., B, S, d]
        tokens = lead[-2] * lead[-1]
        plan_t = plan_of(state, tokens)
        made = tree.map_with_path(leaf_param, state.digital, state.sliced, plan_t)
        params = tree.map(lambda m: m[1], made)
        wrt = [(path, m[0]) for path, m in tree.leaves_with_path(made) if m[0] is not None and m[0].requires_grad]
        sliced = tree.map_with_path(lay.read_planes, state.sliced, plan_t)
        if microbatches == 1:
            loss, aux, grads = grads_of(params, wrt, sliced, plan_t, batch, tokens, dp, D)
        else:
            loss, aux, dense, ops = None, None, {}, {}
            for g in range(microbatches):
                l_g, a_g, g_g = grads_of(params, wrt, sliced, plan_t, {k: v[g] for k, v in batch.items()},
                                         tokens, dp, D)
                loss = l_g if loss is None else loss + l_g
                aux = a_g if aux is None else aux + a_g
                for path, x in tree.leaves_with_path(g_g):
                    if isinstance(x, OuterProductGrad):
                        ops.setdefault(path, []).append(x)
                    else:
                        x = x.to(grad_dtype)
                        dense[path] = dense[path] + x if path in dense else x
                del l_g, x
            loss, aux = loss / microbatches, aux / microbatches
            grads = tree.map_with_path(lambda path, _: _merge_operands(ops[path], microbatches) if path in ops
                                       else dense[path] / microbatches, g_g)
            del g_g, ops, dense
        del params, made, wrt, sliced  # the dense layer copies
        grads = tree.map_with_path(lambda path, g: lay.local_grad(path, g, dp), grads)
        lr = lr_schedule(state.step)
        with torch.no_grad():
            digital, sliced = panther.update_split(grads, state.digital, state.sliced, state.step, lr,
                                                   opt_cfg, rng=state.rng, plan=plan_t, origins=lay.origins)
            gnorm = torch.sqrt(lay.over_mesh(panther.grad_sq_norm(grads, keep=lay.counts)))
            loss, aux = lay.over_data(loss, aux, dp, D)
        new_state = TrainState(step=state.step + 1, digital=digital, sliced=sliced, rng=state.rng)
        return new_state, {"loss": loss, "aux": aux, "lr": lr, "grad_norm": gnorm}

    if mesh is not None:
        train_step.specs = lay.specs
        train_step.plan = lay.plan
    return train_step


def _check_operand_pipeline(plan, operand_grads: bool):
    if not operand_grads and any(pl.fidelity is not None for _, pl in tree.leaves_with_path(plan)):
        raise ValueError("fidelity mode rides the operand pipeline (operand_grads=True)")
    return plan


def expert_tokens(cfg: LMConfig, tokens: int) -> int | None:
    """The capacity tokens an expert's operands have in one forward of
    ``tokens`` flattened tokens: ``G · C`` (``G = tokens // sg`` dispatch
    groups of ``sg = min(MOE_GROUP, tokens)``, ``C`` slots an expert a
    group); None without MoE."""
    if cfg.moe is None:
        return None
    from repro_torch.models.mlp import MOE_GROUP, moe_capacity

    sg = min(MOE_GROUP, tokens)
    return (tokens // sg) * moe_capacity(cfg.moe, sg)


def _merge_operands(ops: list, microbatches: int) -> OuterProductGrad:
    """The microbatches' operands of one leaf as one gradient: token tiles
    concatenated in microbatch order along the token axis, -2 for every
    kind (``[*stack, G·T, d]``), ``dh`` scaled by 1/G, so one fused update
    deposits the mean gradient."""
    return OuterProductGrad(torch.cat([o.x for o in ops], dim=-2), torch.cat([o.dh for o in ops], dim=-2),
                            ops[0].kind).scale_dh(1.0 / microbatches)


# ------------------------------------ mesh ------------------------------------


def _plan_of(cfg: LMConfig, opt_cfg: PantherConfig, plan):
    shapes = lm.param_shapes(cfg)
    return shapes, plan if plan is not None else planlib.resolve_plan(shapes, planlib.default_rules(opt_cfg))


def train_state_specs(cfg: LMConfig, opt_cfg: PantherConfig, mesh=None, fsdp: bool = False, plan=None) -> TrainState:
    """The spec tree of a ``TrainState`` (``sharding.P`` leaves; None where
    the split leaves None): digital leaves by the name rules (or ``plan``'s
    shard hints), sanitized; planes ``[S, *w]`` like their matrix with S
    replicated and, with ``fsdp``, a trailing matrix axis over 'data'
    (``sharding.fsdp_spec``); ``frac_bits``, the step and the rng
    replicated."""
    shapes, plan = _plan_of(cfg, opt_cfg, plan)
    dsize = mesh.shape["data"] if (fsdp and mesh is not None) else 1

    def digital(path, leaf, pl):
        if pl.mapped:
            return None
        return _sanitized(shd.leaf_spec(shd._path_str(path), len(leaf.shape), hint=pl.shard), leaf.shape, mesh)

    def sliced(path, leaf, pl):
        if not pl.mapped:
            return None
        ps = shd._path_str(path)
        pshape = (pl.spec.n_slices, *leaf.shape)
        full = _sanitized(shd.P(None, *shd.leaf_spec(ps, len(leaf.shape), hint=pl.shard)), pshape, mesh)
        if fsdp:
            n_tail = len(shd.trailing_spec(ps, hint=pl.shard)) or 2
            full = shd.fsdp_spec(full, pshape, dsize, n_tail=n_tail)
        return SlicedTensor(planes=full, frac_bits=shd.P())

    return TrainState(step=shd.P(), digital=tree.map_with_path(digital, shapes, plan),
                      sliced=tree.map_with_path(sliced, shapes, plan), rng=shd.P())


def storage_specs(cfg: LMConfig, opt_cfg: PantherConfig, mesh, fsdp: bool = False, plan=None) -> TrainState:
    """The layout the mesh step keeps a state in: ``train_state_specs``,
    except that a plane's slice dim S stays whole. Where a matrix dim does
    not divide, the reference's ``sanitize_spec`` over the planes' shape may
    move 'model' onto S; here it moves within the weight's own dims, as the
    reads (``fidelity_plane_specs``) and the gradients place it, so every
    rank holds all S digits of its cells."""
    shapes, plan = _plan_of(cfg, opt_cfg, plan)
    specs = train_state_specs(cfg, opt_cfg, mesh, fsdp, plan=plan)
    dsize = mesh.shape["data"] if fsdp else 1

    def whole_slices(path, sp, leaf, pl):
        if sp is None or sp.planes[0] is None:
            return sp
        ps = shd._path_str(path)
        pshape = (pl.spec.n_slices, *leaf.shape)
        full = shd.P(None, *shd.sanitized_leaf_spec(ps, tuple(leaf.shape), mesh, hint=pl.shard))
        if fsdp:
            full = shd.fsdp_spec(full, pshape, dsize, n_tail=len(shd.trailing_spec(ps, hint=pl.shard)) or 2)
        return SlicedTensor(planes=full, frac_bits=sp.frac_bits)

    return specs._replace(sliced=tree.map_with_path(whole_slices, specs.sliced, shapes, plan))


def _sanitized(spec, shape, mesh):
    return shd.sanitize_spec(spec, tuple(shape), mesh) if mesh is not None else spec


def grad_specs(cfg: LMConfig, opt_cfg: PantherConfig, mesh=None, fsdp: bool = False, operand: bool = False,
               mb_batch: int | None = None, plan=None):
    """The spec tree of the gradients: the stored planes' minus the S dim;
    with ``operand``, an operand leaf's ``OuterProductGrad`` of specs
    (``sharding.operand_grad_spec``)."""
    shapes, plan = _plan_of(cfg, opt_cfg, plan)
    dsize = mesh.shape["data"] if (fsdp and mesh is not None) else 1

    def spec(path, leaf, pl):
        ps = shd._path_str(path)
        if operand and pl.mapped and pl.grad == "operand":
            return shd.operand_grad_spec(ps, tuple(leaf.shape), mesh, mb_batch, hint=pl.shard, group=pl.group)
        base = _sanitized(shd.leaf_spec(ps, len(leaf.shape), hint=pl.shard), leaf.shape, mesh)
        if fsdp and pl.mapped:
            n_tail = len(shd.trailing_spec(ps, hint=pl.shard)) or 2
            base = shd.fsdp_spec(base, tuple(leaf.shape), dsize, n_tail=n_tail)
        return base

    return tree.map_with_path(spec, shapes, plan)


def batch_specs(cfg: LMConfig, mesh, global_batch: int, microbatches: int = 1) -> dict:
    """Specs of the batch leaves: the (per-microbatch) batch dim over the
    data axes that divide it; ``[G, B/G, ...]`` with microbatches."""
    mb = global_batch // microbatches
    lead = (None,) if microbatches > 1 else ()
    b = shd.P(*(lead + tuple(shd.data_spec(mesh, mb, 2))))
    if cfg.input_mode == "tokens":
        return {"inputs": b, "labels": b}
    return {"inputs": shd.P(*(lead + tuple(shd.data_spec(mesh, mb, 3)))), "labels": b}


def shard_state(state: TrainState, specs: TrainState, mesh) -> TrainState:
    """This rank's blocks of a whole ``state`` (copies: the whole state may
    be freed), laid out for the kernels. The state must map the leaves the
    specs' plan maps (``train_state_init(..., plan=step.plan)``)."""
    def check(path, x, sp):
        if (x is None) != (sp is None):
            raise ValueError(f"leaf {path}: the state and the specs disagree on which leaves are mapped; "
                             "initialize the state with the step's plan (train_state_init(..., plan=step.plan))")

    tree.map_with_path(check, state.digital, specs.digital)

    def dig(d, sp):
        return None if d is None else blocks.local_block(d, sp, mesh).clone()

    def sl(s, sp):
        if s is None:
            return None
        planes = s.planes[blocks.block_slices(sp.planes, tuple(s.planes.shape), mesh)]
        return SlicedTensor(planes=blocks.layer_major(planes), frac_bits=s.frac_bits.clone())

    return TrainState(state.step, tree.map(dig, state.digital, specs.digital), tree.map(sl, state.sliced, specs.sliced),
                      state.rng)


def gather_state(state: TrainState, specs: TrainState, mesh) -> TrainState:
    """The whole state from every rank's blocks, on every rank (a
    collective: every rank calls it); copies, never the blocks
    themselves. Planes are gathered in their layer-major storage, so the
    whole leaf lands in it with no further copy."""
    def fresh(t, local):
        return t.clone() if t is local else t

    def dig(d, sp):
        return None if d is None else fresh(blocks.gather(d, sp, mesh), d)

    def sl(s, sp):
        if s is None:
            return None
        n = s.planes.dim() - 3
        store = s.planes.movedim(0, n)  # [*stack, S, m, n], this rank's contiguous storage
        spec = tuple(sp.planes[1:1 + n]) + (None,) + tuple(sp.planes[1 + n:])
        return SlicedTensor(planes=fresh(blocks.gather(store, spec, mesh), store).movedim(n, 0),
                            frac_bits=s.frac_bits.clone())

    return TrainState(state.step, tree.map(dig, state.digital, specs.digital), tree.map(sl, state.sliced, specs.sliced),
                      state.rng)


class _GatherBlock(torch.autograd.Function):
    """A block all-gathered over its spec's axes; the backward returns the
    block's part of the whole gradient (every rank of those axes computes
    the same whole gradient from the same tokens)."""

    @staticmethod
    def forward(ctx, t, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return blocks.gather(t, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        return g[blocks.block_slices(ctx.spec, tuple(g.shape), ctx.mesh)], None, None


def block_origin(spec, shape: tuple, mesh):
    """The ``Origin`` of this rank's block of a leaf of dense ``shape``
    ``[*stack, M, N]`` under ``spec`` (the planes' minus S); None when the
    block is the whole leaf."""
    sl = blocks.block_slices(spec, shape, mesh)
    if all(s.start == 0 and s.stop == d for s, d in zip(sl, shape)):
        return None
    stack = shape[:-2]
    layers = None
    if any(s.start != 0 or s.stop != d for s, d in zip(sl[:-2], stack)):
        layers = tuple(int(sum(i * math.prod(stack[k + 1:]) for k, i in enumerate(idx)))
                       for idx in itertools.product(*(range(s.start, s.stop) for s in sl[:-2])))
    return Origin(sl[-2].start, sl[-1].start, shape[-2], shape[-1], layers)


class _Whole:
    """Where the single-device step's leaves live: whole on this process.
    Each hook is the identity; ``_Blocks`` overrides them on a mesh."""

    plan = None  # resolved per token count by the step
    origins = None

    def local_batch(self, batch, microbatches):
        """``(this rank's batch, the data axes it is sharded over, their size)``."""
        return batch, (), 1

    def digital(self, path, d):
        return d

    def owned(self, path, w):
        return w

    def at_use(self, path, w):
        return w

    def read_planes(self, path, s, pl):
        return s

    def reads(self, dp):
        return contextlib.nullcontext()

    def operand_block(self, path, g, dp):
        return g

    def local_grad(self, path, g, dp):
        return g

    def counts(self, path) -> bool:
        return True

    def over_mesh(self, t):
        return t

    def over_data(self, loss, aux, dp, D):
        return loss, aux


class _Blocks(_Whole):
    """Where the mesh step's leaves live: this rank's block of each, under
    ``storage_specs`` (module docstring)."""

    def __init__(self, cfg, opt_cfg, mesh, fsdp, operand_grads, plan, rules, global_batch):
        if not mesh.live:
            raise ValueError("make_train_step(mesh=...) runs on a live mesh (launch.mesh.init_mesh), not a logical one")
        shapes = lm.param_shapes(cfg)
        plan = plan if plan is not None else planlib.resolve_plan(shapes, rules)  # token rules are inert on a mesh
        self.plan = planlib.attach_fidelity_shard_dims(_check_operand_pipeline(plan, operand_grads), mesh, shapes)
        self.specs = storage_specs(cfg, opt_cfg, mesh, fsdp, plan=self.plan)
        mspecs = storage_specs(cfg, opt_cfg, mesh, False, plan=self.plan) if fsdp else self.specs
        self.mesh, self.fsdp, self.global_batch = mesh, fsdp, global_batch
        self.maxis = "model" if mesh.shape.get("model", 1) > 1 else None
        self.stacked_groups = {gi for gi, (_, count) in enumerate(cfg.pattern) if count > 1}
        self.shape_at = {path: tuple(leaf.shape) for path, leaf in tree.leaves_with_path(shapes)}
        self.d_spec = dict(tree.leaves_with_path(self.specs.digital))
        self.w_spec = {path: sp.planes[1:] for path, sp in tree.leaves_with_path(self.specs.sliced) if sp is not None}
        self.m_spec = {path: sp.planes[1:] for path, sp in tree.leaves_with_path(mspecs.sliced) if sp is not None}
        self.origins = {path: o for path, sp in self.w_spec.items()
                        if (o := block_origin(sp, self.shape_at[path], mesh)) is not None}

    def fsdp_part(self, path):
        """The dims of a leaf's stored spec that FSDP added ('data' alone)."""
        return tuple(e if e != m else None for e, m in zip(self.w_spec[path], self.m_spec[path]))

    def local_batch(self, batch, microbatches):
        bdim = 1 if microbatches > 1 else 0
        B = batch["inputs"].shape[bdim]
        if self.global_batch is not None and B * microbatches != self.global_batch:
            raise ValueError(f"global_batch={self.global_batch} but the batch holds {B} rows a microbatch")
        dp = shd.data_axes_for(self.mesh, B)
        rows = blocks.block_slices((dp if dp else None,), (B,), self.mesh)[0]
        return {k: v[(slice(None),) * bdim + (rows,)] for k, v in batch.items()}, dp, self.mesh.axes_size(dp)

    def digital(self, path, d):
        """A digital leaf gathered whole."""
        return blocks.gather(d, self.d_spec[path], self.mesh)

    def owned(self, path, w):
        """A mapped leaf's dequantized block gathered over FSDP's data axis:
        the block whose gradient this rank owns."""
        return blocks.gather(w, self.fsdp_part(path), self.mesh) if self.fsdp else w

    def at_use(self, path, w):
        """The owned block gathered over the model axis where the forward
        reads it, a layer at a time in a stacked group."""
        spec = self.m_spec[path]
        if not blocks.sharded(spec):
            return w
        if path[0] == "groups" and path[1] in self.stacked_groups and not blocks.sharded(spec[:1]):
            return LayerStack(lambda i, t=w, sp=spec[1:]: _GatherBlock.apply(t[i], sp, self.mesh))
        return _GatherBlock.apply(w, spec, self.mesh)

    def read_planes(self, path, s, pl):
        """A fidelity leaf's planes as its reads take them
        (``blocks.read_block``: FSDP's data axis and an expert stack
        gathered, the tile block kept)."""
        if s is None or pl.fidelity is None or pl.grad != "operand":
            return s
        return blocks.read_block(s, (None,) + self.w_spec[path], pl.fidelity.shard_dim, self.mesh)

    def reads(self, dp):
        return dist_fid.use_sharded_fidelity(dist_fid.ShardCtx(mesh=self.mesh, data_axes=dp, model_axis=self.maxis))

    def _cut(self, g: OuterProductGrad, spec, shape) -> OuterProductGrad:
        """Operands cut to the block of a leaf of ``shape`` under ``spec``:
        ``x [*stack, T, M]`` / ``dh [*stack, T, N]`` to its stack, rows and
        columns; im2col ``x [*stack, C, T, K]`` / ``dh [*stack, C, T, 1]``
        to its stack, channels and taps."""
        sl = blocks.block_slices(spec, shape, self.mesh)
        if g.kind == "im2col":
            return OuterProductGrad(g.x[(*sl[:-2], sl[-1], slice(None), sl[-2])], g.dh[(*sl[:-2], sl[-1])], g.kind)
        return OuterProductGrad(g.x[(*sl[:-2], slice(None), sl[-2])], g.dh[(*sl[:-2], slice(None), sl[-1])], g.kind)

    def operand_block(self, path, g: OuterProductGrad, dp) -> OuterProductGrad:
        """A leaf's operands cut to this rank's model block (stack, rows,
        cols; a conv-tap leaf's channels and taps), gathered along the token
        axis over the data axes (an expert bank's ``G·C`` capacity rows
        group-major, so the ranks' groups land in global order), then cut to
        the FSDP part of the block."""
        if blocks.sharded(self.m_spec[path]):
            g = self._cut(g, self.m_spec[path], self.shape_at[path])
        x = col.all_gather(g.x.contiguous(), self.mesh, dp, dim=g.x.dim() - 2)
        dh = col.all_gather(g.dh.contiguous(), self.mesh, dp, dim=g.dh.dim() - 2)
        g = OuterProductGrad(x, dh, g.kind)
        if self.fsdp and blocks.sharded(self.fsdp_part(path)):
            g = self._cut(g, self.fsdp_part(path), blocks.block_shape(self.m_spec[path], self.shape_at[path],
                                                                      self.mesh))
            g = OuterProductGrad(g.x.contiguous(), g.dh.contiguous(), g.kind)
        return g

    def local_grad(self, path, g, dp):
        """A dense gradient of this rank's block, summed over the data axes."""
        if isinstance(g, OuterProductGrad):
            return g
        if self.d_spec.get(path) is not None:
            return col.all_reduce(g[blocks.block_slices(self.d_spec[path], tuple(g.shape), self.mesh)].contiguous(),
                                  self.mesh, dp)
        g = col.all_reduce(g.contiguous(), self.mesh, dp)
        if not self.fsdp:
            return g
        return g[blocks.block_slices(self.fsdp_part(path), tuple(g.shape), self.mesh)].contiguous()

    def counts(self, path) -> bool:
        """Whether this rank's block of a leaf counts in the norm: once over
        the ranks that hold copies of it."""
        return blocks.owner(self.w_spec.get(path, self.d_spec.get(path)), self.mesh)

    def over_mesh(self, t):
        return col.all_reduce(t.reshape(1), self.mesh, self.mesh.axis_names)[0]

    def over_data(self, loss, aux, dp, D):
        red = col.all_reduce(torch.stack([loss, aux]).to(torch.float32), self.mesh, dp) / D
        return red[0], red[1]
