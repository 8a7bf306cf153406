"""The PANTHER train step (port of ``repro.train.step``), single device.

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
a host function, so nothing in the step waits on the device. Not ported:
meshes and FSDP, remat (activations are kept).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import plan as planlib
from repro_torch import tree
from repro_torch.core import prng
from repro_torch.core.slicing import dequantize_planes
from repro_torch.models import lm
from repro_torch.models.common import LMConfig, OuterProductGrad, ShapeDtype, XbarWeight
from repro_torch.optim import PantherConfig, panther


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


def make_train_step(cfg: LMConfig, opt_cfg: PantherConfig, lr_schedule, mesh=None,
                    microbatches: int = 1, fsdp: bool = False, grad_dtype=torch.float32,
                    operand_grads: bool = True, plan=None, plan_rules=None, stash_fallback: bool = False):
    """Returns ``train_step(state, batch) -> (state', metrics)``; ``metrics``
    holds ``loss``, ``aux`` and ``grad_norm`` (device scalars) and ``lr`` (a
    float).

    ``cfg.fidelity``, or per leaf ``plan``/``plan_rules``, turns on
    crossbar-in-the-loop training; it rides the operand pipeline. The
    sliced state's planes are updated in place. ``microbatches``,
    ``grad_dtype`` and ``stash_fallback`` as in the module docstring;
    ``stash_fallback`` only augments the default rules."""
    if mesh is not None or fsdp:
        raise NotImplementedError("meshes and FSDP are not ported yet (single device only)")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
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
    resolved = {}  # tokens per microbatch -> plan

    def plan_of(state: TrainState, tokens: int):
        if tokens not in resolved:
            p = plan if plan is not None else planlib.resolve_plan(
                param_shapes(state.digital, state.sliced), rules, tokens=tokens)
            if not operand_grads and any(pl.fidelity is not None for _, pl in tree.leaves_with_path(p)):
                raise ValueError("fidelity mode rides the operand pipeline (operand_grads=True)")
            resolved[tokens] = p
        return resolved[tokens]

    def leaf_param(d, s, pl):
        """The differentiated copy of one leaf: a digital leaf, or a mapped
        leaf's dequantized planes; None where the fidelity reads need none."""
        if s is None:
            return d.detach().requires_grad_(True)
        if operand_grads and not panther.needs_dense(s, pl):
            return None
        w = dequantize_planes(s.planes, s.frac_bits, pl.spec, dtype=opt_cfg.compute_dtype)
        return w.requires_grad_(not (operand_grads and pl.grad == "operand"))

    def grads_of(params, wrt, sliced, plan_t, batch, tokens):
        """One forward and backward: the loss, the aux term and the gradient
        tree (dense tensors; ``OuterProductGrad`` at operand leaves). Fresh
        slots each call, so every microbatch's operands land in their own."""
        if operand_grads:
            params = panther.operandize(params, sliced, plan_t, expert_tokens=expert_tokens(cfg, tokens),
                                        tokens=tokens)
        nll, aux = lm.loss_parts(cfg, params, batch)
        loss = nll + lm.AUX_WEIGHT * aux
        # a leaf the loss never reads (the shared experts' norm scale: the
        # reference's shared MLP has one, and its moe_apply skips it) gets a
        # zero gradient, as under jax.grad
        gs = torch.autograd.grad(loss, [p for _, p in wrt], allow_unused=True)
        dense = {path: torch.zeros_like(p) if g is None else g for (path, p), g in zip(wrt, gs)}
        grads = tree.map_with_path(
            lambda path, p: p.slot.grad() if isinstance(p, XbarWeight) else dense[path], params)
        return loss.detach(), aux.detach(), grads

    def train_step(state: TrainState, batch):
        inp = batch["inputs"]
        if microbatches > 1 and inp.shape[0] != microbatches:
            raise ValueError(f"microbatches={microbatches} takes batch leaves shaped [G, B/G, S], "
                             f"got inputs {tuple(inp.shape)}")
        lead = inp.shape if cfg.input_mode == "tokens" else inp.shape[:-1]  # embeddings: [..., B, S, d]
        tokens = lead[-2] * lead[-1]
        plan_t = plan_of(state, tokens)
        params = tree.map(leaf_param, state.digital, state.sliced, plan_t)
        wrt = [(path, p) for path, p in tree.leaves_with_path(params)
               if isinstance(p, torch.Tensor) and p.requires_grad]
        if microbatches == 1:
            loss, aux, grads = grads_of(params, wrt, state.sliced, plan_t, batch, tokens)
        else:
            loss, aux, dense, ops = None, None, {}, {}
            for g in range(microbatches):
                l_g, a_g, g_g = grads_of(params, wrt, state.sliced, plan_t, {k: v[g] for k, v in batch.items()},
                                         tokens)
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
        del params, wrt  # the dense layer copies
        lr = lr_schedule(state.step)
        with torch.no_grad():
            digital, sliced = panther.update_split(grads, state.digital, state.sliced, state.step, lr,
                                                   opt_cfg, rng=state.rng, plan=plan_t)
            gnorm = panther.global_grad_norm(grads)
        new_state = TrainState(step=state.step + 1, digital=digital, sliced=sliced, rng=state.rng)
        return new_state, {"loss": loss, "aux": aux, "lr": lr, "grad_norm": gnorm}

    return train_step


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
