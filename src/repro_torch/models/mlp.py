"""Gated MLPs (SwiGLU / GeGLU) and the capacity-bounded MoE layer (port of
``repro.models.mlp``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import LMConfig, dense_init, gelu, rms_norm, rms_norm_init, xbar_grouped_linear, xbar_linear


def _act(name: str):
    return {"silu": F.silu, "gelu": gelu}[name]


def mlp_init(cfg: LMConfig, gen: torch.Generator, d_ff: int, *, stack: tuple = (),
             device=None) -> dict:
    d = cfg.d_model
    p = {
        "wi_gate": dense_init(gen, d, d_ff, stack=stack, device=device),
        "wi_up": dense_init(gen, d, d_ff, stack=stack, device=device),
        "wo": dense_init(gen, d_ff, d, stack=stack, device=device),
        "ln": rms_norm_init(d, stack=stack, device=device),
    }
    if cfg.post_norm:
        p["post_ln"] = rms_norm_init(d, stack=stack, device=device)
    return p


def mlp_apply(cfg: LMConfig, p, h: torch.Tensor) -> torch.Tensor:
    x = rms_norm(p["ln"], h, cfg.norm_eps)
    act = _act(cfg.act)
    y = act(xbar_linear(x, p["wi_gate"], h.dtype)) * xbar_linear(x, p["wi_up"], h.dtype)
    y = xbar_linear(y, p["wo"], h.dtype)
    if cfg.post_norm:
        y = rms_norm(p["post_ln"], y, cfg.norm_eps)
    return h + y


# ------------------------------- MoE ----------------------------------------


def moe_init(cfg: LMConfig, gen: torch.Generator, *, stack: tuple = (), device=None) -> dict:
    """Router ``[*stack, d, E]``, expert banks ``[*stack, E, d, f]`` /
    ``[*stack, E, f, d]`` (N(0, 1/fan_in)), the norm, and the shared
    experts' gated MLP when ``n_shared > 0``."""
    m = cfg.moe
    d, E, f = cfg.d_model, m.n_experts, m.d_ff_expert
    p = {
        "router": dense_init(gen, d, E, stack=stack, device=device),
        "experts_gate": dense_init(gen, d, f, stack=(*stack, E), device=device),
        "experts_up": dense_init(gen, d, f, stack=(*stack, E), device=device),
        "experts_down": dense_init(gen, f, d, stack=(*stack, E), device=device),
        "ln": rms_norm_init(d, stack=stack, device=device),
    }
    if m.n_shared > 0:
        p["shared"] = mlp_init(cfg, gen, m.d_ff_shared * m.n_shared, stack=stack, device=device)
    return p


MOE_GROUP = 1024  # tokens per dispatch group (GShard-style)


def _top_k(gates: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last dim, the lower index
    first among equal values (a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(m, sg: int) -> int:
    """Per-expert capacity of one dispatch group of ``sg`` tokens."""
    return max(m.top_k, int(m.capacity_factor * sg * m.top_k / m.n_experts))


def moe_route(m, logits: torch.Tensor, C: int):
    """Routing of f32 router logits ``[G, S, E]``: the renormalized top-k
    gates ``topw`` and experts ``topi`` ``[G, S, K]``, each assignment's
    position ``pos`` in its expert's group buffer (a cumsum over the ``(s,
    k)`` assignments flattened token-major) and ``keep = pos < C``."""
    G, sg, E = logits.shape
    K = m.top_k
    gates = torch.softmax(logits, dim=-1)
    topw, topi = _top_k(gates, K)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)  # renormalize
    onehot = F.one_hot(topi, E).to(torch.int32)  # [G, S, K, E]
    flat = onehot.reshape(G, sg * K, E)
    pos_in_expert = (torch.cumsum(flat, dim=1, dtype=torch.int32) - flat).reshape(G, sg, K, E)
    pos = (pos_in_expert * onehot).sum(-1)
    return topw, topi, pos, pos < C  # a dropped assignment rides the residual


def moe_apply(cfg: LMConfig, p, h: torch.Tensor, with_aux: bool = False):
    """Capacity-bounded dense-dispatch MoE (GShard style). Tokens split into
    ``G`` groups of ``sg = min(MOE_GROUP, T)``; each expert takes at most
    ``C`` tokens a group, in ``(s, k)`` order flattened token-major, and a
    token over capacity rides the residual. The router and the expert banks
    read through ``xbar_linear`` / ``xbar_grouped_linear``, so under an
    operand plan the router is one crossbar read and every expert a grouped
    crossbar tile. ``with_aux`` also returns the load-balance loss from the
    same router logits (an operand-mapped router is read once a step).

    On a mesh (a ``distributed.fidelity.ShardCtx`` whose data axes hold
    more than one rank, ``h`` this rank's rows) the groups are the global
    batch's, as in the reference's one program over the whole batch. Where
    this rank's tokens are whole global groups (``groups_aligned``) they are
    dispatched here, and the load-balance term's two means are taken over
    the data axes. Otherwise (decode's few tokens, or a training batch
    whose groups span ranks) the normed input is all-gathered over the data
    axes in global row order, the global groups dispatched and run through
    the experts on every rank, and this rank's rows kept. In the backward
    the layer's output cotangent is averaged over the data axes
    (``collectives.mean_grad``): each rank's loss, scaled by its share of
    the tokens, reaches the output through its own rows only, so every rank
    then runs the same backward, one process's over D, and its crossbar
    reads quantize the whole cotangent as one process's do (the DAC's
    exponent moves by log2 D, its codes stay). The gather's backward sums
    the input's cotangent over the data axes and keeps this rank's rows
    (``collectives.all_gather_with_grad``). So the experts' and the
    router's gradients summed over the data axes are the batch's. The
    load-balance term is the global logits' on every rank, so it enters the
    sum of the ranks' scaled losses once."""
    B, S, d = h.shape
    x = rms_norm(p["ln"], h, cfg.norm_eps)
    ctx = _data_ctx()
    if ctx is None or groups_aligned(B * S, ctx.mesh.axes_size(ctx.data_axes)):
        yt, logits = _moe_ffn(cfg, p, x)
        out = h + yt
        return (out, _aux_from_logits(cfg.moe, logits, ctx)) if with_aux else out
    from repro_torch.distributed import blocks
    from repro_torch.distributed import collectives as col

    yt, logits = _moe_ffn(cfg, p, col.all_gather_with_grad(x, ctx.mesh, ctx.data_axes, dim=0))
    yt = col.mean_grad(yt, ctx.mesh, ctx.data_axes)
    out = h + yt[blocks.block_slices((ctx.data_axes,), (yt.shape[0],), ctx.mesh)[0]]
    return (out, _aux_from_logits(cfg.moe, logits)) if with_aux else out


def groups_aligned(tokens: int, data_ranks: int) -> bool:
    """Whether a data rank's ``tokens`` (its contiguous share of a batch of
    ``tokens · data_ranks``) are whole dispatch groups of that batch: then
    its local groups are the global ones."""
    return tokens % min(MOE_GROUP, tokens * data_ranks) == 0


def _data_ctx():
    """The active mesh context when its data axes hold more than one rank
    (``distributed.fidelity``), else None."""
    from repro_torch.distributed import fidelity as dist_fid

    ctx = dist_fid.active()
    if isinstance(ctx, dist_fid.ShardCtx) and ctx.data_axes and ctx.mesh.axes_size(ctx.data_axes) > 1:
        return ctx
    return None


def _moe_ffn(cfg: LMConfig, p, x: torch.Tensor):
    """The MoE layer's output ``[B, S, d]`` (without the residual) on normed
    tokens ``x [B, S, d]``, and the f32 router logits ``[G, sg, E]``."""
    m = cfg.moe
    act = _act(cfg.act)
    B, S, d = x.shape
    T = B * S
    sg = min(MOE_GROUP, T)
    G = T // sg
    assert T % sg == 0, (T, sg)
    xt = x.reshape(G, sg, d)
    E, K = m.n_experts, m.top_k
    C = moe_capacity(m, sg)
    dt = xt.dtype

    logits = xbar_linear(xt, p["router"], dt).to(torch.float32)  # [G, S, E]
    topw, topi, pos, keep = moe_route(m, logits, C)

    slots = torch.arange(C, device=x.device)
    experts = torch.arange(E, device=x.device)
    disp = torch.zeros((G, sg, E, C), dtype=dt, device=x.device)
    comb = torch.zeros((G, sg, E, C), dtype=dt, device=x.device)
    for k in range(K):  # one [G, S, E, C] buffer at a time
        dk = ((topi[..., k, None] == experts).to(dt)[..., None]
              * (pos[..., k, None] == slots).to(dt)[..., None, :]
              * keep[..., k, None, None].to(dt))
        disp = disp + dk
        comb = comb + dk * topw[..., k, None, None].to(dt)

    # dispatch and combine one group at a time: a group's sums (the combine's
    # over its tokens' expert slots, and both backwards) then run in one
    # order whatever the number of groups a process holds, so a data rank's
    # groups compute what one process's do
    xe = torch.stack([torch.einsum("sec,sd->ecd", disp[g], xt[g]) for g in range(G)], dim=1).reshape(E, G * C, d)
    ye = act(xbar_grouped_linear(xe, p["experts_gate"], dt))
    ye = ye * xbar_grouped_linear(xe, p["experts_up"], dt)
    ye = xbar_grouped_linear(ye, p["experts_down"], dt).reshape(E, G, C, d)
    yt = torch.stack([torch.einsum("sec,ecd->sd", comb[g], ye[:, g]) for g in range(G)])

    if m.n_shared > 0:
        # shared experts run densely on every token; their weights stay
        # dense-gradient (used by every token of every MoE layer)
        sh = p["shared"]
        ys = act(torch.einsum("gsd,df->gsf", xt, sh["wi_gate"].to(dt)))
        ys = ys * torch.einsum("gsd,df->gsf", xt, sh["wi_up"].to(dt))
        yt = yt + torch.einsum("gsf,fd->gsd", ys, sh["wo"].to(dt))
    return yt.reshape(B, S, d), logits


def _aux_from_logits(m, logits: torch.Tensor, ctx=None) -> torch.Tensor:
    """Load-balance loss (Switch): ``E · sum(frac_tokens · frac_prob)`` from
    router logits ``[..., E]``. With a mesh context ``ctx`` (this rank's
    tokens a data shard of the batch) both means are the batch's, summed
    over the data axes: the value is the batch's term on every rank, and
    its gradient reaches this rank's gates as ``E · frac_tokens``, so the
    ranks' gradients, each scaled by its share of the tokens and summed,
    are the batch term's."""
    gates = torch.softmax(logits.reshape(-1, logits.shape[-1]).to(torch.float32), dim=-1)
    topi = torch.argmax(gates, dim=-1)
    frac_tokens = torch.mean(F.one_hot(topi, m.n_experts).to(torch.float32), dim=0)
    frac_prob = torch.mean(gates, dim=0)
    if ctx is not None:
        from repro_torch.distributed import collectives as col

        D = ctx.mesh.axes_size(ctx.data_axes)
        both = col.all_reduce(torch.stack([frac_tokens, frac_prob.detach()]), ctx.mesh, ctx.data_axes) / D
        frac_tokens, frac_prob = both[0], both[1] + (frac_prob - frac_prob.detach())
    return m.n_experts * torch.sum(frac_tokens * frac_prob)


def moe_aux_loss(cfg: LMConfig, p, h: torch.Tensor) -> torch.Tensor:
    """The load-balance loss alone (a second router read). Training uses
    ``moe_apply(..., with_aux=True)``: an operand-mapped router is read once
    a step."""
    x = rms_norm(p["ln"], h, cfg.norm_eps).reshape(-1, h.shape[-1])
    logits = xbar_linear(x, p["router"], x.dtype)
    return _aux_from_logits(cfg.moe, logits)
