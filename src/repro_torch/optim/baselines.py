"""Float-path optimizers (port of ``repro.optim.baselines``): the digital
baselines of the paper's experiments.

``sgd`` is the exact-arithmetic counterpart of the PANTHER update, the
float-SGD line of the Fig-9 study and the quickstart; ``adamw`` is for
general use. Both walk the gradient tree in ``jax.tree.flatten``'s order
and use the reference's formulas, op for op, in f32. The step is a host
int. AdamW's bias corrections take ``b ** step`` from ``torch.pow``, which
differs from XLA's by an ulp at some steps (the first at step 6 for
``b2 = 0.95``), so the two agree bit for bit up to there; its square root
is correctly rounded, as XLA's is.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree


class SGDState(NamedTuple):
    step: int
    momentum: Any  # tree: f32 buffer per leaf, or None per leaf without momentum


def _rebuild(like, by_path: dict):
    return tree.map_with_path(lambda path, _: by_path[path], like)


def sgd_init(params, momentum: float = 0.0) -> SGDState:
    return SGDState(step=0, momentum=tree.map(lambda p: torch.zeros_like(p) if momentum > 0 else None, params))


def sgd_update(grads, state: SGDState, params, lr: float, momentum: float = 0.0):
    """``p - lr · g`` (``g`` the buffer ``m = momentum · m + g`` when
    ``momentum > 0``). Returns ``(params', state')``; new tensors."""
    p_at = dict(tree.leaves_with_path(params))
    m_at = dict(tree.leaves_with_path(state.momentum))
    new_p, new_m = {}, {}
    for path, g in tree.leaves_sorted(grads):
        p, m = p_at[path], m_at[path]
        if momentum > 0 and m is not None:
            m = momentum * m + g
            g = m
        new_p[path] = (p - lr * g).to(p.dtype)
        new_m[path] = m
    return _rebuild(params, new_p), SGDState(step=state.step + 1, momentum=_rebuild(params, new_m))


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 ``sqrt``, as XLA's: through f64, which is exact
    for it. torch's CPU ``sqrt`` is not correctly rounded."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def adamw_init(params) -> AdamWState:
    z = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return AdamWState(0, tree.map(z, params), tree.map(z, params))


def adamw_update(grads, state: AdamWState, params, lr: float, b1=0.9, b2=0.95, eps=1e-8, wd=0.0):
    """AdamW with bias correction, in f32. Returns ``(params', state')``."""
    step = state.step + 1
    p_at = dict(tree.leaves_with_path(params))
    mu_at = dict(tree.leaves_with_path(state.mu))
    nu_at = dict(tree.leaves_with_path(state.nu))
    new_p, new_mu, new_nu = {}, {}, {}
    for path, g in tree.leaves_sorted(grads):
        p, mu, nu = p_at[path], mu_at[path], nu_at[path]
        t = torch.tensor(float(step), dtype=torch.float32, device=p.device)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=p.device) ** t
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=p.device) ** t
        g32 = g.to(torch.float32)
        mu = b1 * mu + (1 - b1) * g32
        nu = b2 * nu + (1 - b2) * g32 * g32
        upd = (mu / bc1) / (_sqrt(nu / bc2) + eps) + wd * p.to(torch.float32)
        new_p[path] = (p.to(torch.float32) - lr * upd).to(p.dtype)
        new_mu[path], new_nu[path] = mu, nu
    return _rebuild(params, new_p), AdamWState(step, _rebuild(params, new_mu), _rebuild(params, new_nu))
