"""Serving steps (port of ``repro.serve.step``): batched prefill and
single-token decode (greedy, or sampled by ``core.prng.categorical``) over
the model fns, and :func:`fidelity_params`, which wraps a served param tree
so every operand-eligible linear reads the int8 crossbar planes through the
finite-ADC engine. SLA tiers are several wraps at different ADC resolutions
over the same ``sliced`` planes. These step functions serve one request shape at
a time; mixed lengths are ``serve.engine`` and ``serve.scheduler`` over the
paged cache, which drive the same ``lm.prefill`` / ``lm.decode_step``.

Single device; the mesh lowering is not ported.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.models import lm
from repro_torch.models.common import LMConfig
from repro_torch.optim import panther


def fidelity_params(params, sliced, plan):
    """Wrap a served (materialized) param tree for finite-ADC reads: each
    leaf serves at its resolved ``plan.fidelity``; leaves without one stay on
    the lossless dense path. Forward only."""
    return panther.fidelitize(params, sliced, plan)


def make_prefill(cfg: LMConfig):
    def prefill(params, inputs: torch.Tensor):
        with torch.no_grad():
            return lm.prefill(cfg, params, inputs)

    return prefill


def make_decode_step(cfg: LMConfig, sample: bool = False):
    """``decode_step(params, token, caches, pos, rng=None) -> (next token
    int32 [B], logits, caches)``: greedy, or with ``sample`` a draw from the
    softmax of the f32 logits under the host key ``rng``
    (``jax.random.categorical``'s Gumbel-max)."""
    def decode_step(params, token: torch.Tensor, caches, pos, rng=None):
        with torch.no_grad():
            logits, caches = lm.decode_step(cfg, params, token, caches, pos)
            if sample:
                nxt = prng.categorical(rng, logits)
            else:
                nxt = torch.argmax(logits, dim=-1)
        return nxt.to(torch.int32), logits, caches

    return decode_step
