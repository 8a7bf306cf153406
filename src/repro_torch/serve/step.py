"""Serving steps (port of ``repro.serve.step``): batched prefill and greedy
single-token decode over the model fns, and :func:`fidelity_params`, which
wraps a served param tree so every operand-eligible linear reads the int8
crossbar planes through the finite-ADC engine. SLA tiers are several wraps
at different ADC resolutions over the same ``sliced`` planes.

Single device; the mesh lowering and sampled decoding are not ported.
"""
from __future__ import annotations

import torch

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


def make_decode_step(cfg: LMConfig):
    def decode_step(params, token: torch.Tensor, caches, pos: int):
        with torch.no_grad():
            logits, caches = lm.decode_step(cfg, params, token, caches, pos)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, caches

    return decode_step
