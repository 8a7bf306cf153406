"""Serving (port of ``repro.serve``): single-request steps and the
continuous-batching engine.

Layers, bottom up:

* ``step``: batched prefill and single-token decode (greedy or sampled),
  and :func:`fidelity_params`, which wraps a served param tree so
  operand-eligible linears read the int8 crossbar planes through the
  finite-ADC engine; SLA tiers are several wraps over the same planes;
* ``kv_pages``: the paged KV cache, per-layer page pools for every
  sequence-axis leaf, one shared slot page table, host-side free-list
  allocation recycled on eviction, and the spec-driven layout discovery;
* ``engine``: a fixed grid of decode slots over those pools: exact-length
  or chunked prefill, decode rounds at one position a slot, dead slots
  inert at the sentinel;
* ``scheduler``: continuous-batching admit/evict and the static-batch
  barrier over one or more engines on a shared virtual clock of calibrated
  per-shape costs; tier-tagged requests route to their tier's engine;
* ``trace``: seeded open-loop Poisson request traces for the bench
  (``python -m repro_torch.launch.serve --trace``).
"""
from .engine import Engine, PrefillJob
from .scheduler import Request, run_trace, summarize
from .step import fidelity_params, make_decode_step, make_prefill
from .trace import synth_trace

__all__ = [
    "Engine",
    "PrefillJob",
    "Request",
    "fidelity_params",
    "make_decode_step",
    "make_prefill",
    "run_trace",
    "summarize",
    "synth_trace",
]
