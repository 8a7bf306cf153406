"""Seeded synthetic open-loop traces for the serving bench (port of
``repro.serve.trace``: the same numpy draws, so a seed gives the reference's
requests).

Arrivals are an open-loop Poisson process (exponential inter-arrival gaps at
``rate`` requests/sec on the virtual clock — arrivals do NOT wait for the
system, the closed-loop trap). Prompt lengths draw from a small fixed set so
the engine calibrates a bounded number of prefill shapes; output lengths
are uniform over ``out_lens`` (decode rounds are bucketed, so they add no
round shapes). Tier tags draw from ``tiers`` — ``(name, probability)`` pairs —
for the SLA-tier runs.
"""
from __future__ import annotations

import numpy as np

from .scheduler import Request


def synth_trace(seed: int = 0, n_requests: int = 32, rate: float = 50.0,
                prompt_lens=(8, 16, 32), out_lens=(4, 32), vocab: int = 128,
                tiers=(("default", 1.0),), out_choices=None) -> list[Request]:
    """``out_choices`` (e.g. ``((4, 0.7), (60, 0.3))`` — (length, probability)
    pairs) replaces the uniform ``out_lens`` range with a discrete mixture:
    the chat-vs-long-generation bimodality real serving sees, and the regime
    where the static barrier hurts most (a batch is held hostage by its
    longest member)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    names = [t[0] for t in tiers]
    probs = np.asarray([t[1] for t in tiers], np.float64)
    probs = probs / probs.sum()
    if out_choices is not None:
        olens = np.asarray([c[0] for c in out_choices], np.int64)
        oprobs = np.asarray([c[1] for c in out_choices], np.float64)
        oprobs = oprobs / oprobs.sum()
    reqs = []
    for i in range(n_requests):
        L = int(rng.choice(prompt_lens))
        if out_choices is not None:
            out = int(rng.choice(olens, p=oprobs))
        else:
            out = int(rng.integers(out_lens[0], out_lens[1] + 1))
        reqs.append(Request(
            rid=i,
            arrival=float(arrivals[i]),
            tokens=rng.integers(0, vocab, size=L).astype(np.int32),
            out_len=out,
            tier=str(rng.choice(names, p=probs)),
        ))
    return reqs
