"""Serving (port): prefill/decode step builders, the fidelity wrap, and the
spec-driven cache grow. The continuous-batching engine, scheduler and paged
caches are not ported yet."""
from .step import fidelity_params, make_decode_step, make_prefill

__all__ = ["fidelity_params", "make_decode_step", "make_prefill"]
