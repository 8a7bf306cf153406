"""Continuous-batching scheduler (port of ``repro.serve.scheduler``):
admit/evict over engine slot grids, a shared virtual clock, and
latency/throughput accounting. Host-side Python and numpy, the reference's
logic line for line: the same trace and the same cost table give the same
tokens and the same ``token_times``.

Two policies over the same :class:`~repro_torch.serve.engine.Engine` machinery:

* ``continuous`` — vLLM-style: each loop iteration admits at most one
  prefill step (a whole short prompt, or ONE chunk of a long one) into a
  free slot, then runs one decode round over whatever is active. Finished
  slots are evicted (pages recycled) immediately, so new requests flow in
  as soon as capacity frees up.
* ``static`` — the barrier baseline: a batch is admitted only when the
  engine is completely idle, then decoded until EVERY member finishes;
  early finishers keep burning their slot as inert dead rows. This is the
  fixed-batch Python loop the old ``launch.serve`` implemented, expressed
  in the same engine so the comparison isolates the scheduling policy.

The clock is *virtual*: it advances by the calibrated per-shape device
seconds of each prefill call / decode round plus idle jumps to the next
arrival when nothing is runnable. Decode rounds are bucketed (largest
bucket ≤ the LONGEST remaining output among active slots) so only a
handful of round lengths ever occur (each calibrated once); each
slot gets a per-slot step budget and goes inert mid-round once it finishes,
so heterogeneous remaining lengths never degenerate into T=1 rounds. Each
consumed token is timestamped at ``round_start + (i + 1) * dt / T``.

SLA tiers: pass several engines keyed by tier name (e.g. ``premium`` serving
an adc9 ``fidelity_params`` tree, ``bulk`` adc6, both over the same sliced
planes); requests carry a ``tier`` tag and are routed to their tier's
engine, all engines sharing the one virtual clock (the device is serial).

Opt-in, the clock can be priced in *compiled crossbar cycles* instead of
calibrated: pass an :class:`IsaClock` as ``Engine(costs=...)`` and every
prefill chunk / decode round costs its token count times the plan-compiled
per-token crossbar latency (``IsaClock.from_plan``, from
``repro_torch.isa.plan_compile``). Under such a clock the engine never
calibrates, so the schedule and every number of ``summarize`` depend only
on the trace, the clock and the engine's geometry: not on the weights, the
model's width or the host.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


class IsaClock(dict):
    """ISA-priced virtual clock: a drop-in for ``Engine``'s ``costs=`` table
    that prices known cost-key shapes per token rather than by host
    calibration (the engine never calibrates a key the clock can price,
    because ``key in clock`` answers True for them).

    Keys priced: ``("prefill", L)`` and ``("cont", C, L)`` cost their token
    count (L or C) times ``s_per_token``; ``("round", T)`` costs T decode
    steps over the full ``n_slots`` grid (the crossbar streams slot vectors
    serially through the tiles). Unknown key shapes fall through to plain
    dict entries, so pre-seeded host costs still compose."""

    def __init__(self, s_per_token: float, n_slots: int):
        super().__init__()
        self.s_per_token = float(s_per_token)
        self.n_slots = int(n_slots)

    def _price(self, key):
        if isinstance(key, tuple) and len(key) >= 2 and key[0] in ("prefill", "cont", "round"):
            tokens = key[1] * (self.n_slots if key[0] == "round" else 1)
            return tokens * self.s_per_token
        return None

    def __contains__(self, key):
        return self._price(key) is not None or dict.__contains__(self, key)

    def __getitem__(self, key):
        p = self._price(key)
        return dict.__getitem__(self, key) if p is None else p

    @classmethod
    def from_plan(cls, params, plan, n_slots: int, em=None, scale: float = 1.0):
        """Build the clock from a resolved plan over ``params`` (tensors or
        ``ShapeDtype`` leaves: only shapes are read): per-token seconds =
        the plan-compiled forward crossbar latency (packed bit-plane rounds,
        depth-serial leaves) times ``scale`` (SLA-tier ADC factors compose
        here or via ``Engine(cost_scale=...)``)."""
        from repro_torch.isa.energy import DEFAULT_ENERGY
        from repro_torch.isa.plan_compile import token_latency_ns

        ns = token_latency_ns(params, plan, em or DEFAULT_ENERGY)
        return cls(ns * 1e-9 * scale, n_slots)


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    arrival: float  # seconds on the virtual clock
    tokens: np.ndarray  # [L] int32 prompt
    out_len: int  # tokens to generate (including the prefill's first token)
    tier: str = "default"


@dataclasses.dataclass
class Completed:
    rid: int
    tier: str
    arrival: float
    prompt_len: int
    ttft: float  # first-token completion minus arrival
    token_times: list  # absolute completion time of every output token
    tokens: list  # the generated token ids

    @property
    def finish(self) -> float:
        return self.token_times[-1]


ROUND_BUCKETS = (8, 4, 2, 1)


class _Slot:
    def __init__(self, req: Request, first_tok: int, t: float):
        self.req = req
        self.tokens = [first_tok]
        self.token_times = [t]
        self.remaining = req.out_len - 1


class _TierState:
    def __init__(self, engine, requests):
        self.engine = engine
        self.pending = deque(sorted(requests, key=lambda r: (r.arrival, r.rid)))
        self.job = None
        self.job_req = None
        self.slots: dict[int, _Slot] = {}

    def done(self) -> bool:
        return not (self.pending or self.job or self.slots)


def run_trace(engines: dict, trace, policy: str = "continuous",
              buckets=ROUND_BUCKETS) -> dict:
    """Replay ``trace`` (a list of :class:`Request`) through ``engines``
    (tier name -> Engine). Returns ``{"requests": [Completed...],
    "clock": end_time, "policy": policy}``."""
    if policy not in ("continuous", "static"):
        raise ValueError(f"unknown policy {policy!r}")
    tiers = {
        name: _TierState(eng, [r for r in trace if r.tier == name])
        for name, eng in engines.items()
    }
    unrouted = [r for r in trace if r.tier not in engines]
    if unrouted:
        raise ValueError(f"requests with unrouted tiers: {sorted({r.tier for r in unrouted})}")

    t = 0.0
    completed: list[Completed] = []

    def complete(ts: _TierState, tier: str, slot_id: int):
        sl = ts.slots.pop(slot_id)
        ts.engine.evict(slot_id)
        completed.append(Completed(
            rid=sl.req.rid, tier=tier, arrival=sl.req.arrival,
            prompt_len=int(sl.req.tokens.shape[0]),
            ttft=sl.token_times[0] - sl.req.arrival,
            token_times=sl.token_times, tokens=sl.tokens,
        ))

    def admit_job(ts: _TierState, tier: str, job, req):
        slot, first = ts.engine.admit(job)
        sl = _Slot(req, first, t)
        ts.slots[slot] = sl
        if sl.remaining <= 0:
            complete(ts, tier, slot)

    def admit_finished_job(ts: _TierState, tier: str):
        job, req = ts.job, ts.job_req
        ts.job = ts.job_req = None
        admit_job(ts, tier, job, req)

    while not all(ts.done() for ts in tiers.values()):
        progressed = False
        for tier, ts in tiers.items():
            eng = ts.engine

            # ---- admission ----
            if policy == "continuous":
                # burst-fill free slots: short prompts prefill whole and
                # admit immediately, bypassing an in-flight chunked (long)
                # prompt — one slot stays reserved for it so its admission
                # can never be starved. At most one chunked job is in flight
                # per tier; a second long prompt waits for the chunk lane.
                while (ts.pending and ts.pending[0].arrival <= t
                       and eng.free_slot_count() > (1 if ts.job is not None else 0)):
                    head_len = int(ts.pending[0].tokens.shape[0])
                    if eng.will_chunk(head_len):
                        if ts.job is not None:
                            break  # chunk lane busy
                        ts.job_req = ts.pending.popleft()
                        ts.job = eng.start(ts.job_req.tokens)
                        continue
                    req = ts.pending.popleft()
                    job = eng.start(req.tokens)
                    t += eng.prefill_step(job)
                    progressed = True
                    admit_job(ts, tier, job, req)
                if ts.job is not None:
                    # one chunk per iteration while decode slots are live (a
                    # decode slot never stalls more than one chunk); when the
                    # engine has nothing to decode, chunks run back-to-back
                    t += eng.prefill_step(ts.job)
                    progressed = True
                    while not ts.job.finished and not any(
                        sl.remaining > 0 for sl in ts.slots.values()
                    ):
                        t += eng.prefill_step(ts.job)
                    if ts.job.finished:
                        admit_finished_job(ts, tier)
            else:  # static: barrier — admit only into a fully idle engine
                if not ts.slots and ts.job is None:
                    while (ts.pending and ts.pending[0].arrival <= t
                           and eng.has_free_slot()):
                        ts.job_req = ts.pending.popleft()
                        ts.job = eng.start(ts.job_req.tokens)
                        while not ts.job.finished:
                            t += eng.prefill_step(ts.job)
                        progressed = True
                        admit_finished_job(ts, tier)

            # ---- one decode round over the active slots ----
            live = {s: sl for s, sl in ts.slots.items() if sl.remaining > 0}
            if live:
                # under queue pressure, end the round as soon as the first
                # slot can free (admit sooner): smallest bucket covering the
                # shortest remaining output, so the freed slot never idles
                # more than the bucket rounding. Otherwise size for the
                # longest remaining output (fewest dispatches).
                pressure = (
                    policy == "continuous" and ts.pending
                    and ts.pending[0].arrival <= t
                    and eng.free_slot_count() <= (1 if ts.job is not None else 0)
                )
                desc = sorted(buckets, reverse=True)
                if ts.job is not None:
                    # a chunked prefill is mid-flight: run the SMALLEST round
                    # (the one-chunk stall bound for live slots) and bank the
                    # remaining decode work — it overlaps with the late
                    # admissions once the long prompt lands, instead of
                    # draining the batch while admission is serialized
                    T = desc[-1]
                elif pressure:
                    bound = min(sl.remaining for sl in live.values())
                    T = next((b for b in reversed(desc) if b >= bound), desc[0])
                else:
                    bound = max(sl.remaining for sl in live.values())
                    T = next(b for b in desc if b <= bound)
                steps = np.zeros(eng.spec.n_slots, np.int64)
                for s, sl in live.items():
                    steps[s] = min(T, sl.remaining)
                toks, dt = eng.decode_round(T, steps)
                progressed = True
                for s, sl in live.items():
                    for i in range(int(steps[s])):
                        sl.tokens.append(int(toks[i, s]))
                        sl.token_times.append(t + (i + 1) * dt / T)
                    sl.remaining -= int(steps[s])
                t += dt
                # evict finished slots; under static the batch barrier still
                # holds (no re-admission until ts.slots fully drains)
                for s in list(ts.slots):
                    if ts.slots[s].remaining <= 0:
                        complete(ts, tier, s)

        if not progressed:
            arrivals = [ts.pending[0].arrival for ts in tiers.values() if ts.pending]
            if not arrivals:
                break  # nothing runnable and nothing arriving: drained
            t = max(t, min(arrivals))

    return {"requests": completed, "clock": t, "policy": policy}


def summarize(result: dict) -> dict:
    """Latency/throughput digest of a :func:`run_trace` result: aggregate
    tokens/sec over the makespan, p50/p99 inter-token latency, TTFT stats."""
    reqs: list[Completed] = result["requests"]
    if not reqs:
        return {"requests": 0}
    itl = np.concatenate([
        np.diff(np.asarray(r.token_times)) for r in reqs if len(r.token_times) > 1
    ]) if any(len(r.token_times) > 1 for r in reqs) else np.asarray([0.0])
    ttft = np.asarray([r.ttft for r in reqs])
    total_tokens = sum(len(r.tokens) for r in reqs)
    start = min(r.arrival for r in reqs)
    end = max(r.finish for r in reqs)
    makespan = max(end - start, 1e-9)
    return {
        "requests": len(reqs),
        "tokens": int(total_tokens),
        "makespan_s": float(makespan),
        "tokens_per_sec": float(total_tokens / makespan),
        "per_token_p50_ms": float(np.percentile(itl, 50) * 1e3),
        "per_token_p99_ms": float(np.percentile(itl, 99) * 1e3),
        "ttft_p50_ms": float(np.percentile(ttft, 50) * 1e3),
        "ttft_p99_ms": float(np.percentile(ttft, 99) * 1e3),
        "ttft_mean_ms": float(ttft.mean() * 1e3),
    }
