"""Continuous-batching serving engine over a fixed decode-slot grid (port of
``repro.serve.engine``).

One :class:`Engine` owns ``n_slots`` decode slots backed by the paged cache
trees of ``serve.kv_pages``. The serving loop is three primitives:

* **prefill**: each request prefills *solo* at its exact prompt length
  (``[1, L]``) through ``lm.prefill``, so its cache bits are those of
  single-request serving; a prompt longer than ``chunk_size`` instead
  streams through the chunked continuation (``lm.prefill(caches=...,
  start=...)``) one chunk a call, so decode slots never wait more than one
  chunk. The finished caches are scattered into the slot's pages.
* **decode round**: ``T`` single-token steps over all slots, each slot at
  its own position (a vector ``pos``), the caches updated in place. A slot
  decodes while the round index is under its step budget; evicted and
  exhausted slots run at the sentinel position, where their cache writes
  land on the write-only page and their tokens are discarded: dead slots
  are inert without a branch or a host sync inside a step. ``T`` is
  bucketed by the scheduler, so only a few round lengths occur.
* **evict**: the slot's pages go back to the pool's free list.

The virtual clock: every call is charged a per-shape cost. The first time a
key appears (``("prefill", L)``, ``("cont", C, L)``, ``("round", T)``) its
cost is calibrated as the best of 3 runs on fresh zero operands of the same
shapes (tokens, positions, page table and caches; the weights are the
engine's own, which the reference zeros too and which change no kernel's
work), each between ``torch.cuda.synchronize()`` calls; a key already in
``costs`` is never calibrated. Pass one engine's table as ``costs`` to
another so compared policies run on the same per-shape costs;
``cost_scale`` prices a tier's analog readout speed onto the clock. The
clock is deterministic under interleaving-order noise.

Scheduling is invisible in the tokens only on lossless param trees. Under
``fidelity_params`` the DAC exponent of a read is chosen over all its
tokens (``core.mvm.fidelity_read``, as the reference's
``choose_frac_bits``), so every slot of a decode round, dead slots' stale
rows included, quantizes on one exponent, and a slot's finite-ADC tokens
depend on its neighbours.

SLA tiers: an engine serves ONE param tree (e.g. a ``fidelity_params`` wrap
at one ADC resolution); the scheduler composes engines over the same sliced
planes on one shared clock (``serve.scheduler``).

On a mesh (``mesh=``, a live ``launch.mesh.Mesh`` of any shape): every
rank runs the same schedule (admission, pages, rounds) on the same
requests. Each page pool lives as this rank's block (``distributed.
sharding.page_pool_spec``: TP on a trailing dim, replicated over the data
axes); an engine call gathers the pools it reads or writes, runs, and keeps
its block of the result. The fidelity-wrapped leaves
(``serve.step.fidelity_params(mesh=)``) read on this rank's crossbar tile
block. Prefill runs at batch 1 with no token sharding (every rank the whole
prompt: the reference's ``_scope1``), so every rank writes an admitted
request's caches. A decode round runs under ``ctx_for(mesh, n_slots)``: the
slots split over the data axes that divide ``n_slots``, each rank decoding
its rows of slots (its reads' DAC range global over the data axes, a MoE
layer's split dispatch groups through ``moe_apply``'s gather) and the
emitted tokens, positions and tokens-so-far gathered over the data axes. A
slot is decoded by one data rank for the engine's life, so a rank's copy of
the pools holds its own slots' pages and state rows current; another
rank's slots' entries in it may go stale and are never read by it (a
reused page is rewritten by the admission and the decode writes before
the slot's position mask lets a read see it). The cost of a shape is
calibrated on every rank (the calls hold collectives) and rank 0's is
broadcast, so that every rank schedules alike.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import resolve
from repro_torch.distributed import blocks
from repro_torch.distributed import collectives as col
from repro_torch.distributed import fidelity as dist_fid
from repro_torch.distributed import sharding as shd
from repro_torch.models import lm

from . import kv_pages


@dataclasses.dataclass
class PrefillJob:
    """In-flight prompt prefill. ``caches`` holds the stacked-layout cache
    tree being filled; a chunked job advances ``done`` one chunk a step."""

    tokens: np.ndarray  # [L] int32 prompt
    chunked: bool
    done: int = 0
    caches: object = None
    logits: object = None

    @property
    def length(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def finished(self) -> bool:
        return self.done >= self.length


class Engine:
    """Fixed-slot continuous-batching engine over paged caches, on
    ``device`` (``cuda`` unless the caller names another)."""

    def __init__(self, cfg, params, *, n_slots: int, max_seq: int, page: int = 16,
                 num_pages: int | None = None, chunk_size: int | None = None,
                 mesh=None, costs: dict | None = None, cost_scale: float = 1.0, device=None):
        if cfg.input_mode != "tokens":
            raise NotImplementedError(
                "the serving engine feeds sampled token ids back; "
                "embedding-front archs are not servable through it")
        self.mesh, self._ctx, self._ctx1, self._pool_specs, sharding_fn = mesh, None, None, None, None
        self._rows = slice(0, n_slots)  # the slots this rank decodes
        if mesh is not None:
            if not mesh.live:
                raise ValueError("Engine(mesh=...) runs on a live mesh (launch.mesh.init_mesh)")
            self._ctx = dist_fid.ctx_for(mesh, n_slots)  # decode rounds: slots over the data axes
            self._ctx1 = dist_fid.ctx_for(mesh, 1)  # prefill at batch 1: every rank the whole prompt
            if self._ctx.data_axes:
                self._rows = blocks.block_slices((self._ctx.data_axes,), (n_slots,), mesh)[0]
            pool_spec_of = lambda lay, shape: shd.page_pool_spec(shape, mesh, 2 if lay.is_paged else 1)  # noqa: E731
            sharding_fn = lambda lay, shape, dtype: blocks.block_shape(pool_spec_of(lay, shape), shape, mesh)  # noqa: E731
        self.device = resolve(device)
        self.cfg, self.params = cfg, params
        self.spec = kv_pages.pool_spec(n_slots, max_seq, page, num_pages)
        self.alloc = kv_pages.PageAllocator(self.spec)
        self.chunk_size = chunk_size
        if mesh is not None:
            self._pool_specs = kv_pages.pool_map(pool_spec_of, cfg, self.spec)
        self.caches = kv_pages.make_paged_caches(cfg, self.spec, device=self.device, sharding_fn=sharding_fn)
        self.tok = torch.zeros((n_slots,), dtype=torch.int64, device=self.device)
        self.pos = torch.zeros((n_slots,), dtype=torch.int64, device=self.device)
        self.active = np.zeros((n_slots,), bool)
        self.pos_host = np.zeros((n_slots,), np.int64)
        self._costs: dict = {} if costs is None else costs
        self.cost_scale = float(cost_scale)

    # ------------------------------ device fns ------------------------------

    def _prefill_fn(self, x):
        with torch.no_grad(), dist_fid.use_sharded_fidelity(self._ctx1):
            return lm.prefill(self.cfg, self.params, x)

    def _cont_fn(self, x, caches, start):
        with torch.no_grad(), dist_fid.use_sharded_fidelity(self._ctx1):
            return lm.prefill(self.cfg, self.params, x, caches=caches, start=start)

    def _whole_pools(self):
        """The page pools whole (gathered from every rank's block on a
        mesh; the pools themselves off one)."""
        if self.mesh is None:
            return self.caches
        return tree.map(lambda c, sp: blocks.gather(c, sp, self.mesh), self.caches, self._pool_specs)

    def _keep_blocks(self, whole) -> None:
        """This rank's blocks of the whole pools, as the engine's pools."""
        if self.mesh is not None:
            self.caches = tree.map(lambda c, sp: blocks.local_block(c, sp, self.mesh).clone(), whole,
                                   self._pool_specs)

    def _over_data(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of slots' ``t`` gathered over the decode's data
        axes (``t`` itself off a mesh or with none)."""
        if self._ctx is None or not self._ctx.data_axes:
            return t
        return col.all_gather(t, self.mesh, self._ctx.data_axes, dim=dim)

    def _round_fn(self, T, table, caches, tok, pos, active, steps_left):
        """``T`` decode steps over this rank's slots (``table``, ``tok``,
        ``pos``, ``active``, ``steps_left`` their rows; ``caches`` the whole
        pools, state leaves cut to the rows by ``kv_pages.slot_rows``), in
        place on ``caches``. Returns the final (tok, pos) and the emitted
        tokens ``[T, rows]``."""
        caches = kv_pages.with_tables(caches, table)
        sentinel = self.spec.max_seq
        toks = []
        with torch.no_grad(), dist_fid.use_sharded_fidelity(self._ctx):
            for i in range(T):
                # a slot is live while the round index is under its budget;
                # the others decode at the sentinel, their writes land on the
                # write-only page and their logits are discarded
                live = active & (steps_left > i)
                pos_eff = torch.where(live, pos, sentinel)
                logits, _ = lm.decode_step(self.cfg, self.params, tok, caches, pos_eff)
                tok = torch.where(live, torch.argmax(logits, dim=-1), tok)
                pos = pos + live.to(pos.dtype)
                toks.append(tok)
        return tok, pos, torch.stack(toks)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed(self, key, fn, args, zeros):
        """Run ``fn(*args)`` and charge the per-shape cost of ``key``,
        calibrated first (``_calibrate`` on ``zeros()``, fresh zero operands
        of the same shapes) unless the cost table knows it."""
        if key not in self._costs:
            cost = self._calibrate(fn, zeros)
            if self.mesh is not None:  # every rank schedules on rank 0's cost
                cost = float(col.broadcast(torch.tensor([cost], dtype=torch.float64, device=self.mesh.device),
                                           self.mesh)[0])
            self._costs[key] = cost
        out = fn(*args)
        self._sync()
        return out, self._costs[key] * self.cost_scale

    def _calibrate(self, fn, zeros, reps: int = 3) -> float:
        best = float("inf")
        for _ in range(reps):
            dummies = zeros()  # fresh each rep: the caches are written in place
            self._sync()
            t0 = time.perf_counter()
            fn(*dummies)
            self._sync()
            best = min(best, time.perf_counter() - t0)
        return best

    def _zero_tokens(self, n: int):
        return torch.zeros((1, n), dtype=torch.int64, device=self.device)

    def _zero_caches(self, L: int):
        """Stacked-layout zero caches of a length-``L`` solo prefill."""
        return tree.map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=self.device),
                        lm.prefill_cache_specs(self.cfg, 1, L))

    # ------------------------------- prefill --------------------------------

    def has_free_slot(self) -> bool:
        return bool((~self.active).any())

    def free_slot_count(self) -> int:
        return int((~self.active).sum())

    def will_chunk(self, L: int) -> bool:
        """Whether a length-``L`` prompt prefills through the chunked
        continuation (vs single-shot)."""
        return bool(self.chunk_size and L > self.chunk_size and lm.supports_chunked_prefill(self.cfg))

    def start(self, tokens: np.ndarray) -> PrefillJob:
        """Open a prefill job: chunked when the prompt exceeds
        ``chunk_size`` and every block has a continuation, single-shot (the
        solo layout, bit for bit) otherwise."""
        tokens = np.asarray(tokens, np.int32)
        L = int(tokens.shape[0])
        if L + 1 > self.spec.max_seq:
            raise ValueError(f"prompt length {L} exceeds max_seq {self.spec.max_seq}")
        job = PrefillJob(tokens=tokens, chunked=self.will_chunk(L))
        if job.chunked:
            job.caches = self._zero_caches(L)
        return job

    def prefill_step(self, job: PrefillJob) -> float:
        """Advance the job by one chunk (or the whole prompt when not
        chunked). Returns the seconds charged to the clock."""
        L = job.length
        if not job.chunked:
            x = torch.as_tensor(job.tokens.astype(np.int64), device=self.device)[None, :]
            (logits, caches), dt = self._timed(("prefill", L), self._prefill_fn, (x,),
                                               lambda: (self._zero_tokens(L),))
            job.logits, job.caches, job.done = logits, caches, L
            return dt
        C = min(self.chunk_size, L - job.done)
        x = torch.as_tensor(job.tokens[job.done:job.done + C].astype(np.int64), device=self.device)[None, :]
        (logits, caches), dt = self._timed(("cont", C, L), self._cont_fn, (x, job.caches, job.done),
                                           lambda: (self._zero_tokens(C), self._zero_caches(L), 0))
        job.logits, job.caches = logits, caches
        job.done += C
        return dt

    def admit(self, job: PrefillJob) -> tuple[int, int]:
        """Place a finished prefill into a free slot: allocate pages, scatter
        the solo caches in, arm the slot. Returns (slot, first token)."""
        assert job.finished
        free = np.flatnonzero(~self.active)
        if not len(free):
            raise RuntimeError("no free decode slot")
        slot = int(free[0])
        L = job.length
        self.alloc.ensure(slot, L)
        solo = lm.unstack_caches(self.cfg, job.caches)
        whole = self._whole_pools()
        kv_pages.admit_caches(self.cfg, whole, self.spec, self.alloc.table[slot], slot, solo, L)
        self._keep_blocks(whole)
        first = int(torch.argmax(job.logits[0]))
        self.tok[slot] = first
        self.pos[slot] = L
        self.active[slot] = True
        self.pos_host[slot] = L
        return slot, first

    # ------------------------------- decode ---------------------------------

    def decode_round(self, T: int, steps=None) -> tuple[np.ndarray, float]:
        """Run ``T`` decode steps over all slots. ``steps`` (optional,
        ``[n_slots]`` ints) caps each slot's live steps: a slot goes inert
        mid-round once its budget is spent, so ``T`` can be sized for the
        slot with the MOST remaining tokens. Returns the emitted tokens
        ``[T, n_slots]`` (garbage in dead columns and past each slot's
        budget) and the seconds charged to the clock."""
        if steps is None:
            steps = np.where(self.active, T, 0)
        steps = np.minimum(np.asarray(steps, np.int64), T)
        steps = np.where(self.active, steps, 0)
        for s in np.flatnonzero(steps > 0):
            self.alloc.ensure(int(s), int(self.pos_host[s]) + int(steps[s]))
        whole = self._whole_pools()
        r = self._rows
        args = (self.alloc.device_table(self.device)[r], kv_pages.slot_rows(self.cfg, whole, r), self.tok[r],
                self.pos[r], torch.as_tensor(self.active[r], device=self.device),
                torch.as_tensor(steps[r], device=self.device))

        def zeros():
            pools = kv_pages.make_paged_caches(self.cfg, self.spec, device=self.device)
            return (torch.zeros_like(args[0]), kv_pages.slot_rows(self.cfg, pools, r),
                    *(torch.zeros_like(a) for a in args[2:]))

        (tok, pos, toks), dt = self._timed(("round", T), lambda *a: self._round_fn(T, *a), args, zeros)
        self.tok, self.pos, toks = self._over_data(tok), self._over_data(pos), self._over_data(toks, dim=1)
        self._keep_blocks(whole)
        self.pos_host += steps
        return toks.cpu().numpy(), dt

    def evict(self, slot: int) -> None:
        """Free a finished slot: pages return to the pool, the table row goes
        all-sentinel (writes land on the write-only page), the slot rejoins
        the free set."""
        self.alloc.release(slot)
        self.active[slot] = False
        self.pos_host[slot] = 0
