"""Paged KV cache (port of ``repro.serve.kv_pages``): page pools, the slot
page table, and cache-layout discovery.

The serving engine keeps every *sequence-axis* cache leaf (attention K/V,
and the int8 cache's scale ``s`` beside them) in a page pool ``[P + 1,
page, *tail]`` shared by all decode slots, read through ONE page table
``table [n_slots, max_pages]`` (int32) common to every layer and leaf: a
slot's logical cache structure is the same in every layer, so one table row
says where all of its pages live. *State* leaves (no sequence axis: the
mamba2 and xLSTM recurrent states, zamba's stacked mamba states ``[N, B,
...]`` with the batch on axis 1) are not paged: each keeps ``n_slots``
dense rows along its batch axis, and a request's admission overwrites its
slot's row.

The sentinel ``P`` (the number of data pages) marks unallocated and evicted
table entries. Pages ``0..P-1`` hold data; the extra page ``P`` is
write-only: a write through the sentinel lands there, and a read through it
clips to page ``P - 1``, garbage masked by the slot's position mask. The
reference drops such writes instead (``mode="drop"``); the pools here are
one page longer than the reference's, and their first ``P`` pages are the
reference's pools (``models.common`` paged primitives).

Which leaf is which is *discovered*: :func:`cache_layouts` reads the blocks'
cache specs at two batch sizes and two lengths and marks, per leaf, the axis
that scales with each, so :func:`grow_caches` pads the axis that provably
scales with the sequence, never one whose size happens to equal the prompt
length.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.device import resolve
from repro_torch.models import lm
from repro_torch.models.common import ShapeDtype


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """Per-layer cache-leaf layout: which axes scale with batch / seq."""

    batch_axis: int | None
    seq_axis: int | None
    shape: tuple  # per-layer shape at the probe (batch, seq) sizes
    dtype: object

    @property
    def is_paged(self) -> bool:
        """Sequence-axis leaves live in page pools; state leaves do not."""
        return self.seq_axis is not None


def _probe_caches(cfg, batch: int, seq: int):
    """Per-layer cache specs of ``lm.prefill``'s output
    (``lm.prefill_cache_specs``, the stacked axis dropped)."""
    return [spec if count == 1 else tree.map(lambda s: ShapeDtype(s.shape[1:], s.dtype), spec)
            for (_, count), spec in zip(cfg.pattern, lm.prefill_cache_specs(cfg, batch, seq))]


@functools.lru_cache(maxsize=None)
def cache_layouts(cfg):
    """Per pattern group: a tree of :class:`LeafLayout` (per-layer shapes),
    the axes found by differencing the specs at two batch sizes and two
    lengths."""
    B0, B1, S0, S1 = 2, 3, 8, 16
    base = _probe_caches(cfg, B0, S0)
    seq = _probe_caches(cfg, B0, S1)
    bat = _probe_caches(cfg, B1, S0)

    def one(a, a_s, a_b):
        sax = [i for i, (x, y) in enumerate(zip(a.shape, a_s.shape)) if x != y]
        bax = [i for i, (x, y) in enumerate(zip(a.shape, a_b.shape)) if x != y]
        if len(sax) > 1 or len(bax) > 1:
            raise ValueError(f"ambiguous cache leaf layout: {a.shape}")
        return LeafLayout(batch_axis=bax[0] if bax else None, seq_axis=sax[0] if sax else None,
                          shape=tuple(a.shape), dtype=a.dtype)

    return [tree.map(one, a, s, b) for a, s, b in zip(base, seq, bat)]


def _map_layers(fn, cfg, layouts, caches, *rest):
    """``fn(layout, cache_leaf, *rest_leaves)`` over the decode list layout
    (counted groups are lists of per-layer trees); ``rest`` trees share it."""
    out = []
    for gi, ((name, count), lay, cache) in enumerate(zip(cfg.pattern, layouts, caches)):
        r = [x[gi] for x in rest]
        if count == 1:
            out.append(tree.map(fn, lay, cache, *r))
        else:
            out.append([tree.map(fn, lay, c, *[y[i] for y in r]) for i, c in enumerate(cache)])
    return out


def grow_caches(cfg, caches, to_len: int):
    """Zero-pad every sequence axis of a decode-layout cache tree to
    ``to_len``."""
    def one(lay: LeafLayout, leaf):
        ax = lay.seq_axis
        if ax is None or leaf.shape[ax] >= to_len:
            return leaf
        pad = [0, 0] * (leaf.dim() - 1 - ax) + [0, to_len - leaf.shape[ax]]
        return F.pad(leaf, pad)

    return _map_layers(one, cfg, cache_layouts(cfg), caches)


# ------------------------------ page pools ----------------------------------


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """Geometry of the shared page pool."""

    n_slots: int
    page: int  # tokens a page
    max_pages: int  # logical pages a slot (max_seq = page * max_pages)
    num_pages: int  # data pages in the pool (the sentinel value)

    @property
    def max_seq(self) -> int:
        return self.page * self.max_pages


def pool_spec(n_slots: int, max_seq: int, page: int = 16, num_pages: int | None = None) -> PoolSpec:
    if max_seq % page:
        raise ValueError(f"max_seq {max_seq} not a multiple of page {page}")
    max_pages = max_seq // page
    if num_pages is None:
        num_pages = n_slots * max_pages  # fully backed
    return PoolSpec(n_slots, page, max_pages, num_pages)


def _pool_shape(lay: LeafLayout, spec: PoolSpec) -> tuple:
    """A pool leaf's whole shape: ``[P + 1, page, *tail]`` paged, else
    ``n_slots`` rows along the batch axis."""
    if not lay.is_paged:
        shape = list(lay.shape)
        shape[lay.batch_axis] = spec.n_slots
        return tuple(shape)
    if (lay.batch_axis, lay.seq_axis) != (0, 1):
        raise NotImplementedError(
            f"paged leaves must be [B, S, ...]; got batch axis {lay.batch_axis}, seq axis {lay.seq_axis} "
            f"for {lay.shape}")
    return (spec.num_pages + 1, spec.page) + tuple(lay.shape[2:])


def pool_map(fn, cfg, spec: PoolSpec):
    """``fn(layout, whole pool shape)`` over the pools' decode list layout."""
    out = []
    for (name, count), lay in zip(cfg.pattern, cache_layouts(cfg)):
        one = lambda la: fn(la, _pool_shape(la, spec))  # noqa: E731
        out.append(tree.map(one, lay) if count == 1 else [tree.map(one, lay) for _ in range(count)])
    return out


def make_paged_caches(cfg, spec: PoolSpec, device=None, sharding_fn=None):
    """Zeroed cache trees in the decode list layout: every paged leaf a pool
    ``[P + 1, page, *tail]`` (the data pages and the write-only one), every
    state leaf ``n_slots`` dense rows along its batch axis.
    ``sharding_fn(layout, shape, dtype) -> shape | None`` places each leaf
    on a mesh: the shape of this process's block of it (None: the whole;
    ``serve.engine`` passes ``distributed.sharding.page_pool_spec``'s)."""
    dev = resolve(device)

    def one(lay: LeafLayout, shape: tuple):
        if sharding_fn is not None:
            shape = sharding_fn(lay, shape, lay.dtype) or shape
        return torch.zeros(tuple(shape), dtype=lay.dtype, device=dev)

    return pool_map(one, cfg, spec)


# The cache dicts the blocks read at decode: the page table rides beside the
# leaf entries of each attention unit dict ({"k", "v"}: also each half of a
# gemma2 pair, and zamba's shared block's, nested beside its mamba states;
# MLA's {"c_kv", "k_rope"}).
_UNIT_KEYS = (frozenset({"k", "v"}), frozenset({"c_kv", "k_rope"}))


def with_tables(cache, table):
    """The cache tree with the shared page table in every paged unit dict
    (the blocks detect pagedness by the ``"table"`` key). New dicts over the
    same tensors."""
    if isinstance(cache, dict):
        if frozenset(cache) - {"table"} in _UNIT_KEYS:
            return dict(cache, table=table)
        return {k: with_tables(v, table) for k, v in cache.items()}
    if isinstance(cache, (list, tuple)):
        return type(cache)(with_tables(c, table) for c in cache)
    return cache


def strip_tables(cache):
    """The cache tree without injected page tables."""
    if isinstance(cache, dict):
        return {k: strip_tables(v) for k, v in cache.items() if k != "table"}
    if isinstance(cache, (list, tuple)):
        return type(cache)(strip_tables(c) for c in cache)
    return cache


# ------------------------------ allocation ----------------------------------


class OutOfPages(RuntimeError):
    pass


class PageAllocator:
    """Host-side page accounting: one shared table, a free list, pages
    recycled on release, in the reference's order (the same calls give the
    same table). The device only ever sees :meth:`device_table`."""

    def __init__(self, spec: PoolSpec):
        self.spec = spec
        self.sentinel = spec.num_pages
        self.table = np.full((spec.n_slots, spec.max_pages), self.sentinel, np.int32)
        self._free = list(range(spec.num_pages - 1, -1, -1))
        self._used = [0] * spec.n_slots

    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, length: int) -> int:
        return -(-length // self.spec.page)

    def ensure(self, slot: int, length: int) -> None:
        """Allocate pages so positions ``[0, length)`` of ``slot`` are backed."""
        need = self.pages_for(length)
        if need > self.spec.max_pages:
            raise ValueError(f"length {length} exceeds max_seq {self.spec.max_seq}")
        while self._used[slot] < need:
            if not self._free:
                raise OutOfPages(f"page pool exhausted ({self.spec.num_pages} pages)")
            self.table[slot, self._used[slot]] = self._free.pop()
            self._used[slot] += 1

    def release(self, slot: int) -> None:
        """Recycle a finished slot's pages; its table row returns to the
        all-sentinel state (its writes land on the write-only page)."""
        for j in range(self._used[slot]):
            self._free.append(int(self.table[slot, j]))
        self.table[slot, : self._used[slot]] = self.sentinel
        self._used[slot] = 0

    def device_table(self, device=None) -> torch.Tensor:
        return torch.as_tensor(self.table, device=resolve(device))


# ----------------------------- admit scatter --------------------------------


def admit_caches(cfg, caches, spec: PoolSpec, table_row: np.ndarray, slot: int, solo_caches, length: int):
    """Scatter a solo-prefilled request's caches (batch 1, seq ``length``,
    decode list layout) into slot ``slot``, in place: paged leaves onto the
    pages ``table_row`` assigns, state leaves over the slot's dense row.
    Returns ``caches``."""
    npages = -(-length // spec.page)

    def one(lay: LeafLayout, pool, solo):
        if not lay.is_paged:
            pool.select(lay.batch_axis, slot).copy_(solo.select(lay.batch_axis, 0))
            return pool
        rows = torch.as_tensor(table_row[:npages].astype(np.int64), device=pool.device)
        pad = npages * spec.page - length
        if pad:
            solo = F.pad(solo, [0, 0] * (solo.dim() - 2) + [0, pad])
        pool[rows] = solo[0].reshape((npages, spec.page) + tuple(solo.shape[2:])).to(pool.dtype)
        return pool

    return _map_layers(one, cfg, cache_layouts(cfg), caches, solo_caches)
