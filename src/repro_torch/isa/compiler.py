"""PANTHER compiler (§5.3): partition -> place -> schedule (variant-aware)
-> fuse -> codegen (port of ``repro.isa.compiler``: host arithmetic, the
reference's placement, schedules and fusion, instruction for instruction).

Two entry points share these stages:

* :func:`repro_torch.isa.plan_compile.compile_plan` — the modern pipeline: a
  resolved per-leaf ``CrossbarPlan`` + captured model shapes lower to
  per-leaf tile schedules (packed bit-plane MVM rounds, MᵀVM transpose
  reads, fused-OPA vs serial read/write updates), using this module's
  placement (:func:`place_tiles`) and fusion (:func:`fuse`).
* ``_compile_layers`` — the seed-era looped-schedule pipeline over
  ``FCLayer``/``ConvLayer`` lists, kept for the legacy simulator tests and
  ``repro_torch.examples.isa_energy_report``. It prices every MVM as one opaque
  16-bit tile-op and knows nothing about plans, bit-plane packing, or
  sharding; its public entry :func:`compile_model` graduated from
  DeprecationWarning to a hard ``RuntimeError``.

Pipeline stages mirroring the paper's PUMA extension:
  1. *Partition*: every weight matrix is cut into 128x128 tiles.
  2. *Placement*: contiguous MCU runs per matrix (2 MCUs/core, 8 cores/tile,
     138 tiles/node — Table 3). A plan shard hint splits the matrix's tile
     grid along its sharded dim into per-shard groups, each aligned to a
     Table-3 tile boundary, so one mesh shard's crossbars are co-resident
     and its partial-sum reduction crosses the NoC once per shard.
  3. *Schedule*: the variant dataflow — V1 serializes MVM/MTVM/OPA on one
     crossbar (Table 1); V2 runs MVM ∥ MTVM on two copies, defers OPA to
     batch end (Table 2 steps 9-12); V3 adds an eager-OPA third copy and
     commits with serial R/W at ``halt``.
  4. *Fusion*: MCU ops with no data dependence targeting different MCUs of
     one core (or different op kinds on one MCU, variant permitting) merge
     into a single ``mcu`` instruction — iterated to fixpoint.
  5. *Codegen*: per-core instruction streams (+ loads/stores/sends).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

from .graph import Graph, Node
from .isa import MVM_BIT, MTVM_BIT, OPA_BIT, Instr, Opcode, Program

XBAR = 128


@dataclasses.dataclass(frozen=True)
class Hierarchy:  # Table 3
    tiles_per_node: int = 138
    cores_per_tile: int = 8
    mcus_per_core: int = 2

    @property
    def n_cores(self):
        return self.tiles_per_node * self.cores_per_tile

    @property
    def n_mcus(self):
        return self.n_cores * self.mcus_per_core

    @property
    def mcus_per_tile(self):
        return self.cores_per_tile * self.mcus_per_core


@dataclasses.dataclass
class TilePlacement:
    matrix: str
    tile_rc: tuple
    mcu: int
    shard: int = 0  # mesh shard group this tile belongs to (plan hints)

    @property
    def core(self):
        return self.mcu // 2


def place_tiles(grids: dict, hw: Hierarchy, hints: dict | None = None,
                n_shards: int = 1) -> dict:
    """Place tile grids onto MCUs: ``{name: (stack, tile_rows, tile_cols)}``
    -> ``{name: [TilePlacement]}``.

    Unhinted matrices get a contiguous MCU run (tiles of one matrix operate
    in parallel on distinct MCUs while capacity lasts). A shard hint
    (``hints[name] = 0`` for row-sharded, ``1`` for column-sharded, from the
    plan's ``shard``/``shard_dim``) with ``n_shards > 1`` splits that
    matrix's tile grid along the hinted dim into ``n_shards`` contiguous
    groups, each starting on a fresh Table-3 tile boundary — the placement
    then matches the mesh layout the engine actually runs, instead of
    round-robining tiles across shard boundaries."""
    hints = hints or {}
    placements: dict = {}
    next_mcu = 0

    def take(n):
        nonlocal next_mcu
        start = next_mcu
        next_mcu += n
        return start

    for name, (stack, tr, tc) in grids.items():
        dim = hints.get(name)
        tiles = []
        if dim is not None and n_shards > 1:
            span = tr if dim == 0 else tc
            bounds = [span * s // n_shards for s in range(n_shards + 1)]
            for shard in range(n_shards):
                # each shard group opens on a Table-3 tile boundary
                next_mcu = -(-next_mcu // hw.mcus_per_tile) * hw.mcus_per_tile
                lo, hi = bounds[shard], bounds[shard + 1]
                for k in range(stack):
                    for r in range(tr) if dim else range(lo, hi):
                        for c in range(lo, hi) if dim else range(tc):
                            tiles.append(TilePlacement(
                                name, (k, r, c), take(1) % hw.n_mcus, shard))
        else:
            for k in range(stack):
                for r in range(tr):
                    for c in range(tc):
                        tiles.append(TilePlacement(name, (k, r, c), take(1) % hw.n_mcus))
        placements[name] = tiles
    return placements


def partition_and_place(g: Graph, hw: Hierarchy, hints: dict | None = None,
                        n_shards: int = 1) -> dict:
    """matrix name -> [TilePlacement] via :func:`place_tiles` (legacy graph
    front end; tile_rc stays 2-D for the seed-era scheduler)."""
    grids = {name: (1, *m.tiles(XBAR)) for name, m in g.matrices.items()}
    placements = place_tiles(grids, hw, hints=hints, n_shards=n_shards)
    return {
        name: [dataclasses.replace(t, tile_rc=t.tile_rc[1:]) for t in tiles]
        for name, tiles in placements.items()
    }


def schedule(g: Graph, placements: dict, variant: str = "v2", hw: Hierarchy = Hierarchy()) -> Program:
    """Lower the graph to per-core instruction streams.

    Scheduling model: list-schedule in graph order; every matrix op expands
    to one MCU sub-op per placed tile (x reps for conv iterations). The
    fusion pass then packs independent sub-ops into shared `mcu` instrs.
    """
    cores: dict = defaultdict(list)
    deferred_opa: dict = defaultdict(list)  # core -> [(mcu, tag, reps)]

    for node in g.nodes:
        if node.kind in ("input", "output"):
            continue
        if node.kind == "vfu":
            # VFU ops land on the core of their producing matrix (approx: core 0)
            cores[0].append(Instr(Opcode.VFU, n_elems=node.n_elems * node.reps, tag=node.tag))
            continue
        tiles = placements[node.matrix.name]
        bit = {"mvm": MVM_BIT, "mtvm": MTVM_BIT, "opa": OPA_BIT}[node.kind]
        if node.kind == "opa" and variant in ("v1", "v2"):
            # deferred OPA (§5.2 halt semantics): operands saved to shared
            # memory now, crossbar applied at halt
            for t in tiles:
                cores[t.core].append(
                    Instr(Opcode.STORE, n_elems=2 * XBAR * 2 * node.reps, tag=f"{node.tag}/save")
                )
                deferred_opa[t.core].append((t.mcu, node.tag, node.reps))
            continue
        for t in tiles:
            cores[t.core].append(
                Instr(
                    Opcode.MCU,
                    masks=_mask_for(t.mcu, bit, hw),
                    mcu_ops=((node.kind, t.matrix, t.tile_rc, node.reps),),
                    n_elems=node.reps,
                    tag=node.tag,
                )
            )

    # halt: deferred OPAs fire (V1/V2); V3 instead commits its third copy
    for core, items in deferred_opa.items():
        for mcu, tag, reps in items:
            cores[core].append(
                Instr(Opcode.MCU, masks=_mask_for(mcu, OPA_BIT, hw),
                      mcu_ops=(("opa", None, None, reps),), n_elems=reps, tag=f"{tag}/halt")
            )
    for core in list(cores):
        cores[core].append(Instr(Opcode.HALT, tag="halt"))

    prog = Program(cores=dict(cores), meta={"variant": variant, "hw": hw})
    return fuse(prog, variant, hw)


def _mask_for(mcu: int, bit: int, hw: Hierarchy) -> tuple:
    slot = mcu % hw.mcus_per_core
    masks = [0] * hw.mcus_per_core
    masks[slot] = bit
    return tuple(masks)


def _can_fuse(a: Instr, b: Instr, variant: str) -> bool:
    if a.op is not Opcode.MCU or b.op is not Opcode.MCU:
        return False
    for ma, mb in zip(a.masks, b.masks):
        overlap = ma & mb
        if overlap:
            return False  # same op kind on same MCU
        both = ma | mb
        if ma and mb:
            # same MCU, different kinds: V1 can't overlap MVM/MTVM (one
            # crossbar); V2/V3 can (copies). OPA overlaps anywhere (deferred).
            if variant == "v1" and (both & MVM_BIT) and (both & MTVM_BIT):
                return False
    return True


def fuse(prog: Program, variant: str, hw: Hierarchy, no_dep=None) -> Program:
    """Iterative fusion (§5.3): greedily merge adjacent independent MCU
    instructions per core until fixpoint. ``no_dep`` overrides the
    dependence test (the plan pipeline keys lineage on leaf paths)."""
    no_dep = no_dep or _no_dep
    out_cores = {}
    for core, instrs in prog.cores.items():
        changed = True
        cur = list(instrs)
        while changed:
            changed = False
            nxt: list = []
            for ins in cur:
                if nxt and _can_fuse(nxt[-1], ins, variant) and no_dep(nxt[-1], ins):
                    prev = nxt[-1]
                    nxt[-1] = Instr(
                        Opcode.MCU,
                        masks=tuple(x | y for x, y in zip(prev.masks, ins.masks)),
                        mcu_ops=prev.mcu_ops + ins.mcu_ops,
                        n_elems=max(prev.n_elems, ins.n_elems),
                        tag=prev.tag,
                    )
                    changed = True
                else:
                    nxt.append(ins)
            cur = nxt
        out_cores[core] = cur
    return Program(cores=out_cores, meta=prog.meta)


def _no_dep(a: Instr, b: Instr) -> bool:
    """Adjacent same-layer fwd->act->... deps are conservatively encoded by
    tag lineage: ops from the same (layer, batch-index) never fuse."""
    return a.tag.split("/")[0] != b.tag.split("/")[0] or a.tag == b.tag


def compile_model(layers, batch: int = 1, variant: str = "v2", hw: Hierarchy = Hierarchy()):
    """Removed seed-era looped-schedule entry (a deprecation graduated to a
    hard error). Use
    :func:`repro_torch.isa.plan_compile.compile_plan`, which lowers a resolved
    per-leaf plan (packed bit-plane rounds, per-slice ADC pricing, OPA vs
    serial-write selection) instead of opaque 16-bit tile-ops."""
    raise RuntimeError(
        "repro_torch.isa.compiler.compile_model was removed; use "
        "repro_torch.isa.plan_compile.compile_plan(plan, ...) to lower a resolved "
        "CrossbarPlan to the packed per-leaf schedule"
    )


def _compile_layers(layers, batch: int = 1, variant: str = "v2", hw: Hierarchy = Hierarchy()):
    from .graph import build_training_graph

    g = build_training_graph(layers, batch=batch)
    placements = partition_and_place(g, hw)
    prog = schedule(g, placements, variant=variant, hw=hw)
    return g, placements, prog
