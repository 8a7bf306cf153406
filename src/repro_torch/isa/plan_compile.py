"""Lower a resolved crossbar plan + captured model shapes to the PANTHER ISA
(port of ``repro.isa.plan_compile``: host arithmetic over the port's own
param and plan trees; the streams equal the reference's, ``repr`` for
``repr``, and price to its joules and nanoseconds).

This is the bridge between the declarative mapping plan (``repro_torch.plan``)
and the hardware model (``repro_torch.isa``): the same ``LeafPlan`` tree that drives
the training engine's packed bit-plane kernels is compiled here into
per-leaf tile schedules, so a rule-list edit (a spec change, a coarser ADC,
``tiki_taka``, a ``DeviceModel``) shows up as joules and nanoseconds, not
just loss.

Pipeline::

    params/shapes + plan ──capture──> LeafMatrix per mapped leaf
        ──place──> shard-hint-aware TilePlacements (compiler.place_tiles)
        ──schedule──> per-core Instr streams of TileOps
        ──fuse──> fixpoint-fused Program  ──simulate_plan/report──> nJ, ns

Per training step of ``tokens`` tokens, each *mapped* leaf contributes per
tile:

* forward: ONE packed bit-plane MVM round per token (all S slices x
  (io_bits-1) planes in one ``dot_general``-shaped round — the packed read engine),
  priced per slice at the leaf's forward ADC resolution;
* backward: the MᵀVM transpose read at the backward ADC resolution;
* update — the OPA-vs-serial-write selection the paper's Fig 11 turns on:
    - ``grad="operand"`` leaves take the fused in-crossbar OPA deposit
      (V1/V2 defer it to ``halt`` behind shared-memory operand saves; V3
      commits a third copy with serial R/W), with program-verify overhead
      when the leaf's ``DeviceModel`` writes non-ideally;
    - ``grad="dense"`` leaves compute the gradient digitally and pay a
      serial read + program-verify write of every touched tile (XREAD /
      XWRITE) — the Base_mvm-style path;
* a ``tiki_taka`` optimizer (``momentum > 0``) adds the digital momentum
  buffer's read-modify-write traffic (LOAD/VFU/STORE over the full leaf);
* CRS amortizes a serial read+write of every tile over ``crs_every`` steps
  (accounted analytically by :func:`report`, not as instructions).

Unmapped (digital) leaves ride the VFU. Baselines re-cost the *same*
program — see :func:`repro_torch.isa.simulator.simulate_plan`.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

from .. import tree
from ..models.common import path_str
from ..plan import LeafPlan, plan_by_path
from .compiler import Hierarchy, XBAR, _mask_for, fuse, place_tiles
from .energy import DEFAULT_ENERGY, EnergyModel, PAPER_BITS
from .isa import MTVM_BIT, MVM_BIT, OPA_BIT, Instr, Opcode, Program


@dataclasses.dataclass(frozen=True)
class LeafMatrix:
    """One mapped parameter leaf, shaped for the crossbar: ``stack`` copies
    (leading scan/stack dims) of a ``rows x cols`` matrix."""

    path: str
    stack: int
    rows: int
    cols: int
    plan: LeafPlan

    @property
    def tile_grid(self) -> tuple:
        return (self.stack, -(-self.rows // XBAR), -(-self.cols // XBAR))

    @property
    def n_tiles(self) -> int:
        s, r, c = self.tile_grid
        return s * r * c

    @property
    def cells(self) -> int:
        return self.stack * self.rows * self.cols


@dataclasses.dataclass(frozen=True)
class TileOp:
    """One crossbar tile operation, carrying the pricing attributes the
    leaf's plan resolved: kinds are ``mvm`` / ``mtvm`` (packed rounds),
    ``opa`` (fused in-crossbar deposit), ``wgrad_d`` (digital dense-grad
    compute). ``reps`` counts packed rounds / pulse trains this op covers
    (= tokens per step)."""

    kind: str
    leaf: str
    tile: tuple
    reps: int
    bits: tuple = PAPER_BITS
    io_bits: int = 16
    adc_bits: int | None = None
    nonideal_write: bool = False

    def __repr__(self):
        adc = "ideal" if self.adc_bits is None else self.adc_bits
        spec = "".join(str(b) for b in self.bits)
        dev = ",dev" if self.nonideal_write else ""
        return f"{self.kind}[{self.leaf}@{self.tile}]x{self.reps}({spec},io{self.io_bits},adc{adc}{dev})"


def _leaf_fidelity(pl: LeafPlan) -> tuple:
    """(io_bits, adc_fwd, adc_bwd, nonideal_write) a leaf's plan prices at.
    No FidelityConfig (or a disabled path) reads losslessly: the full
    per-slice ADC resolution — the §6.3-taxed anchor."""
    fid = pl.fidelity
    if fid is None:
        return 16, None, None, False
    return (
        fid.io_bits,
        fid.adc_bits_fwd if fid.fwd else None,
        fid.adc_bits_bwd if fid.bwd else None,
        bool(fid.device is not None and fid.device.writes_nonideal()),
    )


def _shard_dim(pl: LeafPlan) -> int | None:
    """The tile-grid dim (0=rows, 1=cols) a leaf's plan shards over 'model',
    from the explicit ``FidelityConfig.shard_dim`` or the trailing-dims
    ``LeafPlan.shard`` hint."""
    if pl.fidelity is not None and pl.fidelity.shard_dim is not None:
        return pl.fidelity.shard_dim
    if pl.shard:
        trailing = tuple(pl.shard)[-2:]
        for i, axis in enumerate(trailing):
            if axis == "model":
                return i + (2 - len(trailing))
    return None


def capture_leaves(params, plan_tree) -> tuple:
    """Walk ``params`` (tensors, fake or meta tensors, or the ``ShapeDtype``
    leaves of ``models.lm.param_shapes``; only ``.shape`` is read, nothing
    is allocated) against the plan: ``(mapped: [LeafMatrix], digital:
    [(path, shape)])``, both sorted by path for deterministic schedules.
    ``None`` leaves are empty subtrees, as in a JAX tree."""
    shapes = {path_str(p): tuple(x.shape) for p, x in tree.leaves_with_path(params) if x is not None}
    plans = plan_by_path(plan_tree)
    mapped, digital = [], []
    for path in sorted(shapes):
        pl, shape = plans[path], shapes[path]
        if pl.mapped and len(shape) >= 2:
            stack = 1
            for d in shape[:-2]:
                stack *= int(d)
            mapped.append(LeafMatrix(path, stack, int(shape[-2]), int(shape[-1]), pl))
        else:
            digital.append((path, shape))
    return mapped, digital


def _plan_no_dep(a: Instr, b: Instr) -> bool:
    """Plan-pipeline dependence test for fusion: ops touching the same leaf
    (tag prefix before ':') never fuse across phases unless identical."""
    return a.tag.split(":")[0] != b.tag.split(":")[0] or a.tag == b.tag


def compile_plan(params, plan_tree, *, tokens: int = 1, opt_cfg=None,
                 variant: str = "v2", hw: Hierarchy = Hierarchy(),
                 n_shards: int = 1) -> Program:
    """Compile a resolved plan over ``params`` into a fused :class:`Program`
    of per-leaf tile schedules for one training step of ``tokens`` tokens.

    ``opt_cfg`` (a ``PantherConfig``) contributes the CRS period and — when
    ``momentum > 0`` (the ``tiki_taka`` rule) — the digital momentum
    buffer's per-step read-modify-write traffic. ``n_shards`` is the size of
    the mesh 'model' axis the plan's shard hints refer to."""
    mapped, digital = capture_leaves(params, plan_tree)
    grids = {lm.path: lm.tile_grid for lm in mapped}
    hints = {lm.path: d for lm in mapped if (d := _shard_dim(lm.plan)) is not None}
    placements = place_tiles(grids, hw, hints=hints, n_shards=n_shards)

    momentum = float(getattr(opt_cfg, "momentum", 0.0) or 0.0)
    crs_every = int(getattr(opt_cfg, "crs_every", 1024) or 1024)

    cores: dict = defaultdict(list)
    deferred: dict = defaultdict(list)  # core -> [(mcu, TileOp, tag)]
    commits: dict = defaultdict(list)  # core -> [Instr] (V3 serial R/W)

    def tile_op(kind, lm, t, reps, adc):
        io, _af, _ab, dev = _leaf_fidelity(lm.plan)
        return TileOp(kind, lm.path, t.tile_rc, reps, tuple(lm.plan.spec.bits),
                      io, adc, dev)

    def mcu_instr(lm, t, kind, bit, reps, adc, tag):
        return Instr(Opcode.MCU, masks=_mask_for(t.mcu, bit, hw),
                     mcu_ops=(tile_op(kind, lm, t, reps, adc),),
                     n_elems=reps, tag=tag)

    # ---- forward: packed MVM rounds, depth order ----
    for lm in mapped:
        _io, adc_f, _ab, _dev = _leaf_fidelity(lm.plan)
        for t in placements[lm.path]:
            cores[t.core].append(mcu_instr(lm, t, "mvm", MVM_BIT, tokens,
                                           adc_f, f"{lm.path}:fwd"))
    for path, shape in digital:
        cores[0].append(Instr(Opcode.VFU, n_elems=tokens * int(shape[-1]),
                              tag=f"{path}:fwd"))

    # ---- backward: MᵀVM transpose reads, reverse depth order ----
    for lm in reversed(mapped):
        _io, _af, adc_b, _dev = _leaf_fidelity(lm.plan)
        for t in placements[lm.path]:
            cores[t.core].append(mcu_instr(lm, t, "mtvm", MTVM_BIT, tokens,
                                           adc_b, f"{lm.path}:bwd"))

    # ---- update: fused OPA vs serial read/write, per the leaf's grad mode
    for lm in mapped:
        for t in placements[lm.path]:
            if lm.plan.grad == "operand":
                if variant in ("v1", "v2"):
                    # deferred OPA (§5.2): operands saved to shared memory
                    # now, crossbar applied at halt
                    cores[t.core].append(Instr(
                        Opcode.STORE, n_elems=2 * XBAR * 2 * tokens,
                        tag=f"{lm.path}:save"))
                    deferred[t.core].append(
                        (t.mcu, tile_op("opa", lm, t, tokens, None),
                         f"{lm.path}:wgrad"))
                else:  # v3: eager OPA on the third copy, serial commit
                    cores[t.core].append(mcu_instr(lm, t, "opa", OPA_BIT,
                                                   tokens, None,
                                                   f"{lm.path}:wgrad"))
                    commits[t.core].append(Instr(
                        Opcode.XREAD, n_elems=1, tag=f"{lm.path}:commit"))
                    commits[t.core].append(Instr(
                        Opcode.XWRITE, n_elems=2, tag=f"{lm.path}:commit"))
            else:  # dense-grad: digital wgrad + serial read-modify-write
                cores[t.core].append(mcu_instr(lm, t, "wgrad_d", OPA_BIT,
                                               tokens, None,
                                               f"{lm.path}:wgrad"))
                cores[t.core].append(Instr(
                    Opcode.XREAD, n_elems=1, tag=f"{lm.path}:update"))
                cores[t.core].append(Instr(
                    Opcode.XWRITE, n_elems=1, tag=f"{lm.path}:update"))
        if momentum > 0.0:
            # tiki_taka: digital momentum buffer read-modify-write, once per
            # step over the whole leaf (4-byte f32 cells) on its first core
            core0 = placements[lm.path][0].core
            cores[core0].append(Instr(Opcode.LOAD, n_elems=4 * lm.cells,
                                      tag=f"{lm.path}:momentum"))
            cores[core0].append(Instr(Opcode.VFU, n_elems=lm.cells,
                                      tag=f"{lm.path}:momentum"))
            cores[core0].append(Instr(Opcode.STORE, n_elems=4 * lm.cells,
                                      tag=f"{lm.path}:momentum"))

    # ---- halt: deferred OPAs fire (V1/V2); V3 commits its third copy ----
    for core, items in deferred.items():
        for mcu, op, tag in items:
            cores[core].append(Instr(Opcode.MCU, masks=_mask_for(mcu, OPA_BIT, hw),
                                     mcu_ops=(op,), n_elems=op.reps, tag=tag))
    for core, items in commits.items():
        cores[core].extend(items)
    for core in sorted(cores):
        cores[core].append(Instr(Opcode.HALT, tag="halt"))

    meta = {
        "pipeline": "plan", "variant": variant, "hw": hw, "tokens": tokens,
        "n_shards": n_shards, "momentum": momentum, "crs_every": crs_every,
        "leaves": {
            lm.path: {"tiles": lm.n_tiles, "cells": lm.cells,
                      "category": lm.plan.category,
                      "spec": lm.plan.spec.name()}
            for lm in mapped
        },
        "digital": [path for path, _ in digital],
    }
    prog = Program(cores={c: cores[c] for c in sorted(cores)}, meta=meta)
    return fuse(prog, variant, hw, no_dep=_plan_no_dep)


def report(prog: Program, system: str = "panther",
           em: EnergyModel = DEFAULT_ENERGY) -> dict:
    """Per-leaf joules/step table for one compiled step: simulate the
    program under ``system`` (panther | base_digital | base_mvm) and fold in
    the CRS amortization (PANTHER only — baselines carry no slice planes)."""
    from .simulator import simulate_plan

    r = simulate_plan(prog, em, system)
    per_leaf = {k: dict(v) for k, v in r.energy_nj.items()}
    if system == "panther":
        crs_every = prog.meta.get("crs_every", 1024)
        for path, info in prog.meta.get("leaves", {}).items():
            e_crs = info["tiles"] * (em.e_read_reram + em.e_write_reram) / crs_every
            per_leaf.setdefault(path, {})["crs"] = e_crs
    total = sum(sum(v.values()) for v in per_leaf.values())
    return {"system": system, "per_leaf_nj": per_leaf, "total_nj": total,
            "time_ns": r.time_ns, "n_instrs": prog.total_instrs()}


def systems_summary(prog: Program, em: EnergyModel = DEFAULT_ENERGY) -> dict:
    """The headline comparison: PANTHER vs the digital (Base_digital) and
    serial-write (Base_mvm) baselines re-costing the same compiled step."""
    reps = {s: report(prog, s, em) for s in ("panther", "base_digital", "base_mvm")}
    p = reps["panther"]
    return {
        "panther_nj": p["total_nj"],
        "base_digital_nj": reps["base_digital"]["total_nj"],
        "base_mvm_nj": reps["base_mvm"]["total_nj"],
        "vs_digital": reps["base_digital"]["total_nj"] / p["total_nj"],
        "vs_serial_write": reps["base_mvm"]["total_nj"] / p["total_nj"],
        "panther_time_ns": p["time_ns"],
        "time_vs_digital": reps["base_digital"]["time_ns"] / p["time_ns"],
        "time_vs_serial_write": reps["base_mvm"]["time_ns"] / p["time_ns"],
    }


def token_latency_ns(params, plan_tree, em: EnergyModel = DEFAULT_ENERGY) -> float:
    """Decode latency of ONE token through the compiled forward path: mapped
    leaves read depth-serially (tiles of a leaf run in parallel across MCUs;
    ``stack`` copies are distinct layers and serialize), digital leaves ride
    the VFU. This is what the serving clock prices rounds with."""
    mapped, digital = capture_leaves(params, plan_tree)
    t = 0.0
    for lm in mapped:
        io, adc_f, _ab, _dev = _leaf_fidelity(lm.plan)
        _e, lat = em.mvm_packed(tuple(lm.plan.spec.bits), io, adc_f)
        t += lat * lm.stack
    for _path, shape in digital:
        t += int(shape[-1]) * 0.01  # 100-lane VFU at 1 GHz
    return t
