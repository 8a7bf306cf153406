"""Cycle-level energy/latency simulator for PANTHER and its baselines (port
of ``repro.isa.simulator``: the same pricing, float operation for float
operation, so a program prices to the reference's joules exactly).

Two pricers over compiled per-core instruction streams:

* :func:`simulate_plan` — the plan-aware pricer for programs from
  ``repro_torch.isa.plan_compile``: every MCU sub-op is a ``TileOp`` carrying its
  leaf's resolved slicing/IO/ADC/device attributes, and a packed bit-plane
  MVM round is priced as ONE ``dot_general``-shaped round per tile
  (``EnergyModel.mvm_packed``, per-slice ADC cost) instead of the seed
  schedule's S*(io_bits-1) serial ops. Serial crossbar traffic (dense-grad
  updates, V3 commits) arrives as explicit XREAD/XWRITE instructions.
  Energy is keyed per *leaf path* — the joules/step table of
  ``plan_compile.report``.
* :func:`simulate` — the seed-era pricer (opaque 16-bit tile-ops) kept for
  the legacy ``_compile_layers`` path and the analytic fig11-14 layer
  model below.

Shared mechanics:
  * fused MCU masks execute concurrently (latency = max over sub-ops;
    energy = sum);
  * cores progress independently (spatial architecture) with the makespan
    taken over cores — the coarse pipeline model behind Tables 1-2;
  * deferred-OPA traffic (V1/V2 shared-memory saves) and V3's serial-write
    commit at ``halt``.

Baselines share the instruction stream but re-cost it:
  * Base_digital: every crossbar op at CMOS cost (weight-stationary SRAM —
    serial crossbar R/W folds into E_MVM_CMOS and prices as SRAM latency);
  * Base_mvm: ReRAM MVM/MTVM; no in-crossbar OPA, so every weight commit =
    digital compute + serial ReRAM read+write of the touched tile;
  * Base_opa-mvm (PipeLayer, conv layers): OPA realized as ReRAM MVMs, but
    the convolution kernel (dH) is *non-stationary* -> serial writes every
    iteration (§5.4.3), plus the update read/write.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

from .compiler import Hierarchy, XBAR
from .energy import DEFAULT_ENERGY, EnergyModel
from .graph import ConvLayer, FCLayer
from .isa import MVM_BIT, MTVM_BIT, OPA_BIT, Opcode


@dataclasses.dataclass
class SimResult:
    energy_nj: dict  # layer -> {category -> nJ}
    time_ns: float
    per_core_ns: dict

    @property
    def total_energy_nj(self) -> float:
        return sum(sum(v.values()) for v in self.energy_nj.values())

    def energy_by_category(self) -> dict:
        out: dict = defaultdict(float)
        for v in self.energy_nj.values():
            for k, e in v.items():
                out[k] += e
        return dict(out)


def simulate(prog, em: EnergyModel = DEFAULT_ENERGY, system: str = "panther") -> SimResult:
    """system: panther | base_digital | base_mvm."""
    energy: dict = defaultdict(lambda: defaultdict(float))
    core_t: dict = {}
    for core, instrs in prog.cores.items():
        t = 0.0
        for ins in instrs:
            layer = ins.tag.split("/")[0]
            if ins.op is Opcode.MCU:
                lat = 0.0
                for kind, _m, _rc, reps in ins.mcu_ops:
                    e_op, l_op = _cost_mcu(kind, em, system)
                    energy[layer][kind] += e_op * reps
                    lat = max(lat, l_op * reps)
                t += lat
            elif ins.op is Opcode.VFU:
                energy[layer]["vfu"] += em.e_vfu_elem * ins.n_elems
                t += ins.n_elems * 0.01  # 100-lane VFU at 1 GHz
            elif ins.op in (Opcode.LOAD, Opcode.STORE):
                energy[layer]["mem"] += em.e_mem_byte * ins.n_elems
                t += ins.n_elems * 0.004  # 256 B/ns shared memory
            elif ins.op in (Opcode.SEND, Opcode.RECV):
                energy[layer]["mem"] += em.e_mem_byte * ins.n_elems * 2
                t += ins.n_elems * 0.008
            elif ins.op is Opcode.HALT:
                pass
        core_t[core] = t
    return SimResult(energy_nj={k: dict(v) for k, v in energy.items()},
                     time_ns=max(core_t.values()) if core_t else 0.0,
                     per_core_ns=core_t)


# ---------------------- plan-aware pricing (TileOps) ------------------------


def _plan_op_cost(op, em: EnergyModel, system: str) -> tuple:
    """``({category: nJ}, ns)`` of one TileOp (reps included) under
    ``system``. The OPA-vs-serial-write selection lives here: Base_mvm has
    no in-crossbar OPA, so an operand leaf's fused deposit re-costs as
    digital compute + a serial read+write of the tile per weight commit."""
    if op.kind in ("mvm", "mtvm"):
        if system == "base_digital":
            return {op.kind: em.e_mvm_cmos * op.reps}, em.l_mvm_cmos * op.reps
        if system == "base_mvm":
            return {op.kind: em.e_mvm_reram * op.reps}, em.l_mvm_reram * op.reps
        e, lat = em.mvm_packed(op.bits, op.io_bits, op.adc_bits)
        return {op.kind: e * op.reps}, lat * op.reps
    if op.kind == "wgrad_d" or system == "base_digital":
        # dense-grad digital compute (all systems), or any update on the
        # weight-stationary digital baseline
        return {"opa": em.e_opa_cmos * op.reps}, em.l_opa_cmos * op.reps
    if system == "base_mvm":
        return (
            {"opa": em.e_opa_cmos * op.reps, "read": em.e_read_reram,
             "write": em.e_write_reram},
            em.l_opa_cmos * op.reps + em.l_read_reram + em.l_write_reram,
        )
    e, lat = em.opa_panther(op.nonideal_write)
    return {"opa": e * op.reps}, lat * op.reps


def simulate_plan(prog, em: EnergyModel = DEFAULT_ENERGY,
                  system: str = "panther") -> SimResult:
    """Price a plan-compiled program (``plan_compile.compile_plan``) under
    ``system`` (panther | base_digital | base_mvm). Energy is keyed by leaf
    path (the tag prefix before ':')."""
    energy: dict = defaultdict(lambda: defaultdict(float))
    core_t: dict = {}
    serial_e = {"panther": (1.0, 1.0), "base_mvm": (1.0, 1.0)}
    for core, instrs in prog.cores.items():
        t = 0.0
        for ins in instrs:
            leaf = ins.tag.split(":")[0]
            if ins.op is Opcode.MCU:
                lat = 0.0
                for op in ins.mcu_ops:
                    cats, l_op = _plan_op_cost(op, em, system)
                    for cat, e in cats.items():
                        energy[op.leaf][cat] += e
                    lat = max(lat, l_op)
                t += lat
            elif ins.op is Opcode.XREAD:
                if system in serial_e:
                    energy[leaf]["read"] += em.e_read_reram * ins.n_elems
                    t += em.l_read_reram * ins.n_elems
                else:  # digital baseline: SRAM, energy folded into E_MVM_CMOS
                    t += em.l_read_sram * ins.n_elems
            elif ins.op is Opcode.XWRITE:
                if system in serial_e:
                    energy[leaf]["write"] += em.e_write_reram * ins.n_elems
                    t += em.l_write_reram * ins.n_elems
                else:
                    t += em.l_write_sram * ins.n_elems
            elif ins.op is Opcode.VFU:
                energy[leaf]["vfu"] += em.e_vfu_elem * ins.n_elems
                t += ins.n_elems * 0.01  # 100-lane VFU at 1 GHz
            elif ins.op in (Opcode.LOAD, Opcode.STORE):
                energy[leaf]["mem"] += em.e_mem_byte * ins.n_elems
                t += ins.n_elems * 0.004  # 256 B/ns shared memory
            elif ins.op in (Opcode.SEND, Opcode.RECV):
                energy[leaf]["mem"] += em.e_mem_byte * ins.n_elems * 2
                t += ins.n_elems * 0.008
            elif ins.op is Opcode.HALT:
                pass
        core_t[core] = t
    return SimResult(energy_nj={k: dict(v) for k, v in energy.items()},
                     time_ns=max(core_t.values()) if core_t else 0.0,
                     per_core_ns=core_t)


def _cost_mcu(kind: str, em: EnergyModel, system: str):
    if system == "base_digital":
        return {
            "mvm": (em.e_mvm_cmos, em.l_mvm_cmos),
            "mtvm": (em.e_mvm_cmos, em.l_mvm_cmos),
            "opa": (em.e_opa_cmos, em.l_opa_cmos),
        }[kind]
    if system == "base_mvm":
        return {
            "mvm": (em.e_mvm_reram, em.l_mvm_reram),
            "mtvm": (em.e_mvm_reram, em.l_mvm_reram),
            # OPA on Base_mvm = digital compute + serial read+write (priced
            # separately by the analytic layer below; here compute only)
            "opa": (em.e_opa_cmos, em.l_opa_cmos),
        }[kind]
    e_mvm, l_mvm = em.mvm_panther()
    return {
        "mvm": (e_mvm, l_mvm),
        "mtvm": (e_mvm, l_mvm),
        "opa": (em.e_opa_reram, em.l_opa_reram),
    }[kind]


# ------------------- analytic layer costs (paper figures) -------------------
# Tile-op counts per layer per training step; used by the Fig 11-15 benches.
# batch: examples per weight update. crs_period: steps between CRS (PANTHER).


def _layer_tiles(ly) -> int:
    if isinstance(ly, FCLayer):
        return -(-ly.d_in // XBAR) * (-(-ly.d_out // XBAR))
    r, c = ly.matrix_shape
    return -(-r // XBAR) * (-(-c // XBAR))


def _layer_reps(ly) -> int:
    return 1 if isinstance(ly, FCLayer) else ly.E * ly.E


def layer_energy(ly, system: str, batch: int, em: EnergyModel = DEFAULT_ENERGY,
                 crs_period: int = 1024, variant: str = "v2") -> dict:
    """Energy (nJ) for one *batch* (one weight update) of one layer,
    broken into categories. This is the analytic model behind Figs 11-13."""
    nt = _layer_tiles(ly)
    reps = _layer_reps(ly)
    mvm_ops = nt * reps * batch  # fwd
    mtvm_ops = nt * reps * batch  # bwd
    opa_ops = nt * reps * batch  # weight-gradient accumulations

    out = defaultdict(float)
    if system == "base_digital":
        out["mvm"] = mvm_ops * em.e_mvm_cmos
        out["mtvm"] = mtvm_ops * em.e_mvm_cmos
        out["opa"] = opa_ops * em.e_opa_cmos
    elif system == "base_mvm":
        out["mvm"] = mvm_ops * em.e_mvm_reram
        out["mtvm"] = mtvm_ops * em.e_mvm_reram
        out["opa"] = opa_ops * em.e_opa_cmos  # digital wgrad compute
        # serial read+write of every tile, once per weight update
        out["read"] = nt * em.e_read_reram
        out["write"] = nt * em.e_write_reram
    elif system == "base_opa_mvm":
        # PipeLayer-style (conv only, §5.4.3): wgrad via ReRAM MVMs with a
        # non-stationary kernel -> write dH tiles every iteration
        out["mvm"] = mvm_ops * em.e_mvm_reram
        out["mtvm"] = mtvm_ops * em.e_mvm_reram
        out["opa"] = opa_ops * em.e_mvm_reram  # wgrad as MVMs
        kernel_tiles = max(1, nt // 4)  # dH kernel occupies a tile subset
        # non-stationary kernel: written per example; update RW once per batch
        out["write"] = (batch * kernel_tiles + nt) * em.e_write_reram
        out["read"] = nt * em.e_read_reram
    else:  # panther
        e_mvm, _ = em.mvm_panther()
        out["mvm"] = mvm_ops * e_mvm
        out["mtvm"] = mtvm_ops * e_mvm
        out["opa"] = opa_ops * em.e_opa_reram
        # CRS: serial read+write every crs_period updates (amortized)
        out["crs"] = nt * (em.e_read_reram + em.e_write_reram) / crs_period
        if variant == "v3":
            # commit third copy to the other two at batch end
            out["write"] = 2 * nt * em.e_write_reram / 1.0
            out["read"] = nt * em.e_read_reram
        else:
            # V1/V2 save OPA operands to shared memory until halt
            out["mem"] = 2 * XBAR * 2 * nt * reps * batch * em.e_mem_byte
    return dict(out)


def layer_time(ly, system: str, batch: int, em: EnergyModel = DEFAULT_ENERGY,
               variant: str = "v2") -> float:
    """Batch latency (ns) of one layer under the variant pipeline:
    fwd/bwd MVMs pipeline across examples (V2 runs MVM ∥ MTVM on copies);
    OPAs serialize at batch end (V2) — the Fig 13 model."""
    nt = _layer_tiles(ly)
    reps = _layer_reps(ly)
    # tiles of one matrix operate in parallel (different MCUs) -> latency
    # counts the sequential reps x batch stream, not tile count.
    if system == "base_digital":
        # digital SRAM banks pipeline fwd ∥ bwd like V2; OPA serializes
        t_mvm = em.l_mvm_cmos * reps * batch
        t_opa = em.l_opa_cmos * reps * batch
        return t_mvm + t_opa
    if system == "base_mvm":
        # fwd ∥ bwd on crossbar copies; digital wgrad overlaps the stream;
        # serial read+write once per weight update dominates small batches
        t = max(em.l_mvm_reram * reps * batch, em.l_opa_cmos * reps * batch)
        t += em.l_read_reram + em.l_write_reram
        return t
    if system == "base_opa_mvm":
        t = max(em.l_mvm_reram * reps * batch * 2, em.l_mvm_reram * reps * batch)
        t += em.l_write_reram * max(1, batch // 4) + em.l_write_reram
        return t
    # panther
    _, l_mvm = em.mvm_panther()
    if variant in ("v2", "v3"):
        t = l_mvm * reps * batch  # MVM ∥ MTVM on the two copies
    else:
        t = l_mvm * reps * batch * 2
    if variant == "v3":
        t += em.l_opa_reram * reps  # eager OPA overlaps; commit at halt:
        t += em.l_write_reram * 2 + em.l_read_reram
    else:
        t += em.l_opa_reram * reps * batch  # serialized at batch end (Table 2)
    return t


def model_report(layers, system: str, batch: int, em: EnergyModel = DEFAULT_ENERGY,
                 variant: str = "v2", crs_period: int = 1024) -> dict:
    """Per-layer energy + total time for one weight update of the model."""
    energy = {ly.name: layer_energy(ly, system, batch, em, crs_period, variant) for ly in layers}
    time_ns = sum(layer_time(ly, system, batch, em, variant) for ly in layers)
    return {
        "per_layer_nj": energy,
        "total_nj": sum(sum(v.values()) for v in energy.values()),
        "time_ns": time_ns,
    }
