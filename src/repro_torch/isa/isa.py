"""PANTHER ISA (§5.2): the PUMA ISA extended with the ``mcu`` instruction
(port of ``repro.isa.isa``).

``mcu`` carries one 3-bit mask per MCU on the core (up to 6). Mask bits =
(MVM, MTVM, OPA); multiple set bits execute concurrently on that MCU
(hardware permitting — the *variant* decides what truly overlaps; the ISA is
variant-agnostic, §5.2). OPA takes effect at ``halt`` (deferred semantics),
which is what lets the same binary run on variants 1/2/3.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any

MAX_MCUS_PER_CORE = 6

MVM_BIT, MTVM_BIT, OPA_BIT = 4, 2, 1


class Opcode(enum.Enum):
    MCU = "mcu"  # matrix ops on the MCUs (masked)
    VFU = "vfu"  # vector op (activation, elementwise, ...)
    LOAD = "load"  # shared memory -> registers (XBarIn)
    STORE = "store"  # registers (XBarOut) -> shared memory
    SEND = "send"  # to another core/tile
    RECV = "recv"
    XREAD = "xread"  # serial row-by-row crossbar tile read (CRS, commits)
    XWRITE = "xwrite"  # serial program-verify crossbar tile write
    HALT = "halt"  # end of kernel; commit deferred OPA


@dataclasses.dataclass
class Instr:
    op: Opcode
    # MCU: masks per MCU slot + per-op operand descriptors
    masks: tuple = ()  # e.g. (0b110, 0b001)
    mcu_ops: tuple = ()  # parallel tuple of dicts: {op: (matrix_tile, in, out)}
    # VFU / LOAD / STORE / SEND / RECV operands
    args: Any = None
    n_elems: int = 0  # vector length for VFU / bytes for memory ops
    tag: str = ""  # provenance (layer name) for the energy report

    def __repr__(self):
        if self.op is Opcode.MCU:
            m = ",".join(f"{x:03b}" for x in self.masks)
            return f"mcu[{m}] {self.tag}"
        return f"{self.op.value}({self.n_elems}) {self.tag}"


@dataclasses.dataclass
class Program:
    """One instruction sequence per core: {core_id: [Instr, ...]}."""

    cores: dict
    meta: dict = dataclasses.field(default_factory=dict)

    def total_instrs(self) -> int:
        return sum(len(v) for v in self.cores.values())
