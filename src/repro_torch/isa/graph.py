"""Computational-graph capture (§5.3): a minimal runtime-library tracer in
the style of the PUMA compiler's C++ API. Programmers declare *training
matrices* and express the model as matrix/vector ops; executing the model
builder records a graph that the compiler partitions, fuses, schedules, and
lowers to ISA code. (Port of ``repro.isa.graph``.)
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class TrainingMatrix:
    """A weight matrix supporting MVM, MTVM, and OPA (§5.3 API extension)."""

    name: str
    rows: int  # input dim (crossbar rows)
    cols: int  # output dim (crossbar cols)

    def tiles(self, xbar: int = 128) -> tuple:
        return (-(-self.rows // xbar), -(-self.cols // xbar))

    def n_tiles(self, xbar: int = 128) -> int:
        tr, tc = self.tiles(xbar)
        return tr * tc


@dataclasses.dataclass
class Node:
    kind: str  # mvm | mtvm | opa | vfu | input | output
    matrix: TrainingMatrix | None
    inputs: list
    n_elems: int = 0  # vector length for vfu nodes
    reps: int = 1  # iterative ops (conv: E^2 iterations, §5.4)
    tag: str = ""
    id: int = -1


class Graph:
    def __init__(self):
        self.nodes: list[Node] = []
        self.matrices: dict[str, TrainingMatrix] = {}

    def matrix(self, name, rows, cols) -> TrainingMatrix:
        m = TrainingMatrix(name, rows, cols)
        self.matrices[name] = m
        return m

    def add(self, kind, matrix=None, inputs=(), n_elems=0, reps=1, tag="") -> Node:
        n = Node(kind, matrix, list(inputs), n_elems, reps, tag, id=len(self.nodes))
        self.nodes.append(n)
        return n


# ------------------------- layer-level builders -----------------------------


@dataclasses.dataclass
class FCLayer:
    name: str
    d_in: int
    d_out: int

    def flops_fwd(self):
        return 2 * self.d_in * self.d_out

    def weight_bytes(self):
        return 4 * self.d_in * self.d_out


@dataclasses.dataclass
class ConvLayer:
    """Table 4 nomenclature: C in-channels, M out-channels, H/W input size,
    R/S kernel, E/F output size."""

    name: str
    C: int
    M: int
    H: int
    R: int
    E: int

    @property
    def matrix_shape(self):
        # linearized filters: rows = C*R*R, cols = M (Fig 7b)
        return (self.C * self.R * self.R, self.M)

    def flops_fwd(self):
        r, c = self.matrix_shape
        return 2 * r * c * self.E * self.E

    def weight_bytes(self):
        r, c = self.matrix_shape
        return 4 * r * c


def build_training_graph(layers, batch: int = 1) -> Graph:
    """Unrolled training graph for one batch: forward MVMs, backward MTVMs,
    weight-gradient OPAs (conv ops iterate E^2 times — §5.4's outer-product
    formulation of the weight-gradient convolution)."""
    g = Graph()
    acts = g.add("input", tag="x0")
    for ly in layers:
        if isinstance(ly, FCLayer):
            m = g.matrix(ly.name, ly.d_in, ly.d_out)
            reps_mvm, n_act = 1, ly.d_out
        else:
            r, c = ly.matrix_shape
            m = g.matrix(ly.name, r, c)
            reps_mvm, n_act = ly.E * ly.E, ly.M * ly.E * ly.E
        for b in range(batch):
            mv = g.add("mvm", m, [acts], reps=reps_mvm, tag=f"{ly.name}/fwd b{b}")
            g.add("vfu", None, [mv], n_elems=n_act, tag=f"{ly.name}/act b{b}")
    # backward + weight gradients
    for ly in reversed(layers):
        m = g.matrices[ly.name]
        if isinstance(ly, FCLayer):
            reps = 1
        else:
            reps = ly.E * ly.E
        for b in range(batch):
            g.add("mtvm", m, [], reps=reps, tag=f"{ly.name}/bwd b{b}")
            g.add("opa", m, [], reps=reps, tag=f"{ly.name}/wgrad b{b}")
    return g


# ------------------------------ workloads -----------------------------------
# Paper Table 4.

MLP_L4 = [
    FCLayer("Dense1", 1024, 256),
    FCLayer("Dense2", 256, 512),
    FCLayer("Dense3", 512, 512),
    FCLayer("Dense4", 512, 10),
]

VGG16 = [
    ConvLayer("Conv1", 3, 64, 32, 3, 32),
    ConvLayer("Conv2", 32, 64, 32, 3, 16),
    ConvLayer("Conv3", 64, 128, 16, 3, 16),
    ConvLayer("Conv4", 128, 128, 16, 3, 8),
    ConvLayer("Conv5", 128, 256, 8, 3, 8),
    ConvLayer("Conv6", 256, 256, 8, 3, 8),
    ConvLayer("Conv7", 256, 256, 8, 3, 4),
    ConvLayer("Conv8", 256, 512, 4, 3, 4),
    ConvLayer("Conv9", 512, 512, 4, 3, 4),
    ConvLayer("Conv10", 512, 512, 4, 3, 2),
    ConvLayer("Conv11", 512, 512, 2, 3, 2),
    ConvLayer("Conv12", 512, 512, 2, 3, 2),
    ConvLayer("Conv13", 512, 512, 2, 3, 1),
    FCLayer("Dense14", 512, 4096),
    FCLayer("Dense15", 4096, 4096),
    FCLayer("Dense16", 4096, 100),
]
