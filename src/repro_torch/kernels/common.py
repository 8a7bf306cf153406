"""Shared kernel utilities (port of ``repro.kernels.common``)."""
from __future__ import annotations

import itertools
from typing import NamedTuple


def pick_block(dim: int, pref: int, granule: int = 128) -> int:
    """Largest block <= pref that divides dim, preferring hardware granules;
    the full dimension when no divisor exists. The sliced-MVM kernel masks
    its ragged token and column edges itself and needs no divisor block, and
    so do the update kernels."""
    if dim <= pref:
        return dim
    if dim % pref == 0:
        return pref
    for cand in range(pref - (pref % granule), 0, -granule):
        if dim % cand == 0:
            return cand
    for cand in range(pref, 0, -1):
        if dim % cand == 0:
            return cand
    return dim


def hw_tiles(M: int, N: int) -> tuple[int, int]:
    """The (bm, bn) tile of an ``[M, N]`` block that seeds the update's
    ``"hw"`` draw: the reference kernel's default blocking
    (``pick_block(M, 128)``, ``pick_block(N, 256)``)."""
    return pick_block(M, 128), pick_block(N, 256)


def layer_views(planes) -> list:
    """Each layer's ``[S, M, N]`` block of planes ``[S, *stack, M, N]``, as
    views in stack order. On the port's layer-major storage (``[*stack, S,
    M, N]``, see ``optim.panther``) every block is contiguous, so a kernel
    updates it in place with no copy of the stack."""
    stack = planes.shape[1:-2]
    return [planes[(slice(None), *idx)] for idx in itertools.product(*map(range, stack))]


class Origin(NamedTuple):
    """Where an ``[m, n]`` block of planes sits in its leaf's ``[M, N]``
    layer (one rank's block on a mesh): its first row and column, the
    layer's ``M`` and ``N``, and ``layers``, the flat stack index in the
    whole leaf of each of the block's layers (None: ``0, 1, ...``). The
    update's draws are taken at global coordinates, so a block updated at
    its origin equals the same block of the whole leaf's update."""

    row: int = 0
    col: int = 0
    rows: int = 0
    cols: int = 0
    layers: tuple | None = None

    def layer(self, l: int) -> int:
        return l if self.layers is None else self.layers[l]


def whole(origin, m: int, n: int) -> Origin:
    """``origin`` completed for an ``[m, n]`` block: None is the whole
    layer at (0, 0)."""
    if origin is None:
        return Origin(0, 0, m, n)
    if origin.row + m > origin.rows or origin.col + n > origin.cols:
        raise ValueError(f"block [{m}, {n}] at ({origin.row}, {origin.col}) outside its layer "
                         f"[{origin.rows}, {origin.cols}]")
    return origin


# ------------------------------ meta tensors ------------------------------
#
# A kernel entry given a meta tensor (the dry run's) allocates what the
# kernel's launch would (its outputs and its workspace), records the launch
# by instance and its work in ``fake_work``, and launches nothing: there is
# no storage to launch on. The wrappers' own counters count real launches
# only. A real CUDA tensor always launches the kernel, a real CPU tensor
# always takes the plain version.


def is_fake(t) -> bool:
    """Whether ``t`` has no storage to launch a kernel on: a meta tensor."""
    return t.device.type == "meta"


def on_card(t) -> bool:
    """Whether ``t`` takes the kernel route: a CUDA tensor or a meta
    tensor."""
    return t.is_cuda or t.device.type == "meta"


# ------------------------------ work and bounds -----------------------------
#
# Each kernel's work as its bound counts it: every input read once and every
# output written once over the card's memory rate, and its operations over
# the peak of the unit that does them (one H100 SXM at 700 W, NVIDIA's data
# sheet, dense rates). ``chip_smoke.py`` computes every kernel's bound from
# these functions, and the dry run (``launch.dryrun``) sums them over a
# step's launches on meta tensors.

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak
CUDA_CORE_OPS_PER_S = 67e12  # f32 outside the tensor cores (the 32-bit elementwise rate)

# 32-bit CUDA-core operations a cell beside K1's products: the grid draw's
# threefry2x32 (20 rounds and key injections) and the hw draw's Philox; the
# device instance's physics (the write noise's two hashes and Box-Muller, the
# gain, the stuck mask's slice hashes); the counter draw's hash rides the
# tensor cores' shadow and counts none
RNG_OPS_PER_CELL = {"grid": 100, "hw": 40}
DEVICE_OPS_PER_CELL = 150
STUCK_OPS_PER_PLANE_CELL = 13
# K2's dense write beside the deposit's 8 a plane cell (digit, add, clip,
# carry): the rounding (rint and a clip; the counter hash; threefry2x32) and
# on the device instance the write noise and the gain
DENSE_DRAW_OPS = {"rint": 4, "counter": 14, "grid": 100}
DENSE_DEVICE_OPS = 110
DEPOSIT_OPS_PER_PLANE_CELL = 8.0
# K3's byte-lane carry chain: ~13 32-bit operations a word of 4 elements and
# a slice (crs.cu's crs_words)
CRS_OPS_PER_PLANE_CELL = 13 / 4


class Work(NamedTuple):
    """A launch's bytes (each input read once, each output written once)
    and its operations by unit."""

    bytes: float
    int8_ops: float = 0.0
    bf16_flops: float = 0.0
    core_ops: float = 0.0

    @property
    def ops(self) -> float:
        return self.int8_ops + self.bf16_flops + self.core_ops

    def bound_ms(self) -> tuple[float, str]:
        """``(ms, "bytes" | "operations")``: the larger of the bytes over the
        memory rate and the operations over their units' peaks."""
        t_bytes = self.bytes / HBM_BYTES_PER_S
        t_ops = self.int8_ops / INT8_OPS_PER_S + self.bf16_flops / BF16_FLOPS_PER_S \
            + self.core_ops / CUDA_CORE_OPS_PER_S
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    def __add__(self, other: "Work") -> "Work":
        return Work(*(a + b for a, b in zip(self, other)))


def read_work(B: int, M: int, N: int, S: int, io_bits: int, fused: bool = True) -> Work:
    """K4 (``fused``) or K5 on planes [S, M, N] and B tokens, either
    direction: the int8 planes, x and the f32 out once (K4's f32 x and its
    DAC exponent; K5's int32 x_q); 2·B·M·N·S·(io_bits-1) int8 operations,
    one product a (token, cell, slice, streamed bit)."""
    return Work(S * M * N + 4 * B * M + 4 * B * N + (4 if fused else 0), int8_ops=2.0 * B * M * N * S * (io_bits - 1))


def opa_work(T: int, M: int, N: int, S: int, *, dev: bool = False, draw: str = "counter",
             operand_bytes: int = 2) -> Work:
    """K1 on an [S, M, N] block from T tokens: the planes read and written,
    x [T, M] and dh [T, N] read, frac_bits; 2·T·M·N products on the bf16
    tensor cores, and the draw's and the device's CUDA-core operations a
    cell."""
    cell = RNG_OPS_PER_CELL.get(draw, 0) + (DEVICE_OPS_PER_CELL if dev else 0)
    return Work(2 * S * M * N + operand_bytes * T * (M + N) + 4, bf16_flops=2.0 * T * M * N,
                core_ops=cell * M * N if cell else 0.0)


def dense_work(M: int, N: int, S: int, *, grad_bytes: int = 4, draw: str = "counter", dev: bool = False) -> Work:
    """K2's dense write of an [S, M, N] block: the gradient read, the
    planes read and written; the deposit's, the rounding's and the device
    instance's CUDA-core operations a cell (its stuck mask's a plane
    cell)."""
    ops = DEPOSIT_OPS_PER_PLANE_CELL * S + DENSE_DRAW_OPS[draw] \
        + (DENSE_DEVICE_OPS + STUCK_OPS_PER_PLANE_CELL * S if dev else 0)
    return Work((grad_bytes + 2 * S) * M * N, core_ops=ops * M * N)


def deposit_work(M: int, N: int, S: int, *, stuck: bool = False) -> Work:
    """K2 from an int32 update (``opa_deposit``): p_q read, the planes read
    and written; the deposit's (and the stuck mask's) operations."""
    per = DEPOSIT_OPS_PER_PLANE_CELL + STUCK_OPS_PER_PLANE_CELL if stuck else DEPOSIT_OPS_PER_PLANE_CELL
    return Work((4 + 2 * S) * M * N, core_ops=per * S * M * N)


def crs_work(cells: int) -> Work:
    """K3 over ``cells`` plane cells (S·M·N): each byte read and written
    once; the carry chain's operations."""
    return Work(2 * cells, core_ops=CRS_OPS_PER_PLANE_CELL * cells)


def im2col_work(C: int, T: int, K: int, S: int, operand_bytes: int = 2) -> Work:
    """The im2col entry on an [S, K, C] block from T tokens: the planes read
    and written, x [C, T, K] and dh [C, T, 1] read, frac_bits; 2·C·T·K
    products on the CUDA cores."""
    return Work(2 * S * K * C + operand_bytes * C * T * (K + 1) + 4, core_ops=2.0 * C * T * K)


class FakeWork:
    """The launches on meta tensors by kernel instance
    (``"<kernel>/<instance>"``, the keys of ``kernels.launch_counts``):
    ``launches``, and their summed ``Work``."""

    def __init__(self):
        self.launches: dict = {}
        self.work: dict = {}

    def add(self, kernel: str, instance: str, work: Work) -> None:
        key = f"{kernel}/{instance}"
        self.launches[key] = self.launches.get(key, 0) + 1
        self.work[key] = self.work.get(key, Work(0.0)) + work

    def total(self) -> Work:
        return sum(self.work.values(), Work(0.0))

    def clear(self) -> None:
        self.launches.clear()
        self.work.clear()


fake_work = FakeWork()
