"""Bit-sliced weight representation (port of ``repro.core.slicing``).

A 32-bit fixed-point weight is held as ``S`` signed digit planes in balanced
base-16: ``w = sum_s plane[s] * 16**s``, plane ``s`` covering logical bits
``[4s, 4s+4)`` and stored in a crossbar of ``bits[s]`` physical bits (the
surplus is carry headroom). ``SliceSpec.bits`` is written MSB->LSB as in the
paper's "44466555"; planes are indexed LSB-first.
"""
from __future__ import annotations

import dataclasses

import torch

LOGICAL_BITS = 4  # p=4 column-DAC chunk width (paper §3.3 choice)
RADIX = 1 << LOGICAL_BITS  # 16


@dataclasses.dataclass(frozen=True)
class SliceSpec:
    """Heterogeneous weight-slicing configuration: physical bits per slice,
    MSB->LSB. The paper's default is "44466555", 39 bits for a 32-bit
    weight."""

    bits: tuple = (4, 4, 4, 6, 6, 5, 5, 5)

    def __post_init__(self):
        object.__setattr__(self, "bits", tuple(int(b) for b in self.bits))
        if any(b < 2 or b > 8 for b in self.bits):
            raise ValueError(f"slice bits must be in [2, 8], got {self.bits}")

    @property
    def n_slices(self) -> int:
        return len(self.bits)

    @property
    def total_bits(self) -> int:
        return sum(self.bits)

    @property
    def bits_lsb_first(self) -> tuple:
        return tuple(reversed(self.bits))

    @property
    def plane_max(self) -> tuple:
        """Saturating bound per plane, LSB-first: plane in [-m, m]."""
        return tuple((1 << (b - 1)) for b in self.bits_lsb_first)

    @property
    def word_bits(self) -> int:
        return LOGICAL_BITS * self.n_slices

    def name(self) -> str:
        return "".join(str(b) for b in self.bits)

    @staticmethod
    def uniform(bits_per_slice: int, n_slices: int = 8) -> "SliceSpec":
        return SliceSpec(bits=(bits_per_slice,) * n_slices)

    @property
    def canonical_limit(self) -> int:
        """Largest magnitude representable by canonical balanced digits:
        ``7 * (16^S - 1) / 15``; the symmetric weight rail."""
        return (RADIX // 2 - 1) * (RADIX**self.n_slices - 1) // (RADIX - 1)


DEFAULT_SPEC = SliceSpec()


def slice_weights(q: torch.Tensor, spec: SliceSpec = DEFAULT_SPEC) -> torch.Tensor:
    """Canonically decompose int32 fixed-point weights into int8 digit planes
    ``[S, *q.shape]``, LSB-first, balanced base-16 digits in [-8, 7]. Input is
    clipped to ``±canonical_limit``. Integer ``%`` and ``//`` follow Python
    (floor) semantics in torch, as in ``jnp``."""
    lim = spec.canonical_limit
    rem = torch.clamp(q.to(torch.int32), -lim, lim)
    out = torch.empty((spec.n_slices, *q.shape), dtype=torch.int8, device=q.device)
    for s in range(spec.n_slices):
        d = ((rem + RADIX // 2) % RADIX) - RADIX // 2  # balanced digit [-8, 7]
        out[s] = d.to(torch.int8)
        rem = (rem - d) // RADIX
    return out


def unslice_weights(planes: torch.Tensor, spec: SliceSpec = DEFAULT_SPEC) -> torch.Tensor:
    """Reassemble int32 weights ``sum_s plane_s * 16**s`` (canonical planes)."""
    acc = planes[-1].to(torch.int32)
    for s in range(spec.n_slices - 2, -1, -1):
        acc = acc * RADIX + planes[s].to(torch.int32)
    return acc


def dequantize_planes(
    planes: torch.Tensor,
    frac_bits,
    spec: SliceSpec = DEFAULT_SPEC,
    dtype=torch.float32,
) -> torch.Tensor:
    """Dequantize possibly-dirty planes to float, ``sum_s plane_s 2^{4s-F}``,
    with the per-plane sums in float32 in the reference's order."""
    from .fixed_point import exp2i

    acc = planes[-1].to(torch.float32)
    for s in range(planes.shape[0] - 2, -1, -1):
        acc = acc * float(RADIX) + planes[s].to(torch.float32)
    scale = exp2i(-torch.as_tensor(frac_bits, dtype=torch.int32)).to(acc.device)
    return (acc * scale).to(dtype)


def _digits_of(value: int, n: int) -> list:
    """Balanced base-16 digits of a Python int, LSB-first."""
    out, rem = [], value
    for _ in range(n):
        d = ((rem + RADIX // 2) % RADIX) - RADIX // 2
        out.append(d)
        rem = (rem - d) // RADIX
    return out


def _plane_max(spec: SliceSpec, ndim: int, device) -> torch.Tensor:
    m = torch.tensor(spec.plane_max, dtype=torch.int32, device=device)
    return m.reshape((spec.n_slices,) + (1,) * (ndim - 1))


def saturating_add(planes: torch.Tensor, delta: torch.Tensor, spec: SliceSpec = DEFAULT_SPEC) -> torch.Tensor:
    """Per-plane saturating accumulate ``clip(plane + delta, -m_s, m_s)``:
    int32 ``delta`` ``[S, ...]`` -> int8 planes."""
    m = _plane_max(spec, planes.dim(), planes.device)
    out = planes.to(torch.int32) + delta.to(torch.int32)
    return torch.minimum(torch.maximum(out, -m), m).to(torch.int8)


def saturation_fraction(planes: torch.Tensor, spec: SliceSpec = DEFAULT_SPEC) -> torch.Tensor:
    """Fraction of saturated cells per plane (the paper's Fig-9 metric), f32
    ``[S]``."""
    m = _plane_max(spec, planes.dim(), planes.device)
    sat = planes.to(torch.int32).abs() >= m
    return sat.to(torch.float32).mean(dim=tuple(range(1, planes.dim())))


def crs(planes: torch.Tensor, spec: SliceSpec = DEFAULT_SPEC) -> torch.Tensor:
    """Carry Resolution Step (paper §3.2): digit-serial carry propagation
    LSB -> MSB; a carry out of the MSB rails the whole digit vector to
    ``±canonical_limit``, and carry-free vectors below ``-canonical_limit``
    rail to it by an MSB-first lexicographic compare."""
    S = spec.n_slices
    carry = torch.zeros(planes.shape[1:], dtype=torch.int32, device=planes.device)
    digs = []
    for s in range(S):
        v = planes[s].to(torch.int32) + carry
        d = ((v + RADIX // 2) % RADIX) - RADIX // 2
        digs.append(d)
        carry = (v - d) // RADIX
    lim = spec.canonical_limit
    pos, neg = _digits_of(lim, S), _digits_of(-lim, S)
    lt = torch.zeros(planes.shape[1:], dtype=torch.bool, device=planes.device)
    gt = torch.zeros_like(lt)
    for s in range(S - 1, -1, -1):
        lt_new = lt | (~gt & (digs[s] < neg[s]))
        gt = gt | (~lt & (digs[s] > neg[s]))
        lt = lt_new
    out = torch.empty_like(planes, dtype=torch.int8)
    for s in range(S):
        d = torch.where(carry > 0, pos[s], digs[s])
        d = torch.where(carry < 0, neg[s], d)
        out[s] = torch.where(lt & (carry == 0), neg[s], d).to(torch.int8)
    return out


def product_digits(p: torch.Tensor, spec: SliceSpec = DEFAULT_SPEC) -> torch.Tensor:
    """Balanced base-16 digit deltas ``[S, ...]`` (int32 in [-8, 7]) of an
    int32 update, clipped to ``±canonical_limit`` first."""
    lim = spec.canonical_limit
    rem = torch.clamp(p.to(torch.int32), -lim, lim)
    out = torch.empty((spec.n_slices, *p.shape), dtype=torch.int32, device=p.device)
    for s in range(spec.n_slices):
        d = ((rem + RADIX // 2) % RADIX) - RADIX // 2
        out[s] = d
        rem = (rem - d) // RADIX
    return out
