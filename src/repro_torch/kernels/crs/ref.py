"""Plain PyTorch version of the CRS kernel (port of
``repro.kernels.crs.ref``): ``core.slicing.crs``. The CPU tests run it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.

``crs_words`` and ``crs_split`` mirror the kernel: the byte-lane arithmetic
it runs on 4 elements a 32-bit word, and its split of a block's flat ``M·N``
elements into a per-element head, 16-byte-aligned groups walked in bulk
chunks by a persistent grid, and a per-element tail. The CPU tests hold them
against the reference; nothing on the card path calls them.
"""
from __future__ import annotations

import torch

from repro_torch.core.slicing import SliceSpec, crs

GROUP = 16  # elements a thread resolves at once: one 16-byte access per plane
CHUNK = 16 * 256  # elements of one bulk chunk: 16 a thread, 256 threads (the source's CHUNK)
MASK32 = 0xFFFFFFFF


def crs_ref(planes, spec: SliceSpec):
    """planes int8 [S, ...] -> canonical planes (carry propagation and the
    ±canonical_limit rails)."""
    return crs(planes, spec)


def split(mn: int, addr: int) -> tuple[int, int]:
    """(head, nbulk) of a block of ``mn`` elements a plane whose planes start
    at byte address ``addr``: ``head`` elements resolved one at a time up to
    the first 16-byte boundary, then ``nbulk`` (a multiple of 16) in bulk,
    then the tail. Where ``mn`` is not a multiple of 16 the planes' segments
    are aligned differently, and every element takes the per-element
    routine."""
    if mn % GROUP:
        return mn, 0
    head = -addr % GROUP
    return head, (mn - head) // GROUP * GROUP


def chunk_order(nbulk: int, grid: int) -> list[list[int]]:
    """The bulk chunks each block of a persistent grid walks, in order:
    block ``b`` takes chunks ``b, b + grid, ...``."""
    chunks = -(-nbulk // CHUNK)
    return [list(range(b, chunks, grid)) for b in range(grid)]


def crs_words(w: torch.Tensor) -> torch.Tensor:
    """The kernel's CRS on words: ``w`` int64 ``[S, n]`` holding uint32
    words, byte ``i`` of word ``s`` the plane-``s`` digit (int8) of element
    ``i``; returns the canonical words. Every step is a 32-bit add, shift or
    logic op whose byte lanes never carry into each other:

    * offset binary ``q = p + 128 = 16h + l``; with the carry ``c`` biased as
      ``cb = c + 9`` (in [0, 18]), ``wb = l + cb + 15`` (in [15, 48]) is
      ``(p + c + 8) - 16(h - 9)``, so the digit's ``x = d + 8`` is ``wb & 15``
      and the next ``cb`` is ``h + (wb >> 4)``;
    * the digit bytes are kept as ``z = x + 0x78``, which ``^ 0x80`` turns
      into the int8 digit;
    * below ``-canonical_limit`` (whose digits are all ``-7``): the sign of
      ``sum (d_s + 7)·16^s``, a borrow chain ``lb`` in {0, 1} over ``x_s -
      1`` (``z + lb - 0x6A``, in [14, 30]); ``lb = 0`` at the end is below;
    * the rails (+7 or -7 in every digit) are chosen per byte by masks.
    """
    S = w.shape[0]
    ones, lo = 0x01010101, 0x0F0F0F0F
    cb = torch.full_like(w[0], 9 * ones)
    lb = torch.full_like(w[0], ones)
    z = []
    for s in range(S):
        h = ((w[s] >> 4) ^ (8 * ones)) & lo
        wb = ((w[s] & lo) + cb + 15 * ones) & MASK32
        zs = ((wb & lo) + 0x78787878) & MASK32
        cb = (h + ((wb >> 4) & lo)) & MASK32
        lb = (((zs + lb - 0x6A6A6A6A) & MASK32) >> 4) & ones
        z.append(zs)
    pos = (cb + 0x76767676) & 0x80808080  # carry > 0
    nonneg = (cb + 0x77777777) & 0x80808080  # carry >= 0
    neg = (~nonneg & 0x80808080) | (((lb ^ ones) << 7) & ~pos & 0x80808080)
    posf, negf = (pos >> 7) * 0xFF, (neg >> 7) * 0xFF
    rail = posf | negf
    q = (0x80808080 & ~rail) | (0x07070707 & posf) | (0xF9F9F9F9 & negf)
    return torch.stack([((zs & ~rail) ^ q) & MASK32 for zs in z])


def to_words(planes: torch.Tensor) -> torch.Tensor:
    """int8 [S, 4n] -> int64 [S, n] uint32 words, little-endian bytes."""
    b = planes.reshape(planes.shape[0], -1, 4).to(torch.int64) & 0xFF
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def from_words(w: torch.Tensor) -> torch.Tensor:
    """int64 [S, n] uint32 words -> int8 [S, 4n]."""
    b = torch.stack([(w >> (8 * i)) & 0xFF for i in range(4)], dim=-1)
    return torch.where(b >= 128, b - 256, b).to(torch.int8).reshape(w.shape[0], -1)


def crs_split(planes: torch.Tensor, spec: SliceSpec, addr: int = 0, grid: int = 3) -> tuple[torch.Tensor, list]:
    """The kernel's walk of one block, in plain torch: planes int8 ``[S, M,
    N]`` whose storage starts at byte address ``addr`` -> (canonical planes,
    the walk). The head and the tail run ``crs`` element by element (the
    kernel's per-element routine); the bulk runs ``crs_words`` on each
    chunk, chunk by chunk in the order ``grid`` persistent blocks take them.
    The walk lists ``(kind, first element, elements)`` in that order, so a
    test can check that every element is resolved once."""
    S = planes.shape[0]
    flat = planes.reshape(S, -1).clone()
    mn = flat.shape[1]
    head, nbulk = split(mn, addr)
    walk = []

    def one_by_one(lo, hi):
        if hi > lo:
            flat[:, lo:hi] = crs(flat[:, lo:hi], spec)
            walk.append(("element", lo, hi - lo))

    one_by_one(0, head)
    for chunks in chunk_order(nbulk, grid):
        for c in chunks:
            lo = head + c * CHUNK
            hi = min(lo + CHUNK, head + nbulk)
            flat[:, lo:hi] = from_words(crs_words(to_words(flat[:, lo:hi])))
            walk.append(("bulk", lo, hi - lo))
    one_by_one(head + nbulk, mn)
    return flat.reshape(planes.shape), walk
