"""The CRS kernel's schedule and arithmetic, mirrored in plain torch
(``repro_torch.kernels.crs.ref``: ``split``, ``chunk_order``, ``crs_words``,
``crs_split``), against the JAX package's ``repro.core.slicing.crs`` and its
Pallas kernel ``repro.kernels.crs.kernel.crs`` run in interpret mode, on the
CPU. The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``).

Tolerance: none. Every comparison is bit for bit (integer digit arithmetic).
Inputs are made with numpy from a seed: planes over each plane's whole
range, over all of int8, and vectors built to hit each rail (a positive
carry out of the MSB, a negative one, and a carry-free vector below
``-canonical_limit``).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import slicing as JS  # noqa: E402
from repro.kernels.crs import kernel as JK  # noqa: E402
from repro_torch.core import slicing as TS  # noqa: E402
from repro_torch.kernels.crs import ref as R  # noqa: E402

NARROW = (4, 4, 4, 4, 4, 4, 4, 4)  # the narrowest slices: plane_max 8
WIDE = (8, 7, 6, 5, 4, 4, 4, 4)  # an 8-bit slice: plane_max 128, the whole int8 range


def _specs(S: int):
    """(JAX spec, port spec) pairs with S slices: the default spec's last S
    widths, the narrow one's and the wide one's."""
    out = []
    for bits in (JS.DEFAULT_SPEC.bits, NARROW, WIDE):
        b = tuple(bits[-S:])
        out.append((JS.SliceSpec(b), TS.SliceSpec(b)))
    return out


def _planes(rng, spec, shape, kind):
    if kind == "range":  # each plane over its whole range [-m, m], clipped to int8
        return np.stack([np.clip(rng.integers(-m, m + 1, shape), -128, 127) for m in spec.plane_max]).astype(np.int8)
    if kind == "int8":
        return rng.integers(-128, 128, (spec.n_slices, *shape)).astype(np.int8)
    # near the rails: digits of +-canonical_limit (+-7) and one past them
    return rng.choice(np.array([-9, -8, -7, -6, 6, 7, 8], np.int8), (spec.n_slices, *shape))


def _jax_crs(planes, spec):
    return np.asarray(JS.crs(jnp.asarray(planes), spec))


def _rail_counts(out, spec):
    """(positive-railed, negative-railed) elements of canonical planes."""
    return (int((out == 7).all(0).sum()), int((out == -7).all(0).sum()))


def test_canonical_limit_digits_are_all_sevens():
    # the kernel's rails are the digit vectors +7 and -7 in every slice
    for S in range(1, 9):
        lim = TS.SliceSpec.uniform(4, S).canonical_limit
        assert TS._digits_of(lim, S) == [7] * S and TS._digits_of(-lim, S) == [-7] * S


@pytest.mark.parametrize("S", [1, 2])
def test_words_match_the_reference_on_every_int8_vector(S):
    # all 256^S digit vectors, 4 a word, through the byte-lane arithmetic
    v = np.arange(-128, 128, dtype=np.int8)
    planes = np.stack([g.reshape(-1) for g in np.meshgrid(*([v] * S), indexing="ij")])
    for jspec, tspec in _specs(S):
        got = R.from_words(R.crs_words(R.to_words(torch.from_numpy(planes))))
        want = _jax_crs(planes, jspec)
        assert np.array_equal(got.numpy(), want)
        pos, neg = _rail_counts(want, jspec)
        assert pos > 0 and neg > 0


@pytest.mark.parametrize("S", range(1, 9))
@pytest.mark.parametrize("kind", ["range", "int8", "rails"])
def test_words_match_the_reference(S, kind):
    rng = np.random.default_rng(10 * S + len(kind))
    for jspec, tspec in _specs(S):
        planes = _planes(rng, jspec, (4096,), kind)
        got = R.from_words(R.crs_words(R.to_words(torch.from_numpy(planes)))).numpy()
        assert np.array_equal(got, _jax_crs(planes, jspec))
        assert np.array_equal(got, TS.crs(torch.from_numpy(planes), tspec).numpy())


def test_every_rail_case_is_hit_and_resolved():
    # a positive carry out of the MSB, a negative one, a carry-free vector
    # just below -canonical_limit, one at it and one just above: built
    # vectors, LSB first
    S = 8
    jspec, tspec = _specs(S)[0]
    vecs = np.array([
        [0, 0, 0, 0, 0, 0, 0, 8],    # 8·16^7 > lim: carry +1 out of the MSB -> +lim
        [0, 0, 0, 0, 0, 0, 0, -9],   # carry -1 -> -lim
        [-8, -7, -7, -7, -7, -7, -7, -7],  # -lim - 1, carry-free -> -lim
        [-7] * 8,                    # -lim: stays
        [-6, -7, -7, -7, -7, -7, -7, -7],  # -lim + 1: stays
        [7] * 8,                     # +lim: stays
        [8, 7, 7, 7, 7, 7, 7, 7],    # +lim + 1: carries out -> +lim
        [3, -2, 0, 0, 0, 0, 0, 0],   # an ordinary value
    ], np.int8).T
    want = _jax_crs(vecs, jspec)
    assert want[:, 0].tolist() == [7] * 8 and want[:, 1].tolist() == [-7] * 8
    assert want[:, 2].tolist() == [-7] * 8 and want[:, 6].tolist() == [7] * 8
    assert want[:, 4].tolist() == vecs[:, 4].tolist() and want[:, 7].tolist() == vecs[:, 7].tolist()
    padded = np.concatenate([vecs, np.zeros((S, 8), np.int8)], axis=1)  # 16 elements: one word group
    got = R.from_words(R.crs_words(R.to_words(torch.from_numpy(padded)))).numpy()[:, :8]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mn,addr", [(4096 * 5 + 48, 0), (4096 * 5 + 48, 3), (4096 * 2, 15), (16, 0), (16, 1),
                                     (33 * 47, 0), (33 * 47, 8), (5, 2), (4096 * 7, 8)])
@pytest.mark.parametrize("grid", [1, 3])
def test_walk_resolves_every_element_once(mn, addr, grid):
    planes = torch.zeros((2, 1, mn), dtype=torch.int8)
    _, walk = R.crs_split(planes, TS.SliceSpec((4, 4)), addr=addr, grid=grid)
    covered = np.zeros(mn, np.int64)
    for kind, lo, n in walk:
        covered[lo:lo + n] += 1
        if kind == "bulk":  # 16-byte aligned in every plane, whole 16-byte groups, at most a chunk
            assert (addr + lo) % 16 == 0 and n % 16 == 0 and 0 < n <= R.CHUNK and mn % 16 == 0
    assert (covered == 1).all()
    head, nbulk = R.split(mn, addr)
    if mn % 16 == 0:
        assert head < 16 and mn - head - nbulk < 16
    else:
        assert (head, nbulk) == (mn, 0) and [k for k, _, _ in walk] == ["element"]
    # the bulk chunks in the order the persistent blocks take them
    assert [lo for k, lo, _ in walk if k == "bulk"] == [head + c * R.CHUNK for b in R.chunk_order(nbulk, grid)
                                                         for c in b]


@pytest.mark.parametrize("S", range(1, 9))
@pytest.mark.parametrize("shape,addr", [((64, 300), 0), ((64, 300), 5), ((33, 47), 0), ((33, 47), 8),
                                        ((3, 32), 15), ((1, 5), 1)])
def test_split_matches_the_reference(S, shape, addr):
    # the head/bulk/tail walk over one block, M·N on and off the 16-element
    # grid, planes at and off a 16-byte boundary
    rng = np.random.default_rng(S * 1000 + shape[0] + addr)
    for (jspec, tspec), kind in zip(_specs(S), ("range", "rails", "int8")):
        planes = _planes(rng, jspec, shape, kind)
        got, _ = R.crs_split(torch.from_numpy(planes), tspec, addr=addr, grid=3)
        assert np.array_equal(got.numpy(), _jax_crs(planes, jspec))


@pytest.mark.parametrize("spec_bits", [JS.DEFAULT_SPEC.bits, NARROW, WIDE])
def test_split_matches_the_reference_kernel_in_interpret_mode(spec_bits):
    rng = np.random.default_rng(len(set(spec_bits)))
    jspec, tspec = JS.SliceSpec(spec_bits), TS.SliceSpec(spec_bits)
    planes = _planes(rng, jspec, (64, 320), "range")
    want = np.asarray(JK.crs(jnp.asarray(planes), spec=jspec, interpret=True))
    got, _ = R.crs_split(torch.from_numpy(planes), tspec, addr=7, grid=2)
    assert np.array_equal(got.numpy(), want)
    pos, neg = _rail_counts(want, jspec)
    assert pos > 0 and neg > 0
