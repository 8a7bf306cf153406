"""The streamed OPA of ``repro_torch.core.opa`` (``opa_stream``,
``opa_stream_batch``, ``outer_product_int``): the two stream properties of
``tests/test_core_properties.py`` on the port, and each function against
the reference's on the same numpy inputs. Integer arithmetic throughout, so
every comparison is bit for bit, the int32 outer product's wrap on overflow
included."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
from hypothesis import assume, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import SliceSpec as JSpec  # noqa: E402
from repro.core import opa as J  # noqa: E402
from repro.core import slice_weights as jslice  # noqa: E402
from repro_torch.core import opa as T  # noqa: E402
from repro_torch.core.slicing import SliceSpec, slice_weights, unslice_weights  # noqa: E402

SPECS = ["88888888", "44466555", "66666666", "33344455"]


def _stream_never_clips(planes0, x, a, spec) -> bool:
    """|plane| at any point of the stream <= |start digit| + the sum of the
    deposits' magnitudes (a final state inside the caps does not show that
    no cycle clipped)."""
    P = np.abs(planes0.numpy().astype(np.int64))
    for xb, ab in zip(x.numpy().astype(np.int64), a.numpy().astype(np.int64)):
        mx, ma = np.abs(xb), np.abs(ab)
        for t in range(15):
            bt, v = (mx >> t) & 1, ma << t
            for s in range(spec.n_slices):
                P[s] += bt[:, None] * ((v >> (4 * s)) & 15)[None, :]
    return bool((P < np.asarray(spec.plane_max).reshape(spec.n_slices, 1, 1)).all())


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 4), st.integers(1, 4), st.integers(1, 3), st.integers(0, 2**31 - 1))
def test_stream_equals_batched_value_when_headroom(m, n, b, seed):
    """Streaming per-example OPA deposits the exact product (value-wise)
    while no plane saturates, so it matches the batched digit deposit of the
    summed outer product (paper §3.1, Fig 3)."""
    spec = SliceSpec.uniform(8)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-(2**10), 2**10, size=(b, m)).astype(np.int32))
    a = torch.from_numpy(rng.integers(-(2**10), 2**10, size=(b, n)).astype(np.int32))
    planes = slice_weights(torch.from_numpy(rng.integers(-(2**20), 2**20, size=(m, n)).astype(np.int32)), spec)
    assume(_stream_never_clips(planes, x, a, spec))
    streamed = T.opa_stream_batch(planes, x, a, spec)
    batched = T.opa_batched(planes, T.outer_product_int(x, a), spec)
    caps = torch.tensor(spec.plane_max).reshape(-1, 1, 1)
    assume(bool((batched.to(torch.int32).abs() < caps).all()))
    assert torch.equal(unslice_weights(streamed, spec), unslice_weights(batched, spec))


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_stream_opa_exact_product(seed):
    spec = SliceSpec.uniform(8)
    rng = np.random.default_rng(seed)
    m, n = int(rng.integers(1, 6)), int(rng.integers(1, 6))
    x = torch.from_numpy(rng.integers(-(2**14), 2**14, size=(m,)).astype(np.int32))
    a = torch.from_numpy(rng.integers(-(2**14), 2**14, size=(n,)).astype(np.int32))
    planes = slice_weights(torch.zeros((m, n), dtype=torch.int32), spec)
    assume(_stream_never_clips(planes, x[None], a[None], spec))
    val = unslice_weights(T.opa_stream(planes, x, a, spec), spec).numpy().astype(np.int64)
    assert np.array_equal(val, x.numpy().astype(np.int64)[:, None] * a.numpy().astype(np.int64)[None, :])


@pytest.mark.parametrize("name", SPECS)
@pytest.mark.parametrize("io_bits", [16, 8])
def test_stream_forms_equal_the_reference(name, io_bits):
    """On planes and inputs that saturate planes mid-stream: every cycle's
    clip in the same place."""
    bits = tuple(int(c) for c in name)
    rng = np.random.default_rng(len(name) * io_bits + sum(bits))
    lim = 2 ** (io_bits - 1)
    x = rng.integers(-lim + 1, lim, size=(5, 7)).astype(np.int32)
    a = rng.integers(-lim + 1, lim, size=(5, 6)).astype(np.int32)
    q = rng.integers(-(2**28), 2**28, size=(7, 6)).astype(np.int32)
    jp = jslice(jnp.asarray(q), JSpec(bits))
    tp = slice_weights(torch.from_numpy(q), SliceSpec(bits))
    assert np.array_equal(np.asarray(jp), tp.numpy())
    want = np.asarray(J.opa_stream(jp, jnp.asarray(x[0]), jnp.asarray(a[0]), JSpec(bits), io_bits))
    got = T.opa_stream(tp, torch.from_numpy(x[0]), torch.from_numpy(a[0]), SliceSpec(bits), io_bits)
    assert np.array_equal(want, got.numpy())
    want = np.asarray(J.opa_stream_batch(jp, jnp.asarray(x), jnp.asarray(a), JSpec(bits), io_bits))
    got = T.opa_stream_batch(tp, torch.from_numpy(x), torch.from_numpy(a), SliceSpec(bits), io_bits)
    assert np.array_equal(want, got.numpy())
    assert bool((got != tp).any())


@pytest.mark.parametrize("scale", [2**10, 2**31 - 1])
def test_outer_product_int_equals_the_reference_and_wraps(scale):
    """The int32 sum of the reference, wrapping where |x·a| summed over the
    batch passes 2^31 (``scale`` 2^31 - 1: every product overflows)."""
    rng = np.random.default_rng(scale % 1000)
    x = rng.integers(-scale, scale, size=(9, 5), dtype=np.int64).astype(np.int32)
    a = rng.integers(-scale, scale, size=(9, 4), dtype=np.int64).astype(np.int32)
    want = np.asarray(J.outer_product_int(jnp.asarray(x), jnp.asarray(a)))
    got = T.outer_product_int(torch.from_numpy(x), torch.from_numpy(a))
    assert got.dtype == torch.int32 and np.array_equal(want, got.numpy())
    exact = x.astype(np.int64).T @ a.astype(np.int64)
    assert np.array_equal(got.numpy(), exact.astype(np.int32)) and ((exact != got.numpy()).any() == (scale > 2**20))
