"""The port's update numerics against ``repro``: the threefry key chain, the
counter hash, stochastic quantize, the digit arithmetic (saturating add,
product digits, CRS) and the plain versions of the three update kernels
(``opa_deposit``, ``opa_fused``, ``crs``), the last held against the
reference's Pallas kernels run in interpret mode (``use_kernel=True,
interpret=True``). Inputs are made with numpy from a seed and passed to both.

Tolerance: none — every check here is bit for bit. ``opa_fused`` is held on
f32-exact operands (small integers on a power-of-two grid), where every
contraction order gives the same f32 sums; elsewhere the reference's own
kernel depends on its blocking.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fixed_point as JF  # noqa: E402
from repro.core import opa as JO  # noqa: E402
from repro.core import slicing as JS  # noqa: E402
from repro.kernels.crs import ops as jcrs  # noqa: E402
from repro.kernels.sliced_opa import kernel as jopa_k  # noqa: E402
from repro.kernels.sliced_opa import ops as jopa  # noqa: E402
from repro_torch.core import fixed_point as TF  # noqa: E402
from repro_torch.core import opa as TO  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import slicing as TS  # noqa: E402
from repro_torch.kernels import crs as tcrs  # noqa: E402
from repro_torch.kernels import sliced_opa as topa  # noqa: E402
from repro_torch.kernels.sliced_opa import ref as topa_ref  # noqa: E402

SPEC = TS.DEFAULT_SPEC
JSPEC = JS.DEFAULT_SPEC


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(a, b):
    a, b = np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert np.array_equal(a, b), int((a != b).sum())


def _key_words(key) -> tuple:
    return tuple(int(w) for w in np.asarray(key, dtype=np.uint32))


# ------------------------------- key chain ----------------------------------


@pytest.mark.parametrize("seed", [0, 7, 11, 2**31 + 5, 2**32 - 1])
def test_threefry_shim_matches_jax(seed):
    rng = np.random.default_rng(seed % 1000)
    datas = [0, 1, 2, 17, 2**31 - 1, 2**31, 2**32 - 1, *rng.integers(0, 2**32, 24).tolist()]
    key_j, key_t = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert _key_words(key_j) == key_t
    for d in datas:
        kj = jax.random.fold_in(key_j, np.uint32(d))
        kt = prng.fold_in(key_t, d)
        assert _key_words(kj) == kt
        assert tuple(int(v) for v in np.asarray(JF.counter_key_scalars(kj))) == prng.counter_key_scalars(kt)
    # the update's chain: fold_in(fold_in(PRNGKey(7), step), leaf), then layer
    chain_j = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(7), 3), 4), 2)
    chain_t = prng.fold_in(prng.fold_in(prng.fold_in(prng.PRNGKey(7), 3), 4), 2)
    assert _key_words(chain_j) == chain_t


# ------------------------------ counter hash ---------------------------------


def test_counter_u01_bit_identical_over_coordinates_and_keys():
    rng = np.random.default_rng(0)
    r = rng.integers(0, 2**31 - 1, (64, 1), dtype=np.int32)
    c = rng.integers(0, 2**31 - 1, (1, 96), dtype=np.int32)
    for k0, k1 in [(0, 0), (-1, 1), (2**31 - 1, -(2**31)), (123456789, -987654321)]:
        want = JF.counter_u01(jnp.asarray(r), jnp.asarray(c), jnp.int32(k0), jnp.int32(k1))
        got = TF.counter_u01(_t(r), _t(c), k0, k1)
        _eq(want, got)
        assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


@pytest.mark.parametrize("shape", [(5, 7), (3, 40, 24), (2, 3, 8, 5), (9,), (1, 130)])
def test_counter_uniform_bit_identical_including_stacks(shape):
    key_j = jax.random.PRNGKey(5)
    _eq(JF.counter_uniform(key_j, shape), TF.counter_uniform(prng.PRNGKey(5), shape))
    _eq(JF.rounding_noise(key_j, shape, "counter"), TF.rounding_noise(prng.PRNGKey(5), shape, "counter"))


def test_rounding_noise_other_modes_raise():
    # "grid" is ported (jax.random.uniform's stream); "hw", and any other
    # mode, raises ValueError as the reference's rounding_noise does
    _eq(JF.rounding_noise(jax.random.PRNGKey(0), (4, 4), "grid"), TF.rounding_noise(prng.PRNGKey(0), (4, 4), "grid"))
    for mode in ("hw", "other"):
        with pytest.raises(ValueError):
            JF.rounding_noise(jax.random.PRNGKey(0), (4, 4), mode)
        with pytest.raises(ValueError):
            TF.rounding_noise(prng.PRNGKey(0), (4, 4), mode)


@pytest.mark.parametrize("stacked", [False, True])
def test_stochastic_quantize_bit_identical(stacked):
    rng = np.random.default_rng(3)
    shape = (3, 24, 40) if stacked else (24, 40)
    x = (rng.normal(size=shape) * 1e-4).astype(np.float32)
    x.flat[:6] = [0.0, 1e30, -1e30, 2.5 * 2**-20, -2.5 * 2**-20, 3.0 * 2**-21]  # saturation, exact halves
    for f in (20, 31):
        want = JF.quantize(jnp.asarray(x), f, stochastic=True, key=jax.random.PRNGKey(9))
        got = TF.quantize(_t(x), f, stochastic=True, key=prng.PRNGKey(9))
        _eq(want, got)
        _eq(JF.quantize(jnp.asarray(x), f), TF.quantize(_t(x), f))
    with pytest.raises(ValueError):
        TF.quantize(_t(x), 20, stochastic=True)


def test_stochastic_rounding_is_unbiased():
    x = torch.full((64, 64), 0.3711)
    draws = torch.stack([TF.quantize(x, 4, stochastic=True, key=prng.PRNGKey(k)) for k in range(20)])
    assert abs(float(draws.float().mean()) - 0.3711 * 16) < 4.0 / np.sqrt(draws.numel())


# ----------------------------- digit arithmetic ------------------------------


def _dirty_planes(rng, shape, spec=SPEC):
    """Planes over each plane's whole range: saturated cells, MSB carries
    and vectors below -canonical_limit all occur."""
    return np.stack([rng.integers(-m, m + 1, shape) for m in spec.plane_max]).astype(np.int8)


def _rail_updates(rng, shape, lim=SPEC.canonical_limit):
    kind = rng.integers(0, 4, shape)
    near = rng.integers(-1000, 1001, shape)
    full = rng.integers(-(2**31), 2**31, shape)
    out = np.where(kind == 0, near * 4, np.where(kind == 1, lim + near, np.where(kind == 2, near - lim, full)))
    return out.astype(np.int32)


def test_saturating_add_product_digits_and_opa_batched_bit_identical():
    rng = np.random.default_rng(1)
    planes = _dirty_planes(rng, (33, 47))
    p = _rail_updates(rng, (33, 47))
    _eq(JS.product_digits(jnp.asarray(p), JSPEC), TS.product_digits(_t(p), SPEC))
    delta = rng.integers(-40, 41, (8, 33, 47)).astype(np.int32)
    _eq(JS.saturating_add(jnp.asarray(planes), jnp.asarray(delta), JSPEC),
        TS.saturating_add(_t(planes), _t(delta), SPEC))
    _eq(JO.opa_batched(jnp.asarray(planes), jnp.asarray(p), JSPEC), TO.opa_batched(_t(planes), _t(p), SPEC))
    want = np.asarray(JS.saturation_fraction(jnp.asarray(planes), JSPEC))
    got = TS.saturation_fraction(_t(planes), SPEC).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got.min() > 0  # every plane has saturated cells


def test_crs_bit_identical_with_every_rail_hit():
    rng = np.random.default_rng(2)
    planes = _dirty_planes(rng, (64, 80))
    want = np.asarray(JS.crs(jnp.asarray(planes), JSPEC))
    got = TS.crs(_t(planes), SPEC)
    _eq(want, got)
    pos = np.asarray(JS.slice_weights(jnp.int32(SPEC.canonical_limit), JSPEC))
    neg = np.asarray(JS.slice_weights(jnp.int32(-SPEC.canonical_limit), JSPEC))
    railed_pos = (want == pos[:, None, None]).all(0).mean()
    railed_neg = (want == neg[:, None, None]).all(0).mean()
    assert railed_pos > 0 and railed_neg > 0 and railed_pos + railed_neg < 1


# ------------------------- kernels' plain versions ---------------------------


def test_crs_plain_version_matches_the_reference_kernel():
    rng = np.random.default_rng(4)
    planes = _dirty_planes(rng, (128, 384))
    want = jcrs.crs(jnp.asarray(planes), JSPEC, use_kernel=True, interpret=True)
    pt = _t(planes)
    out = tcrs.crs(pt, SPEC)
    assert out is pt  # in place
    _eq(want, pt)


def test_opa_deposit_plain_version_matches_the_reference_kernel():
    rng = np.random.default_rng(5)
    planes = _dirty_planes(rng, (128, 384))
    p = _rail_updates(rng, (128, 384))
    want = jopa.opa_deposit(jnp.asarray(planes), jnp.asarray(p), JSPEC, use_kernel=True, interpret=True)
    pt = _t(planes)
    topa.opa_deposit(pt, _t(p), SPEC)
    _eq(want, pt)


def _exact_operands(rng, t, m, n):
    x = (rng.integers(-4, 5, (t, m)) * 0.125).astype(np.float32)
    dh = (rng.integers(-4, 5, (t, n)) * 2.0**-5).astype(np.float32)
    return x, dh


@pytest.mark.parametrize("t,lr,f,keyed", [(1, 2.0**-4, 8, True), (100, 2.0**-4, 8, True),
                                          (100, 2.0**-4, 8, False), (256, 4.0, 28, True)])
def test_opa_fused_plain_version_matches_the_reference_kernel(t, lr, f, keyed):
    rng = np.random.default_rng(t)
    m, n = 128, 256
    planes = _dirty_planes(rng, (m, n))
    x, dh = _exact_operands(rng, t, m, n)
    key = jax.random.PRNGKey(t + 1)
    scale = -jnp.float32(lr) * JF.exp2i(f)
    rkey = JF.counter_key_scalars(key) if keyed else None
    want = jopa_k.opa_fused(jnp.asarray(planes), jnp.asarray(x), jnp.asarray(dh), scale, spec=JSPEC,
                            interpret=True, rkey=rkey)
    words = prng.counter_key_scalars(prng.PRNGKey(t + 1)) if keyed else None
    _eq(want, topa_ref.opa_fused_ref(_t(planes), _t(x), _t(dh), lr, f, SPEC, words))
    pt = _t(planes)
    topa.opa_fused(pt, _t(x), _t(dh), lr, f, SPEC, key_words=words)
    _eq(want, pt)
    # bf16 operands widen exactly, so the same numbers come out
    _eq(want, topa_ref.opa_fused_ref(_t(planes), _t(x).bfloat16(), _t(dh).bfloat16(), lr, f, SPEC, words))


def test_opa_fused_update_stacked_leaf_per_layer_keys():
    rng = np.random.default_rng(6)
    L, t, m, n = 3, 64, 128, 128
    q = rng.integers(-(2**27), 2**27, (L, m, n)).astype(np.int32)
    planes = np.asarray(JS.slice_weights(jnp.asarray(q), JSPEC))  # [S, L, M, N]
    x, dh = _exact_operands(rng, L * t, m, n)
    x, dh = x.reshape(L, t, m), dh.reshape(L, t, n)
    lr, f = 2.0**-3, 20
    key = jax.random.PRNGKey(11)
    want = jopa.opa_fused_update(jnp.asarray(planes), jnp.asarray(x), jnp.asarray(dh), jnp.float32(lr), f, JSPEC,
                                 stochastic=True, key=key, use_kernel=True, interpret=True)
    # the port's layout: layer-major storage viewed [S, L, M, N]
    store = _t(np.ascontiguousarray(np.moveaxis(planes, 0, 1)))
    pt = store.movedim(1, 0)
    topa.opa_fused_update(pt, _t(x), _t(dh), lr, f, SPEC, stochastic=True, key=prng.PRNGKey(11))
    _eq(want, pt)
    # and the dense pipeline (quantize + deposit) draws the same bits
    _eq(want, topa_ref.opa_fused_update_ref(_t(planes), _t(x), _t(dh), lr, f, SPEC,
                                            stochastic=True, key=prng.PRNGKey(11)))
    # one layer's draw is fold_in(key, l): layer 1 alone
    one = topa_ref.opa_fused_ref(_t(planes[:, 1]), _t(x[1]), _t(dh[1]), lr, f, SPEC,
                                 prng.counter_key_scalars(prng.fold_in(prng.PRNGKey(11), 1)))
    _eq(np.asarray(want)[:, 1], one)


def test_opa_fused_update_refuses_what_is_not_ported():
    from repro_torch.models.common import DeviceModel

    planes = torch.zeros((8, 16, 16), dtype=torch.int8)
    x, dh = torch.zeros((4, 16)), torch.zeros((4, 16))
    # write noise draws under the key, also with deterministic rounding
    with pytest.raises(ValueError, match="key"):
        topa.opa_fused_update(planes, x, dh, 0.1, 20, SPEC, device=DeviceModel(write_noise=0.5))
    # "hw" is the kernel's own draw: CPU planes refuse it, as the reference's CPU path does
    with pytest.raises(ValueError, match="hw"):
        topa.opa_fused_update(planes, x, dh, 0.1, 20, SPEC, stochastic=True, key=(0, 1), rng_mode="hw")
    with pytest.raises(ValueError, match="key"):
        topa.opa_fused_update(planes, x, dh, 0.1, 20, SPEC, stochastic=True)
    # an all-ideal device model is the ideal update
    topa.opa_fused_update(planes, x, dh, 0.1, 20, SPEC, device=DeviceModel())


def test_reference_kernel_rounds_its_finalize_once():
    # Why the port is held to the reference's K1 kernel only at power-of-two
    # learning rates: on the CPU, XLA contracts the kernel's `acc * scale`
    # and `+ u` into one FMA, while its jnp oracle, the port's plain version
    # and the CUDA kernel round twice. At lr = 1e-2, F = 30 the product is
    # inexact and the two differ; an FMA model reproduces the kernel.
    rng = np.random.default_rng(0)
    t, m, n = 24, 128, 128
    planes = np.asarray(JS.slice_weights(jnp.asarray(rng.integers(-(2**27), 2**27, (m, n)), jnp.int32), JSPEC))
    x, dh = _exact_operands(rng, t, m, n)
    lr, f = np.float32(1e-2), 30
    scale = np.float32(-lr * np.float32(2.0**f))
    words = prng.counter_key_scalars(prng.PRNGKey(11))
    kernel = np.asarray(jopa_k.opa_fused(jnp.asarray(planes), jnp.asarray(x), jnp.asarray(dh), jnp.float32(scale),
                                         spec=JSPEC, interpret=True, rkey=jnp.asarray(words, jnp.int32)))
    acc = (x.astype(np.float64).T @ dh.astype(np.float64)).astype(np.float32)  # exact
    u = TF.counter_u01(torch.arange(m)[:, None], torch.arange(n)[None, :], *words).numpy()
    fma = np.floor((acc.astype(np.float64) * np.float64(scale) + u).astype(np.float32))
    fma_planes = np.asarray(JO.opa_batched(jnp.asarray(planes), jnp.asarray(fma.astype(np.int32)), JSPEC))
    _eq(kernel, fma_planes)
    port = topa_ref.opa_fused_ref(_t(planes), _t(x), _t(dh), float(lr), f, SPEC, words).numpy()
    assert (port != kernel).sum() > 0
    g = jnp.einsum("tm,tn->mn", jnp.asarray(x), jnp.asarray(dh))
    upd = JF.quantize(-jnp.float32(lr) * g, f, stochastic=True, key=jax.random.PRNGKey(11))
    _eq(JO.opa_batched(jnp.asarray(planes), upd, JSPEC), port)  # the oracle rounds twice, as the port


# ------------------------- K1's body, by operand dtype -------------------------


@pytest.mark.parametrize("dtype,body,ideal,device", [(torch.bfloat16, "mma", "ideal", "device"),
                                                     (torch.float32, "fma", "ideal_fma", "device_fma")])
def test_k1_body_follows_the_operand_dtype(dtype, body, ideal, device):
    # bf16 operands (the training path) take the tensor-core body, f32 ones
    # the CUDA-core body; the instance keys count the launches of each
    from repro_torch.kernels.sliced_opa import kernel as topa_k

    assert topa_k.body_for(dtype) == body
    assert (topa_k.instance_name(False, body), topa_k.instance_name(True, body)) == (ideal, device)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8, torch.int32])
def test_k1_body_refuses_other_dtypes(dtype):
    from repro_torch.kernels.sliced_opa import kernel as topa_k

    with pytest.raises(ValueError, match="float32 or bfloat16"):
        topa_k.body_for(dtype)
