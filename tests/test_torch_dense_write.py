"""The dense-leaf write of the port (``kernels.sliced_opa.opa_dense_update``,
``opa_device_update`` and the optimizer's ``_write_leaf``) on CPU planes,
against the JAX package: the reference's ``quantize`` and ``opa_deposit``
with its Pallas kernel in interpret mode (``use_kernel=True,
interpret=True``), and its ``opa_device_update`` the same way. Inputs are
made with numpy from a seed: f32 and bf16 gradients whose updates fall
between grid points (the draw decides), past the int32 rails, at ±inf and
where ``-lr · g`` is subnormal, on planes whose every digit range occurs;
2-D leaves and ``[L, M, N]`` stacks (per-layer keys, and under ``"grid"``
per-layer offsets). On CPU planes the write runs ``ref.opa_dense_ref`` a
layer block at a time: the plain version ``chip_smoke.py`` holds the CUDA
kernel to.

Tolerances, and why:
* Without write noise: bit for bit (integer digits, the same f32 products
  in the same order, the same draws).
* With write noise (``σ_w = 4`` LSB): ±1 LSB, at most ``FLIPS`` = 2 elements
  a case, the tolerance of ``tests/test_torch_device.py::
  test_opa_device_update_matches_jax_oracle``: ``counter_gauss`` differs by
  up to 3 ulps between XLA's and torch's CPU ``log1p``/``cos``, which moves
  ``σ_w · g`` by less than ``2^-18`` LSB, so an update flips only where its
  analog value lies that close to a rounding boundary.
* Subnormal values: XLA on the CPU flushes them to zero, torch and the card
  keep them. An increment below ``2^-95`` LSB rounds as zero does unless
  its draw is exactly 0 (one in ``2^24``), so the updates are held bit for
  bit; the f32 increments themselves are held to numpy's IEEE arithmetic.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fixed_point as JF  # noqa: E402
from repro.core import slicing as JS  # noqa: E402
from repro.kernels.sliced_opa import ops as jopa  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.optim import PantherConfig as JPC  # noqa: E402
from repro.optim import panther as jpan  # noqa: E402
from repro.plan import default_rules as jrules  # noqa: E402
from repro.plan import resolve_plan as jresolve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import slicing as TS  # noqa: E402
from repro_torch.kernels import sliced_opa as topa  # noqa: E402
from repro_torch.kernels.sliced_opa import kernel as KO  # noqa: E402
from repro_torch.kernels.sliced_opa import ref as topa_ref  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.optim import PantherConfig as TPC  # noqa: E402
from repro_torch.optim import panther as tpan  # noqa: E402

SPEC, JSPEC = TS.DEFAULT_SPEC, JS.DEFAULT_SPEC
FLIPS = 2
DRAWS = {"rint": (False, "counter"), "counter": (True, "counter"), "grid": (True, "grid")}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
PHYSICS = {
    "asym": dict(asym_up=1.2, asym_down=0.8),
    "noise": dict(write_noise=4.0),
    "stuck": dict(stuck_frac=0.02, stuck_seed=3),
    "all": dict(asym_up=1.2, asym_down=0.8, write_noise=4.0, stuck_frac=0.02, stuck_seed=3),
}
MLP_SIZES = (64, 256, 128, 10)  # the paper MLP's three crossbar leaves: 64x256, 256x128, 128x10
LR, F = 1e-2, 20  # an lr off the binary grid: every product rounds


def _t(a):
    return torch.from_numpy(np.array(a))


def _plane_values(planes):
    p = np.asarray(planes).astype(np.int64)
    acc = p[-1]
    for s in range(p.shape[0] - 2, -1, -1):
        acc = acc * 16 + p[s]
    return acc


def _layer_major(planes):
    """Planes [S, *stack, M, N] in the port's layer-major storage."""
    lead = planes.ndim - 3
    return _t(np.ascontiguousarray(np.moveaxis(planes, 0, lead))).movedim(lead, 0)


def _planes(rng, shape):
    """int8 planes [S, *shape], each plane uniform over its whole range:
    saturated digits, carries out of the MSB and values past the canonical
    limit all occur."""
    return np.stack([rng.integers(-m, m + 1, shape) for m in SPEC.plane_max]).astype(np.int8)


def _gradient(rng, shape, dtype):
    """A gradient whose updates (``-LR · g · 2^F``) mostly lie between grid
    points, with a share past the int32 rails, at ±inf and where ``-LR ·
    g`` is subnormal; rounded to ``dtype`` (the JAX and torch arrays hold
    the same values)."""
    g = rng.standard_normal(shape) * 10.0 ** rng.uniform(-6, -2, shape)
    kind = rng.integers(0, 16, shape)
    g = np.where(kind == 0, rng.standard_normal(shape) * 1e9, g)  # past the rails
    g = np.where(kind == 1, rng.standard_normal(shape) * 1e-38, g)  # -lr·g subnormal
    g = np.where(kind == 2, np.sign(rng.standard_normal(shape)) * np.inf, g)
    jdt, tdt = DTYPES[dtype]
    gj = jnp.asarray(g.astype(np.float32)).astype(jdt)
    return gj, _t(gj.astype(jnp.float32)).to(tdt)


def _assert_flips(want, got, allowed):
    d = np.abs(_plane_values(want) - _plane_values(got))
    assert d.max() <= 1 and int((d > 0).sum()) <= allowed, (int(d.max()), int((d > 0).sum()))


@pytest.mark.parametrize("stack", [(), (3,)])
@pytest.mark.parametrize("draw", list(DRAWS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dense_write_matches_quantize_and_the_reference_deposit_kernel(dtype, draw, stack):
    rng = np.random.default_rng(len(stack) * 10 + list(DRAWS).index(draw))
    shape = (*stack, 96, 80) if not stack else (*stack, 40, 24)
    planes = _planes(rng, shape)
    gj, gt = _gradient(rng, shape, dtype)
    stochastic, mode = DRAWS[draw]
    upd = JF.quantize(-jnp.float32(LR) * gj.astype(jnp.float32), F, stochastic=stochastic,
                      key=jax.random.PRNGKey(5), rng_mode=mode)
    want = np.asarray(jopa.opa_deposit(jnp.asarray(planes), upd, JSPEC, use_kernel=True, interpret=True))
    pt = _layer_major(planes)
    before = (KO.opa_dense.launches, KO.opa_deposit.launches)
    out = topa.opa_dense_update(pt, gt, LR, F, SPEC, stochastic=stochastic, key=prng.PRNGKey(5), rng_mode=mode)
    assert out is pt and (KO.opa_dense.launches, KO.opa_deposit.launches) == before  # in place, no launch
    assert np.array_equal(want, pt.numpy())
    assert (want != planes).mean() > 0.1


@pytest.mark.parametrize("draw", list(DRAWS))
@pytest.mark.parametrize("physics", list(PHYSICS))
def test_device_write_matches_the_reference_device_update(physics, draw):
    rng = np.random.default_rng(100 + list(PHYSICS).index(physics) * 3 + list(DRAWS).index(draw))
    jd, td = jcommon.DeviceModel(**PHYSICS[physics]), tcommon.DeviceModel(**PHYSICS[physics])
    allowed = FLIPS if td.write_noise > 0 else 0
    stochastic, mode = DRAWS[draw]
    for dtype in DTYPES:
        for shape in ((64, 48), (2, 40, 24)):
            q = rng.integers(-(2**27), 2**27, shape).astype(np.int32)
            planes = np.asarray(JS.slice_weights(jnp.asarray(q), JSPEC))
            gj, gt = _gradient(rng, shape, dtype)
            want = np.asarray(jopa.opa_device_update(jnp.asarray(planes), gj, jnp.float32(LR), F, JSPEC, device=jd,
                                                     stochastic=stochastic, key=jax.random.PRNGKey(6), rng_mode=mode,
                                                     use_kernel=True, interpret=True))
            pt = _layer_major(planes)
            topa.opa_device_update(pt, gt, LR, F, SPEC, device=td, stochastic=stochastic, key=prng.PRNGKey(6),
                                   rng_mode=mode)
            _assert_flips(want, pt, allowed)
            # the entry point of every dense write
            again = _layer_major(planes)
            topa.opa_dense_update(again, gt, LR, F, SPEC, stochastic=stochastic, key=prng.PRNGKey(6), rng_mode=mode,
                                  device=td)
            assert torch.equal(again, pt)
            if td.stuck_frac > 0:  # stuck digits held
                mask = topa_ref.stuck_mask_ref(td, SPEC, planes.shape).numpy()
                assert np.array_equal(np.where(mask, planes, 0), np.where(mask, pt.numpy(), 0))


def test_the_two_scale_orders_are_the_reference_s_two():
    """The ideal write rounds ``(-lr · g) · 2^F`` (the reference's dense
    path), the device write ``g · (2^F · -lr)`` (its opa_device_update).
    They differ only where ``-lr · g`` is subnormal. XLA on the CPU flushes
    subnormal values to zero, and torch and the card keep them (IEEE), so
    there each order is held to numpy's IEEE f32 arithmetic; on normal
    values both are held to the reference's."""
    rng = np.random.default_rng(7)
    lr, f = 0.3, 31
    g = (rng.standard_normal(4096) * 1e-38).astype(np.float32)  # -lr·g subnormal
    ideal = (np.float32(-lr) * g) * np.float32(2.0**f)
    device = g * (np.float32(2.0**f) * np.float32(-lr))
    assert np.array_equal(ideal.view(np.int32), topa_ref.dense_increment(_t(g), lr, f).numpy().view(np.int32))
    assert np.array_equal(device.view(np.int32), topa_ref.dense_increment(
        _t(g), lr, f, tcommon.DeviceModel(asym_up=1.5)).numpy().view(np.int32))
    assert (ideal != device).any()
    g = (rng.standard_normal(4096) * 1e-3).astype(np.float32)
    ideal = np.asarray((-jnp.float32(lr) * jnp.asarray(g)) * JF.exp2i(f))
    device = np.asarray(jnp.asarray(g) * (-jnp.float32(lr) * JF.exp2i(f)))
    assert np.array_equal(ideal, topa_ref.dense_increment(_t(g), lr, f).numpy())
    assert np.array_equal(device, topa_ref.dense_increment(_t(g), lr, f, tcommon.DeviceModel(asym_up=1.5)).numpy())


def _mlp(seed):
    rng = np.random.default_rng(seed)
    p = {}
    for i, (a, b) in enumerate(zip(MLP_SIZES[:-1], MLP_SIZES[1:])):
        p[f"w{i}"] = (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
        p[f"b{i}"] = (rng.standard_normal(b) * 0.1).astype(np.float32)
    return p


def _grads(seed, params):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32) for k, v in params.items()}


def _configs(draw, **kw):
    stochastic, mode = DRAWS[draw]
    kw.update(stochastic_round=stochastic, rng_mode=mode)
    return JPC(opa_use_kernel=True, opa_interpret=True, **kw), TPC(**kw)


def _plans(params, cj, ct, physics):
    if physics is None:
        return None, None
    jd, td = jcommon.DeviceModel(**PHYSICS[physics]), tcommon.DeviceModel(**PHYSICS[physics])
    plan_j = jresolve(jax.tree.map(jnp.asarray, params),
                      jrules(cj, fidelity=jcommon.FidelityConfig(spec=cj.spec, device=jd)))
    plan_t = tplan.resolve_plan({k: _t(v) for k, v in params.items()},
                                tplan.default_rules(ct, fidelity=tcommon.FidelityConfig(spec=ct.spec, device=td)))
    return plan_j, plan_t


@pytest.mark.parametrize("physics", [None, "asym", "all"])
@pytest.mark.parametrize("draw", list(DRAWS))
def test_mlp_update_split_and_update_write_the_dense_leaves_as_the_reference(draw, physics):
    """The paper MLP's three leaves take dense gradients: ``update_split``
    and ``update`` write them through ``_write_leaf`` (the dense write, K2
    on the card) as the reference writes them through quantize and its
    deposit kernel (or its device update), from the same state."""
    params = _mlp(1)
    cj, ct = _configs(draw, crs_every=1 << 20)
    plan_j, plan_t = _plans(params, cj, ct, physics)
    allowed = FLIPS if physics == "all" else 0
    # update_split: the sliced state carried across, two steps
    pj = jax.tree.map(jnp.asarray, params)
    dj, sj = jpan.init_split(pj, cj, plan=plan_j)
    st = convert.sliced_from_jax(jax.tree.map(np.asarray, sj), device="cpu")
    dt = convert.params_from_jax(jax.tree.map(np.asarray, dj), device="cpu")
    for step in range(2):
        g = _grads(20 + step, params)
        dj, sj = jpan.update_split(jax.tree.map(jnp.asarray, g), dj, sj, step, jnp.float32(0.05), cj,
                                   rng=jax.random.PRNGKey(3), plan=plan_j)
        dt, st = tpan.update_split({k: _t(v) for k, v in g.items()}, dt, st, step, 0.05, ct, rng=prng.PRNGKey(3),
                                   plan=plan_t)
        for k in ("w0", "w1", "w2"):
            _assert_flips(np.asarray(sj[k].planes), st[k].planes.numpy(), allowed)
    # update: from the reference's state, one step
    sj = jpan.init(pj, cj, plan=plan_j)
    state = convert.panther_state_from_jax(jax.tree.map(np.asarray, sj), device="cpu")
    pj = jpan.materialize(pj, sj, cj)
    pt = {k: _t(v) for k, v in pj.items()}
    g = _grads(30, params)
    pj, sj = jpan.update(jax.tree.map(jnp.asarray, g), sj, pj, jnp.float32(0.05), cj, rng=jax.random.PRNGKey(9),
                         plan=plan_j)
    pt, state = tpan.update({k: _t(v) for k, v in g.items()}, state, pt, 0.05, ct, rng=prng.PRNGKey(9),
                            plan=plan_t)
    for k in ("w0", "w1", "w2"):
        _assert_flips(np.asarray(sj.sliced[k].planes), state.sliced[k].planes.numpy(), allowed)
        if not allowed:
            assert np.array_equal(np.asarray(pj[k]), pt[k].numpy()), k
    assert (KO.opa_dense.launches, KO.opa_deposit.launches) == (0, 0)  # CPU planes: the plain versions


def test_dense_write_kernel_refuses_cpu_tensors_and_the_hw_draw():
    planes = torch.zeros((8, 16, 16), dtype=torch.int8)
    g = torch.zeros((16, 16))
    frac = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        KO.opa_dense(planes, g, 0.1, frac, spec=SPEC)
    with pytest.raises(ValueError, match="CUDA"):
        KO.opa_dense(planes, g, 0.1, frac, spec=SPEC, dev=tcommon.DeviceModel(stuck_frac=0.1))
    for device in (None, tcommon.DeviceModel(asym_up=1.2)):
        with pytest.raises(ValueError, match="hw"):
            topa.opa_dense_update(planes, g, 0.1, 12, SPEC, stochastic=True, key=prng.PRNGKey(0), rng_mode="hw",
                                  device=device)
    with pytest.raises(ValueError, match="key"):
        topa.opa_dense_update(planes, g, 0.1, 12, SPEC, stochastic=True)
    assert KO.opa_dense.launches == 0 and not KO.opa_dense.instances


def test_dense_instance_names():
    assert KO.dense_instance(torch.float32, "counter", False) == "f32_counter"
    assert KO.dense_instance(torch.bfloat16, "grid", True) == "bf16_grid_device"
    assert KO.dense_instance(torch.float32, "rint", True) == "f32_rint_device"
