"""The device sweep's noisy rows (``dev_wn4e6``, ``dev_wn4e6_tt``) tracked
against the JAX package step by step (``tests/torch_paper_mlp_runs.py``
holds the tolerances, and why a final loss cannot be held there); run as a
script it prints the rows' spread over noise keys:
``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_paper_mlp_noisy_rows.py [sigma ...]``."""
from __future__ import annotations

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_paper_mlp_runs import (JF9, NOISE_LSB, NOISE_SHARE, TRACK_RTOL, TRACK_STEPS, _dev_plan_j,  # noqa: E402
                                 _jax_panther, _jax_task, _plane_values, _t)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import PantherConfig as JPC  # noqa: E402
from repro.optim import panther as jpan  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch.benchmarks import fig9_slice_crs as TF9  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.optim import PantherConfig as TPC  # noqa: E402
from repro_torch.optim import panther as tpan  # noqa: E402


@pytest.mark.parametrize("rule", ["sgd", "tiki-taka"])
def test_device_sweep_noisy_rows_track_jax(rule):
    """``dev_wn4e6`` (SGD) and ``dev_wn4e6_tt``: from the same converted
    start, per-step losses within TRACK_RTOL for TRACK_STEPS steps, the
    first step's flips counted; both runs finite at 300 steps; the
    reference's own final loss moves by more than 5% under a one-ulp
    nudge of one input element (module docstring)."""
    pj, bj = _jax_task(7)
    cfg = JPC(stochastic_round=False, crs_every=1 << 20)
    tcfg = TPC(stochastic_round=False, crs_every=1 << 20)
    if rule == "tiki-taka":
        cfg, tcfg = jpan.tiki_taka(cfg), tpan.tiki_taka(tcfg)
    plan_j = _dev_plan_j(cfg, 4e6, pj)
    losses_j = []
    final_j = _jax_panther(pj, bj, cfg, 300, 0.03, plan=plan_j, rng=jax.random.PRNGKey(11), losses=losses_j)
    pt0 = {k: _t(v) for k, v in pj.items()}
    bt = tuple(_t(a) for a in bj)
    dev = tcommon.DeviceModel(write_noise=4e6, asym_up=1.2, asym_down=0.8)
    plan_t = tplan.resolve_plan(pt0, tplan.default_rules(tcfg, fidelity=tcommon.FidelityConfig(device=dev)))
    st = tpan.init(pt0, tcfg, plan=plan_t)
    pt = tpan.materialize(pt0, st, tcfg)
    sj0 = jpan.init(pj, cfg, plan=plan_j)
    track = []
    for i in range(300):
        pt, st = tpan.update(TF9._grad(pt, bt), st, pt, 0.03, tcfg, rng=prng.PRNGKey(11), plan=plan_t)
        if i == 0:  # one-LSB flips of the write noise's ulps, counted
            pj1, sj1 = jpan.update(jax.grad(JF9._loss)(jpan.materialize(pj, sj0, cfg), bj), sj0,
                                   jpan.materialize(pj, sj0, cfg), jnp.float32(0.03), cfg,
                                   rng=jax.random.PRNGKey(11), plan=plan_j)
            for k in ("w0", "w1", "w2"):
                d = np.abs(_plane_values(sj1.sliced[k].planes) - _plane_values(st.sliced[k].planes))
                print(f"step 1, {k}: {int((d > 0).sum())} of {d.size} elements off, by at most {int(d.max())} LSB")
                assert d.max() <= NOISE_LSB and (d > 0).mean() <= NOISE_SHARE, (k, int(d.max()), (d > 0).mean())
        if i < TRACK_STEPS:
            lt = float(TF9._loss(pt, bt))
            track.append(abs(lt - losses_j[i]) / losses_j[i])
            assert track[-1] <= TRACK_RTOL, (i, lt, losses_j[i])
    final_t = float(TF9._loss(pt, bt))
    assert np.isfinite(final_t) and np.isfinite(final_j)
    nudged = _jax_panther(pj, _jax_task(7, nudge=True)[1], cfg, 300, 0.03, plan=plan_j,
                          rng=jax.random.PRNGKey(11))
    print(f"{rule} at 4e6: losses of the first {TRACK_STEPS} steps within {max(track):.1e} relative; final: "
          f"reference {final_j:.5f}, one ulp nudged {nudged:.5f}, port {final_t:.5f}")
    assert abs(nudged - final_j) > 0.05 * final_j


def _spread(sigma, keys):
    """The reference's and the port's final losses at write noise ``sigma``
    over noise keys ``keys``, both rules, and the reference's under a
    one-ulp nudge of one input element and of one weight."""
    pj, bj = _jax_task(7)
    pt, bt = TF9._task(7, torch.device("cpu"))
    w0 = np.array(pj["w0"])
    w0.view(np.int32).reshape(-1)[0] += 1
    pj_nudged = {**pj, "w0": jnp.asarray(w0)}
    for rule in ("sgd", "tiki-taka"):
        cfg = JPC(stochastic_round=False, crs_every=1 << 20)
        tcfg = TPC(stochastic_round=False, crs_every=1 << 20)
        if rule == "tiki-taka":
            cfg, tcfg = jpan.tiki_taka(cfg), tpan.tiki_taka(tcfg)
        plan_j = _dev_plan_j(cfg, sigma, pj)
        dev = tcommon.DeviceModel(write_noise=sigma, asym_up=1.2, asym_down=0.8)
        plan_t = tplan.resolve_plan(pt, tplan.default_rules(tcfg, fidelity=tcommon.FidelityConfig(device=dev)))
        run_j = lambda p, b, k: _jax_panther(p, b, cfg, 300, 0.03, plan=plan_j,  # noqa: E731
                                            rng=jax.random.PRNGKey(k))

        def run_t(k):
            st = tpan.init(pt, tcfg, plan=plan_t)
            p = tpan.materialize(pt, st, tcfg)
            for _ in range(300):
                p, st = tpan.update(TF9._grad(p, bt), st, p, 0.03, tcfg, rng=prng.PRNGKey(k), plan=plan_t)
            return float(TF9._loss(p, bt))

        print(f"write noise {sigma:g}, {rule}: reference {run_j(pj, bj, 11):.5f}, input nudged one ulp "
              f"{run_j(pj, _jax_task(7, nudge=True)[1], 11):.5f}, w0 nudged one ulp {run_j(pj_nudged, bj, 11):.5f}",
              flush=True)
        for name, finals in (("reference", [run_j(pj, bj, k) for k in keys]), ("port", [run_t(k) for k in keys])):
            print(f"  {name} over keys {keys[0]}-{keys[-1]}: median {np.median(finals):.4f}, min "
                  f"{min(finals):.4f}, max {max(finals):.4f}; " + " ".join(f"{v:.4f}" for v in finals), flush=True)


if __name__ == "__main__":
    # the spread of the noisy device-sweep rows (module docstring), printed:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_paper_mlp_noisy_rows.py [sigma ...]
    for s in [float(a) for a in sys.argv[1:]] or [4e6, 1e7]:
        _spread(s, list(range(11, 43)))
