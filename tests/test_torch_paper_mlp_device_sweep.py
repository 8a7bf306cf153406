"""The device sweep's anchor rows (``dev_wn0``, ``dev_ideal``) at their full
300 steps against the JAX package (``tests/torch_paper_mlp_runs.py`` holds
the tolerances)."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from torch_paper_mlp_runs import RUN_RTOL, _dev_plan_j, _jax_panther, _jax_task  # noqa: E402

import jax  # noqa: E402

from repro.optim import PantherConfig as JPC  # noqa: E402
from repro_torch.benchmarks import fig9_slice_crs as TF9  # noqa: E402


def test_device_sweep_anchor_rows_match_jax():
    """``dev_wn0`` at its full 300 steps within RUN_RTOL of the reference;
    ``dev_ideal`` equal to it bit for bit, in the port as in the
    reference."""
    pj, bj = _jax_task(7)
    plain = JPC(stochastic_round=False, crs_every=1 << 20)
    want = _jax_panther(pj, bj, plain, 300, 0.03, plan=_dev_plan_j(plain, 0, pj), rng=jax.random.PRNGKey(11))
    task = TF9._task(7, torch.device("cpu"))
    wn0, _ = TF9.device_row(0, "sgd", 300, task=task)
    ideal, _ = TF9.device_row(None, "sgd", 300, task=task)
    assert ideal == wn0
    assert abs(wn0 - want) <= RUN_RTOL * want, (wn0, want)
