"""Fig 9's ``run()`` configuration at its full 400 steps against the JAX
package (``tests/torch_paper_mlp_runs.py`` holds the tolerances)."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from torch_paper_mlp_runs import RUN_RTOL, _jax_panther, _jax_sgd, _jax_task  # noqa: E402

from repro.core import SliceSpec as JSpec  # noqa: E402
from repro.optim import PantherConfig as JPC  # noqa: E402
from repro_torch.benchmarks import fig9_slice_crs as TF9  # noqa: E402


def test_fig9_run_configuration_matches_jax():
    """``run()``'s 4-bit, CRS-64 row at its full 400 steps: the float-SGD
    loss and the configuration's loss relative to it."""
    pj, bj = _jax_task(0)
    ref_j = _jax_sgd(pj, bj, 400, 0.03)
    loss_j = _jax_panther(pj, bj, JPC(spec=JSpec.uniform(4), crs_every=64, stochastic_round=False), 400, 0.03)
    pt, bt = TF9._task(0, torch.device("cpu"))
    ref_t, _ = TF9.sgd_reference(pt, bt, 400, 0.03)
    loss_t, *_ = TF9.train_config(pt, bt, 4, 64, 400, 0.03)
    assert abs(ref_t - ref_j) <= RUN_RTOL * ref_j, (ref_t, ref_j)
    assert abs(loss_t - loss_j) <= RUN_RTOL * loss_j, (loss_t, loss_j)
    assert abs(loss_t / ref_t - loss_j / ref_j) <= 2 * RUN_RTOL * loss_j / ref_j
