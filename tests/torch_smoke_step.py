"""One lossless SMOKE train step of the port against the JAX package's, from
the same state and batch: shared by the per-family test files
(``test_torch_gemma2.py``, ``test_torch_mla.py``).

Tolerances: the loss and the gradient norm within ``LOSS_RTOL`` relative;
every mapped leaf within ``1 + 2^-15 · max|update|`` grid LSB of the
reference's (f32 weight gradients summed in another order); digital leaves
within ``DIGITAL_RTOL``.
"""
from __future__ import annotations

import numpy as np
import torch

import jax

from repro import plan as jplan
from repro.data import SyntheticLMDataset as JData
from repro.models import common as jcommon
from repro.optim import PantherConfig as JPC
from repro.optim import panther as jpan
from repro.optim import schedules as jsched
from repro.train import step as jstep
from repro_torch import convert
from repro_torch import plan as tplan
from repro_torch import tree
from repro_torch.data import SyntheticLMDataset as TData
from repro_torch.models import common as tcommon
from repro_torch.optim import PantherConfig as TPC
from repro_torch.optim import schedules as tsched
from repro_torch.train import step as tstep

LOSS_RTOL, DIGITAL_RTOL = 1e-5, 1e-4
LR = 5e-2
RULES = {"coverage": (jplan.coverage_rules, tplan.coverage_rules),
         "default": (jplan.default_rules, tplan.default_rules)}


def plane_values(planes) -> np.ndarray:
    """The integer each cell's digit planes hold (radix 16, slice 0 low)."""
    p = (planes.detach().numpy() if isinstance(planes, torch.Tensor) else np.asarray(planes)).astype(np.int64)
    acc = p[-1]
    for s in range(p.shape[0] - 2, -1, -1):
        acc = acc * 16 + p[s]
    return acc


def check_smoke_step(cfg_j, cfg_t, rules: str, batch: int, seq: int) -> set:
    """Run one step of each package under ``rules`` and hold them together.
    Returns the set of operand ``group`` kinds of the port's plan."""
    rj, rt = RULES[rules]
    start = jstep.train_state_init(cfg_j, JPC(crs_every=2), jax.random.PRNGKey(0))
    step_j = jax.jit(jstep.make_train_step(cfg_j, JPC(crs_every=2), jsched.constant(LR), plan_rules=rj(JPC())))
    step_t = tstep.make_train_step(cfg_t, TPC(crs_every=2), tsched.constant(LR), plan_rules=rt(TPC()), remat="none")
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    st = convert.train_state_from_jax(0, np_tree(start.digital), np_tree(start.sliced), start.rng, device="cpu")
    start_v = {tcommon.path_str(p): plane_values(s.planes) for p, s in tree.leaves_with_path(st.sliced)
               if s is not None}
    groups = {pl.group for _, pl in tree.leaves_with_path(tplan.resolve_plan(
        tstep.param_shapes(st.digital, st.sliced), rt(TPC())))}
    sj, mj = step_j(start, JData(cfg_j.vocab, seq, batch).batch(0))
    st, mt = step_t(st, TData(cfg_t.vocab, seq, batch, device="cpu").batch(0))
    for k in ("loss", "grad_norm"):
        assert abs(float(mt[k]) - float(mj[k])) <= LOSS_RTOL * abs(float(mj[k])), k
    want = {jcommon.path_str(p): s for p, s in jax.tree_util.tree_flatten_with_path(
        sj.sliced, is_leaf=lambda x: isinstance(x, jpan.SlicedTensor))[0]}
    for path, s in tree.leaves_with_path(st.sliced):
        if s is None:
            continue
        path = tcommon.path_str(path)
        vj, vt = plane_values(want[path].planes), plane_values(s.planes)
        assert np.abs(vj - vt).max() <= 1 + np.abs(vj - start_v[path]).max() * 2.0**-15, path
    want_d = {jcommon.path_str(p): v for p, v in jax.tree_util.tree_flatten_with_path(sj.digital)[0]}
    for path, d in tree.leaves_with_path(st.digital):
        if d is not None:
            np.testing.assert_allclose(d.detach().numpy(), np.asarray(want_d[tcommon.path_str(path)]),
                                       rtol=DIGITAL_RTOL, atol=1e-7)
    return groups
