"""Quickstart on the port: train a small MLP with the PANTHER sliced-OPA
optimizer and watch it track float SGD, then inspect slice saturation and
CRS (counterpart of ``examples/quickstart.py``).

A 32-128-64-8 MLP fits a ``TeacherStudentDataset`` batch of 256 at lr 0.05
for 301 steps: the paper's 44466555 slices with counter stochastic
rounding at two CRS periods (1024 and 25), and float SGD beside them. At
this toy scale a rare CRS lets slices saturate and training freezes (the
paper's Fig-9 phenomenon); a frequent CRS resolves the carries.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.slicing import SliceSpec
from repro_torch.data import TeacherStudentDataset
from repro_torch.data.pipeline import fan_in_normal
from repro_torch.device import resolve
from repro_torch.optim import PantherConfig, panther
from repro_torch.optim.baselines import sgd_init, sgd_update

SPEC = SliceSpec((4, 4, 4, 6, 6, 5, 5, 5))
CRS_PERIODS = (1024, 25)
LOG_EVERY = 50


def mlp(key, sizes=(32, 128, 64, 8), device=None) -> dict:
    dev = resolve(device)
    ks = prng.split(key, len(sizes))
    return {f"w{i}": fan_in_normal(ks[i], (a, b), device=dev)
            for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}


def fwd(p, x):
    h = x
    for i in range(len(p)):
        h = h @ p[f"w{i}"]
        if i < len(p) - 1:
            h = torch.relu(h)
    return h


def main(steps: int = 301, device=None) -> dict:
    """Returns ``{"panther": {crs_every: (losses, state, cfg)}, "sgd":
    losses}``, the losses logged every 50 steps."""
    dev = resolve(device)
    ds = TeacherStudentDataset(d_in=32, d_out=8, batch=256, device=dev)
    x, y = ds.batch()

    def loss(p):
        return torch.mean((fwd(p, x) - y) ** 2)

    def grad(p):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        return dict(zip(leaves, torch.autograd.grad(loss(leaves), list(leaves.values()))))

    params = mlp(prng.PRNGKey(0), device=dev)
    lr = 0.05
    runs = {}
    for crs_every in CRS_PERIODS:
        cfg = PantherConfig(spec=SPEC, crs_every=crs_every)
        state = panther.init(params, cfg)
        p_q = panther.materialize(params, state, cfg)
        hist = []
        for i in range(steps):
            p_q, state = panther.update(grad(p_q), state, p_q, lr, cfg)
            if i % LOG_EVERY == 0:
                hist.append(float(loss(p_q)))
        runs[crs_every] = (hist, state, cfg)

    p_f, s_f = dict(params), sgd_init(params)
    hist_f = []
    for i in range(steps):
        p_f, s_f = sgd_update(grad(p_f), s_f, p_f, lr)
        if i % LOG_EVERY == 0:
            hist_f.append(float(loss(p_f)))

    print(f"{'step':>5} {'panther(crs=1024)':>18} {'panther(crs=25)':>16} {'float sgd':>10}")
    for j, i in enumerate(range(0, steps, LOG_EVERY)):
        print(f"{i:5d} {runs[1024][0][j]:18.5f} {runs[25][0][j]:16.5f} {hist_f[j]:10.5f}")
    for crs_every in CRS_PERIODS:
        _, state, cfg = runs[crs_every]
        rep = panther.saturation_report(state, cfg)
        print(f"\ncrs_every={crs_every}: per-plane saturation (w0), LSB->MSB:",
              np.round(rep["w0"].cpu().numpy(), 3))
    planes = runs[25][1].sliced["w0"].planes
    print("\nSaturation froze the rare-CRS run (paper §3.2/Fig 9); the frequent-CRS"
          "\nrun tracks float SGD. PANTHER state is int8 digit planes:",
          planes.dtype, tuple(planes.shape))
    return {"panther": runs, "sgd": hist_f}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    main(device=ap.parse_args().device)
