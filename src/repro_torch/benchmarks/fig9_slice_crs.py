"""Fig 9 on the port: bits per slice × CRS period -> saturation and loss
(counterpart of ``benchmarks/fig9_slice_crs.py``'s ``run``,
``device_sweep`` and the paper claims of its ``main``).

The paper trains VGG16/CIFAR-100; this trains the MLP-L4-shaped
teacher-student task (64-256-128-10, 512 rows) through the PANTHER update
and reports, per (uniform slice bits, CRS period): low- and high-order plane
saturation, the final loss against float SGD, and the loss of the trained
planes read through a 9-bit ADC (the serving-fidelity read). The weights,
teacher and inputs come from the reference's ``jax.random`` keys
(``core.prng``), so both packages start from the same draws (within the
``erfinv`` ulps of ``core.prng.normal``).

``device_sweep`` is the write-noise axis: plain sliced SGD against
Tiki-Taka (``optim.panther.tiki_taka``) on a write-nonideal
``DeviceModel`` at matched noise, plus the anchor pair (an all-ideal
``DeviceModel`` must train bit for bit as no device).

Each function takes ``device=`` (default ``cuda``), prints its rows and
returns them; it writes no file. On the card the three weight leaves run
the deposit kernel (K2) every step, CRS (K3) on CRS steps, the device
write through ``opa_device_update`` in ``device_sweep``, and the adc9 read
through K4. Step times are host-clock times of the training loop's own
steps after a synchronize (the first step left out).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig9_slice_crs [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import plan as planlib
from repro_torch import tree
from repro_torch.core import prng
from repro_torch.core.slicing import SliceSpec
from repro_torch.data.pipeline import fan_in_normal
from repro_torch.device import resolve
from repro_torch.models.common import DeviceModel, FidelityConfig
from repro_torch.optim import PantherConfig, panther
from repro_torch.optim.baselines import sgd_init, sgd_update

SIZES = (64, 256, 128, 10)
ROWS = 512
BITS = (3, 4, 5, 6)
CRS_PERIODS = (64, 1024, 4096)
NOISE_SIGMAS = (1e6, 4e6, 1e7)


def _mlp(key, sizes=SIZES, device=None) -> dict:
    dev = resolve(device)
    ks = prng.split(key, len(sizes))
    p = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        p[f"w{i}"] = fan_in_normal(ks[i], (a, b), device=dev)
        p[f"b{i}"] = torch.zeros((b,), dtype=torch.float32, device=dev)
    return p


def _fwd(p, x, n=3):
    h = x
    for i in range(n):
        h = h @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1:
            h = torch.relu(h)
    return h


def _loss(p, batch) -> torch.Tensor:
    x, y = batch
    return torch.mean((_fwd(p, x) - y) ** 2)


def _grad(p, batch) -> dict:
    """``jax.grad(_loss)(p, batch)``: the gradient tree of the MSE loss."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    gs = torch.autograd.grad(_loss(leaves, batch), list(leaves.values()))
    return dict(zip(leaves, gs))


def _task(seed: int, device):
    """The reference's draws: student init under ``fold_in(key, 1)``, the
    teacher under ``fold_in(key, 2)``, the inputs under ``fold_in(key,
    3)``."""
    key = prng.PRNGKey(seed)
    params0 = _mlp(prng.fold_in(key, 1), device=device)
    teacher = _mlp(prng.fold_in(key, 2), device=device)
    x = prng.normal(prng.fold_in(key, 3), (ROWS, SIZES[0]), device=device)
    with torch.no_grad():
        return params0, (x, _fwd(teacher, x))


def _fwd_fidelity(p, state, cfg: PantherConfig, x, adc_bits, io_bits=16, n=3):
    """The forward through the finite-ADC crossbar read
    (``core.mvm.fidelity_read``, K4 on the card): each mapped matmul reads
    its planes at ``adc_bits``; ``None`` is the ideal ADC."""
    from repro_torch.core.mvm import fidelity_read

    fid = FidelityConfig(io_bits=io_bits, adc_bits_fwd=adc_bits, spec=cfg.spec)
    h = x
    for i in range(n):
        s = state.sliced[f"w{i}"]
        h = h @ p[f"w{i}"] if s is None else fidelity_read(s.planes, s.frac_bits, h, fid)
        h = h + p[f"b{i}"]
        if i < n - 1:
            h = torch.relu(h)
    return h


def fidelity_loss(p, state, cfg: PantherConfig, batch, adc_bits) -> float:
    x, y = batch
    with torch.no_grad():
        return float(torch.mean((_fwd_fidelity(p, state, cfg, x, adc_bits) - y) ** 2))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _train(step_fn, carry, steps: int, device):
    """``steps`` steps of ``carry = step_fn(carry)``; returns the carry and
    the mean host-clock µs of steps 2..steps, timed after a synchronize."""
    carry = step_fn(carry)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        carry = step_fn(carry)
    _sync(device)
    return carry, (time.perf_counter() - t0) * 1e6 / max(steps - 1, 1)


class Fig9Row(NamedTuple):
    """One configuration of ``run``; its first five fields are the
    reference's row tuple."""

    bits: int
    crs_every: int
    sat_lo: float
    sat_hi: float
    loss_vs_sgd: float
    loss_adc9: float
    us_per_step: float


def sgd_reference(params0, batch, steps: int, lr: float):
    """Float SGD on the task: ``(final loss, µs/step)``."""
    def sgd_step(c):
        p, s = c
        return sgd_update(_grad(p, batch), s, p, lr)

    dev = batch[0].device
    (p, _), us = _train(sgd_step, (dict(params0), sgd_init(params0)), steps, dev)
    with torch.no_grad():
        return float(_loss(p, batch)), us


def train_config(params0, batch, bits: int, crs_every: int, steps: int, lr: float):
    """One Fig-9 configuration: uniform ``bits``-bit slices, CRS every
    ``crs_every`` steps, deterministic rounding. Returns ``(final loss,
    state, params, cfg, µs/step)``."""
    cfg = PantherConfig(spec=SliceSpec.uniform(bits), crs_every=crs_every, stochastic_round=False)
    state = panther.init(params0, cfg)
    p = panther.materialize(params0, state, cfg)

    def step(c):
        p, s = c
        return panther.update(_grad(p, batch), s, p, lr, cfg)

    (p, state), us = _train(step, (p, state), steps, batch[0].device)
    with torch.no_grad():
        return float(_loss(p, batch)), state, p, cfg, us


def run(steps: int = 400, lr: float = 0.03, device=None) -> list:
    """The Fig-9 grid: uniform slices of 3-6 bits × CRS every 64, 1024 and
    4096 steps, deterministic rounding, against float SGD on the same
    task."""
    params0, batch = _task(0, resolve(device))
    ref_loss, us_ref = sgd_reference(params0, batch, steps, lr)
    print(f"fig9/float_sgd: {us_ref:.1f} us/step; loss={ref_loss:.6f}")
    rows = []
    for bits in BITS:
        for crs_every in CRS_PERIODS:
            loss, state, p, cfg, us = train_config(params0, batch, bits, crs_every, steps, lr)
            sats = [r.cpu().numpy() for _, r in tree.leaves_sorted(panther.saturation_report(state, cfg))
                    if r is not None]
            lo = float(np.mean([s[0] for s in sats]))  # low-order plane
            hi = float(np.mean([s[-1] for s in sats]))  # high-order plane
            rel = loss / max(ref_loss, 1e-9)
            adc9 = fidelity_loss(p, state, cfg, batch, 9)
            rows.append(Fig9Row(bits, crs_every, lo, hi, rel, adc9, us))
            print(f"fig9/bits{bits}_crs{crs_every}: {us:.1f} us/step; sat_lo={lo:.3f};sat_hi={hi:.3f};"
                  f"loss_vs_sgd={rel:.4f};loss_adc9={adc9:.4f}")
    return rows


def paper_claims(rows) -> dict:
    """The four qualitative checks of the reference's ``main``: 3-bit
    slices worst at every CRS period, 5/6-bit within 2.2× of float SGD at
    CRS every 64, high-order planes saturating no more than low-order ones
    (+0.05), and 3-bit saturating at least as much as 6-bit."""
    by = {(r[0], r[1]): (r[2], r[3], r[4]) for r in rows}
    ok3 = all(by[(3, c)][2] >= by[(5, c)][2] and by[(3, c)][2] >= by[(6, c)][2] for c in CRS_PERIODS)
    ok56 = by[(5, 64)][2] < 2.2 and by[(6, 64)][2] < 2.2
    okhl = all(hi <= lo + 0.05 for lo, hi, _ in by.values())
    oksat = all(by[(3, c)][0] >= by[(6, c)][0] for c in CRS_PERIODS)
    return {"3bit_worst": ok3, "56bit_robust": ok56, "hi_le_lo_saturation": okhl, "sat_monotone": oksat}


def _device_model(sigma):
    """The sweep's device at write noise ``sigma``: None at 0, all-ideal at
    None, else asymmetry 1.2/0.8 with the noise."""
    if sigma is None:
        return DeviceModel()
    return DeviceModel(write_noise=sigma, asym_up=1.2, asym_down=0.8) if sigma > 0 else None


def device_row(sigma: float, rule: str, steps: int = 300, device=None, lr: float = 0.03, task=None):
    """One ``device_sweep`` run: ``sigma`` the write noise in grid LSB (0:
    no device; None: an all-ideal ``DeviceModel``), with asymmetry 1.2/0.8
    when ``sigma > 0``; ``rule`` "sgd" or "tiki-taka". Returns ``(final
    loss, µs/step)``. ``task`` is ``(params0, batch)``, default the
    sweep's (seed 7)."""
    params0, batch = task if task is not None else _task(7, resolve(device))
    plain = PantherConfig(stochastic_round=False, crs_every=1 << 20)
    cfg = panther.tiki_taka(plain) if rule == "tiki-taka" else plain
    dmodel = _device_model(sigma)
    fid = FidelityConfig(spec=cfg.spec, device=dmodel) if dmodel is not None else None
    plan = planlib.resolve_plan(params0, planlib.default_rules(cfg, fidelity=fid))
    state = panther.init(params0, cfg, plan=plan)
    p = panther.materialize(params0, state, cfg)

    def step(c):
        p, s = c
        return panther.update(_grad(p, batch), s, p, lr, cfg, rng=prng.PRNGKey(11), plan=plan)

    (p, _), us = _train(step, (p, state), steps, batch[0].device)
    with torch.no_grad():
        return float(_loss(p, batch)), us


def device_sweep(steps: int = 300, device=None) -> dict:
    """The device-noise axis: ``dev_wn0`` (no device) and ``dev_ideal``
    (an all-ideal ``DeviceModel``, which must match it bit for bit), then at
    write noise 1e6, 4e6 and 1e7 grid LSB with asymmetry 1.2/0.8, plain
    sliced SGD (``dev_wn{s}``) and Tiki-Taka at the same lr
    (``dev_wn{s}_tt``). Rows: ``{tag: {device, rule, steps, lr,
    final_loss, us_per_step}}``."""
    task = _task(7, resolve(device))
    lr = 0.03
    rows = {}

    def record(tag, sigma, rule):
        loss, us = device_row(sigma, rule, steps, lr=lr, task=task)
        dmodel = _device_model(sigma)
        rows[tag] = {"device": None if dmodel is None else dataclasses.asdict(dmodel), "rule": rule,
                     "steps": steps, "lr": lr, "final_loss": loss, "us_per_step": us}
        print(f"fig9/{tag}: {us:.1f} us/step; final_loss={loss:.6f};steps={steps}")

    record("dev_wn0", 0, "sgd")
    record("dev_ideal", None, "sgd")
    for sigma in NOISE_SIGMAS:
        tag = f"dev_wn{sigma:g}".replace("+0", "").replace("+", "")
        record(tag, sigma, "sgd")
        record(tag + "_tt", sigma, "tiki-taka")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    rows = run(device=args.device)
    print("fig9/paper_claims: " + ";".join(f"{k}={v}" for k, v in paper_claims(rows).items()))
    device_sweep(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
