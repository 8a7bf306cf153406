"""Plan-compiled energy bench: the paper's headline claims re-derived from
the schedules the engine actually runs (counterpart of
``benchmarks/isa_energy.py``: the same record, field for field).

Everything here is analytic and deterministic — no training, no timing,
no tensor allocated: the model's shapes come from ``lm.param_shapes`` (or a
plain ``ShapeDtype`` tree), the plan is resolved over them, compiled with
``repro_torch.isa.plan_compile`` and the packed per-leaf schedules are
priced under PANTHER and its baselines (``simulate_plan``). Sections of the
record:

* ``configs`` — PANTHER-vs-digital (``vs_digital``, §7.3 band 7.01-8.02x at
  SGD) and PANTHER-vs-serial-write (``vs_serial_write``, band 31.03-54.21x
  at SGD, amortizing toward ~1.2-2.2x at minibatch) for the paper MLP and a
  transformer config, each at an SGD (tokens=1) and a minibatch token count;
* ``hetero`` — the fig10 heterogeneous plan (uniform-6/adc9 group +
  44466555/adc6 group) vs the homogeneous adc9 plan over the same model:
  the plan edit shows up as a joules delta;
* ``tiki_taka`` — the same model compiled with the ``tiki_taka`` rule: the
  digital momentum buffer's read-modify-write traffic, per leaf;
* ``io_points`` — per-tile packed MVM cost along the fig10 ``io_bits`` axis;
* ``per_leaf`` — the transformer's joules/step table.

``--smoke`` shrinks the transformer to the smoke config. The record is
written as JSON only to ``--json PATH``; without it nothing is written.

    PYTHONPATH=src python -m repro_torch.benchmarks.isa_energy [--smoke] [--json PATH]
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.isa import plan_compile as pc
from repro_torch.isa.energy import DEFAULT_ENERGY, PAPER_BITS
from repro_torch.models.common import ShapeDtype
from repro_torch.optim import PantherConfig, tiki_taka
from repro_torch.plan import PlanRule, default_rules, resolve_plan

from .common import emit

# the §7.3 calibration constants the record pins
ANCHORS = {"e_mvm_reram": 35.10, "e_opa_reram": 11.37, "e_opa_cmos": 37.28}


def _mlp_shapes():
    """The paper's MLP-L4 (Table 4) as a param tree of shapes."""
    dims = [(1024, 256), (256, 512), (512, 512), (512, 10)]
    return {f"dense{i + 1}": {"w": ShapeDtype(d, torch.float32)} for i, d in enumerate(dims)}


def _transformer(opt_cfg, smoke: bool):
    """(cfg, shapes, plan) for the transformer config: the smoke model, or a
    CPU-sized 4-layer model for the full record (shapes only)."""
    from repro_torch import configs
    from repro_torch.models import lm

    cfg = configs.get_smoke("gemma_2b")
    if not smoke:
        cfg = dataclasses.replace(cfg, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32, d_ff=1024, vocab=2048,
                                  n_layers=4, pattern=(("dense", 4),))
    shapes = lm.param_shapes(cfg)
    return cfg, shapes, resolve_plan(shapes, default_rules(opt_cfg))


def _config_record(shapes, plan, token_points, opt_cfg=None) -> dict:
    mapped, digital = pc.capture_leaves(shapes, plan)
    rec = {
        "n_leaves_mapped": len(mapped),
        "n_leaves_digital": len(digital),
        "n_tiles": sum(lm.n_tiles for lm in mapped),
        "tokens": {},
    }
    for tokens in token_points:
        prog = pc.compile_plan(shapes, plan, tokens=tokens, opt_cfg=opt_cfg)
        rec["tokens"][str(tokens)] = pc.systems_summary(prog)
    return rec


def _hetero_record(opt_cfg) -> dict:
    """fig10's heterogeneous plan vs the homogeneous adc9 plan, same model:
    the measurable energy delta of a three-line rule edit."""
    from repro_torch.models import lm
    from repro_torch.models.common import FidelityConfig

    from .fig10_hetero import _hetero_rules, hetero_smoke_config

    shapes = lm.param_shapes(hetero_smoke_config())
    homo = resolve_plan(shapes, default_rules(opt_cfg, fidelity=FidelityConfig(adc_bits_fwd=9, adc_bits_bwd=9)))
    hetero = resolve_plan(shapes, _hetero_rules(opt_cfg))
    tokens = 256
    e_homo = pc.report(pc.compile_plan(shapes, homo, tokens=tokens))["total_nj"]
    e_het = pc.report(pc.compile_plan(shapes, hetero, tokens=tokens))["total_nj"]
    return {
        "tokens": tokens,
        "homogeneous_adc9_nj": e_homo,
        "hetero_nj": e_het,
        "delta_frac": (e_het - e_homo) / e_homo,
    }


def _tiki_record(shapes, plan, tokens: int) -> dict:
    """The tiki_taka rule's extra write traffic, per leaf: the digital
    momentum buffer read-modify-write joules that plain SGD doesn't pay."""
    plain_cfg = PantherConfig(stochastic_round=False)
    tt_cfg = tiki_taka(plain_cfg)
    plain = pc.report(pc.compile_plan(shapes, plan, tokens=tokens, opt_cfg=plain_cfg))
    tt = pc.report(pc.compile_plan(shapes, plan, tokens=tokens, opt_cfg=tt_cfg))
    per_leaf_extra = {}
    for leaf, cats in tt["per_leaf_nj"].items():
        base = plain["per_leaf_nj"].get(leaf, {})
        extra = sum(cats.get(c, 0.0) - base.get(c, 0.0) for c in ("mem", "vfu"))
        if extra > 0:
            per_leaf_extra[leaf] = extra
    return {
        "tokens": tokens,
        "beta": tt_cfg.momentum,
        "plain_nj": plain["total_nj"],
        "tiki_taka_nj": tt["total_nj"],
        "extra_mem_nj": tt["total_nj"] - plain["total_nj"],
        "per_leaf_extra_nj": per_leaf_extra,
    }


def energy_record(smoke: bool = False) -> dict:
    """The whole record, as the reference's bench builds it."""
    em = DEFAULT_ENERGY
    opt_cfg = PantherConfig(stochastic_round=False)

    mlp_shapes = _mlp_shapes()
    # the paper MLP trains fully on the analog path: every layer mapped,
    # operand-grad, lossless ADC (the §6.3-taxed anchor pricing)
    mlp_plan = resolve_plan(mlp_shapes, (PlanRule("*", mapped=True, grad="operand"),))
    tcfg, t_shapes, t_plan = _transformer(opt_cfg, smoke)
    return {
        "_meta": {
            "smoke": smoke,
            "anchors": dict(ANCHORS),
            "adc_tax": em.adc_tax_panther,
            "variant": "v2",
            "transformer_arch": tcfg.arch_id,
            "note": ("analytic + deterministic: eval-shaped models, plan-compiled packed schedules priced by "
                     "repro.isa.simulator.simulate_plan"),
        },
        "configs": {
            "mlp": _config_record(mlp_shapes, mlp_plan, (1, 64), opt_cfg),
            "transformer": _config_record(t_shapes, t_plan, (1, 256), opt_cfg),
        },
        "hetero": _hetero_record(opt_cfg),
        "tiki_taka": _tiki_record(t_shapes, t_plan, 256),
        "io_points": {
            str(io): dict(zip(("mvm_tile_nj", "mvm_tile_ns"), em.mvm_packed(PAPER_BITS, io, 9))) for io in (8, 12, 16)
        },
        "per_leaf": pc.report(pc.compile_plan(t_shapes, t_plan, tokens=256, opt_cfg=opt_cfg))["per_leaf_nj"],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="the smoke transformer instead of the 4-layer one")
    ap.add_argument("--json", default=None, help="write the record here (nothing is written without it)")
    args = ap.parse_args(argv)
    record = energy_record(args.smoke)
    for name, cfg_rec in record["configs"].items():
        for tokens, row in cfg_rec["tokens"].items():
            emit(f"energy/{name}/t{tokens}", 0.0,
                 f"vs_digital={row['vs_digital']:.2f};vs_serial_write={row['vs_serial_write']:.2f};"
                 f"panther_nj={row['panther_nj']:.1f}")
    emit("energy/hetero", 0.0, f"delta_frac={record['hetero']['delta_frac']:.4f}")
    emit("energy/tiki_taka", 0.0, f"extra_mem_nj={record['tiki_taka']['extra_mem_nj']:.1f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1, sort_keys=True)
        emit("energy/json", 0.0, f"wrote={args.json}")
    return record


if __name__ == "__main__":
    main()
