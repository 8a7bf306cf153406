"""Every architecture on a mesh on the CPU: one world of four gloo
processes (``tests/torch_mesh_worlds.py``, no JAX in the workers) runs one
adc9 step of each SMOKE config (f32) on the (1, 4) mesh under
``coverage_rules`` and ``default_rules`` (the MoE banks' expert stacks
over 'model', the conv taps, the recurrent and shared leaves, MLA), and of
each arch without MoE blocks on the (2, 2) mesh under ``coverage_rules``
(the depthwise conv's read on a data shard: its DAC range global); rank 0
the same step on one process from the same state. The loss within
``1e-3 · (1 + |loss|)``, the weights within ``1e-5 · max|w|`` (SMOKE's
contractions are under two crossbar tiles, so no adc9 read splits its
contraction).

Where reads do split their contraction (gemma-2b's SMOKE config 512 wide
on the (2, 2) mesh, ideal and adc9, two steps), each mesh step against the
single-process step from the same state whose reads fold their tiles'
partials at the same rank boundary (``distributed.fidelity.FoldCtx``),
with the same tolerances: the fold's f32 order is all that sets the mesh
read apart from the single-device one.

And (``W._mesh_extras``):

* the MoE archs train on the (4, 1) mesh where each rank's tokens are one
  whole dispatch group (4 x 16 tokens, the group cut from the model's 1024
  to 16 in the workers to keep the world small; phase 21 of
  ``chip_smoke.py`` trains granite at 1024 on the card), ideal-ADC reads,
  against one process:
  the loss and the weights as above, the load-balance term within ``1e-6``
  relative (its two means taken over the data axes);
* on the (2, 2) mesh: the SSM archs' FSDP step, ``conv_w``'s planes sharded over 'data' and
  each rank's block updated at its origin, against one process;
* granite served on groups a rank does not hold whole (capacity factor
  1.0, so experts overflow): the logits within ``1e-5`` of max of one
  process's and its tokens equal, where each rank's rows dispatched alone
  are ``1e-3`` or more apart (the fault the gather repairs);
* the MoE (4, 1) step and an FSDP step of the SMOKE arch on the (2, 2)
  mesh under ``remat="full"`` (the default: the recompute gathers each
  layer's blocks again and re-runs the DAC range's and the aux term's
  all-reduces) bit for bit with ``"none"`` from the same state;
* the dry run's SMOKE train cell on the logical (2, 2) mesh
  (``launch.dryrun``, meta tensors) counts the same collectives, kind by
  kind, count and bytes, as the live world stepping that cell.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import torch_mesh_worlds as W  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

MOE_ARCHS = ("granite_moe_1b_a400m", "deepseek_v2_lite_16b")
DENSE_ARCHS = tuple(a for a in configs.ARCH_IDS if a not in MOE_ARCHS)
CASES = [((1, 4), rules, a) for rules in ("coverage", "default") for a in configs.ARCH_IDS] + \
    [((2, 2), "coverage", a) for a in DENSE_ARCHS]
FOLD_PRESETS = ("ideal", "adc9")
WORLD_TIMEOUT = 300


@pytest.fixture(scope="module")
def world():
    cases = [((1, 4), "coverage", list(configs.ARCH_IDS)), ((1, 4), "default", list(configs.ARCH_IDS)),
             ((2, 2), "coverage", list(DENSE_ARCHS))]
    return M.spawn(W.arch_world, 4, args=(cases, FOLD_PRESETS, True), timeout=WORLD_TIMEOUT)[0]


@pytest.mark.parametrize("shape,rules,arch", CASES)
def test_every_arch_steps_on_a_mesh_like_one_process(world, shape, rules, arch):
    loss, one, rel = world[(shape, rules, arch)]
    assert abs(loss - one) <= 1e-3 * (1 + abs(one))
    assert rel <= 1e-5


@pytest.mark.parametrize("preset", FOLD_PRESETS)
def test_contraction_split_steps_equal_the_folded_single_process_steps(world, preset):
    split, steps = world[("fold", preset)]
    assert split > 0
    for loss, one, rel in steps:
        assert abs(loss - one) <= 1e-3 * (1 + abs(one))
        assert rel <= 1e-5


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_trains_on_whole_dispatch_groups_like_one_process(world, arch):
    loss, one, aux, aux_one, rel = world[("moe", arch)]
    assert abs(loss - one) <= 1e-3 * (1 + abs(one))
    assert abs(aux - aux_one) <= 1e-6 * abs(aux_one)
    assert rel <= 1e-5


@pytest.mark.parametrize("arch", ["xlstm_125m", "zamba2_1p2b"])
def test_conv_tap_blocks_under_fsdp_step_like_one_process(world, arch):
    loss, one, rel = world[("conv_fsdp", arch)]
    assert abs(loss - one) <= 1e-3 * (1 + abs(one))
    assert rel <= 1e-5


@pytest.mark.parametrize("case", [("moe", "granite_moe_1b_a400m"), ("moe", "deepseek_v2_lite_16b"),
                                  ("fsdp", W.SMOKE)])
def test_remat_full_steps_the_mesh_like_none(world, case):
    assert world[("remat", *case)] is True


def test_moe_serves_split_dispatch_groups_like_one_process(world):
    rel, tokens_equal, alone = world[("moe_serve",)]
    assert rel <= 1e-5 and tokens_equal
    assert alone >= 1e-3


def test_dry_run_counts_the_live_world_s_collectives(world):
    from repro_torch.launch import dryrun as D

    g, live = world["dry_tally"]
    rec = D.run_cell(W.SMOKE, "train", "2x2", cfg=configs.get_smoke(W.SMOKE), shape=W.DRY_SHAPE,
                     mesh=M.logical_mesh((2, 2), ("data", "model")))
    assert rec["microbatches"] == g
    assert rec["collectives"] == live and live["total_bytes"] > 0
