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
read apart from the single-device one."""
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
    return M.spawn(W.arch_world, 4, args=(cases, FOLD_PRESETS), timeout=WORLD_TIMEOUT)[0]


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
