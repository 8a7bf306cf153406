"""Serving on a mesh on the CPU: one 1x2 world of gloo processes
(``tests/torch_mesh_worlds.py``, no JAX in the workers), gemma-2b's SMOKE
config in f32 from seed 0, against the single-process port:

* prefill and three decode steps (``serve.step`` on the mesh): on the
  lossless tree logits equal bit for bit, and through the adc9 reads on
  each rank's tile blocks (``fidelity_params(mesh=)``) too;
* ``Engine(mesh=)`` over a 3-request trace: on the lossless tree every
  request's tokens equal solo serving, with each shape's cost calibrated on
  every rank and rank 0's broadcast (every rank's clock equal); on the adc9
  tree the tokens equal the one-process engine's on the same costs;
* ``Engine(mesh=)`` on the 1x1 mesh of this process: tokens equal solo.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import torch_mesh_worlds as W  # noqa: E402

from repro_torch.launch import mesh as M  # noqa: E402

WORLD_TIMEOUT = 240


@pytest.fixture(scope="module")
def world():
    return M.spawn(W.serve_world, 2, args=((1, 2),), timeout=WORLD_TIMEOUT)[0]


@pytest.mark.parametrize("tree_", ["lossless", "adc9"])
def test_prefill_and_decode_on_the_mesh_equal_one_process(world, tree_):
    assert world[tree_]["max_rel"] == 0.0 and world[tree_]["tokens_equal"]


def test_engine_on_the_mesh_serves_solo_tokens(world):
    assert world["engine_lossless"]["equal_solo"]
    assert len(set(world["clocks"])) == 1


def test_engine_on_the_mesh_reads_like_one_process(world):
    assert world["engine_adc9"]["equal_one"]


def test_engine_on_a_one_process_mesh_serves_solo_tokens():
    from repro_torch.serve import scheduler as sch
    from repro_torch.serve import trace as tr

    mesh = M.single_mesh("cpu")
    cfg, params, _, served = W.serving_setup(mesh)
    got, _ = W.engine_tokens(cfg, params, mesh, sch.IsaClock(1e-3, W.ENGINE_GRID["n_slots"]))
    assert all(got[r.rid] == W.solo_tokens(cfg, params, r.tokens, r.out_len)
               for r in tr.synth_trace(vocab=cfg.vocab, **W.SERVE_TRACE))
    got_adc9, _ = W.engine_tokens(cfg, served, mesh, sch.IsaClock(1e-3, W.ENGINE_GRID["n_slots"]))
    assert got_adc9.keys() == got.keys()
