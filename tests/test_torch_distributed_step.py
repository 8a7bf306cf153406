"""The mesh train step, its checkpoints and the launcher on the CPU: one
2x2 world of gloo processes (``tests/torch_mesh_worlds.py``, no JAX in the
workers) against the single-process port, which the earlier slices hold
against the reference.

gemma-2b's SMOKE config in f32 (the reference's mesh test runs f32 too:
bf16 gradients summed over data shards round apart), from the seed-0 state,
two steps, with ideal-ADC and adc9 reads, plain and FSDP:

* losses within ``1e-3 · (1 + |loss|)`` of the single-process run at step 1
  and ``5e-3 ·`` at step 2 (the reference's tolerances);
* the weights after step 1, and after every mesh step against the
  single-process step from the same state, within ``1e-5 · max|w|`` of the
  model (the port's tolerance for sums in another order). Two runs apart
  drift further by step 2: the reads' DAC and ADC are discontinuous in their
  input, so an f32 reassociation of an activation can flip a code;
* a checkpoint saved on the mesh resumed on one process, and the other way
  round, equal bit for bit to the same steps with the state carried in
  memory;
* ``launch.train --mesh debug --smoke --device cpu --steps 2``, which spawns
  its own 2x2 world; the backend rule; a world that outlives its timeout is
  killed.
"""
from __future__ import annotations

import math
import time

import pytest

torch = pytest.importorskip("torch")

import torch_mesh_worlds as W  # noqa: E402

from repro_torch.launch import mesh as M  # noqa: E402

VARIANTS = (("ideal", "ideal", False), ("ideal_fsdp", "ideal", True), ("adc9", "adc9", False),
            ("adc9_fsdp", "adc9", True))
LOSS_TOL = (1e-3, 5e-3)
WEIGHT_TOL = 1e-5
WORLD_TIMEOUT = 240


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("mesh_ckpt"))
    return M.spawn(W.step_world, 4, args=((2, 2), list(VARIANTS), directory), timeout=WORLD_TIMEOUT)[0]


@pytest.mark.parametrize("variant", [v[0] for v in VARIANTS])
def test_mesh_step_losses_track_the_single_process_step(world, variant):
    r = world["steps"][variant]
    for k, tol in enumerate(LOSS_TOL):
        assert abs(r["mesh_loss"][k] - r["single_loss"][k]) <= tol * (1 + abs(r["single_loss"][k]))
        assert abs(r["mesh_loss"][k] - r["same_loss"][k]) <= LOSS_TOL[0] * (1 + abs(r["same_loss"][k]))
        assert math.isfinite(r["mesh_gnorm"][k])
        assert abs(r["mesh_gnorm"][k] - r["single_gnorm"][k]) <= tol * r["single_gnorm"][k]


@pytest.mark.parametrize("variant", [v[0] for v in VARIANTS])
def test_mesh_step_weights_equal_the_single_process_step(world, variant):
    r = world["steps"][variant]
    assert r["free_rel"][0] <= WEIGHT_TOL
    assert all(x <= WEIGHT_TOL for x in r["same_rel"])


@pytest.mark.parametrize("direction", ["mesh_to_one", "one_to_mesh"])
def test_checkpoint_resumes_across_meshes(world, direction):
    got = world["ckpt"][direction]
    assert all(got) if isinstance(got, list) else got


def test_launcher_trains_on_the_debug_mesh():
    from repro_torch.launch import train

    hist = train.main(["--mesh", "debug", "--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
                       "--seq", "8", "--log-every", "1", "--fidelity", "adc9"])
    assert len(hist) == 2 and all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist)


def test_backend_rule():
    assert M.backend_for("cpu", 4)[0] == "gloo"
    if not torch.cuda.is_available():
        assert M.backend_for("cuda", 4) == ("gloo", "4 ranks share 0 card(s)")
    mesh = M.single_mesh("cpu")
    assert mesh.live and mesh.group(("data", "model")) is None and mesh.index(("data", "model")) == 0


def test_a_world_past_its_timeout_is_killed():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        M.spawn(W.sleeper, 2, timeout=3.0)
    assert time.monotonic() - t0 < 60


def test_fidelity_context_reaches_other_threads():
    """Autograd runs a CUDA backward on a thread of its own: the mesh
    context of the reads (``distributed.fidelity``) is the process's."""
    import threading

    from repro_torch.distributed import fidelity as dist_fid

    ctx = dist_fid.ShardCtx(mesh=M.single_mesh("cpu"))
    seen = []
    with dist_fid.use_sharded_fidelity(ctx):
        t = threading.Thread(target=lambda: seen.append(dist_fid.active()))
        t.start()
        t.join()
    assert seen == [ctx] and dist_fid.active() is None
