"""The port's reads and writes on a mesh, in one world of four gloo
processes on the CPU (``tests/torch_mesh_worlds.py``, no JAX in the
workers), on the (data, model) meshes 2x2, 1x4 and 4x1:

* ``mvm_sliced_sharded`` (K5's and K4's plain versions on each rank's tile
  block, contraction partials through ``tile_psum``, output shards
  all-gathered) at shard_dim None, 0 and 1, forward and MᵀVM, against the
  single-process read of the rank's token rows: bit for bit at
  ``adc_bits=None`` on integer inputs, within ``READ_RTOL`` of max|read| at
  adc9, on float inputs with the global DAC exponent, and with read noise
  (the reference's tolerances, ``tests/test_distributed.py``);
* ``tile_psum`` exact and ``compressed_psum`` within ``PSUM_TOL`` of the
  f32 sum;
* K1's and K2's plain versions on each rank's block of a stacked leaf at its
  origin, and K3's on the block, bit for bit against the same block of the
  whole-leaf update under the counter, grid and hw draws, ideal and with
  the device physics.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import torch_mesh_worlds as W  # noqa: E402

from repro_torch.launch import mesh as M  # noqa: E402

SHAPES = ((2, 2), (1, 4), (4, 1))
READ_RTOL = 1e-6
PSUM_TOL = 2e-3
WORLD_TIMEOUT = 240


@pytest.fixture(scope="module")
def world():
    """The four ranks' results on each mesh shape, the world started once."""
    return M.spawn(W.reads_world, 4, args=(list(SHAPES),), timeout=WORLD_TIMEOUT)[0]


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_read_matches_single_process(world, shape):
    for rank in world[shape]:
        exact, close = rank["reads"]
        assert exact == 0.0
        assert close <= READ_RTOL


@pytest.mark.parametrize("shape", SHAPES)
def test_tile_psum_exact_and_compressed_psum_close(world, shape):
    for rank in world[shape]:
        exact, err = rank["collectives"]
        assert exact
        assert err <= PSUM_TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_update_blocks_at_their_origin_equal_the_whole_leaf(world, shape):
    for rank in world[shape]:
        cases, bad = rank["blocks"]
        assert cases == 11 and bad == 0
