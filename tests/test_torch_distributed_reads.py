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


@pytest.mark.parametrize("mode", ["counter", "rint", "grid", "device"])
def test_conv_tap_block_update_at_its_origin_is_the_leaf_s_block(mode):
    """The im2col update's plain version (``ref.opa_im2col_ref`` through
    ``ops.opa_im2col_update``) on blocks of a stacked conv-tap leaf [2, 4,
    12] at their origins (``kernels.common.Origin``): channel halves as
    FSDP cuts C at data 16 or 32, tap halves as it cuts K=4 at data 2, and
    a corner; each equals the same block of the whole leaf's update bit for
    bit, under the counter and grid draws, half to even, and the device's
    write physics (noise, asymmetry, stuck cells). The card's entry and its
    hw draw: ``tests/test_torch_cuda.py``."""
    from repro_torch.core import prng
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.common import Origin
    from repro_torch.kernels.sliced_opa import ops as OO
    from repro_torch.models.common import DeviceModel

    spec, K, C, T = DEFAULT_SPEC, 4, 12, 9
    g = torch.Generator().manual_seed(0)
    planes = torch.stack([torch.randint(-m, m + 1, (2, K, C), generator=g).to(torch.int8) for m in spec.plane_max])
    x = torch.randn((2, C, T, K), generator=g)
    dh = torch.randn((2, C, T, 1), generator=g) * 1e-2
    dev = DeviceModel(write_noise=4e6, asym_up=1.2, stuck_frac=0.1, stuck_seed=3) if mode == "device" else None
    kw = dict(stochastic=mode != "rint", key=prng.PRNGKey(3), rng_mode="grid" if mode == "grid" else "counter",
              device=dev)
    whole = OO.opa_im2col_update(planes.clone(), x, dh, 3e-2, 20, spec, **kw)
    for k0, k1, c0, c1 in ((0, 4, 0, 6), (0, 4, 6, 12), (0, 2, 0, 12), (2, 4, 0, 12), (2, 4, 6, 12)):
        got = OO.opa_im2col_update(planes[:, :, k0:k1, c0:c1].clone(), x[:, c0:c1, :, k0:k1], dh[:, c0:c1], 3e-2,
                                   20, spec, **kw, origin=Origin(k0, c0, K, C))
        assert torch.equal(got, whole[:, :, k0:k1, c0:c1]), (k0, c0)
