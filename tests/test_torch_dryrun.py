"""The dry run (``launch.dryrun``) and the kernel entries on fake tensors, on
the CPU.

* ``choose_microbatches`` and ``input_specs`` equal the reference's
  (``repro.launch.dryrun``, pure functions: a stub mesh, nothing compiled)
  for every arch x shape cell on the single- and multi-pod meshes: the
  depth, and every input leaf's shape and dtype in flatten order.
* Each kernel entry on meta tensors allocates its outputs, counts the
  launch by instance as a launch is counted, records the kernel's work
  (``kernels.common``'s formulas) and launches nothing: no library is
  built or loaded.
* A SMOKE train, prefill and decode cell runs on meta tensors on one
  device and on the logical (2, 2) mesh (rank 0 of a dry mesh) with no
  library built, and its record has the reference's keys; the train cell
  launches K1 and K2 by instance and moves collectives on the mesh. (That
  the dry mesh counts what a live one moves is held in
  ``tests/test_torch_distributed_archs.py``.)
* The work formulas give ``PERF.md`` section 6's bounds, to the 4 decimals
  the table shows: ``chip_smoke.py`` computes every bound from them.
"""
from __future__ import annotations

import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch import configs, kernels  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.core.slicing import DEFAULT_SPEC  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import common as kc  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module: it sets ``XLA_FLAGS`` when imported,
    which must not reach this process's JAX (already initialized here) or
    its children, so the variable is put back."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun

    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return dryrun


CELLS = [(a, s) for a in configs.ALIASES for s in configs.shape_cells(a)]


def _stub(kind):
    shape = {"data": 16, "model": 16} if kind == "single" else {"pod": 2, "data": 16, "model": 16}
    return types.SimpleNamespace(axis_names=tuple(shape), shape=shape)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_microbatches_and_input_specs_are_the_reference_s(jdry, arch, shape):
    from repro import configs as jconfigs

    cfg, cfg_j = configs.get(arch), jconfigs.get(arch)
    assert configs.shape_cells(arch) == jconfigs.shape_cells(arch)
    spec = configs.SHAPES[shape]
    for kind in ("single", "multi"):
        g = D.choose_microbatches(cfg, M.make_production_mesh(multi_pod=kind == "multi"), spec["global_batch"],
                                  spec["seq_len"])
        assert g == jdry.choose_microbatches(cfg_j, _stub(kind), spec["global_batch"], spec["seq_len"])
        want = [(tuple(leaf.shape), np.dtype(leaf.dtype).name)
                for leaf in jax.tree.leaves(jdry.input_specs(cfg_j, shape, microbatches=g))]
        got = [(tuple(leaf.shape), str(leaf.dtype).removeprefix("torch."))
               for _, leaf in tree.leaves_sorted(D.input_specs(cfg, shape, microbatches=g))]
        assert got == want


@pytest.fixture
def nothing_built(monkeypatch):
    """Building or loading a kernel library raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel library was built or loaded on fake tensors")

    monkeypatch.setattr(kbuild, "build", refuse)
    monkeypatch.setattr("ctypes.CDLL", refuse)
    kernels.reset_launch_counts()
    kc.fake_work.clear()


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _stacked_planes(S, L, M, N):
    """int8 planes ``[S, L, M, N]`` in the port's layer-major storage."""
    return _meta(L, S, M, N, dtype=torch.int8).movedim(1, 0)


def test_kernel_entries_on_meta_tensors_count_and_launch_nothing(nothing_built):
    from repro_torch.kernels.crs import ops as CO
    from repro_torch.kernels.sliced_mvm import ops as MO
    from repro_torch.kernels.sliced_opa import ops as OO
    from repro_torch.models.common import DeviceModel

    spec, S = DEFAULT_SPEC, DEFAULT_SPEC.n_slices
    planes = _meta(S, 256, 96, dtype=torch.int8)
    out = MO.mvm_sliced_fused(planes, _meta(8, 256), 3, spec, adc_bits=9)
    assert out.shape == (8, 96) and out.device.type == "meta"
    assert MO.mvm_sliced_fused(planes, _meta(8, 96), 3, spec, adc_bits=9, transpose=True).shape == (8, 256)
    assert MO.mvm_sliced_fused(planes, _meta(2, 256), 3, spec).shape == (2, 96)  # the decode body
    assert MO.mvm_sliced(planes, _meta(8, 256, dtype=torch.int32), spec, io_bits=8).shape == (8, 96)
    OO.opa_fused_update(planes, _meta(8, 256, dtype=torch.bfloat16), _meta(8, 96, dtype=torch.bfloat16), 1e-2, 20,
                        spec, stochastic=True, key=(0, 1))
    OO.opa_fused_update(planes, _meta(8, 256, dtype=torch.bfloat16), _meta(8, 96, dtype=torch.bfloat16), 1e-2, 20,
                        spec, stochastic=True, key=(0, 1), device=DeviceModel(write_noise=1e6, stuck_frac=0.1))
    OO.opa_dense_update(planes, _meta(256, 96), 1e-2, 20, spec, stochastic=True, key=(0, 1))
    OO.opa_deposit(planes, _meta(256, 96, dtype=torch.int32), spec)
    conv = _stacked_planes(S, 2, 4, 64)
    OO.opa_im2col_update(conv, _meta(2, 64, 8, 4, dtype=torch.bfloat16), _meta(2, 64, 8, 1, dtype=torch.bfloat16),
                         1e-2, 20, spec, stochastic=True, key=(0, 1))
    CO.crs(_stacked_planes(S, 3, 256, 96), spec)
    assert kc.fake_work.launches == {
        "mvm_sliced_fused/io16": 1, "mvm_sliced_fused/transpose_io16": 1, "mvm_sliced_fused/io16_decode": 1,
        "mvm_sliced/io8": 1, "opa_fused/ideal": 1, "opa_fused/device": 1, "opa_dense/f32_counter": 1,
        "opa_deposit/ideal": 1, "opa_im2col/bf16": 2, "crs/crs": 3}
    assert kernels.launch_counts() == {}  # the wrappers count real launches only
    assert kc.fake_work.work["mvm_sliced_fused/io16"] == kc.read_work(8, 256, 96, S, 16)
    assert kc.fake_work.work["mvm_sliced/io8"] == kc.read_work(8, 256, 96, S, 8, fused=False)
    assert kc.fake_work.work["opa_fused/device"] == kc.opa_work(8, 256, 96, S, dev=True)
    assert kc.fake_work.work["opa_dense/f32_counter"] == kc.dense_work(256, 96, S)
    assert kc.fake_work.work["opa_im2col/bf16"] == kc.im2col_work(64, 8, 4, S) + kc.im2col_work(64, 8, 4, S)
    assert kc.fake_work.work["crs/crs"].bytes == 3 * 2 * S * 256 * 96


REFERENCE_KEYS = {"arch", "shape", "mesh", "n_devices", "tp", "kv_dtype", "memory", "cost", "collectives", "status"}
SMOKE_SHAPES = {"train": {"kind": "train", "seq_len": 16, "global_batch": 4},
                "prefill": {"kind": "prefill", "seq_len": 16, "global_batch": 4},
                "decode": {"kind": "decode", "seq_len": 32, "global_batch": 4}}


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)])
@pytest.mark.parametrize("kind", list(SMOKE_SHAPES))
def test_smoke_cells_run_on_meta_tensors(nothing_built, kind, mesh_shape):
    mesh = M.logical_mesh(mesh_shape, ("data", "model"))
    rec = D.run_cell("gemma-2b", kind, "x".join(map(str, mesh_shape)), cfg=configs.get_smoke("gemma_2b"),
                     shape=SMOKE_SHAPES[kind], mesh=mesh)
    assert REFERENCE_KEYS <= set(rec) and rec["status"] == "ok"
    mem, cost, coll = rec["memory"], rec["cost"], rec["collectives"]
    assert mem["peak_per_device_bytes"] >= mem["argument_bytes"] > 0
    assert cost["flops"] > 0 and cost["bytes_accessed"] > 0
    assert set(coll) == {"bytes", "counts", "total_bytes"} and coll["total_bytes"] == sum(coll["bytes"].values())
    assert (coll["total_bytes"] > 0) == (mesh_shape != (1, 1))
    if kind == "train":
        assert {"microbatches", "remat", "grad_dtype"} <= set(rec) and rec["remat"] == "full"
        launches = rec["kernel_launches"]
        assert launches.get("opa_dense/bf16_counter", 0) > 0
        if mesh_shape == (1, 1):  # the operand leaves through K1 (its bf16 tensor-core work)
            assert launches.get("opa_fused/ideal", 0) > 0 and cost["kernel_ops"]["bf16"] > 0
        else:  # at data 2 their outer products, summed over data, through K2 (an f32 gradient); no K1
            assert launches.get("opa_dense/f32_counter", 0) > 0 and not any(k.startswith("opa_fused/") for k in launches)


def test_a_failing_cell_is_recorded_with_its_error(tmp_path, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("no such cell")

    monkeypatch.setattr(D, "run_cell", boom)
    assert D.main(["--arch", "gemma-2b", "--shape", "decode_32k", "--out", str(tmp_path)]) == 1
    import json

    (rec,) = json.loads((tmp_path / "summary.json").read_text())
    assert rec["status"] == "fail" and "no such cell" in rec["error"]
    assert (tmp_path / "gemma_2b__decode_32k__single.json").exists()


# PERF.md section 6's bounds (ms), each row's work through the formulas
LAYER = ((2048, 2560), (2048, 2048), (2048, 16384), (2048, 16384), (16384, 2048))  # gemma-2b's reads
BOUNDS = {  # a list: the rows' bounds summed read by read, as the table sums them
    "K4 decode, a layer's 5 reads at 4 tokens": (0.2632, lambda: [kc.read_work(4, m, n, 8, 16) for m, n in LAYER]),
    "K4 at 256 tokens, a layer": (3.4182, lambda: [kc.read_work(256, m, n, 8, 16) for m, n in LAYER]),
    "K1 counter, a layer": (0.5356, lambda: [kc.opa_work(256, m, n, 8) for m, n in LAYER]),
    "K2 dense write, embedding f32 counter": (3.1301, lambda: kc.dense_work(256000, 2048, 8)),
    "K3, a layer": (0.5259, lambda: kc.crs_work(8 * (2048 * 2560 + 2048 * 2048 + 3 * 2048 * 16384))),
    "K3, embedding": (2.5041, lambda: kc.crs_work(8 * 256000 * 2048)),
    "im2col, C 4224": (0.0033, lambda: kc.im2col_work(4224, 256, 4, 8)),
}


@pytest.mark.parametrize("row", list(BOUNDS))
def test_work_formulas_give_the_table_s_bounds(row):
    want, work = BOUNDS[row]
    got = work()
    ms = sum(w.bound_ms()[0] for w in got) if isinstance(got, list) else got.bound_ms()[0]
    assert round(ms, 4) == want, ms


def test_work_bound_names_what_bounds_it():
    assert kc.read_work(256, 2048, 2048, 8, 16).bound_ms()[1] == "operations"
    assert kc.read_work(4, 2048, 2048, 8, 16).bound_ms()[1] == "bytes"
