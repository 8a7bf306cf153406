"""Dry run of every (arch x shape x mesh) cell on meta tensors (port of
``repro.launch.dryrun``).

For each cell this script:
  1. builds the production mesh (16x16 single-pod / 2x16x16 multi-pod, or
     ``--tp``'s 256/tp x tp) and takes its rank 0 as a *dry* mesh
     (``launch.mesh.dry_mesh``): the mesh code paths run as on a live mesh,
     and every collective goes through ``distributed.collectives``, which
     counts it and answers it with an output of the right shape, sending
     nothing;
  2. builds the step the reference builds: the train step (``fsdp=True``,
     ``PantherConfig(stochastic_round=True, compute_dtype=bf16)``, the
     chosen microbatches, ``--remat``, ``--grad-dtype``), ``make_prefill``
     or ``make_decode_step`` on bf16 serving params;
  3. makes rank 0's inputs as meta tensors (shapes and dtypes, no storage):
     its block of the train state, the batch, its rows of the caches;
  4. runs that rank's step on them. Every op runs on meta tensors; every
     kernel entry takes its fake path (``kernels.common.is_fake``): it
     allocates what the launch would, records the launch by instance and
     its work (``kernels.common.fake_work``), and launches nothing;
  5. records what the step holds and moves (``measure``): the peak of live
     storage bytes over the step, its inputs included; the flops of the
     PyTorch ops (``torch.utils.flop_counter``'s registry) plus the
     kernels' operations, and
     the bytes every op and kernel reads and writes; the collectives by
     kind; the kernel launches by instance. A failing cell is recorded
     with its error.

These are counts on the CPU, not times. The reference compiles on stand-in
shapes (``jax.ShapeDtypeStruct``); the port runs eagerly, so it runs the
step itself on tensors with no storage. Meta tensors, not FakeTensors on
``cuda``: a CPU build of torch creates fake CUDA tensors but aborts in
autograd on them (the gradient's metadata asks for a CUDA device guard),
and a meta tensor takes the kernel route as a fake one does. Every block of
a sharded leaf has one shape (a mesh axis shards only a dim it divides), so
rank 0's blocks are as large as any rank's.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --out DIR   # the whole sweep
    python -m repro_torch.launch.dryrun --table DIR       # DIR's records as a markdown table
"""
from __future__ import annotations

import argparse
import json
import os
import traceback
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs, tree
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.common import fake_work
from repro_torch.launch import mesh as M
from repro_torch.models import lm
from repro_torch.models.common import ShapeDtype
from repro_torch.optim import PantherConfig
from repro_torch.optim.panther import SlicedTensor
from repro_torch.optim.schedules import constant
from repro_torch.serve.step import make_decode_step, make_prefill
from repro_torch.train.step import TrainState, make_train_step, shard_state, train_state_init

DEVICE = "meta"
MICROBATCH_OVERRIDE = None
KV_DTYPE = torch.bfloat16  # --kv-dtype int8: the quantized cache
TRAIN_REMAT = "full"  # --remat dots: save the matmuls with no batch dims
GRAD_DTYPE = torch.float32  # --grad-dtype bf16: the microbatches' gradient sums in bf16


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def choose_microbatches(cfg, mesh, B: int, S: int) -> int:
    """The reference's gradient-accumulation depth: per-microbatch
    activations of ``B_dev · S · d · 2 B · L / G`` at most ~3 GiB a device,
    ``B_dev`` the batch a data rank holds."""
    if MICROBATCH_OVERRIDE is not None:
        return MICROBATCH_OVERRIDE
    dp = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names and B % (dp * mesh.shape[a]) == 0:
            dp *= mesh.shape[a]
    b_dev = max(B // dp, 1)
    carry_bytes = b_dev * S * cfg.d_model * 2 * max(cfg.n_layers, 1)
    target = 3 * 2**30
    g = 1
    while carry_bytes / g > target and g < b_dev:
        g *= 2
    return g


def input_specs(cfg, shape_name: str, microbatches: int = 1, shape: dict | None = None) -> dict:
    """``ShapeDtype`` stand-ins for one cell's whole inputs, the
    reference's: train ``inputs``/``labels`` (``[G, B/G, S]`` with
    microbatches), prefill ``inputs``, decode ``token``, ``caches`` (the
    list layout) and ``pos``. ``shape``: a ``configs.SHAPES`` entry in place
    of ``shape_name``'s."""
    shape = shape or configs.SHAPES[shape_name]
    B, S = shape["global_batch"], shape["seq_len"]
    kind = shape["kind"]
    if cfg.input_mode == "tokens":
        tok = lambda b, s: ShapeDtype((b, s), torch.int32)  # noqa: E731
    else:
        tok = lambda b, s: ShapeDtype((b, s, cfg.d_model), torch.bfloat16)  # noqa: E731
    if kind == "train":
        if microbatches > 1:
            g, b = microbatches, B // microbatches
            mb = lambda t: ShapeDtype((g,) + t.shape, t.dtype)  # noqa: E731
            return {"inputs": mb(tok(b, S)), "labels": mb(ShapeDtype((b, S), torch.int32))}
        return {"inputs": tok(B, S), "labels": ShapeDtype((B, S), torch.int32)}
    if kind == "prefill":
        return {"inputs": tok(B, S)}
    if cfg.input_mode == "tokens":
        token = ShapeDtype((B,), torch.int32)
    else:
        token = ShapeDtype((B, 1, cfg.d_model), torch.bfloat16)
    return {"token": token, "caches": lm.cache_specs(cfg, B, S, KV_DTYPE, layout="list"),
            "pos": ShapeDtype((), torch.int32)}


# ------------------------------ meta inputs ------------------------------


def _meta(t: torch.Tensor, dtype=None, device=DEVICE) -> torch.Tensor:
    """A tensor of ``t``'s shape and strides (and ``dtype``) on ``device``,
    with no contents."""
    return torch.empty_strided(tuple(t.shape), tuple(t.stride()), dtype=dtype or t.dtype, device=device)


def meta_of(spec, device=DEVICE):
    """A tree of ``ShapeDtype`` leaves as empty tensors on ``device``."""
    return tree.map(lambda s: s if not isinstance(s, ShapeDtype) else torch.empty(s.shape, dtype=s.dtype,
                                                                                    device=device), spec)


def meta_train_state(cfg, opt_cfg, plan, device=DEVICE) -> TrainState:
    """``train_state_init(cfg, opt_cfg, 0, plan=plan)``'s layout (the
    planes' layer-major storage too) on ``device``, with no contents:
    initialized under ``FakeTensorMode`` on the CPU, then remade there."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        st = train_state_init(cfg, opt_cfg, 0, plan=plan, device="cpu")
    digital = tree.map(lambda d: None if d is None else _meta(d, device=device), st.digital)
    sliced = tree.map(lambda s: None if s is None else SlicedTensor(_meta(s.planes, device=device),
                                                                  _meta(s.frac_bits, device=device)), st.sliced)
    return TrainState(st.step, digital, sliced, st.rng)


def meta_serve_params(cfg, device=DEVICE) -> dict:
    """The reference's serving params: the dequantized tree, bf16 at every
    leaf of two or more dims, on ``device`` with no contents."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = lm.init_params(cfg, 0, device="cpu")
    return tree.map(lambda p: _meta(p, torch.bfloat16 if p.dim() >= 2 else p.dtype, device), params)


# -------------------------------- measuring --------------------------------


def _tensors(xs) -> list:
    """The tensors among ``xs`` and the lists and tuples in it."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out += _tensors(x)
    return out


class _Meter(TorchDispatchMode):
    """Live storage bytes over the ops run inside it: every storage an op
    returns (and each one ``hold`` is given) counts from its first sight
    until it is freed; ``peak`` is the most at once. ``moved`` sums the
    bytes each op that is not a view reads and writes, ``flops`` the
    flops of the ops ``torch.utils.flop_counter`` counts (its registry:
    the matmuls, convolutions and attention)."""

    def __init__(self):
        from torch.utils.flop_counter import flop_registry

        super().__init__()
        self.live = self.peak = self.moved = self.flops = 0
        self._sizes: dict = {}
        self._flop_fns = flop_registry

    def hold(self, t) -> None:
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        if not func.is_view:
            ins = _tensors(args) + _tensors(tuple(kwargs.values()))
            self.moved += sum(t.numel() * t.element_size() for t in ins + outs)
            count = self._flop_fns.get(func.overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
        for t in outs:
            self.hold(t)
        return out


def measure(fn, *args) -> tuple:
    """``fn(*args)`` on meta tensors, measured: ``(its result, a record)``
    with ``memory`` (``argument_bytes``: the inputs' storages;
    ``peak_per_device_bytes``: the most live storage bytes at once, the
    inputs included; ``temp_bytes`` the difference), ``cost`` (``flops``:
    the PyTorch ops' flops plus every kernel's operations; ``torch_flops``,
    ``kernel_ops`` by unit; ``bytes_accessed``: what the ops and the
    kernels read and write), ``collectives`` (``distributed.collectives``'
    tally) and ``kernel_launches`` (``common.fake_work``'s launches by
    instance). Those two are cleared first; the kernel wrappers' counters
    (real launches) are left as they are."""
    fake_work.clear()
    col.tally.clear()
    meter = _Meter()
    for t in pytree.tree_leaves(args):
        meter.hold(t)
    arg_bytes = meter.live
    with meter:
        out = fn(*args)
    work = fake_work.total()
    rec = {
        "memory": {"argument_bytes": arg_bytes, "temp_bytes": meter.peak - arg_bytes,
                   "peak_per_device_bytes": meter.peak},
        "cost": {"flops": float(meter.flops + work.ops), "torch_flops": float(meter.flops),
                 "kernel_ops": {"int8": work.int8_ops, "bf16": work.bf16_flops, "cuda_core": work.core_ops},
                 "bytes_accessed": float(meter.moved + work.bytes), "kernel_bytes": float(work.bytes)},
        "collectives": col.tally.record(),
        "kernel_launches": dict(fake_work.launches),
    }
    return out, rec


# --------------------------------- cells ---------------------------------


def _mesh(mesh_kind: str, tp: int | None = None):
    if tp is not None and mesh_kind == "single":
        return M.logical_mesh((256 // tp, tp), ("data", "model"))
    return M.make_production_mesh(multi_pod=(mesh_kind == "multi"))


TRAIN_OPT = PantherConfig(stochastic_round=True, compute_dtype=torch.bfloat16)


def train_cell_step(cfg, shape: dict, mesh) -> tuple:
    """``(train step, microbatches)`` of a train cell on ``mesh`` (live or
    dry): ``fsdp=True``, ``TRAIN_OPT``, lr 1e-3, ``TRAIN_REMAT``,
    ``GRAD_DTYPE``, the chosen microbatches."""
    B, S = shape["global_batch"], shape["seq_len"]
    g = choose_microbatches(cfg, mesh, B, S)
    step = make_train_step(cfg, TRAIN_OPT, constant(1e-3), mesh=mesh, global_batch=B, microbatches=g, fsdp=True,
                           remat=TRAIN_REMAT, grad_dtype=GRAD_DTYPE)
    return step, g


def build_cell(arch: str, shape_name: str, mesh, device=DEVICE, cfg=None, shape: dict | None = None) -> tuple:
    """``(fn, args, knobs)`` of one cell: the step rank 0 of ``mesh`` (a
    logical mesh) runs, its meta inputs, and the train knobs. ``cfg`` and
    ``shape`` (a ``configs.SHAPES`` entry) stand in for the arch's config
    and the named shape (a SMOKE cell)."""
    cfg = cfg or configs.get(arch)
    shape = shape or configs.SHAPES[shape_name]
    B, S = shape["global_batch"], shape["seq_len"]
    kind = shape["kind"]
    dm = M.dry_mesh(mesh, device=device)
    if kind == "train":
        step, g = train_cell_step(cfg, shape, dm)
        knobs = {"microbatches": g, "remat": TRAIN_REMAT, "grad_dtype": _dtype_name(GRAD_DTYPE)}
        state = shard_state(meta_train_state(cfg, TRAIN_OPT, step.plan, device), step.specs, dm)
        return step, (state, meta_of(input_specs(cfg, shape_name, g, shape), device)), knobs
    params = meta_serve_params(cfg, device)
    ins = input_specs(cfg, shape_name, shape=shape)
    if kind == "prefill":
        return make_prefill(cfg, mesh=dm, global_batch=B), (params, meta_of(ins["inputs"], device)), {}
    rows = B // dm.axes_size(shd.data_axes_for(dm, B))
    caches = meta_of(lm.cache_specs(cfg, rows, S, KV_DTYPE, layout="list"), device)
    # the port's scalar decode position is a host int: the cache's last
    # position (the reference's traced int32 scalar, ``input_specs``)
    args = (params, meta_of(ins["token"], device), caches, S - 1)
    return make_decode_step(cfg, mesh=dm, global_batch=B), args, {}


def run_cell(arch: str, shape_name: str, mesh_kind: str, tp: int | None = None, device=DEVICE, cfg=None,
             shape: dict | None = None, mesh=None) -> dict:
    """One cell's record (the reference's keys, and ``kernel_launches``).
    ``cfg``, ``shape`` and ``mesh`` (a logical mesh) stand in for the
    arch's config, the named shape and ``mesh_kind``'s mesh."""
    mesh = mesh if mesh is not None else _mesh(mesh_kind, tp)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "n_devices": mesh.size,
           "tp": mesh.shape.get("model", 1), "kv_dtype": _dtype_name(KV_DTYPE)}
    fn, args, knobs = build_cell(arch, shape_name, mesh, device, cfg, shape)
    _, m = measure(fn, *args)
    del fn, args
    rec.update(m)
    rec.update(knobs)
    rec["blocks"] = "rank 0's (every block of a sharded leaf has one shape)"
    rec["status"] = "ok"
    return rec


def cells_of(arch=None, shape=None, mesh="single", all_cells=False) -> list:
    """``(arch, shape, mesh)`` of the sweep the flags name, in the
    reference's order."""
    archs = list(configs.ALIASES) if (all_cells or arch is None) else [arch]
    out = []
    for a in archs:
        shapes = configs.shape_cells(a) if (all_cells or shape is None) else [shape]
        meshes = ["single", "multi"] if mesh == "both" or all_cells else [mesh]
        out += [(a, s, m) for s in shapes for m in meshes]
    return out


def table(records: list) -> str:
    """The records as a markdown table, a row an arch, a column a shape:
    each cell's peak GiB a rank, flops, all-reduce / all-gather MiB and (a
    train cell) microbatches, on the single and then the multi-pod mesh
    (``single; multi``). The port's other collective kinds are 0 and not
    shown; a failed cell shows its status."""
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in records}
    archs = list(dict.fromkeys(r["arch"] for r in records))
    shapes = [s for s in configs.SHAPES if any(r["shape"] == s for r in records)]

    def one(r):
        if r is None:
            return "-"
        if r.get("status") != "ok":
            return f"**{r.get('status')}**"
        c = r["collectives"]["bytes"]
        out = (f"{r['memory']['peak_per_device_bytes'] / 2**30:.1f} GiB, {r['cost']['flops']:.2g}, "
               f"{c['all-reduce'] / 2**20:.0f} / {c['all-gather'] / 2**20:.0f} MiB")
        return out + (f", mb {r['microbatches']}" if "microbatches" in r else "")

    rows = ["| arch | " + " | ".join(shapes) + " |", "| --- " * (1 + len(shapes)) + "|"]
    for a in archs:
        rows.append(f"| {a} | " + " | ".join("; ".join(one(by.get((a, s, m))) for m in ("single", "multi"))
                                             if (a, s, "single") in by else "-" for s in shapes) + " |")
    fails = [r for r in records if r.get("status") != "ok"]
    rows += [f"\n{r['arch']} {r['shape']} {r['mesh']}: {r.get('error', '')[:300]}" for r in fails]
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(configs.SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="run every supported cell")
    ap.add_argument("--out", default=None, help="output dir for JSON artifacts")
    ap.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"], help="decode KV-cache dtype")
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"], help="train remat policy")
    ap.add_argument("--grad-dtype", default="f32", choices=["f32", "bf16"],
                    help="the microbatches' gradient accumulation dtype")
    ap.add_argument("--tp", type=int, default=None, help="override model-axis width on the single-pod mesh")
    ap.add_argument("--mb", type=int, default=None, help="override gradient-accumulation microbatch count")
    ap.add_argument("--table", default=None, metavar="DIR",
                    help="print the records under DIR (every summary.json) as a markdown table, in the sweep's order")
    args = ap.parse_args(argv)
    if args.table:
        import glob

        recs = [r for f in sorted(glob.glob(os.path.join(args.table, "**", "summary.json"), recursive=True))
                for r in json.load(open(f))]
        order = {c: i for i, c in enumerate(cells_of(all_cells=True))}
        print(table(sorted(recs, key=lambda r: order.get((r["arch"], r["shape"], r["mesh"]), len(order)))))
        return 0
    global MICROBATCH_OVERRIDE, KV_DTYPE, TRAIN_REMAT, GRAD_DTYPE
    MICROBATCH_OVERRIDE = args.mb
    KV_DTYPE = torch.int8 if args.kv_dtype == "int8" else torch.bfloat16
    TRAIN_REMAT = args.remat
    GRAD_DTYPE = torch.bfloat16 if args.grad_dtype == "bf16" else torch.float32

    results = []
    for arch, s, m in cells_of(args.arch, args.shape, args.mesh, args.all):
        name = f"{arch}|{s}|{m}"
        try:
            rec = run_cell(arch, s, m, tp=args.tp)
            print(f"[ok] {name}: peak/dev={rec['memory']['peak_per_device_bytes'] / 2**30:.2f}GiB "
                  f"flops={rec['cost']['flops']:.3g} coll={rec['collectives']['total_bytes'] / 2**20:.1f}MiB "
                  f"launches={sum(rec['kernel_launches'].values())}", flush=True)
        except Exception as e:  # noqa: BLE001 - record and continue the sweep
            rec = {"arch": arch, "shape": s, "mesh": m, "status": "fail", "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
            print(f"[FAIL] {name}: {type(e).__name__}: {str(e)[:200]}", flush=True)
        results.append(rec)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            fname = f"{arch.replace('.', 'p').replace('-', '_')}__{s}__{m}.json"
            with open(os.path.join(args.out, fname), "w") as f:
                json.dump(rec, f, indent=1)

    ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"\n{ok}/{len(results)} cells ran on meta tensors")
    if args.out:
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(results, f, indent=1)
    return 0 if ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
