"""Training launcher (port of ``repro.launch.train``):
``python -m repro_torch.launch.train --arch gemma-2b --steps 50``.

Trains on the card (``--device cuda``, the default; without one it raises)
or, for a check at the reduced size, on the CPU with the plain versions
(``--smoke --device cpu``). Random weights from seed 0, synthetic
bigram tokens (step-indexed, so a resumed run sees the batches it would
have seen), the PANTHER update with counter-hash stochastic rounding and
CRS every ``--crs-every`` steps; ``--fidelity`` trains through the
finite-ADC reads. Every ported architecture trains (``--arch
granite-moe-1b-a400m`` through its MoE blocks, with the load-balance term
in the loss, logged as ``aux``), under the default rules as in the
reference's launcher; a model on frame embeddings (musicgen-large) reads
the token stream through ``data.FrameStub``.

``--ckpt-dir`` checkpoints the train state (``repro_torch.checkpoint``,
the reference's format, with the resolved plan in every manifest): it
restores the newest commit at start, saves every ``--ckpt-every`` steps and
once at the end. A resumed run continues at the step after the one its
checkpoint holds (``rstep + 1``, the state's own count), so it equals the
run that was never interrupted.

``--mesh debug`` trains on the reference's 2x2 ``(data, model)`` debug mesh
(``launch.mesh``), one process a mesh coordinate: run alone, the launcher
spawns the four processes itself (as the reference forces four host
devices) and returns rank 0's metrics; under ``torchrun --nproc-per-node 4``
it joins the world it is given. The backend is chosen by
``launch.mesh.backend_for`` and printed; on ``--device cuda`` with fewer
cards than ranks the ranks share a card over gloo. Rank 0 prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--schedule", default="constant", choices=["constant", "cosine", "wsd"])
    ap.add_argument("--crs-every", type=int, default=1024)
    ap.add_argument("--fidelity", default="none",
                    choices=["none", "ideal", "adc9", "adc6", "adc6_fwd", "adc6_bwd"],
                    help="crossbar-in-the-loop preset: train through the finite-ADC reads")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--mesh", default="none", choices=["none", "debug"],
                    help="debug: the 2x2 (data, model) mesh, one process a coordinate")
    return ap


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def main(argv=None) -> list:
    """Run the launcher; returns the metrics of the steps it ran (floats,
    and ``time_s``, the host clock at the end of the step since the loop
    began: a device sync only where the step logs)."""
    args = build_parser().parse_args(argv)
    mesh = None
    if args.mesh == "debug":
        import torch.distributed as dist

        from repro_torch.launch import mesh as M

        if not dist.is_initialized() and "RANK" not in os.environ:  # alone: start the 2x2 world
            return M.spawn(_mesh_main, 4, args=(argv,), timeout=None)[0]
        M.init_world(args.device)
        mesh = M.make_debug_mesh()
    rank0 = mesh is None or all(c == 0 for c in mesh.coordinate.values())

    from repro_torch import configs
    from repro_torch import plan as planlib
    from repro_torch.checkpoint import CheckpointManager, list_checkpoints, save_checkpoint
    from repro_torch.data import FrameStub, SyntheticLMDataset
    from repro_torch.device import resolve
    from repro_torch.train.step import shard_state
    from repro_torch.optim import PantherConfig
    from repro_torch.optim.schedules import constant, cosine, wsd
    from repro_torch.train.step import make_train_step, param_shapes, train_state_init

    device = resolve(args.device) if mesh is None else mesh.device
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    sched = {
        "constant": lambda: constant(args.lr),
        "cosine": lambda: cosine(args.lr, warmup=max(args.steps // 20, 1), total=args.steps),
        "wsd": lambda: wsd(args.lr, warmup=max(args.steps // 20, 1),
                           stable=int(args.steps * 0.7), decay=max(int(args.steps * 0.25), 1)),
    }[args.schedule]()
    opt_cfg = PantherConfig(crs_every=args.crs_every, stochastic_round=True)
    rules = None
    if args.fidelity != "none":
        # the engine must read the planes the optimizer writes
        fid = dataclasses.replace(configs.fidelity_presets()[args.fidelity], spec=opt_cfg.spec)
        rules = planlib.default_rules(opt_cfg, fidelity=fid)

    ds = SyntheticLMDataset(cfg.vocab, args.seq, args.batch, device=device)
    frames = FrameStub(cfg.vocab, cfg.d_model, device=device) if cfg.input_mode != "tokens" else None

    def batch_of(step):
        b = ds.batch(step)
        return b if frames is None else {**b, "inputs": frames(b["inputs"])}
    step_fn = make_train_step(cfg, opt_cfg, sched, plan_rules=rules, mesh=mesh,
                              global_batch=args.batch if mesh is not None else None)
    state = train_state_init(cfg, opt_cfg, 0, device=device)
    specs = None
    if mesh is not None:
        specs = step_fn.specs
        state = shard_state(state, specs, mesh)

    ckpt, start = None, 0
    if args.ckpt_dir:
        # the resolved plan rides every manifest: a restore under another
        # layout or write physics fails instead of misreading the planes
        plan = planlib.resolve_plan(param_shapes(state.digital, state.sliced),
                                    rules if rules is not None else planlib.default_rules(opt_cfg))
        ckpt = CheckpointManager(args.ckpt_dir, every=args.ckpt_every, plan=plan, mesh=mesh, specs=specs)
        t0 = time.perf_counter()
        restored, rstep = ckpt.restore(state)
        if restored is not None:
            state, start = restored, rstep + 1
            _sync(device)
            if rank0:
                print(f"checkpoint: restored step {rstep} from {args.ckpt_dir} in {time.perf_counter() - t0:.3f} s")
                print(f"resumed from step {rstep}", flush=True)

    def save(step, fn):
        if step in list_checkpoints(ckpt.directory):  # a re-save keeps the first commit
            return
        t0 = time.perf_counter()
        path = fn(step)
        if path is not None and rank0:
            print(f"checkpoint: step {step}: {_dir_bytes(path)} bytes in {path} "
                  f"({time.perf_counter() - t0:.3f} s)", flush=True)

    history = []
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        state, metrics = step_fn(state, batch_of(step))
        if rank0 and (step % args.log_every == 0 or step == args.steps - 1):  # the only device syncs
            aux = f" aux {float(metrics['aux']):.4f}" if cfg.moe is not None else ""
            print(f"step {step:5d} loss {float(metrics['loss']):.4f}{aux} lr {metrics['lr']:.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} ({time.perf_counter() - t0:.1f}s)", flush=True)
        history.append({**metrics, "time_s": time.perf_counter() - t0})
        if ckpt:
            save(step, lambda s: ckpt.maybe_save(s, state))
    if ckpt:
        save(args.steps - 1, lambda s: save_checkpoint(ckpt.directory, s, state, ckpt.keep_last, plan=ckpt.plan,
                                                       mesh=mesh, specs=specs))
    if rank0:
        print("done")
    return [{k: float(v) for k, v in m.items()} for m in history]


def _mesh_main(rank: int, argv):
    """One rank of the spawned ``--mesh debug`` world."""
    return main(argv)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


if __name__ == "__main__":
    main()
