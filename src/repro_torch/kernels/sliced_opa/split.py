"""Time K1 ``opa_fused`` in parts on the card, to see what bounds it.

``csrc/opa_fused.cu`` builds with ``-DOPA_PART=p``: 0 the whole kernel, 1
the mainloop alone (a checksum store in place of the finalize), 2 the
finalize alone (the accumulator a constant, no mainloop), 3 the plane load
and store alone. This script builds the four (one ``nvcc`` each, all
started together) and times each body (``mma``, ``fma``) and instance
(ideal, device) at the largest operand block of gemma-2b's training step,
``mlp/wi_gate`` (M 2048, N 16384, T 256, bf16 operands), with the device
model of ``chip_smoke.py``'s device phase, under each rounding draw asked
for (``--rng``: the counter draw by default; ``grid`` at layer 17's offset,
``hw``), and then the whole device instance of each body with one
write-physics field at a time. The parts' numbers are timings only: their
planes are not a valid update.

Usage, on a machine with the card: ``PYTHONPATH=src python -m
repro_torch.kernels.sliced_opa.split [--bodies mma,fma] [--rng counter,grid,hw]``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time

import torch

from repro_torch.core.slicing import DEFAULT_SPEC
from repro_torch.kernels import build as _build
from repro_torch.kernels.sliced_opa import kernel as KO
from repro_torch.models.common import DeviceModel

PARTS = {0: "whole", 1: "mainloop", 2: "finalize", 3: "planes"}
SHAPE = (2048, 16384, 256)  # mlp/wi_gate: M, N, tokens
PHYSICS = {"asym": dict(asym_up=1.2, asym_down=0.8), "noise": dict(write_noise=4e6),
           "stuck": dict(stuck_frac=0.02, stuck_seed=3)}
DEVICE = {k: v for kw in PHYSICS.values() for k, v in kw.items()}


def build_parts() -> dict:
    """{part: library path}, built together; a part built from the same
    sources before is reused."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = KO.SOURCES["opa_fused"][0]
    procs, out = {}, {}
    for part in PARTS:
        path = _build._target(f"opa_fused_part{part}", [src])
        if path.exists():
            out[part] = path
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")  # renamed once built, as build.py does
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, f"-DOPA_PART={part}", "-o", str(tmp), str(src)]
        procs[part] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), path, tmp)
    for part, (proc, path, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building part {part}:\n{log}")
        for line in log.splitlines():
            # each function's name, then its spills and registers
            if any(k in line for k in ("Function properties", "registers", "spill")):
                print(f"  part {part} ptxas: {line.strip()}")
        os.replace(tmp, path)
        out[part] = path
    return dict(sorted(out.items()))


@contextlib.contextmanager
def using(path):
    """Route ``KO.opa_fused`` through the library at ``path``."""
    fn = KO._bind(path, "opa_fused")
    saved = KO._entry
    KO._entry = lambda name: fn
    try:
        yield
    finally:
        KO._entry = saved


def time_ms(fn, reps: int = 10) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bodies", default="mma,fma", help="comma-separated K1 bodies to time")
    ap.add_argument("--rng", default="counter", help="comma-separated rounding draws to time (counter, grid, hw)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("split.py needs an NVIDIA card")
    t0 = time.perf_counter()
    libs = build_parts()
    print(f"built {len(libs)} parts in {time.perf_counter() - t0:.1f} s", flush=True)
    M, N, T = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    planes = torch.randint(-8, 8, (DEFAULT_SPEC.n_slices, M, N), generator=g, device="cuda", dtype=torch.int8)
    frac = torch.tensor([30], dtype=torch.int32, device="cuda")
    x = torch.randn((T, M), generator=g, device="cuda").to(torch.bfloat16)
    dh = (torch.randn((T, N), generator=g, device="cuda") * 1e-3).to(torch.bfloat16)
    dev = DeviceModel(**DEVICE)
    rows = []
    for rng in args.rng.split(","):
        offset = 17 * M * N if rng == "grid" else 0
        for body in args.bodies.split(","):
            for d in (None, dev):
                name = KO.instance_name(d is not None, body, rng)
                for part, path in libs.items():
                    with using(path):
                        ms = time_ms(lambda: KO.opa_fused(planes, x, dh, 3e-2, frac, spec=DEFAULT_SPEC,
                                                          key_words=(1, 2), rng_mode=rng, offset=offset, dev=d,
                                                          noise_words=(3, 4), body=body))
                    rows.append({"body": body, "instance": name, "part": PARTS[part], "ms": ms})
                    print(f"  {body} {name:15s} {PARTS[part]:9s} M={M} N={N} T={T}: {ms:.4f} ms", flush=True)
    for body in args.bodies.split(","):
        for name, kw in PHYSICS.items():
            d = DeviceModel(**kw)
            with using(libs[0]):
                ms = time_ms(lambda: KO.opa_fused(planes, x, dh, 3e-2, frac, spec=DEFAULT_SPEC, key_words=(1, 2),
                                                  dev=d, noise_words=(3, 4), body=body))
            rows.append({"body": body, "instance": KO.instance_name(True, body), "part": f"whole, {name} only",
                         "ms": ms})
            print(f"  {body} {KO.instance_name(True, body):10s} whole, {name} only: {ms:.4f} ms", flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(out)
    print(json.dumps({"split": rows, "card": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
