#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PANTHER (``src/repro_torch``) on one NVIDIA
Hopper card and check it.

Phases:
  1. build the CUDA kernel from the sources in this checkout (``nvcc``,
     ``sm_90a``) and print the card's name and power limit;
  2. hold the kernel against its plain PyTorch version at every (M, N) the
     gemma-2b serving path reads, at tokens {1, 4, 5, 16, 128} and ADC
     {9, 6, ideal}, plus a short last crossbar tile and a ragged N, and time
     the kernel, the plain version and ``torch.matmul`` on the dequantized
     weights (the lossless yardstick) at the decode (4) and prefill (128)
     token counts;
  3. serve gemma-2b at full width (d=2048, d_ff=16384, vocab 256000, bf16)
     through the adc9 finite-ADC plan: random weights from a seed, sliced into
     int8 digit planes, 4 prompts of 32 tokens prefilled and 16 tokens
     greedily decoded; the kernel's launch count must equal 5 reads x layers x
     (1 prefill + 15 decode steps), the logits must be finite and the
     adc9-vs-lossless gap finite.

It prints one JSON line with the kernel's numbers, the card's
``name, power.limit`` line, and last the device JSON line. Any failure exits
non-zero. Usage: ``python3 chip_smoke.py`` (no arguments).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
SLICE_SHAPES = ((2048, 2560), (2048, 2048), (2048, 16384), (16384, 2048))  # gemma-2b reads
SLICE_READS = (("attn/wqkv", 2048, 2560), ("attn/wo", 2048, 2048), ("mlp/wi_gate", 2048, 16384),
               ("mlp/wi_up", 2048, 16384), ("mlp/wo", 16384, 2048))
EDGE_SHAPES = ((320, 2048), (256, 100))  # short last tile; ragged N
TOL = 1e-3  # |kernel - plain| <= TOL * (1 + max|plain|), as tests/test_kernels_mvm_fused.py


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(B: int, M: int, N: int, S: int, io_bits: int) -> tuple[float, str]:
    """Least time for one read: planes (int8), x (f32) and frac_bits read
    once, out (f32) written once, over HBM; 2·B·M·N·S·(io_bits-1) int8 ops
    over the int8 peak."""
    nbytes = S * M * N + 4 * B * M + 4 * B * N + 4
    ops = 2.0 * B * M * N * S * (io_bits - 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(torch, K, ref, fp, spec, gen):
    """Kernel vs plain at the slice's shapes; timings at 4 and 128 tokens."""
    from repro_torch.core.slicing import dequantize_planes

    dev = torch.device("cuda")
    max_err, worst = 0.0, 0.0
    timings = {}
    shapes = [(m, n, b) for (m, n) in SLICE_SHAPES for b in (1, 4, 5, 16, 128)]
    shapes += [(m, n, b) for (m, n) in EDGE_SHAPES for b in (5, 16)]
    for M, N, B in shapes:
        planes = torch.randint(-8, 8, (spec.n_slices, M, N), generator=gen, device=dev, dtype=torch.int8)
        x = torch.randn((B, M), generator=gen, device=dev) * 0.7
        xf = fp.choose_frac_bits(x, word_bits=16, margin_bits=1, clip_to_word=False).reshape(1)
        for adc in (9, 6, None):
            got = K.mvm_sliced_fused(planes, x, xf, spec=spec, adc_bits=adc)
            want = ref.mvm_sliced_fused_ref(planes, x, xf[0], spec, 16, adc)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = 1.0 + float(want.abs().max())
            if not err <= TOL * scale:
                raise AssertionError(f"kernel vs plain at M={M} N={N} B={B} adc={adc}: "
                                     f"|diff| {err} > {TOL} * {scale}")
            max_err, worst = max(max_err, err), max(worst, err / scale)
        if (M, N) in SLICE_SHAPES and B in (4, 128):
            reps = 20 if B == 4 else 5
            w = dequantize_planes(planes, 30, spec)
            k_ms = cuda_time_ms(lambda: K.mvm_sliced_fused(planes, x, xf, spec=spec, adc_bits=9), reps)
            p_ms = cuda_time_ms(lambda: ref.mvm_sliced_fused_ref(planes, x, xf[0], spec, 16, 9), 2, 1)
            l_ms = cuda_time_ms(lambda: torch.matmul(x, w), reps)
            b_ms, b_by = bound_ms(B, M, N, spec.n_slices, 16)
            timings[(M, N, B)] = (k_ms, p_ms, l_ms, b_ms, b_by)
            print(f"  M={M:5d} N={N:5d} B={B:3d} adc9: kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
                  f"matmul {l_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})", flush=True)
            del w
        del planes, x
    print(f"kernel vs plain: {len(shapes) * 3} cases within {TOL}*(1+max|plain|); "
          f"max |diff| {max_err} (product grid), max |diff|/(1+max|plain|) {worst}", flush=True)
    torch.cuda.empty_cache()
    return max_err, timings


def profile_step(torch, step):
    """One more decode step under torch.profiler: device time by kernel and
    the device's busy share of the step's wall time (profiler on)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (the kernels themselves, not the aten ops that
    # launched them, whose device time would count the same kernels twice)
    rows = sorted(((e.device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profiled decode step: wall {wall_ms:.1f} ms (profiler on), device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.0f}%), {sum(r[1] for r in rows)} kernels", flush=True)
    for ms, n, key in rows[:8]:
        print(f"  {ms:9.3f} ms  x{n:<5d} {key[:100]}")


def phase_slice(torch, K, gen):
    """gemma-2b at full width through the adc9 fidelity plan."""
    from repro_torch import configs, plan as planlib
    from repro_torch.models import lm
    from repro_torch.optim import PantherConfig, panther
    from repro_torch.serve import kv_pages
    from repro_torch.serve.step import fidelity_params, make_decode_step, make_prefill

    cfg = configs.get("gemma_2b")
    layers = cfg.n_layers
    B, P, T = 4, 32, 16
    t0 = time.perf_counter()
    params0 = lm.init_params(cfg, gen, device="cuda")
    opt_cfg = PantherConfig()
    digital, sliced = panther.init_split(params0, opt_cfg)
    del params0
    dense = panther.materialize_split(digital, sliced, opt_cfg)
    torch.cuda.synchronize()
    print(f"gemma-2b: {layers} layers, d={cfg.d_model}, d_ff={cfg.d_ff}, vocab={cfg.vocab}, "
          f"dtype={cfg.dtype}; init+slice+materialize {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated", flush=True)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device="cuda")
    prefill, decode = make_prefill(cfg), make_decode_step(cfg)

    logits_ll, _ = prefill(dense, prompts)
    adc9 = configs.fidelity_presets()["adc9"]
    plan = planlib.resolve_plan(dense, planlib.default_rules(opt_cfg, fidelity=adc9))
    params = fidelity_params(dense, sliced, plan=plan)
    del dense  # the wraps dropped their dense copies; the embedding stays
    torch.cuda.empty_cache()

    # the path's first read on its real planes and input: the card (kernel)
    # against the CPU (plain version)
    from repro_torch.core.mvm import fidelity_read
    from repro_torch.models.common import rms_norm

    wqkv = lm.layer(params["groups"][0], 0)["attn"]["wqkv"]
    x0 = rms_norm({"scale": params["groups"][0]["attn"]["ln"]["scale"][0]},
                  lm._embed_in(cfg, params, prompts), cfg.norm_eps)
    got = fidelity_read(wqkv.planes, wqkv.frac_bits, x0, wqkv.fid).cpu()
    want = fidelity_read(wqkv.planes.cpu(), wqkv.frac_bits.cpu(), x0.cpu(), wqkv.fid)
    err, scale = float((got - want).abs().max()), 1.0 + float(want.abs().max())
    print(f"layer-0 wqkv read on the card vs the plain version on the CPU: max |diff| {err} "
          f"(max |plain| {scale - 1.0})", flush=True)
    if not err <= TOL * scale:
        raise AssertionError(f"first read: card vs CPU |diff| {err} > {TOL} * {scale}")

    K.mvm_sliced_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(params, prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    caches = kv_pages.grow_caches(cfg, lm.unstack_caches(cfg, caches), P + T)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    toks, step_s, all_finite = [tok], [], bool(torch.isfinite(logits).all())
    for i in range(T - 1):
        t0 = time.perf_counter()
        tok, lg, caches = decode(params, tok.long(), caches, P + i)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        all_finite &= bool(torch.isfinite(lg).all())
        toks.append(tok)
    launches = K.mvm_sliced_fused.launches
    gap = float((logits.float() - logits_ll.float()).abs().max())
    out = torch.stack(toks, dim=1).cpu().tolist()
    print(f"prefill [{B}x{P}] {prefill_s * 1e3:.1f} ms; decode {1e3 * sum(step_s) / len(step_s):.1f} "
          f"ms/step over {len(step_s)} steps (batch {B}); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    for row in out:
        print("  tokens:", row)
    print(f"adc9 vs lossless prefill logits: max |diff| {gap}, max |lossless| "
          f"{float(logits_ll.float().abs().max())}", flush=True)
    profile_step(torch, lambda: decode(params, tok.long(), caches, P + T - 1))
    want = 5 * layers * T
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != 5 reads x {layers} layers x {T} steps = {want}")
    if not all_finite:
        raise AssertionError("non-finite logits on the adc9 path")
    if not gap == gap or gap == float("inf"):
        raise AssertionError(f"adc9-vs-lossless gap not finite: {gap}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import fixed_point as fp
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.kernels.sliced_mvm import ref

    torch.backends.cuda.matmul.allow_tf32 = False  # plain version and yardstick in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}", flush=True)

    built = K.build_kernel()
    print(f"built mvm_sliced_fused in {built.seconds:.1f} s -> {built.path.name}", flush=True)
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err, timings = phase_kernels(torch, K, ref, fp, DEFAULT_SPEC, gen)
    launches = phase_slice(torch, K, gen)

    # one layer's five reads at the decode batch (4 tokens): the main path's
    # per-layer decode work
    def per_layer(i):
        return sum(timings[(m, n, 4)][i] for _, m, n in SLICE_READS)

    bounds = [bound_ms(4, m, n, DEFAULT_SPEC.n_slices, 16) for _, m, n in SLICE_READS]
    line = {"kernels": [{
        "name": "mvm_sliced_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/sliced_mvm/csrc/mvm_sliced_fused.cu",
        "replaces": "src/repro/kernels/sliced_mvm/kernel.py:367",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": per_layer(0),
        "plain_ms": per_layer(1),
        "bound_ms": sum(b for b, _ in bounds),
        "bound_by": "bytes" if all(by == "bytes" for _, by in bounds) else "operations",
        "library_ms": per_layer(2),
    }]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
