#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PANTHER (``src/repro_torch``) on one NVIDIA
Hopper card and check it.

Phases:
  1. build the CUDA kernels from the sources in this checkout (one ``nvcc``
     per library, all started together, ``sm_90a``) and print the card's
     name and power limit;
  2. hold the kernel against its plain PyTorch version at every (M, N) the
     gemma-2b serving path reads, at tokens {1, 4, 5, 16, 128, 256} and ADC
     {9, 6, ideal} (bit for bit at finite ADC), plus a short last crossbar
     tile and a ragged N, and time the kernel, the plain version and
     ``torch.matmul`` on the dequantized weights (the lossless yardstick) at
     the decode (4) and prefill (128) token counts and at 5, with K4's two
     bodies side by side: the tensor-core body, and the dp4a body as K5 runs
     it on x_q (the wrapper picks the dp4a body for reads of at most 4
     tokens);
  3. serve gemma-2b at full width (d=2048, d_ff=16384, vocab 256000, bf16)
     through the adc9 finite-ADC plan: random weights from a seed, sliced into
     int8 digit planes, 4 prompts of 32 tokens prefilled and 16 tokens
     greedily decoded; the kernel's launch count must equal 5 reads x layers x
     (1 prefill + 15 decode steps), the prefill's on the tensor-core body
     and the decode steps' on the dp4a body, the logits must be finite and
     the adc9-vs-lossless gap finite;
  4. hold the update kernels and the transpose read against their plain
     versions: ``crs`` and ``opa_deposit`` bit for bit at gemma-2b's four
     (M, N), the 256000x2048 embedding and a ragged 320x100, on inputs that
     hit every rail; ``opa_fused`` bit for bit on f32-exact operands at
     gemma-2b's four (M, N) and the ragged 320x100, T in {1, 17, 100, 256},
     two (lr, F) settings, with and without key words: f32 operands on its
     CUDA-core body, bf16 operands on its tensor-core body (``mma.sync``,
     the training path) and on the CUDA-core body (the same work); on
     training-like bf16 operands, both bodies within the f32 summation bound
     of the plain version, the share of elements that differ printed; the
     MᵀVM read bit for bit at
     finite ADC at tokens {1, 4, 5, 16, 256}, ADC {9, 6, ideal}, a short
     last column tile and a ragged M. Then time each at 256 tokens against
     its plain version, its library yardstick and its bound, K4 (forward
     and MᵀVM) beside the dp4a body (K5 on x_q), and K1's tensor-core body
     beside its CUDA-core body;
  5. train gemma-2b at full width: random weights from a seed, synthetic
     bigram tokens at batch 4 x 64, lr 3e-2, CRS every 2 steps, counter
     stochastic rounding; 3 steps through the adc9 plan, then 2 lossless
     steps, then one more step of each under the profiler. Every kernel's
     launches per step must be exact (K1 per operand block, all on its
     tensor-core instance and none on the CUDA-core ones, K2 per
     dense-gradient block, K3 per mapped block on CRS steps, K4 and K4ᵀ per
     adc9 read), the loss and the gradient norm finite, and the planes must
     change;
  6. (run before 5, on its own memory) hold the new kernel instances against
     their plain versions at gemma-2b's four (M, N) and a ragged 320x100, at
     tokens {1, 100, 256} (K1 also at 17): K1's device instance, both
     bodies, with each write-physics field alone and all together, K2's
     stuck instance (the embedding
     included), K4/K4ᵀ with read noise, K4/K4ᵀ at io 8 and 12 and K5 forward
     and transposed at io 8, 12 and 16, each at ADC {9, 6, ideal}; then time
     each at 256 tokens against its plain version, its library yardstick and
     its bound; then every K4 instance (forward and MᵀVM, io 8/12/16, finite
     and ideal ADC, with and without read noise) at 256 tokens beside the
     dp4a body (K5 on x_q), the ideal-device ones bit for bit against K5 on
     x = x_q·2^-10;
  7. train the same state on the non-ideal device (write noise 4e6 LSB,
     asymmetry 1.2/0.8, 2% stuck cells, read noise 1% of full scale): 2 adc9
     steps, then one adc9 step each at io 8 and 12 on the ideal device, every
     launch count exact (the device steps through K1's device instance, K2's
     stuck instance and the noisy K4/K4ᵀ), stuck digits held across the
     device step that runs no CRS, then one more step of each kind under the
     profiler;
  8. drive K5's entry point, ``mvm_sliced_batched``, over every operand
     block of the trained state, forward and transposed, at 4 x 64 tokens;
  9. drive the update's entry point, ``opa_fused_update``, with f32 operands
     over every operand block of the trained state, on the ideal and on the
     non-ideal device: f32 operands take K1's CUDA-core instances, one
     launch a block;
 10. K1's other rounding sources, ``rng_mode="grid"`` (the threefry stream
     of ``jax.random.uniform``) and ``"hw"`` (the port's Philox tile
     stream): every grid/hw instance, ideal and device, both bodies, bit for
     bit against its plain version on f32-exact operands at gemma-2b's four
     (M, N) and 320x100, T in {1, 17, 256}, grid at layer offsets 0 and 17
     (but for counted one-LSB write-noise flips), and within the f32 bound
     on training-like bf16 operands; hw rounding unbiased on the card (4
     sigma) and its plain stream uniform over 256 bins (chi-squared); each
     instance timed over one layer's 5 blocks beside the counter one; then
     on the trained state one adc9 step and one non-ideal-device step under
     each mode (18 layers, launches by instance exact), a grid step under
     the profiler, the dense leaves' grid draw timed alone, and
     ``opa_fused_update`` with f32 operands under each mode.

It prints one JSON line with the kernels' numbers, the card's
``name, power.limit`` line, and last the device JSON line. Any failure exits
non-zero. Usage: ``python3 chip_smoke.py`` (no arguments).
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores (the 32-bit elementwise rate)
SLICE_SHAPES = ((2048, 2560), (2048, 2048), (2048, 16384), (16384, 2048))  # gemma-2b reads
SLICE_READS = (("attn/wqkv", 2048, 2560), ("attn/wo", 2048, 2048), ("mlp/wi_gate", 2048, 16384),
               ("mlp/wi_up", 2048, 16384), ("mlp/wo", 16384, 2048))
EDGE_SHAPES = ((320, 2048), (256, 100))  # short last tile; ragged N
TOL = 1e-3  # |kernel - plain| <= TOL * (1 + max|plain|), as tests/test_kernels_mvm_fused.py
EMBED_SHAPE = (256000, 2048)  # gemma-2b's embedding: the dense-gradient leaf
RAGGED_SHAPE = (320, 100)
T_TRAIN = 256  # tokens per training step: batch 4 x seq 64
T_EDGE_SHAPES = ((2048, 320), (100, 256))  # MᵀVM: short last column tile; ragged M
T_OPA = (1, 17, 100, 256)  # K1's checks: one token, a ragged k-step, a ragged stage, the step's tokens


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
    shapes = [(m, n, b) for (m, n) in SLICE_SHAPES for b in (1, 4, 5, 16, 128, T_TRAIN)]
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
            if (adc is not None and not torch.equal(got, want)) or not err <= TOL * scale:
                raise AssertionError(f"kernel vs plain at M={M} N={N} B={B} adc={adc}: "
                                     f"|diff| {err} > {TOL} * {scale}")
            max_err, worst = max(max_err, err), max(worst, err / scale)
        if (M, N) in SLICE_SHAPES and B in (4, 5, 128):
            reps = 20 if B < 128 else 5
            w = dequantize_planes(planes, 30, spec)
            x_q = ref.dac_quantize(x, xf[0], 16)
            k_ms = cuda_time_ms(lambda: K.mvm_sliced_fused(planes, x, xf, spec=spec, adc_bits=9), reps)
            p_ms = cuda_time_ms(lambda: ref.mvm_sliced_fused_ref(planes, x, xf[0], spec, 16, 9), 2, 1)
            l_ms = cuda_time_ms(lambda: torch.matmul(x, w), reps)
            b_ms, b_by = bound_ms(B, M, N, spec.n_slices, 16)
            # the two bodies on the same work: the tensor-core body, and the
            # dp4a body as K5 runs it on x_q
            with tensor_core_body(K):
                mma_ms = cuda_time_ms(lambda: K.mvm_sliced_fused(planes, x, xf, spec=spec, adc_bits=9), reps)
            dp4a_ms = cuda_time_ms(lambda: K.mvm_sliced(planes, x_q, spec=spec, adc_bits=9), reps)
            timings[(M, N, B)] = (k_ms, p_ms, l_ms, b_ms, b_by, dp4a_ms, mma_ms)
            print(f"  M={M:5d} N={N:5d} B={B:3d} adc9: kernel {k_ms:.4f} ms ({'dp4a' if K.uses_dp4a(B) else 'mma'} "
                  f"body; tensor-core body {mma_ms:.4f} ms, dp4a body {dp4a_ms:.4f} ms)  plain {p_ms:.4f} ms  "
                  f"matmul {l_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})", flush=True)
            del w
        del planes, x
    for B in (4, 5, 128):
        print(f"  one layer's 5 reads at {B} tokens, adc9: "
              + "  ".join(f"{what} {sum(timings[(m, n, B)][i] for _, m, n in SLICE_READS):.4f} ms"
                          for what, i in (("kernel", 0), ("tensor-core body", 6), ("dp4a body (K5)", 5),
                                          ("plain", 1), ("matmul", 2), ("bound", 3))), flush=True)
    print(f"kernel vs plain: {len(shapes) * 3} cases, bit-identical at finite ADC, within {TOL}*(1+max|plain|) "
          f"at the ideal ADC; max |diff| {max_err} (product grid), max |diff|/(1+max|plain|) {worst}", flush=True)
    torch.cuda.empty_cache()
    return max_err, timings


class tensor_core_body:
    """Run every K4 read on the tensor-core body while inside (the
    wrapper otherwise picks the dp4a body for decode shapes)."""

    def __init__(self, K):
        self.K = K

    def __enter__(self):
        self.saved, self.K.DP4A_MAX_B = self.K.DP4A_MAX_B, 0

    def __exit__(self, *exc):
        self.K.DP4A_MAX_B = self.saved


def profile_step(torch, step, what="decode step"):
    """One more step under torch.profiler: device time by kernel and the
    device's busy share of the step's wall time (profiler on)."""
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
    print(f"profiled {what}: wall {wall_ms:.1f} ms (profiler on), device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.0f}%), {sum(r[1] for r in rows)} kernels", flush=True)
    for ms, n, key in rows[:10]:
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
    K.mvm_sliced_fused.instances.clear()
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
    instances = dict(K.mvm_sliced_fused.instances)
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
    # the prefill's B·P tokens on the tensor-core body, the decode steps' B on the dp4a body
    bodies = {K.instance_name(False, 16, dp4a=K.uses_dp4a(B * P)): 5 * layers,
              K.instance_name(False, 16, dp4a=K.uses_dp4a(B)): 5 * layers * (T - 1)}
    print(f"K4 launches by instance: {instances}", flush=True)
    if launches != want or instances != bodies:
        raise AssertionError(f"kernel launches {launches} != 5 reads x {layers} layers x {T} steps = {want}, "
                             f"or by instance {instances} != {bodies}")
    if not all_finite:
        raise AssertionError("non-finite logits on the adc9 path")
    if not gap == gap or gap == float("inf"):
        raise AssertionError(f"adc9-vs-lossless gap not finite: {gap}")
    return launches


def bound_of(nbytes: float, ops: float, ops_rate: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def random_planes(torch, spec, shape, gen):
    """int8 planes [S, *shape], each plane uniform over its whole range
    [-m_s, m_s]: saturated cells, carries out of the MSB and digit vectors
    below -canonical_limit all occur."""
    out = torch.empty((spec.n_slices, *shape), dtype=torch.int8, device="cuda")
    for s, m in enumerate(spec.plane_max):
        out[s] = torch.randint(-m, m + 1, shape, generator=gen, device="cuda", dtype=torch.int32).to(torch.int8)
    return out


def rail_updates(torch, spec, shape, gen):
    """int32 updates: a quarter small, a quarter within 1000 of
    +canonical_limit, a quarter within 1000 of -canonical_limit (both sides
    of each rail), a quarter anywhere in int32."""
    lim = spec.canonical_limit
    kind = torch.randint(0, 4, shape, generator=gen, device="cuda", dtype=torch.int32)
    near = torch.randint(-1000, 1001, shape, generator=gen, device="cuda", dtype=torch.int32)
    out = torch.randint(-2**31, 2**31, shape, generator=gen, device="cuda", dtype=torch.int64).to(torch.int32)
    out = torch.where(kind == 0, near * 4, out)
    out = torch.where(kind == 1, near + lim, out)
    return torch.where(kind == 2, near - lim, out)


def plain_by_rows(torch, fn, planes, *rest, rows=8192):
    """An elementwise plain version applied row block by row block, so the
    256000-row embedding fits beside its int32 temporaries."""
    out = torch.empty_like(planes)
    for r0 in range(0, planes.shape[1], rows):
        out[:, r0:r0 + rows] = fn(planes[:, r0:r0 + rows], *(x[r0:r0 + rows] for x in rest))
    return out


def plane_values(torch, planes):
    """sum_s plane_s 16^s in int64 (dirty planes included)."""
    acc = planes[-1].to(torch.int64)
    for s in range(planes.shape[0] - 2, -1, -1):
        acc = acc * 16 + planes[s].to(torch.int64)
    return acc


def phase_update_kernels(torch, spec, gen):
    """crs and opa_deposit bit for bit against their plain versions."""
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.crs import ref as RC
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO

    checks = 0
    for shape in (*SLICE_SHAPES, EMBED_SHAPE, RAGGED_SHAPE):
        planes = random_planes(torch, spec, shape, gen)
        want = plain_by_rows(torch, lambda p: RC.crs_ref(p, spec), planes)
        got = KC.crs(planes.clone(), spec=spec)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"crs kernel vs plain at {shape}: {bad} plane cells differ")
        del got, want
        p_q = rail_updates(torch, spec, shape, gen)
        want = plain_by_rows(torch, lambda p, q: RO.opa_deposit_ref(p, q, spec), planes, p_q)
        got = KO.opa_deposit(planes.clone(), p_q, spec=spec)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"opa_deposit kernel vs plain at {shape}: {bad} plane cells differ")
        checks += 2
        del planes, p_q, got, want
        torch.cuda.empty_cache()
    print(f"crs, opa_deposit vs plain: {checks} cases bit-identical (gemma-2b layer shapes, "
          f"embedding {EMBED_SHAPE}, ragged {RAGGED_SHAPE}; every rail hit)", flush=True)


def exact_operands(torch, T, M, N, dtype, gen):
    """Operands whose f32 contraction is exact in any order: small integers
    on a power-of-two grid (|partial sum| <= 16 on a 2^-8 grid)."""
    x = torch.randint(-4, 5, (T, M), generator=gen, device="cuda").to(torch.float32) * 0.125
    dh = torch.randint(-4, 5, (T, N), generator=gen, device="cuda").to(torch.float32) * 2.0**-5
    return x.to(dtype), dh.to(dtype)


def update_shifts(torch, got, want, planes, p_q, stuck, spec, reach):
    """By how many grid LSB the kernel's update differs from the plain
    version's, per element: 0 where their planes agree, else the k of least
    |k| <= reach whose deposit of the plain update ``p_q + k`` into the old
    ``planes`` (stuck digits kept) gives the kernel's planes. The deposit
    saturates each plane, so a one-LSB change of an update can move the
    plane value by far more; the update is what the f32 sums decide.
    Returns int32 [M, N]; raises where no such k exists."""
    from repro_torch.core.opa import opa_batched

    shift = torch.zeros(p_q.shape, dtype=torch.int32, device=p_q.device)
    bad = (got != want).any(0)
    if not bool(bad.any()):
        return shift
    old, g, q = planes[:, bad], got[:, bad], p_q[bad].to(torch.int64)
    k_of = torch.zeros_like(q, dtype=torch.int32)
    found = torch.zeros_like(q, dtype=torch.bool)
    for k in sorted(range(-reach, reach + 1), key=abs)[1:]:
        alt = opa_batched(old, (q + k).clamp(-2**31, 2**31 - 1).to(torch.int32), spec)
        if stuck is not None:
            alt = torch.where(stuck[:, bad], old, alt)
        hit = ~found & (alt == g).all(0)
        k_of[hit], found = k, found | hit
    if not bool(found.all()):
        raise AssertionError(f"{int((~found).sum())} elements differ from the plain version by more than "
                             f"{reach} grid LSB")
    shift[bad] = k_of
    return shift


# the card tests' cap on write-noise flips: a share of a block's updates
FLIP_SHARE = 1e-3


def noise_flips(torch, got, want, planes, p_q, stuck, spec, what):
    """How many updates the last bit of the write noise moved by one grid
    LSB (update_shifts at reach 1); raises where more than FLIP_SHARE of
    the block's updates moved."""
    n = int((update_shifts(torch, got, want, planes, p_q, stuck, spec, reach=1) != 0).sum())
    if n > FLIP_SHARE * p_q.numel():
        raise AssertionError(f"{what}: {n} of {p_q.numel()} updates moved by one grid LSB, more than a share "
                             f"of {FLIP_SHARE}")
    return n


def phase_opa_fused(torch, spec, gen):
    """opa_fused bit for bit on f32-exact operands, each body on the dtypes
    it takes (the tensor-core body on bf16, the CUDA-core body on f32 and on
    the same bf16 work); within the f32 bound on training-like ones.
    Returns the max |plane value| difference seen on the exact operands, by
    body."""
    from repro_torch.core.fixed_point import choose_frac_bits, quantize
    from repro_torch.core.slicing import slice_weights
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO

    max_err, checks = {"mma": 0, "fma": 0}, dict.fromkeys(("fma f32", "mma bf16", "fma bf16"), 0)
    cases = [(m, n, t) for (m, n) in (*SLICE_SHAPES, RAGGED_SHAPE) for t in T_OPA]
    for i, (M, N, T) in enumerate(cases):
        planes = random_planes(torch, spec, (M, N), gen)
        for dtype, bodies in ((torch.float32, ("fma",)), (torch.bfloat16, ("mma", "fma"))):
            x, dh = exact_operands(torch, T, M, N, dtype, gen)
            # (lr, F): fractional updates where the draw decides; updates past the rails
            for lr, F in ((2.0**-4, 8), (4.0, 28)):
                frac = torch.tensor([F], dtype=torch.int32, device="cuda")
                for words in (None, (0x1234567 + i, -0x7654321 - i)):
                    want = RO.opa_fused_ref(planes, x, dh, lr, frac[0], spec, words)
                    for body in bodies:
                        got = KO.opa_fused(planes.clone(), x, dh, lr, frac, spec=spec, key_words=words, body=body)
                        torch.cuda.synchronize()
                        err = int((plane_values(torch, got) - plane_values(torch, want)).abs().max())
                        if not torch.equal(got, want):
                            raise AssertionError(f"opa_fused {body} body vs plain at M={M} N={N} T={T} {dtype} "
                                                 f"lr={lr} F={F} key={words is not None}: max |value diff| {err}")
                        max_err[body] = max(max_err[body], err)
                        checks[f"{body} {'f32' if dtype == torch.float32 else 'bf16'}"] += 1
        del planes
    print(f"opa_fused vs plain on f32-exact operands (gemma-2b's four (M, N) and {RAGGED_SHAPE}, T {T_OPA}): "
          "bit-identical in every case, by body and operand dtype: "
          + ", ".join(f"{k} {v}" for k, v in checks.items()), flush=True)

    # training-like operands on canonical planes: the f32 sums are not exact,
    # so the two contraction orders may round some updates differently, by
    # at most one grid LSB beyond the f32 summation error of the two orders
    # (each within T·2^-24·sum_t |x||dh| of the exact sum). Each update is
    # held to that bound (update_shifts), not the plane value, which a
    # saturated plane can move by far more than the update.
    for M, N in SLICE_SHAPES:
        w = torch.randn((M, N), generator=gen, device="cuda") / M**0.5
        f = choose_frac_bits(w, margin_bits=2)
        planes = slice_weights(quantize(w, f), spec)
        x = torch.randn((T_TRAIN, M), generator=gen, device="cuda").to(torch.bfloat16)
        dh = (torch.randn((T_TRAIN, N), generator=gen, device="cuda") * 1e-3).to(torch.bfloat16)
        want = RO.opa_fused_ref(planes, x, dh, 3e-2, f, spec, (11, 22))
        moved = (plane_values(torch, want) != plane_values(torch, planes)).float().mean()
        scale = 3e-2 * 2.0 ** int(f)
        p_q = RO.write_rows((x.float().T @ dh.float()) * (-RO._lr32(3e-2) * 2.0 ** int(f)), None, 0, None, (11, 22))
        allowed = 1.0 + scale * 2 * T_TRAIN * 2.0**-24 * (x.float().abs().T @ dh.float().abs())
        line = []
        for body, what in (("mma", "tensor-core"), ("fma", "CUDA-core")):
            got = KO.opa_fused(planes.clone(), x, dh, 3e-2, f.reshape(1), spec=spec, key_words=(11, 22), body=body)
            k = update_shifts(torch, got, want, planes, p_q, None, spec, reach=16).abs()
            share, worst = float((k > 0).float().mean()), int(k.max())
            line.append(f"{what} body {share:.3e} of updates differ, max {worst} grid LSB "
                        f"(bound at least {float(allowed.min()):.1f})")
            if bool((k > allowed).any()):
                raise AssertionError(f"opa_fused {what} body vs plain on training-like operands at M={M} N={N}: "
                                     f"an update {worst} LSB off, beyond the f32 bound")
            del got, k
        print(f"  opa_fused M={M:5d} N={N:5d} T={T_TRAIN} bf16 training-like vs plain: " + "; ".join(line)
              + f" ({float(moved):.3f} of elements updated)", flush=True)
        del w, planes, x, dh, want, p_q, allowed
    torch.cuda.empty_cache()
    return max_err


def phase_transpose(torch, K, ref, fp, spec, gen):
    """The MᵀVM read against its plain version; bit for bit at finite ADC."""
    max_err, checks = 0.0, 0
    cases = [(m, n, b) for (m, n) in SLICE_SHAPES for b in (1, 4, 5, 16, T_TRAIN)]
    cases += [(m, n, b) for (m, n) in T_EDGE_SHAPES for b in (5, 16)]
    for M, N, B in cases:
        planes = torch.randint(-8, 8, (spec.n_slices, M, N), generator=gen, device="cuda", dtype=torch.int8)
        dy = torch.randn((B, N), generator=gen, device="cuda") * 0.7
        xf = fp.choose_frac_bits(dy, word_bits=16, margin_bits=1, clip_to_word=False).reshape(1)
        for adc in (9, 6, None):
            got = K.mvm_sliced_fused(planes, dy, xf, spec=spec, adc_bits=adc, transpose=True)
            want = ref.mvm_sliced_fused_ref(planes, dy, xf[0], spec, 16, adc, transpose=True)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = 1.0 + float(want.abs().max())
            if (adc is not None and not torch.equal(got, want)) or not err <= TOL * scale:
                raise AssertionError(f"MᵀVM kernel vs plain at M={M} N={N} B={B} adc={adc}: |diff| {err}")
            max_err, checks = max(max_err, err), checks + 1
        del planes, dy
    torch.cuda.empty_cache()
    print(f"MᵀVM kernel vs plain: {checks} cases, bit-identical at finite ADC; max |diff| {max_err}", flush=True)
    return max_err


def time_update_kernels(torch, K, ref, spec, gen):
    """One layer's work at the training step's 256 tokens (the five operand
    leaves) for opa_fused, the MᵀVM read and crs, and the embedding's deposit
    for opa_deposit: kernel, plain version, library yardstick and bound."""
    from repro_torch.core.slicing import dequantize_planes
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.crs import ref as RC
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO

    S, T = spec.n_slices, T_TRAIN
    rows = {"opa_fused": [], "opa_fused_fma": [], "mvm_sliced_fused_transpose": [], "mvm_sliced_fused_256": [],
            "crs": []}
    for name, M, N in SLICE_READS:
        planes = torch.randint(-8, 8, (S, M, N), generator=gen, device="cuda", dtype=torch.int8)
        frac = torch.tensor([30], dtype=torch.int32, device="cuda")
        x = torch.randn((T, M), generator=gen, device="cuda").to(torch.bfloat16)
        dh = (torch.randn((T, N), generator=gen, device="cuda") * 1e-3).to(torch.bfloat16)
        k = cuda_time_ms(lambda: KO.opa_fused(planes, x, dh, 3e-2, frac, spec=spec, key_words=(1, 2)), 10)
        # the CUDA-core body on the same bf16 work: the same-run yardstick
        k_fma = cuda_time_ms(lambda: KO.opa_fused(planes, x, dh, 3e-2, frac, spec=spec, key_words=(1, 2),
                                                  body="fma"), 10)
        p = cuda_time_ms(lambda: RO.opa_fused_ref(planes, x, dh, 3e-2, frac[0], spec, (1, 2)), 3, 1)
        lib = cuda_time_ms(lambda: torch.matmul(x.t(), dh), 10)
        b = bound_of(2 * S * M * N + 2 * T * (M + N) + 4, 2.0 * T * M * N, BF16_FLOPS_PER_S)
        rows["opa_fused"].append((k, p, lib, *b, k_fma))
        rows["opa_fused_fma"].append((k_fma, p, lib, *b))
        xf = torch.tensor([10], dtype=torch.int32, device="cuda")
        w = dequantize_planes(planes, 30, spec)
        b = bound_of(S * M * N + 4 * T * (M + N) + 4, 2.0 * T * M * N * S * 15, INT8_OPS_PER_S)
        # K4ᵀ (the training step's dx read) and K4 forward at the step's 256
        # tokens; the dp4a body's time is K5's on x_q, the same work
        for key, transpose in (("mvm_sliced_fused_transpose", True), ("mvm_sliced_fused_256", False)):
            dy = torch.randn((T, N if transpose else M), generator=gen, device="cuda")
            x_q = ref.dac_quantize(dy, 10, 16)
            k = cuda_time_ms(lambda: K.mvm_sliced_fused(planes, dy, xf, spec=spec, adc_bits=9, transpose=transpose),
                             5)
            p = cuda_time_ms(lambda: ref.mvm_sliced_fused_ref(planes, dy, xf[0], spec, 16, 9, transpose=transpose),
                             2, 1)
            lib = cuda_time_ms(lambda: torch.matmul(dy, w.T if transpose else w), 10)
            d = cuda_time_ms(lambda: K.mvm_sliced(planes, x_q, spec=spec, adc_bits=9, transpose=transpose), 3)
            rows[key].append((k, p, lib, *b, d))
        k = cuda_time_ms(lambda: KC.crs(planes, spec=spec), 10)
        p = cuda_time_ms(lambda: RC.crs_ref(planes, spec), 3, 1)
        # ~12 32-bit operations a plane cell: carry, digit, compare, rail select
        b = bound_of(2 * S * M * N, 12.0 * S * M * N, CUDA_CORE_OPS_PER_S)
        rows["crs"].append((k, p, None, *b))
        for key, r in rows.items():
            k, p, lib, b_ms, b_by, *other = r[-1]
            lib = "-" if lib is None else f"{lib:.4f}"
            other = f"  {other_body(key)[1]} {other[0]:.4f} ms" if other else ""
            print(f"  {key:27s} {name:11s} M={M:5d} N={N:5d} T={T}: kernel {k:.4f} ms{other}  plain {p:.4f} ms  "
                  f"library {lib} ms  bound {b_ms:.4f} ms ({b_by})", flush=True)
        del planes, x, dh, dy, w, x_q
    V, D = EMBED_SHAPE
    planes = torch.randint(-8, 8, (S, V, D), generator=gen, device="cuda", dtype=torch.int8)
    p_q = torch.randint(-2**20, 2**20, (V, D), generator=gen, device="cuda", dtype=torch.int32)
    k = cuda_time_ms(lambda: KO.opa_deposit(planes, p_q, spec=spec), 5)
    p = cuda_time_ms(lambda: plain_by_rows(torch, lambda a, q: RO.opa_deposit_ref(a, q, spec), planes, p_q), 1, 1)
    # ~8 32-bit operations a plane cell: digit, add, clip, carry
    b = bound_of((4 + 2 * S) * V * D, 8.0 * S * V * D, CUDA_CORE_OPS_PER_S)
    print(f"  opa_deposit embedding {V}x{D}: kernel {k:.4f} ms  plain {p:.4f} ms  bound {b[0]:.4f} ms ({b[1]})",
          flush=True)
    del planes, p_q
    torch.cuda.empty_cache()

    out = {key: layer_total(rs, key) for key, rs in rows.items()}
    out["opa_deposit"] = {"ms": k, "plain_ms": p, "library_ms": None, "bound_ms": b[0], "bound_by": b[1]}
    for key in ("mvm_sliced_fused_transpose", "mvm_sliced_fused_256", "opa_fused"):
        print_layer_total(key, out[key], T)
    return out


def other_body(key):
    """The other body a kernel's rows time on the same work: its key in the
    kernels line and its name (K1: the CUDA-core body; K4: the dp4a body)."""
    return ("fma_ms", "CUDA-core body") if key.startswith("opa_fused") else ("dp4a_ms", "dp4a body")


def layer_total(rs, key):
    """One layer's rows (ms, plain, library, bound, bound_by[, other body])
    summed into a kernels-line entry."""
    lib = [r[2] for r in rs]
    out = {"ms": sum(r[0] for r in rs), "plain_ms": sum(r[1] for r in rs),
           "library_ms": None if None in lib else sum(lib), "bound_ms": sum(r[3] for r in rs),
           "bound_by": "bytes" if all(r[4] == "bytes" for r in rs) else "operations"}
    if len(rs[0]) > 5:
        out[other_body(key)[0]] = sum(r[5] for r in rs)
    return out


def print_layer_total(key, t, T):
    col, what = other_body(key)
    print(f"  {key}: one layer's 5 blocks at {T} tokens: kernel {t['ms']:.4f} ms, {what} {t[col]:.4f} ms "
          f"({t[col] / t['ms']:.2f}x), bound {t['bound_ms']:.4f} ms, library {t['library_ms']:.4f} ms", flush=True)


def snapshot(torch, sliced):
    """A few plane rows of every mapped leaf, copied, to show the update
    moved them."""
    from repro_torch import tree

    return {path: s.planes[..., :4, :].clone() for path, s in tree.leaves_with_path(sliced) if s is not None}


def phase_train(torch, gen):
    """gemma-2b at full width: 3 adc9 steps, then 2 lossless steps, with
    every kernel's launches per step checked. Returns the launch totals, the
    state, the data and the blocks a step updates by gradient path."""
    import dataclasses

    from repro_torch import configs, tree
    from repro_torch import plan as planlib
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.sliced_mvm import kernel as KM
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.optim import PantherConfig, panther
    from repro_torch.optim.schedules import constant
    from repro_torch.train.step import make_train_step, param_shapes, train_state_init

    cfg = configs.get("gemma_2b")
    L = cfg.n_layers
    opt_cfg = PantherConfig(crs_every=2, stochastic_round=True)
    t0 = time.perf_counter()
    state = train_state_init(cfg, opt_cfg, gen, device="cuda")
    torch.cuda.synchronize()
    print(f"train state: {L} layers, init+slice {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated", flush=True)
    ds = SyntheticLMDataset(cfg.vocab, 64, 4, seed=0, device="cuda")
    adc9 = dataclasses.replace(configs.fidelity_presets()["adc9"], spec=opt_cfg.spec)
    steps = {
        "adc9": make_train_step(cfg, opt_cfg, constant(3e-2),
                                plan_rules=planlib.default_rules(opt_cfg, fidelity=adc9)),
        "lossless": make_train_step(cfg, opt_cfg, constant(3e-2)),
    }
    # blocks a step updates: one per layer of each mapped leaf, by gradient
    # path. The [18, 2048] norm-scale stacks are matrices to the default
    # plan (as to the reference's), so they map, with dense gradients.
    plan = planlib.resolve_plan(param_shapes(state.digital, state.sliced), planlib.default_rules(opt_cfg))
    blocks = {"operand": 0, "dense": 0}
    for (path, sl), (_, pl) in zip(tree.leaves_with_path(state.sliced), tree.leaves_with_path(plan)):
        if sl is not None:
            blocks[pl.grad] += math.prod(sl.planes.shape[1:-2])
    print(f"mapped blocks per step: {blocks['operand']} operand, {blocks['dense']} dense ("
          + ", ".join("/".join(map(str, path)) for (path, sl), (_, pl)
                      in zip(tree.leaves_with_path(state.sliced), tree.leaves_with_path(plan))
                      if sl is not None and pl.grad == "dense") + ")", flush=True)
    if blocks["operand"] != 5 * L:
        raise AssertionError(f"{blocks['operand']} operand blocks, not 5 x {L} layers")
    counters = {"opa_fused": (KO.opa_fused, "launches"), "opa_deposit": (KO.opa_deposit, "launches"),
                "crs": (KC.crs, "launches"), "mvm_sliced_fused": (KM.mvm_sliced_fused, "launches"),
                "mvm_sliced_fused_transpose": (KM.mvm_sliced_fused, "transpose_launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    totals = dict.fromkeys(counters, 0)
    before = snapshot(torch, state.sliced)
    torch.cuda.reset_peak_memory_stats()
    for step, mode in enumerate(("adc9", "adc9", "adc9", "lossless", "lossless")):
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        KO.opa_fused.instances.clear()
        batch = ds.batch(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = steps[mode](state, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        got = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        crs_step = step % opt_cfg.crs_every == opt_cfg.crs_every - 1
        want = {"opa_fused": blocks["operand"], "opa_deposit": blocks["dense"],
                "crs": blocks["operand"] + blocks["dense"] if crs_step else 0,
                "mvm_sliced_fused": 5 * L if mode == "adc9" else 0,
                "mvm_sliced_fused_transpose": 5 * L if mode == "adc9" else 0}
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        print(f"step {step} ({mode:8s}): {ms:.1f} ms, {4 * 64 / ms * 1e3:.0f} tokens/s, loss {loss:.4f}, "
              f"grad_norm {gnorm:.4f}, launches {got}", flush=True)
        if got != want:
            raise AssertionError(f"step {step} ({mode}): launches {got} != {want}")
        # bf16 operands: every block on K1's tensor-core instance, none on the CUDA-core ones
        if dict(KO.opa_fused.instances) != {"ideal": blocks["operand"]}:
            raise AssertionError(f"step {step} ({mode}): K1 instances {dict(KO.opa_fused.instances)}")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"step {step}: loss {loss} or grad_norm {gnorm} not finite")
        for k in totals:
            totals[k] += got[k]
    peak = torch.cuda.max_memory_allocated() / 2**30
    after = snapshot(torch, state.sliced)
    moved = {path: float((after[path] != before[path]).float().mean()) for path in before}
    print(f"peak memory over the 5 steps: {peak:.1f} GiB; share of sampled plane cells changed per leaf: "
          + ", ".join(f"{'/'.join(map(str, p))} {v:.3f}" for p, v in moved.items()), flush=True)
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"planes did not change: {moved}")
    for step, mode in ((5, "adc9"), (6, "lossless")):  # where a step's time goes
        out = {}

        def one_more():
            out["state"], _ = steps[mode](state, ds.batch(step))

        profile_step(torch, one_more, f"{mode} train step")
        state = out["state"]
    rep = panther.saturation_report(state.sliced, opt_cfg)
    for path, sat in tree.leaves_with_path(rep):
        if sat is not None:
            print(f"  saturation {'/'.join(map(str, path)):24s} per plane (LSB first): "
                  + " ".join(f"{v:.2e}" for v in sat.tolist()))
    return totals, state, ds, blocks


# ------------------ device physics, io widths 8/12, K5 ------------------------

# the non-ideal device of the device phase: write noise and asymmetry are the
# middle setting of the reference's fig9 device sweep, stuck cells and read
# noise those of its test_train_step_threads_device_plan
DEVICE = dict(write_noise=4e6, asym_up=1.2, asym_down=0.8, stuck_frac=0.02, stuck_seed=3, read_noise=0.01)
PHYSICS = {
    "asym": dict(asym_up=1.2, asym_down=0.8),
    "noise": dict(write_noise=4e6),
    "stuck": dict(stuck_frac=0.02, stuck_seed=3),
    "all": {k: v for k, v in DEVICE.items() if k != "read_noise"},
}
T_CHECK = (1, 100, 256)  # token counts of the new kernels' checks
# 32-bit CUDA-core operations a cell that the write physics add to K1's
# finalize (two hashes and a Box-Muller for the noise, S = 8 hashes for the
# stuck mask), and that the stuck mask adds to K2 per plane cell (a hash and
# a compare)
DEVICE_OPS_PER_CELL = 150
STUCK_OPS_PER_PLANE_CELL = 13



def phase_device_kernels(torch, spec, gen):
    """The new kernel instances against their plain versions: K1's device
    instance and K2's stuck instance (bit for bit but for counted one-LSB
    write-noise flips), the noisy K4/K4ᵀ reads, K4/K4ᵀ at io 8 and 12, and K5
    forward and transposed (bit for bit at finite ADC). Returns the max
    |diff| of each."""
    from repro_torch.core.fixed_point import choose_frac_bits, quantize
    from repro_torch.core.slicing import slice_weights
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.kernels.sliced_mvm import ref
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO
    from repro_torch.models.common import DeviceModel

    err = {}
    # K1 device instance, both bodies: bf16 f32-exact operands on canonical planes
    flips, cases = {"mma": 0, "fma": 0}, 0
    for M, N in (*SLICE_SHAPES, RAGGED_SHAPE):
        w = torch.randn((M, N), generator=gen, device="cuda") / M**0.5
        f = choose_frac_bits(w, margin_bits=2)
        planes = slice_weights(quantize(w, f), spec)
        frac = f.reshape(1)
        for T in T_OPA:
            x, dh = exact_operands(torch, T, M, N, torch.bfloat16, gen)
            for name, kw in PHYSICS.items():
                dev = DeviceModel(**kw)
                for words in (None, (0x1234567 + T, -0x7654321)):
                    want = RO.opa_fused_ref(planes, x, dh, 3e-2, f, spec, words, dev, (77 + T, -99))
                    for body in ("mma", "fma"):
                        got = KO.opa_fused(planes.clone(), x, dh, 3e-2, frac, spec=spec, key_words=words, dev=dev,
                                           noise_words=(77 + T, -99), body=body)
                        torch.cuda.synchronize()
                        if not torch.equal(got, want):
                            if dev.write_noise == 0.0:
                                raise AssertionError(f"opa_fused device instance ({name}), {body} body, vs plain "
                                                     f"at M={M} N={N} T={T}")
                            acc = x.float().T @ dh.float()
                            p_q = RO.write_rows(acc * (-RO._lr32(3e-2) * 2.0 ** int(f)), dev, 0, (77 + T, -99),
                                                words)
                            stuck = RO.stuck_rows(dev, spec, 0, M, N, "cuda") if dev.stuck_frac > 0 else None
                            # a rounding flip of the write noise's last bit
                            flips[body] += noise_flips(torch, got, want, planes, p_q, stuck, spec,
                                                       f"opa_fused device instance ({name}), {body} body, "
                                                       f"at M={M} N={N} T={T}")
                        cases += 1
        del w, planes
    err["opa_fused_device"], err["opa_fused_device_fma"] = float(flips["mma"]), float(flips["fma"])
    print(f"opa_fused device instance vs plain: {cases} cases (tensor-core and CUDA-core bodies, gemma-2b's four "
          f"(M, N) and {RAGGED_SHAPE}, T {T_OPA}, physics {list(PHYSICS)}, with and without key words); "
          f"elements that differ, each by one grid LSB: {flips['mma']} (tensor-core), {flips['fma']} "
          "(CUDA-core)", flush=True)

    # K2 stuck instance: bit for bit, the embedding included
    dev = DeviceModel(**PHYSICS["stuck"])
    for shape in (*SLICE_SHAPES, EMBED_SHAPE, RAGGED_SHAPE, (18, 2048)):
        planes = random_planes(torch, spec, shape, gen)
        p_q = rail_updates(torch, spec, shape, gen)
        want = torch.empty_like(planes)
        rows = 8192
        for r0 in range(0, shape[0], rows):
            blk, q = planes[:, r0:r0 + rows], p_q[r0:r0 + rows]
            stuck = RO.stuck_rows(dev, spec, r0, blk.shape[1], shape[1], "cuda")
            want[:, r0:r0 + rows] = torch.where(stuck, blk, RO.opa_deposit_ref(blk, q, spec))
        got = KO.opa_deposit(planes.clone(), p_q, spec=spec, stuck=dev)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"opa_deposit stuck instance vs plain at {shape}: "
                                 f"{int((got != want).sum())} plane cells differ")
        del planes, p_q, want, got
        torch.cuda.empty_cache()
    err["opa_deposit_stuck"] = 0.0
    print("opa_deposit stuck instance vs plain: bit-identical at gemma-2b's four (M, N), the embedding, "
          f"{RAGGED_SHAPE} and (18, 2048)", flush=True)

    # the reads: K4/K4ᵀ with read noise (io 16), at io 8 and 12, and K5 at
    # io 8, 12 and 16 (one entry for its three widths)
    noisy = DeviceModel(read_noise=DEVICE["read_noise"], stuck_seed=DEVICE["stuck_seed"])
    reads = [("mvm_sliced_fused{}_read_noise", True, 16, noisy), ("mvm_sliced_fused{}_io8", True, 8, None),
             ("mvm_sliced_fused{}_io12", True, 12, None), *(("mvm_sliced{}", False, io, None) for io in (8, 12, 16))]
    adcs = (9, 6, None)
    for name, fused, io, dev in reads:
        for transpose in (False, True):
            key = name.format("_transpose" if transpose else "")
            worst, n_diff, n_cases = err.get(key, 0.0), 0, 0
            for M, N in (*SLICE_SHAPES, RAGGED_SHAPE):
                planes = torch.randint(-8, 8, (spec.n_slices, M, N), generator=gen, device="cuda", dtype=torch.int8)
                for B in T_CHECK:
                    x = torch.randn((B, N if transpose else M), generator=gen, device="cuda")
                    xf = choose_frac_bits(x, word_bits=io, margin_bits=1, clip_to_word=False).reshape(1)
                    x_q = ref.dac_quantize(x, xf[0], io)
                    for adc in adcs:
                        if fused:
                            got = K.mvm_sliced_fused(planes, x, xf, spec=spec, io_bits=io, adc_bits=adc,
                                                     transpose=transpose, dev=dev)
                            want = ref.mvm_sliced_fused_ref(planes, x, xf[0], spec, io, adc, transpose=transpose,
                                                            device=dev)
                        else:
                            got = K.mvm_sliced(planes, x_q, spec=spec, io_bits=io, adc_bits=adc, transpose=transpose)
                            want = ref.mvm_sliced_ref(planes, x_q, spec, io, adc, transpose=transpose)
                        torch.cuda.synchronize()
                        d = float((got - want).abs().max())
                        worst = max(worst, d)
                        if not d <= TOL * (1.0 + float(want.abs().max())):
                            raise AssertionError(f"{key} io{io} vs plain at M={M} N={N} B={B} adc={adc}: |diff| {d}")
                        if adc is not None and not torch.equal(got, want):
                            # only an offset's last bit may move a column current
                            # across an ADC rounding boundary: one code of one
                            # (slice, bit cycle), at most the top one's weight
                            top = 2.0 ** (7 + max(spec.bits_lsb_first) - adc + 4 * (spec.n_slices - 1) + io - 2)
                            if dev is None or d > top:
                                raise AssertionError(f"{key} io{io} vs plain at M={M} N={N} B={B} adc={adc}: "
                                                     f"not bit-identical, max |diff| {d}")
                            n_diff += int((got != want).sum())
                        n_cases += 1
                del planes
            err[key] = worst
            print(f"{key} io{io} vs plain: {n_cases} cases (gemma-2b's four (M, N) and {RAGGED_SHAPE}, tokens "
                  f"{T_CHECK}, ADC {adcs}); bit-identical at finite ADC but for {n_diff} outputs one ADC code "
                  f"apart; max |diff| {worst}", flush=True)
    torch.cuda.empty_cache()
    return err


def time_device_kernels(torch, spec, gen):
    """One layer's work at 256 tokens for each new instance, and the
    embedding's stuck deposit: kernel, plain version, library yardstick and
    bound, as in time_update_kernels."""
    from repro_torch.core.slicing import dequantize_planes
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.kernels.sliced_mvm import ref
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO
    from repro_torch.models.common import DeviceModel

    S, T = spec.n_slices, T_TRAIN
    dev = DeviceModel(**DEVICE)
    rows = {}

    def add(key, *row):
        rows.setdefault(key, []).append(row)

    for name, M, N in SLICE_READS:
        planes = torch.randint(-8, 8, (S, M, N), generator=gen, device="cuda", dtype=torch.int8)
        frac = torch.tensor([30], dtype=torch.int32, device="cuda")
        x = torch.randn((T, M), generator=gen, device="cuda").to(torch.bfloat16)
        dh = (torch.randn((T, N), generator=gen, device="cuda") * 1e-3).to(torch.bfloat16)
        k = cuda_time_ms(lambda: KO.opa_fused(planes, x, dh, 3e-2, frac, spec=spec, key_words=(1, 2), dev=dev,
                                              noise_words=(3, 4)), 10)
        k_fma = cuda_time_ms(lambda: KO.opa_fused(planes, x, dh, 3e-2, frac, spec=spec, key_words=(1, 2), dev=dev,
                                                  noise_words=(3, 4), body="fma"), 10)
        p = cuda_time_ms(lambda: RO.opa_fused_ref(planes, x, dh, 3e-2, frac[0], spec, (1, 2), dev, (3, 4)), 3, 1)
        lib = cuda_time_ms(lambda: torch.matmul(x.t(), dh), 10)
        # bf16 products on the tensor cores, the physics on the CUDA cores
        t_bytes = (2 * S * M * N + 2 * T * (M + N) + 4) / HBM_BYTES_PER_S
        t_ops = 2.0 * T * M * N / BF16_FLOPS_PER_S + DEVICE_OPS_PER_CELL * M * N / CUDA_CORE_OPS_PER_S
        b = (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
        add("opa_fused_device", k, p, lib, *b, k_fma)
        add("opa_fused_device_fma", k_fma, p, lib, *b)
        w = dequantize_planes(planes, 30, spec)
        for transpose in (False, True):
            xin = torch.randn((T, N if transpose else M), generator=gen, device="cuda")
            xf = torch.tensor([10], dtype=torch.int32, device="cuda")
            x_q = ref.dac_quantize(xin, 10, 16)
            lib = cuda_time_ms(lambda: torch.matmul(xin, w.T if transpose else w), 10)
            lib_q = cuda_time_ms(lambda: torch.matmul(x_q.float(), w.T if transpose else w), 10)
            tag = "_transpose" if transpose else ""
            # every K4 instance beside the dp4a body (K5 on x_q, the same work
            # without the DAC and the read offsets); on x = x_q·2^-10, which
            # the DAC maps back to x_q, the ideal-device instances equal K5
            for io in (8, 12, 16):
                xq_io = ref.dac_quantize(xin, 10, io)
                x_io = xq_io.float() * 2.0**-10
                for adc in (9, None):
                    d_ms = cuda_time_ms(lambda: K.mvm_sliced(planes, xq_io, spec=spec, io_bits=io, adc_bits=adc,
                                                             transpose=transpose), 3)
                    for d in (None, dev):
                        got = K.mvm_sliced_fused(planes, x_io, xf, spec=spec, io_bits=io, adc_bits=adc,
                                                 transpose=transpose, dev=d)
                        if d is None and not torch.equal(
                                got, K.mvm_sliced(planes, xq_io, spec=spec, io_bits=io, adc_bits=adc,
                                                  transpose=transpose)):
                            raise AssertionError(f"K4{tag} io{io} adc{adc} vs the dp4a body (K5) at M={M} N={N}: "
                                                 "not bit-identical")
                        k_ms = cuda_time_ms(lambda: K.mvm_sliced_fused(planes, x_io, xf, spec=spec, io_bits=io,
                                                                       adc_bits=adc, transpose=transpose, dev=d), 3)
                        add((transpose, io, adc, d is not None), k_ms, d_ms)
                del xq_io, x_io
            for key, io, d in ((f"mvm_sliced_fused{tag}_read_noise", 16, dev), (f"mvm_sliced_fused{tag}_io8", 8, None),
                               (f"mvm_sliced_fused{tag}_io12", 12, None)):
                k = cuda_time_ms(lambda: K.mvm_sliced_fused(planes, xin, xf, spec=spec, io_bits=io, adc_bits=9,
                                                            transpose=transpose, dev=d), 3)
                p = cuda_time_ms(lambda: ref.mvm_sliced_fused_ref(planes, xin, xf[0], spec, io, 9,
                                                                  transpose=transpose, device=d), 2, 1)
                add(key, k, p, lib, *bound_of(S * M * N + 4 * T * (M + N) + 4, 2.0 * T * M * N * S * (io - 1),
                                              INT8_OPS_PER_S), rows[(transpose, io, 9, False)][-1][1])
            k = cuda_time_ms(lambda: K.mvm_sliced(planes, x_q, spec=spec, adc_bits=9, transpose=transpose), 3)
            p = cuda_time_ms(lambda: ref.mvm_sliced_ref(planes, x_q, spec, 16, 9, transpose=transpose), 2, 1)
            add(f"mvm_sliced{tag}", k, p, lib_q, *bound_of(S * M * N + 4 * T * (M + N), 2.0 * T * M * N * S * 15,
                                                          INT8_OPS_PER_S))
        for key in rows:
            if not isinstance(key, str):
                continue
            k, p, lib, b_ms, b_by, *other = rows[key][-1]
            other = f"  {other_body(key)[1]} {other[0]:.4f} ms" if other else ""
            print(f"  {key:37s} {name:11s} M={M:5d} N={N:5d} T={T}: kernel {k:.4f} ms{other}  plain {p:.4f} ms  "
                  f"library {lib:.4f} ms  bound {b_ms:.4f} ms ({b_by})", flush=True)
        del planes, x, dh, w
    V, D = EMBED_SHAPE
    planes = torch.randint(-8, 8, (S, V, D), generator=gen, device="cuda", dtype=torch.int8)
    p_q = torch.randint(-2**20, 2**20, (V, D), generator=gen, device="cuda", dtype=torch.int32)
    k = cuda_time_ms(lambda: KO.opa_deposit(planes, p_q, spec=spec, stuck=dev), 5)

    def plain():
        for r0 in range(0, V, 8192):
            blk = planes[:, r0:r0 + 8192]
            torch.where(RO.stuck_rows(dev, spec, r0, blk.shape[1], D, "cuda"), blk,
                        RO.opa_deposit_ref(blk, p_q[r0:r0 + 8192], spec))

    p = cuda_time_ms(plain, 1, 1)
    b = bound_of((4 + 2 * S) * V * D, (8.0 + STUCK_OPS_PER_PLANE_CELL) * S * V * D, CUDA_CORE_OPS_PER_S)
    print(f"  opa_deposit_stuck embedding {V}x{D}: kernel {k:.4f} ms  plain {p:.4f} ms  bound {b[0]:.4f} ms "
          f"({b[1]})", flush=True)
    del planes, p_q
    torch.cuda.empty_cache()

    print(f"every K4 instance, one layer's 5 reads at {T} tokens (tensor-core body; the dp4a body is K5's time "
          "on x_q; bit-identical to K5 on the ideal device):", flush=True)
    for transpose in (False, True):
        for io in (8, 12, 16):
            for adc in (9, None):
                for noisy in (False, True):
                    k_ms, d_ms = instance_time(rows, transpose, io, adc, noisy)
                    print(f"  K4{'ᵀ' if transpose else ' '} io{io:2d} adc {adc if adc else 'ideal':5} "
                          f"{'read noise' if noisy else 'ideal dev.':10s}: {k_ms:9.4f} ms   dp4a body {d_ms:9.4f} ms   "
                          f"{d_ms / k_ms:5.2f}x", flush=True)
    out = {key: layer_total(rs, key) for key, rs in rows.items() if isinstance(key, str)}
    out["opa_deposit_stuck"] = {"ms": k, "plain_ms": p, "library_ms": None, "bound_ms": b[0], "bound_by": b[1]}
    print_layer_total("opa_fused_device", out["opa_fused_device"], T)
    return out


def instance_time(rows, transpose, io, adc, noisy):
    """(K4 ms, dp4a body ms) of one instance over one layer's 5 reads."""
    rs = rows[(transpose, io, adc, noisy)]
    return sum(r[0] for r in rs), sum(r[1] for r in rs)


def stuck_sample(torch, sliced, dev, spec):
    """Rows 0..3 of every mapped leaf's planes, copied, with the stuck mask
    of those rows (the same on every layer)."""
    from repro_torch import tree
    from repro_torch.kernels.sliced_opa import ref as RO

    out = {}
    for path, s in tree.leaves_with_path(sliced):
        if s is None:
            continue
        sample = s.planes[..., :4, :].clone()
        mask = RO.stuck_rows(dev, spec, 0, sample.shape[-2], sample.shape[-1], "cuda")
        out[path] = (sample, mask.reshape(spec.n_slices, *(1,) * (sample.dim() - 3), *mask.shape[1:]))
    return out


def phase_device_train(torch, state, ds, blocks, gen):
    """gemma-2b at full width on the non-ideal device: 2 adc9 steps (one of
    them a CRS step), then one adc9 step each at io 8 and 12 on the ideal
    device, every launch count exact; stuck digits held across the device
    step that runs no CRS. Returns the launch totals and the state."""
    from repro_torch import configs
    from repro_torch import plan as planlib
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.sliced_mvm import kernel as KM
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.models.common import DeviceModel, FidelityConfig
    from repro_torch.optim import PantherConfig
    from repro_torch.optim.schedules import constant
    from repro_torch.train.step import make_train_step

    cfg = configs.get("gemma_2b")
    L = cfg.n_layers
    opt_cfg = PantherConfig(crs_every=2, stochastic_round=True)
    dev = DeviceModel(**DEVICE)
    fids = {"device": FidelityConfig(adc_bits_fwd=9, adc_bits_bwd=9, device=dev, spec=opt_cfg.spec),
            "io8": FidelityConfig(io_bits=8, adc_bits_fwd=9, adc_bits_bwd=9, spec=opt_cfg.spec),
            "io12": FidelityConfig(io_bits=12, adc_bits_fwd=9, adc_bits_bwd=9, spec=opt_cfg.spec)}
    steps = {mode: make_train_step(cfg, opt_cfg, constant(3e-2), plan_rules=planlib.default_rules(opt_cfg, fidelity=f))
             for mode, f in fids.items()}
    counted = (KO.opa_fused, KO.opa_deposit, KM.mvm_sliced_fused)
    totals = {}
    before = snapshot(torch, state.sliced)
    torch.cuda.reset_peak_memory_stats()
    for mode in ("device", "device", "io8", "io12"):
        for fn in (*counted, KC.crs):
            fn.launches = 0
        for fn in counted:
            fn.instances.clear()
        crs_step = state.step % opt_cfg.crs_every == opt_cfg.crs_every - 1
        sample = stuck_sample(torch, state.sliced, dev, opt_cfg.spec) if mode == "device" and not crs_step else None
        batch = ds.batch(state.step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = steps[mode](state, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        got = {"opa_fused": dict(KO.opa_fused.instances), "opa_deposit": dict(KO.opa_deposit.instances),
               "crs": KC.crs.launches, "mvm": dict(KM.mvm_sliced_fused.instances)}
        io = 16 if mode == "device" else int(mode[2:])
        noise = mode == "device"
        want = {"opa_fused": {"device" if noise else "ideal": blocks["operand"]},
                "opa_deposit": {"stuck" if noise else "ideal": blocks["dense"]},
                "crs": blocks["operand"] + blocks["dense"] if crs_step else 0,
                "mvm": {KM.instance_name(False, io, noise): 5 * L, KM.instance_name(True, io, noise): 5 * L}}
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        print(f"step {state.step - 1} ({mode:6s}{', CRS' if crs_step else ''}): {ms:.1f} ms, "
              f"{4 * 64 / ms * 1e3:.0f} tokens/s, loss {loss:.4f}, grad_norm {gnorm:.4f}, launches {got}", flush=True)
        if got != want:
            raise AssertionError(f"{mode} step: launches {got} != {want}")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"{mode} step: loss {loss} or grad_norm {gnorm} not finite")
        # the new instances' launches, by their entry names
        news = {"opa_fused_device": got["opa_fused"].get("device", 0),
                "opa_deposit_stuck": got["opa_deposit"].get("stuck", 0),
                **{"mvm_sliced_fused_" + k.replace("io16_", ""): v for k, v in got["mvm"].items()}}
        for key, n in news.items():
            totals[key] = totals.get(key, 0) + n
        if sample is not None:
            held = {}
            for path, (old, mask) in sample.items():
                new = state.sliced
                for k in path:
                    new = new[k]
                new = new.planes[..., :4, :]
                m = mask.expand(old.shape)
                if not torch.equal(new[m], old[m]):
                    raise AssertionError(f"stuck digits of {'/'.join(map(str, path))} moved")
                held[path] = [int(mask[s].sum()) for s in range(mask.shape[0])]
                if min(held[path]) == 0:
                    raise AssertionError(f"no stuck cell of some slice in the sample of {path}")
            print("  stuck digits held on every leaf's sampled rows (stuck cells per slice, first leaf: "
                  f"{next(iter(held.values()))})", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    after = snapshot(torch, state.sliced)
    moved = {path: float((after[path] != before[path]).float().mean()) for path in before}
    print(f"peak memory over the 4 steps: {peak:.1f} GiB; share of sampled plane cells changed per leaf: "
          + ", ".join(f"{'/'.join(map(str, p))} {v:.3f}" for p, v in moved.items()), flush=True)
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"planes did not change: {moved}")
    for mode in ("device", "io8", "io12"):  # where a step's time goes
        out = {}

        def one_more():
            out["state"], _ = steps[mode](state, ds.batch(state.step))

        profile_step(torch, one_more, f"{mode} train step")
        state = out["state"]
    return totals, state


def phase_k5_path(torch, state):
    """K5's entry point over gemma-2b's planes: every operand block read
    forward and transposed through ``mvm_sliced_batched`` on an input already
    on the 16-bit DAC grid (batch 4 x 64), as the reference's unfused read
    serves it. Returns the launch counts."""
    from repro_torch import tree
    from repro_torch.core.fixed_point import choose_frac_bits
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.common import layer_views
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.kernels.sliced_mvm import mvm_sliced_batched, ref

    g = torch.Generator(device="cuda").manual_seed(1)
    blocks = [(path, blk) for path, s in tree.leaves_with_path(state.sliced)
              if s is not None and path[-1] in ("wqkv", "wo", "wi_gate", "wi_up") for blk in layer_views(s.planes)]
    K.mvm_sliced.launches = K.mvm_sliced.transpose_launches = 0
    K.mvm_sliced.instances.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    finite = True
    for path, planes in blocks:
        for transpose in (False, True):
            x = torch.randn((4, 64, planes.shape[2 if transpose else 1]), generator=g, device="cuda")
            x_q = ref.dac_quantize(x, choose_frac_bits(x, word_bits=16, margin_bits=1, clip_to_word=False), 16)
            out = mvm_sliced_batched(planes, x_q, DEFAULT_SPEC, adc_bits=9, transpose=transpose)
            finite &= bool(torch.isfinite(out).all()) and tuple(out.shape[:2]) == (4, 64)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    counts = (K.mvm_sliced.launches, K.mvm_sliced.transpose_launches)
    print(f"K5 path: {len(blocks)} operand blocks read forward and transposed at 4 x 64 tokens, adc9, in {s:.2f} s; "
          f"launches {counts}", flush=True)
    if counts != (len(blocks), len(blocks)) or not finite:
        raise AssertionError(f"K5 path: launches {counts} for {len(blocks)} blocks, finite {finite}")
    return {"mvm_sliced": counts[0], "mvm_sliced_transpose": counts[1]}


def phase_f32_update(torch, state):
    """The update's entry point, ``opa_fused_update``, with f32 operands on
    every operand block of the trained state, on the ideal and on the
    non-ideal device: one launch a block of K1's CUDA-core instances, the
    planes changed. Returns the launch counts."""
    from repro_torch import tree
    from repro_torch.core import prng
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import opa_fused_update
    from repro_torch.models.common import DeviceModel

    g = torch.Generator(device="cuda").manual_seed(2)
    leaves = [(path, s) for path, s in tree.leaves_with_path(state.sliced)
              if s is not None and path[-1] in ("wqkv", "wo", "wi_gate", "wi_up")]
    n_blocks = sum(math.prod(s.planes.shape[1:-2]) for _, s in leaves)
    counts = {}
    for i, dev in enumerate((None, DeviceModel(**{k: v for k, v in DEVICE.items() if k != "read_noise"}))):
        KO.opa_fused.instances.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moved = True
        for j, (path, s) in enumerate(leaves):
            stack, (M, N) = s.planes.shape[1:-2], s.planes.shape[-2:]
            x = torch.randn((*stack, T_TRAIN, M), generator=g, device="cuda")
            dh = torch.randn((*stack, T_TRAIN, N), generator=g, device="cuda") * 1e-3
            before = s.planes[:, ..., :4, :].clone()
            opa_fused_update(s.planes, x, dh, 3e-2, s.frac_bits, DEFAULT_SPEC, stochastic=True,
                             key=prng.PRNGKey(100 * i + j), device=dev)
            moved &= not torch.equal(before, s.planes[:, ..., :4, :])
        torch.cuda.synchronize()
        got = dict(KO.opa_fused.instances)
        name = KO.instance_name(dev is not None, "fma")
        print(f"f32-operand update ({'non-ideal' if dev else 'ideal'} device): {n_blocks} operand blocks in "
              f"{time.perf_counter() - t0:.2f} s; launches {got}", flush=True)
        if got != {name: n_blocks} or not moved:
            raise AssertionError(f"f32-operand update: launches {got} for {n_blocks} blocks, planes moved {moved}")
        counts[f"opa_fused{'_device' if dev else ''}_fma"] = n_blocks
    return counts


# --------------------- K1's grid and hw rounding sources ----------------------

# grid's layer offsets checked: l·M·N of an 18-layer stack (a wrong offset
# passes at l = 0)
RNG_CASES = (("grid", 0), ("grid", 17), ("hw", 0))
T_RNG = (1, 17, 256)
# 32-bit CUDA-core operations a cell that the draw adds to K1's finalize:
# threefry2x32's 20 rounds and key injections (grid); a quarter of
# Philox4x32-10's 10 rounds, the tile seed and the tile coordinates (hw)
RNG_OPS_PER_CELL = {"grid": 100, "hw": 40}


def rng_entry(mode, dev, body):
    """A grid/hw instance's name in the kernels line."""
    return "opa_fused" + ("_device" if dev else "") + f"_{mode}" + ("_fma" if body == "fma" else "")


def chi2_p(chi2: float, dof: int) -> float:
    """Upper-tail p-value of a chi-squared statistic (Wilson-Hilferty's
    normal approximation, good to a few percent at hundreds of degrees)."""
    z = ((chi2 / dof) ** (1 / 3) - (1 - 2 / (9 * dof))) / math.sqrt(2 / (9 * dof))
    return 0.5 * math.erfc(z / math.sqrt(2))


def phase_rng_kernels(torch, spec, gen):
    """K1's grid and hw instances, ideal and device, both bodies, against
    their plain versions: bit for bit on f32-exact operands (but for counted
    one-LSB write-noise flips, as in phase 6), grid at layer offsets 0 and
    17; within the f32 bound on training-like bf16 operands; then hw's
    statistics on the card. The device is once noise-free (asymmetry and
    stuck cells: bit for bit) and once with the write noise too (flips
    counted, at most FLIP_SHARE of a block). Returns the flips by entry
    name."""
    from repro_torch.core.fixed_point import choose_frac_bits, quantize
    from repro_torch.core.slicing import slice_weights
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO
    from repro_torch.models.common import DeviceModel

    devs = (DeviceModel(**PHYSICS["asym"], **PHYSICS["stuck"]), DeviceModel(**PHYSICS["all"]))
    words, noise_words = (0x2468ACE, -0x13579BD), (77, -99)
    flips, cases = {}, 0
    lr, F = 2.0**-4, 8  # updates on a 2^-4 grid: the draw decides
    frac = torch.tensor([F], dtype=torch.int32, device="cuda")
    for M, N in (*SLICE_SHAPES, RAGGED_SHAPE):
        for T in T_RNG:
            x, dh = exact_operands(torch, T, M, N, torch.bfloat16, gen)
            for d in (None, *devs):
                if d is None:
                    planes = random_planes(torch, spec, (M, N), gen)
                else:
                    q = torch.randint(-2**27, 2**27, (M, N), generator=gen, device="cuda", dtype=torch.int32)
                    planes = slice_weights(q, spec)
                for mode, layer in RNG_CASES:
                    offset = layer * M * N
                    want = RO.opa_fused_ref(planes, x, dh, lr, F, spec, words, d, noise_words, rng_mode=mode,
                                            offset=offset)
                    for body in ("mma", "fma"):
                        key = rng_entry(mode, d is not None, body)
                        got = KO.opa_fused(planes.clone(), x, dh, lr, frac, spec=spec, key_words=words,
                                           rng_mode=mode, offset=offset, dev=d, noise_words=noise_words, body=body)
                        torch.cuda.synchronize()
                        n = 0
                        if not torch.equal(got, want):
                            if d is None or d.write_noise == 0.0:
                                raise AssertionError(f"{key} vs plain at M={M} N={N} T={T} layer {layer} "
                                                     f"(device {d}): {int((got != want).sum())} plane cells "
                                                     "differ")
                            acc = x.float().T @ dh.float()
                            p_q = RO.write_rows(acc * (-RO._lr32(lr) * 2.0**F), d, 0, noise_words, words,
                                                rng_mode=mode, offset=offset)
                            stuck = RO.stuck_rows(d, spec, 0, M, N, "cuda")
                            # a rounding flip of the write noise's last bit
                            n = noise_flips(torch, got, want, planes, p_q, stuck, spec,
                                            f"{key} at M={M} N={N} T={T} layer {layer}")
                        flips[key] = flips.get(key, 0) + n
                        cases += 1
                        del got
                    del want
                del planes
    layers = [layer for mode, layer in RNG_CASES if mode == "grid"]
    print(f"K1 grid/hw instances vs plain on f32-exact operands: {cases} cases (ideal, device noise-free and "
          f"with write noise, both bodies, gemma-2b's four (M, N) and {RAGGED_SHAPE}, T {T_RNG}, grid at layers "
          f"{layers} of 18): ideal and noise-free device bit-identical; with write noise, elements that differ, "
          f"each by one grid LSB (at most {FLIP_SHARE} of a block): "
          + ", ".join(f"{k} {v}" for k, v in flips.items() if "device" in k), flush=True)

    # training-like bf16 operands on canonical planes, held to the f32 bound
    # of the two contraction orders in update space, as phase 4 holds counter
    for M, N in SLICE_SHAPES:
        w = torch.randn((M, N), generator=gen, device="cuda") / M**0.5
        f = choose_frac_bits(w, margin_bits=2)
        planes = slice_weights(quantize(w, f), spec)
        x = torch.randn((T_TRAIN, M), generator=gen, device="cuda").to(torch.bfloat16)
        dh = (torch.randn((T_TRAIN, N), generator=gen, device="cuda") * 1e-3).to(torch.bfloat16)
        scale = 3e-2 * 2.0 ** int(f)
        allowed = 1.0 + scale * 2 * T_TRAIN * 2.0**-24 * (x.float().abs().T @ dh.float().abs())
        acc = x.float().T @ dh.float()
        line = []
        for mode, offset in (("grid", 17 * M * N), ("hw", 0)):
            want = RO.opa_fused_ref(planes, x, dh, 3e-2, f, spec, (11, 22), rng_mode=mode, offset=offset)
            p_q = RO.write_rows(acc * (-RO._lr32(3e-2) * 2.0 ** int(f)), None, 0, None, (11, 22), rng_mode=mode,
                                offset=offset)
            for body in ("mma", "fma"):
                got = KO.opa_fused(planes.clone(), x, dh, 3e-2, f.reshape(1), spec=spec, key_words=(11, 22),
                                   rng_mode=mode, offset=offset, body=body)
                k = update_shifts(torch, got, want, planes, p_q, None, spec, reach=16).abs()
                if bool((k > allowed).any()):
                    raise AssertionError(f"{rng_mode_body(mode, body)} vs plain on training-like operands at "
                                         f"M={M} N={N}: an update {int(k.max())} LSB off, beyond the f32 bound")
                line.append(f"{rng_mode_body(mode, body)} {float((k > 0).float().mean()):.3e} differ, max "
                            f"{int(k.max())} LSB")
                del got, k
            del want, p_q
        print(f"  K1 grid/hw M={M:5d} N={N:5d} T={T_TRAIN} bf16 training-like vs plain: " + "; ".join(line)
              + f" (bound at least {float(allowed.min()):.1f} LSB)", flush=True)
        del w, planes, x, dh, allowed, acc
    torch.cuda.empty_cache()

    # hw on the card: unbiased rounding of a constant sub-LSB increment
    M, N = 2048, 2560
    for body, dtype in (("mma", torch.bfloat16), ("fma", torch.float32)):
        planes = torch.zeros((spec.n_slices, M, N), dtype=torch.int8, device="cuda")
        x = torch.ones((1, M), device="cuda", dtype=dtype)
        dh = torch.full((1, N), -0.3711, device="cuda", dtype=dtype)
        p = -float(dh[0, 0].float())  # y = -lr·x·dh·2^F at lr 1, F 0
        KO.opa_fused(planes, x, dh, 1.0, torch.zeros(1, dtype=torch.int32, device="cuda"), spec=spec,
                     key_words=(21, -4), rng_mode="hw", body=body)
        share = float((plane_values(torch, planes) == 1).double().mean())
        sigma = math.sqrt(p * (1 - p) / (M * N))
        print(f"  hw rounding, {body} body, {M}x{N} cells at y = {p:.6f}: rounded up {share:.6f} "
              f"({(share - p) / sigma:+.2f} sigma)", flush=True)
        if abs(share - p) > 4 * sigma:
            raise AssertionError(f"hw rounding on the {body} body is biased: {share} vs {p}")
    # the plain stream: 256 equal bins, two tiles, two keys
    M, N = 2048, 16384
    u = RO.hw_uniform_ref(21, -4, M, N, "cuda")
    counts = torch.bincount((u * 256).long().flatten(), minlength=256).double()
    expect = M * N / 256
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    pval = chi2_p(chi2, 255)
    bm, bn = RO.hw_tiles(M, N)
    same_tile = float((u[:bm, :bn] == u[:bm, bn:2 * bn]).float().mean())
    same_key = float((u == RO.hw_uniform_ref(21, -3, M, N, "cuda")).float().mean())
    print(f"  hw_uniform_ref over {M}x{N}: chi2 {chi2:.1f} over 255 degrees, p {pval:.3g}; cells equal between "
          f"two tiles {same_tile:.2e}, between two keys {same_key:.2e}", flush=True)
    if not (pval > 1e-4 and same_tile < 1e-3 and same_key < 1e-3):
        raise AssertionError("hw_uniform_ref's statistics fail")
    del u, counts
    torch.cuda.empty_cache()
    return {k: float(v) for k, v in flips.items()}


def rng_mode_body(mode, body):
    return f"{mode} {'tensor-core' if body == 'mma' else 'CUDA-core'}"


def time_rng_kernels(torch, spec, gen):
    """One layer's 5 blocks at 256 tokens for each grid/hw instance beside
    the counter instance in the same run: kernel (both bodies), plain
    version, the bf16 contraction alone and the bound."""
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO
    from repro_torch.models.common import DeviceModel

    S, T = spec.n_slices, T_TRAIN
    dev = DeviceModel(**PHYSICS["all"])
    rows, counter = {}, {}
    for name, M, N in SLICE_READS:
        planes = torch.randint(-8, 8, (S, M, N), generator=gen, device="cuda", dtype=torch.int8)
        frac = torch.tensor([30], dtype=torch.int32, device="cuda")
        x = torch.randn((T, M), generator=gen, device="cuda").to(torch.bfloat16)
        dh = (torch.randn((T, N), generator=gen, device="cuda") * 1e-3).to(torch.bfloat16)
        lib = cuda_time_ms(lambda: torch.matmul(x.t(), dh), 10)
        for d in (None, dev):
            kw = dict(spec=spec, key_words=(1, 2), dev=d, noise_words=(3, 4))
            c = counter.setdefault(d is not None, [0.0, 0.0])
            c[0] += cuda_time_ms(lambda: KO.opa_fused(planes, x, dh, 3e-2, frac, **kw), 10)
            c[1] += cuda_time_ms(lambda: KO.opa_fused(planes, x, dh, 3e-2, frac, body="fma", **kw), 10)
            for mode in ("grid", "hw"):
                offset = 17 * M * N if mode == "grid" else 0
                k = cuda_time_ms(lambda: KO.opa_fused(planes, x, dh, 3e-2, frac, rng_mode=mode, offset=offset, **kw),
                                 10)
                k_fma = cuda_time_ms(lambda: KO.opa_fused(planes, x, dh, 3e-2, frac, rng_mode=mode, offset=offset,
                                                          body="fma", **kw), 10)
                p = cuda_time_ms(lambda: RO.opa_fused_ref(planes, x, dh, 3e-2, frac[0], spec, (1, 2), d, (3, 4),
                                                          rng_mode=mode, offset=offset), 3, 1)
                # bf16 products on the tensor cores; the draw (and the physics) on the CUDA cores
                t_bytes = (2 * S * M * N + 2 * T * (M + N) + 4) / HBM_BYTES_PER_S
                cell_ops = RNG_OPS_PER_CELL[mode] + (DEVICE_OPS_PER_CELL if d is not None else 0)
                t_ops = 2.0 * T * M * N / BF16_FLOPS_PER_S + cell_ops * M * N / CUDA_CORE_OPS_PER_S
                b = (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
                rows.setdefault(rng_entry(mode, d is not None, "mma"), []).append((k, p, lib, *b, k_fma))
                rows.setdefault(rng_entry(mode, d is not None, "fma"), []).append((k_fma, p, lib, *b))
        for key, r in rows.items():
            if not key.endswith("_fma"):
                k, p, lib, b_ms, b_by, k_fma = r[-1]
                print(f"  {key:25s} {name:11s} M={M:5d} N={N:5d} T={T}: kernel {k:.4f} ms  CUDA-core body "
                      f"{k_fma:.4f} ms  plain {p:.4f} ms  library {lib:.4f} ms  bound {b_ms:.4f} ms ({b_by})",
                      flush=True)
        del planes, x, dh
    torch.cuda.empty_cache()
    out = {key: layer_total(rs, key) for key, rs in rows.items()}
    for d, (k, k_fma) in counter.items():
        print(f"  counter draw, same run: opa_fused{'_device' if d else ''} one layer's 5 blocks {k:.4f} ms, "
              f"CUDA-core body {k_fma:.4f} ms", flush=True)
        for mode in ("grid", "hw"):
            print_layer_total(rng_entry(mode, d, "mma"), out[rng_entry(mode, d, "mma")], T)
    return out


def phase_rng_train(torch, state, ds, blocks):
    """gemma-2b at full width, 18 layers, under rng_mode "grid" and "hw": one
    adc9 step and one adc9 step on the non-ideal device each, every launch
    count exact by instance; one more grid step under the profiler; the
    dense leaves' grid draw timed alone; then ``opa_fused_update`` with f32
    operands under each mode (K1's CUDA-core grid/hw instances). Returns
    the launch counts by entry name and the state."""
    import dataclasses

    from repro_torch import configs, tree
    from repro_torch import plan as planlib
    from repro_torch.core import prng
    from repro_torch.core.fixed_point import counter_uniform, rounding_noise
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.sliced_mvm import kernel as KM
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import opa_fused_update
    from repro_torch.models.common import DeviceModel, FidelityConfig
    from repro_torch.optim import PantherConfig
    from repro_torch.optim.schedules import constant
    from repro_torch.train.step import make_train_step

    cfg = configs.get("gemma_2b")
    L = cfg.n_layers
    dev = DeviceModel(**DEVICE)
    launches, steps = {}, {}
    for mode in ("grid", "hw"):
        opt_cfg = PantherConfig(crs_every=2, stochastic_round=True, rng_mode=mode)
        fids = {"adc9": dataclasses.replace(configs.fidelity_presets()["adc9"], spec=opt_cfg.spec),
                "device": FidelityConfig(adc_bits_fwd=9, adc_bits_bwd=9, device=dev, spec=opt_cfg.spec)}
        for kind, fid in fids.items():
            steps[mode, kind] = step = make_train_step(cfg, opt_cfg, constant(3e-2),
                                                       plan_rules=planlib.default_rules(opt_cfg, fidelity=fid))
            for fn in (KO.opa_fused, KO.opa_deposit, KM.mvm_sliced_fused, KC.crs):
                fn.launches = 0
            for fn in (KO.opa_fused, KO.opa_deposit, KM.mvm_sliced_fused):
                fn.instances.clear()
            crs_step = state.step % opt_cfg.crs_every == opt_cfg.crs_every - 1
            batch = ds.batch(state.step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            noise = kind == "device"
            got = {"opa_fused": dict(KO.opa_fused.instances), "opa_deposit": dict(KO.opa_deposit.instances),
                   "crs": KC.crs.launches, "mvm": dict(KM.mvm_sliced_fused.instances)}
            want = {"opa_fused": {KO.instance_name(noise, "mma", mode): blocks["operand"]},
                    "opa_deposit": {"stuck" if noise else "ideal": blocks["dense"]},
                    "crs": blocks["operand"] + blocks["dense"] if crs_step else 0,
                    "mvm": {KM.instance_name(False, 16, noise): 5 * L, KM.instance_name(True, 16, noise): 5 * L}}
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            print(f"step {state.step - 1} (rng_mode {mode}, {kind}{', CRS' if crs_step else ''}, {L} layers): "
                  f"{ms:.1f} ms, {4 * 64 / ms * 1e3:.0f} tokens/s, loss {loss:.4f}, grad_norm {gnorm:.4f}, "
                  f"launches {got}", flush=True)
            if got != want:
                raise AssertionError(f"rng_mode {mode} {kind} step: launches {got} != {want}")
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise AssertionError(f"rng_mode {mode} {kind} step: loss {loss} or grad_norm {gnorm} not finite")
            launches[rng_entry(mode, noise, "mma")] = got["opa_fused"][KO.instance_name(noise, "mma", mode)]
    out = {}

    def one_more():
        out["state"], _ = steps["grid", "adc9"](state, ds.batch(state.step))

    profile_step(torch, one_more, "adc9 train step under rng_mode grid")
    state = out["state"]
    # the dense leaves' draws under grid (plain PyTorch, as the reference's is
    # XLA's): the embedding and the two [18, 2048] norm-scale stacks, beside
    # the counter draw of the same shapes
    key = prng.fold_in(prng.PRNGKey(7), 1)
    shapes = (EMBED_SHAPE, (L, cfg.d_model), (L, cfg.d_model))
    for mode in ("grid", "counter"):
        draw = (lambda s: rounding_noise(key, s, "grid", device="cuda")) if mode == "grid" else (
            lambda s: counter_uniform(key, s, device="cuda"))
        ms = cuda_time_ms(lambda: [draw(s) for s in shapes], 2, 1)
        print(f"  dense leaves' {mode} draw ({sum(math.prod(s) for s in shapes)} cells): {ms:.1f} ms", flush=True)
    torch.cuda.empty_cache()

    # the update's entry point with f32 operands: K1's CUDA-core grid/hw instances
    g = torch.Generator(device="cuda").manual_seed(3)
    leaves = [(path, s) for path, s in tree.leaves_with_path(state.sliced)
              if s is not None and path[-1] in ("wqkv", "wo", "wi_gate", "wi_up")]
    n_blocks = sum(math.prod(s.planes.shape[1:-2]) for _, s in leaves)
    for mode in ("grid", "hw"):
        for i, d in enumerate((None, DeviceModel(**PHYSICS["all"]))):
            KO.opa_fused.instances.clear()
            t0 = time.perf_counter()
            for j, (path, s) in enumerate(leaves):
                stack, (M, N) = s.planes.shape[1:-2], s.planes.shape[-2:]
                x = torch.randn((*stack, T_TRAIN, M), generator=g, device="cuda")
                dh = torch.randn((*stack, T_TRAIN, N), generator=g, device="cuda") * 1e-3
                opa_fused_update(s.planes, x, dh, 3e-2, s.frac_bits, DEFAULT_SPEC, stochastic=True,
                                 key=prng.PRNGKey(100 * i + j), rng_mode=mode, device=d)
            torch.cuda.synchronize()
            got = dict(KO.opa_fused.instances)
            name = KO.instance_name(d is not None, "fma", mode)
            print(f"f32-operand update, rng_mode {mode} ({'non-ideal' if d else 'ideal'} device): {n_blocks} "
                  f"operand blocks in {time.perf_counter() - t0:.2f} s; launches {got}", flush=True)
            if got != {name: n_blocks}:
                raise AssertionError(f"f32-operand update under {mode}: launches {got} for {n_blocks} blocks")
            launches[rng_entry(mode, d is not None, "fma")] = n_blocks
    return launches, state


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

    from repro_torch.kernels import build as B
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.sliced_opa import kernel as KO

    t0 = time.perf_counter()
    libs = B.build_all({"mvm_sliced_fused": [K.SOURCE], "crs": [KC.SOURCE], **KO.SOURCES})
    print(f"built {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s (in parallel)", flush=True)
    for name, built in libs.items():
        print(f"  {name}: nvcc {built.seconds:.1f} s -> {built.path.name}")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line:
                print("    ptxas:", line.strip())

    gen = torch.Generator(device="cuda").manual_seed(0)
    t_start = time.perf_counter()

    def done(what):
        print(f"[{time.perf_counter() - t_start:7.1f} s] {what} done", flush=True)

    max_err, timings = phase_kernels(torch, K, ref, fp, DEFAULT_SPEC, gen)
    done("phase 2: K4 checks")
    launches = phase_slice(torch, K, gen)
    torch.cuda.empty_cache()
    done("phase 3: serving")
    phase_update_kernels(torch, DEFAULT_SPEC, gen)
    opa_err = phase_opa_fused(torch, DEFAULT_SPEC, gen)
    t_err = phase_transpose(torch, K, ref, fp, DEFAULT_SPEC, gen)
    train_timings = time_update_kernels(torch, K, ref, DEFAULT_SPEC, gen)
    done("phase 4: update kernels and K4ᵀ")
    dev_err = phase_device_kernels(torch, DEFAULT_SPEC, gen)
    train_timings.update(time_device_kernels(torch, DEFAULT_SPEC, gen))
    done("phase 6: device, io 8/12 and K5 kernels")
    train_launches, state, ds, blocks = phase_train(torch, gen)
    done("phase 5: training")
    dev_launches, state = phase_device_train(torch, state, ds, blocks, gen)
    train_launches.update(dev_launches)
    done("phase 7: training on the non-ideal device and at io 8/12")
    train_launches.update(phase_k5_path(torch, state))
    done("phase 8: K5 entry point")
    train_launches.update(phase_f32_update(torch, state))
    done("phase 9: f32-operand update")
    rng_err = phase_rng_kernels(torch, DEFAULT_SPEC, gen)
    train_timings.update(time_rng_kernels(torch, DEFAULT_SPEC, gen))
    rng_launches, state = phase_rng_train(torch, state, ds, blocks)
    train_launches.update(rng_launches)
    del state
    done("phase 10: K1 rounding sources")

    # one layer's five reads at the decode batch (4 tokens): the main path's
    # per-layer decode work
    def per_layer(i):
        return sum(timings[(m, n, 4)][i] for _, m, n in SLICE_READS)

    bounds = [bound_ms(4, m, n, DEFAULT_SPEC.n_slices, 16) for _, m, n in SLICE_READS]

    def entry(name, source, replaces, max_abs_err):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": train_launches[name], "max_abs_err": max_abs_err, **train_timings[name]}

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
        "dp4a_ms": per_layer(5),
    },
        entry("mvm_sliced_fused_transpose", "src/repro_torch/kernels/sliced_mvm/csrc/mvm_sliced_fused.cu",
              "src/repro/kernels/sliced_mvm/kernel.py:367", t_err),
        entry("opa_fused", "src/repro_torch/kernels/sliced_opa/csrc/opa_fused.cu",
              "src/repro/kernels/sliced_opa/kernel.py:255", float(opa_err["mma"])),
        entry("opa_fused_fma", "src/repro_torch/kernels/sliced_opa/csrc/opa_fused.cu",
              "src/repro/kernels/sliced_opa/kernel.py:255", float(opa_err["fma"])),
        entry("opa_deposit", "src/repro_torch/kernels/sliced_opa/csrc/opa_deposit.cu",
              "src/repro/kernels/sliced_opa/kernel.py:90", 0.0),
        entry("crs", "src/repro_torch/kernels/crs/csrc/crs.cu", "src/repro/kernels/crs/kernel.py:70", 0.0),
        entry("opa_fused_device", "src/repro_torch/kernels/sliced_opa/csrc/opa_fused.cu",
              "src/repro/kernels/sliced_opa/kernel.py:255", dev_err["opa_fused_device"]),
        entry("opa_fused_device_fma", "src/repro_torch/kernels/sliced_opa/csrc/opa_fused.cu",
              "src/repro/kernels/sliced_opa/kernel.py:255", dev_err["opa_fused_device_fma"]),
        entry("opa_deposit_stuck", "src/repro_torch/kernels/sliced_opa/csrc/opa_deposit.cu",
              "src/repro/kernels/sliced_opa/kernel.py:90", dev_err["opa_deposit_stuck"]),
        *(entry(f"mvm_sliced_fused{t}_{v}", "src/repro_torch/kernels/sliced_mvm/csrc/mvm_sliced_fused.cu",
                "src/repro/kernels/sliced_mvm/kernel.py:367", dev_err[f"mvm_sliced_fused{t}_{v}"])
          for v in ("read_noise", "io8", "io12") for t in ("", "_transpose")),
        *(entry(f"mvm_sliced{t}", "src/repro_torch/kernels/sliced_mvm/csrc/mvm_sliced_fused.cu",
                "src/repro/kernels/sliced_mvm/kernel.py:233", dev_err[f"mvm_sliced{t}"]) for t in ("", "_transpose")),
        *(entry(rng_entry(mode, d, body), "src/repro_torch/kernels/sliced_opa/csrc/opa_fused.cu",
                "src/repro/kernels/sliced_opa/kernel.py:255", rng_err[rng_entry(mode, d, body)])
          for mode in ("grid", "hw") for d in (False, True) for body in ("mma", "fma")),
    ]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
