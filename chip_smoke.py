#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PANTHER (``src/repro_torch``) on one NVIDIA
Hopper card and check it.

Phases:
  1. build the CUDA kernels from the sources in this checkout (five
     libraries, one ``nvcc`` each, all started together, ``sm_90a``),
     print each kernel's ptxas registers and spills, and the card's name
     and power limit;
  2. hold the kernel against its plain PyTorch version at every (M, N) the
     gemma-2b serving path reads, at tokens {1, 2, 3, 4, 5, 6, 7, 8, 16, 128,
     256} and ADC {9, 6, ideal} (bit for bit at finite ADC), plus a short
     last crossbar tile and a ragged N at tokens {1, 4, 5, 16}, and time the
     kernel, the plain version and ``torch.matmul`` on the dequantized
     weights (the lossless yardstick) at the decode (4), engine round (8)
     and prefill (128) token counts and at 1 and 5, with K4's three bodies
     side by side: the decode body
     (the wrapper's for forward reads of at most 4 tokens), the tensor-core
     body (for more), and the dp4a body as K5's dp4a instance runs it on
     x_q, asked for by name; it prints the fastest body at each token count;
  3. serve gemma-2b at full width (d=2048, d_ff=16384, vocab 256000, bf16)
     through the adc9 finite-ADC plan: random weights from a seed, sliced into
     int8 digit planes, 4 prompts of 32 tokens prefilled and 16 tokens
     greedily decoded; the kernel's launch count must equal 5 reads x layers x
     (1 prefill + 15 decode steps), the prefill's on the tensor-core body
     and the decode steps' on the decode body, the logits must be finite and
     the adc9-vs-lossless gap finite;
 15. (run after 3) the continuous-batching engine on gemma-2b at full width
     and 2 of its 18 layers (``ENGINE_LAYERS``: the script's time limit
     on a slow host) (``serve.engine``/``scheduler`` through
     ``launch.serve``'s helpers):
     (a) the reference bench's trace (32 requests at 1e4/s, prompts 8/16/32,
     outputs 4 or 120 at 3:1; 8 slots, page 16, chunk 16, max_seq 160)
     under ``continuous`` and ``static`` through the adc9 tree on one cost
     table; (b) tokens/s, p50/p99 inter-token latency and TTFT of each, and
     K4's launches equal to 5 reads x ENGINE_LAYERS x the model passes
     (prefills, chunks and round steps, calibrations included), all on the
     tensor-core body (every read has 8 tokens or more), counted by tokens
     a read; (c) the continuous run again on fresh engines over the same
     costs, its tokens and token_times bit for bit; (d) one round of 8 slots
     (2 dead, 2 exhausted mid-round) on the page pools against dense
     per-slot caches gathered from them, logits and tokens bit for bit;
     (g) one round step under the profiler; (e) the lossless tree under
     ``continuous``, the share of tokens equal to solo serving printed
     (not gated), and a 32-token prefill as 2 chunks of 16 against the
     single-shot one; (f) the two SLA tiers (premium/adc9, bulk/adc6 over
     the same planes, 4 slots: K4's decode body), every request on its
     tier and premium's inter-token latency above bulk's;
 16. (run after 15, on its state) the engine on the crossbar-cycle clock:
     (a) ``IsaClock.from_plan`` over the adc9 plan the tree serves, at 8
     slots (``s_per_token`` equal to ``token_latency_ns`` of
     ``lm.param_shapes`` · 1e-9), phase 15's trace under ``continuous``
     and ``static`` on it with ``Engine._calibrate`` refused: the
     crossbar-clock summaries, passes by kind, K4's launches equal to 5
     reads x ENGINE_LAYERS x the passes, all on the tensor-core body; (b) the
     same trace (tokens mapped into its vocabulary) and clock through the
     ``launch.serve`` bench's narrow model: summaries and every request's
     ``token_times`` equal (a)'s; (c) ``launch.serve --trace --isa-clock``
     on the card: its ``crossbar_clock`` and tier tokens/s equal to
     ``BENCH_serve.json``'s exactly, the tiers reading through K4 at adc9
     and adc6, their 4-slot rounds on the decode body; (d) the first K4 read
     of (a)'s first round against its plain version, bit for bit; (e)
     gemma-2b's compiled training step (``compile_plan`` over
     ``lm.param_shapes`` at 256 tokens, the default plan), its instruction
     count and host seconds, ``systems_summary`` within 1e-12 of the
     reference's ratios;
  4. hold the update kernels and the transpose read against their plain
     versions: ``crs`` (planes at a 16-byte boundary and 5 bytes past
     one) and ``opa_deposit`` bit for bit at gemma-2b's four (M, N),
     the 256000x2048 embedding, a ragged 320x100 and a 33x47 whose M·N is off
     the 16-element grid, on inputs that hit every rail; K2's dense write
     (``opa_dense``: the gradient, the rounding draw and the deposit in one
     pass) bit for bit with f32 and bf16 gradients under half to even,
     counter and grid at the embedding, an [18, 2048] norm-scale stack, the
     MLP's three leaves (128x10 ragged), 33x47 and misaligned planes, and
     through ``opa_dense_update`` on an [18, 2048, 2560] stack against
     ``quantize`` and the deposit; the int32 deposit's entry point
     (``ops.opa_deposit``) driven at gemma-2b's dense leaves and the MLP's,
     its launches the kernels line's; ``opa_fused`` bit for bit on f32-exact operands at
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
     and MᵀVM) beside the dp4a body (K5's dp4a instance on x_q), and K1's
     tensor-core body beside its CUDA-core body; and ``crs`` over one
     layer's 5 blocks and over the embedding's block beside a
     device-to-device copy of the same bytes (the attainable bandwidth);
     and every dense-write instance on the embedding;
  5. train gemma-2b at full width: random weights from a seed, synthetic
     bigram tokens at batch 4 x 64, lr 3e-2, CRS every 2 steps, counter
     stochastic rounding; 3 steps through the adc9 plan, then 2 lossless
     steps, then one more step of each under the profiler. Every kernel's
     launches per step must be exact (K1 per operand block, all on its
     tensor-core instance and none on the CUDA-core ones, K2's dense write
     per dense-gradient block on its f32 counter instance and no int32
     deposit, K3 per mapped block on CRS steps, K4 and K4ᵀ per
     adc9 read), the loss and the gradient norm finite, and the planes must
     change;
  6. (run before 5, on its own memory) hold the new kernel instances against
     their plain versions at gemma-2b's four (M, N) and a ragged 320x100, at
     tokens {1, 100, 256} (the reads also at 4, K1 at 17): K1's device instance, both
     bodies, with each write-physics field alone and all together, K2's
     stuck instance (the embedding
     included), K2's dense-write device instances with each field alone and
     all together under each rounding, f32 and bf16, the stuck mask written
     by a first launch and read by a second, K4/K4ᵀ with read noise, K4/K4ᵀ at io 8 and 12 and K5 forward
     and transposed at io 8, 12 and 16, each at ADC {9, 6, ideal} (K4 at 1 and
     4 tokens on its decode body; K5 on the body its shape takes and on the
     other, by name, bit for bit, also on out-of-range x_q); then time
     each at 256 tokens against its plain version, its library yardstick and
     its bound; then every K4 instance (forward and MᵀVM, io 8/12/16, finite
     and ideal ADC, with and without read noise) at 256 tokens beside the
     dp4a body (K5's dp4a instance on x_q) and K5 on the tensor-core body,
     the ideal-device ones bit for bit against the dp4a body on x =
     x_q·2^-10;
  7. train the same state on the non-ideal device (write noise 4e6 LSB,
     asymmetry 1.2/0.8, 2% stuck cells, read noise 1% of full scale): 2 adc9
     steps, then one adc9 step each at io 8 and 12 on the ideal device, every
     launch count exact (the device steps through K1's device instance, K2's
     dense-write device instance and the noisy K4/K4ᵀ), stuck digits held across the
     device step that runs no CRS, then one more step of each kind under the
     profiler;
  8. drive K5's entry point, ``mvm_sliced_batched``, over every operand
     block of the trained state, forward and transposed, at 4 x 64 tokens
     and io 16, 8 and 12: every read on K5's tensor-core instances;
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
     the profiler, the dense leaves' plain grid draw timed alone (what the
     dense write drew apart before K2 took it in), ``opa_fused_update``
     with f32 operands under each mode, and ``opa_dense_update`` with f32
     and bf16 gradients on the dense leaves under each rounding, ideal and
     device (every instance of K2's dense write);
 12. (run after 10, on its trained state) microbatches and the stash rule:
     an adc9 step with ``microbatches=4`` (16 x 64 tokens as [4, 4, 64],
     the stash rule on, seeing 256 tokens a microbatch and flipping
     nothing): K4 and K4ᵀ 360 launches each, K1 90, all on its tensor-core
     ideal instance at 1024 tokens, K2's dense write 3, K3 93 on a CRS step; then a
     lossless ``stash_fallback`` step at 4 x 320 tokens, whose
     ``plan_summary`` is printed and whose attn/wqkv and attn/wo flip to
     dense gradients (K1 54, K2 39); each step's time and peak memory
     beside phase 5's; then K1 at 1024 tokens over one layer's 5 blocks,
     bit for bit against its plain version on f32-exact operands and timed
     beside it, the library's ``xᵀ @ dh`` and the bound;
 11. the paper MLP: its kernels at its shapes (K2, its dense write and its
     int32 deposit, and K3 on the three crossbar leaves, one K2 write's host
     and device time, the write before the redesign emulated in this tree
     beside the dense write, K4's adc9 read at 512 tokens on short M = 64 tiles and
     a ragged N = 10) against their plain versions and timed; then the
     port's quickstart (two CRS periods and float SGD, 301 steps each),
     Fig 9's ``run()`` (12 configurations x 400 steps) and
     ``device_sweep(300)`` (8 records), every update's launches exact (K2's
     dense write once a leaf, counted under ``opa_dense_mlp`` alone, K3 once a leaf on CRS steps, no K1), the adc9 reads on
     K4's tensor-core body; the paper claims true and the losses within
     1e-3 of the in-process JAX reference (but the noisy rows the
     reference itself does not reproduce, printed beside it); one Fig-9
     step and one device step profiled (the device's busy share);
 13. checkpoints at full width (after 12 and 11 free their states; the
     disk must hold 2.2 x a gemma-2b state, two commits at once): the
     launcher (``launch.train.main``) trains gemma-2b 2 adc9 steps with
     ``--ckpt-dir`` (CRS every 3, a checkpoint every 2), then resumes to 3
     steps, printing ``resumed from step 1`` and taking step 2, a CRS step,
     on the restored planes (every launch count exact; the launcher's
     steps rematerialize each layer, so K4's forward reads run twice); an
     uninterrupted 3-step witness of the same code must equal it bit for
     bit (step 2's loss and grad norm, and every leaf of the last commit,
     compared a leaf at a time on the card); a restore under another spec
     for one leaf must refuse (``check_plan_compat``); bytes, save and
     restore seconds and GB/s, and the resumed step's time are printed;
 14. Fig 10: K2's dense write and K4's 6- and 9-bit reads at each of its
     nine specs on the MLP's shapes against their plain versions; then
     ``spec_sweep()`` and ``io_sweep()`` uncut (400 steps each, every
     update's launches held), each row within 1e-3 of the in-process JAX
     reference's (its ``JAX_FIG10_*`` constants), the energy columns exact
     and the paper's claims equal; ``hetero_plan_demo()`` at the
     reference's size (40 steps) within the bounds its CPU test measured;
     the heterogeneous plan at full width (gemma-2b, bf16, two groups of
     9, group 0 at 66666666 behind adc9 reads, group 1 at 44466555 behind
     adc6): 3 steps at 8 x 32 tokens, lr 0.3, and a prefill through
     ``fidelity_params``, K1 and K4/K4ᵀ launches counted by spec, then K1
     and K4/K4ᵀ at 66666666 on group 0's layer-0 blocks against their plain
     versions and timed; last, the streamed OPA once on the card against
     its CPU result;
 17. the MoE family: granite-moe-1b-a400m at full width (d 1024, 24 layers,
     32 experts top-8 of d_ff 512, vocab 49155, bf16, seed weights in
     44466555 planes): (a) every expert of one bank read through K4 at
     adc9, forward and MᵀVM at the training capacity (80 rows) and forward
     at decode's 8, the router forward and MᵀVM at 256 tokens, K1 on an
     expert tile at 80 tokens and K2 on an expert block, each bit for bit
     against its plain version on the card; then one layer's 96 expert
     reads, its 96 K1 tile updates and one dense bank's 768 K2 writes timed
     beside their plain versions, a library yardstick (one ``torch.bmm`` a
     bank) and the bound; (b) 3 training steps at 4 x 64 tokens under
     ``coverage_rules`` with adc9 (router and experts operand leaves, the
     banks ``group="expert"``; CRS every 2, counter draw), one more under
     the profiler, one under ``default_rules`` (the banks dense: K2 over
     768 blocks a bank) and one under the moe-hetero analogue (experts 0-7
     at adc9, 8-31 at adc6): losses and aux terms finite, every kernel's
     work held to the plan at its entry point and to the wrappers' launch
     counts, by K4 token count and ADC; (c) layer 0's ``moe_apply`` through
     the kernels bit for bit against the plain reads, 4 x 32 prompts and 16
     greedy tokens through the adc9 coverage plan (2376 K4 reads a decode
     step), and the engine on the bench's trace cut to its first 2 requests
     (the script's time limit), continuous, 8 slots: tokens/s and K4 reads
     by tokens;
 18. the SSM family: (a) the im2col entry (``opa_im2col``: K1's
     function on a conv-tap block, one launch a layer block) at C 1536
     (xlstm) and 4224 (zamba2), 256 tokens, under the counter draw and
     half to even, bit for bit against its plain version and against the
     per-tile K1 launches on the same block; K3 on a conv block; K4 and
     K4ᵀ on the narrow tiles w_if 1536x8 and w_B 2048x64 at adc9; each
     timed beside its plain version, its library yardstick and its bound;
     then for xlstm-125m (d 768, 12 blocks, vocab 50304) and zamba2-1.2b
     (d 2048, 38 mamba2 layers and 6 shared-block calls, vocab 32000) at
     full width, bf16, seed weights in 44466555 planes: its first mLSTM
     or mamba2 layer at adc9 forward and backward through the kernels bit
     for bit against the plain reads; (b) 3 training steps at 4 x 64
     tokens under ``coverage_rules`` with adc9 (projections operand leaves
     on K4/K1, ``conv_w`` im2col leaves on the im2col entry; CRS every 2,
     counter draw), one more under the profiler, the plain dwconv reads'
     and the scans' device ms, each step's kernel work held to the plan
     and to the wrappers' counts; (c) 4 x 32 prompts and 16 greedy tokens
     through the adc9 coverage plan, the engine on the bench's trace cut
     to its first 2 requests (continuous, 8 slots) through the adc9 tree,
     then through the lossless tree with every request's tokens equal to
     its solo serving's; last one step under ``default_rules`` (every
     mapped leaf dense on K2, ``conv_w`` digital);
 19. the last two architectures at full width, bf16, seed weights in
     44466555 planes, their depth cut (PERF.md §4): gemma2-9b (d 3584, 16
     heads / 8 KV of 256, d_ff 14336, window 4096, 4 of its 21 local/global
     pairs) and deepseek-v2-lite-16b (d 2048, MLA rank 512, 64 experts top-6
     of 1408 and 2 shared, ``mla_dense`` x 1 + ``mla_moe`` x 2): (a) K4
     forward and MᵀVM and K1 on gemma2's five tiles and on the ragged
     ``wq_dkv`` 2048x3648 at 256 rows, K4 on ``w_uk``/``w_uv`` at a decode
     step's 192 cache rows, each bit for bit against its plain version at
     adc9 and timed; (b) ``_sdpa_chunked`` against the explicit mask in f32
     over 5120 keys at gemma2's heads (window 4096 and none, softcap 50)
     and at MLA's 192/128 widths, within 2e-5, each timed; then for each
     arch: deepseek's expert tiles as phase 17 (a) reads granite's; 3
     coverage adc9 steps at 4 x 64 tokens and one profiled, every step's
     kernel work held to the plan (``plan_expected``) and the wrappers'
     counts; on gemma2 one 5120-token prompt on the lossless tree through
     the chunked path and 8 decode steps through the window, held to the
     forward's logits; 4 x 32 prompts and 16 greedy tokens at adc9, the
     engine on the bench's trace cut to 2 requests, the lossless engine's
     tokens equal to solo serving (deepseek's with no capacity drop); one
     ``default_rules`` step; the plain decode attention's device ms;
 20. the mesh (last; ``torch.distributed``, one process a mesh
     coordinate): (b) K1 and K2 on each block of a 2x2 split at its origin
     (gemma-2b's wi_gate 2048x16384 at 256 tokens under the counter, grid
     and hw draws; the embedding 256000x2048 under half to even, counter
     and grid; ideal and device) and K3 on the blocks, bit for bit against
     the same block of the whole-leaf kernel, K1 at an origin against its
     plain version; a rank's K4, K5, K1, K2 and K3 on its block timed
     beside the whole read, the plain version, the library yardstick and
     the bound; then a 2x2 world of four processes sharing the card over
     gloo (the backend rule's choice printed): (a) ``mvm_sliced_sharded``
     on gemma-2b's full-width tiles at 256 tokens, shard_dim None/0/1,
     both directions, K4 and K5, bit for bit against the single-process
     read at ideal ADC and within 1e-6 at adc9; (c) gemma-2b at full width
     on 2 of its 18 layers in f32, two adc9 and two ideal-ADC coverage
     steps under FSDP (the 1x2 world below steps the blocks with no data
     shards), against rank 0's single-process steps (losses
     within 1e-3 / 5e-3; the ideal step's weights within 1e-5 of max|w|;
     the adc9 weights printed), each step's launches held to the plan; (e)
     the FSDP state saved on the mesh, restored on one process; (d) prefill
     and decode through adc9 reads on the mesh against one process; then
     the engine on a 1x2 mesh over the trace's first 3 requests, adc9 and
     lossless (tokens equal to solo serving);
 21. remat and the dry run (last): (a) gemma-2b at full width (18 layers),
     adc9 (``default_rules``), 4 x 256 tokens, one state: a train step under
     ``remat="none"`` twice, then ``"full"`` and ``"dots"``, losses,
     metrics and every leaf bit for bit with the first ``"none"`` step
     wherever the two ``"none"`` runs agree; each step's ms and peak beside
     the dry run of the same step on meta tensors (``launch.dryrun``): its
     peak, within 5% of the card's, and its launches by kernel instance,
     which must equal the card's; (b) one row of 4096 tokens
     (``train_4k``'s length) under ``"full"``, and under ``"none"`` where
     the dry run predicts under 75 GiB: finite loss, ms, peak beside the dry
     run's (within 5%); (c) granite-moe at
     full width on 2 of its 24 layers, f32, on a (2, 1) world of two
     processes sharing the card over gloo: two ideal-ADC coverage steps of
     2 x 1024 tokens (each rank's tokens one whole dispatch group) under
     the default ``remat="full"``, each against one process stepping under
     ``"none"`` from the mesh's state before it (losses
     within 1e-3, the load-balance term within 1e-6 relative, weights within
     1e-5 of max|w|; the leaves furthest apart printed), K4's expert reads
     and K1's expert deposits counted on each rank; then prefill of 8 x 16
     tokens and
     a decode step on dispatch groups a rank does not hold whole (the
     gather), the logits within 1e-5 of max of one process's, argmax
     equal; (d) the im2col entry at a channel origin: zamba2's [8, 4, 4224]
     block cut in two, each half bit for bit against the whole leaf's
     launch, timed beside it.

It prints one JSON line with the kernels' numbers, the card's
``name, power.limit`` line, and last the device JSON line. Any failure exits
non-zero. Usage: ``python3 chip_smoke.py`` (no arguments).
"""
from __future__ import annotations

import collections
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path


SLICE_SHAPES = ((2048, 2560), (2048, 2048), (2048, 16384), (16384, 2048))  # gemma-2b reads
SLICE_READS = (("attn/wqkv", 2048, 2560), ("attn/wo", 2048, 2048), ("mlp/wi_gate", 2048, 16384),
               ("mlp/wi_up", 2048, 16384), ("mlp/wo", 16384, 2048))
EDGE_SHAPES = ((320, 2048), (256, 100))  # short last tile; ragged N
TOL = 1e-3  # |kernel - plain| <= TOL * (1 + max|plain|), as tests/test_kernels_mvm_fused.py
EMBED_SHAPE = (256000, 2048)  # gemma-2b's embedding: the dense-gradient leaf
RAGGED_SHAPE = (320, 100)
ODD_SHAPE = (33, 47)  # M·N not a multiple of 16: every element on K3's per-element routine
T_TRAIN = 256  # tokens per training step: batch 4 x seq 64
T_EDGE_SHAPES = ((2048, 320), (100, 256))  # MᵀVM: short last column tile; ragged M
T_OPA = (1, 17, 100, 256)  # K1's checks: one token, a ragged k-step, a ragged stage, the step's tokens


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(log: str) -> list:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its name with its
    template arguments, its registers and its spill bytes."""
    import re

    out, fn, spills = [], None, {}
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            fn = m.group(1)
        elif m := re.search(r"Function properties for (\S+)", line):
            props = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills[props] = m.groups()
        elif (m := re.search(r"Used (\d+) registers", line)) and fn:
            st, ld = spills.get(fn, ("?", "?"))
            name = kernel_name(fn)
            out.append(f"{name}<{template_args(fn, name)}>: {m.group(1)} registers, spill stores {st} bytes, "
                       f"loads {ld} bytes")
            fn = None
    return out


def template_args(mangled: str, name: str) -> str:
    """The template arguments of a kernel's mangled name: integer and bool
    values, and the input type (``float``: K4, ``int``: K5)."""
    i = mangled.find(f"{name}I")
    if i < 0:
        return ""
    i += len(name) + 1
    args = []
    while i < len(mangled) and mangled[i] != "E":
        if mangled[i] == "L":
            j = mangled.index("E", i)
            args.append(mangled[i + 2:j])
            i = j + 1
        else:
            args.append({"f": "float", "i": "int"}.get(mangled[i], mangled[i]))
            i += 1
    return ",".join(args)


def kernel_name(mangled: str) -> str:
    """The ``*_kernel`` component of a mangled name's nested names (each a
    length and that many characters), or the name itself."""
    i = mangled.find("_ZN") + 3 if "_ZN" in mangled else 2
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        ident, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
        if ident.endswith("_kernel"):
            return ident
    return mangled


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
    """Least time for one K4 read (``KW.read_work``): planes (int8), x
    (f32) and frac_bits read once, out (f32) written once, over HBM;
    2·B·M·N·S·(io_bits-1) int8 ops over the int8 peak."""
    from repro_torch.kernels import common as KW
    return KW.read_work(B, M, N, S, io_bits).bound_ms()


def phase_kernels(torch, K, ref, fp, spec, gen):
    """Kernel vs plain at the slice's shapes; timings at 1, 4, 5 and 128
    tokens, with K4's three bodies side by side."""
    from repro_torch.core.slicing import dequantize_planes

    dev = torch.device("cuda")
    max_err, worst = 0.0, 0.0
    timings = {}
    shapes = [(m, n, b) for (m, n) in SLICE_SHAPES for b in (*T_ROUNDS, 1, 4, 5, 16, 128, T_TRAIN)]
    shapes += [(m, n, b) for (m, n) in EDGE_SHAPES for b in (1, 4, 5, 16)]
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
        if (M, N) in SLICE_SHAPES and B in T_BODIES:
            reps = 20 if B < 128 else 5
            w = dequantize_planes(planes, 30, spec)
            x_q = ref.dac_quantize(x, xf[0], 16)
            t = {"ms": cuda_time_ms(lambda: K.mvm_sliced_fused(planes, x, xf, spec=spec, adc_bits=9), reps),
                 "plain_ms": cuda_time_ms(lambda: ref.mvm_sliced_fused_ref(planes, x, xf[0], spec, 16, 9), 2, 1),
                 "library_ms": cuda_time_ms(lambda: torch.matmul(x, w), reps),
                 # K5's dp4a body, asked for by name, on x_q: the same work
                 "dp4a_ms": cuda_time_ms(lambda: K.mvm_sliced(planes, x_q, spec=spec, adc_bits=9, body="dp4a"),
                                         reps)}
            t["bound_ms"], t["bound_by"] = bound_ms(B, M, N, spec.n_slices, 16)
            # the same read forced onto the tensor-core body, and onto the
            # decode body where it takes the shape (S·B <= 64)
            with forced_body(K, 0):
                t["mma_ms"] = cuda_time_ms(lambda: K.mvm_sliced_fused(planes, x, xf, spec=spec, adc_bits=9), reps)
            if spec.n_slices * B <= K.DECODE_MAX_SB:
                with forced_body(K, B):
                    t["decode_ms"] = cuda_time_ms(lambda: K.mvm_sliced_fused(planes, x, xf, spec=spec, adc_bits=9),
                                                  reps)
            timings[(M, N, B)] = t
            print(f"  M={M:5d} N={N:5d} B={B:3d} adc9: kernel {t['ms']:.4f} ms ({K.body_for(B, False)} body; "
                  + ", ".join(f"{BODY_NAMES[k]} {t[k]:.4f} ms" for k in BODY_NAMES if k in t)
                  + f")  plain {t['plain_ms']:.4f} ms  matmul {t['library_ms']:.4f} ms  "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})", flush=True)
            del w
        del planes, x
    on_decode = []
    for B in T_BODIES:
        t = layer_timings(timings, B)
        fastest = min((k for k in BODY_NAMES if k in t), key=t.get)
        if fastest == "decode_ms":
            on_decode.append(B)
        print(f"  one layer's 5 reads at {B} tokens, adc9: kernel {t['ms']:.4f} ms ({K.body_for(B, False)} body)  "
              + "  ".join(f"{BODY_NAMES[k]} {t[k]:.4f} ms" for k in BODY_NAMES if k in t)
              + f"  plain {t['plain_ms']:.4f} ms  matmul {t['library_ms']:.4f} ms  bound {t['bound_ms']:.4f} ms; "
              f"fastest: the {BODY_NAMES[fastest]}", flush=True)
    print(f"  crossover: the decode body is the fastest a layer at tokens {on_decode} of {list(T_BODIES)}; the "
          f"wrapper takes it for forward reads of at most DECODE_MAX_B = {K.DECODE_MAX_B}", flush=True)
    print(f"kernel vs plain: {len(shapes) * 3} cases, bit-identical at finite ADC, within {TOL}*(1+max|plain|) "
          f"at the ideal ADC; max |diff| {max_err} (product grid), max |diff|/(1+max|plain|) {worst}", flush=True)
    torch.cuda.empty_cache()
    return max_err, timings


# K4's bodies as phase 2 times them, by their key in the timings
BODY_NAMES = {"decode_ms": "decode body", "mma_ms": "tensor-core body", "dp4a_ms": "dp4a body (K5)"}
T_BODIES = (1, 4, 5, 8, 128)  # phase 2's timed token counts: decode (4) and its neighbours, a round (8), the prefill (128)
T_ROUNDS = (2, 3, 6, 7, 8)  # the widths an engine round reads: 8 (phase 15's 8 slots) and other slot grids


def layer_timings(timings, B):
    """Phase 2's timings of one layer's 5 reads at B tokens, summed by key."""
    rows = [timings[(m, n, B)] for _, m, n in SLICE_READS]
    out = {k: sum(r[k] for r in rows) for k in rows[0] if k != "bound_by"}
    out["bound_by"] = "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations"
    return out


class forced_body:
    """While inside, K4's forward reads of at most ``n`` tokens run the
    decode body and larger ones the tensor-core body (``n = 0``: every read
    on the tensor-core body)."""

    def __init__(self, K, n):
        self.K, self.n = K, n

    def __enter__(self):
        self.saved, self.K.DECODE_MAX_B = self.K.DECODE_MAX_B, self.n

    def __exit__(self, *exc):
        self.K.DECODE_MAX_B = self.saved


def profile_step(torch, step, what="decode step"):
    """One more step under torch.profiler: device time by kernel and the
    device's busy share of the step's wall time (profiler on), which it
    returns."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (the kernels themselves, not the aten ops that
    # launched them, whose device time would count the same kernels twice),
    # summed by name straight from the trace: key_averages() builds the whole
    # event tree first, which takes minutes at 10^5 kernels
    t0 = time.perf_counter()
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            row = by_name[e.name()]
            row[0] += e.duration_ns() / 1e6
            row[1] += 1
    rows = sorted(((ms, n, key) for key, (ms, n) in by_name.items()), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profiled {what}: wall {wall_ms:.1f} ms (profiler on), device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.0f}%), {sum(r[1] for r in rows)} kernels; the trace read in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for ms, n, key in rows[:10]:
        print(f"  {ms:9.3f} ms  x{n:<5d} {key[:100]}")
    return busy / wall_ms


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
    # the prefill's B·P tokens on the tensor-core body, the decode steps' B on the decode body
    bodies = {K.instance_name(False, 16, body=K.body_for(B * P, False)): 5 * layers,
              K.instance_name(False, 16, body=K.body_for(B, False)): 5 * layers * (T - 1)}
    print(f"K4 launches by instance: {instances}", flush=True)
    if launches != want or instances != bodies:
        raise AssertionError(f"kernel launches {launches} != 5 reads x {layers} layers x {T} steps = {want}, "
                             f"or by instance {instances} != {bodies}")
    if not all_finite:
        raise AssertionError("non-finite logits on the adc9 path")
    if not gap == gap or gap == float("inf"):
        raise AssertionError(f"adc9-vs-lossless gap not finite: {gap}")
    return instances


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


def misaligned(torch, planes, offset):
    """A contiguous copy of planes whose storage starts ``offset`` bytes past
    a 16-byte boundary (a layer view of an odd-shaped stack), and its
    buffer, zero around it."""
    buf = torch.zeros(planes.numel() + 32, dtype=torch.int8, device=planes.device)
    view = buf[offset:offset + planes.numel()].view(planes.shape)
    view.copy_(planes)
    return view, buf


def phase_update_kernels(torch, spec, gen):
    """crs (aligned and not) and opa_deposit bit for bit against their plain
    versions."""
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.crs import ref as RC
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO

    checks = 0
    for shape in (*SLICE_SHAPES, EMBED_SHAPE, RAGGED_SHAPE, ODD_SHAPE):
        planes = random_planes(torch, spec, shape, gen)
        want = plain_by_rows(torch, lambda p: RC.crs_ref(p, spec), planes)
        # at a 16-byte boundary and 5 bytes past one: the per-element head
        # and tail beside the 16-byte groups
        for offset in (0, 5):
            got, buf = misaligned(torch, planes, offset)
            KC.crs(got, spec=spec)
            torch.cuda.synchronize()
            if not torch.equal(got, want) or bool(buf[:offset].any()) or bool(buf[offset + got.numel():].any()):
                bad = int((got != want).sum())
                raise AssertionError(f"crs kernel (offset {offset}) vs plain at {shape}: {bad} plane cells "
                                     "differ, or it wrote outside its planes")
            checks += 1
            del got, buf
        del want
        p_q = rail_updates(torch, spec, shape, gen)
        want = plain_by_rows(torch, lambda p, q: RO.opa_deposit_ref(p, q, spec), planes, p_q)
        got = KO.opa_deposit(planes.clone(), p_q, spec=spec)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"opa_deposit kernel vs plain at {shape}: {bad} plane cells differ")
        checks += 1
        del planes, p_q, got, want
        torch.cuda.empty_cache()
    print(f"crs (planes 0 and 5 bytes past a 16-byte boundary), opa_deposit vs "
          f"plain: {checks} cases bit-identical (gemma-2b layer shapes, embedding {EMBED_SHAPE}, ragged "
          f"{RAGGED_SHAPE}, {ODD_SHAPE} with M·N off the 16-element grid; every rail hit)", flush=True)


# ------------------------ K2's dense write (opa_dense) ------------------------

NORM_SHAPE = (18, 2048)  # gemma-2b's norm-scale stacks: 2-D leaves, one block each
DENSE_DRAWS = ("rint", "counter", "grid")  # half to even, and the two dense rounding draws
DENSE_LR, DENSE_F = 1e-2, 20
DENSE_WORDS, DENSE_NOISE_WORDS = (0x2468ACE, -0x13579BD), (77, -99)


def dense_entry(torch, dtype, draw, dev):
    """A dense-write instance's name in the kernels line."""
    from repro_torch.kernels.sliced_opa import kernel as KO

    return "opa_dense_" + KO.dense_instance(dtype, draw, dev)


def dense_gradient(torch, shape, dtype, gen):
    """A dense gradient whose updates at (DENSE_LR, DENSE_F) mostly fall
    between grid points (the draw decides), 5% past the int32 rails, on
    ``dtype``'s grid."""
    x = torch.randn(shape, generator=gen, device="cuda")
    x *= 10.0 ** (torch.rand(shape, generator=gen, device="cuda") * 4 - 6)
    far = torch.rand(shape, generator=gen, device="cuda") < 0.05
    x[far] = torch.randn(int(far.sum()), generator=gen, device="cuda") * 1e9
    return x.to(dtype)


def dense_plain(torch, planes, g, spec, draw, dev=None, offset=0, rows=8192):
    """The dense write's plain version (``ref.opa_dense_ref``) by row
    blocks, so the embedding fits beside its temporaries."""
    from repro_torch.kernels.sliced_opa import ref as RO

    words = None if draw == "rint" else DENSE_WORDS
    out = torch.empty_like(planes)
    for r0 in range(0, planes.shape[1], rows):
        out[:, r0:r0 + rows] = RO.opa_dense_ref(planes[:, r0:r0 + rows], g[r0:r0 + rows], DENSE_LR, DENSE_F, spec,
                                                words, dev, DENSE_NOISE_WORDS, rng_mode="grid" if draw == "grid"
                                                else "counter", offset=offset, r0=r0)
    return out


@functools.lru_cache(maxsize=None)
def dense_frac():
    """DENSE_F as the 1-element device tensor a launch reads, made once so
    that no copy to the card is timed with a launch."""
    import torch

    return torch.tensor([DENSE_F], dtype=torch.int32, device="cuda")


def dense_launch(torch, planes, g, spec, draw, dev=None, offset=0):
    from repro_torch.kernels.sliced_opa import kernel as KO

    frac = dense_frac()
    return KO.opa_dense(planes, g, DENSE_LR, frac, spec=spec, key_words=None if draw == "rint" else DENSE_WORDS,
                        rng_mode="grid" if draw == "grid" else "counter", offset=offset, dev=dev,
                        noise_words=DENSE_NOISE_WORDS)


def dense_case(torch, planes, g, spec, draw, dev=None, offset=0, what=""):
    """One dense-write launch (on a copy of ``planes``) against its plain
    version: bit for bit, but for the write noise's one-LSB flips, counted
    (noise_flips). With stuck cells the launch runs twice, the first drawing
    and writing the block's stuck mask, the second reading it: both the
    same. Returns the flips."""
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO

    want = dense_plain(torch, planes, g, spec, draw, dev, offset)
    stuck = dev is not None and dev.stuck_frac > 0.0
    if stuck:  # the first launch at this shape writes the mask
        S, M, N = planes.shape
        for key in [k for k in KO._STUCK_BITS if k[1:] == (dev.stuck_seed, float(torch.tensor(dev.stuck_frac)),
                                                            S, M, N)]:
            del KO._STUCK_BITS[key]
    got = dense_launch(torch, planes.clone(), g, spec, draw, dev, offset)
    if stuck and not torch.equal(dense_launch(torch, planes.clone(), g, spec, draw, dev, offset), got):
        raise AssertionError(f"{what}: the launch that read the stuck mask differs from the one that wrote it")
    torch.cuda.synchronize()
    if torch.equal(got, want):
        return 0
    if dev is None or dev.write_noise == 0.0:
        raise AssertionError(f"{what}: {int((got != want).sum())} plane cells differ from the plain version")
    words = None if draw == "rint" else DENSE_WORDS
    p_q = RO.write_rows(RO.dense_increment(g, DENSE_LR, DENSE_F, dev), dev, 0, DENSE_NOISE_WORDS, words,
                        rng_mode="grid" if draw == "grid" else "counter", offset=offset)
    mask = RO.stuck_rows(dev, spec, 0, *g.shape, "cuda") if stuck else None
    return noise_flips(torch, got, want, planes, p_q, mask, spec, what)


def phase_dense_kernels(torch, spec, gen):
    """K2's dense write without device physics against its plain version,
    bit for bit: f32 and bf16 gradients under each rounding at the
    embedding, a [18, 2048] norm-scale stack, the MLP's three leaves (128x10
    ragged), 33x47 (M·N off the 16-cell grid: the scalar body) and planes 5
    bytes past a 16-byte boundary; then the entry point on a dense attn stack
    [18, 2048, 2560] against the reference's composition (``quantize`` and
    the deposit) on the card, one launch a layer."""
    from repro_torch.core import prng
    from repro_torch.core.fixed_point import quantize
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import opa_dense_update
    from repro_torch.kernels.sliced_opa import ref as RO

    cases = 0
    for shape in (EMBED_SHAPE, NORM_SHAPE, *MLP_SHAPES, ODD_SHAPE):
        planes = random_planes(torch, spec, shape, gen)
        for dtype in (torch.float32, torch.bfloat16):
            g = dense_gradient(torch, shape, dtype, gen)
            for draw in DENSE_DRAWS:
                dense_case(torch, planes, g, spec, draw, offset=17 * shape[0] * shape[1] if draw == "grid" else 0,
                           what=f"{dense_entry(torch, dtype, draw, False)} at {shape}")
                cases += 1
            del g
        del planes
        torch.cuda.empty_cache()
    planes = random_planes(torch, spec, MLP_SHAPES[2], gen)
    g = dense_gradient(torch, MLP_SHAPES[2], torch.float32, gen)
    view, buf = misaligned(torch, planes, 5)
    dense_launch(torch, view, g, spec, "counter")
    torch.cuda.synchronize()
    if not torch.equal(view, dense_plain(torch, planes, g, spec, "counter")) or bool(buf[:5].any()):
        raise AssertionError("opa_dense on planes 5 bytes past a 16-byte boundary vs plain")
    L, (M, N) = 18, SLICE_SHAPES[0]
    store = torch.randint(-8, 8, (L, spec.n_slices, M, N), generator=gen, device="cuda", dtype=torch.int8)
    g = torch.randn((L, M, N), generator=gen, device="cuda") * 1e-4
    for mode in ("counter", "grid"):
        key = prng.fold_in(prng.PRNGKey(5), 3)
        want = RO.opa_deposit_ref(store.movedim(1, 0), quantize(-RO._lr32(3e-2) * g, 24, stochastic=True, key=key,
                                                                  rng_mode=mode), spec)
        got = store.clone().movedim(1, 0)  # layer-major, as optim.panther stores a stack
        before = KO.opa_dense.launches
        opa_dense_update(got, g, 3e-2, torch.tensor(24, dtype=torch.int32, device="cuda"), spec, stochastic=True,
                         key=key, rng_mode=mode)
        torch.cuda.synchronize()
        if KO.opa_dense.launches - before != L or not torch.equal(got, want):
            raise AssertionError(f"opa_dense_update on an [{L}, {M}, {N}] stack under {mode}: "
                                 f"{KO.opa_dense.launches - before} launches, {int((got != want).sum())} cells off")
        del want, got
    del store, g
    torch.cuda.empty_cache()
    print(f"opa_dense (K2's dense write) vs plain: {cases} cases bit-identical (f32 and bf16 gradients, "
          f"{DENSE_DRAWS}, embedding {EMBED_SHAPE}, {NORM_SHAPE}, the MLP's {MLP_SHAPES}, {ODD_SHAPE}), planes 5 "
          f"bytes past a 16-byte boundary; an [{L}, {M}, {N}] stack through opa_dense_update, {L} launches, as "
          "quantize and the deposit under counter and grid", flush=True)


def drive_deposit_entry(torch, spec, gen):
    """The reference's ``opa_deposit`` API through the port's entry point
    (``ops.opa_deposit``: an int32 update already on the grid) at the
    dense leaves of gemma-2b (the embedding and the two norm-scale stacks,
    ideal and with stuck cells) and the MLP's three leaves, the counts set
    to 0 before and read after. Returns the launches by kernels-line
    entry."""
    from repro_torch.core.fixed_point import quantize
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import opa_deposit
    from repro_torch.models.common import DeviceModel

    stuck = DeviceModel(**PHYSICS["stuck"])
    KO.opa_deposit.launches = 0
    KO.opa_deposit.instances.clear()
    counts = {}
    for entry, shapes, dev in (("opa_deposit", (EMBED_SHAPE, NORM_SHAPE, NORM_SHAPE), None),
                               ("opa_deposit_stuck", (EMBED_SHAPE, NORM_SHAPE, NORM_SHAPE), stuck),
                               ("opa_deposit_mlp", MLP_SHAPES, None)):
        before = KO.opa_deposit.launches
        for shape in shapes:
            planes = torch.randint(-8, 8, (spec.n_slices, *shape), generator=gen, device="cuda", dtype=torch.int8)
            upd = quantize(torch.randn(shape, generator=gen, device="cuda") * 1e-6, DENSE_F)
            opa_deposit(planes, upd, spec, stuck=dev)
            del planes, upd
        counts[entry] = KO.opa_deposit.launches - before
    torch.cuda.synchronize()
    if dict(KO.opa_deposit.instances) != {"ideal": 6, "stuck": 3}:
        raise AssertionError(f"opa_deposit entry point: instances {dict(KO.opa_deposit.instances)}")
    torch.cuda.empty_cache()
    print(f"opa_deposit entry point (the reference's API, int32 updates): launches {counts}", flush=True)
    return counts


def phase_dense_device_kernels(torch, spec, gen):
    """K2's dense write on the non-ideal device against its plain version:
    each write-physics field alone and all together, f32 and bf16 gradients,
    each rounding, at a [18, 2048] norm-scale stack, the MLP's three leaves,
    a 2048x2560 block and 33x47, and with all fields at the embedding; bit
    for bit but for counted one-LSB write-noise flips, the stuck mask written
    by a first launch and read by a second. Returns the flips by entry."""
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO
    from repro_torch.models.common import DeviceModel

    flips, cases = {}, 0
    for shape in (NORM_SHAPE, *MLP_SHAPES, SLICE_SHAPES[0], ODD_SHAPE):
        planes = random_planes(torch, spec, shape, gen)
        for name, kw in PHYSICS.items():
            dev = DeviceModel(**kw)
            for dtype in (torch.float32, torch.bfloat16):
                g = dense_gradient(torch, shape, dtype, gen)
                for draw in DENSE_DRAWS:
                    entry = dense_entry(torch, dtype, draw, True)
                    flips[entry] = flips.get(entry, 0) + dense_case(
                        torch, planes, g, spec, draw, dev, 5 * shape[0] * shape[1] if draw == "grid" else 0,
                        f"{entry} ({name}) at {shape}")
                    cases += 1
            if dev.stuck_frac > 0.0:
                key = (planes.device, dev.stuck_seed, float(torch.tensor(dev.stuck_frac)), *planes.shape)
                if not torch.equal(KO._STUCK_BITS[key], RO.stuck_bits_ref(dev, spec, *shape, "cuda")):
                    raise AssertionError(f"the dense write's stuck mask at {shape} vs stuck_bits_ref")
        del planes
    dev = DeviceModel(**PHYSICS["all"])
    planes = random_planes(torch, spec, EMBED_SHAPE, gen)
    for dtype, draw in ((torch.float32, "counter"), (torch.float32, "grid"), (torch.bfloat16, "rint")):
        g = dense_gradient(torch, EMBED_SHAPE, dtype, gen)
        entry = dense_entry(torch, dtype, draw, True)
        flips[entry] = flips.get(entry, 0) + dense_case(torch, planes, g, spec, draw, dev, 0,
                                                        f"{entry} (all) at the embedding")
        cases += 1
        del g
    del planes
    torch.cuda.empty_cache()
    print(f"opa_dense device instances vs plain: {cases} cases (physics {list(PHYSICS)}, f32 and bf16, "
          f"{DENSE_DRAWS}, {NORM_SHAPE}, the MLP's {MLP_SHAPES}, {SLICE_SHAPES[0]}, {ODD_SHAPE}, all physics at the "
          "embedding; mask written, then read); elements that differ, each by one grid LSB: "
          + ", ".join(f"{k} {v}" for k, v in flips.items()), flush=True)
    return {k: float(v) for k, v in flips.items()}


def time_dense_kernels(torch, spec, gen):
    """Every dense-write instance on the 256000x2048 embedding (the device
    ones with all write fields, the stuck mask cached as after a first
    step): kernel, plain version and bound; no one library call computes
    it."""
    from repro_torch.kernels import common as KW
    from repro_torch.models.common import DeviceModel

    S, (V, D) = spec.n_slices, EMBED_SHAPE
    dev = DeviceModel(**PHYSICS["all"])
    planes = torch.randint(-8, 8, (S, V, D), generator=gen, device="cuda", dtype=torch.int8)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = dense_gradient(torch, EMBED_SHAPE, dtype, gen)
        for d in (None, dev):
            for draw in DENSE_DRAWS:
                k = cuda_time_ms(lambda: dense_launch(torch, planes, g, spec, draw, d), 5)
                p = cuda_time_ms(lambda: dense_plain(torch, planes, g, spec, draw, d), 1, 0)
                b = KW.dense_work(V, D, S, grad_bytes=g.element_size(), draw=draw, dev=d is not None).bound_ms()
                entry = dense_entry(torch, dtype, draw, d is not None)
                out[entry] = {"ms": k, "plain_ms": p, "library_ms": None, "bound_ms": b[0], "bound_by": b[1]}
                print(f"  {entry:30s} embedding {V}x{D}: kernel {k:.4f} ms  plain {p:.4f} ms  bound {b[0]:.4f} ms "
                      f"({b[1]}, {100 * b[0] / k:.0f}% of it)", flush=True)
        del g
    del planes
    torch.cuda.empty_cache()
    return out


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
    leaves) for opa_fused and the MᵀVM read, and the embedding's deposit for
    opa_deposit: kernel, plain version, library yardstick and bound."""
    from repro_torch.kernels import common as KW
    from repro_torch.core.slicing import dequantize_planes
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO

    S, T = spec.n_slices, T_TRAIN
    rows = {"opa_fused": [], "opa_fused_fma": [], "mvm_sliced_fused_transpose": [], "mvm_sliced_fused_256": []}
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
        b = KW.opa_work(T, M, N, S).bound_ms()
        rows["opa_fused"].append((k, p, lib, *b, k_fma))
        rows["opa_fused_fma"].append((k_fma, p, lib, *b))
        xf = torch.tensor([10], dtype=torch.int32, device="cuda")
        w = dequantize_planes(planes, 30, spec)
        b = KW.read_work(T, M, N, S, 16).bound_ms()
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
            d = cuda_time_ms(lambda: K.mvm_sliced(planes, x_q, spec=spec, adc_bits=9, transpose=transpose,
                                                  body="dp4a"), 3)
            rows[key].append((k, p, lib, *b, d))
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
    b = KW.deposit_work(V, D, S).bound_ms()
    print(f"  opa_deposit embedding {V}x{D}: kernel {k:.4f} ms  plain {p:.4f} ms  bound {b[0]:.4f} ms ({b[1]})",
          flush=True)
    del planes, p_q
    torch.cuda.empty_cache()

    out = {key: layer_total(rs, key) for key, rs in rows.items()}
    out["opa_deposit"] = {"ms": k, "plain_ms": p, "library_ms": None, "bound_ms": b[0], "bound_by": b[1]}
    for key in ("mvm_sliced_fused_transpose", "mvm_sliced_fused_256", "opa_fused"):
        print_layer_total(key, out[key], T)
    return out


def time_crs(torch, spec, gen):
    """K3 over one layer's 5 blocks and over the embedding's block: the
    kernel, the plain version, a device-to-device copy of the same bytes (the
    attainable-bandwidth reference: not the same function, so not a library
    yardstick) and the byte bound."""
    from repro_torch.kernels import common as KW
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.crs import ref as RC

    S = spec.n_slices
    out = {}
    for key, shapes in (("crs", [(m, n) for _, m, n in SLICE_READS]), ("crs_embedding", [EMBED_SHAPE])):
        t = {"ms": 0.0, "plain_ms": 0.0, "copy_ms": 0.0, "library_ms": None}
        cells = 0
        for M, N in shapes:
            planes = random_planes(torch, spec, (M, N), gen)
            dst = torch.empty_like(planes)
            reps = 10 if M * N < 2**26 else 5
            # the kernel and the copy in turns (ABBA), each the mean of its two
            timed = {"ms": lambda: KC.crs(planes, spec=spec), "copy_ms": lambda: dst.copy_(planes)}
            for k in (*timed, *reversed(timed)):
                t[k] += cuda_time_ms(timed[k], reps) / 2
            t["plain_ms"] += cuda_time_ms(lambda: plain_by_rows(torch, lambda p: RC.crs_ref(p, spec), planes), 1, 1)
            cells += S * M * N
            del planes, dst
            torch.cuda.empty_cache()
        t["bound_ms"], t["bound_by"] = KW.crs_work(cells).bound_ms()
        out[key] = t
        what = "one layer's 5 blocks" if key == "crs" else f"the embedding's block {EMBED_SHAPE}"
        print(f"  {key}: {what}: kernel {t['ms']:.4f} ms, "
              f"device-to-device copy of the same bytes {t['copy_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}); {100 * t['bound_ms'] / t['ms']:.1f}% of the bound, "
              f"{100 * t['copy_ms'] / t['ms']:.1f}% of the copy", flush=True)
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


class embedding_crs_launches:
    """While inside, K3's launches on the embedding's leaf are counted (a
    list of one int, yielded): the optimizer calls the CRS entry point
    ``repro_torch.kernels.crs.crs`` once a leaf, and around the call on the
    embedding's leaf the difference in the wrapper's own launch count is
    added."""

    def __enter__(self):
        import repro_torch.kernels.crs as pkg
        from repro_torch.kernels.crs import kernel as KC

        self.pkg, self.saved, count = pkg, pkg.crs, [0]

        def on_leaf(planes, spec):
            before = KC.crs.launches
            out = self.saved(planes, spec)
            if tuple(planes.shape[-2:]) == EMBED_SHAPE:
                count[0] += KC.crs.launches - before
            return out

        pkg.crs = on_leaf
        return count

    def __exit__(self, *exc):
        self.pkg.crs = self.saved


def phase_train(torch, gen, dense):
    """gemma-2b at full width: 3 adc9 steps, then 2 lossless steps, with
    every kernel's launches per step checked (the dense write's added to
    ``dense`` by instance). Returns the launch totals, the
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
                                plan_rules=planlib.default_rules(opt_cfg, fidelity=adc9), remat="none"),
        "lossless": make_train_step(cfg, opt_cfg, constant(3e-2), remat="none"),
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
    counters = {"opa_fused": (KO.opa_fused, "launches"), "opa_dense": (KO.opa_dense, "launches"),
                "opa_deposit": (KO.opa_deposit, "launches"), "crs": (KC.crs, "launches"),
                "mvm_sliced_fused": (KM.mvm_sliced_fused, "launches"),
                "mvm_sliced_fused_transpose": (KM.mvm_sliced_fused, "transpose_launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    totals = dict.fromkeys(counters, 0)
    totals["crs_embedding"] = 0
    before = snapshot(torch, state.sliced)
    torch.cuda.reset_peak_memory_stats()
    for step, mode in enumerate(("adc9", "adc9", "adc9", "lossless", "lossless")):
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        KO.opa_fused.instances.clear()
        KO.opa_dense.instances.clear()
        batch = ds.batch(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with embedding_crs_launches() as on_embedding:
            state, metrics = steps[mode](state, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        got = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        crs_step = step % opt_cfg.crs_every == opt_cfg.crs_every - 1
        want = {"opa_fused": blocks["operand"], "opa_dense": blocks["dense"], "opa_deposit": 0,
                "crs": blocks["operand"] + blocks["dense"] if crs_step else 0,
                "mvm_sliced_fused": 5 * L if mode == "adc9" else 0,
                "mvm_sliced_fused_transpose": 5 * L if mode == "adc9" else 0}
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        print(f"step {step} ({mode:8s}): {ms:.1f} ms, {4 * 64 / ms * 1e3:.0f} tokens/s, loss {loss:.4f}, "
              f"grad_norm {gnorm:.4f}, launches {got}", flush=True)
        if got != want:
            raise AssertionError(f"step {step} ({mode}): launches {got} != {want}")
        # K3 once on the embedding's block, every CRS step
        if on_embedding[0] != crs_step:
            raise AssertionError(f"step {step} ({mode}): {on_embedding[0]} K3 launches on the embedding")
        totals["crs_embedding"] += on_embedding[0]
        # bf16 operands: every block on K1's tensor-core instance, none on the CUDA-core ones
        if dict(KO.opa_fused.instances) != {"ideal": blocks["operand"]}:
            raise AssertionError(f"step {step} ({mode}): K1 instances {dict(KO.opa_fused.instances)}")
        # f32 dense gradients: every dense block in one pass of K2's dense write
        if dict(KO.opa_dense.instances) != {"f32_counter": blocks["dense"]}:
            raise AssertionError(f"step {step} ({mode}): K2 instances {dict(KO.opa_dense.instances)}")
        dense.update(KO.opa_dense.instances)
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"step {step}: loss {loss} or grad_norm {gnorm} not finite")
        for k in got:
            totals[k] += got[k]
        if step == 2:  # an adc9 step without CRS, after the first
            info = {"ms": ms}
    del totals["opa_dense"], totals["opa_deposit"]  # K2's entries count by instance (dense), or in phase 4
    info["peak"] = peak = torch.cuda.max_memory_allocated() / 2**30
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
    return totals, state, ds, blocks, info


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
T_CHECK = (1, 4, 100, 256)  # token counts of the new kernels' checks (K4 at 1 and 4 on its decode body)



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
                            k5_bodies(torch, K, ref, planes, x_q, got, spec, io, adc, transpose, gen)
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


def k5_bodies(torch, K, ref, planes, x_q, got, spec, io, adc, transpose, gen):
    """K5 on the body its shape takes (``got``) bit for bit against the other
    body asked for by name, and both on an out-of-range x_q (+-2^15, +-2^20,
    INT_MIN and any int32: the bits at and above io-1 are not streamed) bit
    for bit against each other and, at finite ADC, the plain version."""
    B = x_q.shape[0]
    other = "dp4a" if K.body_for(B, transpose, fused=False) == "mma" else "mma"
    wild = torch.randint(-2**31, 2**31, tuple(x_q.shape), generator=gen, device="cuda", dtype=torch.int64)
    wild = wild.to(torch.int32)
    wild[0, :5] = torch.tensor([2**15, -2**15, 2**20, -2**20, -2**31], dtype=torch.int32)
    for x, what in ((x_q, "x_q"), (wild, "out-of-range x_q")):
        a = got if x is x_q else K.mvm_sliced(planes, x, spec=spec, io_bits=io, adc_bits=adc, transpose=transpose)
        b = K.mvm_sliced(planes, x, spec=spec, io_bits=io, adc_bits=adc, transpose=transpose, body=other)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"K5{'ᵀ' if transpose else ''} io{io} adc{adc} B={B} on {what}: the "
                                 f"{K.body_for(B, transpose, fused=False)} body and the {other} body differ")
        if x is wild and adc is not None and not torch.equal(a, ref.mvm_sliced_ref(planes, x, spec, io, adc,
                                                                                    transpose=transpose)):
            raise AssertionError(f"K5{'ᵀ' if transpose else ''} io{io} adc{adc} B={B} on {what} vs plain")


def time_device_kernels(torch, spec, gen):
    """One layer's work at 256 tokens for each new instance, and the
    embedding's stuck deposit: kernel, plain version, library yardstick and
    bound, as in time_update_kernels."""
    from repro_torch.kernels import common as KW
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
        b = KW.opa_work(T, M, N, S, dev=True).bound_ms()
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
            # every K4 instance beside the dp4a body (K5's dp4a instance on
            # x_q, asked for by name: the same work without the DAC and the
            # read offsets) and K5 on the tensor-core body; on x = x_q·2^-10,
            # which the DAC maps back to x_q, the ideal-device instances
            # equal K5
            for io in (8, 12, 16):
                xq_io = ref.dac_quantize(xin, 10, io)
                x_io = xq_io.float() * 2.0**-10
                for adc in (9, None):
                    d_ms = cuda_time_ms(lambda: K.mvm_sliced(planes, xq_io, spec=spec, io_bits=io, adc_bits=adc,
                                                             transpose=transpose, body="dp4a"), 3)
                    k5_ms = cuda_time_ms(lambda: K.mvm_sliced(planes, xq_io, spec=spec, io_bits=io, adc_bits=adc,
                                                              transpose=transpose), 3)
                    for d in (None, dev):
                        got = K.mvm_sliced_fused(planes, x_io, xf, spec=spec, io_bits=io, adc_bits=adc,
                                                 transpose=transpose, dev=d)
                        if d is None and not torch.equal(
                                got, K.mvm_sliced(planes, xq_io, spec=spec, io_bits=io, adc_bits=adc,
                                                  transpose=transpose, body="dp4a")):
                            raise AssertionError(f"K4{tag} io{io} adc{adc} vs the dp4a body (K5) at M={M} N={N}: "
                                                 "not bit-identical")
                        k_ms = cuda_time_ms(lambda: K.mvm_sliced_fused(planes, x_io, xf, spec=spec, io_bits=io,
                                                                       adc_bits=adc, transpose=transpose, dev=d), 3)
                        add((transpose, io, adc, d is not None), k_ms, d_ms, k5_ms)
                # K5 at adc9 on the body the step's 256 tokens take (the
                # tensor-core body) beside its dp4a instance
                key = f"mvm_sliced{tag}" + ("" if io == 16 else f"_io{io}")
                p = cuda_time_ms(lambda: ref.mvm_sliced_ref(planes, xq_io, spec, io, 9, transpose=transpose),
                                 2, 1)
                k5, d5 = rows[(transpose, io, 9, False)][-1][2], rows[(transpose, io, 9, False)][-1][1]
                add(key, k5, p, lib_q, *KW.read_work(T, M, N, S, io, fused=False).bound_ms(), d5)
                del xq_io, x_io
            for key, io, d in ((f"mvm_sliced_fused{tag}_read_noise", 16, dev), (f"mvm_sliced_fused{tag}_io8", 8, None),
                               (f"mvm_sliced_fused{tag}_io12", 12, None)):
                k = cuda_time_ms(lambda: K.mvm_sliced_fused(planes, xin, xf, spec=spec, io_bits=io, adc_bits=9,
                                                            transpose=transpose, dev=d), 3)
                p = cuda_time_ms(lambda: ref.mvm_sliced_fused_ref(planes, xin, xf[0], spec, io, 9,
                                                                  transpose=transpose, device=d), 2, 1)
                add(key, k, p, lib, *KW.read_work(T, M, N, S, io).bound_ms(), rows[(transpose, io, 9, False)][-1][1])
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
    b = KW.deposit_work(V, D, S, stuck=True).bound_ms()
    print(f"  opa_deposit_stuck embedding {V}x{D}: kernel {k:.4f} ms  plain {p:.4f} ms  bound {b[0]:.4f} ms "
          f"({b[1]})", flush=True)
    del planes, p_q
    torch.cuda.empty_cache()

    print(f"every K4 instance, one layer's 5 reads at {T} tokens (tensor-core body; the dp4a body is K5's dp4a "
          "instance on x_q; bit-identical to K5 on the ideal device), and K5 on the tensor-core body:", flush=True)
    for transpose in (False, True):
        for io in (8, 12, 16):
            for adc in (9, None):
                for noisy in (False, True):
                    k_ms, d_ms, k5_ms = instance_time(rows, transpose, io, adc, noisy)
                    print(f"  K4{'ᵀ' if transpose else ' '} io{io:2d} adc {adc if adc else 'ideal':5} "
                          f"{'read noise' if noisy else 'ideal dev.':10s}: {k_ms:9.4f} ms   dp4a body {d_ms:9.4f} ms   "
                          f"{d_ms / k_ms:5.2f}x" + ("" if noisy else f"   K5 (tensor-core) {k5_ms:9.4f} ms   "
                                                   f"dp4a/K5 {d_ms / k5_ms:5.2f}x"), flush=True)
    out = {key: layer_total(rs, key) for key, rs in rows.items() if isinstance(key, str)}
    out["opa_deposit_stuck"] = {"ms": k, "plain_ms": p, "library_ms": None, "bound_ms": b[0], "bound_by": b[1]}
    print_layer_total("opa_fused_device", out["opa_fused_device"], T)
    return out


def instance_time(rows, transpose, io, adc, noisy):
    """(K4 ms, dp4a body ms, K5 tensor-core ms) of one instance over one
    layer's 5 reads."""
    rs = rows[(transpose, io, adc, noisy)]
    return tuple(sum(r[i] for r in rs) for i in range(3))


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


def phase_device_train(torch, state, ds, blocks, gen, dense):
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
    steps = {mode: make_train_step(cfg, opt_cfg, constant(3e-2), plan_rules=planlib.default_rules(opt_cfg, fidelity=f),
                                   remat="none")
             for mode, f in fids.items()}
    counted = (KO.opa_fused, KO.opa_dense, KO.opa_deposit, KM.mvm_sliced_fused)
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
        got = {"opa_fused": dict(KO.opa_fused.instances), "opa_dense": dict(KO.opa_dense.instances),
               "opa_deposit": KO.opa_deposit.launches, "crs": KC.crs.launches,
               "mvm": dict(KM.mvm_sliced_fused.instances)}
        io = 16 if mode == "device" else int(mode[2:])
        noise = mode == "device"
        want = {"opa_fused": {"device" if noise else "ideal": blocks["operand"]},
                "opa_dense": {KO.dense_instance(torch.float32, "counter", noise): blocks["dense"]}, "opa_deposit": 0,
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
                **{"mvm_sliced_fused_" + k.replace("io16_", ""): v for k, v in got["mvm"].items()}}
        dense.update(got["opa_dense"])
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
    on the DAC grid (batch 4 x 64), as the reference's unfused read serves
    it, at io 16, 8 and 12: every read of these 256 tokens on the
    tensor-core body. Returns the launch counts by kernels-line entry."""
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
    for io in (16, 8, 12):
        for path, planes in blocks:
            for transpose in (False, True):
                x = torch.randn((4, 64, planes.shape[2 if transpose else 1]), generator=g, device="cuda")
                x_q = ref.dac_quantize(x, choose_frac_bits(x, word_bits=io, margin_bits=1, clip_to_word=False), io)
                out = mvm_sliced_batched(planes, x_q, DEFAULT_SPEC, io_bits=io, adc_bits=9, transpose=transpose)
                finite &= bool(torch.isfinite(out).all()) and tuple(out.shape[:2]) == (4, 64)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    counts = dict(K.mvm_sliced.instances)
    want = {K.instance_name(t, io): len(blocks) for t in (False, True) for io in (8, 12, 16)}
    print(f"K5 path: {len(blocks)} operand blocks read forward and transposed at 4 x 64 tokens, adc9, io 16, 8 "
          f"and 12, in {s:.2f} s; launches by instance {counts}", flush=True)
    if counts != want or not finite:
        raise AssertionError(f"K5 path: launches {counts} for {len(blocks)} blocks (want {want}), finite {finite}")
    return {f"mvm_sliced{'_transpose' if t else ''}{'' if io == 16 else f'_io{io}'}": counts[K.instance_name(t, io)]
            for t in (False, True) for io in (8, 12, 16)}


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
    from repro_torch.kernels import common as KW
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
                b = KW.opa_work(T, M, N, S, dev=d is not None, draw=mode).bound_ms()
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


def phase_rng_train(torch, state, ds, blocks, dense):
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
                                                       plan_rules=planlib.default_rules(opt_cfg, fidelity=fid),
               remat="none")
            for fn in (KO.opa_fused, KO.opa_dense, KO.opa_deposit, KM.mvm_sliced_fused, KC.crs):
                fn.launches = 0
            for fn in (KO.opa_fused, KO.opa_dense, KM.mvm_sliced_fused):
                fn.instances.clear()
            crs_step = state.step % opt_cfg.crs_every == opt_cfg.crs_every - 1
            batch = ds.batch(state.step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            noise = kind == "device"
            got = {"opa_fused": dict(KO.opa_fused.instances), "opa_dense": dict(KO.opa_dense.instances),
                   "opa_deposit": KO.opa_deposit.launches, "crs": KC.crs.launches,
                   "mvm": dict(KM.mvm_sliced_fused.instances)}
            # dense leaves draw grid under grid, and counter under hw (no dense hw draw)
            k2 = KO.dense_instance(torch.float32, "grid" if mode == "grid" else "counter", noise)
            want = {"opa_fused": {KO.instance_name(noise, "mma", mode): blocks["operand"]},
                    "opa_dense": {k2: blocks["dense"]}, "opa_deposit": 0,
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
            dense.update(got["opa_dense"])
    out = {}

    def one_more():
        out["state"], _ = steps["grid", "adc9"](state, ds.batch(state.step))

    profile_step(torch, one_more, "adc9 train step under rng_mode grid")
    state = out["state"]
    # the dense leaves' draws under grid and counter in plain PyTorch, as the
    # dense write drew them before K2 took them in (the plain version's):
    # the embedding and the two [18, 2048] norm-scale stacks
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
    drive_dense_instances(torch, state, dense)
    return launches, state


def drive_dense_instances(torch, state, dense):
    """The dense write's entry point, ``opa_dense_update``, with f32 and
    bf16 gradients (bf16: which no training path of the port makes, its
    dense leaves differentiate f32 copies) on every dense leaf of the
    trained state, under each rounding, on the ideal and on the non-ideal
    device: one launch a block of every instance, the planes changed."""
    from repro_torch import tree
    from repro_torch.core import prng
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import opa_dense_update
    from repro_torch.models.common import DeviceModel

    g = torch.Generator(device="cuda").manual_seed(4)
    leaves = [(path, s) for path, s in tree.leaves_with_path(state.sliced)
              if s is not None and path[-1] not in ("wqkv", "wo", "wi_gate", "wi_up")]
    n_blocks = sum(math.prod(s.planes.shape[1:-2]) for _, s in leaves)
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for i, d in enumerate((None, DeviceModel(**PHYSICS["all"]))):
            for draw in DENSE_DRAWS:
                KO.opa_dense.instances.clear()
                for j, (path, s) in enumerate(leaves):
                    grad = (torch.randn(s.planes.shape[1:], generator=g, device="cuda") * 1e-3).to(dtype)
                    before = s.planes[:, ..., :4, :].clone()
                    opa_dense_update(s.planes, grad, 3e-2, s.frac_bits, DEFAULT_SPEC, stochastic=draw != "rint",
                                     key=prng.PRNGKey(100 * i + j), rng_mode="grid" if draw == "grid" else "counter",
                                     device=d)
                    if torch.equal(before, s.planes[:, ..., :4, :]):
                        raise AssertionError(f"{dtype} dense write ({draw}, device {d}) did not move {path}")
                got, want = dict(KO.opa_dense.instances), {KO.dense_instance(dtype, draw, d is not None): n_blocks}
                if got != want:
                    raise AssertionError(f"{dtype} dense write under {draw}: launches {got}, not {want}")
                dense.update(got)
    torch.cuda.synchronize()
    print(f"dense write through opa_dense_update: {len(leaves)} dense leaves ({n_blocks} blocks), f32 and bf16 "
          f"gradients under {DENSE_DRAWS}, ideal and non-ideal device, in {time.perf_counter() - t0:.2f} s; every "
          f"instance {n_blocks} launches", flush=True)


# ------------------- the paper MLP (phase 11) ----------------------------------

# The in-process reference's numbers (JAX 0.9.0 on the CPU: the reference's
# own run(), device_sweep(300) and quickstart loop); PERF.md records them.
JAX_LOSS_VS_SGD = {
    (3, 64): 3.3118276137623033, (3, 1024): 3.3118276137623033, (3, 4096): 3.3118276137623033,
    (4, 64): 2.7182284782952815, (4, 1024): 3.0438107466965953, (4, 4096): 3.0438107466965953,
    (5, 64): 2.0031028751884716, (5, 1024): 2.8971806215246105, (5, 4096): 2.8971806215246105,
    (6, 64): 1.5877245310931443, (6, 1024): 2.6577944833023217, (6, 4096): 2.6577944833023217,
}
JAX_SWEEP = {"dev_wn0": 0.204008087515831, "dev_ideal": 0.204008087515831, "dev_wn1e6": 0.2045062780380249,
             "dev_wn1e6_tt": 0.11580809205770493, "dev_wn4e6": 1.2477335929870605,
             "dev_wn4e6_tt": 0.18974363803863525, "dev_wn1e7": 0.8580390810966492,
             "dev_wn1e7_tt": 0.43726858496665955}
JAX_QUICKSTART = {1024: 0.45942264795303345, 25: 0.1068868562579155, "sgd": 0.05691220983862877}  # step 300
# Final losses within RUN_RTOL of the reference (tests/test_torch_paper_mlp.py,
# where the port's CPU run differs by 7e-6 at most). At write noise 4e6 and
# 1e7 the reference is chaotic: a one-ulp nudge of one input or weight moves
# its final loss by 9% to 11x (PERF.md), so those rows are printed beside it,
# not held.
RUN_RTOL = 1e-3
HELD_SWEEP = ("dev_wn0", "dev_ideal", "dev_wn1e6", "dev_wn1e6_tt")
# the quickstart rounds stochastically: its port on the CPU ends 6e-4 from the
# reference at step 300 (a flipped draw compounds), held here within 1e-2
QS_RTOL = 1e-2
MLP_SHAPES = ((64, 256), (256, 128), (128, 10))  # fig9's three crossbar leaves
T_MLP = 512  # fig9's rows: every step and the adc9 read take the whole batch


class checked_updates:
    """While inside, every ``optim.panther.update`` call is held to its
    launches: K2's dense write once a mapped leaf (and no int32 deposit),
    K3 once a mapped leaf on CRS steps and never otherwise, K1 never (the
    MLP's leaves have dense gradients).
    ``crs`` sums K3's launches by (spec, crs_every); ``steps`` counts the
    calls."""

    def __enter__(self):
        import repro_torch.optim.panther as P
        from repro_torch import tree
        from repro_torch.kernels.crs import kernel as KC
        from repro_torch.kernels.sliced_opa import kernel as KO

        self.P, self.saved, self.steps, self.crs = P, P.update, 0, {}

        def update(grads, state, params, lr, cfg=P.PantherConfig(), rng=None, plan=None):
            counted = (KO.opa_dense, KC.crs, KO.opa_fused, KO.opa_deposit)
            before = [c.launches for c in counted]
            out = self.saved(grads, state, params, lr, cfg, rng, plan)
            got = tuple(c.launches - b for c, b in zip(counted, before))
            mapped = sum(s is not None for _, s in tree.leaves_with_path(state.sliced))
            crs_step = state.step % cfg.crs_every == cfg.crs_every - 1
            if got != (mapped, mapped if crs_step else 0, 0, 0):
                raise AssertionError(f"MLP update at step {state.step} (CRS every {cfg.crs_every}): launches "
                                     f"K2/K3/K1/int32 K2 {got}, not {(mapped, mapped if crs_step else 0, 0, 0)}")
            key = (cfg.spec.name(), cfg.crs_every)
            self.crs[key] = self.crs.get(key, 0) + got[1]
            self.steps += 1
            return out

        P.update = update
        return self

    def __exit__(self, *exc):
        self.P.update = self.saved


def time_mlp_kernels(torch, gen):
    """The MLP's kernels at its own shapes, each checked against its plain
    version and timed beside it: K2 and K3 over the three leaves' blocks
    (S = 8), K4's adc9 read of the three layers at 512 tokens on its
    tensor-core body (M = 64 is a short crossbar tile, N = 10 ragged)."""
    from repro_torch.kernels import common as KW
    from repro_torch.core.slicing import DEFAULT_SPEC, dequantize_planes
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.crs import ref as RC
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.kernels.sliced_mvm import ref
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO

    spec, S = DEFAULT_SPEC, DEFAULT_SPEC.n_slices
    rows = {"opa_dense_mlp": [], "opa_deposit_mlp": [], "crs_mlp": [], "mvm_sliced_fused_mlp": []}
    err = 0.0
    xf = torch.tensor([10], dtype=torch.int32, device="cuda")
    for M, N in MLP_SHAPES:
        planes = random_planes(torch, spec, (M, N), gen)
        # K2's dense write as Fig 9 runs it: f32 gradients, half to even
        g = dense_gradient(torch, (M, N), torch.float32, gen)
        dense_case(torch, planes, g, spec, "rint", what=f"opa_dense at the MLP's {M}x{N}")
        k = cuda_time_ms(lambda: dense_launch(torch, planes, g, spec, "rint"), 50)
        p = cuda_time_ms(lambda: dense_plain(torch, planes, g, spec, "rint"), 10)
        rows["opa_dense_mlp"].append((k, p, None, *KW.dense_work(M, N, S, draw="rint").bound_ms()))
        p_q = rail_updates(torch, spec, (M, N), gen)
        if not torch.equal(KO.opa_deposit(planes.clone(), p_q, spec=spec), RO.opa_deposit_ref(planes, p_q, spec)):
            raise AssertionError(f"opa_deposit kernel vs plain at the MLP's {M}x{N}")
        got = planes.clone()
        KC.crs(got, spec=spec)
        if not torch.equal(got, RC.crs_ref(planes, spec)):
            raise AssertionError(f"crs kernel vs plain at the MLP's {M}x{N}")
        k = cuda_time_ms(lambda: KO.opa_deposit(planes, p_q, spec=spec), 50)
        p = cuda_time_ms(lambda: RO.opa_deposit_ref(planes, p_q, spec), 10)
        rows["opa_deposit_mlp"].append((k, p, None, *KW.deposit_work(M, N, S).bound_ms()))
        k = cuda_time_ms(lambda: KC.crs(planes, spec=spec), 50)
        p = cuda_time_ms(lambda: RC.crs_ref(planes, spec), 10)
        rows["crs_mlp"].append((k, p, None, *KW.crs_work(S * M * N).bound_ms()))
        x = torch.randn((T_MLP, M), generator=gen, device="cuda")
        got = K.mvm_sliced_fused(planes, x, xf, spec=spec, adc_bits=9)
        want = ref.mvm_sliced_fused_ref(planes, x, xf[0], spec, 16, 9)
        if not torch.equal(got, want):
            raise AssertionError(f"mvm_sliced_fused kernel vs plain at the MLP's {M}x{N}, {T_MLP} tokens")
        err = max(err, float((got - want).abs().max()))
        w = dequantize_planes(planes, 30, spec)
        k = cuda_time_ms(lambda: K.mvm_sliced_fused(planes, x, xf, spec=spec, adc_bits=9), 20)
        p = cuda_time_ms(lambda: ref.mvm_sliced_fused_ref(planes, x, xf[0], spec, 16, 9), 3, 1)
        lib = cuda_time_ms(lambda: torch.matmul(x, w), 50)
        rows["mvm_sliced_fused_mlp"].append((k, p, lib, *bound_ms(T_MLP, M, N, S, 16)))
        del planes, p_q, got, x, want, w, g
    launch_split(torch, spec, gen)
    out = {key: layer_total(rs, key) for key, rs in rows.items()}
    for key, t in out.items():
        lib = "-" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        print(f"  {key}: the MLP's 3 blocks: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library {lib}, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})", flush=True)
    return out, err


def launch_split(torch, spec, gen, n=200):
    """Where one K2 write of an MLP leaf (64x256, f32 gradient, Fig 9's half
    to even) spends its time: host microseconds a write (the loop's wall
    time over n writes, no sync inside, profiler off) against device
    microseconds (the kernels' time in a torch.profiler trace of the same
    loop), for the write before the redesign and after it
    (``opa_dense_update``: one launch, the arrays cached). "Before" is an
    emulation in this tree, not the earlier code: ``quantize`` in plain
    PyTorch, then the int32 deposit through today's kernel, its host arrays
    rebuilt every launch as the earlier wrapper did."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.fixed_point import quantize
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import opa_dense_update, opa_deposit
    from repro_torch.kernels.sliced_opa import ref as RO

    M, N = MLP_SHAPES[0]
    planes = random_planes(torch, spec, (M, N), gen)
    g = torch.randn((M, N), generator=gen, device="cuda") * 1e-3
    frac = torch.tensor(28, dtype=torch.int32, device="cuda")

    def before():
        KO._plane_max.cache_clear()
        opa_deposit(planes, quantize(-RO._lr32(0.03) * g, frac), spec)

    def after():
        opa_dense_update(planes, g, 0.03, frac, spec)

    for what, fn in (("before, emulated (quantize + int32 deposit, arrays rebuilt)", before),
                     ("after (opa_dense_update, arrays cached)", after)):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(e.device_time_total for e in kernels) / n
        print(f"  one K2 write of the MLP's {M}x{N} leaf, {what}: host {host_us:.1f} us, device {dev_us:.2f} us in "
              f"{sum(e.count for e in kernels) / n:.0f} kernels a write", flush=True)
    del planes, g


def phase_mlp(torch, gen):
    """The paper MLP end to end on the card (the port's quickstart, Fig 9's
    ``run()`` and ``device_sweep(300)``), every update's launches held
    (``checked_updates``), the adc9 reads' on K4's tensor-core body; the
    results against the in-process reference. Returns the launch totals,
    the timings and K4's max error."""
    from repro_torch import plan as planlib
    from repro_torch.benchmarks import fig9_slice_crs as F9
    from repro_torch.core.slicing import SliceSpec
    from repro_torch.examples import quickstart
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.sliced_mvm import kernel as KM
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.models.common import DeviceModel, FidelityConfig
    from repro_torch.optim import PantherConfig, panther

    timings, k4_err = time_mlp_kernels(torch, gen)
    counters = {"opa_dense_mlp": (KO.opa_dense, "launches"), "crs_mlp": (KC.crs, "launches"),
                "mvm_sliced_fused_mlp": (KM.mvm_sliced_fused, "launches"),
                "transpose": (KM.mvm_sliced_fused, "transpose_launches"), "opa_fused": (KO.opa_fused, "launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    KM.mvm_sliced_fused.instances.clear()
    KO.opa_dense.instances.clear()
    t0 = time.perf_counter()

    with checked_updates() as qs:
        out = quickstart.main(device="cuda")
    spec = quickstart.SPEC.name()
    if qs.steps != 2 * 301 or qs.crs != {(spec, 1024): 0, (spec, 25): 36}:
        raise AssertionError(f"quickstart: {qs.steps} updates, K3 by run {qs.crs}")
    finals = {c: out["panther"][c][0][-1] for c in quickstart.CRS_PERIODS} | {"sgd": out["sgd"][-1]}
    for k, v in finals.items():
        if not (math.isfinite(v) and abs(v - JAX_QUICKSTART[k]) <= QS_RTOL * JAX_QUICKSTART[k]):
            raise AssertionError(f"quickstart {k}: loss {v} at step 300, reference {JAX_QUICKSTART[k]}")
    print("quickstart: losses at step 300 (port / reference): " + ", ".join(
        f"{k} {finals[k]:.6f} / {JAX_QUICKSTART[k]:.6f}" for k in finals) + f" ({time.perf_counter() - t0:.1f} s)",
        flush=True)

    t1 = time.perf_counter()
    with checked_updates() as fig9:
        rows = F9.run(device="cuda")
    claims = F9.paper_claims(rows)
    print(f"fig9 run(): paper claims {claims} ({time.perf_counter() - t1:.1f} s)", flush=True)
    want_crs = {(f"{b}" * 8, c): 18 if c == 64 else 0 for b in F9.BITS for c in F9.CRS_PERIODS}
    if fig9.steps != 12 * 400 or fig9.crs != want_crs:
        raise AssertionError(f"fig9 run(): {fig9.steps} updates, K3 by configuration {fig9.crs}")
    if not all(claims.values()):
        raise AssertionError(f"fig9 paper claims {claims}")
    for r in rows:
        want = JAX_LOSS_VS_SGD[(r.bits, r.crs_every)]
        print(f"  bits {r.bits} CRS {r.crs_every:4d}: loss_vs_sgd {r.loss_vs_sgd:.6f} (reference {want:.6f}), "
              f"sat lo {r.sat_lo:.3f} hi {r.sat_hi:.3f}, adc9 loss {r.loss_adc9:.4f}, {r.us_per_step:.1f} us/step")
        if not abs(r.loss_vs_sgd - want) <= RUN_RTOL * want or not math.isfinite(r.loss_adc9):
            raise AssertionError(f"fig9 bits {r.bits} CRS {r.crs_every}: {r.loss_vs_sgd} vs reference {want}")

    t2 = time.perf_counter()
    with checked_updates() as dev:
        sweep = F9.device_sweep(device="cuda")
    print(f"fig9 device_sweep(300) ({time.perf_counter() - t2:.1f} s):", flush=True)
    for tag, row in sweep.items():
        held = "held" if tag in HELD_SWEEP else "printed only (chaotic in the reference)"
        print(f"  {tag:13s} final loss {row['final_loss']:.6f} (reference {JAX_SWEEP[tag]:.6f}, {held}), "
              f"{row['us_per_step']:.1f} us/step")
        if not math.isfinite(row["final_loss"]):
            raise AssertionError(f"device sweep {tag}: final loss {row['final_loss']}")
    if sweep["dev_ideal"]["final_loss"] != sweep["dev_wn0"]["final_loss"]:
        raise AssertionError("device sweep: dev_ideal differs from dev_wn0")
    for tag in HELD_SWEEP:
        if not abs(sweep[tag]["final_loss"] - JAX_SWEEP[tag]) <= RUN_RTOL * JAX_SWEEP[tag]:
            raise AssertionError(f"device sweep {tag}: {sweep[tag]['final_loss']} vs reference {JAX_SWEEP[tag]}")
    if not sweep["dev_wn1e6_tt"]["final_loss"] < sweep["dev_wn1e6"]["final_loss"]:
        raise AssertionError("device sweep: Tiki-Taka not below SGD at write noise 1e6")
    for sigma in ("4e6", "1e7"):
        below = sweep[f"dev_wn{sigma}_tt"]["final_loss"] < sweep[f"dev_wn{sigma}"]["final_loss"]
        print(f"  write noise {sigma}: Tiki-Taka {'below' if below else 'not below'} SGD in this run")
    if dev.steps != 8 * 300 or any(dev.crs.values()):
        raise AssertionError(f"device sweep: {dev.steps} updates, K3 {dev.crs}")

    got = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    want = {"opa_dense_mlp": 3 * (qs.steps + fig9.steps + dev.steps), "crs_mlp": 36 + 4 * 18,
            "mvm_sliced_fused_mlp": 3 * 12, "transpose": 0, "opa_fused": 0}
    if got != want or dict(KM.mvm_sliced_fused.instances) != {KM.instance_name(False, 16): 36}:
        raise AssertionError(f"the MLP phase's launches {got} (instances {dict(KM.mvm_sliced_fused.instances)}) "
                             f"!= {want}")
    # f32 gradients: the quickstart's counter draw, Fig 9's half to even, the sweep's device rows
    k2 = dict(KO.opa_dense.instances)
    if set(k2) != {"f32_counter", "f32_rint", "f32_rint_device"}:
        raise AssertionError(f"the MLP phase's dense-write instances {k2}")
    print(f"MLP phase launches: {got}, K2 by instance {k2}; {time.perf_counter() - t0:.1f} s", flush=True)
    launches = {k: got[k] for k in timings if k in got}  # the MLP's kernels-line entries of this phase

    # where a step's time goes: one Fig-9 step and one device step, profiled
    params0, batch = F9._task(0, torch.device("cuda"))
    tt = panther.tiki_taka(PantherConfig(stochastic_round=False, crs_every=1 << 20))
    fid = FidelityConfig(spec=tt.spec, device=DeviceModel(write_noise=4e6, asym_up=1.2, asym_down=0.8))
    for what, cfg, plan in (
            ("fig9 MLP step (4-bit, CRS 64)",
             PantherConfig(spec=SliceSpec.uniform(4), crs_every=64, stochastic_round=False), None),
            ("device-sweep MLP step (4e6, Tiki-Taka)", tt,
             planlib.resolve_plan(params0, planlib.default_rules(tt, fidelity=fid)))):
        state = panther.init(params0, cfg, plan=plan)
        carry = {"p": panther.materialize(params0, state, cfg), "s": state}

        def one(carry=carry, cfg=cfg, plan=plan):
            carry["p"], carry["s"] = panther.update(F9._grad(carry["p"], batch), carry["s"], carry["p"], 0.03, cfg,
                                                    plan=plan)

        for _ in range(3):
            one()
        profile_step(torch, one, what)
    return launches, timings, k4_err


# ------------------ microbatches and the stash rule (phase 12) -----------------

T_MICRO = 4 * 256  # the microbatched step's tokens a K1 launch: 4 microbatches of 4 x 64


def time_opa_microbatch(torch, spec, gen):
    """K1 at 1024 tokens over one layer's 5 blocks: bit for bit against its
    plain version on f32-exact bf16 operands (the tensor-core body), then
    timed beside the plain version, the library call ``xᵀ @ dh`` and the
    bound. Returns the kernels-line timing and the max error."""
    from repro_torch.kernels import common as KW
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO

    S, T, rs, err = spec.n_slices, T_MICRO, [], 0
    frac = torch.tensor([30], dtype=torch.int32, device="cuda")
    for name, M, N in SLICE_READS:
        planes = random_planes(torch, spec, (M, N), gen)
        x, dh = exact_operands(torch, T, M, N, torch.bfloat16, gen)
        f8 = torch.tensor([8], dtype=torch.int32, device="cuda")
        want = RO.opa_fused_ref(planes, x, dh, 2.0**-4, f8[0], spec, (5, 6))
        got = KO.opa_fused(planes.clone(), x, dh, 2.0**-4, f8, spec=spec, key_words=(5, 6))
        if not torch.equal(got, want):
            raise AssertionError(f"opa_fused at {T} tokens vs plain at {name}: planes differ")
        err = max(err, int((plane_values(torch, got) - plane_values(torch, want)).abs().max()))
        del got, want
        x = torch.randn((T, M), generator=gen, device="cuda").to(torch.bfloat16)
        dh = (torch.randn((T, N), generator=gen, device="cuda") * 1e-3).to(torch.bfloat16)
        k = cuda_time_ms(lambda: KO.opa_fused(planes, x, dh, 3e-2, frac, spec=spec, key_words=(1, 2)), 10)
        p = cuda_time_ms(lambda: RO.opa_fused_ref(planes, x, dh, 3e-2, frac[0], spec, (1, 2)), 2, 1)
        lib = cuda_time_ms(lambda: torch.matmul(x.t(), dh), 10)
        rs.append((k, p, lib, *KW.opa_work(T, M, N, S).bound_ms()))
        print(f"  opa_fused_microbatch {name:11s} M={M:5d} N={N:5d} T={T}: kernel {k:.4f} ms  plain {p:.4f} ms  "
              f"library {lib:.4f} ms  bound {rs[-1][3]:.4f} ms ({rs[-1][4]})", flush=True)
        del planes, x, dh
    torch.cuda.empty_cache()
    t = layer_total(rs, "opa_fused_microbatch")
    print(f"  opa_fused_microbatch: one layer's 5 blocks at {T} tokens: kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms", flush=True)
    return t, err


class calls_by:
    """While inside, the calls of ``module.name`` are counted by key (a
    Counter, yielded): ``key(args, kwargs)``, each call adding
    ``weight(args, kwargs)`` (1 without one). The wrapped function and its
    kernel's launch counters are untouched."""

    def __init__(self, module, name, key, weight=None):
        self.module, self.name, self.key, self.weight = module, name, key, weight

    def __enter__(self):
        self.saved, seen = getattr(self.module, self.name), collections.Counter()
        saved, key, weight = self.saved, self.key, self.weight

        def wrapped(*a, **k):
            seen[key(a, k)] += 1 if weight is None else weight(a, k)
            return saved(*a, **k)

        setattr(self.module, self.name, wrapped)
        return seen

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def phase_microbatch(torch, state, phase5, gen, dense):
    """gemma-2b at full width: one adc9 step with ``microbatches=4`` (16 x 64
    tokens as [4, 4, 64], the stash rule on: it sees 256 tokens and flips
    nothing) and one lossless step with ``stash_fallback=True`` at 4 x 320
    tokens (attn/wqkv and attn/wo flip to dense gradients), launches exact;
    then K1 at 1024 tokens timed. Returns the launches, the timing, the max
    error and the state."""
    import dataclasses

    from repro_torch import configs, tree
    from repro_torch import plan as planlib
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.sliced_mvm import kernel as KM
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ops
    from repro_torch.optim import PantherConfig
    from repro_torch.optim.schedules import constant
    from repro_torch.train.step import make_train_step, param_shapes

    cfg = configs.get("gemma_2b")
    L = cfg.n_layers
    opt_cfg = PantherConfig(crs_every=2, stochastic_round=True)
    adc9 = dataclasses.replace(configs.fidelity_presets()["adc9"], spec=opt_cfg.spec)
    counters = {"opa_fused": (KO.opa_fused, "launches"), "opa_dense": (KO.opa_dense, "launches"),
                "opa_deposit": (KO.opa_deposit, "launches"), "crs": (KC.crs, "launches"),
                "mvm_sliced_fused": (KM.mvm_sliced_fused, "launches"),
                "mvm_sliced_fused_transpose": (KM.mvm_sliced_fused, "transpose_launches")}
    mb = SyntheticLMDataset(cfg.vocab, 64, 16, seed=1, device="cuda").batch(0)
    mb = {k: v.reshape(4, 4, 64) for k, v in mb.items()}
    cases = (
        ("adc9, microbatches=4", mb, 1024, make_train_step(
            cfg, opt_cfg, constant(3e-2), microbatches=4,
            plan_rules=planlib.default_rules(opt_cfg, fidelity=adc9, stash_fallback=True), remat="none")),
        ("lossless, stash_fallback", SyntheticLMDataset(cfg.vocab, 320, 4, seed=2, device="cuda").batch(0), 1280,
         make_train_step(cfg, opt_cfg, constant(3e-2), stash_fallback=True, remat="none")),
    )
    shapes = param_shapes(state.digital, state.sliced)
    launches = {}
    for what, batch, tokens, step in cases:
        per_mb = batch["inputs"].shape[-2] * batch["inputs"].shape[-1]
        plan = planlib.resolve_plan(shapes, planlib.default_rules(opt_cfg, stash_fallback=True), tokens=per_mb)
        print(f"{what}: {tokens} tokens, the stash rule at {per_mb} tokens a microbatch:\n"
              + planlib.plan_summary(plan), flush=True)
        by = planlib.plan_by_path(plan)
        flipped = sorted(p for p, pl in by.items() if pl.mapped and pl.grad == "dense"
                         and planlib.operand_eligible_path(p))
        want_flipped = ["groups/0/attn/wo", "groups/0/attn/wqkv"] if tokens == 1280 else []
        if flipped != want_flipped:
            raise AssertionError(f"{what}: the stash rule flipped {flipped}, not {want_flipped}")
        operand = 5 * L - L * len(flipped)
        n_dense = 3 + L * len(flipped)  # the embedding, the two norm-scale stacks, the flipped leaves
        crs_step = state.step % opt_cfg.crs_every == opt_cfg.crs_every - 1
        reads = 5 * L * 4 if tokens == 1024 else 0
        want = {"opa_fused": operand, "opa_dense": n_dense, "opa_deposit": 0,
                "crs": operand + n_dense if crs_step else 0, "mvm_sliced_fused": reads,
                "mvm_sliced_fused_transpose": reads}
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        KO.opa_fused.instances.clear()
        KO.opa_dense.instances.clear()
        before = snapshot(torch, state.sliced)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with calls_by(ops, "opa_fused", lambda a, k: a[1].shape[0]) as seen:  # K1's tokens a block update
            state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        print(f"{what}: {ms:.1f} ms, {tokens / ms * 1e3:.0f} tokens/s, peak {peak:.1f} GiB (phase 5's 256-token "
              f"adc9 step: {phase5['ms']:.1f} ms, peak {phase5['peak']:.1f} GiB over its 5 steps), loss {loss:.4f}, "
              f"grad_norm {gnorm:.4f}, launches {got}, K1 tokens {sorted(set(seen))}", flush=True)
        if got != want:
            raise AssertionError(f"{what}: launches {got} != {want}")
        if dict(KO.opa_fused.instances) != {"ideal": operand} or set(seen) != {tokens}:
            raise AssertionError(f"{what}: K1 instances {dict(KO.opa_fused.instances)}, tokens {sorted(set(seen))}")
        # the flipped attn stacks and the embedding: f32 dense gradients, a launch a layer block
        if dict(KO.opa_dense.instances) != {"f32_counter": n_dense}:
            raise AssertionError(f"{what}: K2 instances {dict(KO.opa_dense.instances)}")
        dense.update(KO.opa_dense.instances)
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"{what}: loss {loss} or grad_norm {gnorm} not finite")
        after = snapshot(torch, state.sliced)
        if not all(bool((after[p] != before[p]).any()) for p in before):
            raise AssertionError(f"{what}: some leaf's planes did not change")
        if tokens == 1024:
            launches["opa_fused_microbatch"] = got["opa_fused"]
        del before, after, metrics
        torch.cuda.empty_cache()
    from repro_torch.core.slicing import DEFAULT_SPEC

    timing, err = time_opa_microbatch(torch, DEFAULT_SPEC, gen)
    return launches, {"opa_fused_microbatch": timing}, err, state


# ------------------ checkpoints at full width (phase 13) ----------------------

# the launcher's run: gemma-2b, adc9 reads, CRS every 3 steps, a checkpoint
# every 2; run 1 takes steps 0-1 and commits step 1, run 2 resumes and takes
# step 2, a CRS step, so K3 runs on the restored planes
CKPT_ARGS = ["--arch", "gemma-2b", "--batch", "4", "--seq", "64", "--fidelity", "adc9", "--crs-every", "3",
             "--ckpt-every", "2", "--log-every", "1", "--device", "cuda"]
CKPT_DISK_FACTOR = 2.2  # two commits on disk at once, and margin


class tee:
    """While inside, what is printed goes to the terminal and into a
    buffer (yielded)."""

    def __enter__(self):
        import io

        self.saved, self.buf = sys.stdout, io.StringIO()
        buf, saved = self.buf, self.saved

        class _Tee:
            def write(self, text):
                buf.write(text)
                return saved.write(text)

            def flush(self):
                saved.flush()

        sys.stdout = _Tee()
        return self.buf

    def __exit__(self, *exc):
        sys.stdout = self.saved


def state_bytes(cfg, opt_cfg):
    """Bytes of a train state's checkpoint at ``cfg``: S bytes a mapped
    cell, 4 a digital one (f32), from the param shapes."""
    from repro_torch import plan as planlib
    from repro_torch import tree
    from repro_torch.models import lm

    shapes = lm.param_shapes(cfg)
    plan = planlib.resolve_plan(shapes, planlib.default_rules(opt_cfg))
    return sum(math.prod(sd.shape) * (pl.spec.n_slices if pl.mapped else 4)
               for (_, sd), (_, pl) in zip(tree.leaves_with_path(shapes), tree.leaves_with_path(plan)))


def compare_commit(torch, commit, state):
    """Every leaf of the committed checkpoint ``commit`` against ``state``
    bit for bit, one leaf at a time on the card (a plane of a stack at a
    time), never a second state. Returns the leaves compared."""
    import numpy as np

    from repro_torch.checkpoint.manager import _flatten_with_paths
    from repro_torch.optim.panther import SlicedTensor

    with open(Path(commit) / "manifest.json") as f:
        manifest = json.load(f)
    mine = dict(_flatten_with_paths(state))
    if set(mine) != {m["path"] for m in manifest["leaves"]}:
        raise AssertionError(f"checkpoint paths differ from the state's: {sorted(set(mine) ^ {m['path'] for m in manifest['leaves']})}")

    def load(i):
        return np.load(Path(commit) / f"arr_{i:06d}.npy", mmap_mode="r")

    n = 0
    for meta in manifest["leaves"]:
        leaf, path = mine[meta["path"]], meta["path"]
        if meta["kind"] == "__none__":
            ok = leaf is None
        elif meta["kind"] == "__sliced_tensor__":
            planes, frac = load(meta["files"][0]), load(meta["files"][1])
            ok = isinstance(leaf, SlicedTensor) and tuple(planes.shape) == tuple(leaf.planes.shape) \
                and int(frac) == int(leaf.frac_bits) \
                and all(torch.equal(torch.from_numpy(np.array(planes[s])).cuda(), leaf.planes[s])
                        for s in range(planes.shape[0]))
        elif isinstance(leaf, torch.Tensor):
            arr = load(meta["files"][0])
            ok = torch.equal(torch.from_numpy(np.array(arr)).cuda(), leaf)
        else:  # the host step and rng words
            ok = np.array_equal(np.asarray(load(meta["files"][0])).reshape(-1), np.asarray(leaf).reshape(-1))
        if not ok:
            raise AssertionError(f"checkpoint leaf {path} differs from the uninterrupted run's")
        n += 1
    return n


def phase_checkpoint(torch):
    """gemma-2b at full width through the launcher's checkpoints: 2 adc9
    steps committed, a resumed run that takes step 2 (a CRS step) on the
    restored state, against an uninterrupted 3-step witness bit for bit
    (step 2's loss and grad norm, every leaf of the last commit); then a
    restore under another slice spec for one leaf, which must refuse."""
    import dataclasses
    import re
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch import plan as planlib
    from repro_torch.checkpoint import list_checkpoints, restore_latest
    from repro_torch.core.slicing import SliceSpec
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.sliced_mvm import kernel as KM
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.launch import train as launcher
    from repro_torch.optim import PantherConfig
    from repro_torch.optim.schedules import constant
    from repro_torch.train.step import make_train_step, param_shapes, train_state_init

    cfg = configs.get("gemma_2b")
    opt_cfg = PantherConfig(crs_every=3, stochastic_round=True)
    need = state_bytes(cfg, opt_cfg)
    root = tempfile.mkdtemp(prefix="panther_ckpt_")
    free = shutil.disk_usage(root).free
    print(f"checkpoint: a gemma-2b state is {need} bytes; {free} bytes free under {root} (need "
          f"{CKPT_DISK_FACTOR} x: two commits at once)", flush=True)
    if free < CKPT_DISK_FACTOR * need:
        shutil.rmtree(root)
        raise AssertionError(f"phase 13: {free} bytes free, {CKPT_DISK_FACTOR * need:.0f} needed for full depth")
    d = str(Path(root) / "ck")
    try:
        with tee() as out1:
            t0 = time.perf_counter()
            first = launcher.main(CKPT_ARGS + ["--steps", "2", "--ckpt-dir", d])
            run1_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        if list_checkpoints(d) != [1]:
            raise AssertionError(f"run 1 committed {list_checkpoints(d)}, not [1]")
        counters = {"opa_fused": (KO.opa_fused, "launches"), "opa_dense": (KO.opa_dense, "launches"),
                    "crs": (KC.crs, "launches"), "mvm_sliced_fused": (KM.mvm_sliced_fused, "launches"),
                    "mvm_sliced_fused_transpose": (KM.mvm_sliced_fused, "transpose_launches")}
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        with tee() as out2:
            t0 = time.perf_counter()
            resumed = launcher.main(CKPT_ARGS + ["--steps", "3", "--ckpt-dir", d])
            run2_s = time.perf_counter() - t0
        got = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        torch.cuda.empty_cache()
        L = cfg.n_layers
        # the launcher's step rematerializes each layer (remat="full", the
        # default): the backward reads each forward again
        want = {"opa_fused": 5 * L, "opa_dense": 3, "crs": 5 * L + 3, "mvm_sliced_fused": 2 * 5 * L,
                "mvm_sliced_fused_transpose": 5 * L}
        if "resumed from step 1" not in out2.getvalue().splitlines() or len(resumed) != 1 or got != want:
            raise AssertionError(f"run 2: {len(resumed)} steps, launches {got} (want {want}); it printed:\n"
                                 + out2.getvalue())
        if list_checkpoints(d) != [1, 2]:
            raise AssertionError(f"run 2 left commits {list_checkpoints(d)}, not [1, 2]")
        saves = [(int(m[1]), int(m[2]), float(m[3])) for m in
                 re.finditer(r"checkpoint: step (\d+): (\d+) bytes in \S+ \(([\d.]+) s\)", out1.getvalue() + out2.getvalue())]
        restore_s = float(re.search(r"restored step 1 from \S+ in ([\d.]+) s", out2.getvalue())[1])

        # the witness: the same code, uninterrupted
        state = train_state_init(cfg, opt_cfg, 0, device="cuda")
        fid = dataclasses.replace(configs.fidelity_presets()["adc9"], spec=opt_cfg.spec)
        rules = planlib.default_rules(opt_cfg, fidelity=fid)
        step_fn = make_train_step(cfg, opt_cfg, constant(3e-2), plan_rules=rules, remat="none")
        ds = SyntheticLMDataset(cfg.vocab, 64, 4, device="cuda")
        for step in range(3):
            state, metrics = step_fn(state, ds.batch(step))
        witness = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}
        mine = {k: resumed[0][k] for k in witness}
        print(f"step 2 (CRS) resumed: loss {mine['loss']!r}, grad_norm {mine['grad_norm']!r}; uninterrupted: "
              f"loss {witness['loss']!r}, grad_norm {witness['grad_norm']!r}", flush=True)
        if mine != witness:
            raise AssertionError(f"the resumed step 2 {mine} differs from the uninterrupted run's {witness}")
        commit = Path(d) / "step_000000002"
        t0 = time.perf_counter()
        n = compare_commit(torch, commit, state)
        print(f"every leaf of {commit.name} ({n}) equals the uninterrupted run's final state bit for bit "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

        # a restore under another slice spec for one leaf refuses before loading anything
        other = planlib.resolve_plan(param_shapes(state.digital, state.sliced), rules + (
            planlib.PlanRule("embed", spec=SliceSpec.uniform(6)),))
        try:
            restore_latest(d, state, plan=other)
        except ValueError as e:
            if "embed" not in str(e):
                raise AssertionError(f"the plan mismatch names another leaf: {e}") from e
            print(f"restore under another spec for embed refused: {str(e).splitlines()[0]}", flush=True)
        else:
            raise AssertionError("a restore under another slice spec for embed did not refuse")
        del state, metrics

        times = [r["time_s"] for r in first]
        steps_ms = [1e3 * t for t in (times[0], times[1] - times[0], resumed[0]["time_s"])]
        for step, nbytes, secs in saves:
            print(f"checkpoint save of step {step}: {nbytes} bytes in {secs:.2f} s, {nbytes / secs / 1e9:.2f} GB/s",
                  flush=True)
        print(f"checkpoint restore of step 1: {saves[0][1]} bytes in {restore_s:.2f} s, "
              f"{saves[0][1] / restore_s / 1e9:.2f} GB/s; the launcher's steps 0, 1 and the resumed CRS step 2: "
              f"{', '.join(f'{m:.1f}' for m in steps_ms)} ms (host clock, each ending in its log's sync); "
              f"run 1 {run1_s:.1f} s, run 2 {run2_s:.1f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


# ---------------------------- Fig 10 (phase 14) -------------------------------

# The in-process reference's numbers (JAX 0.9.0 on the CPU: the reference's
# own spec_sweep(400), io_sweep(400) and hetero_plan_demo(40)); PERF.md
# records them. Rows as (loss, loss_adc6, loss_adc9).
JAX_FIG10_SPEC = {
    "44444444": (0.22592826187610626, 0.24719662964344025, 0.246607705950737),
    "55555555": (0.21504457294940948, 0.26487836241722107, 0.27321383357048035),
    "66666666": (0.1972760260105133, 0.29666122794151306, 0.2851378917694092),
    "44466555": (0.20144210755825043, 0.2705255448818207, 0.2560124397277832),
    "44455566": (0.21743272244930267, 0.25507092475891113, 0.24990907311439514),
    "66655444": (0.212186798453331, 0.28662312030792236, 0.27828750014305115),
    "44444555": (0.2259252816438675, 0.24658413231372833, 0.24645593762397766),
    "33344455": (0.24023060500621796, 0.27194052934646606, 0.23781338334083557),
    "43333334": (0.24582193791866302, 0.27215272188186646, 0.2567799389362335),
}
JAX_FIG10_ENERGY_X = {"44444444": 2.0, "55555555": 2.8284271247461903, "66666666": 4.0, "44466555": 4.0, "44455566": 4.0, "66655444": 4.0, "44444555": 2.8284271247461903, "33344455": 2.8284271247461903, "43333334": 2.0}
JAX_FIG10_IO = {8: (0.2619117796421051, 6.847679485852733, 46.666666666666664), 12: (0.25740888714790344, 10.760639192054294, 73.33333333333333), 16: (0.2560124397277832, 14.673598898255856, 100.0)}  # (loss, mvm_tile_nj, mvm_tile_ns)
JAX_FIG10_CLAIMS = {"3bit_always_worst": True, "hetero_beats_uniform4": True}
JAX_FIG10_HETERO = (4.866611480712891, 4.833367824554443, 4.778995513916016, 4.709864616394043, 4.6840715408325195, 4.687353134155273, 4.701846122741699, 4.6423211097717285, 4.640377521514893, 4.542319297790527, 4.464871883392334, 4.47584342956543, 4.337571144104004, 4.257309913635254, 4.32137393951416, 4.237386226654053, 4.23861837387085, 4.153906345367432, 4.132732391357422, 4.080392837524414, 4.037062644958496, 3.9772720336914062, 3.9346470832824707, 3.931504249572754, 3.8932857513427734, 3.742276191711426, 3.774592876434326, 3.7268266677856445, 3.754971981048584, 3.480132579803467, 3.628476619720459, 3.522874355316162, 3.440855026245117, 3.4035582542419434, 3.3485183715820312, 3.4103405475616455, 3.274585485458374, 3.2157535552978516, 3.2595691680908203, 3.1882238388061523)
JAX_FIG10_SERVE = (3.2959117889404297, 4.544851779937744)  # hetero, lossless
# Rows within FIG10_ATOL of the reference (absolute): the port's CPU run is
# within 5e-6 relative on the losses and 4.2e-4 absolute on the ADC reads,
# which are discontinuous in their input (tests/test_torch_fig10.py).
FIG10_ATOL = 1e-3
# The heterogeneous demo trains through adc9 and adc6 reads from the
# reference's initial weights (within prng.normal's ulps): its first loss
# within HETERO_FIRST_RTOL of the reference's, every step within
# HETERO_TRACK_RTOL (tests/test_torch_fig10.py: 4.8e-4 and 2.9e-2 on the CPU)
HETERO_FIRST_RTOL, HETERO_TRACK_RTOL = 2e-3, 5e-2
FULL_HETERO_STEPS = 3


def fig10_kernels(torch, gen):
    """K2's dense write (half to even) and K4's 6- and 9-bit reads at the
    MLP's shapes, at each of Fig 10's nine specs, bit for bit against their
    plain versions: the specs the sweep runs them at."""
    from repro_torch.benchmarks import fig10_hetero as F10
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.kernels.sliced_mvm import ref

    xf = torch.tensor([10], dtype=torch.int32, device="cuda")
    for name in F10.CONFIGS:
        spec = F10._spec(name)
        for M, N in MLP_SHAPES:
            planes = random_planes(torch, spec, (M, N), gen)
            dense_case(torch, planes, dense_gradient(torch, (M, N), torch.float32, gen), spec, "rint",
                       what=f"opa_dense at {name}, {M}x{N}")
            x = torch.randn((T_MLP, M), generator=gen, device="cuda")
            for adc in (6, 9):
                got = K.mvm_sliced_fused(planes, x, xf, spec=spec, adc_bits=adc)
                if not torch.equal(got, ref.mvm_sliced_fused_ref(planes, x, xf[0], spec, 16, adc)):
                    raise AssertionError(f"mvm_sliced_fused at {name}, {M}x{N}, adc {adc} vs plain")
    print(f"Fig 10's kernels at its nine specs ({', '.join(F10.CONFIGS)}), the MLP's shapes: K2's dense write "
          "(half to even) and K4 at adc 6 and 9 bit for bit against their plain versions", flush=True)


def uniform6_kernels(torch, state, spec, gen):
    """K1 (half to even) and K4/K4ᵀ (adc9) at 66666666 on group 0's layer-0
    blocks of the full-width heterogeneous state, bit for bit against their
    plain versions (K1 on f32-exact bf16 operands), then timed at 256 tokens
    beside the plain version, the library call and the bound. Returns the
    two kernels-line timings and the max errors."""
    from repro_torch.kernels import common as KW
    from repro_torch.core.slicing import dequantize_planes
    from repro_torch.kernels.common import layer_views
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.kernels.sliced_mvm import ref
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO

    S, T = spec.n_slices, T_TRAIN
    rows = {"opa_fused_uniform6": [], "mvm_sliced_fused_uniform6": []}
    err = {"opa_fused_uniform6": 0, "mvm_sliced_fused_uniform6": 0.0}
    group0 = state.sliced["groups"][0]
    for name, M, N in SLICE_READS:
        sub, leaf = name.split("/")
        planes = layer_views(group0[sub][leaf].planes)[0]
        frac = group0[sub][leaf].frac_bits.reshape(1)
        x, dh = exact_operands(torch, T, M, N, torch.bfloat16, gen)
        f8 = torch.tensor([8], dtype=torch.int32, device="cuda")
        want = RO.opa_fused_ref(planes, x, dh, 2.0**-4, f8[0], spec, None)
        got = KO.opa_fused(planes.clone(), x, dh, 2.0**-4, f8, spec=spec)
        if not torch.equal(got, want):
            raise AssertionError(f"opa_fused at 66666666 vs plain at {name}")
        err["opa_fused_uniform6"] = max(err["opa_fused_uniform6"],
                                        int((plane_values(torch, got) - plane_values(torch, want)).abs().max()))
        x = torch.randn((T, M), generator=gen, device="cuda").to(torch.bfloat16)
        dh = (torch.randn((T, N), generator=gen, device="cuda") * 1e-3).to(torch.bfloat16)
        work = planes.clone()  # the timed launches update a copy: the state stays as trained
        k = cuda_time_ms(lambda: KO.opa_fused(work, x, dh, 0.3, frac, spec=spec), 10)
        p = cuda_time_ms(lambda: RO.opa_fused_ref(planes, x, dh, 0.3, frac[0], spec, None), 3, 1)
        lib = cuda_time_ms(lambda: torch.matmul(x.t(), dh), 10)
        rows["opa_fused_uniform6"].append((k, p, lib, *KW.opa_work(T, M, N, S).bound_ms()))
        w = dequantize_planes(planes, frac[0], spec)
        xf = torch.tensor([10], dtype=torch.int32, device="cuda")
        r = [0.0] * 3
        for transpose in (False, True):
            v = torch.randn((T, N if transpose else M), generator=gen, device="cuda")
            got = K.mvm_sliced_fused(planes, v, xf, spec=spec, adc_bits=9, transpose=transpose)
            want = ref.mvm_sliced_fused_ref(planes, v, xf[0], spec, 16, 9, transpose=transpose)
            if not torch.equal(got, want):
                raise AssertionError(f"mvm_sliced_fused (transpose={transpose}) at 66666666 vs plain at {name}")
            r[0] += cuda_time_ms(lambda: K.mvm_sliced_fused(planes, v, xf, spec=spec, adc_bits=9,
                                                            transpose=transpose), 5)
            r[1] += cuda_time_ms(lambda: ref.mvm_sliced_fused_ref(planes, v, xf[0], spec, 16, 9,
                                                                  transpose=transpose), 2, 1)
            r[2] += cuda_time_ms(lambda: torch.matmul(v, w.T if transpose else w), 10)
        b = KW.read_work(T, M, N, S, 16).bound_ms()
        rows["mvm_sliced_fused_uniform6"].append((*r, 2 * b[0], b[1]))
        for key, rs in rows.items():
            k, p, lib, b_ms, b_by = rs[-1]
            print(f"  {key:26s} {name:11s} M={M:5d} N={N:5d} T={T}: kernel {k:.4f} ms  plain {p:.4f} ms  "
                  f"library {lib:.4f} ms  bound {b_ms:.4f} ms ({b_by})", flush=True)
        del x, dh, w, v, got, want, work
    torch.cuda.empty_cache()
    out = {key: layer_total(rs, key) for key, rs in rows.items()}
    for key, t in out.items():
        print(f"  {key}: group 0's layer-0 blocks at {T} tokens: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})", flush=True)
    return out, err


def phase_hetero_full(torch, gen):
    """The heterogeneous plan at full width: gemma-2b (d 2048, d_ff 16384,
    vocab 256000, bf16) in two groups of 9 layers, group 0 at 66666666 with
    adc9 reads, group 1 at 44466555 with adc6; 3 steps at 8 x 32 tokens, lr
    0.3, then a prefill through ``fidelity_params``; K1 and K4/K4ᵀ launches
    counted by spec; then K1 and K4/K4ᵀ at 66666666 against their plain
    versions and timed. Returns the launches, the timings and the errors."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.benchmarks import fig10_hetero as F10
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.sliced_mvm import kernel as KM
    from repro_torch.kernels.sliced_mvm import ops as MO
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ops as OO
    from repro_torch.models import lm
    from repro_torch.optim import panther
    from repro_torch.optim.schedules import constant
    from repro_torch.serve.step import fidelity_params
    from repro_torch.train.step import make_train_step, train_state_init

    cfg = dataclasses.replace(configs.get("gemma_2b"), pattern=(("dense", 9), ("dense", 9)))
    opt, plan = F10.hetero_plan(cfg)
    spec6 = F10._spec("66666666")
    t0 = time.perf_counter()
    state = train_state_init(cfg, opt, gen, plan=plan, device="cuda")
    torch.cuda.synchronize()
    print(f"heterogeneous gemma-2b, {cfg.dtype}, groups {cfg.pattern}: init+slice {time.perf_counter() - t0:.1f} s",
          flush=True)
    ds = SyntheticLMDataset(cfg.vocab, 32, 8, seed=3, device="cuda")
    step = make_train_step(cfg, opt, constant(0.3), plan=plan, remat="none")
    counters = {"opa_fused": (KO.opa_fused, "launches"), "opa_dense": (KO.opa_dense, "launches"),
                "crs": (KC.crs, "launches"), "mvm_sliced_fused": (KM.mvm_sliced_fused, "launches"),
                "mvm_sliced_fused_transpose": (KM.mvm_sliced_fused, "transpose_launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    spec_of = lambda a, k: a[5].name()  # noqa: E731  (ops.opa_fused(planes, x, dh, lr, frac_bits, spec, ...))
    read_of = lambda a, k: (a[3].name(), k["transpose"])  # noqa: E731  (ops.mvm_sliced_fused(planes, x, frac, spec, ...))
    ms = []
    torch.cuda.reset_peak_memory_stats()
    with calls_by(OO, "opa_fused", spec_of) as k1, calls_by(MO, "mvm_sliced_fused", read_of) as k4:
        for i in range(FULL_HETERO_STEPS):
            batch = ds.batch(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            ms.append(1e3 * (time.perf_counter() - t0))
            print(f"heterogeneous step {i}: {ms[-1]:.1f} ms, loss {loss:.4f}, grad_norm {gnorm:.4f}", flush=True)
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise AssertionError(f"heterogeneous step {i}: loss {loss}, grad_norm {gnorm}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        train = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        params = panther.materialize_split(state.digital, state.sliced, opt)
        with torch.no_grad():
            t0 = time.perf_counter()
            logits, _ = lm.prefill(cfg, fidelity_params(params, state.sliced, plan), ds.batch(FULL_HETERO_STEPS)["inputs"])
            torch.cuda.synchronize()
            prefill_ms = 1e3 * (time.perf_counter() - t0)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("heterogeneous prefill: logits not finite")
        del params, logits
    n = FULL_HETERO_STEPS
    want_k1 = {"66666666": 45 * n, "44466555": 45 * n}
    want_k4 = {(s, t): 45 * (n + (not t)) for s in want_k1 for t in (False, True)}
    print(f"heterogeneous steps: {', '.join(f'{m:.1f}' for m in ms)} ms (phase 5 prints the adc9 step at 4 x 64 "
          f"tokens), peak {peak:.1f} GiB; prefill {prefill_ms:.1f} ms; launches over the steps "
          f"{train}; K1 by spec {dict(k1)}, K4 by (spec, transpose) {dict(k4)}", flush=True)
    if dict(k1) != want_k1 or dict(k4) != want_k4 or train["opa_fused"] != 90 * n \
            or train["crs"] != 0 or train["opa_dense"] != 5 * n:
        raise AssertionError(f"heterogeneous launches: K1 {dict(k1)} (want {want_k1}), K4 {dict(k4)} "
                             f"(want {want_k4}), totals {train}")
    launches = {"opa_fused_uniform6": k1["66666666"],
                "mvm_sliced_fused_uniform6": k4[("66666666", False)] + k4[("66666666", True)]}
    timings, err = uniform6_kernels(torch, state, spec6, gen)
    del state
    torch.cuda.empty_cache()
    return launches, timings, err


def phase_fig10(torch, gen):
    """Fig 10 on the card: both sweeps uncut against the in-process
    reference's rows, the heterogeneous demo at its own size against the
    reference's losses as far as they agree, the heterogeneous plan at full
    width, and the streamed OPA once. Returns the launches, the timings
    and the errors of the two 66666666 entries."""
    from repro_torch.benchmarks import fig10_hetero as F10
    from repro_torch.core import opa
    from repro_torch.core.slicing import SliceSpec, slice_weights

    t0 = time.perf_counter()
    fig10_kernels(torch, gen)
    with checked_updates() as sweep:
        rows = F10.spec_sweep(device="cuda")
        io = F10.io_sweep(device="cuda")
    if sweep.steps != 10 * 400 or any(sweep.crs.values()):
        raise AssertionError(f"Fig 10 sweeps: {sweep.steps} updates, K3 {sweep.crs}")
    for name, (loss, a6, a9) in JAX_FIG10_SPEC.items():
        r = rows[name]
        got = (r["loss"], r["loss_adc6"], r["loss_adc9"])
        print(f"  {name}: loss {got[0]:.6f} / {loss:.6f}, adc6 {got[1]:.6f} / {a6:.6f}, adc9 {got[2]:.6f} / {a9:.6f} "
              f"(port / reference), mvm_energy_x {r['mvm_energy_x']!r}, {r['us_per_step']:.1f} us/step")
        if not all(abs(g - w) <= FIG10_ATOL for g, w in zip(got, (loss, a6, a9))) \
                or r["mvm_energy_x"] != JAX_FIG10_ENERGY_X[name]:
            raise AssertionError(f"fig10 {name}: {r} vs reference {(loss, a6, a9)}, {JAX_FIG10_ENERGY_X[name]}")
    for io_bits, (loss, nj, ns) in JAX_FIG10_IO.items():
        r = io[f"io{io_bits}"]
        print(f"  io{io_bits}: loss {r['loss']:.6f} / {loss:.6f}, mvm_tile_nj {r['mvm_tile_nj']!r}, "
              f"mvm_tile_ns {r['mvm_tile_ns']!r}")
        if abs(r["loss"] - loss) > FIG10_ATOL or (r["mvm_tile_nj"], r["mvm_tile_ns"]) != (nj, ns):
            raise AssertionError(f"fig10 io{io_bits}: {r} vs reference {(loss, nj, ns)}")
    claims = F10.paper_claims(rows)
    if {k: claims[k] for k in JAX_FIG10_CLAIMS} != JAX_FIG10_CLAIMS:
        raise AssertionError(f"fig10 paper claims {claims}, the reference's {JAX_FIG10_CLAIMS}")
    print(f"fig10 sweeps ({time.perf_counter() - t0:.1f} s): rows within {FIG10_ATOL} of the reference, energy exact, "
          f"paper claims {claims}", flush=True)

    t1 = time.perf_counter()
    demo = F10.hetero_plan_demo(device="cuda")
    losses = demo["train_losses"]
    first = abs(losses[0] - JAX_FIG10_HETERO[0]) / JAX_FIG10_HETERO[0]
    track = [abs(a - b) / b for a, b in zip(losses, JAX_FIG10_HETERO)]
    serve = [abs(a - b) / b for a, b in zip((demo["serve_loss_hetero"], demo["serve_loss_lossless"]), JAX_FIG10_SERVE)]
    print(f"fig10 hetero demo ({time.perf_counter() - t1:.1f} s), against the reference's {len(JAX_FIG10_HETERO)} "
          f"steps: first loss {losses[0]:.6f} / {JAX_FIG10_HETERO[0]:.6f} ({first:.2e}), last {losses[-1]:.6f} / "
          f"{JAX_FIG10_HETERO[-1]:.6f}, every step within {max(track):.2e}, served within {max(serve):.2e} relative",
          flush=True)
    if demo["n_distinct_specs"] < 2 or demo["n_distinct_adc"] < 2 or len(losses) != len(JAX_FIG10_HETERO) \
            or first > HETERO_FIRST_RTOL or max(track + serve) > HETERO_TRACK_RTOL:
        raise AssertionError(f"fig10 hetero demo: {demo}")

    launches, timings, err = phase_hetero_full(torch, gen)

    # the streamed OPA once on the card against its CPU result
    g = torch.Generator().manual_seed(5)
    spec = SliceSpec.uniform(8)
    planes = slice_weights(torch.randint(-2**20, 2**20, (12, 10), generator=g, dtype=torch.int32), spec)
    x = torch.randint(-2**10, 2**10, (6, 12), generator=g, dtype=torch.int32)
    a = torch.randint(-2**10, 2**10, (6, 10), generator=g, dtype=torch.int32)
    big = torch.full((3, 4), 2**30, dtype=torch.int32)
    if not (torch.equal(opa.opa_stream_batch(planes.cuda(), x.cuda(), a.cuda(), spec).cpu(),
                        opa.opa_stream_batch(planes, x, a, spec))
            and torch.equal(opa.outer_product_int(big.cuda(), big.cuda()).cpu(), opa.outer_product_int(big, big))):
        raise AssertionError("the streamed OPA or the int32 outer product differs between the card and the CPU")
    print("streamed OPA (opa_stream_batch, 6 x 12 x 10) and a wrapping outer_product_int: the card equals the CPU",
          flush=True)
    return launches, timings, err


# ------------------ the serving engine at full width (phase 15) -----------------

ENGINE_REQUESTS = 32  # the reference bench's trace (src/repro/launch/serve.py:70-79)
# phases 15-16 serve gemma-2b at full width and 2 of its 18 layers: the
# whole script must finish inside its time limit on a slow host (PERF.md §4)
ENGINE_LAYERS = 2
# (d): one round's step budgets over the 8 slots; slots 6 and 7 hold no request
DENSE_CHECK_STEPS = (8, 8, 3, 8, 1, 8, 0, 0)


def served_equal(a, b) -> bool:
    """Two ``run_trace`` results with the same tokens and ``token_times``,
    request by request, bit for bit."""
    return [(r.rid, r.tokens, r.token_times) for r in a["requests"]] == \
        [(r.rid, r.tokens, r.token_times) for r in b["requests"]]


def print_summary(what, s):
    print(f"  {what}: {s['tokens']} tokens in {s['makespan_s']:.3f} s virtual, {s['tokens_per_sec']:.2f} tokens/s; "
          f"inter-token p50 {s['per_token_p50_ms']:.2f} / p99 {s['per_token_p99_ms']:.2f} ms; TTFT p50 "
          f"{s['ttft_p50_ms']:.1f} / p99 {s['ttft_p99_ms']:.1f} ms", flush=True)


def solo_tokens(torch, cfg, params, req):
    """Greedy tokens of single-request serving: batch 1, dense caches,
    scalar positions (``serve.step``)."""
    from repro_torch.models import lm
    from repro_torch.serve import kv_pages
    from repro_torch.serve.step import make_decode_step, make_prefill

    L = len(req.tokens)
    logits, caches = make_prefill(cfg)(params, torch.as_tensor(req.tokens, device="cuda").long()[None])
    caches = kv_pages.grow_caches(cfg, lm.unstack_caches(cfg, caches), L + req.out_len)
    tok = torch.argmax(logits, dim=-1)
    out, decode = [tok], make_decode_step(cfg)
    for i in range(req.out_len - 1):
        tok, _, caches = decode(params, tok.long(), caches, L + i)
        out.append(tok)
    return [int(t) for t in torch.cat(out).cpu()]


def paged_against_dense(torch, cfg, params, trace, costs):
    """(d): one round of 8 slots (6 requests, 2 dead slots, 2 exhausted
    mid-round) on the engine's page pools, then the same steps on dense
    per-slot caches gathered from the pools before the round, at the same
    vector positions and width: every step's logits and tokens equal bit
    for bit. Returns the engine (its slots still admitted)."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.models import lm
    from repro_torch.models.common import paged_gather
    from repro_torch.serve.engine import Engine

    eng = Engine(cfg, params, n_slots=8, max_seq=160, page=16, chunk_size=16, costs=costs, device="cuda")
    for req in trace[:6]:
        job = eng.start(req.tokens)
        while not job.finished:
            eng.prefill_step(job)
        eng.admit(job)
    steps = np.asarray(DENSE_CHECK_STEPS)
    T = int(steps.max())
    before = tree.map(lambda t: t.clone(), eng.caches)
    seen, decode_step = [], lm.decode_step

    def recorded(cfg_, params_, tok, caches, pos):
        logits, caches = decode_step(cfg_, params_, tok, caches, pos)
        seen.append((tok.clone(), pos.clone(), logits.clone()))
        return logits, caches

    lm.decode_step = recorded
    try:
        toks, _ = eng.decode_round(T, steps)
    finally:
        lm.decode_step = decode_step
    # a dead slot reads page P - 1 wherever its table holds the sentinel;
    # that page held by no slot, nothing writes it during the round
    if (eng.alloc.table == eng.spec.num_pages - 1).any() or len(seen) != T:
        raise AssertionError(f"(d): page {eng.spec.num_pages - 1} allocated, or {len(seen)} steps for T={T}")
    table = eng.alloc.device_table("cuda")
    dense = tree.map(lambda pool: paged_gather(pool, table), before)
    live_rows = torch.as_tensor(steps > 0, device="cuda")
    for i, (tok, pos, logits_paged) in enumerate(seen):
        with torch.no_grad():
            logits, _ = decode_step(cfg, params, tok, dense, pos)
        live = torch.as_tensor(steps > i, device="cuda")
        nxt = torch.where(live, torch.argmax(logits, dim=-1), tok)
        if not (torch.equal(logits[live_rows], logits_paged[live_rows]) and torch.equal(logits, logits_paged)
                and (nxt.cpu().numpy() == toks[i]).all()):
            diff = float((logits.float() - logits_paged.float()).abs().max())
            raise AssertionError(f"(d) step {i}: dense vs paged logits max |diff| {diff}, tokens "
                                 f"{nxt.cpu().tolist()} vs the engine's {toks[i].tolist()}")
    print(f"  (d) one round, paged vs dense: {T} steps x 8 slots (budgets {steps.tolist()}), logits and tokens "
          f"bit for bit", flush=True)
    return eng


def phase_engine(torch, K, gen):
    """gemma-2b at full width, ENGINE_LAYERS deep, through the
    continuous-batching engine."""
    import contextlib
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch import plan as planlib
    from repro_torch.kernels.sliced_mvm import ops as KOPS
    from repro_torch.launch import serve as LS
    from repro_torch.models import lm
    from repro_torch.optim import PantherConfig, panther
    from repro_torch.serve import scheduler as sch
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.step import fidelity_params

    cfg = dataclasses.replace(configs.get("gemma_2b"), n_layers=ENGINE_LAYERS, pattern=(("dense", ENGINE_LAYERS),))
    layers = cfg.n_layers
    t0 = time.perf_counter()
    opt_cfg = PantherConfig()
    params0 = lm.init_params(cfg, gen, device="cuda")
    digital, sliced = panther.init_split(params0, opt_cfg)
    del params0
    dense = panther.materialize_split(digital, sliced, opt_cfg)
    adc9 = configs.fidelity_presets()["adc9"]
    adc9_plan = planlib.resolve_plan(dense, planlib.default_rules(opt_cfg, fidelity=adc9))
    params = fidelity_params(dense, sliced, plan=adc9_plan)
    trace = LS.bench_trace(cfg, ENGINE_REQUESTS, seed=0, rate=1e4)
    print(f"engine: gemma-2b state ({layers} layers) {time.perf_counter() - t0:.1f} s; trace of {len(trace)} "
          f"requests, prompts "
          f"{sorted(collections.Counter(len(r.tokens) for r in trace).items())}, outputs "
          f"{sorted(collections.Counter(r.out_len for r in trace).items())}; {LS.N_SLOTS} slots, page {LS.PAGE}, "
          f"chunk {LS.CHUNK}, max_seq {LS.MAX_SEQ}", flush=True)

    # (a)/(b): both policies through the adc9 tree on one cost table; every
    # model pass counted (calibration runs too), K4's launches by token count
    costs = {}
    K.mvm_sliced_fused.launches = 0
    K.mvm_sliced_fused.instances.clear()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        prefills = stack.enter_context(calls_by(Engine, "_prefill_fn", lambda a, k: len(a[1][0])))
        chunks = stack.enter_context(calls_by(Engine, "_cont_fn", lambda a, k: len(a[1][0])))
        rounds = stack.enter_context(calls_by(Engine, "_round_fn", lambda a, k: a[1]))
        # K4's entry point: one launch a call on the card (the wrapper's own
        # counts, read below, are by instance only)
        by_tokens = stack.enter_context(calls_by(KOPS, "mvm_sliced_fused", lambda a, k: a[1].shape[0]))
        runs, costs = LS.run_policies(cfg, params, trace, "cuda", costs)
    wall = time.perf_counter() - t0
    passes = sum(prefills.values()) + sum(chunks.values()) + sum(T * n for T, n in rounds.items())
    want = 5 * layers * passes
    bodies = {K.instance_name(False, 16, body=K.body_for(n, False)) for n in by_tokens}
    print(f"  (a) both policies: wall {wall:.1f} s; prefills by length {dict(prefills)}, chunks {dict(chunks)}, "
          f"rounds by T {dict(rounds)} (calibrations included); {len(costs)} costs calibrated: "
          + ", ".join(f"{k}: {1e3 * v:.1f} ms" for k, v in sorted(costs.items(), key=str)), flush=True)
    print(f"  (b) K4 launches {K.mvm_sliced_fused.launches} by instance {dict(K.mvm_sliced_fused.instances)}, "
          f"by tokens a read {dict(sorted(by_tokens.items()))}", flush=True)
    if (K.mvm_sliced_fused.launches != want or dict(K.mvm_sliced_fused.instances) != {"io16": want}
            or sum(by_tokens.values()) != want or bodies != {"io16"}):
        raise AssertionError(f"(b) K4 launches {K.mvm_sliced_fused.launches} ({dict(K.mvm_sliced_fused.instances)}) "
                             f"!= 5 reads x {layers} layers x {passes} passes = {want}, all on the tensor-core body")
    summaries = {p: sch.summarize(r) for p, r in runs.items()}
    for policy, s in summaries.items():
        print_summary(policy, s)
    ratio = summaries["continuous"]["tokens_per_sec"] / summaries["static"]["tokens_per_sec"]
    print(f"  continuous/static: {ratio:.3f}x tokens/s", flush=True)

    # (c): the continuous run again on fresh engines over the same costs
    again, _ = LS.run_policies(cfg, params, trace, "cuda", costs, policies=("continuous",))
    if not served_equal(again["continuous"], runs["continuous"]):
        raise AssertionError("(c) the repeated continuous run's tokens or token_times differ")
    print("  (c) repeat run: tokens and token_times bit for bit", flush=True)

    # (d): one round paged against dense
    eng = paged_against_dense(torch, cfg, params, trace, costs)

    # (g): one decode round step under the profiler
    profile_step(torch, lambda: eng.decode_round(1), what="engine round step (8 slots, adc9)")
    del eng

    # (e): the lossless tree: the share of tokens equal to solo serving (not
    # gated: cuBLAS may round a batch-8 and a batch-1 bf16 product apart),
    # and one chunked prefill against the single-shot one
    ll, ll_costs = LS.run_policies(cfg, dense, trace, "cuda", policies=("continuous",))
    print_summary("lossless continuous", sch.summarize(ll["continuous"]))
    same = total = 0
    for r in ll["continuous"]["requests"]:
        solo = solo_tokens(torch, cfg, dense, trace[r.rid])
        same += sum(a == b for a, b in zip(r.tokens, solo))
        total += len(solo)
    long_prompt = next(r.tokens for r in trace if len(r.tokens) > LS.CHUNK)
    eng = Engine(cfg, dense, n_slots=LS.N_SLOTS, max_seq=LS.MAX_SEQ, page=LS.PAGE, chunk_size=LS.CHUNK,
                 costs=ll_costs, device="cuda")
    job = eng.start(long_prompt)
    while not job.finished:
        eng.prefill_step(job)
    with torch.no_grad():
        single, _ = lm.prefill(cfg, dense, torch.as_tensor(long_prompt, device="cuda").long()[None])
    chunk_gap = float((job.logits.float() - single.float()).abs().max())
    print(f"  (e) lossless: {same} of {total} tokens ({100 * same / total:.1f}%) equal to solo serving; a "
          f"{len(long_prompt)}-token prefill as {len(long_prompt) // LS.CHUNK} chunks of {LS.CHUNK} vs single-shot: "
          f"max |logit diff| {chunk_gap} (max |logit| {float(single.float().abs().max())})", flush=True)
    del eng, job

    # (f): the two tiers over the same planes (4 slots: K4's decode body)
    engines, _ = LS.tier_engines(cfg, dense, sliced, opt_cfg, "cuda")
    ttrace = LS.tier_trace(cfg, ENGINE_REQUESTS, seed=0, rate=1e4)
    t0 = time.perf_counter()
    tiers = sch.run_trace(engines, ttrace, policy="continuous")
    itl, mean = {}, {}
    for tier in engines:
        got = [r for r in tiers["requests"] if r.tier == tier]
        s = sch.summarize({"requests": got})
        itl[tier] = s["per_token_p50_ms"]
        mean[tier] = 1e3 * float(np.mean([np.diff(r.token_times).mean() for r in got]))
        print_summary(f"tier {tier} ({LS.TIER_DEFS[tier]}, {len(got)} requests)", s)
    routed = sorted((r.rid, r.tier) for r in tiers["requests"]) == sorted((r.rid, r.tier) for r in ttrace)
    print(f"  (f) tiers: wall {time.perf_counter() - t0:.1f} s, every request on its tier: {routed}; inter-token "
          f"p50 premium {itl['premium']:.2f} ms, bulk {itl['bulk']:.2f} ms (the mean of each request's mean: "
          f"{mean['premium']:.2f}, {mean['bulk']:.2f} ms)", flush=True)
    if not routed or not itl["premium"] > itl["bulk"]:
        raise AssertionError(f"(f) routing {routed}, inter-token p50 premium {itl['premium']} vs bulk {itl['bulk']}")
    return {"round_launches": by_tokens[LS.N_SLOTS], "summaries": summaries,
            "state": {"cfg": cfg, "dense": dense, "params": params, "plan": adc9_plan, "trace": trace}}


# ---------------- the engine on the crossbar-cycle clock (phase 16) --------------

# the reference's serving record on the crossbar clock (BENCH_serve.json,
# written by ``python -m repro.launch.serve --trace --isa-clock``), held exactly
SERVE_RECORD = "BENCH_serve.json"
# gemma-2b at full width, the default (lossless) plan, one compiled training
# step of 256 tokens: the in-process reference's systems_summary (JAX 0.9.0
# on the CPU), held to GEMMA_SUMMARY_RTOL
GEMMA_SUMMARY = {"vs_digital": 7.4005738284279206, "vs_serial_write": 1.227212538270422}
GEMMA_SUMMARY_RTOL = 1e-12


class first_round_read:
    """While inside, keeps the inputs of the first K4 read
    (``ops.mvm_sliced_fused``) made inside an engine decode round
    (``Engine._round_fn``): ``(args, kwargs)`` with ``x`` cloned."""

    def __init__(self, torch, Engine, KOPS):
        self.torch, self.Engine, self.KOPS = torch, Engine, KOPS

    def __enter__(self):
        self.saved = self.Engine._round_fn, self.KOPS.mvm_sliced_fused
        round_fn, read = self.saved
        kept, depth = [], [0]

        def in_round(*a, **k):
            depth[0] += 1
            try:
                return round_fn(*a, **k)
            finally:
                depth[0] -= 1

        def reading(*a, **k):
            if depth[0] and not kept:
                kept.append(((a[0], a[1].clone(), *a[2:]), dict(k)))
            return read(*a, **k)

        self.Engine._round_fn, self.KOPS.mvm_sliced_fused = in_round, reading
        return kept

    def __exit__(self, *exc):
        self.Engine._round_fn, self.KOPS.mvm_sliced_fused = self.saved


class no_calibration:
    """While inside, ``Engine._calibrate`` raises: a clock that prices every
    key leaves nothing to calibrate, and host timing never stands in for it."""

    def __init__(self, Engine):
        self.Engine = Engine

    def __enter__(self):
        self.saved = self.Engine._calibrate

        def refused(*a, **k):
            raise AssertionError("Engine._calibrate called under the crossbar clock")

        self.Engine._calibrate = refused

    def __exit__(self, *exc):
        self.Engine._calibrate = self.saved


def timings_equal(a, b) -> bool:
    """Two ``run_trace`` results with the same ``token_times``, request by
    request (the tokens depend on the model)."""
    return [(r.rid, r.token_times) for r in a["requests"]] == [(r.rid, r.token_times) for r in b["requests"]]


def phase_isa_clock(torch, K, ref, state):
    """The serving engine on the crossbar-cycle clock and the ISA pipeline:
    gemma-2b at full width through the adc9 tree (a), the bench's narrow
    model on the same clock (b), the reference's serving record (c), one
    round's K4 read against its plain version (d), gemma-2b's compiled
    training step (e)."""
    import contextlib
    import dataclasses
    import tempfile

    from repro_torch import configs
    from repro_torch import plan as planlib
    from repro_torch.isa import plan_compile as pc
    from repro_torch.kernels.sliced_mvm import ops as KOPS
    from repro_torch.launch import serve as LS
    from repro_torch.models import lm
    from repro_torch.optim import PantherConfig
    from repro_torch.serve import scheduler as sch
    from repro_torch.serve.engine import Engine

    cfg, trace = state["cfg"], state["trace"]
    layers = sum(n for _, n in cfg.pattern)

    # (a): the clock of the adc9 plan the tree serves, at 8 slots; both
    # policies on it, every model pass counted, nothing calibrated
    clock = sch.IsaClock.from_plan(state["dense"], state["plan"], n_slots=LS.N_SLOTS)
    want_s = pc.token_latency_ns(lm.param_shapes(cfg), state["plan"]) * 1e-9
    print(f"isa clock: gemma-2b adc9, {LS.N_SLOTS} slots: s_per_token {clock.s_per_token!r} (token_latency_ns · "
          f"1e-9 of lm.param_shapes: {want_s!r})", flush=True)
    if clock.s_per_token != want_s or not clock.s_per_token > 0:
        raise AssertionError(f"(a) s_per_token {clock.s_per_token!r} != {want_s!r}")
    K.mvm_sliced_fused.launches = 0
    K.mvm_sliced_fused.instances.clear()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(no_calibration(Engine))
        prefills = stack.enter_context(calls_by(Engine, "_prefill_fn", lambda a, k: len(a[1][0])))
        chunks = stack.enter_context(calls_by(Engine, "_cont_fn", lambda a, k: len(a[1][0])))
        rounds = stack.enter_context(calls_by(Engine, "_round_fn", lambda a, k: a[1]))
        by_tokens = stack.enter_context(calls_by(KOPS, "mvm_sliced_fused", lambda a, k: a[1].shape[0]))
        kept = stack.enter_context(first_round_read(torch, Engine, KOPS))
        runs, _ = LS.run_policies(cfg, state["params"], trace, "cuda", clock)
    wall = time.perf_counter() - t0
    launches, instances = K.mvm_sliced_fused.launches, dict(K.mvm_sliced_fused.instances)
    passes = sum(prefills.values()) + sum(chunks.values()) + sum(T * n for T, n in rounds.items())
    want = 5 * layers * passes
    summaries = {p: sch.summarize(r) for p, r in runs.items()}
    for policy, s in summaries.items():
        print_summary(f"crossbar clock, {policy}", s)
    speedup = summaries["continuous"]["tokens_per_sec"] / summaries["static"]["tokens_per_sec"]
    print(f"  (a) both policies: wall {wall:.1f} s; tokens/s continuous {summaries['continuous']['tokens_per_sec']!r}, "
          f"static {summaries['static']['tokens_per_sec']!r}, speedup {speedup!r}; prefills by length "
          f"{dict(prefills)}, chunks {dict(chunks)}, rounds by T {dict(rounds)}: {passes} passes; K4 launches "
          f"{launches} by instance {instances}, by tokens a read {dict(sorted(by_tokens.items()))}; nothing "
          f"calibrated", flush=True)
    if launches != want or instances != {"io16": want} or sum(by_tokens.values()) != want or not kept:
        raise AssertionError(f"(a) K4 launches {launches} ({instances}) != 5 reads x {layers} layers x {passes} "
                             f"passes = {want} on the tensor-core body, or no round read kept")

    # (b): the bench's narrow model on the same clock object: the same
    # schedule (tokens mapped into its vocabulary)
    ncfg = LS.bench_config("gemma-2b")
    nparams, _, _ = LS._weights(ncfg, torch.device("cuda"))
    ntrace = [dataclasses.replace(r, tokens=r.tokens % ncfg.vocab) for r in trace]
    t0 = time.perf_counter()
    with no_calibration(Engine):
        nruns, _ = LS.run_policies(ncfg, nparams, ntrace, "cuda", clock)
    for policy in runs:
        same = sch.summarize(nruns[policy]) == summaries[policy] and timings_equal(nruns[policy], runs[policy])
        if not same:
            raise AssertionError(f"(b) {policy}: the narrow model's schedule differs from gemma-2b's on one clock")
    print(f"  (b) the narrow model (d {ncfg.d_model}, {sum(n for _, n in ncfg.pattern)} layers) on the same "
          f"clock: wall {time.perf_counter() - t0:.1f} s; summaries and every request's token_times equal (a)'s",
          flush=True)
    del nparams

    # (c): the reference's serving record, through the launcher on the card
    record = json.loads((Path(__file__).resolve().parent / SERVE_RECORD).read_text())
    K.mvm_sliced_fused.instances.clear()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, no_calibration(Engine), \
            calls_by(KOPS, "mvm_sliced_fused", lambda a, k: (a[1].shape[0], k.get("adc_bits"))) as tier_reads:
        out = LS.main(["--trace", "--isa-clock", "--out", str(Path(tmp) / "serve.json")])
        written = json.loads((Path(tmp) / "serve.json").read_text())
    tier_instances = dict(K.mvm_sliced_fused.instances)
    tps = {t: out["tiers"][t]["tokens_per_sec"] for t in LS.TIER_DEFS}
    print(f"  (c) launch.serve --trace --isa-clock: wall {time.perf_counter() - t0:.1f} s; crossbar_clock "
          f"{ {k: v for k, v in out['crossbar_clock'].items() if k != 'note'} }; tiers tokens/s {tps}; K4 reads by "
          f"(tokens, adc) {dict(sorted(tier_reads.items(), key=str))}, by instance {tier_instances}", flush=True)
    if (out["crossbar_clock"] != record["crossbar_clock"] or written != json.loads(json.dumps(out))
            or any(tps[t] != record["tiers"][t]["tokens_per_sec"] for t in tps)
            or not out["_meta"]["isa_clock"]):
        raise AssertionError(f"(c) the record differs from {SERVE_RECORD}: {out['crossbar_clock']} vs "
                             f"{record['crossbar_clock']}, tiers {tps}")
    adcs = {adc for (_, adc) in tier_reads}
    if adcs != {9, 6} or not any(n <= LS.TIER_SLOTS for n, _ in tier_reads) \
            or not any(k.endswith("_decode") for k in tier_instances):
        raise AssertionError(f"(c) tier reads {dict(tier_reads)}, instances {tier_instances}: adc9 and adc6 reads "
                             f"expected, the 4-slot rounds on the decode body")

    # (d): the kept 8-slot round read against its plain version, bit for bit
    (planes, x, frac, spec), kw = kept[0][0][:4], kept[0][1]
    frac = torch.as_tensor(frac, dtype=torch.int32, device=planes.device).reshape(1)
    dev = KOPS._normalize_read_device(kw.get("device"))
    read = dict(io_bits=kw.get("io_bits", 16), adc_bits=kw.get("adc_bits"), transpose=kw.get("transpose", False),
                tile0=kw.get("tile0", 0), col0=kw.get("col0", 0))
    got = K.mvm_sliced_fused(planes, x.float().contiguous(), frac, spec=spec, dev=dev, **read)
    plain = ref.mvm_sliced_fused_ref(planes, x.float(), frac[0], spec, device=dev, **read)
    err = float((got - plain).abs().max())
    print(f"  (d) the first round's first K4 read ({tuple(x.shape)} x planes {tuple(planes.shape)}, adc "
          f"{kw.get('adc_bits')}): kernel vs plain max |diff| {err}, bit for bit {torch.equal(got, plain)}",
          flush=True)
    if not torch.equal(got, plain) or x.shape[0] != LS.N_SLOTS:
        raise AssertionError(f"(d) kernel vs plain on the round read: max |diff| {err}")

    # (e): gemma-2b's compiled training step at full width (host arithmetic)
    t0 = time.perf_counter()
    shapes = lm.param_shapes(configs.get("gemma_2b"))
    prog = pc.compile_plan(shapes, planlib.resolve_plan(shapes, planlib.default_rules(PantherConfig())), tokens=256)
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary = pc.systems_summary(prog)
    t_summary = time.perf_counter() - t0
    print(f"  (e) gemma-2b compile_plan(tokens=256): {len(prog.meta['leaves'])} mapped leaves, "
          f"{sum(v['tiles'] for v in prog.meta['leaves'].values())} tiles, {prog.total_instrs()} instructions in "
          f"{t_compile:.1f} host s; systems_summary in {t_summary:.1f} host s: {summary}", flush=True)
    for k, v in GEMMA_SUMMARY.items():
        if not abs(summary[k] - v) <= GEMMA_SUMMARY_RTOL * v:
            raise AssertionError(f"(e) {k} {summary[k]!r} vs the reference's {v!r}")
    return {"launches": launches, "max_abs_err": err, "summaries": summaries}


# ---------------- the MoE family at full width (phase 17) ---------------------

MOE_ARCH = "granite_moe_1b_a400m"
MOE_BATCH, MOE_SEQ = 4, 64  # training tokens a step: 4 x 64
# the bench's trace cut to its first 3 requests: the 4th asks for 120 tokens,
# 120 round steps at ~1.5 s a step (PERF.md §4)
MOE_ENGINE_REQUESTS = 2
MOE_BANKS = ("experts_gate", "experts_up", "experts_down")
MOE_HETERO = ((8, 9), (24, 6))  # the granite analogue of --plan moe-hetero: (experts, ADC bits) in order
MOE_SERVE_PROMPT, MOE_SERVE_TOKENS = 32, 16


class plain_reads:
    """While inside, K4's entry point runs the plain version
    (``ref.mvm_sliced_fused_ref``) on the card, on the arguments the kernel
    would have had; nothing launches and no kernel count moves."""

    def __enter__(self):
        from repro_torch.kernels.sliced_mvm import ops, ref

        class plain:
            @staticmethod
            def mvm_sliced_fused(planes, xf, frac, *, spec, io_bits, adc_bits, transpose, dev, tile0, col0):
                return ref.mvm_sliced_fused_ref(planes, xf, frac[0], spec, io_bits, adc_bits, transpose=transpose,
                                                device=dev, tile0=tile0, col0=col0)

        self.ops, self.saved = ops, ops._k
        ops._k = plain

    def __exit__(self, *exc):
        self.ops._k = self.saved


def moe_shapes(cfg) -> dict:
    """(M, N) of each crossbar read of a MoE layer -> its name."""
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    return {(d, (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim): "wqkv", (cfg.n_heads * cfg.head_dim, d): "wo",
            (d, cfg.moe.n_experts): "router", (d, f): "expert", (f, d): "expert"}


def moe_expected(cfg, shapes, plan, tokens):
    """What one training step of ``tokens`` flattened tokens launches under
    the resolved ``plan`` over the param ``shapes``: K4 reads by (MᵀVM,
    tokens, read, ADC bits), K1 blocks by (tokens, read), K2 and K3 blocks
    (one a layer, or a (layer, expert), of each mapped leaf)."""
    from repro_torch import tree
    from repro_torch.train.step import expert_tokens

    reads, k1, dense, mapped = collections.Counter(), collections.Counter(), 0, 0
    t_e = expert_tokens(cfg, tokens)
    for (path, pl), (_, shape) in zip(tree.leaves_with_path(plan), tree.leaves_with_path(shapes)):
        if not pl.mapped:
            continue
        key = str(path[-1])
        name = "expert" if key.startswith("experts_") else key
        n = math.prod(shape.shape[:-2])
        layers = math.prod(shape.shape[:-3]) if name == "expert" else n
        mapped += n
        if pl.grad != "operand":
            dense += n
            continue
        t = t_e if name == "expert" else tokens
        k1[(t, name)] += n
        fid = pl.fidelity
        if fid is None:
            continue
        segs = fid.group_slices(cfg.moe.n_experts) if name == "expert" else [(0, 1, fid)]
        for a, b, g in segs:
            for transpose, on in ((False, fid.fwd), (True, fid.bwd)):
                if on:
                    reads[(transpose, t, name, g.adc_bits_bwd if transpose else g.adc_bits_fwd)] += layers * (b - a)
    return reads, k1, dense, mapped


class entry_counts:
    """While inside, the main path's kernel work is counted at the entry
    points (a dict of Counters, yielded): K4 reads by (direction, tokens a
    read, read, ADC bits), K1 blocks by (tokens, read), and the im2col
    entry's, K2's dense-write and K3's blocks by read. A read is named by
    ``names`` ((M, N) -> name), or is its (M, N) without it. On the card the
    kernel wrappers' own counts must equal them (``check_kernel_counts``)."""

    def __init__(self, names=None):
        self.names = names

    def __enter__(self):
        import contextlib

        import repro_torch.kernels.crs as KCP
        import repro_torch.kernels.sliced_opa as OPK
        from repro_torch.kernels.sliced_mvm import ops as KOPS
        from repro_torch.kernels.sliced_opa import ops as OO

        names = self.names
        blocks = lambda a, k: math.prod(a[0].shape[1:-2])  # noqa: E731
        name_of = lambda planes: (tuple(planes.shape[-2:]) if names is None  # noqa: E731
                                  else names.get(tuple(planes.shape[-2:]), "other"))
        read = lambda a, k: name_of(a[0])  # noqa: E731
        self.stack = contextlib.ExitStack()
        return {
            "k4": self.stack.enter_context(calls_by(KOPS, "mvm_sliced_fused", lambda a, k: (
                k["transpose"], a[1].shape[0], name_of(a[0]), k["adc_bits"]))),
            "k1": self.stack.enter_context(calls_by(OO, "opa_fused", lambda a, k: (a[1].shape[0], name_of(a[0])))),
            "im2col": self.stack.enter_context(calls_by(OPK, "opa_im2col_update", read, blocks)),
            "k2": self.stack.enter_context(calls_by(OPK, "opa_dense_update", read, blocks)),
            "k3": self.stack.enter_context(calls_by(KCP, "crs", read, blocks)),
        }

    def __exit__(self, *exc):
        self.stack.close()


def zero_kernel_counts():
    from repro_torch import kernels

    kernels.reset_launch_counts()


def check_kernel_counts(torch, seen, what):
    """The kernel wrappers' launch counts since ``zero_kernel_counts``
    against the entry-point counts ``seen`` (``entry_counts``): one launch a
    call (a block for the im2col entry, K2 and K3), the im2col entry's in
    its bf16 instance; prints them by instance."""
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.sliced_mvm import kernel as KM
    from repro_torch.kernels.sliced_opa import kernel as KO

    got = {"K4": KM.mvm_sliced_fused.launches, "K4T": KM.mvm_sliced_fused.transpose_launches,
           "K1": KO.opa_fused.launches, "im2col": KO.opa_im2col.launches, "K2": KO.opa_dense.launches,
           "K3": KC.crs.launches}
    want = {"K4": sum(n for key, n in seen["k4"].items() if not key[0]),
            "K4T": sum(n for key, n in seen["k4"].items() if key[0]), "K1": sum(seen["k1"].values()),
            "im2col": sum(seen["im2col"].values()), "K2": sum(seen["k2"].values()), "K3": sum(seen["k3"].values())}
    if got != want or KO.opa_deposit.launches:
        raise AssertionError(f"{what}: kernel launches {got} (int32 deposit {KO.opa_deposit.launches}) != the entry "
                             f"points' {want}")
    if KO.opa_im2col.launches and set(KO.opa_im2col.instances) != {"bf16"}:
        raise AssertionError(f"{what}: im2col launches by instance {dict(KO.opa_im2col.instances)}, expected bf16")
    print(f"    launches {got}; by instance: K4 {dict(KM.mvm_sliced_fused.instances)}, K1 "
          f"{dict(KO.opa_fused.instances)}, im2col {dict(KO.opa_im2col.instances)}, K2 {dict(KO.opa_dense.instances)}",
          flush=True)


def moe_state(torch, gen, device="cuda", cfg=None):
    """granite-moe-1b-a400m's train state at full width (or ``cfg``): the
    default plan's layout, which every plan of this phase shares (the same
    leaves map, at one spec)."""
    from repro_torch import configs
    from repro_torch.optim import PantherConfig
    from repro_torch.train.step import train_state_init

    cfg = cfg or configs.get(MOE_ARCH)
    opt_cfg = PantherConfig(crs_every=2, stochastic_round=True)
    t0 = time.perf_counter()
    state = train_state_init(cfg, opt_cfg, gen, device=device)
    planes = sum(s.planes.numel() for s in _leaves(state.sliced))
    print(f"{cfg.arch_id}: d {cfg.d_model}, {cfg.n_layers} layers, {cfg.moe.n_experts} experts top-"
          f"{cfg.moe.top_k} of d_ff {cfg.moe.d_ff_expert}, vocab {cfg.vocab}, {cfg.dtype}; init + slice "
          f"{time.perf_counter() - t0:.1f} s, {planes / opt_cfg.spec.n_slices:.0f} parameters in "
          f"{opt_cfg.spec.name()} planes ({planes / 1e9:.2f} GB)", flush=True)
    return cfg, opt_cfg, state


def _leaves(t):
    from repro_torch import tree

    return [x for _, x in tree.leaves_with_path(t) if x is not None]


def moe_train(torch, cfg, opt_cfg, state, device="cuda"):
    """Phase 17 (b): 3 coverage adc9 steps (the second a CRS step) and one
    profiled, one default-rules step, one moe-hetero step; every step's
    kernel work counted and held to the plan. Returns the state and what
    the kernels line reads."""
    import dataclasses

    from repro_torch import configs
    from repro_torch import plan as planlib
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models.common import FidelityConfig
    from repro_torch.optim.schedules import constant
    from repro_torch.train.step import make_train_step, param_shapes

    T = MOE_BATCH * MOE_SEQ
    adc9 = dataclasses.replace(configs.fidelity_presets()["adc9"], spec=opt_cfg.spec)
    hetero = tuple((n, FidelityConfig(adc_bits_fwd=b, adc_bits_bwd=b, spec=opt_cfg.spec)) for n, b in MOE_HETERO)
    rules = {"coverage": planlib.coverage_rules(opt_cfg, fidelity=adc9),
             "default": planlib.default_rules(opt_cfg, fidelity=adc9),
             "hetero": planlib.coverage_rules(opt_cfg) + (planlib.PlanRule("*/experts_*", expert_groups=hetero),)}
    shapes = param_shapes(state.digital, state.sliced)
    plans = {k: planlib.resolve_plan(shapes, r, tokens=T) for k, r in rules.items()}
    steps = {k: make_train_step(cfg, opt_cfg, constant(3e-2), plan_rules=r, remat="none") for k, r in rules.items()}
    for k, pl in plans.items():
        print(f"  plan {k}:\n" + planlib.plan_summary(pl), flush=True)
    ds = SyntheticLMDataset(cfg.vocab, MOE_SEQ, MOE_BATCH, seed=0, device=device)
    totals = {"k4": collections.Counter(), "k1": collections.Counter(), "k2": collections.Counter()}
    info = {"ms": {}, "loss": [], "aux": []}
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for step, mode in enumerate(("coverage", "coverage", "coverage", "default", "hetero")):
        zero_kernel_counts()
        batch = ds.batch(step)
        crs_step = state.step % opt_cfg.crs_every == opt_cfg.crs_every - 1
        with entry_counts(moe_shapes(cfg)) as seen:
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = steps[mode](state, batch)
            loss, aux, gnorm = float(m["loss"]), float(m["aux"]), float(m["grad_norm"])
            ms = 1e3 * (time.perf_counter() - t0)
        reads, k1, dense, mapped = moe_expected(cfg, shapes, plans[mode], T)
        want = {"k4": reads, "k1": k1, "k2": dense, "k3": mapped if crs_step else 0}
        got = {"k4": dict(seen["k4"]), "k1": dict(seen["k1"]), "k2": sum(seen["k2"].values()),
               "k3": sum(seen["k3"].values())}
        print(f"  step {step} ({mode}{', CRS' if crs_step else ''}): {ms:.1f} ms, {T / ms * 1e3:.0f} tokens/s, "
              f"loss {loss:.4f}, aux {aux:.4f}, grad_norm {gnorm:.4f}", flush=True)
        print(f"    K4 reads by (MᵀVM, tokens, read, ADC): {dict(sorted(seen['k4'].items(), key=str))}; K1 blocks "
              f"by (tokens, read): {dict(sorted(seen['k1'].items(), key=str))}; K2 blocks {dict(seen['k2'])}; "
              f"K3 blocks {sum(seen['k3'].values())}", flush=True)
        if got != {k: (dict(v) if isinstance(v, collections.Counter) else v) for k, v in want.items()}:
            raise AssertionError(f"step {step} ({mode}): kernel work {got} != the plan's {want}")
        if cuda:
            check_kernel_counts(torch, seen, f"step {step} ({mode})")
        if not (math.isfinite(loss) and math.isfinite(aux) and math.isfinite(gnorm) and aux > 0):
            raise AssertionError(f"step {step}: loss {loss}, aux {aux} or grad_norm {gnorm} not finite")
        for k in totals:
            totals[k].update(seen[k])
        info["ms"][f"{mode}{'_crs' if crs_step else ''}"] = ms
        info["loss"].append(loss)
        info["aux"].append(aux)
        if step == 2 and cuda:
            info["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            out = {}

            def one_more():
                out["state"], _ = steps["coverage"](state, ds.batch(5))

            profile_step(torch, one_more, "granite coverage adc9 train step")
            state = out["state"]
    adc_split = collections.Counter()
    for (transpose, t, name, adc), n in seen["k4"].items():
        adc_split[(name, adc)] += n
    print(f"  (b) peak memory over the coverage steps {info.get('peak_gib', float('nan')):.1f} GiB; the hetero step's "
          f"K4 reads by (read, ADC bits): {dict(sorted(adc_split.items(), key=str))}", flush=True)
    return state, totals, info


def serving_tree(opt_cfg, state, plan):
    """The served tree over the state's planes: operand leaves read through
    ``plan``'s fidelity (no dense copy), the rest dequantized."""
    from repro_torch.optim import panther

    return panther.fidelitize(dense_tree(opt_cfg, state, plan), state.sliced, plan)


def moe_serve(torch, cfg, opt_cfg, state, gen, device="cuda"):
    """Phase 17 (c): layer 0's ``moe_apply`` through the kernels against the
    plain reads, bit for bit; batch 4 x 32 prompts, 16 greedy tokens through
    the adc9 coverage plan (router and experts on K4); the engine on the
    bench's trace cut to MOE_ENGINE_REQUESTS, continuous, 8 slots."""
    import dataclasses

    from repro_torch import configs
    from repro_torch import plan as planlib
    from repro_torch.launch import serve as LS
    from repro_torch.models import lm
    from repro_torch.models.mlp import moe_apply
    from repro_torch.serve import scheduler as sch
    from repro_torch.serve.kv_pages import grow_caches
    from repro_torch.train.step import expert_tokens, param_shapes

    cuda = device == "cuda"
    adc9 = dataclasses.replace(configs.fidelity_presets()["adc9"], spec=opt_cfg.spec)
    shapes = param_shapes(state.digital, state.sliced)
    plan = planlib.resolve_plan(shapes, planlib.coverage_rules(opt_cfg, adc9))
    params = serving_tree(opt_cfg, state, plan)
    B, P, N = MOE_BATCH, MOE_SERVE_PROMPT, MOE_SERVE_TOKENS
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=device)
    out = {}
    with torch.no_grad():
        h = lm._embed_in(cfg, params, prompts)
        p0 = lm.layer(params["groups"][0], 0)["moe"]
        got = moe_apply(cfg, p0, h)
        with plain_reads():
            want = moe_apply(cfg, p0, h)
        if not torch.equal(got, want):
            raise AssertionError(f"(a) layer 0's moe_apply through K4 vs the plain reads: max |diff| "
                                 f"{float((got.float() - want.float()).abs().max())}")
        print(f"  (a) layer 0's moe_apply on {B} x {P} tokens (the router and every expert read at adc9): through "
              "the kernels bit for bit with the plain reads", flush=True)
        zero_kernel_counts()
        with entry_counts(moe_shapes(cfg)) as seen:
            t0 = time.perf_counter()
            logits, caches = lm.prefill(cfg, params, prompts)
            caches = grow_caches(cfg, lm.unstack_caches(cfg, caches), P + N)
            tok = torch.argmax(logits, dim=-1)
            if cuda:
                torch.cuda.synchronize()
            out["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
            t0 = time.perf_counter()
            toks = [tok]
            for i in range(N - 1):
                logits, caches = lm.decode_step(cfg, params, tok, caches, P + i)
                tok = torch.argmax(logits, dim=-1)
                toks.append(tok)
            if cuda:
                torch.cuda.synchronize()
            out["decode_ms"] = 1e3 * (time.perf_counter() - t0) / (N - 1)
        # the plan's forward reads: one prefill of B x P tokens, N - 1 decode steps of B
        want = collections.Counter()
        for tokens, times in ((B * P, 1), (B, N - 1)):
            for key, n in moe_expected(cfg, shapes, plan, tokens)[0].items():
                if not key[0]:
                    want[key] += n * times
        print(f"  (c) serving {B} x {P} prompts, {N} greedy tokens, adc9: prefill {out['prefill_ms']:.1f} ms, decode "
              f"{out['decode_ms']:.1f} ms a step; K4 reads by (MᵀVM, tokens, read, ADC) "
              f"{dict(sorted(seen['k4'].items(), key=str))}", flush=True)
        if dict(seen["k4"]) != dict(want) or not bool(torch.isfinite(logits.float()).all()):
            raise AssertionError(f"(c) K4 reads {dict(seen['k4'])} != {dict(want)}, or logits not finite")
        if cuda:
            check_kernel_counts(torch, seen, "(c) serving")
            profile_step(torch, lambda: lm.decode_step(cfg, params, tok, caches, P + N - 1),
                         "granite decode step (batch 4, adc9)")
        out["decode_reads"] = seen["k4"][(False, expert_tokens(cfg, B), "expert", 9)]
        print("    sample:", torch.stack(toks, 1)[0].tolist(), flush=True)

    trace = LS.bench_trace(cfg, 32, seed=0, rate=1e4)[:MOE_ENGINE_REQUESTS]
    zero_kernel_counts()
    with entry_counts(moe_shapes(cfg)) as seen:
        t0 = time.perf_counter()
        runs, costs = LS.run_policies(cfg, params, trace, device, {}, policies=("continuous",))
        wall = time.perf_counter() - t0
    s = sch.summarize(runs["continuous"])
    by_tokens = collections.Counter()
    for (transpose, t, name, adc), n in seen["k4"].items():
        by_tokens[(name, t)] += n
    print(f"  (c) engine: the bench's trace cut to {len(trace)} requests (prompts "
          f"{sorted(collections.Counter(len(r.tokens) for r in trace).items())}, outputs "
          f"{sorted(collections.Counter(r.out_len for r in trace).items())}), continuous, {LS.N_SLOTS} slots: wall "
          f"{wall:.1f} s; {len(costs)} costs calibrated", flush=True)
    print_summary("granite continuous", s)
    print(f"    K4 reads by (read, tokens a read): {dict(sorted(by_tokens.items(), key=str))}", flush=True)
    if len(runs["continuous"]["requests"]) != len(trace) or s["tokens_per_sec"] <= 0:
        raise AssertionError(f"(c) engine served {len(runs['continuous']['requests'])} of {len(trace)} requests")
    if cuda:
        check_kernel_counts(torch, seen, "(c) engine")
    out["engine_tokens_per_sec"] = s["tokens_per_sec"]
    out["engine_reads"] = by_tokens[("expert", expert_tokens(cfg, LS.N_SLOTS))]
    return out


def moe_kernel_times(torch, K, cfg, opt_cfg, state, gen, gi=0, suffix=""):
    """Phase 17 (a): one expert bank's grouped read (K4 forward and MᵀVM at
    adc9, 80 rows; forward at 8) bit for bit against each expert's plain
    read, the router's at 256 tokens, K1 on an expert tile at 80 tokens and
    K2 on an expert block bit for bit against their plain versions; then
    one layer's 96 expert reads, one layer's 96 K1 tile updates and one
    dense bank's 768 K2 writes timed beside their plain versions, the
    library yardstick and the bound. ``gi``: the pattern group whose layer 0
    is read; ``suffix`` ends the timings' names. Returns the timings."""
    from repro_torch.kernels import common as KW
    import dataclasses

    from repro_torch import configs
    from repro_torch.core.fixed_point import choose_frac_bits
    from repro_torch.core.mvm import fidelity_read
    from repro_torch.core.slicing import dequantize_planes
    from repro_torch.kernels.sliced_mvm import ref
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO
    from repro_torch.models import common as C
    from repro_torch.train.step import expert_tokens

    spec = opt_cfg.spec
    S, E = spec.n_slices, cfg.moe.n_experts
    adc9 = dataclasses.replace(configs.fidelity_presets()["adc9"], spec=spec)
    T, rows = MOE_BATCH * MOE_SEQ, expert_tokens(cfg, MOE_BATCH * MOE_SEQ)
    moe0 = state.sliced["groups"][gi]["moe"]
    L = math.prod(moe0["experts_gate"].planes.shape[1:-3])  # the group's MoE layers
    banks = {b: moe0[b].planes.movedim(0, 2)[0] for b in MOE_BANKS}  # layer 0: [E, S, M, N]
    fracs = {b: moe0[b].frac_bits for b in MOE_BANKS}
    # bit for bit: every expert of one bank, each direction, and the router
    checks = 0
    for transpose, n in ((False, rows), (True, rows), (False, expert_tokens(cfg, MOE_BATCH))):
        planes = banks["experts_gate"]
        ww = C.XbarWeight(None, planes, fracs["experts_gate"].expand(E), adc9)
        v = torch.randn((E, n, planes.shape[-1] if transpose else planes.shape[-2]), generator=gen,
                        device="cuda").to(torch.bfloat16)
        got = C._grouped_fid_read(ww, v, transpose)
        with plain_reads():
            want = C._grouped_fid_read(ww, v, transpose)
        if not torch.equal(got, want):
            raise AssertionError(f"(a) the grouped read ({'MᵀVM' if transpose else 'forward'}, {n} rows) vs the "
                                 f"plain reads: max |diff| {float((got - want).abs().max())}")
        checks += E
    router = moe0["router"]
    rp = router.planes.movedim(0, 1)[0]
    for transpose in (False, True):
        v = torch.randn((T, rp.shape[-1] if transpose else rp.shape[-2]), generator=gen, device="cuda")
        got = fidelity_read(rp, router.frac_bits, v, adc9, transpose=transpose)
        with plain_reads():
            want = fidelity_read(rp, router.frac_bits, v, adc9, transpose=transpose)
        if not torch.equal(got, want):
            raise AssertionError(f"(a) the router read (transpose={transpose}) vs plain")
        checks += 1
    tile = banks["experts_gate"][0].clone()
    M, N = tile.shape[-2:]
    for lr, F in ((2.0**-4, 8), (4.0, 28)):
        frac = torch.tensor([F], dtype=torch.int32, device="cuda")
        x, dh = exact_operands(torch, rows, M, N, torch.bfloat16, gen)
        want = RO.opa_fused_ref(tile, x, dh, lr, frac[0], spec, (5, 7))
        got = KO.opa_fused(tile.clone(), x, dh, lr, frac, spec=spec, key_words=(5, 7))
        if not torch.equal(got, want):
            raise AssertionError(f"(a) K1 on an expert tile at {rows} tokens vs plain (lr {lr}, F {F})")
        checks += 1
    g = dense_gradient(torch, (M, N), torch.float32, gen)
    if dense_case(torch, tile, g, spec, "counter", what="(a) K2 on an expert block"):
        raise AssertionError("(a) K2 on an expert block vs plain")
    print(f"  (a) {checks + 1} kernel-vs-plain cases bit for bit: {E} experts' reads forward and MᵀVM at {rows} rows "
          f"and forward at {expert_tokens(cfg, MOE_BATCH)}, the router forward and MᵀVM at {T} tokens, K1 on an "
          f"expert tile at {rows} tokens (two lr/F), K2's dense write on an expert block", flush=True)

    out = {}
    # one layer's 96 expert reads: the kernel (DAC exponents chosen once,
    # outside the timed loop), the plain reads, one torch.bmm a bank over
    # the experts' f32 weights, and the bound
    for key, transpose, n in ((f"mvm_sliced_fused_expert{suffix}", False, rows),
                              (f"mvm_sliced_fused_expert{suffix}_transpose", True, rows),
                              (f"mvm_sliced_fused_expert{suffix}_decode", False, expert_tokens(cfg, MOE_BATCH))):
        work = []
        for b in MOE_BANKS:
            planes = banks[b]
            Mb, Nb = planes.shape[-2:]
            v = torch.randn((E, n, Nb if transpose else Mb), generator=gen, device="cuda")
            xf = [choose_frac_bits(v[e], word_bits=16, margin_bits=1, clip_to_word=False).reshape(1) for e in range(E)]
            w = dequantize_planes(planes.movedim(1, 0), fracs[b], spec)  # [E, M, N] f32
            work.append((planes, v, xf, w, Mb, Nb))

        def kernel():
            for planes, v, xf, _, _, _ in work:
                for e in range(E):
                    K.mvm_sliced_fused(planes[e], v[e], xf[e], spec=spec, adc_bits=9, transpose=transpose)

        def plain():
            for planes, v, xf, _, _, _ in work:
                for e in range(E):
                    ref.mvm_sliced_fused_ref(planes[e], v[e], xf[e][0], spec, 16, 9, transpose=transpose)

        def library():
            for _, v, _, w, _, _ in work:
                torch.bmm(v, w.transpose(1, 2) if transpose else w)

        bms = [bound_ms(n, Mb, Nb, S, 16) for _, _, _, _, Mb, Nb in work]
        out[key] = {"ms": cuda_time_ms(kernel, 5), "plain_ms": cuda_time_ms(plain, 1, 0),
                    "library_ms": cuda_time_ms(library, 10), "bound_ms": E * sum(b[0] for b in bms),
                    "bound_by": "bytes" if all(b[1] == "bytes" for b in bms) else "operations"}
        del work
    # K1 over one layer's 96 expert tiles at the capacity rows, bf16
    # training-like operands, on copies; library: one bf16 xᵀ @ dh bmm a bank
    work = []
    for b in MOE_BANKS:
        planes = banks[b].clone()
        Mb, Nb = planes.shape[-2:]
        x = torch.randn((E, rows, Mb), generator=gen, device="cuda").to(torch.bfloat16)
        dh = (torch.randn((E, rows, Nb), generator=gen, device="cuda") * 1e-3).to(torch.bfloat16)
        work.append((planes, x, dh, fracs[b].reshape(1), Mb, Nb))

    def k1():
        for planes, x, dh, frac, _, _ in work:
            for e in range(E):
                KO.opa_fused(planes[e], x[e], dh[e], 3e-2, frac, spec=spec, key_words=(1, 2))

    def k1_plain():
        for planes, x, dh, frac, _, _ in work:
            for e in range(E):
                RO.opa_fused_ref(planes[e], x[e], dh[e], 3e-2, frac[0], spec, (1, 2))

    def k1_lib():
        for _, x, dh, _, _, _ in work:
            torch.bmm(x.transpose(1, 2), dh)

    bs = [KW.opa_work(rows, Mb, Nb, S).bound_ms()
          for *_, Mb, Nb in work]
    out[f"opa_fused_expert{suffix}"] = {"ms": cuda_time_ms(k1, 5), "plain_ms": cuda_time_ms(k1_plain, 1, 0),
                               "library_ms": cuda_time_ms(k1_lib, 10), "bound_ms": E * sum(b[0] for b in bs),
                               "bound_by": "bytes" if all(b[1] == "bytes" for b in bs) else "operations"}
    del work
    # K2's dense write over one dense expert bank: L x E blocks, f32
    # gradient, counter draw, as the default-rules step writes them
    Mb, Nb = banks["experts_gate"].shape[-2:]
    planes = torch.randint(-8, 8, (L * E, S, Mb, Nb), generator=gen, device="cuda", dtype=torch.int8)
    g = dense_gradient(torch, (L * E, Mb, Nb), torch.float32, gen)
    k2 = cuda_time_ms(lambda: [dense_launch(torch, planes[i], g[i], spec, "counter") for i in range(L * E)], 3)
    k2_plain = cuda_time_ms(lambda: [dense_plain(torch, planes[i], g[i], spec, "counter") for i in range(L * E)], 1, 0)
    b = KW.dense_work(L * E * Mb, Nb, S).bound_ms()
    out[f"opa_dense_expert{suffix}"] = {"ms": k2, "plain_ms": k2_plain, "library_ms": None, "bound_ms": b[0],
                                        "bound_by": b[1]}
    del planes, g
    torch.cuda.empty_cache()
    for key, t in out.items():
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        print(f"  {key:34s} kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  library {lib}  bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {100 * t['bound_ms'] / t['ms']:.0f}% of it)", flush=True)
    return out


def phase_moe(torch, K, gen):
    """Phase 17: granite-moe-1b-a400m at full width, bf16, seed weights in
    44466555 planes: (a) the kernels on its shapes, (b) training, (c)
    serving and the engine."""
    from repro_torch.train.step import expert_tokens

    t = [time.perf_counter()]
    cfg, opt_cfg, state = moe_state(torch, gen)
    timings = moe_kernel_times(torch, K, cfg, opt_cfg, state, gen)
    t.append(time.perf_counter())
    state, totals, info = moe_train(torch, cfg, opt_cfg, state)
    t.append(time.perf_counter())
    serving = moe_serve(torch, cfg, opt_cfg, state, gen)
    t.append(time.perf_counter())
    print(f"phase 17 wall: state and (a) {t[1] - t[0]:.1f} s, (b) training {t[2] - t[1]:.1f} s, (c) serving and "
          f"the engine {t[3] - t[2]:.1f} s", flush=True)
    del state
    torch.cuda.empty_cache()
    rows = expert_tokens(cfg, MOE_BATCH * MOE_SEQ)
    dec = expert_tokens(cfg, MOE_BATCH)
    k4 = totals["k4"]
    launches = {
        "mvm_sliced_fused_expert": sum(n for (t, r, name, _), n in k4.items() if not t and r == rows
                                       and name == "expert"),
        "mvm_sliced_fused_expert_transpose": sum(n for (t, r, name, _), n in k4.items() if t and r == rows
                                                 and name == "expert"),
        "mvm_sliced_fused_expert_decode": serving["decode_reads"] + serving["engine_reads"],
        "opa_fused_expert": totals["k1"][(rows, "expert")],
        "opa_dense_expert": totals["k2"]["expert"],
    }
    print(f"phase 17 summary: train ms {info['ms']}, losses {info['loss']}, aux {info['aux']}; serving prefill "
          f"{serving['prefill_ms']:.1f} ms, decode {serving['decode_ms']:.1f} ms a step, engine "
          f"{serving['engine_tokens_per_sec']:.2f} tokens/s; main-path launches {launches} (expert reads at {rows} "
          f"rows in training, {dec} in decode)", flush=True)
    return launches, timings


# ------------------- phase 18: the SSM family at full width -------------------

SSM_ARCHS = ("xlstm_125m", "zamba2_1p2b")
SSM_BATCH, SSM_SEQ = 4, 64  # training tokens a step: 4 x 64
SSM_SERVE_PROMPT, SSM_SERVE_TOKENS = 32, 16
# the bench's trace cut to its first requests (PERF.md §4): the 4th asks
# for 120 tokens, 120 round steps, and the lossless check serves each
# request twice more (cut from 6 when phase 19 came: the script had run
# 1033 s of its 1200 on an H100; to 2 when phase 20 came, PERF.md §4)
SSM_ENGINE_REQUESTS = 2
IM2COL_T = 256  # the training step's tokens a conv-tap block: 4 x 64
# the narrow crossbar tiles the SSM blocks read: (name, arch, M, N)
NARROW_READS = (("w_if", "xlstm_125m", 1536, 8), ("w_B", "zamba2_1p2b", 2048, 64))


def im2col_operands(torch, C, T, K, gen, device="cuda"):
    """bf16 im2col operands ``x [C, T, K]``, ``dh [C, T, 1]`` whose f32 sums
    are exact in any order (``exact_operands``' grid)."""
    x = torch.randint(-4, 5, (C, T, K), generator=gen, device=device).to(torch.float32) * 0.125
    dh = torch.randint(-4, 5, (C, T, 1), generator=gen, device=device).to(torch.float32) * 2.0**-5
    return x.to(torch.bfloat16), dh.to(torch.bfloat16)


def ssm_kernel_checks(torch, K, spec, gen):
    """Phase 18 (a), the kernels at the SSM family's shapes: the im2col
    entry at C = 1536 (xlstm) and 4224 (zamba2), 256 tokens, under the
    counter draw and half to even, bit for bit against its plain version
    and the per-tile K1 launches on the same block; K3 on a conv leaf's
    block; K4 forward and MᵀVM on the narrow tiles at adc9; each timed
    beside its plain version, its library yardstick and its bound. Returns
    the timings by kernels-line name."""
    from repro_torch.kernels import common as KW
    from repro_torch.core import prng
    from repro_torch.core.fixed_point import choose_frac_bits
    from repro_torch.core.slicing import dequantize_planes
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.crs import ref as RC
    from repro_torch.kernels.sliced_mvm import ref
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ops as OO
    from repro_torch.kernels.sliced_opa import ref as RO

    S, Kw = spec.n_slices, 4
    out, checks = {}, 0
    for arch, C in (("xlstm_125m", 1536), ("zamba2_1p2b", 4224)):
        name = "opa_im2col" if arch == "xlstm_125m" else "opa_im2col_zamba"
        planes = random_planes(torch, spec, (Kw, C), gen)
        # the plain version takes a Python loop over the channels (1-5 s
        # here): two cases a width, one under each rounding
        for lr, F, key in ((2.0**-4, 8, prng.fold_in(prng.PRNGKey(7), 11)), (4.0, 28, None)):
            frac = torch.tensor([F], dtype=torch.int32, device="cuda")
            x, dh = im2col_operands(torch, C, IM2COL_T, Kw, gen)
            want = RO.opa_im2col_ref(planes, x, dh, lr, frac[0], spec, key, 3)
            got = KO.opa_im2col(planes.clone(), x, dh, lr, frac, spec=spec, key=key, layer=3)
            tiles = OO.im2col_tiles(planes.clone(), x, dh, lr, frac, spec, 3, key)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(tiles, want)) or torch.equal(want, planes):
                raise AssertionError(f"(a) the im2col entry at C {C} (lr {lr}, F {F}, key {key}): "
                                     f"{int((got != want).sum())} cells differ from plain, "
                                     f"{int((tiles != want).sum())} from the per-tile K1 launches")
            checks += 1
        # timed on training-like operands, the counter draw, on copies
        x = torch.randn((C, IM2COL_T, Kw), generator=gen, device="cuda").to(torch.bfloat16)
        dh = (torch.randn((C, IM2COL_T, 1), generator=gen, device="cuda") * 1e-3).to(torch.bfloat16)
        frac = torch.tensor([20], dtype=torch.int32, device="cuda")
        key = prng.PRNGKey(3)
        work = planes.clone()
        x32, dh32 = x.float(), dh[..., 0].float()
        b = KW.im2col_work(C, IM2COL_T, Kw, S).bound_ms()
        out[name] = {
            "ms": cuda_time_ms(lambda: KO.opa_im2col(work, x, dh, 3e-2, frac, spec=spec, key=key, layer=0), 20),
            "plain_ms": cuda_time_ms(lambda: RO.opa_im2col_ref(work, x, dh, 3e-2, frac[0], spec, key, 0), 1, 0),
            "tile_ms": cuda_time_ms(lambda: OO.im2col_tiles(work, x, dh, 3e-2, frac, spec, 0, key), 1, 1),
            "library_ms": cuda_time_ms(lambda: torch.einsum("ctk,ct->kc", x32, dh32), 20),
            "bound_ms": b[0], "bound_by": b[1]}
        # K3 on the conv leaf's block
        if name == "opa_im2col":
            cplanes = random_planes(torch, spec, (Kw, C), gen)
            want = RC.crs_ref(cplanes, spec)
            got = KC.crs(cplanes.clone(), spec=spec)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"(a) K3 on a conv block [{S}, {Kw}, {C}] vs plain")
            checks += 1
            cb = KW.crs_work(S * Kw * C).bound_ms()
            out["crs_conv"] = {"ms": cuda_time_ms(lambda: KC.crs(cplanes, spec=spec), 20),
                               "plain_ms": cuda_time_ms(lambda: RC.crs_ref(cplanes, spec), 5),
                               "library_ms": None, "bound_ms": cb[0], "bound_by": cb[1]}
        del planes, work, x, dh
    # K4 on the narrow tiles at adc9, forward and MᵀVM, 256 tokens
    for rname, _, M, N in NARROW_READS:
        planes = random_planes(torch, spec, (M, N), gen)
        w = dequantize_planes(planes, 20, spec)
        for transpose in (False, True):
            key = f"mvm_sliced_fused_{rname}" + ("_transpose" if transpose else "")
            v = torch.randn((IM2COL_T, N if transpose else M), generator=gen, device="cuda")
            xf = choose_frac_bits(v, word_bits=16, margin_bits=1, clip_to_word=False).reshape(1)
            got = K.mvm_sliced_fused(planes, v, xf, spec=spec, adc_bits=9, transpose=transpose)
            want = ref.mvm_sliced_fused_ref(planes, v, xf[0], spec, 16, 9, transpose=transpose)
            if not torch.equal(got, want):
                raise AssertionError(f"(a) K4 on {rname} ({M}x{N}, transpose={transpose}) vs plain at adc9")
            checks += 1
            bms = bound_ms(IM2COL_T, M, N, S, 16)
            out[key] = {"ms": cuda_time_ms(lambda: K.mvm_sliced_fused(planes, v, xf, spec=spec, adc_bits=9,
                                                                      transpose=transpose), 20),
                        "plain_ms": cuda_time_ms(lambda: ref.mvm_sliced_fused_ref(planes, v, xf[0], spec, 16, 9,
                                                                                  transpose=transpose), 3),
                        "library_ms": cuda_time_ms(lambda: v @ (w.T if transpose else w), 20),
                        "bound_ms": bms[0], "bound_by": bms[1]}
    torch.cuda.empty_cache()
    print(f"  (a) {checks} kernel-vs-plain cases bit for bit: the im2col entry at C 1536 and 4224 ({IM2COL_T} "
          f"tokens, the counter draw and half to even) against its plain version and the per-tile K1 "
          f"launches, K3 on a conv block, K4 and K4ᵀ on w_if 1536x8 and w_B 2048x64 at adc9", flush=True)
    for key, t in out.items():
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        tile = f"  per-tile K1 {t['tile_ms']:.4f} ms" if "tile_ms" in t else ""
        print(f"  {key:34s} kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms{tile}  library {lib}  bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']}, {100 * t['bound_ms'] / t['ms']:.1f}% of it)", flush=True)
    return out


def dense_tree(opt_cfg, state, plan):
    """The param tree a step or a server reads before its wraps: digital
    leaves, mapped leaves dequantized, None where the fidelity reads need no
    dense copy (``panther.needs_dense``)."""
    from repro_torch import tree
    from repro_torch.core.slicing import dequantize_planes
    from repro_torch.optim import panther

    def leaf(d, s, pl):
        if s is None:
            return d
        if not panther.needs_dense(s, pl):
            return None
        return dequantize_planes(s.planes, s.frac_bits, pl.spec, dtype=opt_cfg.compute_dtype)

    return tree.map(leaf, state.digital, state.sliced, plan)


def ssm_state(torch, arch, gen, device="cuda", cfg=None):
    """The arch's train state at full width (or ``cfg``), bf16, seed weights
    in 44466555 planes, the default plan's layout (every plan of this
    phase maps the same leaves but ``conv_w``, which the coverage plan
    maps: so the coverage layout)."""
    from repro_torch import configs
    from repro_torch import plan as planlib
    from repro_torch.models import lm
    from repro_torch.optim import PantherConfig
    from repro_torch.train.step import train_state_init

    cfg = cfg or configs.get(arch)
    opt_cfg = PantherConfig(crs_every=2, stochastic_round=True)
    t0 = time.perf_counter()
    plan = planlib.resolve_plan(lm.param_shapes(cfg), planlib.coverage_rules(opt_cfg))
    state = train_state_init(cfg, opt_cfg, gen, plan=plan, device=device)
    planes = sum(s.planes.numel() for s in _leaves(state.sliced))
    params = planes / opt_cfg.spec.n_slices + sum(d.numel() for d in _leaves(state.digital))
    print(f"{cfg.arch_id}: d {cfg.d_model}, {cfg.n_layers} layers, pattern {cfg.pattern}, vocab {cfg.vocab}, "
          f"{cfg.dtype}; init + slice {time.perf_counter() - t0:.1f} s, {params / 1e6:.1f} M parameters, "
          f"{planes / opt_cfg.spec.n_slices / 1e6:.1f} M in {opt_cfg.spec.name()} planes ({planes / 1e9:.2f} GB)",
          flush=True)
    return cfg, opt_cfg, state


def plan_expected(cfg, shapes, plan, tokens, cache_rows=None):
    """What one pass of ``tokens`` flattened tokens launches under ``plan``
    over the param ``shapes``: K4 reads by (MᵀVM, rows, (M, N), ADC), K1
    blocks, im2col blocks, K2 blocks, K3 blocks (every mapped block). An
    expert bank (``group="expert"``) reads ``expert_tokens`` rows a (layer,
    expert), a segment of its ``expert_groups`` at that segment's ADC; MLA's
    ``w_uk``/``w_uv`` read the cache's ``cache_rows`` (B·Sk) at decode."""
    from repro_torch import tree
    from repro_torch.train.step import expert_tokens

    reads, k1, im2col, dense, mapped = collections.Counter(), 0, 0, 0, 0
    for (path, pl), (_, shape) in zip(tree.leaves_with_path(plan), tree.leaves_with_path(shapes)):
        if not pl.mapped:
            continue
        n = math.prod(shape.shape[:-2])
        mapped += n
        if pl.grad != "operand":
            dense += n
        elif pl.group == "im2col":
            im2col += n
        else:
            k1 += n
            fid = pl.fidelity
            if fid is None:
                continue
            rows, layers, segs = tokens, n, [(0, 1, fid)]
            if pl.group == "expert":
                rows, layers = expert_tokens(cfg, tokens), math.prod(shape.shape[:-3])
                segs = fid.group_slices(cfg.moe.n_experts)
            elif str(path[-1]) in ("w_uk", "w_uv") and cache_rows is not None:
                rows = cache_rows
            for a, b, g in segs:
                for transpose, on in ((False, fid.fwd), (True, fid.bwd)):
                    if on:
                        reads[(transpose, rows, tuple(shape.shape[-2:]),
                               g.adc_bits_bwd if transpose else g.adc_bits_fwd)] += layers * (b - a)
    return reads, k1, im2col, dense, mapped


def ssm_scan_times(torch, cfg, opt_cfg, state, gen):
    """Device ms of the plain PyTorch pieces of the step at its shapes, per
    layer and per step (x layers): the dwconv's finite-ADC reads (forward
    and transposed, adc9, on layer 0's taps), the SSD scan (zamba2) and the
    mLSTM and sLSTM recurrences (xlstm), each forward and forward+backward."""
    import dataclasses

    from repro_torch import configs
    from repro_torch import tree
    from repro_torch.models import common as C
    from repro_torch.models import mamba2 as m2
    from repro_torch.models import xlstm as xl

    B, L = SSM_BATCH, SSM_SEQ
    adc9 = dataclasses.replace(configs.fidelity_presets()["adc9"], spec=opt_cfg.spec)
    conv = [(p, s) for p, s in tree.leaves_with_path(state.sliced) if s is not None and p[-1] == "conv_w"]
    n_conv = sum(math.prod(s.planes.shape[1:-2]) for _, s in conv)
    planes = conv[0][1].planes.reshape(opt_cfg.spec.n_slices, -1, *conv[0][1].planes.shape[-2:])[:, 0]
    frac = conv[0][1].frac_bits
    Kw, Cc = planes.shape[-2:]
    xp = torch.randn((B, L + Kw - 1, Cc), generator=gen, device="cuda").to(cfg.dtype)
    dy = torch.randn((B, L, Cc), generator=gen, device="cuda").to(cfg.dtype)
    out = {"dwconv_fwd": (cuda_time_ms(lambda: C._dwconv_fidelity_read(planes, frac, xp, adc9), 5), n_conv),
           "dwconv_transpose": (cuda_time_ms(lambda: C._dwconv_fidelity_read(planes, frac, dy, adc9, transpose=True),
                                             3), n_conv)}

    def fwd_bwd(fn, *args):
        args = [a.detach().requires_grad_(a.is_floating_point()) for a in args]
        y = fn(*args)
        y = y[0] if isinstance(y, tuple) else y
        y.float().sum().backward()

    if cfg.ssm is not None:
        d_inner, H = m2._dims(cfg)
        ds = cfg.ssm.d_state
        x = torch.randn((B, L, d_inner), generator=gen, device="cuda").to(cfg.dtype)
        Bs, Cs = (torch.randn((B, L, ds), generator=gen, device="cuda").to(cfg.dtype) for _ in range(2))
        dt = torch.rand((B, L, H), generator=gen, device="cuda") * 0.2
        A_log, D = torch.zeros(H, device="cuda"), torch.ones(H, device="cuda")
        n = cfg.n_layers
        out["ssd_scan"] = (cuda_time_ms(lambda: m2.ssd_scan(cfg, x, Bs, Cs, dt, A_log, D), 5), n)
        out["ssd_scan_fwd_bwd"] = (cuda_time_ms(lambda: fwd_bwd(lambda *a: m2.ssd_scan(cfg, *a), x, Bs, Cs, dt,
                                                                A_log, D), 3), n)
    if cfg.xlstm is not None:
        d_up, H, hd = xl._dims(cfg)
        q, k, v = (torch.randn((B, L, H, hd), generator=gen, device="cuda") for _ in range(3))
        i_pre, logf = torch.randn((B, L, H), generator=gen, device="cuda"), -torch.rand((B, L, H), generator=gen,
                                                                                          device="cuda")
        n_m = sum(c for name, c in cfg.pattern if name == "mlstm")
        n_s = sum(c for name, c in cfg.pattern if name == "slstm")
        out["mlstm_scan"] = (cuda_time_ms(lambda: xl.mlstm_scan(q, k, v, i_pre, logf, L), 5), n_m)
        out["mlstm_scan_fwd_bwd"] = (cuda_time_ms(lambda: fwd_bwd(lambda *a: xl.mlstm_scan(*a, L), q, k, v, i_pre,
                                                                  logf), 3), n_m)
        sp = {"r": torch.randn((H, cfg.d_model // H, 4 * cfg.d_model // H), generator=gen, device="cuda") * 0.05}
        xg = torch.randn((B, L, 4 * cfg.d_model), generator=gen, device="cuda")
        out["slstm_scan"] = (cuda_time_ms(lambda: xl.slstm_scan(cfg, sp, xg), 3), n_s)
        out["slstm_scan_fwd_bwd"] = (cuda_time_ms(lambda: fwd_bwd(lambda a, r: xl.slstm_scan(cfg, {"r": r}, a)[0],
                                                                  xg, sp["r"]), 2), n_s)
    print("    plain PyTorch pieces at the step's shapes, device ms a layer (x layers a step): " + ", ".join(
        f"{k} {ms:.3f} (x{n} = {ms * n:.1f})" for k, (ms, n) in out.items()), flush=True)
    return {k: {"ms_layer": ms, "layers": n, "ms_step": ms * n} for k, (ms, n) in out.items()}


def ssm_layer_check(torch, cfg, opt_cfg, state, gen, device="cuda"):
    """Phase 18 (a): the first mLSTM (xlstm) or mamba2 (zamba2) layer at
    adc9 under ``coverage_rules``, forward and backward through the kernels
    (K4 and K4ᵀ) and then through their plain versions on the same device:
    output, input gradient and every slot's operands bit for bit."""
    import dataclasses

    from repro_torch import configs
    from repro_torch import plan as planlib
    from repro_torch import tree
    from repro_torch.models import lm
    from repro_torch.models import mamba2 as m2
    from repro_torch.models import xlstm as xl
    from repro_torch.models.common import XbarWeight
    from repro_torch.optim import panther
    from repro_torch.train.step import param_shapes

    adc9 = dataclasses.replace(configs.fidelity_presets()["adc9"], spec=opt_cfg.spec)
    T = SSM_BATCH * SSM_SEQ
    plan = planlib.resolve_plan(param_shapes(state.digital, state.sliced), planlib.coverage_rules(opt_cfg, adc9),
                                tokens=T)
    h = torch.randn((SSM_BATCH, SSM_SEQ, cfg.d_model), generator=gen, device=device).to(cfg.dtype)
    co = torch.randn(h.shape, generator=gen, device=device).to(cfg.dtype)

    def run():
        params = panther.operandize(dense_tree(opt_cfg, state, plan), state.sliced, plan, tokens=T)
        if cfg.xlstm is not None:
            p0, fn = lm.layer(params["groups"][0], 0), xl.mlstm_apply
        else:
            p0, fn = lm.layer(lm.layer(params["groups"][0], 0)["mamba"], 0), m2.mamba2_apply
        hh = h.detach().requires_grad_(True)
        y = fn(cfg, p0, hh)
        y.backward(co)
        ops = [(w.slot.x[w.index], w.slot.dh[w.index]) for _, w in tree.leaves_with_path(p0)
               if isinstance(w, XbarWeight) and w.slot is not None]
        return y.detach(), hh.grad, ops

    got = run()
    if device == "cuda":
        with plain_reads():
            want = run()
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and len(got[2]) == len(want[2]) and all(
            torch.equal(a, c) and torch.equal(b, d) for (a, b), (c, d) in zip(got[2], want[2]))
        if not same:
            raise AssertionError(f"(a) {cfg.arch_id} layer 0 through the kernels vs the plain reads: max |dy| "
                                 f"{float((got[0].float() - want[0].float()).abs().max())}, max |dx| "
                                 f"{float((got[1].float() - want[1].float()).abs().max())}")
    print(f"  (a) {cfg.arch_id}'s first {'mLSTM' if cfg.xlstm is not None else 'mamba2'} layer at adc9, forward and "
          f"backward on {SSM_BATCH} x {SSM_SEQ} tokens: output, input gradient and the {len(got[2])} operand pairs "
          f"through the kernels bit for bit with the plain reads", flush=True)


def train_steps(torch, cfg, opt_cfg, state, gen, device="cuda", modes=("coverage",) * 3, plain_times=None):
    """Phases 18 (b) and 19: adc9 steps under ``modes``: 3 coverage steps
    (the second a CRS step) and one profiled after the third (and
    ``plain_times(torch, cfg, opt_cfg, state, gen)``, the plain pieces'
    device ms, before it), or one default-rules step (on ``default_layout``'s
    state); every step's kernel work counted at the entry points, held to
    the plan and to the wrappers' counts. Returns the state, the counts and
    what the summary prints."""
    import dataclasses

    from repro_torch import configs
    from repro_torch import plan as planlib
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.optim.schedules import constant
    from repro_torch.train.step import make_train_step, param_shapes

    T = SSM_BATCH * SSM_SEQ
    adc9 = dataclasses.replace(configs.fidelity_presets()["adc9"], spec=opt_cfg.spec)
    rules = {"coverage": planlib.coverage_rules(opt_cfg, fidelity=adc9),
             "default": planlib.default_rules(opt_cfg, fidelity=adc9)}
    shapes = param_shapes(state.digital, state.sliced)
    plans = {k: planlib.resolve_plan(shapes, r, tokens=T) for k, r in rules.items()}
    steps = {k: make_train_step(cfg, opt_cfg, constant(3e-2), plan_rules=r, remat="none") for k, r in rules.items()}
    ds = SyntheticLMDataset(cfg.vocab, SSM_SEQ, SSM_BATCH, seed=0, device=device)
    cuda = device == "cuda"
    totals = {k: collections.Counter() for k in ("k4", "k1", "im2col", "k2", "k3")}
    info = {"ms": {}, "loss": [], "launches": {}}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    print(f"  plan {modes[0]}:\n" + planlib.plan_summary(plans[modes[0]]), flush=True)
    for mode in modes:
        zero_kernel_counts()
        step = state.step
        crs_step = step % opt_cfg.crs_every == opt_cfg.crs_every - 1
        batch = ds.batch(step)
        with entry_counts() as seen:
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = steps[mode](state, batch)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            ms = 1e3 * (time.perf_counter() - t0)
        reads, k1, im2col, dense, mapped = plan_expected(cfg, shapes, plans[mode], T)
        want = {"k4": dict(reads), "k1": k1, "im2col": im2col, "k2": dense, "k3": mapped if crs_step else 0}
        got = {"k4": dict(seen["k4"]), **{k: sum(seen[k].values()) for k in ("k1", "im2col", "k2", "k3")}}
        print(f"  step {step} ({mode}{', CRS' if crs_step else ''}): {ms:.1f} ms, {T / ms * 1e3:.0f} tokens/s, loss "
              f"{loss:.4f}, grad_norm {gnorm:.4f}; K4 reads {sum(seen['k4'].values())}, K1 {got['k1']}, im2col "
              f"{got['im2col']} blocks, K2 {got['k2']}, K3 {got['k3']}", flush=True)
        if got != want:
            raise AssertionError(f"step {step} ({mode}): kernel work {got} != the plan's {want}")
        if cuda:
            check_kernel_counts(torch, seen, f"step {step} ({mode})")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"step {step}: loss {loss} or grad_norm {gnorm} not finite")
        for k in totals:
            totals[k].update(seen[k])
        info["ms"][f"{mode}{'_crs' if crs_step else ''}"] = ms
        info["loss"].append(loss)
        info["launches"][f"step {step} ({mode})"] = {k: v for k, v in got.items() if k != "k4"}
        if step == 2 and mode == "coverage" and cuda:
            info["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            if plain_times is not None:
                info["scans"] = plain_times(torch, cfg, opt_cfg, state, gen)
            out = {}

            def one_more():
                out["state"], _ = steps["coverage"](state, ds.batch(5))

            info["busy"] = profile_step(torch, one_more, f"{cfg.arch_id} coverage adc9 train step")
            state = out["state"]
    if "peak_gib" in info:
        print(f"  (b) peak memory over the coverage steps {info['peak_gib']:.1f} GiB", flush=True)
    return state, totals, info


def default_layout(opt_cfg, state):
    """The state in the default plan's layout: the leaves it leaves digital
    (the conv taps, whose K = 4 is under ``min_dim``) dequantized from their
    planes into digital leaves; every other leaf shared with ``state``."""
    from repro_torch import plan as planlib
    from repro_torch import tree
    from repro_torch.core.slicing import dequantize_planes
    from repro_torch.train.step import TrainState, param_shapes

    plan = planlib.resolve_plan(param_shapes(state.digital, state.sliced), planlib.default_rules(opt_cfg))
    digital = tree.map(lambda d, s, pl: dequantize_planes(s.planes, s.frac_bits, opt_cfg.spec)
                       if s is not None and not pl.mapped else d, state.digital, state.sliced, plan)
    sliced = tree.map(lambda s, pl: s if pl.mapped else None, state.sliced, plan)
    return TrainState(step=state.step, digital=digital, sliced=sliced, rng=state.rng)


def replicated_solo_tokens(torch, cfg, params, req, width, device="cuda"):
    """Greedy tokens of ``serve.step`` serving the request alone: prefilled
    at batch 1 (as the engine prefills), then decoded with its caches
    replicated to ``width`` rows (every row the same request), dense and
    grown to the engine's ``max_seq``, scalar positions: every matmul has a
    decode round's shape, so its algorithm is the engine's (a batch-1 decode
    may sum in another order)."""
    from repro_torch.launch import serve as LS
    from repro_torch.models import lm
    from repro_torch.serve import kv_pages
    from repro_torch.serve.step import make_decode_step, make_prefill

    L = len(req.tokens)
    logits, caches = make_prefill(cfg)(params, torch.as_tensor(req.tokens, device=device).long()[None])
    caches = kv_pages.grow_caches(cfg, lm.unstack_caches(cfg, caches), LS.MAX_SEQ)
    lay = kv_pages.cache_layouts(cfg)
    caches = kv_pages._map_layers(lambda ly, c: torch.repeat_interleave(c, width, dim=ly.batch_axis).contiguous(),
                                  cfg, lay, caches)
    tok = torch.argmax(logits, dim=-1).expand(width).contiguous()
    out, decode = [int(tok[0])], make_decode_step(cfg)
    for i in range(req.out_len - 1):
        tok, _, caches = decode(params, tok.long(), caches, L + i)
        if not bool((tok == tok[0]).all()):
            raise AssertionError("replicated rows of one request decoded different tokens")
        out.append(int(tok[0]))
    return out


def serve_and_engine(torch, cfg, opt_cfg, state, gen, device="cuda", requests=None, lossless_cfg=None):
    """Phases 18 (c) and 19: 4 x 32 prompts and 16 greedy tokens through the
    adc9 coverage plan; the engine on the bench's trace cut to ``requests``
    (SSM_ENGINE_REQUESTS), continuous, 8 slots, through the adc9 tree; then
    the lossless tree through the engine under ``lossless_cfg`` (``cfg``),
    each request's tokens equal to its solo serving's."""
    import dataclasses

    from repro_torch import configs
    from repro_torch import plan as planlib
    from repro_torch.launch import serve as LS
    from repro_torch.models import lm
    from repro_torch.optim import panther
    from repro_torch.serve import scheduler as sch
    from repro_torch.serve.kv_pages import grow_caches
    from repro_torch.train.step import param_shapes

    cuda = device == "cuda"
    adc9 = dataclasses.replace(configs.fidelity_presets()["adc9"], spec=opt_cfg.spec)
    shapes = param_shapes(state.digital, state.sliced)
    plan = planlib.resolve_plan(shapes, planlib.coverage_rules(opt_cfg, adc9))
    params = serving_tree(opt_cfg, state, plan)
    B, P, N = SSM_BATCH, SSM_SERVE_PROMPT, SSM_SERVE_TOKENS
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=device)
    out = {}
    zero_kernel_counts()
    with torch.no_grad(), entry_counts() as seen:
        t0 = time.perf_counter()
        logits, caches = lm.prefill(cfg, params, prompts)
        caches = grow_caches(cfg, lm.unstack_caches(cfg, caches), P + N)
        tok = torch.argmax(logits, dim=-1)
        if cuda:
            torch.cuda.synchronize()
        out["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        toks = [tok]
        for i in range(N - 1):
            logits, caches = lm.decode_step(cfg, params, tok, caches, P + i)
            tok = torch.argmax(logits, dim=-1)
            toks.append(tok)
        if cuda:
            torch.cuda.synchronize()
        out["decode_ms"] = 1e3 * (time.perf_counter() - t0) / (N - 1)
    want = collections.Counter()
    for tokens, cache_rows, times in ((B * P, B * P, 1), (B, B * (P + N), N - 1)):
        for key, n in plan_expected(cfg, shapes, plan, tokens, cache_rows)[0].items():
            if not key[0]:
                want[key] += n * times
    print(f"  (c) serving {B} x {P} prompts, {N} greedy tokens, adc9: prefill {out['prefill_ms']:.1f} ms, decode "
          f"{out['decode_ms']:.1f} ms a step; K4 reads {sum(seen['k4'].values())} ({sum(want.values()) // (N)} "
          f"a pass)", flush=True)
    if dict(seen["k4"]) != dict(want) or not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"(c) K4 reads {dict(seen['k4'])} != {dict(want)}, or logits not finite")
    if cuda:
        check_kernel_counts(torch, seen, "(c) serving")
    out["k4"] = collections.Counter(seen["k4"])
    print("    sample:", torch.stack(toks, 1)[0].tolist(), flush=True)

    trace = LS.bench_trace(cfg, 32, seed=0, rate=1e4)[:requests or SSM_ENGINE_REQUESTS]
    print(f"  (c) the bench's trace cut to {len(trace)} requests: prompts "
          f"{sorted(collections.Counter(len(r.tokens) for r in trace).items())}, outputs "
          f"{sorted(collections.Counter(r.out_len for r in trace).items())}", flush=True)
    zero_kernel_counts()
    with entry_counts() as seen:
        t0 = time.perf_counter()
        runs, costs = LS.run_policies(cfg, params, trace, device, {}, policies=("continuous",))
        wall = time.perf_counter() - t0
    s = sch.summarize(runs["continuous"])
    print(f"    adc9 engine, continuous, {LS.N_SLOTS} slots: wall {wall:.1f} s; {len(costs)} costs calibrated; "
          f"K4 reads {sum(seen['k4'].values())}", flush=True)
    print_summary(f"{cfg.arch_id} continuous (adc9)", s)
    if len(runs["continuous"]["requests"]) != len(trace) or s["tokens_per_sec"] <= 0:
        raise AssertionError(f"(c) engine served {len(runs['continuous']['requests'])} of {len(trace)} requests")
    if cuda:
        check_kernel_counts(torch, seen, "(c) engine")
    out["k4"].update(seen["k4"])
    out["engine_tokens_per_sec"] = s["tokens_per_sec"]

    # the lossless tree: every mapped leaf dequantized, no wrap
    lossless = panther.materialize_split(state.digital, state.sliced, opt_cfg)
    lcfg = lossless_cfg or cfg
    t0 = time.perf_counter()
    runs, _ = LS.run_policies(lcfg, lossless, trace, device, {}, policies=("continuous",))
    by_rid = {r.rid: r.tokens for r in runs["continuous"]["requests"]}
    with torch.no_grad():
        solo = {r.rid: replicated_solo_tokens(torch, lcfg, lossless, r, LS.N_SLOTS, device) for r in trace}
    equal = sum(by_rid[rid] == toks for rid, toks in solo.items())
    print(f"    lossless engine vs solo serving: {equal} of {len(trace)} requests' tokens equal "
          f"({sum(len(t) for t in solo.values())} tokens; {time.perf_counter() - t0:.1f} s)", flush=True)
    if equal != len(trace):
        bad = [rid for rid, toks in solo.items() if by_rid[rid] != toks]
        raise AssertionError(f"(c) lossless engine tokens differ from solo serving for requests {bad}")
    del lossless
    return out


def phase_ssm(torch, K, gen):
    """Phase 18: the SSM family at full width, bf16, seed weights in
    44466555 planes: (a) the kernels at its shapes, then for xlstm-125m and
    zamba2-1.2b (b) training and (c) serving and the engine."""
    t = [time.perf_counter()]
    from repro_torch.core.slicing import DEFAULT_SPEC

    timings = ssm_kernel_checks(torch, K, DEFAULT_SPEC, gen)
    t.append(time.perf_counter())
    summary, launches = {}, collections.Counter()
    for arch in SSM_ARCHS:
        cfg, opt_cfg, state = ssm_state(torch, arch, gen)
        ssm_layer_check(torch, cfg, opt_cfg, state, gen)
        state, totals, info = train_steps(torch, cfg, opt_cfg, state, gen, plain_times=ssm_scan_times)
        serving = serve_and_engine(torch, cfg, opt_cfg, state, gen)
        _, default_totals, default_info = train_steps(torch, cfg, opt_cfg, default_layout(opt_cfg, state), gen,
                                                    modes=("default",))
        for k in totals:
            totals[k].update(default_totals[k])
        info["ms"].update(default_info["ms"])
        info["loss"] += default_info["loss"]
        info["launches"].update(default_info["launches"])
        del state
        torch.cuda.empty_cache()
        t.append(time.perf_counter())
        summary[arch] = {"train_ms": info["ms"], "losses": info["loss"], "peak_gib": info.get("peak_gib"),
                         "busy": info.get("busy"), "launches": info["launches"],
                         "scans_ms_a_step": {k: round(v["ms_step"], 3) for k, v in info.get("scans", {}).items()},
                         "prefill_ms": serving["prefill_ms"], "decode_ms": serving["decode_ms"],
                         "engine_tokens_per_sec": serving["engine_tokens_per_sec"]}
        k4 = totals["k4"] + serving["k4"]
        launches["opa_im2col" if arch == "xlstm_125m" else "opa_im2col_zamba"] += sum(totals["im2col"].values())
        if arch == "xlstm_125m":
            launches["crs_conv"] += totals["k3"][(4, 1536)]
        for rname, rarch, M, N in NARROW_READS:
            if rarch == arch:
                for transpose in (False, True):
                    launches[f"mvm_sliced_fused_{rname}" + ("_transpose" if transpose else "")] += sum(
                        n for (tr, _, mn, _), n in k4.items() if tr == transpose and mn == (M, N))
        print(f"phase 18 {arch} summary: {json.dumps(summary[arch])}", flush=True)
    print(f"phase 18 wall: (a) {t[1] - t[0]:.1f} s, xlstm-125m {t[2] - t[1]:.1f} s, zamba2-1.2b {t[3] - t[2]:.1f} s; "
          f"main-path launches {dict(launches)}", flush=True)
    return launches, timings


# -------- phase 19: gemma2-9b and deepseek-v2-lite-16b at full width --------

GEMMA2_PAIRS = 4  # of 21: 8 of 42 layers, ~20 GB of planes (PERF.md §4)
DEEPSEEK_PATTERN = (("mla_dense", 1), ("mla_moe", 2))  # 3 of 27 layers, ~13.4 GB of planes
# the bench's trace cut to its first requests (PERF.md §4): the 4th asks for
# 120 tokens, 120 round steps, and the lossless check serves each request
# twice more (cut from 3 when phase 20 came, PERF.md §4)
NEW_ENGINE_REQUESTS = 2
LONG_PROMPT, LONG_DECODE = 5120, 8  # the chunked prefill (5 query chunks), then decodes through the window
# tests/test_torch_arch_smoke.py::test_prefill_decode_matches_forward's bounds
LONG_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
CHUNKED_TOL = 2e-5  # tests/test_chunked_paths.py's bound
T_NEW = 256  # the training step's tokens: 4 x 64


def new_arch_cfgs():
    """The two configs at full width, their depth cut (PERF.md §4)."""
    import dataclasses

    from repro_torch import configs

    g = configs.get("gemma2_9b")
    d = configs.get("deepseek_v2_lite_16b")
    return (dataclasses.replace(g, n_layers=2 * GEMMA2_PAIRS, pattern=(("gemma2_pair", GEMMA2_PAIRS),)),
            dataclasses.replace(d, n_layers=sum(n for _, n in DEEPSEEK_PATTERN), pattern=DEEPSEEK_PATTERN))


def gemma2_tiles(cfg) -> dict:
    """A gemma2 layer's five crossbar reads: name -> (M, N)."""
    d, hd = cfg.d_model, cfg.head_dim
    return {"wqkv": (d, (cfg.n_heads + 2 * cfg.n_kv_heads) * hd), "wo": (cfg.n_heads * hd, d),
            "wi_gate": (d, cfg.d_ff), "wi_up": (d, cfg.d_ff), "mlp_wo": (cfg.d_ff, d)}


def mla_tiles(cfg) -> dict:
    m, H = cfg.mla, cfg.n_heads
    return {"wq_dkv": (cfg.d_model, H * (m.qk_nope_dim + m.qk_rope_dim) + m.kv_lora_rank + m.qk_rope_dim),
            "w_uk": (m.kv_lora_rank, H * m.qk_nope_dim), "w_uv": (m.kv_lora_rank, H * m.v_head_dim)}


def tile_kernel_times(torch, K, spec, tiles, rows, gen, directions=(False, True), k1=True):
    """K4 at adc9 (forward and MᵀVM, at ``rows`` rows) and K1 (bf16 operands
    at ``rows`` tokens) on random planes of each ``tiles`` (M, N), each bit
    for bit against its plain version (K1 on f32-exact operands), timed
    beside it, the library yardstick (``v @ w`` on the dequantized f32
    weights; bf16 ``xᵀ @ dh`` for K1) and the bound. Returns the sums over
    the tiles by direction: {"fwd", "mtvm", "k1"} -> timings."""
    from repro_torch.kernels import common as KW
    from repro_torch.core.fixed_point import choose_frac_bits
    from repro_torch.core.slicing import dequantize_planes
    from repro_torch.kernels.sliced_mvm import ref
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO

    S = spec.n_slices
    parts = collections.defaultdict(list)
    for name, (M, N) in tiles.items():
        planes = random_planes(torch, spec, (M, N), gen)
        w = dequantize_planes(planes, 20, spec)
        for transpose in directions:
            v = torch.randn((rows, N if transpose else M), generator=gen, device="cuda")
            xf = choose_frac_bits(v, word_bits=16, margin_bits=1, clip_to_word=False).reshape(1)
            got = K.mvm_sliced_fused(planes, v, xf, spec=spec, adc_bits=9, transpose=transpose)
            want = ref.mvm_sliced_fused_ref(planes, v, xf[0], spec, 16, 9, transpose=transpose)
            if not torch.equal(got, want):
                raise AssertionError(f"(a) K4 on {name} ({M}x{N}, {rows} rows, transpose={transpose}) vs plain")
            del got, want
            bms = bound_ms(rows, M, N, S, 16)
            parts["mtvm" if transpose else "fwd"].append({
                "ms": cuda_time_ms(lambda: K.mvm_sliced_fused(planes, v, xf, spec=spec, adc_bits=9,
                                                              transpose=transpose), 10),
                "plain_ms": cuda_time_ms(lambda: ref.mvm_sliced_fused_ref(planes, v, xf[0], spec, 16, 9,
                                                                          transpose=transpose), 1, 1),
                "library_ms": cuda_time_ms(lambda: v @ (w.T if transpose else w), 10),
                "bound_ms": bms[0], "bound_by": bms[1]})
        if k1:
            frac = torch.tensor([20], dtype=torch.int32, device="cuda")
            x, dh = exact_operands(torch, rows, M, N, torch.bfloat16, gen)
            want = RO.opa_fused_ref(planes, x, dh, 2.0**-4, frac[0], spec, (5, 7))
            got = KO.opa_fused(planes.clone(), x, dh, 2.0**-4, frac, spec=spec, key_words=(5, 7))
            if not torch.equal(got, want):
                raise AssertionError(f"(a) K1 on {name} ({M}x{N}) at {rows} tokens vs plain")
            del got, want
            x = torch.randn((rows, M), generator=gen, device="cuda").to(torch.bfloat16)
            dh = (torch.randn((rows, N), generator=gen, device="cuda") * 1e-3).to(torch.bfloat16)
            b = KW.opa_work(rows, M, N, S).bound_ms()
            parts["k1"].append({
                "ms": cuda_time_ms(lambda: KO.opa_fused(planes, x, dh, 3e-2, frac, spec=spec, key_words=(1, 2)), 5),
                "plain_ms": cuda_time_ms(lambda: RO.opa_fused_ref(planes, x, dh, 3e-2, frac[0], spec, (1, 2)), 1, 1),
                "library_ms": cuda_time_ms(lambda: x.T @ dh, 10), "bound_ms": b[0], "bound_by": b[1]})
        del planes, w
        torch.cuda.empty_cache()
    return {k: {"ms": sum(p["ms"] for p in ps), "plain_ms": sum(p["plain_ms"] for p in ps),
                "library_ms": sum(p["library_ms"] for p in ps), "bound_ms": sum(p["bound_ms"] for p in ps),
                "bound_by": "bytes" if all(p["bound_by"] == "bytes" for p in ps) else "operations"}
            for k, ps in parts.items()}


def chunked_attention_checks(torch, gen):
    """Phase 19 (b): ``_sdpa_chunked`` against ``_sdpa`` under the explicit
    mask, f32, over 5120 keys: gemma2-9b's heads (16 / 8 of 256) under
    softcap 50, windowed at 4096 and not; MLA's widths (16 heads of 192,
    values of 128). Within CHUNKED_TOL; each timed beside the explicit one.
    Returns the device ms by case."""
    import dataclasses

    from repro_torch.models import attention as att

    g, d = new_arch_cfgs()
    out = {}
    for name, cfg, H, KV, hd, hd_v, window in (
            ("gemma2_window", dataclasses.replace(g, dtype=torch.float32), 16, 8, 256, 256, g.window),
            ("gemma2_global", dataclasses.replace(g, dtype=torch.float32), 16, 8, 256, 256, None),
            ("mla", dataclasses.replace(d, dtype=torch.float32), 16, 16, 192, 128, None)):
        S = LONG_PROMPT
        q = torch.randn((1, S, H, hd), generator=gen, device="cuda")
        k = torch.randn((1, S, KV, hd), generator=gen, device="cuda")
        v = torch.randn((1, S, KV, hd_v), generator=gen, device="cuda")
        got = att._sdpa_chunked(cfg, q, k, v, window)
        mask = att.causal_mask(S, S, window, device="cuda")
        want = att._sdpa(cfg, q, k, v, mask)
        err = float((got - want).abs().max())
        bad = int(((got - want).abs() > CHUNKED_TOL + CHUNKED_TOL * want.abs()).sum())
        del want
        out[name] = {"chunked_ms": cuda_time_ms(lambda: att._sdpa_chunked(cfg, q, k, v, window), 2, 1),
                     "explicit_ms": cuda_time_ms(lambda: att._sdpa(cfg, q, k, v, mask), 2, 1), "max_abs_err": err}
        print(f"  (b) {name}: {H} heads / {KV} of {hd} (values {hd_v}), {S} keys, window {window}, softcap "
              f"{cfg.softcap_attn}: chunked vs explicit mask max |diff| {err:.3g} ({bad} beyond {CHUNKED_TOL} "
              f"abs + rel); chunked {out[name]['chunked_ms']:.2f} ms, explicit {out[name]['explicit_ms']:.2f} ms",
              flush=True)
        if bad:
            raise AssertionError(f"(b) {name}: the chunked attention off the explicit mask's by {err}")
        del q, k, v, got, mask
        torch.cuda.empty_cache()
    return out


def decode_attention_times(torch, cfg, B, Sk, gen):
    """Device ms of a decode step's plain attention pieces, bf16, at ``B``
    slots over ``Sk`` cached positions: gemma2's ring mask and ``_sdpa``
    (one local layer), MLA's ``_mla_attend`` with its two up-projection
    reads on plain weights (one layer)."""
    from repro_torch.models import attention as att
    from repro_torch.models import lm

    bf = torch.bfloat16
    if cfg.mla is None:
        q = torch.randn((B, 1, cfg.n_heads, cfg.head_dim), generator=gen, device="cuda").to(bf)
        kv = [torch.randn((B, Sk, cfg.n_kv_heads, cfg.head_dim), generator=gen, device="cuda").to(bf)
              for _ in range(2)]
        pos = torch.full((B,), Sk - 1, device="cuda")
        return cuda_time_ms(lambda: att._sdpa(cfg, q, *kv, lm.ring_mask(pos, Sk, cfg.window, device="cuda")), 20)
    m, H = cfg.mla, cfg.n_heads
    p = {"w_uk": torch.randn((m.kv_lora_rank, H * m.qk_nope_dim), generator=gen, device="cuda").to(bf),
         "w_uv": torch.randn((m.kv_lora_rank, H * m.v_head_dim), generator=gen, device="cuda").to(bf)}
    qn = torch.randn((B, 1, H, m.qk_nope_dim), generator=gen, device="cuda").to(bf)
    qr = torch.randn((B, 1, H, m.qk_rope_dim), generator=gen, device="cuda").to(bf)
    c = torch.randn((B, Sk, m.kv_lora_rank), generator=gen, device="cuda").to(bf)
    kr = torch.randn((B, Sk, 1, m.qk_rope_dim), generator=gen, device="cuda").to(bf)
    mask = att.decode_posmask(Sk - 1, Sk, device="cuda")
    return cuda_time_ms(lambda: att._mla_attend(cfg, p, qn, qr, c, kr, mask, bf), 20)


def long_prompt_check(torch, cfg, opt_cfg, state, gen, device="cuda", L=LONG_PROMPT):
    """Phase 19 (c): on the lossless tree, one 5120-token prompt through the
    chunked path (every layer: 5 x 5 chunk pairs; the local layers' window
    of 4096 masks the last 1024 queries' oldest keys), then 8 decode steps
    through the window, the logits against the forward's (the explicit
    mask over 5128 keys) at those positions: in f32 within LONG_TOL[f32]
    (the gate), and in bf16 against LONG_TOL[bf16], the count beyond it
    printed (on an H100, 4-7 of 2304000 logits, by at most 0.063: PERF.md §7)."""
    import dataclasses

    from repro_torch.models import attention as att
    from repro_torch.models import lm
    from repro_torch.optim import panther
    from repro_torch.serve.kv_pages import grow_caches

    lossless = panther.materialize_split(state.digital, state.sliced, opt_cfg)
    N = LONG_DECODE
    x = torch.randint(0, cfg.vocab, (1, L + N), generator=gen, device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    calls = []
    chunked = att._sdpa_chunked
    att._sdpa_chunked = lambda *a: calls.append(a[1].shape[1]) or chunked(*a)
    out = {}
    try:
        for dtype in (torch.bfloat16, torch.float32):
            c = dataclasses.replace(cfg, dtype=dtype)
            with torch.no_grad():
                sync()
                t0 = time.perf_counter()
                logits, caches = lm.prefill(c, lossless, x[:, :L])
                sync()
                prefill_ms = 1e3 * (time.perf_counter() - t0)
                got = [logits[0].float()]
                caches = grow_caches(c, lm.unstack_caches(c, caches), L + N)
                t0 = time.perf_counter()
                for i in range(N):
                    logits, caches = lm.decode_step(c, lossless, x[:, L + i], caches, L + i)
                    got.append(logits[0].float())
                sync()
                decode_ms = 1e3 * (time.perf_counter() - t0) / N
                del caches
                full, _ = lm.forward(c, lossless, x)
                want = full[0, L - 1:].float()
                del full
            got = torch.stack(got)
            tol = LONG_TOL[str(dtype).split(".")[-1]]
            bad = int(((got - want).abs() > tol + tol * want.abs()).sum())
            err = float((got - want).abs().max())
            name = str(dtype).split(".")[-1]
            out[name] = {"prefill_ms": prefill_ms, "decode_ms": decode_ms, "max_abs_err": err, "beyond_tol": bad}
            print(f"  (c) one {L}-token prompt on the lossless tree, {name}: prefill {prefill_ms:.1f} ms, {N} decode "
                  f"steps {decode_ms:.1f} ms a step; logits at positions {L - 1}..{L + N - 1} against the "
                  f"forward's: max |diff| {err:.3g}, {bad} of {got.numel()} beyond {tol} abs + rel", flush=True)
            if not bool(torch.isfinite(got).all()) or (dtype == torch.float32 and bad):
                raise AssertionError(f"(c) the long prompt in {name}: {bad} logits off the forward's")
            del got, want
    finally:
        att._sdpa_chunked = chunked
    print(f"    {len(calls)} chunked attention calls over {sorted(set(calls))} keys", flush=True)
    if calls != [L] * (2 * cfg.n_layers):
        raise AssertionError(f"(c) the prefills took the chunked path {len(calls)} times, not {2 * cfg.n_layers}")
    return out


def phase_new_archs(torch, K, gen):
    """Phase 19: gemma2-9b (4 of 21 pairs) and deepseek-v2-lite-16b
    (``mla_dense`` x 1 + ``mla_moe`` x 2) at full width, bf16, seed weights
    in 44466555 planes: (a) the kernels at their new shapes, (b) the chunked
    attention on the card, then each arch's training, serving and engine."""
    import dataclasses

    from repro_torch.core.slicing import DEFAULT_SPEC

    t = [time.perf_counter()]
    g_cfg, d_cfg = new_arch_cfgs()
    spec = DEFAULT_SPEC
    timings = {}
    gt = tile_kernel_times(torch, K, spec, gemma2_tiles(g_cfg), T_NEW, gen)
    timings.update({"mvm_sliced_fused_gemma2": gt["fwd"], "mvm_sliced_fused_gemma2_transpose": gt["mtvm"],
                    "opa_fused_gemma2": gt["k1"]})
    mt = mla_tiles(d_cfg)
    wt = tile_kernel_times(torch, K, spec, {"wq_dkv": mt["wq_dkv"]}, T_NEW, gen)
    timings.update({"mvm_sliced_fused_wq_dkv": wt["fwd"], "mvm_sliced_fused_wq_dkv_transpose": wt["mtvm"],
                    "opa_fused_wq_dkv": wt["k1"]})
    # the up-projections at a decode step of serve_and_engine: B x (P + N) cache rows
    up_rows = SSM_BATCH * (SSM_SERVE_PROMPT + SSM_SERVE_TOKENS)
    ut = tile_kernel_times(torch, K, spec, {k: mt[k] for k in ("w_uk", "w_uv")}, up_rows, gen,
                           directions=(False,), k1=False)
    timings["mvm_sliced_fused_mla_up"] = ut["fwd"]
    print(f"  (a) bit for bit against plain at adc9: K4 forward and MᵀVM and K1 on gemma2-9b's five tiles "
          f"{list(gemma2_tiles(g_cfg).values())} and on wq_dkv {mt['wq_dkv']} at {T_NEW} rows; K4 on w_uk/w_uv "
          f"{mt['w_uk']} at a decode step's {up_rows} cache rows", flush=True)
    attn = chunked_attention_checks(torch, gen)
    t.append(time.perf_counter())

    summary, launches = {}, collections.Counter()
    for cfg in (g_cfg, d_cfg):
        arch = "gemma2_9b" if cfg.mla is None else "deepseek_v2_lite_16b"
        cfg, opt_cfg, state = ssm_state(torch, arch, gen, cfg=cfg)
        if cfg.moe is not None:
            timings.update(moe_kernel_times(torch, K, cfg, opt_cfg, state, gen, gi=1, suffix="64"))
        state, totals, info = train_steps(torch, cfg, opt_cfg, state, gen)
        long = long_prompt_check(torch, cfg, opt_cfg, state, gen) if cfg.mla is None else None
        # at deepseek's capacity factor 1.25 a token's experts depend on its
        # batch (ROADMAP Queue 3): the scheduling-invariance check of the
        # paged c_kv/k_rope pools runs the same weights with no capacity drop
        no_drop = None if cfg.moe is None else dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=2.0 * cfg.moe.n_experts / cfg.moe.top_k))
        serving = serve_and_engine(torch, cfg, opt_cfg, state, gen, requests=NEW_ENGINE_REQUESTS,
                                   lossless_cfg=no_drop)
        _, default_totals, default_info = train_steps(torch, cfg, opt_cfg, default_layout(opt_cfg, state), gen,
                                                      modes=("default",))
        for k in totals:
            totals[k].update(default_totals[k])
        info["ms"].update(default_info["ms"])
        info["loss"] += default_info["loss"]
        info["launches"].update(default_info["launches"])
        del state
        torch.cuda.empty_cache()
        t.append(time.perf_counter())
        k4 = totals["k4"] + serving["k4"]
        summary[arch] = {"train_ms": info["ms"], "losses": info["loss"], "peak_gib": info.get("peak_gib"),
                         "busy": info.get("busy"), "launches": info["launches"],
                         "prefill_ms": serving["prefill_ms"], "decode_ms": serving["decode_ms"],
                         "engine_tokens_per_sec": serving["engine_tokens_per_sec"],
                         "decode_attention_ms_a_layer": decode_attention_times(
                             torch, cfg, SSM_BATCH, SSM_SERVE_PROMPT + SSM_SERVE_TOKENS, gen)}
        if long is not None:
            summary[arch]["long_prompt"] = long
        if cfg.mla is None:
            shapes = set(gemma2_tiles(cfg).values())
            launches["mvm_sliced_fused_gemma2"] += sum(n for (tr, r, mn, _), n in k4.items()
                                                       if not tr and r == T_NEW and mn in shapes)
            launches["mvm_sliced_fused_gemma2_transpose"] += sum(n for (tr, r, mn, _), n in k4.items()
                                                                 if tr and r == T_NEW and mn in shapes)
            launches["opa_fused_gemma2"] += sum(n for (r, mn), n in totals["k1"].items() if mn in shapes)
        else:
            from repro_torch.train.step import expert_tokens

            rows, dec = expert_tokens(cfg, T_NEW), expert_tokens(cfg, SSM_BATCH)
            eshape = (cfg.d_model, cfg.moe.d_ff_expert)
            expert = {(cfg.d_model, cfg.moe.d_ff_expert), (cfg.moe.d_ff_expert, cfg.d_model)}
            for name, tr, r, mns in (("mvm_sliced_fused_wq_dkv", False, T_NEW, {mt["wq_dkv"]}),
                                     ("mvm_sliced_fused_wq_dkv_transpose", True, T_NEW, {mt["wq_dkv"]}),
                                     ("mvm_sliced_fused_mla_up", False, up_rows, {mt["w_uk"]}),
                                     ("mvm_sliced_fused_expert64", False, rows, expert),
                                     ("mvm_sliced_fused_expert64_transpose", True, rows, expert),
                                     ("mvm_sliced_fused_expert64_decode", False, dec, expert)):
                launches[name] += sum(n for (t_, r_, mn, _), n in k4.items() if t_ == tr and r_ == r and mn in mns)
            launches["opa_fused_wq_dkv"] += sum(n for (r, mn), n in totals["k1"].items() if mn == mt["wq_dkv"])
            launches["opa_fused_expert64"] += sum(n for (r, mn), n in totals["k1"].items()
                                                  if r == rows and mn in expert)
            launches["opa_dense_expert64"] += sum(n for mn, n in totals["k2"].items() if mn == eshape)
        print(f"phase 19 {arch} summary: {json.dumps(summary[arch])}", flush=True)
    print(f"phase 19 wall: (a)+(b) {t[1] - t[0]:.1f} s, gemma2-9b {t[2] - t[1]:.1f} s, deepseek-v2-lite-16b "
          f"{t[3] - t[2]:.1f} s; attention {json.dumps(attn)}; main-path launches {dict(launches)}", flush=True)
    return launches, timings


# ---------------------------------------------------------------------------
# phase 20: the mesh (torch.distributed, one process a mesh coordinate)

MESH_SHAPE = (2, 2)  # the reference's debug mesh: (data, model)
MESH_LAYERS = 2  # gemma-2b's 18 layers cut to 2: the phase's share of the script's time limit
MESH_TILES = (("attn/wqkv", 2048, 2560), ("attn/wo", 2048, 2048), ("mlp/wi_gate", 2048, 16384),
              ("mlp/wo", 16384, 2048))  # gemma-2b's crossbar tiles
MESH_RTOL = 1e-6  # adc9: |sharded - single| <= MESH_RTOL * max|single| (tests/test_distributed.py)
MESH_LOSS_TOL = (1e-3, 5e-3)  # |loss| steps 1 and 2, times (1 + |loss|): the reference's mesh test
MESH_WEIGHT_TOL = 1e-5  # |w_mesh - w_one| <= MESH_WEIGHT_TOL * max|w|: f32 sums in another order
MESH_SERVE_TOL = 1e-3  # logits on the mesh vs one process, relative to max|logit|: batch-shaped matmuls
MESH_ADC9_OF_MOVE = 0.5  # adc9 steps: a crossbar leaf's |w_mesh - w_one| within this share of |w_one - w_0|
# (L2 over rank 0's block). A block written at a wrong origin or from wrong operands is ~1-1.4 of its move;
# the code flips that an f32 sum in another order sets off stay below it (0.42 after two steps on an H100)
MESH_ADC9_ARGMAX = 0.9  # adc9 serving: the share of positions whose argmax equals one process's
MESH_ENGINE_REQUESTS = 3  # the bench's trace cut to its first 3 requests, as phases 17-19
MESH_TIMEOUT = 900
MESH_LR = 1e-2  # the CPU mesh tests' rate


def mesh_cfg():
    """gemma-2b at full width, MESH_LAYERS deep, in f32: bf16 gradients
    summed over data shards round apart from the single-process sums (the
    reference's mesh test runs f32 too)."""
    import dataclasses

    import torch

    from repro_torch import configs

    cfg = configs.get("gemma_2b")
    return dataclasses.replace(cfg, n_layers=MESH_LAYERS, pattern=(("dense", MESH_LAYERS),), dtype=torch.float32)


def mesh_counts():
    """The kernels' launch counters the mesh phase reads (K4 and K5 forward
    and MᵀVM together)."""
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.sliced_mvm import kernel as KM
    from repro_torch.kernels.sliced_opa import kernel as KO

    return {"mvm_sliced_fused": KM.mvm_sliced_fused.launches + KM.mvm_sliced_fused.transpose_launches,
            "mvm_sliced": KM.mvm_sliced.launches + KM.mvm_sliced.transpose_launches,
            "opa_fused": KO.opa_fused.launches, "opa_dense": KO.opa_dense.launches, "crs": KC.crs.launches}


def mesh_reads(torch, mesh, spec):
    """(a) ``mvm_sliced_sharded`` on gemma-2b's full-width tiles at 256
    tokens (128 a data rank), shard_dim None/0/1, forward and MᵀVM, through
    K4 (fused, float x and the global DAC exponent) and K5 (unfused, int
    x_q), against the single-process kernel read of the rank's rows: bit for
    bit at ``adc_bits=None`` (integer inputs whose every sum is exact in
    f32), within MESH_RTOL at adc9. Then the fold-order witness, on
    weights over all 32 bits and Gaussian float inputs at adc9 with the
    contraction split over 'model': the sharded read equals, bit for bit,
    the single-process K4 reads of the two contraction blocks (each at its
    ``tile0``) added in f32 (``mvm_sliced_folded``), and differs from the
    whole read only by that fold's rounding (within MESH_RTOL).
    Returns the worst adc9 error, the witness and the sharded reads'
    launches by kernel."""
    from repro_torch.core.fixed_point import choose_frac_bits
    from repro_torch.core.slicing import slice_weights
    from repro_torch.distributed import blocks
    from repro_torch.kernels.sliced_mvm import mvm_sliced_batched, mvm_sliced_fused_batched, mvm_sliced_sharded

    gen = torch.Generator(device="cuda").manual_seed(20)
    rows = blocks.block_slices((("data",),), (T_TRAIN,), mesh)[0]
    worst, launches = 0.0, collections.Counter()
    witness = {"cases": 0, "differ": 0, "outputs": 0, "max_rel": 0.0}
    for name, M, N in MESH_TILES:
        planes = slice_weights(torch.randint(-64, 65, (M, N), generator=gen, device="cuda", dtype=torch.int32), spec)
        for transpose in (False, True):
            contract = N if transpose else M
            xi = torch.randint(-30, 31, (T_TRAIN, contract), generator=gen, device="cuda", dtype=torch.int32)
            xf = xi.float()
            xf[0, 0] = 2.0**13  # the DAC exponent 1: every x_q = 2·x, exact
            frac = choose_frac_bits(xf, word_bits=16, margin_bits=1, clip_to_word=False)
            for adc in (None, 9):
                want_i = mvm_sliced_batched(planes, xi, spec, adc_bits=adc, transpose=transpose)[rows]
                want_f = mvm_sliced_fused_batched(planes, xf, frac, spec, adc_bits=adc, transpose=transpose)[rows]
                for sd in (None, 0, 1):
                    pspec = (None, None, None) if sd is None else (None, "model", None) if sd == 0 else \
                        (None, None, "model")
                    local = blocks.local_block(planes, pspec, mesh)
                    kw = dict(mesh=mesh, data_axes=("data",), model_axis="model", shard_dim=sd, adc_bits=adc,
                              transpose=transpose)
                    c0 = mesh_counts()
                    got_i = mvm_sliced_sharded(local, xi[rows], spec, **kw)
                    got_f = mvm_sliced_sharded(local, xf[rows], spec, frac_bits=frac, **kw)
                    c1 = mesh_counts()
                    launches.update({k: c1[k] - c0[k] for k in ("mvm_sliced", "mvm_sliced_fused")})
                    for what, got, want in (("K5", got_i, want_i), ("K4", got_f, want_f)):
                        if adc is None and not torch.equal(got, want):
                            raise AssertionError(f"(a) {what} {name} transpose={transpose} shard_dim={sd} adc None: "
                                                 "the sharded read differs from the single-process read")
                        err = float((got - want).abs().max() / want.abs().max())
                        if adc is not None and not err <= MESH_RTOL:
                            raise AssertionError(f"(a) {what} {name} transpose={transpose} shard_dim={sd} adc9: "
                                                 f"error {err:.3g} > {MESH_RTOL}")
                        worst = max(worst, err)
                    del local
            del xi, xf
        del planes
        planes = slice_weights(torch.randint(-2**30, 2**30, (M, N), generator=gen, device="cuda", dtype=torch.int32),
                               spec)  # every digit plane in use, as in a trained leaf
        for transpose in (False, True):
            fold_witness(torch, planes, spec, mesh, rows, transpose, gen, witness)
        del planes
        empty_cache(torch)
    return worst, witness, dict(launches)


def fold_witness(torch, planes, spec, mesh, rows, transpose, gen, witness):
    """One case of (a)'s fold-order witness (``mesh_reads``), on whole
    ``planes`` [S, M, N]: Gaussian x, adc9, the contraction split over
    'model'. Raises where the sharded read differs from the folded
    single-process reads; adds the gap to the whole read to ``witness``."""
    from repro_torch.core.fixed_point import choose_frac_bits
    from repro_torch.distributed import blocks
    from repro_torch.kernels.sliced_mvm import mvm_sliced_folded, mvm_sliced_fused_batched, mvm_sliced_sharded

    msize = mesh.shape["model"]
    sd = 1 if transpose else 0
    contract = planes.shape[1 + sd]
    if contract % (msize * 128):  # the guard reads the whole planes: nothing folds apart
        return
    x = torch.randn((T_TRAIN, contract), generator=gen, device="cuda")
    frac = choose_frac_bits(x, word_bits=16, margin_bits=1, clip_to_word=False)
    spec_p = (None, "model", None) if sd == 0 else (None, None, "model")
    got = mvm_sliced_sharded(blocks.local_block(planes, spec_p, mesh), x[rows], spec, mesh=mesh, data_axes=("data",),
                             model_axis="model", shard_dim=sd, adc_bits=9, transpose=transpose, frac_bits=frac)
    folded = mvm_sliced_folded(planes, x[rows], frac, spec, parts=msize, shard_dim=sd, adc_bits=9,
                               transpose=transpose)  # two parts: tile_psum's one f32 add
    whole = mvm_sliced_fused_batched(planes, x, frac, spec, adc_bits=9, transpose=transpose)[rows]
    if not torch.equal(got, folded):
        raise AssertionError(f"(a) witness transpose={transpose}: the sharded adc9 read differs from the "
                             "single-process reads folded at the rank boundary")
    rel = float((got - whole).abs().max() / whole.abs().max())
    if not rel <= MESH_RTOL:
        raise AssertionError(f"(a) witness transpose={transpose}: the sharded adc9 read is {rel:.3g} from the whole "
                             f"read, beyond {MESH_RTOL}")
    witness["cases"] += 1
    witness["differ"] += int((got != whole).sum())
    witness["outputs"] += got.numel()
    witness["max_rel"] = max(witness["max_rel"], rel)


def empty_cache(torch):
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def mesh_rel(torch, a, b, opt_cfg) -> float:
    """max |w_a - w_b| over every leaf of two states' dequantized weights,
    over the model's max|w_b|; one leaf at a time."""
    from repro_torch import tree
    from repro_torch.core.slicing import dequantize_planes

    diff = top = 0.0
    for (_, x), (_, y) in zip(tree.leaves_sorted(a.sliced), tree.leaves_sorted(b.sliced)):
        if x is None:
            continue
        wx = dequantize_planes(x.planes, x.frac_bits, opt_cfg.spec)
        wy = dequantize_planes(y.planes, y.frac_bits, opt_cfg.spec)
        diff, top = max(diff, float((wx - wy).abs().max())), max(top, float(wy.abs().max()))
        del wx, wy
    for (_, x), (_, y) in zip(tree.leaves_sorted(a.digital), tree.leaves_sorted(b.digital)):
        if x is not None:
            diff, top = max(diff, float((x - y).abs().max())), max(top, float(y.abs().max()))
    return diff / top


# FSDP only: the 1x2 world steps the tile blocks with no data shards (MESH_MODEL_VARIANTS)
MESH_VARIANTS = (("adc9_fsdp", "adc9", True, 2), ("ideal_fsdp", "ideal", True, 2))


def word_ints(torch, planes):
    """Planes [S, ...] as the integers of their words (int64, exact for
    dirty digits too): a weight is this times 2^-frac_bits."""
    from repro_torch.core.slicing import RADIX

    acc = planes[-1].long()
    for s in range(planes.shape[0] - 2, -1, -1):
        acc = acc * RADIX + planes[s].long()
    return acc


def mesh_leaf_gaps(torch, local, whole, init, specs, mesh):
    """Rank 0's blocks of the mesh state's crossbar leaves against the same
    blocks of the single-process state, in units of the word's last bit
    (2^-frac_bits): per leaf the largest gap, the cells that differ, the
    cells, and the largest change the steps so far made to the block
    (``init``: rank 0's planes before the first step, by path)."""
    from repro_torch import tree
    from repro_torch.distributed import blocks

    out = {}
    for (path, x), (_, y), (_, sp) in zip(tree.leaves_sorted(local.sliced), tree.leaves_sorted(whole.sliced),
                                          tree.leaves_sorted(specs.sliced)):
        if x is None:
            continue
        if not torch.equal(x.frac_bits.to(y.frac_bits.device), y.frac_bits):
            raise AssertionError(f"(c) {path}: the mesh and the single process scaled the leaf apart (frac_bits)")
        wy = word_ints(torch, y.planes[blocks.block_slices(sp.planes, tuple(y.planes.shape), mesh)])
        gap = (word_ints(torch, x.planes) - wy).abs()
        moved = (wy - word_ints(torch, init[path])).abs()
        out["/".join(map(str, path))] = {
            "max_lsb": int(gap.max()), "cells_differ": int((gap != 0).sum()), "cells": gap.numel(),
            "max_update_lsb": int(moved.max()),
            "of_update": float(gap.double().norm() / moved.double().norm().clamp_min(1.0))}
        del wy, gap, moved
    return out


def mesh_block_rel(torch, local, whole, specs, mesh, opt_cfg) -> float:
    """max |w_local - w_whole| over this rank's blocks of every leaf (the
    dequantized weights), over the whole model's max|w_whole|."""
    from repro_torch import tree
    from repro_torch.core.slicing import dequantize_planes
    from repro_torch.distributed import blocks

    diff = top = 0.0
    for (_, x), (_, y), (_, sp) in zip(tree.leaves_sorted(local.sliced), tree.leaves_sorted(whole.sliced),
                                       tree.leaves_sorted(specs.sliced)):
        if x is None:
            continue
        wy = dequantize_planes(y.planes, y.frac_bits, opt_cfg.spec)
        top = max(top, float(wy.abs().max()))
        wy = wy[blocks.block_slices(sp.planes[1:], tuple(wy.shape), mesh)]
        diff = max(diff, float((dequantize_planes(x.planes, x.frac_bits, opt_cfg.spec) - wy).abs().max()))
        del wy
    for (_, x), (_, y), (_, sp) in zip(tree.leaves_sorted(local.digital), tree.leaves_sorted(whole.digital),
                                       tree.leaves_sorted(specs.digital)):
        if x is not None:
            top = max(top, float(y.abs().max()))
            diff = max(diff, float((x - y[blocks.block_slices(sp, tuple(y.shape), mesh)]).abs().max()))
    return diff / top


MESH_MODEL_VARIANTS = (("adc9_model", "adc9", False, 2),)  # the 1x2 world's: the tile blocks without data shards


def mesh_train(torch, mesh, root, directory, variants=MESH_VARIANTS, fold=False):
    """(c) gemma-2b at full width (MESH_LAYERS deep, f32) from the seed
    weights and batches: the ``variants``' steps on the mesh against the
    single-process steps (rank 0), coverage rules, two steps each (adc9 and
    ideal ADC under FSDP; adc9 with no data shards on the 1x2 world). Rank
    0 compares after each step the losses,
    its blocks' weights over the model's max|w| (``mesh_block_rel``) and its
    crossbar cells in units of a word's last bit (``mesh_leaf_gaps``); each
    step's ms on this rank and its launches. ``fold``: the single-process
    step starts each time from the mesh's own state before it (gathered),
    its reads folded at the mesh's rank boundary
    (``distributed.fidelity.FoldCtx``, the mesh's plan). (e) The adc9 FSDP run's state saved on the mesh, restored on one
    process, rank 0's blocks equal bit for bit."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch import plan as planlib
    from repro_torch import tree
    from repro_torch.checkpoint import restore_latest, save_checkpoint
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.distributed import fidelity as dist_fid
    from repro_torch.optim import PantherConfig
    from repro_torch.optim.schedules import constant
    from repro_torch.train import step as S

    dev = "cuda"
    cfg = mesh_cfg()
    opt_cfg = PantherConfig(crs_every=2, stochastic_round=True)
    ds = SyntheticLMDataset(cfg.vocab, 64, 4, device=dev)
    out = {"launches": collections.Counter(), "step_ms": []}
    for name, preset, fsdp, steps in variants:
        fid = dataclasses.replace(configs.fidelity_presets()[preset], spec=opt_cfg.spec)
        rules = planlib.coverage_rules(opt_cfg, fid)
        step = S.make_train_step(cfg, opt_cfg, constant(MESH_LR), mesh=mesh, fsdp=fsdp, plan_rules=rules, remat="none")
        one = S.make_train_step(cfg, opt_cfg, constant(MESH_LR), **({"plan": step.plan} if fold else
                                                                     {"plan_rules": rules}), remat="none")
        res = {"mesh_loss": [], "one_loss": [], "rel": [], "leaves": [], "steps": steps, "fold": fold}
        ref = S.train_state_init(cfg, opt_cfg, 0, device=dev) if root and not fold else None
        state = S.shard_state(S.train_state_init(cfg, opt_cfg, 0, device=dev), step.specs, mesh)
        init = {p: s.planes.clone() for p, s in tree.leaves_with_path(state.sliced) if s is not None} if root else None
        empty_cache(torch)
        for k in range(steps):
            if fold:
                ref = S.gather_state(state, step.specs, mesh)  # a collective: every rank
                ref = ref if root else None
            c0 = mesh_counts()
            sync(torch)
            t0 = time.perf_counter()
            state, m = step(state, ds.batch(k))
            loss = float(m["loss"])
            sync(torch)
            out["step_ms"].append(1e3 * (time.perf_counter() - t0))
            c1 = mesh_counts()
            out["launches"].update({key: c1[key] - c0[key] for key in c1})
            res["mesh_loss"].append(loss)
            dist.barrier()  # rank 0's witness below launches nothing the counts read
            if root:
                with dist_fid.use_sharded_fidelity(dist_fid.FoldCtx(mesh.shape["model"]) if fold else None):
                    ref, m1 = one(ref, ds.batch(k))
                res["one_loss"].append(float(m1["loss"]))
                res["rel"].append(mesh_block_rel(torch, state, ref, step.specs, mesh, opt_cfg))
                res["leaves"].append(mesh_leaf_gaps(torch, state, ref, init, step.specs, mesh))
                worst = max(res["leaves"][-1].items(), key=lambda kv: kv[1]["of_update"])
                print(f"    (c) {name} step {k + 1}: loss {loss:.6f} (one process {res['one_loss'][k]:.6f}), "
                      f"{out['step_ms'][-1]:.1f} ms on rank 0; rank 0's blocks within {res['rel'][-1]:.3g} of "
                      f"max|w|; the worst crossbar leaf {worst[0]}: {worst[1]}", flush=True)
            if fold:
                ref = None
            dist.barrier()
        if name == "adc9_fsdp":  # (e)
            t0 = time.perf_counter()
            save_checkpoint(directory, steps - 1, state, plan=step.plan, mesh=mesh, specs=step.specs)
            res["ckpt_save_s"] = time.perf_counter() - t0
            if root:
                t0 = time.perf_counter()
                restored, rstep = restore_latest(directory, S.train_state_init(cfg, opt_cfg, 0, device=dev),
                                                 device=dev)
                res["ckpt_restore_s"] = time.perf_counter() - t0
                res["ckpt_equal"] = rstep == steps - 1 and mesh_block_rel(torch, state, restored, step.specs, mesh,
                                                                          opt_cfg) == 0.0
                del restored
            dist.barrier()
        out[name] = res
        del state, ref, init
        empty_cache(torch)
    out["launches"] = dict(out["launches"])
    return out


def mesh_serve(torch, mesh, root):
    """(d) prefill 4 x 32 and 4 decode steps on the mesh (each rank its 2
    prompts) against one process (rank 0): on the lossless tree, logits
    within MESH_SERVE_TOL of max|logit| (f32 matmuls of another batch
    shape); through the adc9 reads on each rank's tile blocks, finite
    logits whose argmax equals one process's at MESH_ADC9_ARGMAX of the
    positions or more (the gap printed: the reads fold their tiles' f32
    partials in another order, and a later DAC or ADC code flips); K4's
    launches."""
    import dataclasses

    from repro_torch import configs
    from repro_torch import plan as planlib
    from repro_torch.models import lm
    from repro_torch.optim import PantherConfig, panther
    from repro_torch.serve import kv_pages
    from repro_torch.serve.step import fidelity_params, make_decode_step, make_prefill
    from repro_torch.train import step as S

    dev = "cuda"
    cfg = mesh_cfg()
    opt_cfg = PantherConfig()
    state = S.train_state_init(cfg, opt_cfg, 0, device=dev)
    fid = dataclasses.replace(configs.fidelity_presets()["adc9"], spec=opt_cfg.spec)
    plan = planlib.resolve_plan(S.param_shapes(state.digital, state.sliced), planlib.default_rules(opt_cfg, fid))
    specs = S.storage_specs(cfg, opt_cfg, mesh, plan=plan)
    params = panther.materialize_split(state.digital, state.sliced, opt_cfg)
    served = {"mesh": fidelity_params(params, S.shard_state(state, specs, mesh).sliced, plan, mesh=mesh,
                                      specs=specs.sliced), "lossless_mesh": params}
    if root:
        served["one"] = fidelity_params(params, state.sliced, plan)
        served["lossless_one"] = params
    del state
    gen = torch.Generator(device=dev).manual_seed(21)
    prompts = torch.randint(0, cfg.vocab, (4, 32), generator=gen, device=dev)
    logits, counts = {}, {}
    for key, p in served.items():
        m = mesh if key.endswith("mesh") else None
        prefill, decode = make_prefill(cfg, mesh=m), make_decode_step(cfg, mesh=m)
        c0 = mesh_counts()
        sync(torch)
        t0 = time.perf_counter()
        lg, caches = prefill(p, prompts)
        caches = kv_pages.grow_caches(cfg, lm.unstack_caches(cfg, caches), 32 + 4)
        seq, tok = [lg], torch.argmax(lg, dim=-1)
        for i in range(4):
            tok, lg, caches = decode(p, tok, caches, 32 + i)
            seq.append(lg)
        sync(torch)
        logits[key] = (torch.stack(seq), 1e3 * (time.perf_counter() - t0))
        c1 = mesh_counts()
        counts[key] = c1["mvm_sliced_fused"] - c0["mvm_sliced_fused"]
    out = {"launches": counts["mesh"], "ms": logits["mesh"][1]}
    if root:
        for tree_, (a, b) in (("adc9", (logits["mesh"][0], logits["one"][0])),
                              ("lossless", (logits["lossless_mesh"][0], logits["lossless_one"][0]))):
            out[tree_] = {"max_rel": float((a - b).abs().max() / b.abs().max()),
                          "argmax_equal": float((a.argmax(-1) == b.argmax(-1)).float().mean()),
                          "finite": bool(torch.isfinite(a).all())}
        out["one_ms"] = logits["one"][1]
    return out


def mesh_world(rank, directory):
    """The 2x2 world's work on one rank: (a), (c), (e), (d). Returns this
    rank's results."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.launch import mesh as M

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")  # four ranks share the card
    backend, dev = M.init_world("cuda")
    mesh = M.init_mesh(MESH_SHAPE)
    root = dist.get_rank() == 0
    out = {"backend": backend, "device": str(dev), "coordinate": mesh.coordinate}
    t0 = time.perf_counter()
    out["reads_err"], out["witness"], out["reads_launches"] = mesh_reads(torch, mesh, DEFAULT_SPEC)
    out["reads_s"] = time.perf_counter() - t0
    if root:
        print(f"    (a) done on rank 0 in {out['reads_s']:.1f} s", flush=True)
    t0 = time.perf_counter()
    out["train"] = mesh_train(torch, mesh, root, directory)
    out["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["serve"] = mesh_serve(torch, mesh, root)
    out["serve_s"] = time.perf_counter() - t0
    if root:
        print(f"    (d) serving done on rank 0 in {out['serve_s']:.1f} s", flush=True)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def engine_world(rank, requests):
    """The 1x2 world: (c) the MESH_MODEL_VARIANTS' steps (``mesh_train``);
    (d) the engine on the 1x2 mesh over the bench's trace cut to
    ``requests``: through the adc9 tree (tokens/s, K4 launches), and the
    lossless tree's tokens against solo serving (rank 0)."""
    import dataclasses
    import os

    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch import plan as planlib
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve as LS
    from repro_torch.optim import PantherConfig, panther
    from repro_torch.serve import scheduler as sch
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.step import fidelity_params
    from repro_torch.train import step as S

    dev = "cuda"
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    M.init_world(dev)
    mesh = M.init_mesh((1, 2))
    out = {"train": mesh_train(torch, mesh, dist.get_rank() == 0, None, MESH_MODEL_VARIANTS, fold=True)}
    cfg = mesh_cfg()
    opt_cfg = PantherConfig()
    state = S.train_state_init(cfg, opt_cfg, 0, device=dev)
    fid = dataclasses.replace(configs.fidelity_presets()["adc9"], spec=opt_cfg.spec)
    plan = planlib.resolve_plan(S.param_shapes(state.digital, state.sliced), planlib.default_rules(opt_cfg, fid))
    specs = S.storage_specs(cfg, opt_cfg, mesh, plan=plan)
    lossless = panther.materialize_split(state.digital, state.sliced, opt_cfg)
    adc9 = fidelity_params(lossless, S.shard_state(state, specs, mesh).sliced, plan, mesh=mesh, specs=specs.sliced)
    del state
    trace = LS.bench_trace(cfg, 32, seed=0, rate=1e4)[:requests]
    for name, params in (("adc9", adc9), ("lossless", lossless)):
        eng = Engine(cfg, params, n_slots=LS.N_SLOTS, max_seq=LS.MAX_SEQ, page=LS.PAGE, chunk_size=LS.CHUNK,
                     mesh=mesh, device=dev)
        c0 = mesh_counts()
        t0 = time.perf_counter()
        res = sch.run_trace({"default": eng}, trace, policy="continuous")
        out[name] = {"wall_s": time.perf_counter() - t0, "tokens_per_sec": sch.summarize(res)["tokens_per_sec"],
                     "launches": mesh_counts()["mvm_sliced_fused"] - c0["mvm_sliced_fused"],
                     "tokens": {r.rid: list(r.tokens) for r in res["requests"]}, "clock": res["clock"]}
    if dist.get_rank() == 0:
        with torch.no_grad():
            solo = {r.rid: replicated_solo_tokens(torch, cfg, lossless, r, LS.N_SLOTS, dev) for r in trace}
        out["lossless_equal"] = sum(out["lossless"]["tokens"][rid] == t for rid, t in solo.items())
    return out


def mesh_block_checks(torch, spec, gen):
    """(b) K1 and K2 on each block of a 2x2 split at its origin, and K3 on
    the block, bit for bit against the same block of the whole-leaf kernel:
    K1 on gemma-2b's wi_gate 2048x16384 (256 tokens, bf16) under the
    counter, grid and hw draws, ideal and device; K2 on the embedding
    256000x2048 (f32 gradient) under half to even, counter and grid, ideal
    and device; K3 on the embedding's blocks. Returns the cases checked."""
    from repro_torch.core import prng
    from repro_torch.kernels.common import Origin
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO
    from repro_torch.models.common import DeviceModel

    dev = DeviceModel(**{k: v for k, v in DEVICE.items() if k != "read_noise"})
    frac = torch.tensor([30], dtype=torch.int32, device="cuda")
    cases = 0
    M, N = 2048, 16384
    whole = random_planes(torch, spec, (M, N), gen)
    x = torch.randn((T_TRAIN, M), generator=gen, device="cuda").to(torch.bfloat16)
    dh = (torch.randn((T_TRAIN, N), generator=gen, device="cuda") * 1e-3).to(torch.bfloat16)
    for mode in ("counter", "grid", "hw"):
        for d in (None, dev):
            key = (123, -45)
            nw = (7, 8) if d is not None else None
            want = whole.clone()
            KO.opa_fused(want, x, dh, 3e-2, frac, spec=spec, key_words=key, rng_mode=mode, offset=5 * M * N, dev=d,
                         noise_words=nw)
            for r0 in (0, M // 2):
                for c0 in (0, N // 2):
                    blk = whole[:, r0:r0 + M // 2, c0:c0 + N // 2].contiguous()
                    KO.opa_fused(blk, x[:, r0:r0 + M // 2].contiguous(), dh[:, c0:c0 + N // 2].contiguous(), 3e-2,
                                 frac, spec=spec, key_words=key, rng_mode=mode, offset=5 * M * N, dev=d,
                                 noise_words=nw, origin=Origin(r0, c0, M, N))
                    if not torch.equal(blk, want[:, r0:r0 + M // 2, c0:c0 + N // 2]):
                        raise AssertionError(f"(b) K1 {mode} {'device' if d else 'ideal'}: the block at ({r0}, {c0}) "
                                             "differs from the whole leaf's")
                    cases += 1
            del want
    del whole, x, dh
    torch.cuda.empty_cache()
    V, D = EMBED_SHAPE
    whole = random_planes(torch, spec, (V, D), gen)
    g = torch.randn((V, D), generator=gen, device="cuda") * 1e-3
    for draw in ("rint", "counter", "grid"):
        for d in (None, dev):
            key = None if draw == "rint" else (31, 41)
            nw = (7, 8) if d is not None else None
            want = whole.clone()
            KO.opa_dense(want, g, 3e-2, frac, spec=spec, key_words=key, rng_mode="counter" if draw == "rint" else draw,
                         offset=3 * V * D, dev=d, noise_words=nw)
            for r0 in (0, V // 2):
                for c0 in (0, D // 2):
                    blk = whole[:, r0:r0 + V // 2, c0:c0 + D // 2].contiguous()
                    KO.opa_dense(blk, g[r0:r0 + V // 2, c0:c0 + D // 2].contiguous(), 3e-2, frac, spec=spec,
                                 key_words=key, rng_mode="counter" if draw == "rint" else draw, offset=3 * V * D,
                                 dev=d, noise_words=nw, origin=Origin(r0, c0, V, D))
                    if not torch.equal(blk, want[:, r0:r0 + V // 2, c0:c0 + D // 2]):
                        raise AssertionError(f"(b) K2 {draw} {'device' if d else 'ideal'}: the block at ({r0}, {c0}) "
                                             "differs from the whole leaf's")
                    cases += 1
                    del blk
            del want
    want = whole.clone()
    KC.crs(want, spec=spec)
    for r0 in (0, V // 2):
        for c0 in (0, D // 2):
            blk = whole[:, r0:r0 + V // 2, c0:c0 + D // 2].contiguous()
            KC.crs(blk, spec=spec)
            if not torch.equal(blk, want[:, r0:r0 + V // 2, c0:c0 + D // 2]):
                raise AssertionError(f"(b) K3: the block at ({r0}, {c0}) differs from the whole leaf's")
            cases += 1
    del whole, g, want
    torch.cuda.empty_cache()
    # K1 against its plain version at a block origin, hw draw, device physics, on operands whose f32
    # contraction is exact in any order (the tensor cores sum in another order than the plain version)
    p = random_planes(torch, spec, (256, 512), gen)
    xs, ds = exact_operands(torch, 17, 256, 512, torch.bfloat16, gen)
    o = Origin(128, 256, 512, 1024)
    for d in (None, dev):
        nw = (7, 8) if d is not None else None
        a = KO.opa_fused(p.clone(), xs, ds, 3e-2, frac, spec=spec, key_words=(5, 6), rng_mode="hw", origin=o, dev=d,
                         noise_words=nw)
        b = RO.opa_fused_ref(p, xs, ds, 3e-2, frac[0], spec, (5, 6), d, nw, rng_mode="hw", origin=o)
        if not torch.equal(a, b):
            raise AssertionError(f"(b) K1 hw {'device' if d else 'ideal'} at a block origin differs from its plain "
                                 "version")
        cases += 1
    return cases


def mesh_block_timings(torch, K, ref, spec, gen):
    """A rank's kernels on its block (the 2x2 mesh's): K4 and K5 on
    wi_gate's column block 2048x8192 at 256 tokens (the whole 2048x16384
    read beside it), K1 on that block, K2 on the embedding's row block
    128000x2048 (f32, counter), K3 on it: kernel, plain version, library
    yardstick, bound."""
    from repro_torch.kernels import common as KW
    from repro_torch.core.slicing import dequantize_planes
    from repro_torch.kernels.common import Origin
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.crs import ref as RC
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO

    S, T = spec.n_slices, T_TRAIN
    out = {}
    M, N = 2048, 16384
    planes = torch.randint(-8, 8, (S, M, N // 2), generator=gen, device="cuda", dtype=torch.int8)
    whole = torch.randint(-8, 8, (S, M, N), generator=gen, device="cuda", dtype=torch.int8)
    xf = torch.randn((T, M), generator=gen, device="cuda")
    frac = torch.tensor([10], dtype=torch.int32, device="cuda")
    x_q = ref.dac_quantize(xf, 10, 16)
    w = dequantize_planes(planes, 30, spec)
    b = bound_ms(T, M, N // 2, S, 16)
    lib = cuda_time_ms(lambda: torch.matmul(xf, w), 10)
    out["mvm_sliced_fused_sharded"] = {
        "ms": cuda_time_ms(lambda: K.mvm_sliced_fused(planes, xf, frac, spec=spec, adc_bits=9, col0=N // 2), 5),
        "whole_ms": cuda_time_ms(lambda: K.mvm_sliced_fused(whole, xf, frac, spec=spec, adc_bits=9), 5),
        "plain_ms": cuda_time_ms(lambda: ref.mvm_sliced_fused_ref(planes, xf, frac[0], spec, 16, 9, col0=N // 2), 2, 1),
        "bound_ms": b[0], "bound_by": b[1], "library_ms": lib}
    out["mvm_sliced_sharded"] = {
        "ms": cuda_time_ms(lambda: K.mvm_sliced(planes, x_q, spec=spec, adc_bits=9), 5),
        "plain_ms": cuda_time_ms(lambda: ref.mvm_sliced_ref(planes, x_q, spec, 16, 9), 2, 1),
        "bound_ms": b[0], "bound_by": b[1], "library_ms": lib}
    del whole, w
    fr = torch.tensor([30], dtype=torch.int32, device="cuda")
    xb = torch.randn((T, M), generator=gen, device="cuda").to(torch.bfloat16)
    dhb = (torch.randn((T, N // 2), generator=gen, device="cuda") * 1e-3).to(torch.bfloat16)
    o = Origin(0, N // 2, M, N)
    b = KW.opa_work(T, M, N // 2, S).bound_ms()
    out["opa_fused_block"] = {
        "ms": cuda_time_ms(lambda: KO.opa_fused(planes, xb, dhb, 3e-2, fr, spec=spec, key_words=(1, 2), origin=o), 10),
        "plain_ms": cuda_time_ms(lambda: RO.opa_fused_ref(planes, xb, dhb, 3e-2, fr[0], spec, (1, 2), origin=o), 3, 1),
        "library_ms": cuda_time_ms(lambda: torch.matmul(xb.t(), dhb), 10), "bound_ms": b[0], "bound_by": b[1]}
    del planes, xf, x_q, xb, dhb
    torch.cuda.empty_cache()
    V, D = EMBED_SHAPE
    planes = torch.randint(-8, 8, (S, V // 2, D), generator=gen, device="cuda", dtype=torch.int8)
    g = torch.randn((V // 2, D), generator=gen, device="cuda") * 1e-3
    o = Origin(V // 2, 0, V, D)
    b = KW.dense_work(V // 2, D, S).bound_ms()
    out["opa_dense_block"] = {
        "ms": cuda_time_ms(lambda: KO.opa_dense(planes, g, 3e-2, fr, spec=spec, key_words=(1, 2), origin=o), 5),
        "plain_ms": cuda_time_ms(lambda: plain_by_rows(torch, lambda a, q, r0=0: RO.opa_dense_ref(
            a, q, 3e-2, 30, spec, (1, 2), origin=o), planes, g), 1, 1),
        "library_ms": None, "bound_ms": b[0], "bound_by": b[1]}
    b = KW.crs_work(S * (V // 2) * D).bound_ms()
    out["crs_block"] = {
        "ms": cuda_time_ms(lambda: KC.crs(planes, spec=spec), 5),
        "plain_ms": cuda_time_ms(lambda: plain_by_rows(torch, lambda p: RC.crs_ref(p, spec), planes), 1, 1),
        "library_ms": None, "bound_ms": b[0], "bound_by": b[1]}
    del planes, g
    torch.cuda.empty_cache()
    for key, t in out.items():
        extra = f"  whole read {t['whole_ms']:.4f} ms" if "whole_ms" in t else ""
        lib = "-" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        print(f"  {key:25s} kernel {t['ms']:.4f} ms{extra}  plain {t['plain_ms']:.4f} ms  library {lib} ms  "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})", flush=True)
    return out


def mesh_train_checks(tr, variants, check):
    """(c)'s numbers printed and held: the losses within MESH_LOSS_TOL of
    one process's. The weights within MESH_WEIGHT_TOL of max|w| at ideal
    ADC, and where one process stepped from the mesh's own state with its
    reads folded as the mesh folds them (``mesh_train(fold=True)``); else,
    at adc9, where an f32 sum in another order flips a DAC or ADC code,
    every crossbar leaf's gap within MESH_ADC9_OF_MOVE of its move."""
    for name, preset, fsdp, steps in variants:
        t = tr[name]
        apart = [sum(v["cells_differ"] for v in lv.values()) for lv in t["leaves"]]
        cells = sum(v["cells"] for v in t["leaves"][0].values())
        of_move = [max(v["of_update"] for v in lv.values()) for lv in t["leaves"]]
        one = "one process from the same state, its reads folded at the rank boundary" if t["fold"] else "one process"
        print(f"  (c) {name}: losses mesh {t['mesh_loss']}, {one} {t['one_loss']}; rank 0's blocks within "
              f"{[float(f'{x:.3g}') for x in t['rel']]} of max|w|, crossbar cells apart {apart} of {cells}, the "
              f"worst leaf's |gap| {[float(f'{x:.3g}') for x in of_move]} of its |move|, after each step", flush=True)
        for k in range(steps):
            tol = MESH_LOSS_TOL[k]
            check(abs(t["mesh_loss"][k] - t["one_loss"][k]) <= tol * (1 + abs(t["one_loss"][k])),
                  f"(c) {name} step {k + 1} loss {t['mesh_loss'][k]} vs {t['one_loss'][k]}")
        if preset == "ideal" or t["fold"]:
            check(max(t["rel"]) <= MESH_WEIGHT_TOL, f"(c) {name} weights beyond {MESH_WEIGHT_TOL} of max|w|")
        else:
            check(max(of_move) <= MESH_ADC9_OF_MOVE,
                  f"(c) {name}: a crossbar leaf's gap to one process beyond {MESH_ADC9_OF_MOVE} of its move")


def phase_mesh(torch, K, ref, gen):
    """Phase 20: the mesh. (b) and the block timings in this process; then
    a 2x2 world of four processes sharing the card over gloo (the backend
    rule's choice printed): (a) the sharded reads and the fold-order
    witness, (c) the mesh train steps, (e) a checkpoint across meshes, (d)
    serving; then a 1x2 world: (d) the engine. Every check's numbers are
    printed before any failing one fails the phase. Returns the kernels
    line's launches, timings and errors."""
    import tempfile

    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.launch import mesh as M

    spec = DEFAULT_SPEC
    fails = []

    def check(ok, what):
        if not ok:
            fails.append(what)

    t0 = time.perf_counter()
    cases = mesh_block_checks(torch, spec, gen)
    print(f"  (b) K1, K2 and K3 on blocks at their origin: {cases} cases bit for bit against the whole leaf "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    timings = mesh_block_timings(torch, K, ref, spec, gen)
    empty_cache(torch)
    print(f"  backend rule for {MESH_SHAPE[0] * MESH_SHAPE[1]} ranks on this host: {M.backend_for('cuda', 4)}",
          flush=True)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ranks = M.spawn(mesh_world, 4, args=(d,), timeout=MESH_TIMEOUT)
        wall = time.perf_counter() - t0
    r0 = ranks[0]
    print(f"  2x2 world: {wall:.1f} s ({r0['backend']} on {r0['device']}; reads {r0['reads_s']:.1f} s, training "
          f"{r0['train_s']:.1f} s, serving {r0['serve_s']:.1f} s; peak {max(r['peak_gib'] for r in ranks):.1f} GiB "
          "a rank)", flush=True)
    check({r["backend"] for r in ranks} == {"gloo"}, "the 2x2 world on one card must run over gloo")
    reads_err = max(r["reads_err"] for r in ranks)
    read_launches = collections.Counter()
    for r in ranks:
        read_launches.update(r["reads_launches"])
    print(f"  (a) sharded reads on the 4 tiles x 3 shard dims x 2 directions x 2 ADCs: bit for bit at adc None, "
          f"worst adc9 error {reads_err:.3g}; launches {dict(read_launches)}", flush=True)
    wit = {k: sum(r["witness"][k] for r in ranks) for k in ("cases", "differ", "outputs")}
    wit["max_rel"] = max(r["witness"]["max_rel"] for r in ranks)
    print(f"  (a) fold-order witness, adc9, weights over all 32 bits, Gaussian inputs, contraction split over "
          f"'model' ({wit['cases']} reads over the 4 ranks): each equal bit for bit to the single-process reads "
          f"of its two blocks added in f32; against the whole read {wit['differ']} of {wit['outputs']} outputs "
          f"apart, by at most {wit['max_rel']:.3g} of max", flush=True)
    train_launches = collections.Counter()
    for r in ranks:
        train_launches.update(r["train"]["launches"])
    mesh_train_checks(r0["train"], MESH_VARIANTS, check)
    steps = [r["train"]["step_ms"] for r in ranks]
    print(f"  (c) step ms by rank ({', '.join(f'{v[0]} x {v[3]}' for v in MESH_VARIANTS)}): "
          f"{[[round(x, 1) for x in s] for s in steps]}; launches over the 4 ranks {dict(train_launches)}",
          flush=True)
    # per rank and step: K4 20 reads (5 operand leaves x 2 layers, both directions), K1 10 blocks, K2 the
    # embedding's block; K3 11 blocks on each CRS step (every second); 4 ranks
    n_steps = sum(v[3] for v in MESH_VARIANTS)
    crs_steps = sum(v[3] // 2 for v in MESH_VARIANTS)
    want = {"mvm_sliced_fused": 20 * n_steps * 4, "opa_fused": 10 * n_steps * 4, "opa_dense": n_steps * 4,
            "crs": 11 * crs_steps * 4}
    check(all(train_launches[k] == n for k, n in want.items()), f"(c) launches {dict(train_launches)} != {want}")
    fs = r0["train"]["adc9_fsdp"]
    print(f"  (e) the adc9 FSDP state saved on the 2x2 mesh in {fs['ckpt_save_s']:.1f} s, restored on one process "
          f"in {fs['ckpt_restore_s']:.1f} s: equal {fs['ckpt_equal']}", flush=True)
    check(fs["ckpt_equal"], "(e) the checkpoint restored on one process differs from the mesh's state")
    sv = r0["serve"]
    serve_launches = sum(r["serve"]["launches"] for r in ranks)
    print(f"  (d) prefill 4 x 32 + 4 decode steps on the mesh, adc9 {sv['ms']:.1f} ms (one process "
          f"{sv['one_ms']:.1f} ms): adc9 logits within {sv['adc9']['max_rel']:.3g} of max|logit|, argmax equal "
          f"{sv['adc9']['argmax_equal']:.3f}; lossless within {sv['lossless']['max_rel']:.3g}, argmax equal "
          f"{sv['lossless']['argmax_equal']:.3f}; K4 launches {serve_launches}", flush=True)
    check(sv["lossless"]["max_rel"] <= MESH_SERVE_TOL, f"(d) lossless serving logits beyond {MESH_SERVE_TOL}")
    check(sv["adc9"]["finite"] and sv["adc9"]["argmax_equal"] >= MESH_ADC9_ARGMAX,
          f"(d) adc9 logits not finite, or argmax equal at fewer than {MESH_ADC9_ARGMAX} of the positions")
    t0 = time.perf_counter()
    eng = M.spawn(engine_world, 2, args=(MESH_ENGINE_REQUESTS,), timeout=MESH_TIMEOUT)
    e0 = eng[0]
    mesh_train_checks(e0["train"], MESH_MODEL_VARIANTS, check)
    model_launches = collections.Counter()
    for e in eng:
        model_launches.update(e["train"]["launches"])
    n_steps = sum(v[3] for v in MESH_MODEL_VARIANTS)
    want = {"mvm_sliced_fused": 20 * n_steps * 2, "opa_fused": 10 * n_steps * 2, "opa_dense": n_steps * 2,
            "crs": 11 * sum(v[3] // 2 for v in MESH_MODEL_VARIANTS) * 2}
    print(f"  (c) the 1x2 world's step ms by rank: {[[round(x, 1) for x in e['train']['step_ms']] for e in eng]}; "
          f"launches over the 2 ranks {dict(model_launches)}", flush=True)
    check(all(model_launches[k] == n for k, n in want.items()), f"(c) 1x2 launches {dict(model_launches)} != {want}")
    train_launches.update(model_launches)
    print(f"  (d) the engine on a 1x2 mesh, {MESH_ENGINE_REQUESTS} requests: adc9 {e0['adc9']['tokens_per_sec']:.2f} "
          f"tokens/s (wall {e0['adc9']['wall_s']:.1f} s, K4 launches {e0['adc9']['launches']} a rank), lossless "
          f"tokens equal solo for {e0['lossless_equal']} of {MESH_ENGINE_REQUESTS}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(e0["lossless_equal"] == MESH_ENGINE_REQUESTS and len({e["adc9"]["clock"] for e in eng}) == 1,
          "(d) the engine on the mesh: lossless tokens differ from solo, or the ranks' clocks")
    if fails:
        raise AssertionError("phase 20: " + "; ".join(fails))
    engine_launches = sum(e["adc9"]["launches"] + e["lossless"]["launches"] for e in eng)
    return {
        "launches": {"mvm_sliced_fused_sharded": train_launches["mvm_sliced_fused"] + serve_launches + engine_launches,
                     "mvm_sliced_sharded": read_launches["mvm_sliced"],
                     "opa_fused_block": train_launches["opa_fused"], "opa_dense_block": train_launches["opa_dense"],
                     "crs_block": train_launches["crs"]},
        "timings": timings, "reads_err": reads_err}


# ----------------------- remat and the dry run (phase 21) -----------------------

REMAT_RUNS = ("none", "none", "full", "dots")  # one state, each mode; "none" twice (repeatability)
REMAT_BATCH, REMAT_SEQ = 4, 256  # 4 x 256 tokens at gemma-2b's full width, adc9
LONG_SEQ = 4096  # train_4k's sequence length, one row
LONG_NONE_GATE_GIB = 75  # "none" at LONG_SEQ runs only where the dry run predicts a peak under this
PEAK_TOL = 0.05  # the dry run's peak against the card's, relative
REMAT_LR = 3e-2
MOE_MESH_LAYERS = 2  # granite's 24 layers cut to 2: the phase's share of the time limit
MOE_MESH_SEQ = 1024  # 2 rows of it on data 2: each rank's tokens one whole dispatch group
MOE_MESH_TIMEOUT = 600
MOE_AUX_TOL = 1e-6  # |aux_mesh - aux_one| <= MOE_AUX_TOL * |aux_one|
MOE_SERVE_ROWS, MOE_SERVE_PROMPT = 8, 16  # 4 rows a rank: 64 prompt tokens, 4 decode tokens a rank (misaligned)
MOE_SERVE_TOL = 1e-5  # |logits_mesh - logits_one| <= MOE_SERVE_TOL * max|logits_one|, argmax equal
IM2COL_ORIGIN_C = 4224  # zamba2's channels, cut in two at a channel origin


def storage_bytes(torch, *trees) -> int:
    """Bytes of the distinct storages of the tensors in ``trees``."""
    from torch.utils import _pytree as pytree

    seen = {}
    for t in pytree.tree_leaves(trees):
        if isinstance(t, torch.Tensor):
            seen[t.untyped_storage()._cdata] = t.untyped_storage().nbytes()
    return sum(seen.values())


def state_leaves(state) -> list:
    """A train state's tensors: digital leaves, then planes, in order."""
    return _leaves(state.digital) + [s.planes for s in _leaves(state.sliced)]


def card_step(torch, step, state, batch) -> tuple:
    """One step on the card: ``(new state, metrics, ms, peak bytes)``, the
    peak the step's allocations above what was allocated before it plus
    its arguments' storages (the state's and the batch's): what the dry
    run's ``peak_per_device_bytes`` counts."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    args = storage_bytes(torch, state_leaves(state), batch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    new, m = step(state, batch)
    float(m["loss"])
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return new, m, ms, torch.cuda.max_memory_allocated() - base + args


def dry_step(torch, cfg, opt_cfg, rules, remat, batch) -> dict:
    """The dry run (``launch.dryrun.measure``) of the train step the card
    runs: the same config, plan rules and mode, on meta tensors of the
    state's layout and the batch's shapes and dtypes."""
    from repro_torch.launch import dryrun as D
    from repro_torch.optim.schedules import constant
    from repro_torch.train.step import make_train_step

    step = make_train_step(cfg, opt_cfg, constant(REMAT_LR), remat=remat, plan_rules=rules)
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in batch.items()}
    return D.measure(step, D.meta_train_state(cfg, opt_cfg, None), meta)[1]


def remat_runs(torch, cfg, opt_cfg, rules, state, batch, modes, pristine=None, compare=True) -> list:
    """``modes``' steps from one state (restored from ``pristine`` before
    each but the first), each beside its dry run: ms, peak, launches by
    instance, and with ``compare`` whether loss, metrics and every leaf
    equal the first step's where the first two runs agree."""
    from repro_torch import kernels
    from repro_torch.optim.schedules import constant
    from repro_torch.train.step import make_train_step

    out, first, agree, dry_of = [], None, None, {}
    for i, mode in enumerate(modes):
        if i and pristine is not None:
            for t, p in zip(state_leaves(state), pristine):
                t.copy_(p)
        step = make_train_step(cfg, opt_cfg, constant(REMAT_LR), remat=mode, plan_rules=rules)
        kernels.reset_launch_counts()
        new, m, ms, peak = card_step(torch, step, state, batch)
        launches = kernels.launch_counts()
        t0 = time.perf_counter()
        if mode not in dry_of:  # a mode's dry run is the same step each time
            dry_of[mode] = dry_step(torch, cfg, opt_cfg, rules, mode, batch)
        dry = dry_of[mode]
        dry_s = time.perf_counter() - t0
        r = {"mode": mode, "ms": ms, "peak": peak, "max_allocated": torch.cuda.max_memory_allocated(),
             "launches": launches, "dry_peak": dry["memory"]["peak_per_device_bytes"],
             "dry_launches": dry["kernel_launches"], "dry_s": dry_s,
             "metrics": {k: float(m[k]) for k in ("loss", "aux", "grad_norm")}}
        if compare:
            if first is None:
                first = [t.clone() for t in state_leaves(new)]
            else:
                same = [torch.equal(a, b) for a, b in zip(state_leaves(new), first)]
                if agree is None:
                    agree = same  # the second "none": the leaves two runs of one mode agree on
                r["leaves_equal"] = sum(s for s, a in zip(same, agree) if a)
                r["leaves_held"] = sum(agree)
        out.append(r)
        del new, m, step
        torch.cuda.empty_cache()
    del first
    return out


def moe_mesh_cfg(arch=MOE_ARCH):
    """``arch`` (granite-moe-1b-a400m) at full width, MOE_MESH_LAYERS deep,
    in f32 (bf16 gradients summed over data shards round apart, as phase
    20's)."""
    import dataclasses

    import torch

    from repro_torch import configs

    cfg = configs.get(arch)
    return dataclasses.replace(cfg, n_layers=MOE_MESH_LAYERS, pattern=((cfg.pattern[0][0], MOE_MESH_LAYERS),),
                               dtype=torch.float32)


def moe_mesh_world(rank, arch=MOE_ARCH):
    """(c) on one rank of a (2, 1) world sharing the card over gloo
    (``arch``: granite, or another arch at the same shape to tell the MoE
    layer's share of a gap from the rest's): two ideal-ADC coverage steps
    of 2 x MOE_MESH_SEQ tokens (a rank's tokens one whole dispatch group)
    under the default ``remat="full"`` (the recompute re-runs the DAC
    range's and the aux term's all-reduces in the backward) with the
    kernels' launches counted, each against one process stepping under
    ``"none"`` from the mesh's state before it (rank 0:
    loss, aux, the weights' gap of max|w| and in grid LSB); then prefill of
    MOE_SERVE_ROWS x MOE_SERVE_PROMPT tokens and a decode step (groups a
    rank does not hold whole) on the lossless tree of the trained state,
    against one process (rank 0)."""
    import dataclasses
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs, kernels
    from repro_torch import plan as planlib
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch import mesh as M
    from repro_torch.models import lm
    from repro_torch.optim import PantherConfig, panther
    from repro_torch.optim.schedules import constant
    from repro_torch.serve import kv_pages
    from repro_torch.serve.step import make_decode_step, make_prefill
    from repro_torch.train import step as S

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    backend, dev = M.init_world("cuda")
    mesh = M.init_mesh((2, 1))
    root = dist.get_rank() == 0
    cfg = moe_mesh_cfg(arch)
    opt = PantherConfig(crs_every=2, stochastic_round=True)
    rules = planlib.coverage_rules(opt, dataclasses.replace(configs.fidelity_presets()["ideal"], spec=opt.spec))
    step = S.make_train_step(cfg, opt, constant(MESH_LR), mesh=mesh, plan_rules=rules)  # remat "full", the default
    init = lambda: S.train_state_init(cfg, opt, 0, device=dev, plan=step.plan)  # noqa: E731
    ds = SyntheticLMDataset(cfg.vocab, MOE_MESH_SEQ, 2, device=dev)
    one = S.make_train_step(cfg, opt, constant(MESH_LR), plan_rules=rules, remat="none")
    out = {"backend": backend, "losses": [], "aux": [], "ms": [], "one_losses": [], "one_aux": [], "rel": [],
           "lsb": [], "launches": collections.Counter()}
    state = S.shard_state(init(), step.specs, mesh)
    for k in range(2):
        before = S.gather_state(state, step.specs, mesh)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, ds.batch(k))
        out["losses"].append(float(m["loss"]))
        out["aux"].append(float(m["aux"]))
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["launches"].update(kernels.launch_counts())
        whole = S.gather_state(state, step.specs, mesh)
        if root:  # one process stepping from the mesh's state before this step
            ref, m1 = one(before, ds.batch(k))
            out["one_losses"].append(float(m1["loss"]))
            out["one_aux"].append(float(m1["aux"]))
            out["rel"].append(mesh_rel(torch, whole, ref, opt))
            gaps = [(word_ints(torch, a.planes) - word_ints(torch, b.planes)).abs()
                    for a, b in zip(_leaves(whole.sliced), _leaves(ref.sliced))]
            out["lsb"].append((max(int(g.max()) for g in gaps), sum(int((g > 0).sum()) for g in gaps),
                               sum(g.numel() for g in gaps)))
            out.setdefault("leaves", []).append(moe_leaf_gaps(torch, whole, ref, opt))
            del ref
        del before
    out["launches"] = dict(out["launches"])
    del state
    prompts = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab, (MOE_SERVE_ROWS, MOE_SERVE_PROMPT)),
                              device=dev)
    params = panther.materialize_split(whole.digital, whole.sliced, PantherConfig())

    def serve(m):
        prefill, decode = make_prefill(cfg, mesh=m), make_decode_step(cfg, mesh=m)
        lg, caches = prefill(params, prompts)
        caches = kv_pages.grow_caches(cfg, lm.unstack_caches(cfg, caches), MOE_SERVE_PROMPT + 1)
        _, lg2, _ = decode(params, torch.argmax(lg, dim=-1).to(torch.int32), caches, MOE_SERVE_PROMPT)
        return torch.stack([lg, lg2])

    served = serve(mesh)
    if root:
        solo = serve(None)
        out["serve_rel"] = float((served - solo).abs().max() / solo.abs().max())
        out["serve_argmax_equal"] = bool(torch.equal(served.argmax(-1), solo.argmax(-1)))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def moe_leaf_gaps(torch, a, b, opt_cfg, top=4) -> list:
    """The ``top`` leaves of two states furthest apart: (path, max |w_a -
    w_b| over the model's max|w_b|, the share of cells apart)."""
    from repro_torch import tree
    from repro_torch.core.slicing import dequantize_planes

    top_w = 0.0
    rows = []
    for (path, x), (_, y) in zip(tree.leaves_with_path(a.sliced), tree.leaves_with_path(b.sliced)):
        if x is None:
            continue
        wx = dequantize_planes(x.planes, x.frac_bits, opt_cfg.spec)
        wy = dequantize_planes(y.planes, y.frac_bits, opt_cfg.spec)
        top_w = max(top_w, float(wy.abs().max()))
        rows.append(["/".join(map(str, path)), float((wx - wy).abs().max()), float((wx != wy).float().mean())])
    for r in rows:
        r[1] /= top_w
    return sorted(rows, key=lambda r: -r[1])[:top]


def im2col_origin_check(torch, gen) -> dict:
    """(d) The im2col entry on zamba2's conv-tap block ``[S, 4, 4224]`` cut
    at channel 2112 (as FSDP cuts it at data 16 or 32): each half's launch
    at its channel origin equals the same half of the whole leaf's launch
    bit for bit, under the counter draw and half to even; the halves and
    the whole timed."""
    from repro_torch.kernels import common as KW
    from repro_torch.core import prng
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.common import Origin
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO

    spec, C, Kw = DEFAULT_SPEC, IM2COL_ORIGIN_C, 4
    planes = random_planes(torch, spec, (Kw, C), gen)
    x, dh = im2col_operands(torch, C, IM2COL_T, Kw, gen)
    frac = torch.tensor([20], dtype=torch.int32, device="cuda")
    checks = 0
    halves = ((0, C // 2), (C // 2, C))
    for key in (None, prng.PRNGKey(9)):
        whole = KO.opa_im2col(planes.clone(), x, dh, 3e-2, frac, spec=spec, key=key, layer=5)
        for c0, c1 in halves:
            got = KO.opa_im2col(planes[:, :, c0:c1].contiguous(), x[c0:c1].contiguous(), dh[c0:c1].contiguous(),
                                3e-2, frac, spec=spec, key=key, layer=5, origin=Origin(0, c0, Kw, C))
            torch.cuda.synchronize()
            if not torch.equal(got, whole[:, :, c0:c1]):
                raise AssertionError(f"(d) the im2col entry at channel origin {c0} (key {key}): "
                                     f"{int((got != whole[:, :, c0:c1]).sum())} cells differ from the whole leaf's")
            checks += 1
    key = prng.PRNGKey(9)
    parts = [(planes[:, :, a:b].contiguous(), x[a:b].contiguous(), dh[a:b].contiguous(), Origin(0, a, Kw, C))
             for a, b in halves]
    half_ms = [cuda_time_ms(lambda p=p: KO.opa_im2col(p[0], p[1], p[2], 3e-2, frac, spec=spec, key=key, layer=5,
                                                       origin=p[3]), 20) for p in parts]
    whole_ms = cuda_time_ms(lambda: KO.opa_im2col(planes, x, dh, 3e-2, frac, spec=spec, key=key, layer=5), 20)
    hp, hx, hd, ho = parts[1]  # the half at a channel origin off 0
    plain_ms = cuda_time_ms(lambda: RO.opa_im2col_ref(hp, hx, hd, 3e-2, frac[0], spec, key, 5, origin=ho), 1, 0)
    hx32, hd32 = hx.float(), hd[..., 0].float()
    lib_ms = cuda_time_ms(lambda: torch.einsum("ctk,ct->kc", hx32, hd32), 20)
    b = KW.im2col_work(C // 2, IM2COL_T, Kw, spec.n_slices).bound_ms()
    print(f"  (d) the im2col entry at a channel origin, zamba2's [{spec.n_slices}, {Kw}, {C}] block cut at "
          f"{C // 2}, {IM2COL_T} tokens: {checks} cases bit for bit against the whole leaf's launch (counter draw, "
          f"half to even); a half {half_ms[0]:.4f} / {half_ms[1]:.4f} ms, the whole {whole_ms:.4f} ms; the half at "
          f"{C // 2}: plain {plain_ms:.4f} ms, library (einsum ctk,ct->kc f32) {lib_ms:.4f} ms, bound {b[0]:.4f} ms "
          f"({b[1]})", flush=True)
    return {"checks": checks, "half_ms": half_ms, "whole_ms": whole_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b[0], "bound_by": b[1]}


def phase_remat(torch, gen):
    """Phase 21: remat and the dry run. (a) gemma-2b at full width, adc9
    (``default_rules``), REMAT_BATCH x REMAT_SEQ tokens, one state: a step
    under each of REMAT_RUNS, each beside its dry run (``launch.dryrun``,
    meta tensors): losses, metrics and every leaf equal to the first "none"
    step's wherever the two "none" runs agree; the launches by instance
    equal to the dry run's; the peaks side by side. (b) one row of LONG_SEQ
    tokens under "full", and under "none" where its dry-run peak is under
    LONG_NONE_GATE_GIB. Each dry-run peak within PEAK_TOL of the card's.
    (c) granite on a (2, 1) world sharing the card over gloo, the mesh
    stepping under "full" (``moe_mesh_world``). (d) the im2col entry at a channel
    origin (``im2col_origin_check``). Every number is printed before a
    failed check fails the phase."""
    import dataclasses

    from repro_torch import configs
    from repro_torch import plan as planlib
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch import mesh as M
    from repro_torch.optim import PantherConfig
    from repro_torch.train.step import train_state_init

    fails = []

    def check(ok, what):
        if not ok:
            fails.append(what)

    gib = lambda b: b / 2**30  # noqa: E731
    cfg = configs.get("gemma_2b")
    opt_cfg = PantherConfig(crs_every=2, stochastic_round=True)
    rules = planlib.default_rules(opt_cfg, fidelity=dataclasses.replace(configs.fidelity_presets()["adc9"],
                                                                        spec=opt_cfg.spec))
    t0 = time.perf_counter()
    state = train_state_init(cfg, opt_cfg, gen, device="cuda")
    pristine = [t.clone() for t in state_leaves(state)]
    print(f"  gemma-2b state and its copy: {time.perf_counter() - t0:.1f} s, "
          f"{gib(storage_bytes(torch, state_leaves(state))):.2f} GiB each", flush=True)
    batch = SyntheticLMDataset(cfg.vocab, REMAT_SEQ, REMAT_BATCH, device="cuda").batch(0)
    runs = remat_runs(torch, cfg, opt_cfg, rules, state, batch, REMAT_RUNS, pristine)
    for r in runs:
        gap = r["dry_peak"] / r["peak"] - 1
        print(f"  (a) {r['mode']:4s} {REMAT_BATCH} x {REMAT_SEQ}: step {r['ms']:.1f} ms, peak {gib(r['peak']):.3f} GiB "
              f"(max_memory_allocated {gib(r['max_allocated']):.3f}); dry run peak {gib(r['dry_peak']):.3f} GiB "
              f"({100 * gap:+.2f}%, {r['dry_s']:.1f} s on the host); metrics {r['metrics']}; leaves equal to the "
              f"first none step {r.get('leaves_equal', '-')} of the {r.get('leaves_held', '-')} the none runs agree "
              f"on; launches {r['launches']}", flush=True)
        check(r["launches"] == r["dry_launches"], f"(a) {r['mode']}: launches {r['launches']} != the dry run's "
                                                  f"{r['dry_launches']}")
        check(abs(gap) <= PEAK_TOL, f"(a) {r['mode']}: the dry run's peak {100 * gap:+.2f}% from the card's")
        if "leaves_equal" in r:
            same = r["metrics"] == runs[0]["metrics"] or runs[1]["metrics"] != runs[0]["metrics"]
            check(r["leaves_equal"] == r["leaves_held"] and same,
                  f"(a) {r['mode']}: not bit for bit with the first none step")
    a = {"runs": runs}
    del pristine
    torch.cuda.empty_cache()
    long_batch = SyntheticLMDataset(cfg.vocab, LONG_SEQ, 1, device="cuda").batch(0)
    predicted = {mode: dry_step(torch, cfg, opt_cfg, rules, mode, long_batch)["memory"]["peak_per_device_bytes"]
                 for mode in ("full", "none")}
    print(f"  (b) 1 x {LONG_SEQ}: the dry run's peak under full {gib(predicted['full']):.3f} GiB, under none "
          f"{gib(predicted['none']):.3f} GiB", flush=True)
    modes = ("full", "none") if gib(predicted["none"]) < LONG_NONE_GATE_GIB else ("full",)
    long_runs = remat_runs(torch, cfg, opt_cfg, rules, state, long_batch, modes, compare=False)
    for r in long_runs:
        gap = r["dry_peak"] / r["peak"] - 1
        print(f"  (b) {r['mode']:4s} 1 x {LONG_SEQ}: step {r['ms']:.1f} ms, peak {gib(r['peak']):.3f} GiB, dry run "
              f"{gib(r['dry_peak']):.3f} GiB ({100 * gap:+.2f}%); loss {r['metrics']['loss']:.6f}; launches "
              f"{r['launches']}", flush=True)
        check(math.isfinite(r["metrics"]["loss"]), f"(b) {r['mode']}: loss not finite")
        check(r["launches"] == r["dry_launches"], f"(b) {r['mode']}: launches != the dry run's")
        check(abs(gap) <= PEAK_TOL, f"(b) {r['mode']}: the dry run's peak {100 * gap:+.2f}% from the card's")
    del state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = M.spawn(moe_mesh_world, 2, timeout=MOE_MESH_TIMEOUT)
    r0 = ranks[0]
    wall = time.perf_counter() - t0
    rel_loss = max(abs(x - y) / (1 + abs(y)) for x, y in zip(r0["losses"], r0["one_losses"]))
    rel_aux = max(abs(x - y) / abs(y) for x, y in zip(r0["aux"], r0["one_aux"]))
    print(f"  (c) granite-moe-1b-a400m, {MOE_MESH_LAYERS} layers, f32, on a (2, 1) world ({r0['backend']}; "
          f"{wall:.1f} s), remat full, each step against one process (none) from the mesh's state before it: losses "
          f"{r0['losses']} "
          f"against {r0['one_losses']} ({rel_loss:.3g}); aux {r0['aux']} against {r0['one_aux']} ({rel_aux:.3g} "
          f"relative); weights {[float(f'{x:.3g}') for x in r0['rel']]} of max|w|, (largest gap in grid LSB, cells "
          f"apart, cells) {r0['lsb']}; step ms by rank {[[round(x, 1) for x in r['ms']] for r in ranks]}; launches "
          f"by rank {[r['launches'] for r in ranks]}; serving on split groups: logits {r0['serve_rel']:.3g} of max, "
          f"argmax equal {r0['serve_argmax_equal']}; peak {max(r['peak_gib'] for r in ranks):.1f} GiB a rank",
          flush=True)
    for k, leaves in enumerate(r0["leaves"]):
        print(f"  (c) step {k + 1}: the leaves furthest apart (path, of max|w|, share of cells apart): "
              f"{[(p, float(f'{g:.3g}'), float(f'{c:.3g}')) for p, g, c in leaves]}", flush=True)
    check(rel_loss <= MESH_LOSS_TOL[0], "(c) losses beyond the mesh tolerance")
    check(rel_aux <= MOE_AUX_TOL, f"(c) aux {rel_aux:.3g} apart, beyond {MOE_AUX_TOL}")
    check(max(r0["rel"]) <= MESH_WEIGHT_TOL, f"(c) weights {max(r0['rel']):.3g} of max|w| apart")
    check(all(r["launches"].get("mvm_sliced_fused/io16", 0) > 0 and r["launches"].get("opa_fused/ideal_fma", 0) > 0
              for r in ranks), "(c) a rank launched no expert read or no expert deposit")
    check(r0["serve_rel"] <= MOE_SERVE_TOL and r0["serve_argmax_equal"], "(c) serving on split groups differs")
    d = im2col_origin_check(torch, gen)
    if fails:
        raise AssertionError("phase 21: " + "; ".join(fails))
    return {"a": a, "b": long_runs, "c": ranks, "d": d}


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
        for line in ptxas_lines(built.log):
            print("    ptxas:", line)

    gen = torch.Generator(device="cuda").manual_seed(0)
    t_start = time.perf_counter()

    def done(what):
        print(f"[{time.perf_counter() - t_start:7.1f} s] {what} done", flush=True)

    max_err, timings = phase_kernels(torch, K, ref, fp, DEFAULT_SPEC, gen)
    done("phase 2: K4 checks")
    serving = phase_slice(torch, K, gen)
    torch.cuda.empty_cache()
    done("phase 3: serving")
    engine = phase_engine(torch, K, gen)
    done("phase 15: the serving engine")
    isa_clock = phase_isa_clock(torch, K, ref, engine.pop("state"))
    torch.cuda.empty_cache()
    done("phase 16: the crossbar-cycle clock and the ISA pipeline")
    phase_update_kernels(torch, DEFAULT_SPEC, gen)
    phase_dense_kernels(torch, DEFAULT_SPEC, gen)
    deposit_launches = drive_deposit_entry(torch, DEFAULT_SPEC, gen)
    opa_err = phase_opa_fused(torch, DEFAULT_SPEC, gen)
    t_err = phase_transpose(torch, K, ref, fp, DEFAULT_SPEC, gen)
    train_timings = time_update_kernels(torch, K, ref, DEFAULT_SPEC, gen)
    train_timings.update(time_crs(torch, DEFAULT_SPEC, gen))
    train_timings.update(time_dense_kernels(torch, DEFAULT_SPEC, gen))
    done("phase 4: update kernels and K4ᵀ")
    dev_err = phase_device_kernels(torch, DEFAULT_SPEC, gen)
    dense_err = phase_dense_device_kernels(torch, DEFAULT_SPEC, gen)
    train_timings.update(time_device_kernels(torch, DEFAULT_SPEC, gen))
    done("phase 6: device, io 8/12 and K5 kernels")
    dense = collections.Counter()  # the dense write's launches on the main path, by instance
    train_launches, state, ds, blocks, phase5 = phase_train(torch, gen, dense)
    train_launches.update(deposit_launches)
    done("phase 5: training")
    dev_launches, state = phase_device_train(torch, state, ds, blocks, gen, dense)
    train_launches.update(dev_launches)
    done("phase 7: training on the non-ideal device and at io 8/12")
    train_launches.update(phase_k5_path(torch, state))
    done("phase 8: K5 entry point")
    train_launches.update(phase_f32_update(torch, state))
    done("phase 9: f32-operand update")
    rng_err = phase_rng_kernels(torch, DEFAULT_SPEC, gen)
    train_timings.update(time_rng_kernels(torch, DEFAULT_SPEC, gen))
    rng_launches, state = phase_rng_train(torch, state, ds, blocks, dense)
    train_launches.update(rng_launches)
    done("phase 10: K1 rounding sources")
    mb_launches, mb_timings, mb_err, state = phase_microbatch(torch, state, phase5, gen, dense)
    train_launches.update(mb_launches)
    train_timings.update(mb_timings)
    del state
    torch.cuda.empty_cache()
    done("phase 12: microbatches and the stash rule")
    mlp_launches, mlp_timings, mlp_err = phase_mlp(torch, gen)
    train_launches.update(mlp_launches)
    train_timings.update(mlp_timings)
    done("phase 11: the paper MLP")
    phase_checkpoint(torch)
    done("phase 13: checkpoints at full width")
    f10_launches, f10_timings, f10_err = phase_fig10(torch, gen)
    train_launches.update(f10_launches)
    train_timings.update(f10_timings)
    done("phase 14: Fig 10")
    moe_launches, moe_timings = phase_moe(torch, K, gen)
    train_launches.update(moe_launches)
    train_timings.update(moe_timings)
    done("phase 17: the MoE family (granite-moe-1b-a400m at full width)")
    ssm_launches, ssm_timings = phase_ssm(torch, K, gen)
    train_launches.update(ssm_launches)
    train_timings.update(ssm_timings)
    done("phase 18: the SSM family (xlstm-125m and zamba2-1.2b at full width)")
    new_launches, new_timings = phase_new_archs(torch, K, gen)
    train_launches.update(new_launches)
    train_timings.update(new_timings)
    done("phase 19: gemma2-9b and deepseek-v2-lite-16b at full width")
    mesh = phase_mesh(torch, K, ref, gen)
    train_launches.update(mesh["launches"])
    train_timings.update(mesh["timings"])
    done("phase 20: the mesh")
    phase_remat(torch, gen)
    done("phase 21: remat and the dry run")
    train_launches.update({"opa_dense_" + inst: n for inst, n in dense.items()})
    print(f"K2's dense write, launches by instance over the main-path runs: {dict(dense)}", flush=True)

    # one layer's five reads: "mvm_sliced_fused" at the decode batch's 4
    # tokens on the decode body (the entry's meaning since the port began:
    # the main path's per-layer decode work), "mvm_sliced_fused_prefill" at
    # the prefill's 128 on the tensor-core body, each beside the other bodies
    # on the same work and with the launches of its own body
    def serving_entry(name, B, body, extra):
        t = layer_timings(timings, B)
        return {"name": name, "route": "cuda", "source": "src/repro_torch/kernels/sliced_mvm/csrc/mvm_sliced_fused.cu",
                "replaces": "src/repro/kernels/sliced_mvm/kernel.py:367",
                "launches": serving[K.instance_name(False, 16, body=body)], "max_abs_err": max_err,
                **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "dp4a_ms", *extra)}}

    def entry(name, source, replaces, max_abs_err):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": train_launches[name], "max_abs_err": max_abs_err, **train_timings[name]}

    line = {"kernels": [
        serving_entry("mvm_sliced_fused", 4, K.body_for(4, False), ("mma_ms",)),
        serving_entry("mvm_sliced_fused_prefill", 128, K.body_for(128, False), ()),
        # the engine's 8-slot decode round on the tensor-core body (phase 15;
        # its launches: every 8-token read there, rounds and 8-token prefills)
        {**serving_entry("mvm_sliced_fused_round", 8, K.body_for(8, False), ("mma_ms", "decode_ms")),
         "launches": engine["round_launches"]},
        # the engine on the crossbar clock (phase 16 (a)): every K4 launch
        # of its two policies; the time fields are the 8-token entry's above
        # (the same read, timed in phase 2 of this run), the error (d)'s
        {**serving_entry("mvm_sliced_fused_isa_clock", 8, K.body_for(8, False), ("mma_ms", "decode_ms")),
         "launches": isa_clock["launches"], "max_abs_err": isa_clock["max_abs_err"]},
        entry("mvm_sliced_fused_transpose", "src/repro_torch/kernels/sliced_mvm/csrc/mvm_sliced_fused.cu",
              "src/repro/kernels/sliced_mvm/kernel.py:367", t_err),
        entry("opa_fused", "src/repro_torch/kernels/sliced_opa/csrc/opa_fused.cu",
              "src/repro/kernels/sliced_opa/kernel.py:255", float(opa_err["mma"])),
        entry("opa_fused_fma", "src/repro_torch/kernels/sliced_opa/csrc/opa_fused.cu",
              "src/repro/kernels/sliced_opa/kernel.py:255", float(opa_err["fma"])),
        entry("opa_deposit", "src/repro_torch/kernels/sliced_opa/csrc/opa_deposit.cu",
              "src/repro/kernels/sliced_opa/kernel.py:90", 0.0),
        entry("crs", "src/repro_torch/kernels/crs/csrc/crs.cu", "src/repro/kernels/crs/kernel.py:70", 0.0),
        # the embedding's block alone: one of the K3 launches of every CRS step
        entry("crs_embedding", "src/repro_torch/kernels/crs/csrc/crs.cu", "src/repro/kernels/crs/kernel.py:70", 0.0),
        entry("opa_fused_device", "src/repro_torch/kernels/sliced_opa/csrc/opa_fused.cu",
              "src/repro/kernels/sliced_opa/kernel.py:255", dev_err["opa_fused_device"]),
        entry("opa_fused_device_fma", "src/repro_torch/kernels/sliced_opa/csrc/opa_fused.cu",
              "src/repro/kernels/sliced_opa/kernel.py:255", dev_err["opa_fused_device_fma"]),
        entry("opa_deposit_stuck", "src/repro_torch/kernels/sliced_opa/csrc/opa_deposit.cu",
              "src/repro/kernels/sliced_opa/kernel.py:90", dev_err["opa_deposit_stuck"]),
        # K2's dense write on the embedding, every instance: f32 and bf16 gradients, ideal and device
        # (the flips of the write noise's last bit counted in phase 6)
        *(entry(dense_entry(torch, dt, draw, d), "src/repro_torch/kernels/sliced_opa/csrc/opa_deposit.cu",
                "src/repro/kernels/sliced_opa/kernel.py:90", dense_err.get(dense_entry(torch, dt, draw, d), 0.0))
          for dt in (torch.float32, torch.bfloat16) for d in (False, True) for draw in DENSE_DRAWS),
        *(entry(f"mvm_sliced_fused{t}_{v}", "src/repro_torch/kernels/sliced_mvm/csrc/mvm_sliced_fused.cu",
                "src/repro/kernels/sliced_mvm/kernel.py:367", dev_err[f"mvm_sliced_fused{t}_{v}"])
          for v in ("read_noise", "io8", "io12") for t in ("", "_transpose")),
        # K5 on the tensor-core body (its dp4a instance's time beside it), one
        # entry a width, each named with the instance it launched in phase 8
        *({**entry(f"mvm_sliced{t}{v}", "src/repro_torch/kernels/sliced_mvm/csrc/mvm_sliced_fused.cu",
                   "src/repro/kernels/sliced_mvm/kernel.py:233", dev_err[f"mvm_sliced{t}"]),
           "instance": K.instance_name(t == "_transpose", int(v[3:]) if v else 16)}
          for t in ("", "_transpose") for v in ("", "_io8", "_io12")),
        *(entry(rng_entry(mode, d, body), "src/repro_torch/kernels/sliced_opa/csrc/opa_fused.cu",
                "src/repro/kernels/sliced_opa/kernel.py:255", rng_err[rng_entry(mode, d, body)])
          for mode in ("grid", "hw") for d in (False, True) for body in ("mma", "fma")),
        # K1 at the microbatched step's 1024 tokens (phase 12)
        entry("opa_fused_microbatch", "src/repro_torch/kernels/sliced_opa/csrc/opa_fused.cu",
              "src/repro/kernels/sliced_opa/kernel.py:255", float(mb_err)),
        # the paper MLP's kernels at its shapes, launches over phase 11 (the int32 deposit's: phase 4's entry point)
        entry("opa_dense_mlp", "src/repro_torch/kernels/sliced_opa/csrc/opa_deposit.cu",
              "src/repro/kernels/sliced_opa/kernel.py:90", 0.0),
        entry("opa_deposit_mlp", "src/repro_torch/kernels/sliced_opa/csrc/opa_deposit.cu",
              "src/repro/kernels/sliced_opa/kernel.py:90", 0.0),
        entry("crs_mlp", "src/repro_torch/kernels/crs/csrc/crs.cu", "src/repro/kernels/crs/kernel.py:70", 0.0),
        entry("mvm_sliced_fused_mlp", "src/repro_torch/kernels/sliced_mvm/csrc/mvm_sliced_fused.cu",
              "src/repro/kernels/sliced_mvm/kernel.py:367", mlp_err),
        # the heterogeneous model's group 0 at 66666666, full width (phase 14): K1 half to even, K4 and K4ᵀ at adc9
        entry("opa_fused_uniform6", "src/repro_torch/kernels/sliced_opa/csrc/opa_fused.cu",
              "src/repro/kernels/sliced_opa/kernel.py:255", float(f10_err["opa_fused_uniform6"])),
        entry("mvm_sliced_fused_uniform6", "src/repro_torch/kernels/sliced_mvm/csrc/mvm_sliced_fused.cu",
              "src/repro/kernels/sliced_mvm/kernel.py:367", f10_err["mvm_sliced_fused_uniform6"]),
        # granite-moe-1b-a400m (phase 17): one layer's 96 expert reads at the
        # training capacity (80 rows) forward and MᵀVM, and at decode (8
        # rows); K1 on one layer's 96 expert tiles at 80 tokens; K2 over one
        # dense expert bank (24 x 32 blocks). Launches: the phase's runs.
        *(entry(name, "src/repro_torch/kernels/sliced_mvm/csrc/mvm_sliced_fused.cu",
                "src/repro/kernels/sliced_mvm/kernel.py:367", 0.0)
          for name in ("mvm_sliced_fused_expert", "mvm_sliced_fused_expert_transpose",
                       "mvm_sliced_fused_expert_decode")),
        entry("opa_fused_expert", "src/repro_torch/kernels/sliced_opa/csrc/opa_fused.cu",
              "src/repro/kernels/sliced_opa/kernel.py:255", 0.0),
        entry("opa_dense_expert", "src/repro_torch/kernels/sliced_opa/csrc/opa_deposit.cu",
              "src/repro/kernels/sliced_opa/kernel.py:90", 0.0),
        # the SSM family (phase 18): the im2col entry on one conv-tap block
        # at xlstm's C 1536 and zamba2's 4224 (256 tokens; "tile_ms": the
        # per-tile K1 launches on the same block), K3 on xlstm's conv block,
        # K4 and K4ᵀ on the narrow tiles w_if 1536x8 and w_B 2048x64 at
        # adc9. Launches: the phase's runs.
        *(entry(name, "src/repro_torch/kernels/sliced_opa/csrc/opa_im2col.cu",
                "src/repro/kernels/sliced_opa/kernel.py:255", 0.0) for name in ("opa_im2col", "opa_im2col_zamba")),
        entry("crs_conv", "src/repro_torch/kernels/crs/csrc/crs.cu", "src/repro/kernels/crs/kernel.py:70", 0.0),
        *(entry(f"mvm_sliced_fused_{r}{t}", "src/repro_torch/kernels/sliced_mvm/csrc/mvm_sliced_fused.cu",
                "src/repro/kernels/sliced_mvm/kernel.py:367", 0.0)
          for r, *_ in NARROW_READS for t in ("", "_transpose")),
        # gemma2-9b and deepseek-v2-lite-16b (phase 19): K4 forward and MᵀVM
        # and K1 over one gemma2 layer's five tiles and on deepseek's wq_dkv
        # 2048x3648 (ragged) at 256 rows; K4 on w_uk + w_uv at a decode
        # step's 4 x 48 cache rows; deepseek's 64 x 3 expert tiles as
        # granite's (30 rows in training, 6 at decode). Launches: the phase's runs.
        *(entry(name, "src/repro_torch/kernels/sliced_mvm/csrc/mvm_sliced_fused.cu",
                "src/repro/kernels/sliced_mvm/kernel.py:367", 0.0)
          for name in ("mvm_sliced_fused_gemma2", "mvm_sliced_fused_gemma2_transpose", "mvm_sliced_fused_wq_dkv",
                       "mvm_sliced_fused_wq_dkv_transpose", "mvm_sliced_fused_mla_up", "mvm_sliced_fused_expert64",
                       "mvm_sliced_fused_expert64_transpose", "mvm_sliced_fused_expert64_decode")),
        *(entry(name, "src/repro_torch/kernels/sliced_opa/csrc/opa_fused.cu",
                "src/repro/kernels/sliced_opa/kernel.py:255", 0.0)
          for name in ("opa_fused_gemma2", "opa_fused_wq_dkv", "opa_fused_expert64")),
        entry("opa_dense_expert64", "src/repro_torch/kernels/sliced_opa/csrc/opa_deposit.cu",
              "src/repro/kernels/sliced_opa/kernel.py:90", 0.0),
        # the mesh (phase 20): a rank's K4 and K5 on its tile block (wi_gate's column block, 256 tokens;
        # "whole_ms" the whole read), K1 on that block at its origin, K2 and K3 on the embedding's row
        # block. Launches: the 2x2 world's training steps, serving and the 1x2 engine (K4); the sharded
        # K5 reads of (a), the unfused entry's only path besides phase 8 (K5); the training steps (K1-K3)
        entry("mvm_sliced_fused_sharded", "src/repro_torch/kernels/sliced_mvm/csrc/mvm_sliced_fused.cu",
              "src/repro/kernels/sliced_mvm/kernel.py:367", mesh["reads_err"]),
        entry("mvm_sliced_sharded", "src/repro_torch/kernels/sliced_mvm/csrc/mvm_sliced_fused.cu",
              "src/repro/kernels/sliced_mvm/kernel.py:233", mesh["reads_err"]),
        entry("opa_fused_block", "src/repro_torch/kernels/sliced_opa/csrc/opa_fused.cu",
              "src/repro/kernels/sliced_opa/kernel.py:255", 0.0),
        entry("opa_dense_block", "src/repro_torch/kernels/sliced_opa/csrc/opa_deposit.cu",
              "src/repro/kernels/sliced_opa/kernel.py:90", 0.0),
        entry("crs_block", "src/repro_torch/kernels/crs/csrc/crs.cu", "src/repro/kernels/crs/kernel.py:70", 0.0),
    ]}
    unlaunched = [e["name"] for e in line["kernels"] if e["launches"] <= 0]
    if unlaunched:
        raise AssertionError(f"kernels-line entries with no launch on their path: {unlaunched}")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
