"""Worker functions of the mesh tests: each runs on one rank of a gloo world
on the CPU (``launch.mesh.spawn``), imports the port only (no JAX), and
returns plain numbers for the test process to check. Not a test file: the
``test_torch_distributed*.py`` files start each world once and read its
results."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

SMOKE = "gemma-2b"
LR = 1e-2
STEPS = 2


def _world(shape):
    from repro_torch.launch import mesh as M

    M.init_world("cpu", verbose=False)
    return M.init_mesh(shape)


def _weights(state, opt_cfg):
    from repro_torch import tree
    from repro_torch.optim import panther

    params = panther.materialize_split(state.digital, state.sliced, opt_cfg)
    return {tuple(p): w.detach().float() for p, w in tree.leaves_with_path(params) if w is not None}


def _rel(a, b, opt_cfg) -> float:
    """max|w_a - w_b| over every leaf of the dequantized weights, relative to
    the largest |w_b| of the model."""
    wa, wb = _weights(a, opt_cfg), _weights(b, opt_cfg)
    top = max(float(w.abs().max()) for w in wb.values())
    return max(float((wa[p] - wb[p]).abs().max()) for p in wb) / top


def _step_variants(cfg, opt_cfg, mesh, variants, batch_size=4, seq=16):
    """Each (name, fidelity preset or None, fsdp) variant, from the seed-0
    state: ``STEPS`` mesh steps and, on rank 0, the same steps on one
    process; and each mesh step again on one process from the mesh's own
    state before it. Returns rank 0's per-variant losses, grad norms and
    weight differences (``_rel``): ``free`` the two runs apart, ``same`` a
    mesh step against the one-process step from the same state."""
    from repro_torch import configs, plan as planlib
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.optim.schedules import constant
    from repro_torch.train import step as S

    ds = SyntheticLMDataset(cfg.vocab, seq, batch_size, device="cpu")
    root = all(v == 0 for v in mesh.coordinate.values())
    out = {}
    for name, preset, fsdp in variants:
        rules = None
        if preset is not None:
            fid = dataclasses.replace(configs.fidelity_presets()[preset], spec=opt_cfg.spec)
            rules = planlib.default_rules(opt_cfg, fidelity=fid)
        step = S.make_train_step(cfg, opt_cfg, constant(LR), mesh=mesh, fsdp=fsdp, plan_rules=rules, remat="none")
        one = S.make_train_step(cfg, opt_cfg, constant(LR), plan_rules=rules, remat="none")
        state = S.shard_state(S.train_state_init(cfg, opt_cfg, 0, device="cpu"), step.specs, mesh)
        ref = S.train_state_init(cfg, opt_cfg, 0, device="cpu") if root else None
        res = {k: [] for k in ("mesh_loss", "single_loss", "same_loss", "mesh_gnorm", "single_gnorm", "free_rel",
                               "same_rel")}
        for k in range(STEPS):
            before = S.gather_state(state, step.specs, mesh)
            state, m = step(state, ds.batch(k))
            got = S.gather_state(state, step.specs, mesh)
            res["mesh_loss"].append(float(m["loss"]))
            res["mesh_gnorm"].append(float(m["grad_norm"]))
            if root:
                ref, m1 = one(ref, ds.batch(k))
                same, m2 = one(before, ds.batch(k))
                res["single_loss"].append(float(m1["loss"]))
                res["single_gnorm"].append(float(m1["grad_norm"]))
                res["same_loss"].append(float(m2["loss"]))
                res["free_rel"].append(_rel(got, ref, opt_cfg))
                res["same_rel"].append(_rel(got, same, opt_cfg))
        out[name] = res
    return out





# ------------------------------- reads and blocks -------------------------------

READ_M = READ_N = 512  # 4-way model shards hold exactly one 128-row tile each
READ_DEVICE = dict(read_noise=0.01, stuck_seed=5)
UPDATE_DEVICE = dict(write_noise=4e6, asym_up=1.2, asym_down=0.8, stuck_frac=0.1, stuck_seed=3)


def _read_checks(mesh):
    """mvm_sliced_sharded at every shard_dim, both directions, against the
    single-process read of this rank's token rows (a shard over 'data'):
    unfused (K5's plain version) on int x_q and fused (K4's, float x and
    the global DAC exponent), with and without read noise. Returns ``(worst
    |diff| of the unfused reads at adc_bits=None, worst |diff| / max|read|
    of the others)``."""
    from repro_torch.core import DEFAULT_SPEC, slice_weights
    from repro_torch.core.fixed_point import choose_frac_bits
    from repro_torch.distributed import blocks
    from repro_torch.kernels.sliced_mvm import (mvm_sliced_batched, mvm_sliced_fused_batched,
                                                mvm_sliced_sharded)
    from repro_torch.models.common import DeviceModel

    g = torch.Generator().manual_seed(0)
    q = torch.randint(-256, 257, (READ_M, READ_N), generator=g, dtype=torch.int32)
    planes = slice_weights(q, DEFAULT_SPEC)
    dp = tuple(a for a in ("data",) if mesh.shape[a] > 1)
    rows = blocks.block_slices((dp if dp else None,), (8,), mesh)[0]
    exact, close = 0.0, 0.0
    for transpose in (False, True):
        contract = READ_N if transpose else READ_M
        xi = torch.randint(-100, 101, (8, contract), generator=g, dtype=torch.int32)
        xf = torch.randn((8, contract), generator=g)
        frac = choose_frac_bits(xf, word_bits=16, margin_bits=1, clip_to_word=False)
        for sd in (None, 0, 1):
            spec = (None, None, None) if sd is None else (None, "model", None) if sd == 0 else (None, None, "model")
            local = blocks.local_block(planes, spec, mesh)
            for adc in (None, 9):
                kw = dict(mesh=mesh, data_axes=dp, model_axis="model", shard_dim=sd, adc_bits=adc,
                          transpose=transpose)
                want = mvm_sliced_batched(planes, xi, DEFAULT_SPEC, adc_bits=adc, transpose=transpose)[rows]
                got = mvm_sliced_sharded(local, xi[rows], DEFAULT_SPEC, **kw)
                if adc is None:
                    exact = max(exact, float((got - want).abs().max()))
                else:
                    close = max(close, float((got - want).abs().max() / want.abs().max()))
                for dev in (None, DeviceModel(**READ_DEVICE)):
                    want = mvm_sliced_fused_batched(planes, xf, frac, DEFAULT_SPEC, adc_bits=adc,
                                                    transpose=transpose, device=dev)[rows]
                    got = mvm_sliced_sharded(local, xf[rows], DEFAULT_SPEC, frac_bits=frac, device=dev, **kw)
                    close = max(close, float((got - want).abs().max() / want.abs().max()))
    return exact, close


def _collective_checks(mesh):
    """tile_psum exact; compressed_psum within 2e-3 of the f32 sum (relative
    to its max), stochastic and half to even."""
    from repro_torch.core import prng
    from repro_torch.distributed import collectives as col

    axes = mesh.axis_names
    n = mesh.size
    i = mesh.index(axes)
    g = torch.Generator().manual_seed(100 + i)
    part = torch.randint(-2**20, 2**20, (64, 33), generator=g).to(torch.float32)
    parts = [torch.randint(-2**20, 2**20, (64, 33), generator=torch.Generator().manual_seed(100 + k)).to(torch.float32)
             for k in range(n)]
    want = sum(parts)
    exact = bool(torch.equal(col.tile_psum(part.clone(), mesh, axes), want))
    grads = [torch.randn((256,), generator=torch.Generator().manual_seed(200 + k)) for k in range(n)]
    grad = grads[i]
    total = sum(grads)
    errs = []
    for key in (None, prng.fold_in(prng.PRNGKey(3), i)):
        got = col.compressed_psum(grad, mesh, axes, key=key)
        errs.append(float((got - total).abs().max() / total.abs().max()))
    return exact, max(errs)


def _block_update_checks(mesh):
    """K1's, K2's and K3's plain versions on this rank's block of a stacked
    leaf at its origin (2-D split of rows and columns over the mesh's two
    axes, a layer block of the stack too), bit for bit against the same
    block of the whole-leaf update: counter, grid and hw draws, ideal and
    device physics. Returns the number of cases and of mismatches."""
    from repro_torch.core import DEFAULT_SPEC, prng
    from repro_torch.core.fixed_point import WRITE_NOISE_FOLD
    from repro_torch.distributed import blocks
    from repro_torch.kernels.common import Origin
    from repro_torch.kernels.crs import ref as crs_ref
    from repro_torch.kernels.sliced_opa import ops, ref
    from repro_torch.models.common import DeviceModel
    from repro_torch.train.step import block_origin

    S = DEFAULT_SPEC.n_slices
    L, M, N, T = 2, 256, 512, 9
    g = torch.Generator().manual_seed(7)
    whole = torch.randint(-7, 8, (L, S, M, N), generator=g, dtype=torch.int8).movedim(1, 0)
    x = torch.randn((L, T, M), generator=g)
    dh = torch.randn((L, T, N), generator=g) * 1e-2
    gr = torch.randn((L, M, N), generator=g) * 1e-2
    spec = ("data", None, "model") if mesh.shape["data"] > 1 else (None, "model", None)
    sl = blocks.block_slices(spec, (L, M, N), mesh)
    origin = block_origin(spec, (L, M, N), mesh) or Origin(0, 0, M, N)
    key = prng.PRNGKey(11)
    cases = bad = 0
    for dev in (None, DeviceModel(**UPDATE_DEVICE)):
        for mode in ("counter", "grid", "hw"):
            want = whole.clone()
            block = blocks.layer_major(whole[(slice(None), *sl)])
            if mode == "hw":  # the hw draw's plain stream, layer by layer (its entry point runs on the card)
                for l in range(L):
                    kw = ref.layer_key_words(key, l, True)
                    nw = ref.layer_key_words(prng.fold_in(key, WRITE_NOISE_FOLD) if dev is not None else None, l, True)
                    want[:, l] = ref.opa_fused_ref(want[:, l], x[l], dh[l], 3e-2, 20, DEFAULT_SPEC, kw, dev, nw,
                                                   rng_mode="hw")
                for j, l in enumerate(range(sl[0].start, sl[0].stop)):
                    kw = ref.layer_key_words(key, l, True)
                    nw = ref.layer_key_words(prng.fold_in(key, WRITE_NOISE_FOLD) if dev is not None else None, l, True)
                    block[:, j] = ref.opa_fused_ref(block[:, j], x[l][:, sl[1]], dh[l][:, sl[2]], 3e-2, 20,
                                                    DEFAULT_SPEC, kw, dev, nw, rng_mode="hw", origin=origin)
            else:
                ops.opa_fused_update(want, x, dh, 3e-2, 20, DEFAULT_SPEC, stochastic=True, key=key, rng_mode=mode,
                                     device=dev)
                ops.opa_fused_update(block, x[sl[0]][:, :, sl[1]], dh[sl[0]][:, :, sl[2]], 3e-2, 20, DEFAULT_SPEC,
                                     stochastic=True, key=key, rng_mode=mode, device=dev, origin=origin)
            cases += 1
            bad += int(not torch.equal(block, want[(slice(None), *sl)]))
            if mode != "hw":  # K2: the dense write has no hw draw
                want = whole.clone()
                block = blocks.layer_major(whole[(slice(None), *sl)])
                ops.opa_dense_update(want, gr, 3e-2, 20, DEFAULT_SPEC, stochastic=True, key=key, rng_mode=mode,
                                     device=dev)
                ops.opa_dense_update(block, gr[sl], 3e-2, 20, DEFAULT_SPEC, stochastic=True, key=key, rng_mode=mode,
                                     device=dev, origin=origin)
                cases += 1
                bad += int(not torch.equal(block, want[(slice(None), *sl)]))
    # K3: CRS per cell on the block
    cases += 1
    bad += int(not torch.equal(crs_ref.crs_ref(blocks.layer_major(whole[(slice(None), *sl)]), DEFAULT_SPEC),
                               crs_ref.crs_ref(whole, DEFAULT_SPEC)[(slice(None), *sl)]))
    return cases, bad


def reads_world(rank, shapes):
    """On each mesh shape of the world (2x2, 1x4, 4x1 on four ranks): the
    read, collective and update-block checks; rank 0's results."""
    from repro_torch.launch import mesh as M

    M.init_world("cpu", verbose=False)
    out = {}
    for shape in shapes:
        mesh = M.init_mesh(shape)
        r = {"reads": _read_checks(mesh), "collectives": _collective_checks(mesh),
             "blocks": _block_update_checks(mesh)}
        out[shape] = _all_ranks(r, mesh)
    return out


def _all_ranks(result, mesh):
    """Every rank's result, gathered to each (a list in rank order)."""
    import torch.distributed as dist

    got = [None] * mesh.size
    dist.all_gather_object(got, result)
    return got


# ----------------------------------- serving -----------------------------------

SERVE_TRACE = dict(seed=3, n_requests=3, rate=1e4, prompt_lens=(4, 6, 9), out_choices=((3, 0.5), (5, 0.5)))
ENGINE_GRID = dict(n_slots=2, max_seq=24, page=4, chunk_size=4)


def serving_setup(mesh, device="cpu"):
    """gemma-2b SMOKE in f32 from seed 0: its dense params, the adc9 plan and
    the wraps served on one process and on ``mesh`` (this rank's tile
    blocks)."""
    from repro_torch import configs, plan as planlib
    from repro_torch.optim import PantherConfig, panther
    from repro_torch.serve.step import fidelity_params
    from repro_torch.train import step as S

    cfg = dataclasses.replace(configs.get_smoke(SMOKE), dtype=torch.float32)
    opt = PantherConfig()
    state = S.train_state_init(cfg, opt, 0, device=device)
    params = panther.materialize_split(state.digital, state.sliced, opt)
    fid = dataclasses.replace(configs.fidelity_presets()["adc9"], spec=opt.spec)
    plan = planlib.resolve_plan(S.param_shapes(state.digital, state.sliced), planlib.default_rules(opt, fidelity=fid))
    specs = S.storage_specs(cfg, opt, mesh, plan=plan)
    local = S.shard_state(state, specs, mesh)
    return cfg, params, fidelity_params(params, state.sliced, plan), \
        fidelity_params(params, local.sliced, plan, mesh=mesh, specs=specs.sliced)


def solo_tokens(cfg, params, prompt, out_len) -> list:
    """Greedy tokens of one request served alone (dense caches)."""
    from repro_torch.models import lm
    from repro_torch.serve import kv_pages

    L = len(prompt)
    with torch.no_grad():
        logits, caches = lm.prefill(cfg, params, torch.as_tensor(np.asarray(prompt, np.int64))[None])
        caches = kv_pages.grow_caches(cfg, lm.unstack_caches(cfg, caches), L + out_len)
        tok = torch.argmax(logits, dim=-1)
        out = [int(tok[0])]
        for i in range(out_len - 1):
            logits, caches = lm.decode_step(cfg, params, tok, caches, L + i)
            tok = torch.argmax(logits, dim=-1)
            out.append(int(tok[0]))
    return out


def engine_tokens(cfg, params, mesh, costs=None) -> dict:
    """rid -> tokens of the engine (on ``mesh``, or one process) over the
    test trace under ``continuous``."""
    from repro_torch.serve import scheduler as sch
    from repro_torch.serve import trace as tr
    from repro_torch.serve.engine import Engine

    eng = Engine(cfg, params, mesh=mesh, costs=costs, device="cpu", **ENGINE_GRID)
    res = sch.run_trace({"default": eng}, tr.synth_trace(vocab=cfg.vocab, **SERVE_TRACE), policy="continuous")
    return {r.rid: list(r.tokens) for r in res["requests"]}, res["clock"]


def serve_world(rank, shape):
    """Prefill and decode on ``shape`` against one process (lossless tokens
    and logits, adc9 logits), and the engine on the mesh (lossless tokens
    against solo serving; adc9 tokens against the one-process engine on the
    same costs); rank 0's results, every rank's clock."""
    from repro_torch.serve import scheduler as sch
    from repro_torch.serve import trace as tr
    from repro_torch.serve.step import make_decode_step, make_prefill

    mesh = _world(shape)
    cfg, params, served_one, served_mesh = serving_setup(mesh)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 7)))
    out = {}
    for name, p_one, p_mesh in (("lossless", params, params), ("adc9", served_one, served_mesh)):
        logits = {}
        for key, p, m in (("one", p_one, None), ("mesh", p_mesh, mesh)):
            prefill, decode = make_prefill(cfg, mesh=m), make_decode_step(cfg, mesh=m)
            lg, caches = prefill(p, prompts)
            from repro_torch.models import lm
            from repro_torch.serve import kv_pages
            caches = kv_pages.grow_caches(cfg, lm.unstack_caches(cfg, caches), 7 + 4)
            seq, tok = [lg], torch.argmax(lg, dim=-1)
            for i in range(3):
                tok, lg, caches = decode(p, tok, caches, 7 + i)
                seq.append(lg)
            logits[key] = torch.stack(seq)
        out[name] = {"max_rel": float((logits["mesh"] - logits["one"]).abs().max() / logits["one"].abs().max()),
                     "tokens_equal": bool(torch.equal(logits["mesh"].argmax(-1), logits["one"].argmax(-1)))}
    trace = tr.synth_trace(vocab=cfg.vocab, **SERVE_TRACE)
    got, clock = engine_tokens(cfg, params, mesh)  # calibrated, rank 0's costs broadcast
    out["engine_lossless"] = {"equal_solo": all(got[r.rid] == solo_tokens(cfg, params, r.tokens, r.out_len)
                                                for r in trace)}
    costs = sch.IsaClock(1e-3, ENGINE_GRID["n_slots"])
    got, _ = engine_tokens(cfg, served_mesh, mesh, costs)
    want, _ = engine_tokens(cfg, served_one, None, costs)
    out["engine_adc9"] = {"equal_one": got == want}
    out["clocks"] = _all_ranks(clock, mesh)
    return out


# --------------------------------- checkpoints ---------------------------------


def _same_state(a, b) -> bool:
    from repro_torch import tree

    for (_, x), (_, y) in zip(tree.leaves_sorted(a.digital), tree.leaves_sorted(b.digital)):
        if (x is None) != (y is None) or x is not None and not torch.equal(x, y):
            return False
    for (_, x), (_, y) in zip(tree.leaves_sorted(a.sliced), tree.leaves_sorted(b.sliced)):
        if (x is None) != (y is None) or x is not None and not (torch.equal(x.planes, y.planes)
                                                                  and torch.equal(x.frac_bits, y.frac_bits)):
            return False
    return a.step == b.step and tuple(a.rng) == tuple(b.rng)


def _ckpt_checks(cfg, opt_cfg, mesh, directory):
    """(a) saved on the mesh after a mesh step, resumed on one process for
    the next step; (b) saved on one process after a step, resumed on the
    mesh for the next: each equal, bit for bit, to the same two steps with
    no checkpoint in between (the state carried in memory)."""
    import os

    import torch.distributed as dist

    from repro_torch import configs, plan as planlib
    from repro_torch.checkpoint import restore_latest, save_checkpoint
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.optim.schedules import constant
    from repro_torch.train import step as S

    fid = dataclasses.replace(configs.fidelity_presets()["adc9"], spec=opt_cfg.spec)
    rules = planlib.default_rules(opt_cfg, fidelity=fid)
    ds = SyntheticLMDataset(cfg.vocab, 16, 4, device="cpu")
    mesh_step = S.make_train_step(cfg, opt_cfg, constant(LR), mesh=mesh, plan_rules=rules, remat="none")
    one = S.make_train_step(cfg, opt_cfg, constant(LR), plan_rules=rules, remat="none")
    specs = mesh_step.specs
    root = dist.get_rank() == 0
    fresh = lambda: S.train_state_init(cfg, opt_cfg, 0, device="cpu")  # noqa: E731
    out = {}
    # (a) mesh -> one process
    da = os.path.join(directory, "mesh_to_one")
    local, _ = mesh_step(S.shard_state(fresh(), specs, mesh), ds.batch(0))
    save_checkpoint(da, 0, local, plan=mesh_step.plan, mesh=mesh, specs=specs)
    carried = S.gather_state(local, specs, mesh)
    if root:
        restored, rstep = restore_latest(da, fresh(), device="cpu")
        a, _ = one(restored, ds.batch(rstep + 1))
        b, _ = one(carried, ds.batch(1))
        out["mesh_to_one"] = _same_state(a, b)
    # (b) one process -> mesh
    db = os.path.join(directory, "one_to_mesh")
    if root:
        s1, _ = one(fresh(), ds.batch(0))
        save_checkpoint(db, 0, s1, plan=mesh_step.plan)
    dist.barrier()
    s1 = fresh()
    s1, _ = one(s1, ds.batch(0))  # every rank carries the same state in memory
    restored, rstep = restore_latest(db, S.shard_state(fresh(), specs, mesh), device="cpu", mesh=mesh, specs=specs)
    a, _ = mesh_step(restored, ds.batch(rstep + 1))
    b, _ = mesh_step(S.shard_state(s1, specs, mesh), ds.batch(1))
    out["one_to_mesh"] = _all_ranks(_same_state(a, b), mesh)
    return out


def step_world(rank, shape, variants, directory):
    """The step variants (``_step_variants``) and the checkpoint checks on
    one world; rank 0's results."""
    from repro_torch import configs
    from repro_torch.optim import PantherConfig

    mesh = _world(shape)
    cfg = dataclasses.replace(configs.get_smoke(SMOKE), dtype=torch.float32)
    opt_cfg = PantherConfig(crs_every=2, stochastic_round=True)
    out = {"steps": _step_variants(cfg, opt_cfg, mesh, variants)}
    out["ckpt"] = _ckpt_checks(cfg, opt_cfg, mesh, directory)
    return out


def sleeper(rank):
    """A rank that never finishes (the spawn timeout's test)."""
    import time

    time.sleep(3600)


# ------------------------------ every architecture ------------------------------


def arch_world(rank, cases, fold_presets=(), extras=False):
    """One mesh step of each SMOKE arch (f32, lr ``LR``) against the
    single-process step from the same state, for each ``(shape, rules,
    archs)`` case (adc9 reads): rank 0's (loss, one-process loss, weight
    gap ``_rel``) by (shape, rules, arch). Then ``_fold_steps`` for each of
    ``fold_presets``, by ``("fold", preset)``."""
    from repro_torch import configs, plan as planlib
    from repro_torch.data import FrameStub, SyntheticLMDataset
    from repro_torch.launch import mesh as M
    from repro_torch.optim import PantherConfig
    from repro_torch.optim.schedules import constant
    from repro_torch.train import step as S

    M.init_world("cpu", verbose=False)
    opt = PantherConfig(crs_every=1, stochastic_round=True)
    fid = dataclasses.replace(configs.fidelity_presets()["adc9"], spec=opt.spec)
    out = {}
    for shape, rules_name, archs in cases:
        mesh = M.init_mesh(shape)
        root = all(v == 0 for v in mesh.coordinate.values())
        for arch in archs:
            cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32)
            rules = getattr(planlib, f"{rules_name}_rules")(opt, fid)
            batch = SyntheticLMDataset(cfg.vocab, 16, 4, device="cpu").batch(0)
            if cfg.input_mode != "tokens":
                batch = {**batch, "inputs": FrameStub(cfg.vocab, cfg.d_model, device="cpu")(batch["inputs"])}
            step = S.make_train_step(cfg, opt, constant(LR), mesh=mesh, plan_rules=rules, remat="none")
            init = lambda: S.train_state_init(cfg, opt, 0, device="cpu", plan=step.plan)  # noqa: E731
            state, m = step(S.shard_state(init(), step.specs, mesh), batch)
            got = S.gather_state(state, step.specs, mesh)
            if root:
                ref, m1 = S.make_train_step(cfg, opt, constant(LR), plan_rules=rules, remat="none")(init(), batch)
                out[(shape, rules_name, arch)] = (float(m["loss"]), float(m1["loss"]), _rel(got, ref, opt))
    if fold_presets:
        mesh = M.init_mesh((2, 2))
        for preset in fold_presets:
            out[("fold", preset)] = _fold_steps(mesh, opt, preset)
    if extras:
        out.update(_mesh_extras(M.init_mesh((2, 2)), opt, fid))
    return out


MOE_GROUP = 16  # the MoE cases' dispatch group (the model's is 1024): a rank's row of 16 tokens one whole group
DRY_SHAPE = {"kind": "train", "seq_len": 16, "global_batch": 4}  # the dry run's SMOKE cell


def _mesh_extras(mesh, opt, fid):
    """Rank 0's results of:

    * ``("moe", arch)``: one ideal-ADC ``coverage_rules`` step of each MoE
      SMOKE arch on the (4, 1) mesh, on aligned dispatch groups (4 x 16
      tokens, a row a rank, the group cut to ``MOE_GROUP`` tokens in this
      process: the card runs the model's 1024, ``chip_smoke.py`` phase 21),
      against one process: (loss, one-process loss, aux, one-process aux,
      weight gap);
    * ``("remat", "moe", arch)``: that mesh step under ``remat="full"``
      (the default) and under ``"none"`` from one state: loss, aux, grad
      norm and every leaf equal (a bool);
    * on ``mesh`` (2, 2):
    * ``("remat", "fsdp", SMOKE)``: one adc9 ``coverage_rules`` FSDP step of
      the SMOKE arch under ``"full"`` and ``"none"`` from one state, equal
      as above (the recompute gathers each layer's blocks again);
    * ``("conv_fsdp", arch)``: one adc9 ``coverage_rules`` FSDP step of each
      SSM arch (``conv_w``'s planes sharded over 'data', updated a block at
      its origin) against one process: (loss, one-process loss, weight gap);
    * ``("moe_serve", ...)``: granite SMOKE at capacity factor 1.0 served on
      groups a rank does not hold whole (prefill of 2 x 5 tokens and two
      decode steps): the mesh's logits against one process's, and against
      the logits of each rank's rows dispatched alone (the fault repaired);
    * ``"dry_tally"``: the collectives of the dry run's SMOKE train cell
      (``launch.dryrun``) stepped live, as ``distributed.collectives``
      counts them."""
    from repro_torch import configs, plan as planlib
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.distributed import collectives as col
    from repro_torch.launch import dryrun as D
    from repro_torch.models.common import MoECfg
    from repro_torch.optim.schedules import constant
    from repro_torch.train import step as S

    from repro_torch.launch import mesh as M
    from repro_torch.models import mlp

    root = all(v == 0 for v in mesh.coordinate.values())
    out = {}
    ideal = dataclasses.replace(configs.fidelity_presets()["ideal"], spec=opt.spec)
    data4 = M.init_mesh((4, 1))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the remat cases compare two steps bit for bit
    model_group, mlp.MOE_GROUP = mlp.MOE_GROUP, MOE_GROUP
    for arch in ("granite_moe_1b_a400m", "deepseek_v2_lite_16b"):
        cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32)
        rules = planlib.coverage_rules(opt, ideal)
        batch = SyntheticLMDataset(cfg.vocab, MOE_GROUP, 4, device="cpu").batch(0)
        step = S.make_train_step(cfg, opt, constant(LR), mesh=data4, plan_rules=rules, remat="none")
        init = lambda: S.train_state_init(cfg, opt, 0, device="cpu", plan=step.plan)  # noqa: E731
        state, m = step(S.shard_state(init(), step.specs, data4), batch)
        got = S.gather_state(state, step.specs, data4)
        full = S.make_train_step(cfg, opt, constant(LR), mesh=data4, plan_rules=rules)
        state_f, m_f = full(S.shard_state(init(), full.specs, data4), batch)
        got_f = S.gather_state(state_f, full.specs, data4)
        if root:
            ref, m1 = S.make_train_step(cfg, opt, constant(LR), plan_rules=rules, remat="none")(init(), batch)
            out[("moe", arch)] = (float(m["loss"]), float(m1["loss"]), float(m["aux"]), float(m1["aux"]),
                                  _rel(got, ref, opt))
            out[("remat", "moe", arch)] = _same_step(got, m, got_f, m_f)
    mlp.MOE_GROUP = model_group
    cfg = dataclasses.replace(configs.get_smoke(SMOKE), dtype=torch.float32)
    rules = planlib.coverage_rules(opt, fid)
    batch = SyntheticLMDataset(cfg.vocab, 16, 4, device="cpu").batch(0)
    got = {}
    for mode in ("none", "full"):
        step = S.make_train_step(cfg, opt, constant(LR), mesh=mesh, fsdp=True, plan_rules=rules, remat=mode)
        state = S.train_state_init(cfg, opt, 0, device="cpu", plan=step.plan)
        state, m = step(S.shard_state(state, step.specs, mesh), batch)
        got[mode] = (S.gather_state(state, step.specs, mesh), m)
    if root:
        out[("remat", "fsdp", SMOKE)] = _same_step(*got["none"], *got["full"])
    torch.set_num_threads(threads)
    for arch in ("xlstm_125m", "zamba2_1p2b"):
        cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32)
        rules = planlib.coverage_rules(opt, fid)
        batch = SyntheticLMDataset(cfg.vocab, 16, 4, device="cpu").batch(0)
        step = S.make_train_step(cfg, opt, constant(LR), mesh=mesh, fsdp=True, plan_rules=rules, remat="none")
        init = lambda: S.train_state_init(cfg, opt, 0, device="cpu", plan=step.plan)  # noqa: E731
        state, m = step(S.shard_state(init(), step.specs, mesh), batch)
        got = S.gather_state(state, step.specs, mesh)
        if root:
            ref, m1 = S.make_train_step(cfg, opt, constant(LR), plan_rules=rules, remat="none")(init(), batch)
            out[("conv_fsdp", arch)] = (float(m["loss"]), float(m1["loss"]), _rel(got, ref, opt))
    out[("moe_serve",)] = _moe_serve(mesh, dataclasses.replace(
        configs.get_smoke("granite_moe_1b_a400m"), dtype=torch.float32,
        moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=1.0)))
    cfg = configs.get_smoke(SMOKE)
    step, g = D.train_cell_step(cfg, DRY_SHAPE, mesh)
    state = S.shard_state(S.train_state_init(cfg, D.TRAIN_OPT, 0, device="cpu", plan=step.plan), step.specs, mesh)
    batch = SyntheticLMDataset(cfg.vocab, DRY_SHAPE["seq_len"], DRY_SHAPE["global_batch"], device="cpu").batch(0)
    col.tally.clear()
    step(state, {k: v.to(torch.int32) for k, v in batch.items()})
    out["dry_tally"] = (g, col.tally.record())
    return out


def _same_step(a, ma, b, mb) -> bool:
    """Whether two steps' states (every plane, frac-bits and digital leaf)
    and metrics (loss, aux, grad norm) are equal bit for bit."""
    from repro_torch import tree

    def leaves(st):
        out = [(("d",) + p, x) for p, x in tree.leaves_with_path(st.digital) if x is not None]
        for p, x in tree.leaves_with_path(st.sliced):
            if x is not None:
                out += [(("s",) + p, x.planes), (("f",) + p, x.frac_bits)]
        return out

    ta, tb = leaves(a), leaves(b)
    return [p for p, _ in ta] == [p for p, _ in tb] and all(torch.equal(x, y) for (_, x), (_, y) in zip(ta, tb)) \
        and all(float(ma[k]) == float(mb[k]) for k in ("loss", "aux", "grad_norm"))


def _moe_serve(mesh, cfg):
    """Prefill and two decode steps of 2 x 5 prompt tokens on ``mesh`` and
    on one process, and on one process with each rank's row served alone:
    rank 0's ``(max |mesh - one| / max |one|, tokens equal, max |alone -
    one| / max |one|)``."""
    from repro_torch.models import lm
    from repro_torch.optim import PantherConfig, panther
    from repro_torch.serve import kv_pages
    from repro_torch.serve.step import make_decode_step, make_prefill
    from repro_torch.train import step as S

    opt = PantherConfig()
    state = S.train_state_init(cfg, opt, 0, device="cpu")
    params = panther.materialize_split(state.digital, state.sliced, opt)
    prompts = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (2, 5)))

    def run(m, rows):
        prefill, decode = make_prefill(cfg, mesh=m), make_decode_step(cfg, mesh=m)
        lg, caches = prefill(params, rows)
        caches = kv_pages.grow_caches(cfg, lm.unstack_caches(cfg, caches), 5 + 3)
        seq, tok = [lg], torch.argmax(lg, dim=-1)
        for i in range(2):
            tok, lg, caches = decode(params, tok, caches, 5 + i)
            seq.append(lg)
        return torch.stack(seq)

    got, one = run(mesh, prompts), run(None, prompts)
    alone = torch.cat([run(None, prompts[r:r + 1]) for r in range(2)], dim=1)
    top = one.abs().max()
    return (float((got - one).abs().max() / top), bool(torch.equal(got.argmax(-1), one.argmax(-1))),
            float((alone - one).abs().max() / top))


FOLD_WIDTH = 512  # a rank's half of each contraction is 2 crossbar tiles: the fold reorders a sum


def _fold_steps(mesh, opt, preset):
    """gemma-2b's SMOKE config at FOLD_WIDTH, where the reads on a model
    axis of 2 split their contraction (``tile_psum`` adds two f32
    partials): ``STEPS`` mesh steps under ``coverage_rules`` with
    ``preset`` reads, each against the single-process step from the same
    state whose reads fold at the same rank boundary (``FoldCtx(2)``).
    Rank 0's (the plan's fidelity leaves that split a contraction, [(mesh
    loss, one-process loss, weight gap ``_rel``) a step])."""
    from repro_torch import configs, plan as planlib, tree
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.distributed import fidelity as dist_fid
    from repro_torch.optim.schedules import constant
    from repro_torch.train import step as S

    cfg = dataclasses.replace(configs.get_smoke("gemma_2b"), d_model=FOLD_WIDTH, d_ff=FOLD_WIDTH,
                              head_dim=FOLD_WIDTH // 4, dtype=torch.float32)
    fid = dataclasses.replace(configs.fidelity_presets()[preset], spec=opt.spec)
    step = S.make_train_step(cfg, opt, constant(LR), mesh=mesh, plan_rules=planlib.coverage_rules(opt, fid),
                             remat="none")
    one = S.make_train_step(cfg, opt, constant(LR), plan=step.plan, remat="none")
    ds = SyntheticLMDataset(cfg.vocab, 16, 4, device="cpu")
    state = S.shard_state(S.train_state_init(cfg, opt, 0, device="cpu", plan=step.plan), step.specs, mesh)
    root = all(v == 0 for v in mesh.coordinate.values())
    split = sum(pl.fidelity is not None and pl.fidelity.shard_dim is not None
                for _, pl in tree.leaves_with_path(step.plan))
    res = []
    for k in range(STEPS):
        before = S.gather_state(state, step.specs, mesh)
        state, m = step(state, ds.batch(k))
        got = S.gather_state(state, step.specs, mesh)
        if root:
            with dist_fid.use_sharded_fidelity(dist_fid.FoldCtx(mesh.shape["model"])):
                ref, m1 = one(before, ds.batch(k))
            res.append((float(m["loss"]), float(m1["loss"]), _rel(got, ref, opt)))
    return split, res
