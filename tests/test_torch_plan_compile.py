"""``repro_torch.isa.plan_compile`` against ``repro.isa.plan_compile``, case
by case with ``tests/test_plan_compile.py``: each mirror runs the
reference's checks on the port (its ``ShapeDtype`` trees and plans) and
holds the port to the reference in-process: the fused streams equal ``repr``
for ``repr`` (the golden two-leaf stream is the reference's), energies and
times within ``RTOL``. Beyond the mirrors: gemma-2b at full width
(``token_latency_ns`` and the captured leaves against the reference's
``jax.eval_shape`` tree), the 4-layer transformer's compiled step, and the
energy record against the in-process reference and the committed
``BENCH_energy.json``."""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import plan as jplan  # noqa: E402
from repro.isa import plan_compile as jpc  # noqa: E402
from repro.isa.compiler import Hierarchy as JHierarchy  # noqa: E402
from repro.isa.compiler import place_tiles as jplace_tiles  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.optim import PantherConfig as JPantherConfig  # noqa: E402
from repro.optim import tiki_taka as jtiki_taka  # noqa: E402
from repro_torch.isa import plan_compile as pc  # noqa: E402
from repro_torch.isa.compiler import Hierarchy, place_tiles  # noqa: E402
from repro_torch.isa.energy import DEFAULT_ENERGY, PAPER_BITS, adc_eff_bits  # noqa: E402
from repro_torch.isa.isa import Opcode  # noqa: E402
from repro_torch.models.common import DeviceModel, FidelityConfig, ShapeDtype  # noqa: E402
from repro_torch.optim import PantherConfig, tiki_taka  # noqa: E402
from repro_torch.plan import PlanRule, resolve_plan  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-12  # energies and times, port vs reference, relative
SMALL_HW = Hierarchy(tiles_per_node=2, cores_per_tile=2, mcus_per_core=2)
JSMALL_HW = JHierarchy(tiles_per_node=2, cores_per_tile=2, mcus_per_core=2)
# gemma-2b at full width, the default (lossless) plan: the reference's
# token_latency_ns over its jax.eval_shape tree, and its systems_summary of
# compile_plan(tokens=256) (chip_smoke.py phase 16 (e) holds the port's)
GEMMA_TOKEN_NS = 9320.48


def _close(a, b) -> bool:
    return abs(a - b) <= RTOL * max(abs(a), abs(b))


def _deep_close(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_deep_close(a[k], b[k]) for k in a)
    if isinstance(a, float) or isinstance(b, float):
        return _close(a, b)
    return a == b


def _shapes(dims: dict):
    """``{name: {"w": shape}}`` as the port's and the reference's shape trees."""
    t = {k: {"w": ShapeDtype(d, torch.float32)} for k, d in dims.items()}
    j = {k: {"w": jax.ShapeDtypeStruct(d, jnp.float32)} for k, d in dims.items()}
    return t, j


def _rules(pkg, specs):
    """``[(pattern, fields)]`` as ``PlanRule`` s of one package; a fidelity
    given as a dict becomes that package's ``FidelityConfig``."""
    Rule, Fid, Dev = ((PlanRule, FidelityConfig, DeviceModel) if pkg == "t"
                      else (jplan.PlanRule, jcommon.FidelityConfig, jcommon.DeviceModel))
    out = []
    for pattern, fields in specs:
        fields = dict(fields)
        if "fidelity" in fields:
            fid = dict(fields["fidelity"])
            if "device" in fid:
                fid["device"] = Dev(**fid["device"])
            fields["fidelity"] = Fid(**fid)
        out.append(Rule(pattern, **fields))
    return tuple(out)


TWO_LEAF_DIMS = {"a": (256, 128), "b": (128, 128)}
TWO_LEAF_RULES = [("a/*", dict(mapped=True, grad="operand", fidelity=dict(adc_bits_fwd=6, adc_bits_bwd=9))),
                  ("b/*", dict(mapped=True, grad="dense"))]


def _both(dims, rules):
    """(port params, port plan, reference params, reference plan)."""
    t, j = _shapes(dims)
    return t, resolve_plan(t, _rules("t", rules)), j, jplan.resolve_plan(j, _rules("j", rules))


def _two_leaf():
    """The golden fixture: one hetero-ADC operand leaf (2 tiles) + one
    dense-grad leaf (1 tile)."""
    return _both(TWO_LEAF_DIMS, TWO_LEAF_RULES)


def _stream(prog):
    return {core: [repr(i) for i in instrs] for core, instrs in prog.cores.items()}


def _full(prog):
    """Every instruction with its TileOps' reprs: the stream in full."""
    return {core: [(repr(i), i.masks, [repr(op) for op in i.mcu_ops], i.n_elems) for i in instrs]
            for core, instrs in prog.cores.items()}


def _meta(prog):
    return {k: (dataclasses.asdict(v) if k == "hw" else v) for k, v in prog.meta.items()}


def _same_program(prog, jprog):
    assert _full(prog) == _full(jprog)
    assert _meta(prog) == _meta(jprog)


def _same_report(rep, jrep):
    assert _deep_close(rep, jrep), (rep, jrep)


def test_golden_two_leaf_stream():
    """The fused per-core instruction streams, pinned: a spec/placement/
    fusion change that reshapes the schedule must show up here."""
    params, plan, jparams, jplan_ = _two_leaf()
    prog = pc.compile_plan(params, plan, tokens=2, hw=SMALL_HW)
    assert _stream(prog) == {
        0: [  # a/w: both tiles on core 0 (MCUs 0-1), fused per phase
            "mcu[100,100] a/w:fwd",
            "mcu[010,010] a/w:bwd",
            "store(1024) a/w:save",
            "store(1024) a/w:save",
            "mcu[001,001] a/w:wgrad",
            "halt(0) halt",
        ],
        1: [  # b/w: dense grad — digital wgrad + serial read-modify-write
            "mcu[100,000] b/w:fwd",
            "mcu[010,000] b/w:bwd",
            "mcu[001,000] b/w:wgrad",
            "xread(1) b/w:update",
            "xwrite(1) b/w:update",
            "halt(0) halt",
        ],
    }
    # the TileOps carry the plan's pricing attributes (per-phase ADC; the
    # dense leaf's fidelity was dropped at resolution -> lossless reads)
    ops = {f"{c}/{i.tag}": [repr(op) for op in i.mcu_ops]
           for c, instrs in prog.cores.items()
           for i in instrs if i.op is Opcode.MCU}
    assert ops["0/a/w:fwd"] == ["mvm[a/w@(0, 0, 0)]x2(44466555,io16,adc6)",
                                "mvm[a/w@(0, 1, 0)]x2(44466555,io16,adc6)"]
    assert ops["0/a/w:bwd"] == ["mtvm[a/w@(0, 0, 0)]x2(44466555,io16,adc9)",
                                "mtvm[a/w@(0, 1, 0)]x2(44466555,io16,adc9)"]
    assert ops["0/a/w:wgrad"] == ["opa[a/w@(0, 0, 0)]x2(44466555,io16,adcideal)",
                                  "opa[a/w@(0, 1, 0)]x2(44466555,io16,adcideal)"]
    assert ops["1/b/w:wgrad"] == ["wgrad_d[b/w@(0, 0, 0)]x2(44466555,io16,adcideal)"]
    assert prog.meta["leaves"]["a/w"]["category"] == "operand"
    assert prog.meta["leaves"]["b/w"]["category"] == "dense"
    # the reference's golden stream, TileOp for TileOp
    _same_program(prog, jpc.compile_plan(jparams, jplan_, tokens=2, hw=JSMALL_HW))


def test_compile_deterministic_and_fuse_fixpoint():
    """Compiling twice gives byte-identical streams, and re-fusing a fused
    program is the identity (the fusion pass is a fixpoint)."""
    from repro_torch.isa.compiler import fuse

    params, plan, jparams, jplan_ = _two_leaf()
    p1 = pc.compile_plan(params, plan, tokens=2, hw=SMALL_HW)
    p2 = pc.compile_plan(params, plan, tokens=2, hw=SMALL_HW)
    assert _stream(p1) == _stream(p2)
    refused = fuse(p1, "v2", SMALL_HW, no_dep=pc._plan_no_dep)
    assert _stream(refused) == _stream(p1)
    for variant in ("v1", "v2", "v3"):
        _same_program(pc.compile_plan(params, plan, tokens=3, variant=variant),
                      jpc.compile_plan(jparams, jplan_, tokens=3, variant=variant))


def test_v3_variant_commits_serially():
    params, plan, jparams, jplan_ = _two_leaf()
    prog = pc.compile_plan(params, plan, tokens=2, hw=SMALL_HW, variant="v3")
    instrs = [i for s in prog.cores.values() for i in s]
    assert not any(i.op is Opcode.STORE and "save" in i.tag for i in instrs)
    assert any(i.op is Opcode.XWRITE and "commit" in i.tag for i in instrs)
    jprog = jpc.compile_plan(jparams, jplan_, tokens=2, hw=JSMALL_HW, variant="v3")
    _same_program(prog, jprog)
    for system in ("panther", "base_digital", "base_mvm"):
        _same_report(pc.report(prog, system), jpc.report(jprog, system))


# --------------------------- §7.3 pricing anchors ---------------------------


def test_paper_energy_anchors_exact():
    """The Table-5 constants the whole energy stack hangs off — moving one
    of these reprices every figure and must be deliberate."""
    from repro.isa.energy import DEFAULT_ENERGY as JE

    em = DEFAULT_ENERGY
    assert em.e_mvm_reram == 35.10
    assert em.e_opa_reram == 11.37
    assert em.e_opa_cmos == 37.28
    assert em.adc_tax_panther == 1.175
    assert dataclasses.asdict(em) == dataclasses.asdict(JE)


def test_mvm_packed_default_is_taxed_anchor():
    """Paper-default packed round == the §6.3-taxed §7.3 MVM anchor,
    exactly: 35.10 nJ x 1.175."""
    from repro.isa.energy import DEFAULT_ENERGY as JE

    e, lat = DEFAULT_ENERGY.mvm_packed()
    assert e == pytest.approx(35.10 * 1.175, rel=1e-12)
    assert lat == pytest.approx(DEFAULT_ENERGY.l_mvm_reram)
    assert (e, lat) == JE.mvm_packed()


def test_mvm_packed_coarser_adc_and_narrower_io_price_below():
    from repro.isa.energy import DEFAULT_ENERGY as JE

    em = DEFAULT_ENERGY
    e_ref, lat_ref = em.mvm_packed(PAPER_BITS, 16, None)
    e_adc9, _ = em.mvm_packed(PAPER_BITS, 16, 9)
    e_adc6, _ = em.mvm_packed(PAPER_BITS, 16, 6)
    e_io8, lat_io8 = em.mvm_packed(PAPER_BITS, 8, None)
    assert e_adc6 < e_adc9 < e_ref
    assert e_io8 < e_ref and lat_io8 < lat_ref
    # io scaling is exactly the (io_bits - 1) bit-plane round count
    assert e_io8 == pytest.approx(e_ref * 7 / 15)
    for io, adc in ((16, None), (16, 9), (16, 6), (8, None)):
        assert em.mvm_packed(PAPER_BITS, io, adc) == JE.mvm_packed(PAPER_BITS, io, adc)


def test_adc_eff_bits_saturates_at_full_resolution():
    from repro.isa.energy import adc_eff_bits as j_adc_eff_bits

    assert adc_eff_bits(5, None) == 12  # 7 row bits + 5 slice bits
    assert adc_eff_bits(5, 9) == 9
    assert adc_eff_bits(2, 12) == 9  # can't read finer than the column sum
    for b, adc in ((5, None), (5, 9), (2, 12), (8, 6)):
        assert adc_eff_bits(b, adc) == j_adc_eff_bits(b, adc)


def test_opa_panther_verify_overhead():
    from repro.isa.energy import DEFAULT_ENERGY as JE

    em = DEFAULT_ENERGY
    e0, l0 = em.opa_panther(nonideal_write=False)
    e1, l1 = em.opa_panther(nonideal_write=True)
    assert e0 == em.e_opa_reram
    assert e1 == pytest.approx(e0 * 1.25) and l1 > l0
    assert ((e0, l0), (e1, l1)) == (JE.opa_panther(False), JE.opa_panther(True))


# ------------------------- placement / shard hints --------------------------


def _placed(pls):
    return {k: [dataclasses.astuple(t) for t in v] for k, v in pls.items()}


def test_place_tiles_shard_hint_aligns_tile_boundaries():
    """A 'model'-sharded leaf splits its hinted dim into n_shards groups,
    each starting on a Table-3 tile boundary, with disjoint shard ids."""
    hw = Hierarchy(tiles_per_node=4, cores_per_tile=2, mcus_per_core=2)
    grids = {"w": (1, 4, 2)}
    pls = place_tiles(grids, hw, hints={"w": 0}, n_shards=2)["w"]
    by_shard = {}
    for t in pls:
        by_shard.setdefault(t.shard, []).append(t)
    assert sorted(by_shard) == [0, 1]
    rows = {s: {t.tile_rc[1] for t in ts} for s, ts in by_shard.items()}
    assert rows[0] == {0, 1} and rows[1] == {2, 3}
    # shard 1's first MCU starts on a tile boundary (mcus_per_tile = 4)
    first_mcu_s1 = min(t.mcu for t in by_shard[1])
    assert first_mcu_s1 % hw.mcus_per_tile == 0
    mcus = [t.mcu for t in pls]
    assert len(set(mcus)) == len(mcus)
    jhw = JHierarchy(tiles_per_node=4, cores_per_tile=2, mcus_per_core=2)
    for hints, n in (({"w": 0}, 2), ({"w": 1}, 2), ({"w": 0, "v": 1}, 3)):
        g = {"u": (2, 1, 3), **grids, "v": (1, 3, 5)}
        assert _placed(place_tiles(g, hw, hints=hints, n_shards=n)) == \
            _placed(jplace_tiles(g, jhw, hints=hints, n_shards=n))


def test_unhinted_placement_matches_legacy_numbering():
    """Without hints, place_tiles keeps the seed-era contiguous numbering
    (partition_and_place delegates to it — placement must not drift)."""
    hw = Hierarchy()
    pls = place_tiles({"a": (1, 2, 2), "b": (1, 1, 1)}, hw)
    assert [t.mcu for t in pls["a"]] == [0, 1, 2, 3]
    assert [t.mcu for t in pls["b"]] == [4]
    assert _placed(pls) == _placed(jplace_tiles({"a": (1, 2, 2), "b": (1, 1, 1)}, JHierarchy()))


def test_sharded_compile_prices_same_compute():
    """Sharding relocates tiles; it must not change the compute priced."""
    params, plan, _, _ = _two_leaf()
    rules = (PlanRule("a/*", mapped=True, grad="operand",
                      fidelity=FidelityConfig(adc_bits_fwd=6, adc_bits_bwd=9,
                                              shard_dim=0)),
             PlanRule("b/*", mapped=True, grad="dense"))
    plan_sh = resolve_plan(params, rules)
    hw = Hierarchy()
    base = pc.report(pc.compile_plan(params, plan, tokens=4, hw=hw))
    shard = pc.report(pc.compile_plan(params, plan_sh, tokens=4, hw=hw,
                                      n_shards=2))
    for leaf in ("a/w", "b/w"):
        for cat in ("mvm", "mtvm"):
            assert shard["per_leaf_nj"][leaf][cat] == pytest.approx(
                base["per_leaf_nj"][leaf][cat])


# ----------------------------- priced schedules -----------------------------


def test_hetero_adc_prices_below_lossless():
    """The fig10 mechanism end to end: a coarser-ADC plan over the same
    params compiles to a measurably cheaper step."""
    e = {}
    for name, fields in (("full", dict(mapped=True, grad="operand")),
                         ("coarse", dict(mapped=True, grad="operand",
                                         fidelity=dict(adc_bits_fwd=6, adc_bits_bwd=6)))):
        params, plan, jparams, jplan_ = _both(TWO_LEAF_DIMS, [("*", fields)])
        rep = pc.report(pc.compile_plan(params, plan, tokens=8))
        _same_report(rep, jpc.report(jpc.compile_plan(jparams, jplan_, tokens=8)))
        e[name] = rep["total_nj"]
    assert e["coarse"] < e["full"]
    assert (e["full"] - e["coarse"]) / e["full"] > 1e-3


def test_systems_summary_mlp_in_paper_bands():
    """The §7.3 headline re-derived from the packed plan schedule: the paper
    MLP at SGD lands in the fig11/fig13 bands, and the serial-write
    advantage amortizes at minibatch (§7.4)."""
    dims = [(1024, 256), (256, 512), (512, 512), (512, 10)]
    params, plan, jparams, jplan_ = _both({f"dense{i}": d for i, d in enumerate(dims)},
                                          [("*", dict(mapped=True, grad="operand"))])
    sgd = pc.systems_summary(pc.compile_plan(params, plan, tokens=1))
    assert 6.0 < sgd["vs_digital"] < 9.0, sgd
    assert 25.0 < sgd["vs_serial_write"] < 60.0, sgd
    mb = pc.systems_summary(pc.compile_plan(params, plan, tokens=64))
    assert 1.0 < mb["vs_serial_write"] < 3.0, mb
    assert mb["vs_serial_write"] < sgd["vs_serial_write"]
    assert sgd["time_vs_serial_write"] > 1.0
    _same_report(sgd, jpc.systems_summary(jpc.compile_plan(jparams, jplan_, tokens=1)))
    _same_report(mb, jpc.systems_summary(jpc.compile_plan(jparams, jplan_, tokens=64)))


def test_tiki_taka_momentum_traffic_visible_per_leaf():
    params, plan, jparams, jplan_ = _two_leaf()
    plain = pc.report(pc.compile_plan(
        params, plan, tokens=2, opt_cfg=PantherConfig(stochastic_round=False)))
    tt_prog = pc.compile_plan(params, plan, tokens=2, opt_cfg=tiki_taka(PantherConfig(stochastic_round=False)))
    tt = pc.report(tt_prog)
    assert tt["total_nj"] > plain["total_nj"]
    for leaf in ("a/w", "b/w"):
        extra = (tt["per_leaf_nj"][leaf].get("mem", 0.0)
                 - plain["per_leaf_nj"][leaf].get("mem", 0.0))
        assert extra > 0, leaf  # the momentum buffer's RMW traffic, per leaf
    jtt_prog = jpc.compile_plan(jparams, jplan_, tokens=2, opt_cfg=jtiki_taka(JPantherConfig(stochastic_round=False)))
    _same_program(tt_prog, jtt_prog)
    _same_report(tt, jpc.report(jtt_prog))


def test_crs_amortizes_with_period():
    params, plan, jparams, jplan_ = _two_leaf()
    fast = pc.report(pc.compile_plan(params, plan, tokens=1,
                                     opt_cfg=PantherConfig(crs_every=10)))
    slow = pc.report(pc.compile_plan(params, plan, tokens=1,
                                     opt_cfg=PantherConfig(crs_every=1000)))
    assert fast["per_leaf_nj"]["a/w"]["crs"] == pytest.approx(
        100 * slow["per_leaf_nj"]["a/w"]["crs"])
    _same_report(fast, jpc.report(jpc.compile_plan(jparams, jplan_, tokens=1, opt_cfg=JPantherConfig(crs_every=10))))


def test_nonideal_device_prices_verify_overhead():
    e = {}
    for name, fields in (("ideal", dict(mapped=True, grad="operand")),
                         ("noisy", dict(mapped=True, grad="operand",
                                        fidelity=dict(device=dict(write_noise=0.05))))):
        params, plan, jparams, jplan_ = _both(TWO_LEAF_DIMS, [("*", fields)])
        e[name] = pc.report(pc.compile_plan(params, plan, tokens=1))
        _same_report(e[name], jpc.report(jpc.compile_plan(jparams, jplan_, tokens=1)))
    assert (e["noisy"]["per_leaf_nj"]["a/w"]["opa"]
            == pytest.approx(e["ideal"]["per_leaf_nj"]["a/w"]["opa"] * 1.25))


# ------------------------------- serving clock ------------------------------


def test_isa_clock_prices_known_keys_without_calibration():
    from repro.serve.scheduler import IsaClock as JIsaClock
    from repro_torch.serve.scheduler import IsaClock

    clk = IsaClock(s_per_token=1e-6, n_slots=8)
    assert ("prefill", 32) in clk and clk[("prefill", 32)] == pytest.approx(32e-6)
    assert clk[("cont", 16, 48)] == pytest.approx(16e-6)
    assert clk[("round", 4)] == pytest.approx(4 * 8 * 1e-6)
    assert ("something", 3) not in clk  # unknown keys fall through to dict
    clk[("something", 3)] = 0.5
    assert clk[("something", 3)] == 0.5
    jclk = JIsaClock(s_per_token=1e-6, n_slots=8)
    for key in (("prefill", 32), ("cont", 16, 48), ("round", 4), ("round", 8)):
        assert clk[key] == jclk[key]


def test_isa_clock_from_plan_matches_token_latency():
    from repro.serve.scheduler import IsaClock as JIsaClock
    from repro_torch.serve.scheduler import IsaClock

    params, plan, jparams, jplan_ = _two_leaf()
    ns = pc.token_latency_ns(params, plan, DEFAULT_ENERGY)
    clk = IsaClock.from_plan(params, plan, n_slots=4)
    assert ns > 0
    assert clk[("prefill", 10)] == pytest.approx(10 * ns * 1e-9)
    jclk = JIsaClock.from_plan(jparams, jplan_, n_slots=4, scale=2.5)
    assert ns == jpc.token_latency_ns(jparams, jplan_)
    assert IsaClock.from_plan(params, plan, n_slots=4, scale=2.5).s_per_token == jclk.s_per_token


# ---------------------- beyond the mirrors: real models ----------------------


def test_capture_reads_tensors_fake_tensors_and_shapes_alike():
    """``capture_leaves`` reads only ``.shape``: real, meta and fake tensors
    and ``ShapeDtype`` leaves capture the same leaves, sorted by path."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dims = {"z": (256, 128), "a": (128, 384), "n": (64,)}
    shapes, _ = _shapes(dims)
    plan = resolve_plan(shapes, (PlanRule("*", mapped=True, grad="operand"),))
    real = {k: {"w": torch.zeros(d)} for k, d in dims.items()}
    meta = {k: {"w": torch.empty(d, device="meta")} for k, d in dims.items()}
    with FakeTensorMode():
        fake = {k: {"w": torch.empty(d)} for k, d in dims.items()}
    want = pc.capture_leaves(shapes, plan)
    assert [lm.path for lm in want[0]] == ["a/w", "z/w"] and want[1] == [("n/w", (64,))]
    for tree_ in (real, meta, fake):
        assert pc.capture_leaves(tree_, plan) == want


def _gemma(full: bool):
    """(port cfg, reference cfg) of gemma-2b: full width, or the energy
    record's 4-layer transformer."""
    from repro import configs as jconfigs
    from repro_torch import configs

    cfg, jcfg = configs.get("gemma_2b"), jconfigs.get("gemma_2b")
    if not full:
        cut = dict(d_model=256, n_heads=8, n_kv_heads=2, head_dim=32, d_ff=1024, vocab=2048, n_layers=4,
                   pattern=(("dense", 4),))
        cfg = dataclasses.replace(configs.get_smoke("gemma_2b"), **cut)
        jcfg = dataclasses.replace(jconfigs.get_smoke("gemma_2b"), **cut)
    return cfg, jcfg


def _gemma_both(full: bool):
    from repro.models import lm as jlm
    from repro_torch.models import lm

    cfg, jcfg = _gemma(full)
    shapes = lm.param_shapes(cfg)
    jshapes = jax.eval_shape(lambda: jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    from repro_torch.plan import default_rules

    plan = resolve_plan(shapes, default_rules(PantherConfig()))
    jplan_ = jplan.resolve_plan(jshapes, jplan.default_rules(JPantherConfig()))
    return shapes, plan, jshapes, jplan_


def _captured(mapped_digital):
    mapped, digital = mapped_digital
    return ([(m.path, m.stack, m.rows, m.cols, m.tile_grid, m.plan.category, m.plan.spec.name(),
              pc._leaf_fidelity(m.plan)) for m in mapped], [(p, tuple(s)) for p, s in digital])


def test_gemma_2b_full_width_token_latency_and_leaves():
    """gemma-2b at full width (``lm.param_shapes``: nothing allocated): the
    captured leaves are the reference's ``jax.eval_shape`` tree's, leaf for
    leaf, and ``token_latency_ns`` is its 9320.48 ns. The compiled step at
    full width (431,633 instructions) is held on the card in
    ``chip_smoke.py`` phase 16 (e); here the 4-layer transformer's."""
    shapes, plan, jshapes, jplan_ = _gemma_both(full=True)
    cap = pc.capture_leaves(shapes, plan)
    assert _captured(cap) == _captured(jpc.capture_leaves(jshapes, jplan_))
    assert len(cap[0]) == 8 and sum(m.n_tiles for m in cap[0]) == 152992
    ns = pc.token_latency_ns(shapes, plan)
    assert ns == jpc.token_latency_ns(jshapes, jplan_)
    assert ns == pytest.approx(GEMMA_TOKEN_NS, rel=1e-12)


@pytest.mark.parametrize("tokens", [1, 256])
def test_transformer_compiled_step_equals_the_reference(tokens):
    """The energy record's 4-layer transformer (d 256, d_ff 1024, vocab
    2048): the compiled step's streams equal the reference's, ``repr`` for
    ``repr``, and every system's report within ``RTOL``."""
    shapes, plan, jshapes, jplan_ = _gemma_both(full=False)
    prog = pc.compile_plan(shapes, plan, tokens=tokens, opt_cfg=PantherConfig())
    jprog = jpc.compile_plan(jshapes, jplan_, tokens=tokens, opt_cfg=JPantherConfig())
    _same_program(prog, jprog)
    _same_report(pc.systems_summary(prog), jpc.systems_summary(jprog))


def test_energy_record_equals_the_reference_and_the_committed_one(tmp_path, monkeypatch):
    """``repro_torch.benchmarks.isa_energy``'s record against the
    reference's bench run in-process and against the committed
    ``BENCH_energy.json``: every field, floats within ``RTOL``; the paper
    MLP at SGD reads 7.7415x against digital and 51.329x against serial
    write. It writes nothing without ``--json``."""
    sys.path.insert(0, str(ROOT))  # the reference's benchmarks/
    from benchmarks import isa_energy as JBE
    from repro_torch.benchmarks import isa_energy as BE

    monkeypatch.chdir(tmp_path)
    got = BE.main([])
    assert not list(tmp_path.iterdir())
    monkeypatch.setattr(JBE, "ENERGY_JSON", str(tmp_path / "ref.json"))
    monkeypatch.setattr(JBE, "SMOKE", False)
    JBE.main()
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert _deep_close(json.loads(json.dumps(got, sort_keys=True)), ref)
    assert _deep_close(json.loads(json.dumps(got, sort_keys=True)),
                       json.loads((ROOT / "BENCH_energy.json").read_text()))
    sgd = got["configs"]["mlp"]["tokens"]["1"]
    assert round(sgd["vs_digital"], 4) == 7.7415 and round(sgd["vs_serial_write"], 3) == 51.329


@pytest.mark.parametrize("rules", ["default_rules", "coverage_rules"])
@pytest.mark.parametrize("arch", ["gemma2_9b", "deepseek_v2_lite_16b"])
def test_last_two_archs_compile_like_the_reference(arch, rules):
    """gemma2-9b's pairs (leaves nested under ``local``/``global``) and
    deepseek-v2-lite-16b's MLA and expert leaves at SMOKE size: the
    captured leaves and the compiled step equal the reference's, stream and
    meta (the port's plans have no shard field)."""
    import jax

    from repro import configs as jconfigs
    from repro.models import lm as jlm
    from repro_torch import configs as tconfigs
    from repro_torch import plan as tplan
    from repro_torch.models import lm as tlm

    shapes_j = jax.eval_shape(lambda: jlm.init_params(jconfigs.get_smoke(arch), jax.random.PRNGKey(0)))
    shapes_t = tlm.param_shapes(tconfigs.get_smoke(arch))
    plan_j = jplan.resolve_plan(shapes_j, getattr(jplan, rules)(JPantherConfig()))
    plan_t = resolve_plan(shapes_t, getattr(tplan, rules)(PantherConfig()))
    (mt, dt), (mj, dj) = pc.capture_leaves(shapes_t, plan_t), jpc.capture_leaves(shapes_j, plan_j)
    assert [(m.path, m.stack, m.rows, m.cols, m.plan.grad, m.plan.group) for m in mt] == \
        [(m.path, m.stack, m.rows, m.cols, m.plan.grad, m.plan.group) for m in mj]
    assert dt == dj
    _same_program(pc.compile_plan(shapes_t, plan_t, tokens=64), jpc.compile_plan(shapes_j, plan_j, tokens=64))
