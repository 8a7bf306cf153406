"""``repro_torch.isa`` (``isa``, ``graph``, ``compiler``, ``simulator``)
against ``repro.isa``, case by case with ``tests/test_isa.py``: each mirror
runs the reference's checks on the port and holds the port to the
reference in-process. Host arithmetic, so the legacy pipeline's graphs,
placements and instruction streams are equal ``repr`` for ``repr`` and the
energies and times within ``RTOL`` (they come out equal: the same float
operations in the same order)."""
from __future__ import annotations

import dataclasses

import pytest

pytest.importorskip("torch")

from repro.isa import compiler as JC  # noqa: E402
from repro.isa import graph as JG  # noqa: E402
from repro.isa import isa as JI  # noqa: E402
from repro.isa import simulator as JS  # noqa: E402
from repro_torch.isa.compiler import Hierarchy, _compile_layers, compile_model, partition_and_place  # noqa: E402
from repro_torch.isa.graph import ConvLayer, Graph, MLP_L4, VGG16, build_training_graph  # noqa: E402
from repro_torch.isa.isa import Opcode  # noqa: E402
from repro_torch.isa.simulator import (  # noqa: E402
    _layer_reps, _layer_tiles, layer_energy, layer_time, model_report, simulate)

RTOL = 1e-12  # energies and times, port vs reference, relative
SYSTEMS = ("panther", "base_digital", "base_mvm", "base_opa_mvm")


def _close(a, b) -> bool:
    return abs(a - b) <= RTOL * max(abs(a), abs(b))


def _dict_close(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        _dict_close(a[k], b[k]) if isinstance(a[k], dict) else _close(a[k], b[k]) for k in a)


def _jlayers(layers):
    """The reference's layer objects with the port's fields."""
    return [JG.FCLayer(**dataclasses.asdict(ly)) if type(ly).__name__ == "FCLayer"
            else JG.ConvLayer(**dataclasses.asdict(ly)) for ly in layers]


def _stream(prog):
    return {core: [repr(i) for i in instrs] for core, instrs in prog.cores.items()}


def _ops(prog):
    return {core: [(i.op.value, i.masks, i.mcu_ops, i.n_elems, i.tag) for i in instrs]
            for core, instrs in prog.cores.items()}


def test_module_constants_are_the_reference_s():
    from repro_torch.isa import isa as TI

    assert (TI.MAX_MCUS_PER_CORE, TI.MVM_BIT, TI.MTVM_BIT, TI.OPA_BIT) == (
        JI.MAX_MCUS_PER_CORE, JI.MVM_BIT, JI.MTVM_BIT, JI.OPA_BIT)
    assert [(o.name, o.value) for o in TI.Opcode] == [(o.name, o.value) for o in JI.Opcode]
    assert _jlayers(MLP_L4) == JG.MLP_L4 and _jlayers(VGG16) == JG.VGG16
    assert dataclasses.asdict(Hierarchy()) == dataclasses.asdict(JC.Hierarchy()) and JC.XBAR == 128


def test_matrix_tiling():
    g = Graph()
    m = g.matrix("w", 1024, 300)
    assert m.tiles() == (8, 3)
    assert m.n_tiles() == 24
    jm = JG.Graph().matrix("w", 1024, 300)
    assert (m.tiles(), m.n_tiles(), m.tiles(64)) == (jm.tiles(), jm.n_tiles(), jm.tiles(64))


def test_graph_has_all_three_op_kinds():
    g = build_training_graph(MLP_L4, batch=2)
    kinds = {n.kind for n in g.nodes}
    assert {"mvm", "mtvm", "opa", "vfu"} <= kinds
    # per layer per example: one mvm, one mtvm, one opa
    assert sum(1 for n in g.nodes if n.kind == "opa") == len(MLP_L4) * 2
    jg = JG.build_training_graph(JG.MLP_L4, batch=2)
    assert [(n.kind, n.matrix and n.matrix.name, n.n_elems, n.reps, n.tag, n.id) for n in g.nodes] == \
        [(n.kind, n.matrix and n.matrix.name, n.n_elems, n.reps, n.tag, n.id) for n in jg.nodes]


def test_conv_wgrad_iterates_e2():
    ly = ConvLayer("c", 64, 128, 16, 3, 16)
    g = build_training_graph([ly], batch=1)
    opa = [n for n in g.nodes if n.kind == "opa"][0]
    assert opa.reps == 16 * 16  # §5.4.2: n^2 outer-product iterations
    jg = JG.build_training_graph(_jlayers([ly]), batch=1)
    assert [(n.kind, n.reps, n.n_elems, n.tag) for n in g.nodes] == [(n.kind, n.reps, n.n_elems, n.tag)
                                                                     for n in jg.nodes]


def test_placement_round_robin():
    g = build_training_graph(MLP_L4, batch=1)
    hw = Hierarchy()
    pl = partition_and_place(g, hw)
    mcus = [t.mcu for tiles in pl.values() for t in tiles]
    assert len(set(mcus)) == len(mcus)  # distinct MCUs while capacity lasts
    assert max(mcus) < hw.n_mcus
    jpl = JC.partition_and_place(JG.build_training_graph(JG.MLP_L4, batch=1), JC.Hierarchy())
    assert {k: [dataclasses.astuple(t) for t in v] for k, v in pl.items()} == \
        {k: [dataclasses.astuple(t) for t in v] for k, v in jpl.items()}


def test_compile_model_raises_removed():
    with pytest.raises(RuntimeError, match="plan_compile.compile_plan"):
        compile_model(MLP_L4, batch=1, variant="v2")
    with pytest.raises(RuntimeError, match="plan_compile.compile_plan"):
        JC.compile_model(JG.MLP_L4, batch=1, variant="v2")


@pytest.mark.parametrize("variant", ["v1", "v2", "v3"])
def test_compile_fuses_mcu_ops(variant):
    """The reference's checks at v2; at every variant the fused streams and
    every instruction's fields equal the reference's."""
    g, pl, prog = _compile_layers(MLP_L4, batch=1, variant=variant)
    if variant == "v2":
        mcu_instrs = [i for instrs in prog.cores.values() for i in instrs if i.op is Opcode.MCU]
        # fusion must pack some multi-op instructions
        assert any(len(i.mcu_ops) > 1 for i in mcu_instrs)
    # every core stream ends with halt
    for instrs in prog.cores.values():
        assert instrs[-1].op is Opcode.HALT
    _, _, jprog = JC._compile_layers(JG.MLP_L4, batch=1, variant=variant)
    assert _stream(prog) == _stream(jprog)
    assert _ops(prog) == _ops(jprog)
    assert prog.total_instrs() == jprog.total_instrs()


def test_deferred_opa_semantics_v2():
    """V1/V2: OPA operands stored to shared memory, applied at halt (§5.2)."""
    g, pl, prog = _compile_layers(MLP_L4, batch=1, variant="v2")
    all_instrs = [i for instrs in prog.cores.values() for i in instrs]
    stores = [i for i in all_instrs if i.op is Opcode.STORE and "save" in i.tag]
    halts_opa = [i for i in all_instrs if i.op is Opcode.MCU and "halt" in i.tag]
    assert stores and halts_opa
    _, _, jprog = JC._compile_layers(JG.MLP_L4, batch=2, variant="v2")
    assert _stream(_compile_layers(MLP_L4, batch=2, variant="v2")[2]) == _stream(jprog)


def test_v3_no_deferred_stores():
    g, pl, prog = _compile_layers(MLP_L4, batch=1, variant="v3")
    all_instrs = [i for instrs in prog.cores.values() for i in instrs]
    assert not any(i.op is Opcode.STORE and "save" in i.tag for i in all_instrs)
    _, _, jprog = JC._compile_layers(_jlayers(VGG16[:3]), batch=1, variant="v3")
    assert _stream(_compile_layers(VGG16[:3], batch=1, variant="v3")[2]) == _stream(jprog)


@pytest.mark.parametrize("system", ["panther", "base_digital", "base_mvm"])
def test_simulator_energy_positive_and_decomposed(system):
    _, _, prog = _compile_layers(MLP_L4, batch=1)
    r = simulate(prog, system=system)
    cats = r.energy_by_category()
    assert cats["mvm"] > 0 and cats["mtvm"] > 0 and cats["opa"] > 0
    assert r.time_ns > 0
    jr = JS.simulate(JC._compile_layers(JG.MLP_L4, batch=1)[2], system=system)
    assert _dict_close(r.energy_nj, jr.energy_nj) and _dict_close(r.per_core_ns, jr.per_core_ns)
    assert _close(r.time_ns, jr.time_ns) and _close(r.total_energy_nj, jr.total_energy_nj)
    assert _dict_close(cats, jr.energy_by_category())


# ------------------------- paper-claim gates --------------------------------


def test_fc_sgd_energy_ratio_in_paper_band():
    """§7.3: FC layers 31.03-54.21x vs Base_mvm at SGD."""
    for ly, jly in zip(MLP_L4, JG.MLP_L4):
        p = sum(layer_energy(ly, "panther", 1).values())
        m = sum(layer_energy(ly, "base_mvm", 1).values())
        assert 25 <= m / p <= 60, (ly.name, m / p)
        assert _close(p, sum(JS.layer_energy(jly, "panther", 1).values()))
        assert _close(m, sum(JS.layer_energy(jly, "base_mvm", 1).values()))


def test_digital_energy_ratio_in_paper_band():
    """§7.3: 7.01-8.02x vs Base_digital; every layer's categories, every
    system, both variants, the reference's."""
    for model in (MLP_L4, VGG16):
        for ly, jly in zip(model, _jlayers(model)):
            p = sum(layer_energy(ly, "panther", 1).values())
            d = sum(layer_energy(ly, "base_digital", 1).values())
            assert 6.0 <= d / p <= 9.0, (ly.name, d / p)
            for system in SYSTEMS:
                for variant in ("v2", "v3"):
                    assert _dict_close(layer_energy(ly, system, 1, variant=variant),
                                       JS.layer_energy(jly, system, 1, variant=variant)), (ly.name, system)
            assert (_layer_tiles(ly), _layer_reps(ly)) == (JS._layer_tiles(jly), JS._layer_reps(jly))


def test_minibatch_fc_ratio_in_paper_band():
    """§7.4: FC 1.61-2.16x vs Base_mvm at batch 64 (write amortized)."""
    for ly, jly in zip(MLP_L4, JG.MLP_L4):
        p = sum(layer_energy(ly, "panther", 64).values())
        m = sum(layer_energy(ly, "base_mvm", 64).values())
        assert 1.3 <= m / p <= 2.6, (ly.name, m / p)
        for system in SYSTEMS:
            assert _dict_close(layer_energy(ly, system, 64, crs_period=16),
                               JS.layer_energy(jly, system, 64, crs_period=16))


def test_large_batch_ratio_approaches_opa_advantage():
    """§7.4: at batch 1024 writes fully amortize -> ~1.18x."""
    ly = MLP_L4[0]
    p = sum(layer_energy(ly, "panther", 1024).values())
    m = sum(layer_energy(ly, "base_mvm", 1024).values())
    assert 1.05 <= m / p <= 1.4, m / p
    assert _close(m / p, sum(JS.layer_energy(JG.MLP_L4[0], "base_mvm", 1024).values())
                  / sum(JS.layer_energy(JG.MLP_L4[0], "panther", 1024).values()))


def test_exec_time_faster_than_all_baselines():
    """§7.5: consistently lower execution time."""
    for model in (MLP_L4, VGG16):
        for batch in (1, 64, 1024):
            t = {s: model_report(model, s, batch)["time_ns"] for s in SYSTEMS}
            assert t["panther"] < min(t["base_digital"], t["base_mvm"], t["base_opa_mvm"])
            for s in SYSTEMS:
                jr = JS.model_report(_jlayers(model), s, batch)
                assert _dict_close(model_report(model, s, batch), jr), (s, batch)
                assert all(_close(layer_time(ly, s, batch, variant=v), JS.layer_time(jly, s, batch, variant=v))
                           for ly, jly in zip(model, _jlayers(model)) for v in ("v1", "v2", "v3"))


def test_v2_vs_v3_tradeoff():
    """§7.6: V3's commit writes cost energy at small batch; V2 needs shared
    memory that grows with batch."""
    ly = MLP_L4[1]
    e2_small = sum(layer_energy(ly, "panther", 1, variant="v2").values())
    e3_small = sum(layer_energy(ly, "panther", 1, variant="v3").values())
    assert e2_small < e3_small
    m2 = layer_energy(ly, "panther", 4096, variant="v2").get("mem", 0)
    m3 = layer_energy(ly, "panther", 4096, variant="v3").get("mem", 0)
    assert m2 > 0 and m3 == 0  # V3 eliminates the shared-memory saves
    jly = JG.MLP_L4[1]
    assert _close(e2_small, sum(JS.layer_energy(jly, "panther", 1, variant="v2").values()))
    assert _close(e3_small, sum(JS.layer_energy(jly, "panther", 1, variant="v3").values()))
    assert _close(m2, JS.layer_energy(jly, "panther", 4096, variant="v2").get("mem", 0))
