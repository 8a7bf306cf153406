"""``repro_torch.isa.energy`` against ``repro.isa.energy``: host arithmetic,
so every constant, field and method result is held exactly (==), over Fig
10's nine slice specs and the paper's, IO widths 8/12/16, ADC None/6/9, and
both write kinds."""
from __future__ import annotations

import dataclasses
import itertools

import pytest

pytest.importorskip("torch")

from repro.isa import energy as J  # noqa: E402
from repro_torch.benchmarks.fig10_hetero import CONFIGS  # noqa: E402
from repro_torch.isa import energy as T  # noqa: E402

BITS = [tuple(int(c) for c in name) for name in CONFIGS] + [J.PAPER_BITS]


def test_constants_and_defaults_are_the_reference_s():
    for name in ("XBAR", "CELLS", "PAPER_BITS", "ROW_BITS", "IO_CYCLES_REF"):
        assert getattr(T, name) == getattr(J, name), name
    assert dataclasses.asdict(T.DEFAULT_ENERGY) == dataclasses.asdict(J.DEFAULT_ENERGY)
    assert dataclasses.asdict(T.DEFAULT_GPU) == dataclasses.asdict(J.DEFAULT_GPU)
    assert [f.name for f in dataclasses.fields(T.EnergyModel)] == [f.name for f in dataclasses.fields(J.EnergyModel)]
    assert [f.name for f in dataclasses.fields(T.GPUModel)] == [f.name for f in dataclasses.fields(J.GPUModel)]


@pytest.mark.parametrize("bits", BITS, ids=["".join(map(str, b)) for b in BITS])
def test_packed_pricing_equals_the_reference(bits):
    for io, adc in itertools.product((8, 12, 16), (None, 6, 9)):
        assert T.DEFAULT_ENERGY.mvm_packed(bits, io, adc) == J.DEFAULT_ENERGY.mvm_packed(bits, io, adc), (io, adc)
        assert T.DEFAULT_ENERGY._adc_weight(bits, io, adc) == J.DEFAULT_ENERGY._adc_weight(bits, io, adc)
    for b, adc in itertools.product(bits, (None, 6, 9, 20)):
        assert T.adc_eff_bits(b, adc) == J.adc_eff_bits(b, adc)


def test_tile_op_and_gpu_pricing_equal_the_reference():
    for em_t, em_j in ((T.DEFAULT_ENERGY, J.DEFAULT_ENERGY),
                       (T.EnergyModel(adc_sample_exp=0.7, verify_frac=0.5), J.EnergyModel(adc_sample_exp=0.7,
                                                                                          verify_frac=0.5))):
        assert em_t.mvm_panther() == em_j.mvm_panther() and em_t.mvm_base() == em_j.mvm_base()
        for nonideal in (False, True):
            assert em_t.opa_panther(nonideal) == em_j.opa_panther(nonideal)
        assert em_t.mvm_packed() == em_j.mvm_packed()
    for flops, nbytes, batch in itertools.product((1e6, 3.2e9, 1e12), (1e3, 4e8), (1, 32, 256, 1024)):
        assert T.DEFAULT_GPU.step_time_energy(flops, nbytes, batch) == J.DEFAULT_GPU.step_time_energy(
            flops, nbytes, batch)
    # the packed pricing reduces to the §6.3-taxed anchor at the paper's default
    assert T.DEFAULT_ENERGY.mvm_packed()[0] == T.DEFAULT_ENERGY.mvm_panther()[0]
