"""The hand-written CUDA kernel against its plain PyTorch version, on the
card. These tests need an NVIDIA Hopper card and ``nvcc``; without them they
skip (a CUDA kernel has no interpret mode). Run them on the card with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerance: ``max|kernel - plain| <= 1e-3 * (1 + max|plain|)``; at finite ADC
the two sum in the same order and agree bit for bit.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("adc", [9, 6, None])
@pytest.mark.parametrize("m,n,b", [(2048, 2560, 5), (16384, 2048, 4), (320, 2048, 16), (256, 100, 3)])
def test_kernel_matches_plain(card, adc, m, n, b):
    from repro_torch.core.fixed_point import choose_frac_bits
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.kernels.sliced_mvm import ref

    g = torch.Generator(device=card).manual_seed(m + n + b)
    planes = torch.randint(-8, 8, (8, m, n), generator=g, device=card, dtype=torch.int8)
    x = torch.randn((b, m), generator=g, device=card)
    xf = choose_frac_bits(x, word_bits=16, margin_bits=1, clip_to_word=False).reshape(1)
    before = K.mvm_sliced_fused.launches
    got = K.mvm_sliced_fused(planes, x, xf, spec=DEFAULT_SPEC, adc_bits=adc)
    want = ref.mvm_sliced_fused_ref(planes, x, xf[0], DEFAULT_SPEC, 16, adc)
    torch.cuda.synchronize()
    assert K.mvm_sliced_fused.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-3 * (1.0 + float(want.abs().max()))
    if adc is not None:
        assert torch.equal(got, want)


def test_fidelity_read_on_the_card_goes_through_the_kernel(card):
    from repro_torch.core.mvm import fidelity_read
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.models.common import FidelityConfig

    g = torch.Generator(device=card).manual_seed(1)
    planes = torch.randint(-8, 8, (8, 256, 128), generator=g, device=card, dtype=torch.int8)
    x = torch.randn((2, 3, 256), generator=g, device=card, dtype=torch.bfloat16)
    before = K.mvm_sliced_fused.launches
    y = fidelity_read(planes, torch.tensor(30, device=card, dtype=torch.int32), x, FidelityConfig(adc_bits_fwd=9))
    y_cpu = fidelity_read(planes.cpu(), 30, x.cpu(), FidelityConfig(adc_bits_fwd=9))
    assert K.mvm_sliced_fused.launches == before + 1
    assert tuple(y.shape) == (2, 3, 128) and torch.equal(y.cpu(), y_cpu)
