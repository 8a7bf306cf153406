"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. These tests need an NVIDIA Hopper card and ``nvcc``; without them
they skip (a CUDA kernel has no interpret mode). Run them on the card with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerance: the reads within ``max|kernel - plain| <= 1e-3 * (1 + max|plain|)``,
and at finite ADC bit for bit (the two sum in the same order); the update
kernels bit for bit (``opa_fused`` on f32-exact operands, where every
contraction order gives the same sums).
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


@pytest.mark.parametrize("adc", [9, 6, None])
@pytest.mark.parametrize("m,n,b", [(2048, 2560, 5), (16384, 2048, 16), (2048, 320, 4), (100, 256, 3)])
def test_transpose_kernel_matches_plain(card, adc, m, n, b):
    from repro_torch.core.fixed_point import choose_frac_bits
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.kernels.sliced_mvm import ref

    g = torch.Generator(device=card).manual_seed(m + n + b)
    planes = torch.randint(-8, 8, (8, m, n), generator=g, device=card, dtype=torch.int8)
    dy = torch.randn((b, n), generator=g, device=card)
    xf = choose_frac_bits(dy, word_bits=16, margin_bits=1, clip_to_word=False).reshape(1)
    before = K.mvm_sliced_fused.transpose_launches
    got = K.mvm_sliced_fused(planes, dy, xf, spec=DEFAULT_SPEC, adc_bits=adc, transpose=True)
    want = ref.mvm_sliced_fused_ref(planes, dy, xf[0], DEFAULT_SPEC, 16, adc, transpose=True)
    torch.cuda.synchronize()
    assert K.mvm_sliced_fused.transpose_launches == before + 1
    assert tuple(got.shape) == (b, m)
    assert float((got - want).abs().max()) <= 1e-3 * (1.0 + float(want.abs().max()))
    if adc is not None:
        assert torch.equal(got, want)


def _full_range_planes(card, shape, g):
    from repro_torch.core.slicing import DEFAULT_SPEC

    return torch.stack([torch.randint(-m, m + 1, shape, generator=g, device=card, dtype=torch.int32)
                        for m in DEFAULT_SPEC.plane_max]).to(torch.int8)


@pytest.mark.parametrize("m,n", [(2048, 2560), (320, 100)])
def test_crs_and_opa_deposit_kernels_match_plain(card, m, n):
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.crs import ref as RC
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO

    g = torch.Generator(device=card).manual_seed(m + n)
    planes = _full_range_planes(card, (m, n), g)
    assert torch.equal(KC.crs(planes.clone(), spec=DEFAULT_SPEC), RC.crs_ref(planes, DEFAULT_SPEC))
    p_q = torch.randint(-2**31, 2**31, (m, n), generator=g, device=card, dtype=torch.int64).to(torch.int32)
    want = RO.opa_deposit_ref(planes, p_q, DEFAULT_SPEC)
    assert torch.equal(KO.opa_deposit(planes.clone(), p_q, spec=DEFAULT_SPEC), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,t,keyed", [(2048, 2560, 100, True), (2048, 16384, 256, False), (320, 100, 37, True)])
def test_opa_fused_kernel_matches_plain_on_exact_operands(card, dtype, m, n, t, keyed):
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO

    g = torch.Generator(device=card).manual_seed(m + n + t)
    planes = _full_range_planes(card, (m, n), g)
    x = (torch.randint(-4, 5, (t, m), generator=g, device=card) * 0.125).to(getattr(torch, dtype))
    dh = (torch.randint(-4, 5, (t, n), generator=g, device=card) * 2.0**-5).to(getattr(torch, dtype))
    words = (12345, -678) if keyed else None
    for lr, f in ((2.0**-4, 8), (4.0, 28)):
        frac = torch.tensor([f], dtype=torch.int32, device=card)
        before = KO.opa_fused.launches
        got = KO.opa_fused(planes.clone(), x, dh, lr, frac, spec=DEFAULT_SPEC, key_words=words)
        want = RO.opa_fused_ref(planes, x, dh, lr, frac[0], DEFAULT_SPEC, words)
        torch.cuda.synchronize()
        assert KO.opa_fused.launches == before + 1
        assert torch.equal(got, want)


def test_training_step_on_the_card_goes_through_every_kernel(card):
    from repro_torch import configs
    from repro_torch import plan as planlib
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.optim import PantherConfig
    from repro_torch.optim.schedules import constant
    from repro_torch.train.step import make_train_step, train_state_init

    cfg = configs.get_smoke("gemma_2b")
    opt = PantherConfig(crs_every=1)
    rules = planlib.default_rules(opt, fidelity=configs.fidelity_presets()["adc9"])
    state = train_state_init(cfg, opt, 0)
    counters = (K.mvm_sliced_fused, KO.opa_fused, KO.opa_deposit, KC.crs)
    before = [c.launches for c in counters] + [K.mvm_sliced_fused.transpose_launches]
    state, metrics = make_train_step(cfg, opt, constant(1e-2), plan_rules=rules)(
        state, SyntheticLMDataset(cfg.vocab, 8, 2).batch(0))
    after = [c.launches for c in counters] + [K.mvm_sliced_fused.transpose_launches]
    reads = 5 * cfg.n_layers
    assert [a - b for a, b in zip(after, before)] == [reads, reads, 1, reads + 1, reads]
    assert bool(torch.isfinite(metrics["loss"])) and bool(torch.isfinite(metrics["grad_norm"]))
