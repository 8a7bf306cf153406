"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. These tests need an NVIDIA Hopper card and ``nvcc``; without them
they skip (a CUDA kernel has no interpret mode). Run them on the card with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerance: the reads within ``max|kernel - plain| <= 1e-3 * (1 + max|plain|)``,
and at finite ADC bit for bit (the two sum in the same order); K4's
tensor-core body bit for bit against its plain version and against the dp4a
body (K5's dp4a instance, asked for by name) at every ADC; its decode body
bit for bit against its plain version at every ADC (the ideal one on
f32-exact digits), read after read, on two streams and replayed in a CUDA
graph; K5's tensor-core instances bit for bit against its dp4a instances at
every ADC, on any int32 input, and against its plain version at finite ADC;
the update kernels bit for bit (``opa_fused`` on f32-exact operands, where
every contraction order gives the same sums: its bf16 tensor-core body
against its plain version and its CUDA-core body; ``crs`` in place, at any
alignment, on two streams and replayed in a CUDA graph).
"""
from __future__ import annotations

import re
import subprocess
from pathlib import Path

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


def _misaligned(planes, offset):
    """A contiguous copy of planes ``offset`` bytes past a 16-byte boundary,
    and its buffer, zero around it."""
    buf = torch.zeros(planes.numel() + 32, dtype=torch.int8, device=planes.device)
    view = buf[offset:offset + planes.numel()].view(planes.shape)
    view.copy_(planes)
    return view, buf


# gemma-2b's layer blocks, 2^24 cells of the embedding, M·N off the
# 16-element grid, a ragged block, one shorter than a 16-byte group
CRS_SHAPES = [(2048, 2560), (2048, 2048), (2048, 16384), (16384, 2048), (8192, 2048), (33, 47), (320, 100),
              (3, 5)]


@pytest.mark.parametrize("m,n", CRS_SHAPES)
def test_crs_matches_plain_at_any_alignment(card, m, n):
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.crs import ref as RC

    g = torch.Generator(device=card).manual_seed(m * n)
    planes = _full_range_planes(card, (m, n), g)
    want = RC.crs_ref(planes, DEFAULT_SPEC)
    for offset in (0, 5, 15):
        view, buf = _misaligned(planes, offset)
        before = KC.crs.launches
        out = KC.crs(view, spec=DEFAULT_SPEC)
        torch.cuda.synchronize()
        assert out is view and KC.crs.launches == before + 1  # in place, counted
        assert torch.equal(view, want), (offset, int((view != want).sum()))
        assert not buf[:offset].any() and not buf[offset + view.numel():].any()


@pytest.mark.parametrize("S", range(1, 9))
def test_crs_takes_every_slice_count(card, S):
    # S from 1 to 8, narrow and wide slices, digits anywhere in int8
    from repro_torch.core.slicing import SliceSpec
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.crs import ref as RC

    g = torch.Generator(device=card).manual_seed(S)
    for spec in (SliceSpec.uniform(4, S), SliceSpec.uniform(8, S)):
        planes = torch.randint(-128, 128, (S, 97, 160), generator=g, device=card, dtype=torch.int32).to(torch.int8)
        want = RC.crs_ref(planes, spec)
        view, _ = _misaligned(planes, 3)
        KC.crs(view, spec=spec)
        torch.cuda.synchronize()
        assert torch.equal(view, want), spec.bits


def test_crs_on_two_streams_and_replayed_in_a_cuda_graph(card):
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.crs import ref as RC

    g = torch.Generator(device=card).manual_seed(19)
    blocks = [_full_range_planes(card, shape, g) for shape in ((2048, 2560), (320, 100), (33, 47))]
    wants = [RC.crs_ref(p, DEFAULT_SPEC) for p in blocks]
    # two streams, each block in place on its own copy
    streams = [torch.cuda.Stream(card), torch.cuda.Stream(card)]
    copies = [p.clone() for p in blocks * 2]
    torch.cuda.synchronize()
    for i, c in enumerate(copies):
        with torch.cuda.stream(streams[i % 2]):
            KC.crs(c, spec=DEFAULT_SPEC)
    torch.cuda.synchronize()
    assert all(torch.equal(c, (wants * 2)[i]) for i, c in enumerate(copies))
    # a graph: one eager launch on the capture stream first sets the
    # kernel's shared-memory limit; every replay canonicalizes the refilled
    # buffers in place
    work = [p.clone() for p in blocks]
    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(stream):
        KC.crs(blocks[0].clone(), spec=DEFAULT_SPEC)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for w in work:
            KC.crs(w, spec=DEFAULT_SPEC)
    for _ in range(3):
        for w, p in zip(work, blocks):
            w.copy_(p)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(w, want) for w, want in zip(work, wants))


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
    name = KO.instance_name(False, KO.body_for(x.dtype))
    for lr, f in ((2.0**-4, 8), (4.0, 28)):
        frac = torch.tensor([f], dtype=torch.int32, device=card)
        before = KO.opa_fused.launches, KO.opa_fused.instances[name]
        got = KO.opa_fused(planes.clone(), x, dh, lr, frac, spec=DEFAULT_SPEC, key_words=words)
        want = RO.opa_fused_ref(planes, x, dh, lr, frac[0], DEFAULT_SPEC, words)
        torch.cuda.synchronize()
        assert (KO.opa_fused.launches, KO.opa_fused.instances[name]) == (before[0] + 1, before[1] + 1)
        assert torch.equal(got, want)


def _exact_bf16_operands(card, t, m, n, g):
    """bf16 operands whose f32 contraction is exact in any order: small
    integers on a power-of-two grid (|partial sum| <= 16 on a 2^-8 grid)."""
    x = (torch.randint(-4, 5, (t, m), generator=g, device=card) * 0.125).to(torch.bfloat16)
    dh = (torch.randint(-4, 5, (t, n), generator=g, device=card) * 2.0**-5).to(torch.bfloat16)
    return x, dh


# (M, N): gemma-2b's attention block; N % 8 != 0 (element loads, scalar
# plane path); M % 8 != 0 and a short last tile of each axis
TC_SHAPES = [(2048, 2560), (320, 100), (100, 336)]


@pytest.mark.parametrize("physics", [None, "asym", "noise", "stuck", "all"])
@pytest.mark.parametrize("t", [1, 17, 100, 256])
@pytest.mark.parametrize("m,n", TC_SHAPES)
def test_tensor_core_opa_fused_matches_plain_on_exact_operands(card, physics, t, m, n):
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO
    from repro_torch.models.common import DeviceModel

    dev = None if physics is None else DeviceModel(**PHYSICS[physics])
    g = torch.Generator(device=card).manual_seed(m + n + t)
    planes = _full_range_planes(card, (m, n), g) if dev is None else _canonical_planes(card, (m, n), g)
    x, dh = _exact_bf16_operands(card, t, m, n, g)
    name = KO.instance_name(dev is not None, "mma")
    for lr, f in ((2.0**-4, 8), (4.0, 28)):
        frac = torch.tensor([f], dtype=torch.int32, device=card)
        for words in (None, (12345 + t, -678)):
            before = KO.opa_fused.instances[name]
            got = KO.opa_fused(planes.clone(), x, dh, lr, frac, spec=DEFAULT_SPEC, key_words=words, dev=dev,
                               noise_words=(77, -99))
            want = RO.opa_fused_ref(planes, x, dh, lr, frac[0], DEFAULT_SPEC, words, dev, (77, -99))
            torch.cuda.synchronize()
            assert KO.opa_fused.instances[name] == before + 1
            if dev is None or dev.write_noise == 0.0:
                assert torch.equal(got, want)
            else:  # a Gaussian's last bit may move one update by one grid LSB
                d = (_plane_values(got) - _plane_values(want)).abs()
                assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3


@pytest.mark.parametrize("physics", [None, "all"])
@pytest.mark.parametrize("m,n,t", [(2048, 16384, 256), (16384, 2048, 100), (320, 100, 17)])
def test_tensor_core_opa_fused_equals_the_cuda_core_body(card, physics, m, n, t):
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.models.common import DeviceModel

    dev = None if physics is None else DeviceModel(**PHYSICS[physics])
    g = torch.Generator(device=card).manual_seed(m + n + t)
    planes = _canonical_planes(card, (m, n), g)
    x, dh = _exact_bf16_operands(card, t, m, n, g)
    frac = torch.tensor([20], dtype=torch.int32, device=card)
    got = {body: KO.opa_fused(planes.clone(), x, dh, 3e-2, frac, spec=DEFAULT_SPEC, key_words=(5, 6), dev=dev,
                              noise_words=(7, 8), body=body) for body in ("mma", "fma")}
    assert torch.equal(got["mma"], got["fma"])


@pytest.mark.parametrize("m,n", [(2048, 2560), (320, 100)])
def test_tensor_core_stuck_mask_is_written_once_then_read(card, m, n):
    # the first launch at a block shape draws the stuck bits and caches
    # them; later launches read the cache; every launch equals the plain version
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO
    from repro_torch.models.common import DeviceModel

    dev = DeviceModel(stuck_frac=0.3, stuck_seed=11)
    g = torch.Generator(device=card).manual_seed(m * n)
    planes = _full_range_planes(card, (m, n), g)
    frac = torch.tensor([8], dtype=torch.int32, device=card)
    KO._STUCK_BITS.clear()
    for t in (17, 100):
        x, dh = _exact_bf16_operands(card, t, m, n, g)
        got = KO.opa_fused(planes.clone(), x, dh, 2.0**-4, frac, spec=DEFAULT_SPEC, key_words=(1, t), dev=dev)
        want = RO.opa_fused_ref(planes, x, dh, 2.0**-4, frac[0], DEFAULT_SPEC, (1, t), dev)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        (mask,) = KO._STUCK_BITS.values()
        assert torch.equal(mask, RO.stuck_bits_ref(dev, DEFAULT_SPEC, m, n, card))


def test_opa_fused_tensor_core_instances_run_hmma(card):
    from repro_torch.kernels import build
    from repro_torch.kernels.sliced_opa import kernel as KO

    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    lib = build.build("opa_fused", KO.SOURCES["opa_fused"]).path
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs = {f.split("\n", 1)[0].strip(): f for f in re.split(r"\n\s*Function : ", sass)[1:]}
    mma = [body for name, body in funcs.items() if "opa_mma_kernel" in name]
    fma = [body for name, body in funcs.items() if "opa_fused_kernel" in name]
    # ideal and device, each with the counter draw and with the grid/hw draws (FAR)
    assert len(mma) == 4 and all("HMMA" in body for body in mma)
    assert len(fma) == 4 and not any("HMMA" in body for body in fma)  # f32/bf16 x ideal/device


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
    ideal_before = dict(KO.opa_fused.instances)
    state, metrics = make_train_step(cfg, opt, constant(1e-2), plan_rules=rules)(
        state, SyntheticLMDataset(cfg.vocab, 8, 2).batch(0))
    after = [c.launches for c in counters] + [K.mvm_sliced_fused.transpose_launches]
    reads = 5 * cfg.n_layers
    assert [a - b for a, b in zip(after, before)] == [reads, reads, 1, reads + 1, reads]
    # bf16 operands: every block on the tensor-core body, none on the CUDA-core one
    assert {k: v - ideal_before.get(k, 0) for k, v in KO.opa_fused.instances.items()
            if v != ideal_before.get(k, 0)} == {"ideal": reads}
    assert bool(torch.isfinite(metrics["loss"])) and bool(torch.isfinite(metrics["grad_norm"]))


# ------------------- device physics, io widths 8/12, K5 ----------------------
# The write noise and the read offsets go through log1p/sqrt/cos: the plain
# version on the card calls the same CUDA math library as the kernels, so
# they are held bit for bit; where a Gaussian differs in its last bit, the
# differing elements are counted and must be within one grid LSB (updates)
# or one ADC code (reads).

PHYSICS = {
    "asym": dict(asym_up=1.2, asym_down=0.8),
    "noise": dict(write_noise=4.0),
    "stuck": dict(stuck_frac=0.02, stuck_seed=3),
    "all": dict(asym_up=1.2, asym_down=0.8, write_noise=4.0, stuck_frac=0.02, stuck_seed=3),
}


def _plane_values(planes):
    acc = planes[-1].to(torch.int64)
    for s in range(planes.shape[0] - 2, -1, -1):
        acc = acc * 16 + planes[s].to(torch.int64)
    return acc


def _canonical_planes(card, shape, g):
    """Canonical planes [S, *shape]; a stack is stored layer-major, as
    ``optim.panther`` stores it, so each layer's block is contiguous."""
    from repro_torch.core.slicing import DEFAULT_SPEC, slice_weights

    q = torch.randint(-2**27, 2**27, shape, generator=g, device=card, dtype=torch.int32)
    lead = len(shape) - 2
    return slice_weights(q, DEFAULT_SPEC).movedim(0, lead).contiguous().movedim(lead, 0)


@pytest.mark.parametrize("physics", list(PHYSICS))
@pytest.mark.parametrize("m,n,t,keyed", [(2048, 2560, 100, True), (320, 100, 37, False)])
def test_opa_fused_device_instance_matches_plain(card, physics, m, n, t, keyed):
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO
    from repro_torch.models.common import DeviceModel

    dev = DeviceModel(**PHYSICS[physics])
    g = torch.Generator(device=card).manual_seed(m + n + t)
    planes = _canonical_planes(card, (m, n), g)
    x = torch.randint(-4, 5, (t, m), generator=g, device=card) * 0.125
    dh = torch.randint(-4, 5, (t, n), generator=g, device=card) * 2.0**-5
    words = (12345, -678) if keyed else None
    name = KO.instance_name(True, KO.body_for(x.dtype))  # f32 operands: the CUDA-core body
    for lr, f in ((2.0**-4, 8), (3e-2, 20)):
        frac = torch.tensor([f], dtype=torch.int32, device=card)
        before = KO.opa_fused.instances[name]
        got = KO.opa_fused(planes.clone(), x, dh, lr, frac, spec=DEFAULT_SPEC, key_words=words, dev=dev,
                           noise_words=(77, -99))
        want = RO.opa_fused_ref(planes, x, dh, lr, frac[0], DEFAULT_SPEC, words, dev, (77, -99))
        torch.cuda.synchronize()
        assert KO.opa_fused.instances[name] == before + 1
        d = (_plane_values(got) - _plane_values(want)).abs()
        print(f"{physics} lr={lr}: {int((d > 0).sum())} of {d.numel()} elements differ")
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
        if dev.write_noise == 0.0:
            assert torch.equal(got, want)


@pytest.mark.parametrize("m,n", [(2048, 2560), (18, 2048), (320, 100)])
def test_opa_deposit_stuck_instance_matches_plain(card, m, n):
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO
    from repro_torch.models.common import DeviceModel

    g = torch.Generator(device=card).manual_seed(m + n)
    planes = _full_range_planes(card, (m, n), g)
    p_q = torch.randint(-2**31, 2**31, (m, n), generator=g, device=card, dtype=torch.int64).to(torch.int32)
    for frac in (0.02, 0.5):
        dev = DeviceModel(stuck_frac=frac, stuck_seed=3)
        want = RO.opa_deposit_ref(planes, p_q, DEFAULT_SPEC)
        want = torch.where(RO.stuck_mask_ref(dev, DEFAULT_SPEC, planes.shape, card), planes, want)
        before = KO.opa_deposit.instances["stuck"]
        got = KO.opa_deposit(planes.clone(), p_q, spec=DEFAULT_SPEC, stuck=dev)
        torch.cuda.synchronize()
        assert KO.opa_deposit.instances["stuck"] == before + 1
        assert torch.equal(got, want)


def test_opa_device_update_on_the_card_matches_the_cpu(card):
    from repro_torch.core import prng
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels import sliced_opa as ops
    from repro_torch.models.common import DeviceModel

    dev = DeviceModel(**PHYSICS["all"])
    g = torch.Generator(device=card).manual_seed(5)
    planes = _canonical_planes(card, (2, 384, 256), g)
    grad = torch.randn((2, 384, 256), generator=g, device=card) * 1e-3
    got = ops.opa_device_update(planes.clone(), grad, 3e-2, 24, DEFAULT_SPEC, device=dev, stochastic=True,
                                key=prng.PRNGKey(3))
    want = ops.opa_device_update(planes.cpu(), grad.cpu(), 3e-2, 24, DEFAULT_SPEC, device=dev, stochastic=True,
                                 key=prng.PRNGKey(3))
    d = (_plane_values(got.cpu()) - _plane_values(want)).abs()
    print(f"opa_device_update card vs CPU: {int((d > 0).sum())} of {d.numel()} elements differ")
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3


def test_an_all_ideal_device_runs_the_ideal_instances(card):
    from repro_torch.core import prng
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels import sliced_mvm, sliced_opa
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.models.common import DeviceModel

    g = torch.Generator(device=card).manual_seed(9)
    planes = _canonical_planes(card, (2, 256, 128), g)
    x = torch.randint(-4, 5, (2, 16, 256), generator=g, device=card) * 0.125
    dh = torch.randint(-4, 5, (2, 16, 128), generator=g, device=card) * 2.0**-5
    outs = []
    ideal, device_fma = KO.instance_name(False, "fma"), KO.instance_name(True, "fma")  # f32 operands
    for device in (None, DeviceModel()):
        before = dict(KO.opa_fused.instances)
        p = planes.clone()
        sliced_opa.opa_fused_update(p, x, dh, 3e-2, 20, DEFAULT_SPEC, stochastic=True, key=prng.PRNGKey(1),
                                    device=device)
        assert KO.opa_fused.instances[ideal] == before.get(ideal, 0) + 2
        assert KO.opa_fused.instances[device_fma] == before.get(device_fma, 0)
        before = dict(K.mvm_sliced_fused.instances)
        y = sliced_mvm.mvm_sliced_fused(p[:, 0], x[0], 12, DEFAULT_SPEC, adc_bits=9, device=device)
        assert K.mvm_sliced_fused.instances["io16"] == before.get("io16", 0) + 1
        outs.append((p, y))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def _read_case(card, m, n, b, transpose, io_bits, seed):
    from repro_torch.core.fixed_point import choose_frac_bits

    g = torch.Generator(device=card).manual_seed(seed)
    planes = torch.randint(-8, 8, (8, m, n), generator=g, device=card, dtype=torch.int8)
    x = torch.randn((b, n if transpose else m), generator=g, device=card)
    xf = choose_frac_bits(x, word_bits=io_bits, margin_bits=1, clip_to_word=False).reshape(1)
    return planes, x, xf


@pytest.mark.parametrize("adc", [9, 6, None])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("m,n,b", [(2048, 2560, 5), (320, 100, 16)])
def test_noisy_read_matches_plain(card, adc, transpose, m, n, b):
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.kernels.sliced_mvm import ref
    from repro_torch.models.common import DeviceModel

    dev = DeviceModel(read_noise=0.01, stuck_seed=3)
    planes, x, xf = _read_case(card, m, n, b, transpose, 16, m + n + b)
    name = K.instance_name(transpose, 16, True)
    before = K.mvm_sliced_fused.instances[name]
    got = K.mvm_sliced_fused(planes, x, xf, spec=DEFAULT_SPEC, adc_bits=adc, transpose=transpose, dev=dev,
                             tile0=3, col0=7)
    want = ref.mvm_sliced_fused_ref(planes, x, xf[0], DEFAULT_SPEC, 16, adc, transpose=transpose, device=dev,
                                    tile0=3, col0=7)
    torch.cuda.synchronize()
    assert K.mvm_sliced_fused.instances[name] == before + 1
    assert float((got - want).abs().max()) <= 1e-3 * (1.0 + float(want.abs().max()))
    assert torch.equal(got, want)


@pytest.mark.parametrize("io_bits", [8, 12])
@pytest.mark.parametrize("adc", [9, 6, None])
@pytest.mark.parametrize("transpose", [False, True])
def test_io_bits_8_and_12_match_plain(card, io_bits, adc, transpose):
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.kernels.sliced_mvm import ref

    planes, x, xf = _read_case(card, 2048, 2560, 5, transpose, io_bits, io_bits)
    name = K.instance_name(transpose, io_bits)
    before = K.mvm_sliced_fused.instances[name]
    got = K.mvm_sliced_fused(planes, x, xf, spec=DEFAULT_SPEC, io_bits=io_bits, adc_bits=adc, transpose=transpose)
    want = ref.mvm_sliced_fused_ref(planes, x, xf[0], DEFAULT_SPEC, io_bits, adc, transpose=transpose)
    torch.cuda.synchronize()
    assert K.mvm_sliced_fused.instances[name] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("io_bits", [8, 12, 16])
@pytest.mark.parametrize("adc", [9, 6, None])
@pytest.mark.parametrize("transpose", [False, True])
def test_mvm_sliced_kernel_matches_plain(card, io_bits, adc, transpose):
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels import sliced_mvm
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.kernels.sliced_mvm import ref

    g = torch.Generator(device=card).manual_seed(io_bits)
    m, n = 320, 2048
    planes = torch.randint(-8, 8, (8, m, n), generator=g, device=card, dtype=torch.int8)
    lim = 2 ** (io_bits - 1) - 1
    x_q = torch.randint(-lim, lim + 1, (2, 3, n if transpose else m), generator=g, device=card, dtype=torch.int32)
    before = (K.mvm_sliced.launches, K.mvm_sliced.transpose_launches)
    got = sliced_mvm.mvm_sliced_batched(planes, x_q, DEFAULT_SPEC, io_bits=io_bits, adc_bits=adc,
                                        transpose=transpose)
    want = ref.mvm_sliced_ref(planes, x_q.reshape(6, -1), DEFAULT_SPEC, io_bits, adc, transpose=transpose)
    torch.cuda.synchronize()
    after = (K.mvm_sliced.launches, K.mvm_sliced.transpose_launches)
    assert after == (before[0] + (not transpose), before[1] + transpose)
    assert tuple(got.shape) == (2, 3, m if transpose else n)
    assert torch.equal(got.reshape(6, -1), want)


def test_device_training_step_on_the_card_goes_through_every_kernel(card):
    import dataclasses

    from repro_torch import configs
    from repro_torch import plan as planlib
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.models.common import DeviceModel
    from repro_torch.optim import PantherConfig
    from repro_torch.optim.schedules import constant
    from repro_torch.train.step import make_train_step, train_state_init

    cfg = configs.get_smoke("gemma_2b")
    opt = PantherConfig(crs_every=1)
    dev = DeviceModel(write_noise=4e6, asym_up=1.2, asym_down=0.8, stuck_frac=0.02, stuck_seed=3, read_noise=0.01)
    fid = dataclasses.replace(configs.fidelity_presets()["adc9"], device=dev)
    state = train_state_init(cfg, opt, 0)
    before = {c: dict(c.instances) for c in (K.mvm_sliced_fused, KO.opa_fused, KO.opa_deposit)}
    crs_before = KC.crs.launches
    state, metrics = make_train_step(cfg, opt, constant(1e-2), plan_rules=planlib.default_rules(opt, fidelity=fid))(
        state, SyntheticLMDataset(cfg.vocab, 8, 2).batch(0))
    reads = 5 * cfg.n_layers
    got = {c: {k: v - before[c].get(k, 0) for k, v in c.instances.items() if v != before[c].get(k, 0)}
           for c in before}
    assert got[K.mvm_sliced_fused] == {"io16_read_noise": reads, "transpose_io16_read_noise": reads}
    assert got[KO.opa_fused] == {"device": reads}
    assert got[KO.opa_deposit] == {"stuck": 1}
    assert KC.crs.launches == crs_before + reads + 1
    assert bool(torch.isfinite(metrics["loss"])) and bool(torch.isfinite(metrics["grad_norm"]))


def _on_the_dac_grid(card, b, k, io_bits, g, frac=10):
    """x_q on the io_bits grid and x = x_q·2^-frac, which the DAC maps back
    to x_q exactly."""
    lim = 2 ** (io_bits - 1) - 1
    x_q = torch.randint(-lim, lim + 1, (b, k), generator=g, device=card, dtype=torch.int32)
    return x_q, x_q.float() * 2.0**-frac, torch.tensor([frac], dtype=torch.int32, device=card)


@pytest.mark.parametrize("b", [40, 200])
@pytest.mark.parametrize("io_bits", [8, 12, 16])
@pytest.mark.parametrize("adc", [9, 6, None])
@pytest.mark.parametrize("transpose", [False, True])
def test_tensor_core_read_equals_the_dp4a_body(card, b, io_bits, adc, transpose):
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_mvm import kernel as K

    g = torch.Generator(device=card).manual_seed(b + io_bits)
    m, n = 2048, 2560
    planes = torch.randint(-8, 8, (8, m, n), generator=g, device=card, dtype=torch.int8)
    x_q, x, xf = _on_the_dac_grid(card, b, n if transpose else m, io_bits, g)
    name = K.instance_name(transpose, io_bits)
    before = K.mvm_sliced_fused.instances[name]
    got = K.mvm_sliced_fused(planes, x, xf, spec=DEFAULT_SPEC, io_bits=io_bits, adc_bits=adc, transpose=transpose)
    # the yardstick: K5's dp4a instance, asked for by name
    dp4a = K.instance_name(transpose, io_bits, body="dp4a")
    before_dp4a = K.mvm_sliced.instances[dp4a]
    want = K.mvm_sliced(planes, x_q, spec=DEFAULT_SPEC, io_bits=io_bits, adc_bits=adc, transpose=transpose,
                        body="dp4a")
    torch.cuda.synchronize()
    assert K.mvm_sliced_fused.instances[name] == before + 1
    assert K.mvm_sliced.instances[dp4a] == before_dp4a + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("b", [1, 17, 33])
@pytest.mark.parametrize("m,n", [(300, 100), (200, 2080)])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("noisy", [False, True])
def test_tensor_core_read_on_ragged_edges(card, monkeypatch, b, m, n, transpose, noisy):
    # M and N multiples of neither the 128-row tile nor the 64-column block;
    # N = 100 also off the 16-byte loads. Every token count on the
    # tensor-core body, 1 included.
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.kernels.sliced_mvm import ref
    from repro_torch.models.common import DeviceModel

    monkeypatch.setattr(K, "DECODE_MAX_B", 0)
    dev = DeviceModel(read_noise=0.01, stuck_seed=3) if noisy else None
    planes, x, xf = _read_case(card, m, n, b, transpose, 16, m + n + b)
    for adc in (9, None):
        name = K.instance_name(transpose, 16, noisy)
        before = K.mvm_sliced_fused.instances[name]
        got = K.mvm_sliced_fused(planes, x, xf, spec=DEFAULT_SPEC, adc_bits=adc, transpose=transpose, dev=dev,
                                 tile0=2, col0=5)
        want = ref.mvm_sliced_fused_ref(planes, x, xf[0], DEFAULT_SPEC, 16, adc, transpose=transpose, device=dev,
                                        tile0=2, col0=5)
        torch.cuda.synchronize()
        assert K.mvm_sliced_fused.instances[name] == before + 1
        assert tuple(got.shape) == (b, m if transpose else n)
        assert torch.equal(got, want)


# ragged tokens, rows and columns: M and N multiples of neither the 128-row
# tile nor the 64-column block (N = 100 also off the 16-byte loads)
K5_CASES = [(2048, 2560, 40), (2048, 2560, 200), (300, 100, 17), (200, 2080, 33), (130, 36, 5)]


@pytest.mark.parametrize("io_bits", [8, 12, 16])
@pytest.mark.parametrize("adc", [9, 6, None])
@pytest.mark.parametrize("transpose", [False, True])
def test_k5_tensor_core_body_matches_the_dp4a_body_and_plain(card, io_bits, adc, transpose):
    # every K5 tensor-core instance, on x_q on the DAC grid and on any int32
    # (+-2^15, +-2^20, INT_MIN, ...: the bits at and above io-1 are not
    # streamed), bit for bit against the dp4a instance; at finite ADC also
    # against the plain version
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.kernels.sliced_mvm import ref

    g = torch.Generator(device=card).manual_seed(io_bits + 100 * transpose)
    name = K.instance_name(transpose, io_bits)
    for m, n, b in K5_CASES:
        planes = torch.randint(-8, 8, (8, m, n), generator=g, device=card, dtype=torch.int8)
        k = n if transpose else m
        lim = 2 ** (io_bits - 1) - 1
        x_q = torch.randint(-lim, lim + 1, (b, k), generator=g, device=card, dtype=torch.int32)
        wild = torch.randint(-2**31, 2**31, (b, k), generator=g, device=card, dtype=torch.int64).to(torch.int32)
        wild[0, :5] = torch.tensor([2**15, -2**15, 2**20, -2**20, -2**31], dtype=torch.int32)
        for x in (x_q, wild):
            before = K.mvm_sliced.instances[name]
            got = K.mvm_sliced(planes, x, spec=DEFAULT_SPEC, io_bits=io_bits, adc_bits=adc, transpose=transpose)
            dp4a = K.mvm_sliced(planes, x, spec=DEFAULT_SPEC, io_bits=io_bits, adc_bits=adc, transpose=transpose,
                                body="dp4a")
            torch.cuda.synchronize()
            assert K.mvm_sliced.instances[name] == before + 1
            assert tuple(got.shape) == (b, m if transpose else n)
            assert torch.equal(got, dp4a), (m, n, b)
            if adc is not None:
                assert torch.equal(got, ref.mvm_sliced_ref(planes, x, DEFAULT_SPEC, io_bits, adc,
                                                           transpose=transpose)), (m, n, b)


def test_k5_reads_take_their_body_by_shape(card):
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_mvm import kernel as K

    g = torch.Generator(device=card).manual_seed(5)
    planes = torch.randint(-8, 8, (8, 256, 128), generator=g, device=card, dtype=torch.int8)
    for b in (1, K.DECODE_MAX_B, K.DECODE_MAX_B + 1, 64):
        for transpose in (False, True):
            x_q = torch.randint(-32767, 32768, (b, 128 if transpose else 256), generator=g, device=card,
                                dtype=torch.int32)
            body = K.body_for(b, transpose, fused=False)
            assert body == ("dp4a" if b <= K.DECODE_MAX_B else "mma")
            name = K.instance_name(transpose, 16, body=body)
            before = K.mvm_sliced.instances[name]
            K.mvm_sliced(planes, x_q, spec=DEFAULT_SPEC, adc_bits=9, transpose=transpose)
            assert K.mvm_sliced.instances[name] == before + 1
    with pytest.raises(ValueError):
        K.mvm_sliced(planes, x_q, spec=DEFAULT_SPEC, adc_bits=9, transpose=True, body="decode")


def test_decode_reads_take_the_decode_body_by_shape(card):
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_mvm import kernel as K

    g = torch.Generator(device=card).manual_seed(4)
    planes = torch.randint(-8, 8, (8, 256, 128), generator=g, device=card, dtype=torch.int8)
    for b in (K.DECODE_MAX_B, K.DECODE_MAX_B + 1):
        for transpose in (False, True):
            x_q, x, xf = _on_the_dac_grid(card, b, 128 if transpose else 256, 16, g)
            name = K.instance_name(transpose, 16, body=K.body_for(b, transpose))
            before = K.mvm_sliced_fused.instances[name]
            got = K.mvm_sliced_fused(planes, x, xf, spec=DEFAULT_SPEC, adc_bits=9, transpose=transpose)
            torch.cuda.synchronize()
            assert K.mvm_sliced_fused.instances[name] == before + 1
            assert torch.equal(got, K.mvm_sliced(planes, x_q, spec=DEFAULT_SPEC, adc_bits=9, transpose=transpose,
                                                 body="dp4a"))
    assert K.body_for(K.DECODE_MAX_B, False) == "decode" and K.body_for(K.DECODE_MAX_B, True) == "dp4a"
    assert K.body_for(K.DECODE_MAX_B + 1, False) == K.body_for(K.DECODE_MAX_B + 1, True) == "mma"


# gemma-2b's four read shapes and the edge shapes (a short last tile; a ragged N)
DECODE_SHAPES = [(2048, 2560), (2048, 2048), (2048, 16384), (16384, 2048), (320, 2048), (256, 100)]


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("adc", [9, None])
@pytest.mark.parametrize("io_bits", [8, 12, 16])
def test_decode_body_matches_plain(card, io_bits, adc, noisy):
    # every decode instance, bit for bit, at 1-4 tokens; the ideal ADC on
    # digits in [-2, 2], where the plain version's f32 sums are exact
    from repro_torch.core.fixed_point import choose_frac_bits
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.kernels.sliced_mvm import ref
    from repro_torch.models.common import DeviceModel

    dev = DeviceModel(read_noise=0.01, stuck_seed=3) if noisy else None
    name = K.instance_name(False, io_bits, noisy, body="decode")
    g = torch.Generator(device=card).manual_seed(io_bits)
    digit = 8 if adc is not None else 2
    for m, n in DECODE_SHAPES:
        planes = torch.randint(-digit, digit + 1, (8, m, n), generator=g, device=card, dtype=torch.int8)
        for b in (1, 2, 3, 4):
            x = torch.randn((b, m), generator=g, device=card)
            xf = choose_frac_bits(x, word_bits=io_bits, margin_bits=1, clip_to_word=False).reshape(1)
            before = K.mvm_sliced_fused.instances[name]
            got = K.mvm_sliced_fused(planes, x, xf, spec=DEFAULT_SPEC, io_bits=io_bits, adc_bits=adc, dev=dev,
                                     tile0=2, col0=5)
            want = ref.mvm_sliced_fused_ref(planes, x, xf[0], DEFAULT_SPEC, io_bits, adc, device=dev, tile0=2,
                                            col0=5)
            torch.cuda.synchronize()
            assert K.mvm_sliced_fused.instances[name] == before + 1
            assert torch.equal(got, want), (m, n, b)


def test_decode_reads_repeated_and_on_two_streams_give_the_same_bits(card):
    # the tickets reset after every read, and two streams hold their own
    from repro_torch.core.fixed_point import choose_frac_bits
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.kernels.sliced_mvm import ref

    g = torch.Generator(device=card).manual_seed(18)
    reads = []
    for m, n in ((16384, 2048), (2048, 16384), (256, 100)):
        planes = torch.randint(-8, 8, (8, m, n), generator=g, device=card, dtype=torch.int8)
        x = torch.randn((4, m), generator=g, device=card)
        xf = choose_frac_bits(x, word_bits=16, margin_bits=1, clip_to_word=False).reshape(1)
        reads.append((planes, x, xf, ref.mvm_sliced_fused_ref(planes, x, xf[0], DEFAULT_SPEC, 16, 9)))
    outs = [K.mvm_sliced_fused(p, x, xf, spec=DEFAULT_SPEC, adc_bits=9) for _ in range(3) for p, x, xf, _ in reads]
    streams = [torch.cuda.Stream(card), torch.cuda.Stream(card)]
    torch.cuda.synchronize()
    on_streams = []
    for _ in range(3):
        for i, (p, x, xf, _) in enumerate(reads * 2):
            with torch.cuda.stream(streams[i % 2]):
                on_streams.append(K.mvm_sliced_fused(p, x, xf, spec=DEFAULT_SPEC, adc_bits=9))
    torch.cuda.synchronize()
    wants = [want for _, _, _, want in reads]
    assert all(torch.equal(o, wants[i % 3]) for i, o in enumerate(outs))
    assert all(torch.equal(o, (wants * 2)[i % 6]) for i, o in enumerate(on_streams))
    assert all(int(t.abs().sum()) == 0 for t in K._TICKETS.values())


def test_decode_reads_replay_in_a_cuda_graph(card):
    # what a graph around the decode step needs of the decode body: one read
    # on the capture stream beforehand makes its tickets and sets its
    # shared-memory limit, so the capture only records the launch; every
    # replay gives the eager read's bits and leaves the tickets at 0
    from repro_torch.core.fixed_point import choose_frac_bits
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.models.common import DeviceModel

    g = torch.Generator(device=card).manual_seed(6)
    dev = DeviceModel(read_noise=0.01, stuck_seed=3)
    reads = []
    for (m, n), d in (((2048, 16384), None), ((16384, 2048), dev), ((320, 2048), None)):
        planes = torch.randint(-8, 8, (8, m, n), generator=g, device=card, dtype=torch.int8)
        x = torch.randn((4, m), generator=g, device=card)
        xf = choose_frac_bits(x, word_bits=16, margin_bits=1, clip_to_word=False).reshape(1)
        reads.append((planes, x, xf, d))

    def run():
        return [K.mvm_sliced_fused(p, x, xf, spec=DEFAULT_SPEC, adc_bits=9, dev=d, tile0=2, col0=5)
                for p, x, xf, d in reads]

    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(stream):
        wants = run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = K.mvm_sliced_fused.instances["io16_decode"]
    with torch.cuda.graph(graph, stream=stream):
        outs = run()
    assert K.mvm_sliced_fused.instances["io16_decode"] == before + 2  # counted once, at capture
    for _ in range(3):
        for o in outs:
            o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, w) for o, w in zip(outs, wants))
    assert all(int(t.abs().sum()) == 0 for t in K._TICKETS.values())


def test_decode_read_refuses_fewer_tickets_than_column_blocks(card, monkeypatch):
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_mvm import kernel as K

    planes = torch.zeros((8, 256, 100), device=card, dtype=torch.int8)
    x = torch.ones((4, 256), device=card)
    xf = torch.tensor([10], device=card, dtype=torch.int32)
    monkeypatch.setattr(K, "_tickets", lambda device, stream, n: torch.zeros(n - 1, dtype=torch.int32, device=card))
    with pytest.raises(RuntimeError, match="launch failed"):
        K.mvm_sliced_fused(planes, x, xf, spec=DEFAULT_SPEC, adc_bits=9)


def test_tensor_core_instances_run_imma_and_no_dp4a(card):
    from repro_torch.kernels import build
    from repro_torch.kernels.sliced_mvm import kernel as K

    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(K.build_kernel().path)], capture_output=True,
                          text=True, check=True).stdout
    funcs = {f.split("\n", 1)[0].strip(): f for f in re.split(r"\n\s*Function : ", sass)[1:]}
    mma = {name: body for name, body in funcs.items() if "mvm_mma_kernel" in name}
    # K4: 2 token heights x io 8/12/16 x finite/ideal ADC x forward/MᵀVM x
    # noise; K5 (int x_q, the last template argument): as many, without noise
    assert len(mma) == 48 + 24
    assert sum(bool(re.search(r"mvm_mma_kernelI(L[ib]\d+E)+iEE", name)) for name in mma) == 24  # mangled
    idp4a = re.compile(r"\bIDP\.?4A")  # sm_90 SASS spells __dp4a IDP.4A
    for name, body in mma.items():
        assert "IMMA" in body and not idp4a.search(body), name
    dp4a = [body for name, body in funcs.items() if "mvm_sliced_kernel" in name]
    assert dp4a and all(idp4a.search(body) and "IMMA" not in body for body in dp4a)
    # the decode body: io 8/12/16 x finite/ideal ADC x noise, all on __dp4a
    decode = {name: body for name, body in funcs.items() if "mvm_decode_kernel" in name}
    assert len(decode) == 12
    for name, body in decode.items():
        assert idp4a.search(body) and "IMMA" not in body, name


# --------------------- K1's grid and hw rounding sources ---------------------
# (M, N) with their hw tiles (bm, bn): gemma-2b's attention block (128, 256);
# ragged (80, 100) and (100, 168); bn = 131, not a multiple of 4, on the
# tensor-core body's 16-byte plane path (2096) and on its scalar one (262)
RNG_SHAPES = [(2048, 2560), (320, 100), (100, 336), (64, 2096), (64, 262)]


@pytest.mark.parametrize("physics", [None, "asym", "stuck", "all"])
@pytest.mark.parametrize("body", ["mma", "fma"])
@pytest.mark.parametrize("rng_mode,layer", [("grid", 0), ("grid", 17), ("hw", 0)])
@pytest.mark.parametrize("t", [1, 17, 256])
@pytest.mark.parametrize("m,n", RNG_SHAPES)
def test_opa_fused_rng_sources_match_plain_on_exact_operands(card, m, n, t, rng_mode, layer, body, physics):
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO
    from repro_torch.models.common import DeviceModel

    dev = None if physics is None else DeviceModel(**PHYSICS[physics])
    g = torch.Generator(device=card).manual_seed(m + n + t + layer)
    planes = _full_range_planes(card, (m, n), g) if dev is None else _canonical_planes(card, (m, n), g)
    x, dh = _exact_bf16_operands(card, t, m, n, g)
    if body == "fma":  # the CUDA-core body on f32 operands
        x, dh = x.float(), dh.float()
    name = KO.instance_name(dev is not None, body, rng_mode)
    offset = layer * m * n  # layer l of an 18-layer stack under grid
    for lr, f in ((2.0**-4, 8), (4.0, 28)):
        frac = torch.tensor([f], dtype=torch.int32, device=card)
        before = KO.opa_fused.instances[name]
        got = KO.opa_fused(planes.clone(), x, dh, lr, frac, spec=DEFAULT_SPEC, key_words=(12345 + t, -678),
                           rng_mode=rng_mode, offset=offset, dev=dev, noise_words=(77, -99))
        want = RO.opa_fused_ref(planes, x, dh, lr, frac[0], DEFAULT_SPEC, (12345 + t, -678), dev, (77, -99),
                                rng_mode=rng_mode, offset=offset)
        torch.cuda.synchronize()
        assert KO.opa_fused.instances[name] == before + 1
        if dev is None or dev.write_noise == 0.0:
            assert torch.equal(got, want)
        else:  # a Gaussian's last bit may move one update by one grid LSB
            d = (_plane_values(got) - _plane_values(want)).abs()
            assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3


@pytest.mark.parametrize("rng_mode", ["grid", "hw"])
def test_opa_fused_rng_sources_draw_what_their_plain_streams_draw(card, rng_mode):
    # half-way updates y = k + 1/2 on a fine grid: floor(y + u) rounds up
    # exactly where u >= 1/2, so the kernel's draws show through its planes
    from repro_torch.core.prng import counter_key_scalars, PRNGKey
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.kernels.sliced_opa import ref as RO

    m, n = 256, 512
    words = counter_key_scalars(PRNGKey(3))
    planes = torch.zeros((DEFAULT_SPEC.n_slices, m, n), dtype=torch.int8, device=card)
    x = torch.ones((1, m), device=card)
    dh = torch.full((1, n), -1.5, device=card)  # y = -lr·x·dh·2^F = 1.5 at lr = 2^-3, F = 3
    got = KO.opa_fused(planes, x, dh, 2.0**-3, torch.tensor([3], dtype=torch.int32, device=card),
                       spec=DEFAULT_SPEC, key_words=words, rng_mode=rng_mode, offset=5 * m * n)
    u = RO.rounding_u(words, rng_mode, 0, m, n, offset=5 * m * n, device=card)
    torch.cuda.synchronize()
    assert torch.equal(_plane_values(got), torch.where(u >= 0.5, 2, 1).to(torch.int64))
    assert 0.45 < float((u >= 0.5).float().mean()) < 0.55


def test_opa_fused_update_grid_on_the_card_matches_the_cpu(card):
    from repro_torch.core import prng
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels import sliced_opa as ops
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.models.common import DeviceModel

    g = torch.Generator(device=card).manual_seed(13)
    planes = _canonical_planes(card, (3, 320, 256), g)
    x = torch.randint(-4, 5, (3, 40, 320), generator=g, device=card) * 0.125
    dh = torch.randint(-4, 5, (3, 40, 256), generator=g, device=card) * 2.0**-5
    for dev in (None, DeviceModel(**PHYSICS["asym"]), DeviceModel(**PHYSICS["stuck"])):
        name = KO.instance_name(dev is not None, "mma", "grid")
        before = KO.opa_fused.instances[name]
        got = ops.opa_fused_update(planes.clone(), x.bfloat16(), dh.bfloat16(), 2.0**-5, 16, DEFAULT_SPEC,
                                   stochastic=True, key=prng.PRNGKey(8), rng_mode="grid", device=dev)
        want = ops.opa_fused_update(planes.cpu(), x.cpu(), dh.cpu(), 2.0**-5, 16, DEFAULT_SPEC, stochastic=True,
                                    key=prng.PRNGKey(8), rng_mode="grid", device=dev)
        assert KO.opa_fused.instances[name] == before + 3
        assert torch.equal(got.cpu(), want)


def test_training_steps_under_grid_and_hw_go_through_their_instances(card):
    from repro_torch import configs
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.optim import PantherConfig
    from repro_torch.optim.schedules import constant
    from repro_torch.train.step import make_train_step, train_state_init

    cfg = configs.get_smoke("gemma_2b")
    blocks = 5 * cfg.n_layers
    for mode in ("grid", "hw"):
        opt = PantherConfig(crs_every=2, rng_mode=mode)
        state = train_state_init(cfg, opt, 0)
        before = dict(KO.opa_fused.instances)
        state, metrics = make_train_step(cfg, opt, constant(1e-2))(state, SyntheticLMDataset(cfg.vocab, 8, 2).batch(0))
        torch.cuda.synchronize()
        assert {k: v - before.get(k, 0) for k, v in KO.opa_fused.instances.items()
                if v != before.get(k, 0)} == {f"ideal_{mode}": blocks}
        assert bool(torch.isfinite(metrics["loss"])) and bool(torch.isfinite(metrics["grad_norm"]))


def test_hw_rounding_on_the_card_is_unbiased(card):
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_opa import kernel as KO

    m, n, frac = 2048, 2560, 0.3711
    planes = torch.zeros((DEFAULT_SPEC.n_slices, m, n), dtype=torch.int8, device=card)
    # y = -lr·x·dh·2^F = frac on every cell: 0.3711 is not on a short binary grid, so a
    # few ulps of f32 rounding do not bias it at this sample size
    x = torch.ones((1, m), device=card)
    dh = torch.full((1, n), -frac, device=card)
    KO.opa_fused(planes, x, dh, 1.0, torch.tensor([0], dtype=torch.int32, device=card), spec=DEFAULT_SPEC,
                 key_words=(21, -4), rng_mode="hw")
    p = float(torch.tensor(frac, dtype=torch.float32))
    share = float((_plane_values(planes) == 1).double().mean())
    assert abs(share - p) <= 4.0 * (p * (1 - p) / (m * n)) ** 0.5


def test_opa_fused_grid_and_hw_instances_run_hmma(card):
    from repro_torch.kernels import build
    from repro_torch.kernels.sliced_opa import kernel as KO

    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    lib = build.build("opa_fused", KO.SOURCES["opa_fused"]).path
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs = {f.split("\n", 1)[0].strip(): f for f in re.split(r"\n\s*Function : ", sass)[1:]}
    # opa_mma_kernel<DEV, FAR = true>: the grid and hw instances, ideal and device
    far = [body for name, body in funcs.items() if "opa_mma_kernel" in name and "ELb1EEE" in name]
    assert len(far) == 2 and all("HMMA" in body for body in far)
