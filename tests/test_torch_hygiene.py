"""Boundaries of the port: it imports neither JAX nor the JAX package, its
CPU path never touches the kernel, and its entry points never drift to the
CPU on their own."""
from __future__ import annotations

import ast
import os
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _port_modules():
    import repro_torch

    return ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]


def test_port_imports_no_jax_and_no_reference_package():
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {_port_modules()!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print(len({_port_modules()!r}))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_and_port_sources_import_no_jax():
    files = [ROOT / "chip_smoke.py", *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "repro"}
        assert not bad, (f, bad)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.kernels.sliced_mvm import ops, ref

    before = K.mvm_sliced_fused.launches
    g = torch.Generator().manual_seed(0)
    planes = torch.randint(-8, 8, (8, 256, 64), generator=g, dtype=torch.int8)
    x = torch.randn((3, 256), generator=g)
    out = ops.mvm_sliced_fused(planes, x, 12, DEFAULT_SPEC, adc_bits=9)
    assert torch.equal(out, ref.mvm_sliced_fused_ref(planes, x, 12, DEFAULT_SPEC, 16, 9))
    assert K.mvm_sliced_fused.launches == before == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.models.common import DeviceModel

    planes = torch.zeros((8, 128, 32), dtype=torch.int8)
    frac = torch.zeros(1, dtype=torch.int32)
    for transpose, x in ((False, torch.zeros((1, 128))), (True, torch.zeros((1, 32)))):
        with pytest.raises(ValueError):
            K.mvm_sliced_fused(planes, x, frac, spec=DEFAULT_SPEC, adc_bits=9, transpose=transpose)
    # the noisy instance, the other io widths and the int-input read (K5)
    # refuse them too, before any launch
    with pytest.raises(ValueError):
        K.mvm_sliced_fused(planes, torch.zeros((1, 32)), frac, spec=DEFAULT_SPEC, adc_bits=9,
                           transpose=True, dev=DeviceModel(read_noise=0.1))
    with pytest.raises(ValueError):
        K.mvm_sliced_fused(planes, torch.zeros((1, 128)), frac, spec=DEFAULT_SPEC, io_bits=8, adc_bits=9)
    for transpose, x in ((False, torch.zeros((1, 128), dtype=torch.int32)),
                         (True, torch.zeros((1, 32), dtype=torch.int32))):
        with pytest.raises(ValueError):
            K.mvm_sliced(planes, x, spec=DEFAULT_SPEC, io_bits=12, adc_bits=9, transpose=transpose)
    assert K.mvm_sliced_fused.launches == K.mvm_sliced_fused.transpose_launches == 0
    assert K.mvm_sliced.launches == K.mvm_sliced.transpose_launches == 0
    assert not K.mvm_sliced_fused.instances and not K.mvm_sliced.instances


def test_update_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.core.slicing import DEFAULT_SPEC
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.sliced_opa import kernel as KO
    from repro_torch.models.common import DeviceModel

    planes = torch.zeros((8, 16, 16), dtype=torch.int8)
    frac = torch.zeros(1, dtype=torch.int32)
    x = torch.zeros((4, 16))
    with pytest.raises(ValueError):
        KC.crs(planes, spec=DEFAULT_SPEC)
    with pytest.raises(ValueError):
        KO.opa_deposit(planes, torch.zeros((16, 16), dtype=torch.int32), spec=DEFAULT_SPEC)
    with pytest.raises(ValueError):
        KO.opa_fused(planes, x, x, 0.1, frac, spec=DEFAULT_SPEC)
    with pytest.raises(ValueError):
        KO.opa_fused(planes, x, x, 0.1, frac, spec=DEFAULT_SPEC, dev=DeviceModel(write_noise=0.5),
                     noise_words=(1, 2))
    with pytest.raises(ValueError):
        KO.opa_deposit(planes, torch.zeros((16, 16), dtype=torch.int32), spec=DEFAULT_SPEC,
                       stuck=DeviceModel(stuck_frac=0.1))
    assert KC.crs.launches == KO.opa_deposit.launches == KO.opa_fused.launches == 0
    assert not KO.opa_deposit.instances and not KO.opa_fused.instances


def test_cpu_training_step_takes_the_plain_versions_and_launches_nothing():
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
    state = train_state_init(cfg, opt, 0, device="cpu")
    state, metrics = make_train_step(cfg, opt, constant(1e-2), plan_rules=rules, remat="none")(
        state, SyntheticLMDataset(cfg.vocab, 8, 2, device="cpu").batch(0))
    assert state.step == 1 and bool(torch.isfinite(metrics["loss"]))
    counts = (K.mvm_sliced_fused.launches, K.mvm_sliced_fused.transpose_launches,
              KO.opa_fused.launches, KO.opa_deposit.launches, KC.crs.launches)
    assert counts == (0, 0, 0, 0, 0)


def test_entry_points_without_a_device_run_on_cuda_or_raise():
    from repro_torch import configs, convert
    from repro_torch.device import resolve
    from repro_torch.models import lm

    cfg = configs.get_smoke("gemma_2b")
    if torch.cuda.is_available():
        assert resolve().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.params_from_jax({"w": __import__("numpy").zeros(2)})
    assert lm.init_params(cfg, 0, device="cpu")["embed"].device.type == "cpu"


def test_training_entry_points_without_a_device_run_on_cuda_or_raise():
    from repro_torch import configs
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch import train as launch
    from repro_torch.optim import PantherConfig
    from repro_torch.train.step import train_state_init

    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run on it")
    cfg = configs.get_smoke("gemma_2b")
    with pytest.raises(RuntimeError, match="cuda"):
        train_state_init(cfg, PantherConfig(), 0)
    with pytest.raises(RuntimeError, match="cuda"):
        SyntheticLMDataset(cfg.vocab, 8, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        launch.main(["--smoke", "--steps", "1"])


def test_paper_mlp_entry_points_without_a_device_run_on_cuda_or_raise():
    from repro_torch.benchmarks import fig9_slice_crs
    from repro_torch.core import prng
    from repro_torch.data import TeacherStudentDataset
    from repro_torch.examples import quickstart
    from repro_torch.optim import panther

    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        TeacherStudentDataset(8, 2, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        fig9_slice_crs.run(steps=1)
    with pytest.raises(RuntimeError, match="cuda"):
        fig9_slice_crs.device_sweep(steps=1)
    with pytest.raises(RuntimeError, match="cuda"):
        fig9_slice_crs.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        quickstart.main(steps=1)
    # panther.init on params made on the default device: making them raises
    with pytest.raises(RuntimeError, match="cuda"):
        panther.init(fig9_slice_crs._mlp(prng.PRNGKey(0)))
    # asked for the CPU, they run there
    params = fig9_slice_crs._mlp(prng.PRNGKey(0), device="cpu")
    assert panther.init(params).sliced["w0"].planes.device.type == "cpu"
    assert TeacherStudentDataset(8, 2, 4, device="cpu").x.device.type == "cpu"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_serving_entry_points_without_a_device_run_on_cuda_or_raise():
    from repro_torch import configs
    from repro_torch.examples import serve_batched
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import lm
    from repro_torch.serve import Engine

    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run on it")
    cfg = configs.get_smoke("gemma_2b")
    params = lm.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(cfg, params, n_slots=2, max_seq=16, page=4)
    for argv in (["--smoke", "--tokens", "2"], ["--smoke", "--trace"]):
        with pytest.raises(RuntimeError, match="cuda"):
            launch_serve.main(argv)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_batched.main([])
    # asked for the CPU, the engine keeps its pools and slot state there
    eng = Engine(cfg, params, n_slots=2, max_seq=16, page=4, device="cpu")
    assert eng.caches[0][0]["k"]["q"].device.type == eng.tok.device.type == "cpu"


@pytest.mark.cuda
def test_one_engine_round_on_the_card_matches_the_cpu():
    """One decode round of the engine on the card against the same round on
    the CPU (the plain versions), from the same weights: on a lossless f32
    tree the tokens are equal; through an adc9 tree every read of the round
    launches K4 on its decode body (2 slots), 5 reads a layer a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    import dataclasses

    import numpy as np

    from repro_torch import configs, tree
    from repro_torch import plan as planlib
    from repro_torch.kernels.sliced_mvm import kernel as K
    from repro_torch.models import lm
    from repro_torch.optim import PantherConfig, panther
    from repro_torch.serve import Engine, fidelity_params

    cfg = dataclasses.replace(configs.get_smoke("gemma_2b"), dtype=torch.float32)
    opt = PantherConfig()
    prompts = [np.arange(5, dtype=np.int32) * 7 % cfg.vocab, np.arange(3, dtype=np.int32) * 5 % cfg.vocab]
    T = 4

    def one_round(device, fidelity=None):
        params0 = tree.map(lambda t: t.to(device), lm.init_params(cfg, 0, device="cpu"))
        digital, sliced = panther.init_split(params0, opt)
        params = panther.materialize_split(digital, sliced, opt)
        if fidelity is not None:
            plan = planlib.resolve_plan(params, planlib.default_rules(opt, fidelity=fidelity))
            params = fidelity_params(params, sliced, plan=plan)
        costs = {("prefill", len(p)): 0.0 for p in prompts} | {("round", T): 0.0}
        eng = Engine(cfg, params, n_slots=2, max_seq=16, page=4, device=device, costs=costs)
        for p in prompts:
            job = eng.start(p)
            eng.prefill_step(job)
            eng.admit(job)
        toks, _ = eng.decode_round(T)
        return toks

    assert (one_round("cuda") == one_round("cpu")).all()
    K.mvm_sliced_fused.launches = 0
    K.mvm_sliced_fused.instances.clear()
    toks = one_round("cuda", configs.fidelity_presets()["adc9"])
    assert ((0 <= toks) & (toks < cfg.vocab)).all()
    layers = sum(count for _, count in cfg.pattern)
    on_decode = T + sum(K.body_for(len(p), False) == "decode" for p in prompts)  # the 3-token prefill too
    assert K.mvm_sliced_fused.instances[K.instance_name(False, 16, body="decode")] == 5 * layers * on_decode
