"""The PANTHER hardware model: ISA, compiler, simulator, energy (port of
``repro.isa``: host arithmetic, no tensor touched, so every stream, joule
and nanosecond equals the reference's).

The spine is the *plan-compile pipeline* — the co-design loop between the
declarative mapping plan and the accelerator:

    repro_torch.plan (LeafPlan tree)  +  model shapes
        └─ plan_compile.compile_plan ─> per-leaf tile schedules (Program)
              └─ simulator.simulate_plan / plan_compile.report
                    └─ joules + nanoseconds per leaf, PANTHER vs baselines

Modules:

* ``isa`` — the PUMA ISA extended with the masked ``mcu`` instruction plus
  serial crossbar access (XREAD/XWRITE);
* ``plan_compile`` — lowers a resolved ``CrossbarPlan`` to packed bit-plane
  tile schedules (per-slice ADC pricing, MᵀVM reads, fused-OPA vs
  serial-write updates, DeviceModel write physics; the port's plans carry
  no shard hints yet, so placement is the unhinted one);
* ``compiler`` — shared placement/fusion stages and the removed seed-era
  ``compile_model`` entry;
* ``simulator`` — prices compiled programs under PANTHER and the
  digital/serial-write baselines; also the analytic fig11-15 layer model;
* ``energy`` — the §7.3-anchored constants and the packed-schedule pricing
  (``EnergyModel.mvm_packed`` / ``opa_panther``);
* ``graph`` — the legacy layer-list workloads (MLP_L4, VGG16).

``repro_torch.benchmarks.isa_energy`` drives this into the energy record,
and ``serve.scheduler.IsaClock`` closes the loop the other way: the serving
engine's virtual clock priced in compiled crossbar cycles.
"""
from . import compiler, energy, graph, isa, plan_compile, simulator

__all__ = ["compiler", "energy", "graph", "isa", "plan_compile", "simulator"]
