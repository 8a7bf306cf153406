"""Energy/latency model for the PANTHER accelerator and its baselines (port
of ``repro.isa.energy``: host arithmetic only, the same constants).

Two pricing granularities share one set of anchors:

* the seed-era opaque tile-op costs (``mvm_panther``/``mvm_base``) — one
  constant per 16-bit MVM regardless of slicing, still used by the analytic
  fig11-14 layer model;
* the plan-aware *packed-schedule* costs (``mvm_packed``/``opa_panther``) —
  priced per ``LeafPlan``: one packed bit-plane MVM round per tile covering
  all (bit, slice) columns, with each slice's ADC conversion priced at its
  own effective resolution (Murmann-survey trend, ~2x energy per +2 bits)
  and the round count scaling with ``io_bits``. This is what the plan
  compiler and the simulator of the JAX package charge, and it reduces to
  the §6.3-taxed anchor exactly at the paper's default configuration
  (44466555 slices, 16-bit IO, lossless ADC).

All per-op constants are for one 128x128 crossbar tile processing 16-bit
streamed inputs. Disclosed anchors from the paper:

  * ReRAM MVM            35.10 nJ   (§7.3 "ReRAM MVMs ... 35.10 nJ")
  * CMOS  OPA            37.28 nJ   (§7.3 "... CMOS OPAs ... 37.28 nJ")
  * ReRAM OPA            11.37 nJ   (§7.3 "performing OPA in the crossbar (11.37 nJ)")
  * CMOS/ReRAM MVM       10.4x energy, 8.9x latency (Fig 1, same area, 32nm)
  * PANTHER MVM ADC tax  +17.5% for the 44466555 spec (§6.3)
  * ReRAM write >> read, both >> in-crossbar compute; write ~10x read and
    ~order of magnitude over CMOS write (Fig 1, program-verify [9])

Calibrated (derivation in comments — chosen to reproduce the paper's
headline ratios, then held fixed across ALL experiments):

  * ReRAM serial write/tile: PANTHER vs Base_mvm FC-layer SGD ratio peaks at
    54.21x (§7.3). Base_mvm FC cost/tile ~= 2*35.10 + 37.28 + R + W;
    PANTHER ~= 2*35.10*1.175 + 11.37 = 93.9 nJ  =>  R + W ~= 4983 nJ.
    With W = 10R: W ~= 4530 nJ (~276 pJ/cell — consistent with tens of
    program-verify pulses [9]), R ~= 453 nJ.
  * SRAM read+write/tile (CMOS baseline is weight-stationary; its reads
    stay on-chip): folded into E_MVM_CMOS = 10.4 * 35.10 = 365 nJ.
"""
from __future__ import annotations

import dataclasses

XBAR = 128  # crossbar rows/cols
CELLS = XBAR * XBAR

PAPER_BITS = (4, 4, 4, 6, 6, 5, 5, 5)  # §3.3 heterogeneous pick ("44466555")
ROW_BITS = 7  # log2(128 rows): partial-sum growth a lossless ADC must cover
IO_CYCLES_REF = 15  # bit cycles of the 16-bit anchor stream (io_bits - 1)


def adc_eff_bits(slice_bits: int, adc_bits: int | None = None) -> int:
    """Effective ADC resolution reading one slice's column: a lossless read
    needs ``log2(rows) + slice_bits``; a programmed per-path ``adc_bits``
    (FidelityConfig) caps it — an ADC never burns more bits than its slice
    can produce."""
    full = ROW_BITS + slice_bits
    return full if adc_bits is None else min(adc_bits, full)


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    # --- energy per tile-op (nJ) ---
    e_mvm_reram: float = 35.10
    e_opa_reram: float = 11.37
    e_opa_cmos: float = 37.28
    e_mvm_cmos: float = 35.10 * 10.4  # Fig 1
    adc_tax_panther: float = 1.175  # §6.3 (44466555 needs higher-precision ADC)
    e_write_reram: float = 4530.0  # calibrated (see module docstring)
    e_read_reram: float = 453.0
    # digital vector op energy per 16-bit element (nJ) — VFU activations etc.
    e_vfu_elem: float = 0.0004
    # shared-memory / NoC movement per byte (nJ)
    e_mem_byte: float = 0.0009
    # ADC sample-energy exponent: ~2x per +2 bits at 6-13 bit resolutions
    # (Murmann survey trend — the same slope fig10/launch.serve price with)
    adc_sample_exp: float = 0.5
    # program-verify overhead on a writes-nonideal DeviceModel: extra verify
    # reads interleaved with the OPA pulse train (Fig 1 [9])
    verify_frac: float = 0.25

    # --- latency per tile-op (ns) ---
    # ReRAM MVM: 16 bit-serial cycles at ~6.4ns effective (ADC-limited), ~100ns.
    l_mvm_reram: float = 100.0
    l_opa_reram: float = 105.0  # 16 pulse-width cycles (m=1, §3.1)
    l_mvm_cmos: float = 890.0  # 8.9x (Fig 1)
    l_opa_cmos: float = 890.0
    # serial row-by-row access: 128 rows; write uses program-verify pulses.
    l_read_reram: float = 128 * 50.0  # 6.4 us/tile
    l_write_reram: float = 128 * 500.0  # 64 us/tile (~10x read, Fig 1)
    l_read_sram: float = 128 * 2.0
    l_write_sram: float = 128 * 2.0

    def mvm_panther(self):  # energy, latency of PANTHER MVM or MTVM
        return self.e_mvm_reram * self.adc_tax_panther, self.l_mvm_reram

    def mvm_base(self):  # Base_mvm / Base_opa-mvm crossbars (2-bit slices)
        return self.e_mvm_reram, self.l_mvm_reram

    # ---------------- plan-aware packed-schedule pricing ----------------

    def _adc_weight(self, bits: tuple, io_bits: int, adc_bits: int | None) -> float:
        """Relative ADC cost of one packed round: (io_bits - 1) bit cycles,
        each converting every slice's column block once, per-slice sample
        energy ~ 2^(eff_bits * adc_sample_exp)."""
        return (io_bits - 1) * sum(
            2.0 ** (adc_eff_bits(b, adc_bits) * self.adc_sample_exp) for b in bits
        )

    def mvm_packed(self, bits: tuple = PAPER_BITS, io_bits: int = 16,
                   adc_bits: int | None = None) -> tuple:
        """(energy nJ, latency ns) of ONE packed bit-plane MVM/MᵀVM round on
        one 128x128 tile under a leaf's plan: all S slices x (io_bits - 1)
        bit planes convert in one ``dot_general``-shaped round (the packed
        read engine), instead of the seed schedule's S*(io_bits-1) serial ops.

        Calibration: the cost is the §7.3 anchor times the ADC weight of the
        leaf's configuration relative to the paper's default (44466555
        slices, 16-bit IO, lossless ADC), so the default reproduces
        ``e_mvm_reram * adc_tax_panther`` exactly and a coarser ADC or a
        shorter IO stream prices below it."""
        ref = self._adc_weight(PAPER_BITS, 16, None)
        e = self.e_mvm_reram * self.adc_tax_panther * (
            self._adc_weight(tuple(bits), io_bits, adc_bits) / ref)
        lat = self.l_mvm_reram * (io_bits - 1) / IO_CYCLES_REF
        return e, lat

    def opa_panther(self, nonideal_write: bool = False) -> tuple:
        """(energy nJ, latency ns) of one in-crossbar OPA pulse train per
        tile; a writes-nonideal DeviceModel pays ``verify_frac`` extra in
        program-verify reads."""
        f = 1.0 + self.verify_frac if nonideal_write else 1.0
        return self.e_opa_reram * f, self.l_opa_reram * f


DEFAULT_ENERGY = EnergyModel()


@dataclasses.dataclass(frozen=True)
class GPUModel:
    """Analytical RTX 2080-Ti model (Table 3): utilization rises with batch
    size and arithmetic intensity (ops/byte); calibrated so SGD batch-1 MLP
    lands ~2 orders of magnitude behind PANTHER in time (§7.7 / Fig 15)."""

    peak_flops: float = 13.4e12  # fp32
    tdp_w: float = 250.0
    mem_bw: float = 616e9  # GDDR6
    idle_frac: float = 0.35  # fraction of TDP drawn regardless of utilization

    def step_time_energy(self, flops: float, bytes_moved: float, batch: int):
        # utilization: batch amortizes kernel-launch/occupancy; intensity
        # decides compute vs memory bound.
        occupancy = min(1.0, 0.05 + 0.95 * (batch / 256.0))
        t_compute = flops / (self.peak_flops * occupancy)
        t_memory = bytes_moved / self.mem_bw
        t = max(t_compute, t_memory) + 6e-6  # fixed launch overhead per step
        e = t * self.tdp_w * (self.idle_frac + (1 - self.idle_frac) * occupancy)
        return t, e


DEFAULT_GPU = GPUModel()
