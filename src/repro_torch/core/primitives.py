"""CiM primitive model (paper §IV-A, Table IV) + technology scaling (eqs 2-5).

A CiM *primitive* is one SRAM array modified for in-situ MACs.  The paper's
dataflow-centric representation exposes it as Rp×Cp parallel *CiM units*,
each of which serially performs Rh×Ch MAC operations.  Hence the array holds
a weight tile of (Rp·Rh) K-rows × (Cp·Ch) N-columns, and one full-array
activation ("wave") takes `latency_ns` and computes up to
Rp·Cp·Rh·Ch MACs.
"""
from __future__ import annotations

import dataclasses

# Stillmaker & Baas 45nm energy-model coefficients (paper footnote 1).
A45 = (1.103, -0.362, 0.2767)


def tech_scale_ratio(v_ref: float, a_ref: tuple[float, float, float] = A45,
                     v_45: float = 1.0) -> float:
    """Paper eqs. (3)-(5): T_ratio = f_45nm / f_ref.

    f(V) = a_e2·V² + a_e1·V + a_e0 evaluated at the reference design's supply
    voltage with its node coefficients, vs 45 nm at 1 V.
    """
    f45 = A45[0] * v_45 ** 2 + A45[1] * v_45 + A45[2]
    fref = a_ref[0] * v_ref ** 2 + a_ref[1] * v_ref + a_ref[2]
    return f45 / fref


def mac_energy_pj_from_tops_w(tops_per_w: float, v_ref: float = 1.0,
                              a_ref: tuple[float, float, float] = A45) -> float:
    """Paper eq. (2): pJ/MAC = (2 / TOPS/W) · T_ratio.

    (2 ops per MAC; TOPS/W is reported in ops.)
    """
    return (2.0 / tops_per_w) * tech_scale_ratio(v_ref, a_ref)


def compute_latency_ns(cim_freq_ghz: float, cycles_mac: float) -> float:
    """Paper eq. (6): latency normalized to a 1 GHz system clock."""
    return (1.0 / cim_freq_ghz) * cycles_mac


# --- per-precision macro scaling (What-axis widening) ----------------------
# Multiplicative factors on the Table-IV 8b-8b calibration point, following
# the analog/digital SRAM-CiM characterizations (SRAM-CiM review, CiMLoop):
#
#   * analog INT-b: MAC energy splits into an array part that scales
#     linearly with the bit-serial input width (0.4·b/8) and an ADC part
#     that scales with resolution (0.6·2^(b-8)); activation latency is
#     dominated by input DAC streaming (0.5 + 0.5·b/8); halving the
#     weight width doubles usable column parallelism (colpar 8/b — two
#     INT4 weights share one 8b column's ADC range).
#   * analog FP8: shared-exponent handling costs an extra alignment pass
#     (energy x1.3, latency x1.5) and halves column parallelism (0.5).
#   * digital INT-b: bit-serial multiply — energy (b/8)^2, latency b/8,
#     no column-parallelism change.
#   * digital FP8: exponent-align adder overhead (energy x1.2, latency
#     x1.25), full column parallelism.
#
# All four branches are exactly (1, 1, 1) at INT8 so the Table-IV
# calibration (tests/test_calibration.py) is untouched.

ANALOG_FP8_FACTORS = (1.3, 1.5, 0.5)
DIGITAL_FP8_FACTORS = (1.2, 1.25, 1.0)
SUPPORTED_BITS = (4, 8)


def precision_factors(compute_type: str, bits: int,
                      fp: bool = False) -> tuple[float, float, float]:
    """(energy_x, latency_x, colpar_x) vs the INT8 calibration point.

    energy_x scales the per-MAC energy, latency_x the per-step array
    activation latency, and colpar_x the usable column parallelism
    (Cp_eff = Cp * colpar_x).  Identity at INT8 by construction.
    """
    if compute_type not in ("analog", "digital"):
        raise ValueError(f"unknown compute_type {compute_type!r}")
    if fp:
        if bits != 8:
            raise ValueError(f"FP precision requires 8 bits, got {bits}")
        return (ANALOG_FP8_FACTORS if compute_type == "analog"
                else DIGITAL_FP8_FACTORS)
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"unsupported integer precision INT{bits} "
                         f"(supported: {SUPPORTED_BITS})")
    if bits == 8:
        return (1.0, 1.0, 1.0)
    r = bits / 8.0
    if compute_type == "analog":
        return (0.4 * r + 0.6 * 2.0 ** (bits - 8), 0.5 + 0.5 * r, 8.0 / bits)
    return (r * r, r, 1.0)


@dataclasses.dataclass(frozen=True)
class CiMPrimitive:
    """One CiM array (paper Table IV row)."""

    name: str
    compute_type: str           # "analog" | "digital"
    cell: str                   # "6T" | "8T"
    Rp: int                     # parallel rows (CiM units along K)
    Cp: int                     # parallel cols (CiM units along N)
    Rh: int                     # row hold: serial MACs along K per unit
    Ch: int                     # col hold: serial MACs along N per unit
    capacity_bytes: int         # SRAM capacity (4 KB for all prototypes)
    latency_ns: float           # full-array activation latency (Table IV)
    mac_energy_pj: float        # 8b-8b MAC energy, scaled to 45nm/1V
    area_overhead: float        # × vs iso-capacity plain SRAM

    # --- geometry ---------------------------------------------------------
    @property
    def k_rows(self) -> int:
        """K-extent of the stationary weight tile held by one array."""
        return self.Rp * self.Rh

    @property
    def n_cols(self) -> int:
        """N-extent of the stationary weight tile held by one array."""
        return self.Cp * self.Ch

    @property
    def weight_elems(self) -> int:
        """INT8 weights held stationary by one array."""
        return min(self.k_rows * self.n_cols, self.capacity_bytes)

    @property
    def mac_units(self) -> int:
        """Total MAC positions (utilization denominator): Rp·Cp units of
        Rh·Ch MACs each (paper §V-D)."""
        return self.Rp * self.Cp * self.Rh * self.Ch

    @property
    def macs_per_wave(self) -> int:
        """MACs performed by one full-array activation."""
        return self.mac_units

    @property
    def peak_gops(self) -> float:
        """Appendix B: 2·Rp·Cp·Rh·Ch / latency for one array, in GOPS."""
        return 2.0 * self.mac_units / self.latency_ns

    def __str__(self) -> str:  # pragma: no cover
        return (f"{self.name}(Rp={self.Rp},Cp={self.Cp},Rh={self.Rh},"
                f"Ch={self.Ch},{self.latency_ns}ns,{self.mac_energy_pj}pJ)")


# --- the four prototypes of Table IV --------------------------------------

ANALOG_6T = CiMPrimitive(
    name="Analog-6T", compute_type="analog", cell="6T",
    Rp=64, Cp=4, Rh=1, Ch=16, capacity_bytes=4096,
    latency_ns=9.0, mac_energy_pj=0.15, area_overhead=1.34)

ANALOG_8T = CiMPrimitive(
    name="Analog-8T", compute_type="analog", cell="8T",
    Rp=64, Cp=4, Rh=1, Ch=16, capacity_bytes=4096,
    latency_ns=144.0, mac_energy_pj=0.09, area_overhead=2.1)

DIGITAL_6T = CiMPrimitive(
    name="Digital-6T", compute_type="digital", cell="6T",
    Rp=256, Cp=16, Rh=1, Ch=1, capacity_bytes=4096,
    latency_ns=18.0, mac_energy_pj=0.34, area_overhead=1.4)

DIGITAL_8T = CiMPrimitive(
    name="Digital-8T", compute_type="digital", cell="8T",
    Rp=1, Cp=128, Rh=10, Ch=1, capacity_bytes=4096,
    latency_ns=233.0, mac_energy_pj=0.84, area_overhead=1.1)

PRIMITIVES: dict[str, CiMPrimitive] = {
    p.name: p for p in (ANALOG_6T, ANALOG_8T, DIGITAL_6T, DIGITAL_8T)
}
# Short aliases used in the appendix figures.
PRIMITIVES["A-1"] = ANALOG_6T
PRIMITIVES["A-2"] = ANALOG_8T
PRIMITIVES["D-1"] = DIGITAL_6T
PRIMITIVES["D-2"] = DIGITAL_8T


@dataclasses.dataclass(frozen=True)
class TensorCoreSpec:
    """Baseline tensor-core-like SM (paper §V-A).

    4 sub-cores × 16×16 PEs, INT8, 1 GHz.  MAC energy 0.26 pJ (Table III),
    PE-buffer operand access 0.02 pJ.
    """

    subcores: int = 4
    pe_rows: int = 16
    pe_cols: int = 16
    mac_energy_pj: float = 0.26
    pe_buffer_energy_pj: float = 0.02
    freq_ghz: float = 1.0

    @property
    def macs_per_cycle(self) -> int:
        return self.subcores * self.pe_rows * self.pe_cols

    @property
    def peak_gops(self) -> float:
        return 2.0 * self.macs_per_cycle * self.freq_ghz


TENSOR_CORE = TensorCoreSpec()
