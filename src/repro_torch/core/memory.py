"""Memory hierarchy + energy model (paper §V-A, Table III).

Baseline SM hierarchy: DRAM -> SMEM (256 KB, 42 B/cyc... paper gives SMEM
42 B/cycle and DRAM 32 B/cycle) -> RF (4×4 KB) -> PE buffers.

Energy costs (INT8, 45 nm, Table III) are per *access*; the paper does not
state the access width.  We expose `access_granularity_bytes` per level and
calibrate it so system-level TOPS/W reproduces the paper's reported numbers
(see DESIGN.md §7 and tests/test_calibration.py).
"""
from __future__ import annotations

import dataclasses
import math

from .primitives import CiMPrimitive

TEMPORAL_REDUCTION_PJ = 0.05   # pJ per partial-sum addition (paper §V-D)


@dataclasses.dataclass(frozen=True)
class MemoryLevel:
    name: str
    capacity_bytes: float                 # math.inf for DRAM
    access_energy_pj: float               # per access (Table III)
    access_granularity_bytes: int         # bytes per access (calibrated)
    bandwidth_bytes_per_cycle: float      # math.inf if never the bottleneck

    def energy_pj_per_byte(self) -> float:
        return self.access_energy_pj / self.access_granularity_bytes

    def energy_pj(self, n_bytes: float) -> float:
        """Energy for moving n_bytes through this level's port."""
        accesses = math.ceil(n_bytes / self.access_granularity_bytes)
        return accesses * self.access_energy_pj


# --- Table III / §V-A constants -------------------------------------------
# Granularities are the calibration knob (DESIGN.md §7): DRAM 512 pJ per 8 B
# burst (64 pJ/B) reproduces the paper's 0.03 TOPS/W M=1 cells and the
# ~1.75 TOPS/W large-K plateau; SMEM is a 32 B bank access; RF an 8 B
# operand-collector read.

DRAM = MemoryLevel("DRAM", math.inf, 512.00, 8, 32.0)
SMEM = MemoryLevel("SMEM", 256 * 1024, 124.69, 32, 42.0)
RF = MemoryLevel("RF", 4 * 4 * 1024, 11.47, 16, math.inf)

LEVELS: dict[str, MemoryLevel] = {"DRAM": DRAM, "SMEM": SMEM, "RF": RF}


def iso_area_primitive_count(level: MemoryLevel, prim: CiMPrimitive) -> int:
    """How many CiM primitives fit in a level under iso-area (paper §VI).

    round(level capacity / (primitive capacity × area overhead)); RF with
    Digital-6T gives the paper's 3.  For SMEM "configB" the paper scales the
    RF count by the capacity ratio (16×); see `configb_count`.
    """
    n = round(level.capacity_bytes / (prim.capacity_bytes * prim.area_overhead))
    return max(1, int(n))


def configb_count(prim: CiMPrimitive) -> int:
    """Paper Fig. 11 configB: 16× the RF iso-area count (capacity ratio)."""
    return 16 * iso_area_primitive_count(RF, prim)


@dataclasses.dataclass(frozen=True)
class CiMSystemConfig:
    """Where CiM is integrated and how many primitives it gets.

    cim_level: "RF" or "SMEM".  When CiM sits at RF, inputs stream from SMEM
    and SMEM still buffers input/output tiles (paper Fig. 6/11a).  When CiM
    sits at SMEM, there is no intermediate buffer level: inputs/outputs move
    directly between DRAM and the CiM arrays (paper §VI-C).
    """

    prim: CiMPrimitive
    cim_level: str = "RF"
    n_prims: int | None = None          # default: iso-area count
    serialize_primitives: bool = True   # DESIGN.md §7 calibration
    kn_balance_threshold: int = 4       # paper §IV-B multi-primitive rule

    def resolved_n_prims(self) -> int:
        if self.n_prims is not None:
            return self.n_prims
        return iso_area_primitive_count(LEVELS[self.cim_level], self.prim)
