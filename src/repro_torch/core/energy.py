"""Energy model (paper §III-D analogue).

SMAUG characterized 16nm functional units + SRAM compiler blocks + CACTI for
the LLC + DRAMPower for LP-DDR4.  These per-op energies are the JAX
package's model of that simulated SoC (published-ballpark constants for a
5nm-class accelerator and HBM2e), copied unchanged: they describe the
modeled SoC, not the H100, and the port reports no energy as the card's.
All constants are overridable so studies can re-characterize.

Units: joules.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EnergyModel:
    pj_per_flop_bf16: float = 0.25     # MXU MAC (0.5 pJ/MAC -> /2 per flop)
    pj_per_byte_hbm: float = 40.0      # HBM2e access ≈ 5 pJ/bit
    pj_per_byte_vmem: float = 1.2      # on-chip SRAM
    pj_per_byte_ici: float = 10.0      # inter-chip link
    pj_per_byte_host: float = 60.0     # host DRAM + PCIe path
    static_w_per_chip: float = 60.0    # idle/leakage+clocking floor

    def compute(self, flops: float) -> float:
        return flops * self.pj_per_flop_bf16 * 1e-12

    def hbm(self, nbytes: float) -> float:
        return nbytes * self.pj_per_byte_hbm * 1e-12

    def vmem(self, nbytes: float) -> float:
        return nbytes * self.pj_per_byte_vmem * 1e-12

    def ici(self, nbytes: float) -> float:
        return nbytes * self.pj_per_byte_ici * 1e-12

    def host(self, nbytes: float) -> float:
        return nbytes * self.pj_per_byte_host * 1e-12

    def static(self, seconds: float, n_chips: int = 1) -> float:
        return self.static_w_per_chip * seconds * n_chips


DEFAULT_ENERGY = EnergyModel()
