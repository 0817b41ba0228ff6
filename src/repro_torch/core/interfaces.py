"""Accelerator<->memory-system data-path models (paper §IV-A, TPU-adapted).

SMAUG's case study compared DMA (software-managed scratchpad fills with
explicit cache flush/invalidate cost) against ACP (one-way coherent port into
the LLC: no SW coherency management, DRAM hits become LLC hits).

On a TPU the analogous end-to-end choice is how an intermediate tensor moves
between producer and consumer ops:

  dma   : producer writes HBM, framework-level boundary (layout change /
          tiling pass) with per-transfer launch overhead, consumer re-reads
          HBM — the "every op round-trips HBM + host manages staging" model.
  acp   : fused/resident path — producer output stays in VMEM for the
          consumer (one-way coherent: no host staging, no flush analogue);
          only first read + last write touch HBM.

Both are cost models evaluated over the op graph.  ``HBM_BW`` and
``VMEM_BW`` are the H100's (``repro_torch.sim.hw``); the DMA launch and
staging constants below are SMAUG's modeled SoC, the JAX package's values,
not the card's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.energy import DEFAULT_ENERGY, EnergyModel
from repro_torch.sim.hw import HBM_BW, VMEM_BW  # noqa: F401  (single home)

# SMAUG's modeled SoC (the JAX package's model, not measured on the card)
DMA_LAUNCH_S = 2e-6    # per-transfer software+descriptor overhead
FLUSH_PER_BYTE = 6e-12 # SW coherency-management analogue (staging/copy mgmt)


@dataclass(frozen=True)
class TransferCost:
    seconds: float
    energy_j: float


def dma_transfer(nbytes: float, n_transfers: int = 1,
                 em: EnergyModel = DEFAULT_ENERGY,
                 hbm_bw: Optional[float] = None) -> TransferCost:
    """HBM round-trip with SW-managed staging (DMA analogue)."""
    bw = hbm_bw or HBM_BW
    t = (2 * nbytes / bw              # write + re-read
         + n_transfers * DMA_LAUNCH_S
         + nbytes * FLUSH_PER_BYTE)   # staging management
    e = em.hbm(2 * nbytes) + em.host(nbytes * 0.05)
    return TransferCost(t, e)


def acp_transfer(nbytes: float, resident_fraction: float = 1.0,
                 em: EnergyModel = DEFAULT_ENERGY,
                 hbm_bw: Optional[float] = None,
                 vmem_bw: Optional[float] = None) -> TransferCost:
    """Fused / VMEM-resident path (coherent-port analogue).

    resident_fraction: share of the tensor that stays on-chip between
    producer and consumer (1.0 = fully fused; working sets larger than VMEM
    spill the remainder through HBM)."""
    spill = nbytes * (1.0 - resident_fraction)
    t = (nbytes * resident_fraction) / (vmem_bw or VMEM_BW) \
        + 2 * spill / (hbm_bw or HBM_BW)
    e = em.vmem(2 * nbytes * resident_fraction) + em.hbm(2 * spill)
    return TransferCost(t, e)
