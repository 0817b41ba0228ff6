"""Hardware constants of one NVIDIA H100 SXM (80 GB), the port's card.

The port's copy of the constants that calibration reads from
``repro/sim/hw.py``, with the H100's data-sheet values in place of the TPU
v5e's.  Dense rates, without sparsity, at the card's full 700 W power limit;
a card set below it runs slower under load.
"""
from __future__ import annotations

# the calibration loop measures in float32 (kernels/calibrate.py BYTES), so
# its roofline peak is float32 on the CUDA cores, not the tensor cores
PEAK_FLOPS = 67e12           # float32, CUDA cores (NVIDIA H100 data sheet)
PEAK_FLOPS_BF16 = 989e12     # bf16, tensor cores, dense (H100 data sheet)
PEAK_FLOPS_TF32 = 494.7e12   # TF32, tensor cores, dense (H100 data sheet);
                             # a float32-accurate product takes 3 passes
HBM_BW = 3.35e12             # bytes/s, HBM3 (NVIDIA H100 data sheet)
N_SMS = 132                  # streaming multiprocessors (Hopper white paper)
SM_CLOCK_HZ = 1.98e9         # boost clock (NVIDIA H100 data sheet)
SFU_PER_CLOCK = 16           # exponentials per clock per SM (NVIDIA's
                             # arithmetic throughput table, sm_90)
EXP_RATE = N_SMS * SFU_PER_CLOCK * SM_CLOCK_HZ   # exponentials/s
