"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense
rates, no sparsity, at the full 700 W power limit).  A copy of the
program's table (``repro_torch/roofline/analysis.py``), kept here so the
yardstick does not move with the program."""

PEAK_INT8 = 1979e12       # OP/s, int8 tensor cores
PEAK_BF16 = 989e12        # FLOP/s, bf16 tensor cores
PEAK_F32 = 67e12          # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12          # B/s, HBM3
