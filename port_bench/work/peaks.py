"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), by the precision the cell's math
runs in."""

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_FLOPS = {
    "fp32_parity": 67e12,  # fp32 outside the tensor cores
    "tf32": 495e12,  # TF32 tensor cores
    "bf16": 989e12,  # bf16 tensor cores
}
