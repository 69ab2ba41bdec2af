"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): float32 outside the tensor cores, and HBM3
bandwidth. The port pins float32 products to true f32 (TF32 off), so f32 is
the peak its work is held to."""

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
