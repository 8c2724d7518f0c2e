"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit), and the 32-bit integer issue rate: 64
add/shift/compare/multiply-add per SM per clock (CUDA C++ Programming
Guide, compute capability 9.0) x 132 SMs x 1.98 GHz, as `chip_smoke.py`
takes it."""

MEM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 64 * 132 * 1.98e9
F32_FLOPS_PER_S = 67e12  # outside the tensor cores
