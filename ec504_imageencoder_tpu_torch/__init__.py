"""PyTorch + CUDA port of the correct-mode MPEG-1 intra encoder.

The JAX package `ec504_imageencoder_tpu` is the reference; this package
computes the same bytes on an NVIDIA Hopper GPU.  Plain tensor code is
PyTorch; the two hot stages (the fused DCT/quantize/VLC stage and the
bit-packing stage) are hand-written CUDA C++ kernels under `csrc/`,
compiled with nvcc at first use.  Every kernel has a plain PyTorch twin
in the same module, which the wrapper runs only for CPU tensors.

Host code of the reference that never imports JAX (tables, headers,
stream assembly, the spec decoder) is shared by import.  Nothing here
imports JAX.
"""
