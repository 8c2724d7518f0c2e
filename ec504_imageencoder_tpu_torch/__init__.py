"""PyTorch + CUDA port of the MPEG-1 intra encoder.

The JAX package `ec504_imageencoder_tpu` is the reference; this package
computes the same bytes on an NVIDIA Hopper GPU.  Plain tensor code is
PyTorch; the hot stages (the fused DCT/quantize/VLC stages and the
bit-packing stages) are hand-written CUDA C++ kernels under `csrc/`,
compiled with nvcc at first use.  Every kernel has a plain PyTorch twin
in the same module, which the wrapper runs only for CPU tensors.

The package stands alone: it keeps its own copies of the reference's
host code (tables, header builders, slice sizing, stream assembly), held
equal to the reference's by tests/test_torch_host.py, and imports
neither JAX nor anything of the reference package.
"""
