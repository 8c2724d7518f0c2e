"""PyTorch + CUDA port of the MPEG-1 intra encoder.

The JAX package `ec504_imageencoder_tpu` is the reference; this package
computes the same bytes on an NVIDIA Hopper GPU.  Plain tensor code is
PyTorch; the hot stages (the fused DCT/quantize/VLC stages and the
bit-packing stages) are hand-written CUDA C++ kernels under `csrc/`,
compiled with nvcc at first use.  Every kernel has a plain PyTorch twin
in the same module, which the wrapper runs only for CPU tensors.

The entry points are the reference's: `mpeg_encode_procedure` and
`encode_video` (below), `api.encode_jpeg_folder`, the CLI
(`python -m ec504_imageencoder_tpu_torch.cli`, console script
`mpeg-encode-torch`) and a C ABI shim (`io/native/encoder_capi.cpp`); they
run on "cuda" unless asked for the CPU.  JPEG folders are decoded by the
port's own g++ build of the stb-compatible decoder (`io/`).

The package stands alone: it keeps its own copies of the reference's
host code (tables, header builders, slice sizing, stream assembly, JPEG
intake, muxing, metrics, checkpointing), held equal to the reference's by
the tests, and imports neither JAX nor anything of the reference package.
"""

from ec504_imageencoder_tpu_torch.api import encode_video, mpeg_encode_procedure

__all__ = ["encode_video", "mpeg_encode_procedure"]
