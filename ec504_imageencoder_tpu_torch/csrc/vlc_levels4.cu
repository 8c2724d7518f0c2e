// vlc_levels4: zigzag levels + DC predictors -> 4:1-fused VLC slots.
//
// Replaces the Pallas kernel ec504_imageencoder_tpu/ops/pallas_vlc.py
// `_vlc_kernel` (launched by `vlc_slots_tpu`) and the XLA
// `fuse_slots_streamwise` behind it: the VLC emission of the high-quality
// path (f32 DCT at quality >= 70), whose DCT, quantization, zigzag and DC
// prediction run as PyTorch ops in front of it.  Per 8x8 block it emits
// the 64 correct-mode slots (dct_dc_size VLC + differential DC with the
// MB header folded in, AC run/level codes or escapes, EOB folded into slot
// 63) and fuses them 4:1 exactly, in stream order: B1's output format,
// ready for the pack kernel.
//
// What bounds it on the H100: per block it reads 256 B of levels and 4 B
// of predictor and writes 320 B of fused slots (about 450 MB at 16 x
// 1080p, 0.14 ms at 3.35 TB/s).  It takes 1.77 ms there (H100 SXM,
// 700 W): neither side is coalesced (neighbouring threads load 16 B
// 256 B apart and store 4 B 64 B apart), and the 64-step sequential
// emission is integer latency, as in B1.  Staging both through shared
// memory, or computing the levels in the kernel as B1 does, is the next
// step.
//
// Design: B1's emission (vlc_emit.cuh) on levels read from memory instead
// of computed in registers.  One CUDA block per slice row; threads loop
// over the row's NB blocks.  A thread reads its block's levels as 16
// 16-byte loads, one per fused slot, so the four levels of a fused slot
// arrive together; the tables live in shared memory.  The 4:1 fusion
// happens in registers, so the raw slots never reach device memory (the
// TPU wrote them and fused them in XLA).

#include <cuda_runtime.h>
#include <stdint.h>

#include "vlc_emit.cuh"

namespace {

using namespace vlc;

constexpr int kThreads = 128;
constexpr int kMaxNB = 6 * 256;  // width 4096, as B1

// The 64 levels of a block, contiguous in device memory.
struct RowLevels {
  const int4* row;
  __device__ __forceinline__ void operator()(int j, int lv[4]) const {
    const int4 q = __ldg(row + j);
    lv[0] = q.x;
    lv[1] = q.y;
    lv[2] = q.z;
    lv[3] = q.w;
  }
};

__global__ void __launch_bounds__(kThreads)
vlc_levels4_kernel(const int32_t* __restrict__ levels, const int32_t* __restrict__ preds,
                   int nb, const int32_t* __restrict__ ac_code,
                   const int32_t* __restrict__ ac_len, const int32_t* __restrict__ dc_code,
                   const int32_t* __restrict__ dc_len, int32_t* __restrict__ out_v0,
                   int32_t* __restrict__ out_v1, int32_t* __restrict__ out_v2,
                   int32_t* __restrict__ out_v3, int32_t* __restrict__ out_len) {
  __shared__ uint32_t s_ac[kAcRuns * kAcLevels];  // code | len << 16
  __shared__ uint32_t s_dcc[2 * kDcSizes];        // code | len << 16, [luma][size]

  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const FusedOut out{out_v0, out_v1, out_v2, out_v3, out_len};

  load_vlc_tables(s_ac, s_dcc, ac_code, ac_len, dc_code, dc_len, tid, kThreads);
  __syncthreads();

  for (int n = tid; n < nb; n += kThreads) {
    const size_t blk = (size_t)row * nb + n;
    const int32_t* lv = levels + blk * 64;
    int len0;
    const uint32_t code0 = emit_dc(__ldg(lv), __ldg(preds + blk), n % 6, s_dcc, len0);
    emit_block_fused4(RowLevels{reinterpret_cast<const int4*>(lv)}, code0, len0, s_ac,
                      out, blk * 16);
  }
}

}  // namespace

extern "C" int vlc_levels4_launch(const void* levels, const void* preds, int rows, int nb,
                                  const void* ac_code, const void* ac_len,
                                  const void* dc_code, const void* dc_len, void* v0,
                                  void* v1, void* v2, void* v3, void* flens, int device,
                                  void* stream) {
  if (rows < 0 || nb < 0 || nb % 6 || nb > kMaxNB || ((uintptr_t)levels & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0 || nb == 0) return (int)cudaSuccess;
  vlc_levels4_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)levels, (const int32_t*)preds, nb, (const int32_t*)ac_code,
      (const int32_t*)ac_len, (const int32_t*)dc_code, (const int32_t*)dc_len,
      (int32_t*)v0, (int32_t*)v1, (int32_t*)v2, (int32_t*)v3, (int32_t*)flens);
  return (int)cudaGetLastError();
}

extern "C" const char* vlc_levels4_strerror(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
