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
// What bounds it on the H100: bytes, by design.  Per block it reads 256 B
// of levels and 4 B of predictor and writes 320 B of fused slots (about
// 450 MB at 16 x 1080p, 0.14 ms at 3.35 TB/s).  A thread per block took
// 1.76 ms there (H100 SXM, 700 W): neighbouring threads loaded 16 B 256 B
// apart and stored 4 B 64 B apart, and the 64-step emission was a serial
// chain.  Now both sides coalesce and a block's emission is 16 lanes wide:
// 0.20 ms, 1.5x the bound.  What is left is the latency of one load per
// warp and pass, hidden by loading the next pair while emitting this one;
// 32 registers and 5.3 KB of shared memory keep 8 blocks of 256 threads
// (64 warps) on each SM.
//
// Design: the warp-cooperative emission of vlc_emit.cuh (emit_fused4_lane),
// B1's emission, on levels read from memory instead of computed in
// registers.  Blocks go in pairs to warps, over the whole batch at once (a
// slice row holds NB blocks, a multiple of 6, so a pair never straddles
// rows and block i of the batch is component i % 6): lanes 0-15 take the
// even block, 16-31 the odd one, lane j one 16-byte load of levels 4j ..
// 4j+3, so a warp reads 512 B and writes five 128-byte lines.  A block
// needs nothing from any other block (the predictors are an input), so
// there is no shared memory beyond the tables, and the grid is as many
// blocks as the card holds at once, each walking pairs with a stride.  The
// 4:1 fusion happens in registers, so the raw slots never reach device
// memory (the TPU wrote them and fused them in XLA).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "device_guard.cuh"
#include "vlc_emit.cuh"

namespace {

using namespace vlc;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNB = 6 * 256;  // width 4096, as B1

__global__ void __launch_bounds__(kThreads)
vlc_levels4_kernel(const int4* __restrict__ levels, const int32_t* __restrict__ preds,
                   int pairs, const int32_t* __restrict__ ac_code,
                   const int32_t* __restrict__ ac_len, const int32_t* __restrict__ dc_code,
                   const int32_t* __restrict__ dc_len, int32_t* __restrict__ out_v0,
                   int32_t* __restrict__ out_v1, int32_t* __restrict__ out_v2,
                   int32_t* __restrict__ out_v3, int32_t* __restrict__ out_len) {
  __shared__ uint32_t s_ac[kAcRuns * kAcLevels];  // code | len << 16
  __shared__ uint32_t s_dcc[2 * kDcSizes];        // code | len << 16, [luma][size]

  const int lane = threadIdx.x & 31, j = lane & 15;
  const FusedOut out{out_v0, out_v1, out_v2, out_v3, out_len};

  load_vlc_tables(s_ac, s_dcc, ac_code, ac_len, dc_code, dc_len, threadIdx.x, kThreads);
  __syncthreads();

  // the half-warp's block of pair p, its levels 4j .. 4j+3 and (lane j = 0)
  // its predictor
  auto load = [&](int p, int4& q, int& pred) {
    const int blk = 2 * p + (lane >> 4);
    q = __ldg(levels + (size_t)blk * 16 + j);
    pred = j == 0 ? __ldg(preds + blk) : 0;
  };
  const int stride = gridDim.x * kWarps;
  int p = blockIdx.x * kWarps + (threadIdx.x >> 5);  // warp-uniform
  int4 q = {0, 0, 0, 0};
  int pred = 0;
  if (p < pairs) load(p, q, pred);
  for (; p < pairs; p += stride) {
    const int blk = 2 * p + (lane >> 4);
    const int lv[4] = {q.x, q.y, q.z, q.w};
    const int pr = pred;
    if (p + stride < pairs) load(p + stride, q, pred);
    uint32_t code0 = 0;
    int len0 = 0;
    if (j == 0) code0 = emit_dc(lv[0], pr, blk % 6, s_dcc, len0);
    emit_fused4_lane(lv, lane, code0, len0, s_ac, out, (size_t)blk * 16 + j);
  }
}

}  // namespace

extern "C" int vlc_levels4_launch(const void* levels, const void* preds, int rows, int nb,
                                  const void* ac_code, const void* ac_len,
                                  const void* dc_code, const void* dc_len, void* v0,
                                  void* v1, void* v2, void* v3, void* flens, int device,
                                  void* stream) {
  if (rows < 0 || nb < 0 || nb % 6 || nb > kMaxNB || ((uintptr_t)levels & 15) ||
      (long long)rows * nb > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  if (rows == 0 || nb == 0) return (int)cudaSuccess;
  // as many blocks as are resident at once, or fewer for a small input
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vlc_levels4_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int pairs = rows * nb / 2;
  const int grid = (int)std::min<long long>((pairs + kWarps - 1) / kWarps,
                                            (long long)sms * std::max(per_sm, 1));
  vlc_levels4_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)levels, (const int32_t*)preds, pairs, (const int32_t*)ac_code,
      (const int32_t*)ac_len, (const int32_t*)dc_code, (const int32_t*)dc_len,
      (int32_t*)v0, (int32_t*)v1, (int32_t*)v2, (int32_t*)v3, (int32_t*)flens);
  return (int)cudaGetLastError();
}

extern "C" const char* vlc_levels4_strerror(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
