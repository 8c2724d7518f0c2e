// lut_lookup: out[i] = table[idx[i]] for a small table, 0 off the table.
//
// Replaces the Pallas kernel ec504_imageencoder_tpu/ops/mxu_lut.py: the
// inner `kernel` of `tpu_lookup` in `_onehot_lookup_packed_mxu`, which the
// reference's XLA VLC path on a TPU reaches through `ac_table_lookup` (the
// 112-entry rank-compressed AC table, `code | len << 16`) and
// `dc_size_lookup` (the 32-entry dct_dc_size table, `code | len << 8`).
// The TPU could not gather, so it contracted one-hot rows against byte
// planes of the table on the MXU; an index outside the table matched no
// row and gave 0.  A GPU gathers: this kernel is a plain lookup with the
// same result, 0 for an index outside [0, m).
//
// What bounds it on the H100: bytes.  It reads 4 B of index and writes 4 B
// of value per element (400 MB for the 50.1 M AC lookups of 16 x 1080p at
// q=85, 0.12 ms at 3.35 TB/s); the table (<= 512 B) sits in shared memory,
// so the gather costs no device-memory traffic.
//
// Design: the table is copied to shared memory once per block; a
// grid-stride loop gives each thread one index at a time, neighbouring
// threads on neighbouring elements (coalesced loads and stores).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTable = 128;

__global__ void __launch_bounds__(kThreads)
lut_lookup_kernel(const int32_t* __restrict__ idx, long long n,
                  const int32_t* __restrict__ table, int m, int32_t* __restrict__ out) {
  __shared__ int32_t s_tab[kMaxTable];
  for (int i = threadIdx.x; i < m; i += kThreads) s_tab[i] = table[i];
  __syncthreads();
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += step) {
    const int k = __ldg(idx + i);
    out[i] = (unsigned)k < (unsigned)m ? s_tab[k] : 0;
  }
}

}  // namespace

extern "C" int lut_lookup_launch(const void* idx, long long n, const void* table, int m,
                                 void* out, int device, void* stream) {
  if (n < 0 || m < 0 || m > kMaxTable) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaSuccess;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 8LL * sms ? want : 8LL * sms);
  lut_lookup_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, n, (const int32_t*)table, m, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* lut_lookup_strerror(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
