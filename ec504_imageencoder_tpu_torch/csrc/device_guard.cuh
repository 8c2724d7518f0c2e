// The device of a launch, for every C entry point: the kernel runs on the
// device index the wrapper passes (the tensors' device), and the calling
// thread's current CUDA device is the same after the call as before it, on
// every return path.  Without the restore, a launch on cuda:1 would leave
// cuda:1 current, and a later `device="cuda"` (torch.cuda.current_device())
// or torch's default allocations would land there.  Host code only.

#pragma once

#include <cuda_runtime.h>

// Makes `device` current for the guard's scope; error() is the failure of
// cudaGetDevice or cudaSetDevice (the launcher returns it and launches
// nothing).  The destructor restores the previous device only if the
// constructor changed it.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      changed_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (changed_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool changed_ = false;
  cudaError_t err_ = cudaSuccess;
};
