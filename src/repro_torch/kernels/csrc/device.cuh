// The card's shape that the launchers size their grids by, read from the
// runtime once per device and kept: a launch then makes one cheap
// cudaGetDevice call, not three queries. Also the block's dynamic shared
// memory, which the packed round sum's partial sums and the QMGeo encoder's
// level tables (qmgeo_encode.cuh) live in.
#pragma once
#include <cuda_runtime.h>

#include <atomic>

namespace repro {

struct DeviceShape {
  int sms;            // streaming multiprocessors (132 on an H100 SXM)
  int threads_per_sm; // resident threads an SM holds (2048 on Hopper)
};

inline DeviceShape device_shape() {
  constexpr int kDevices = 64;
  static std::atomic<int> sms[kDevices], threads[kDevices];
  int device = 0;
  cudaGetDevice(&device);
  const bool kept = device < kDevices;
  DeviceShape shape{kept ? sms[device].load(std::memory_order_relaxed) : 0,
                    kept ? threads[device].load(std::memory_order_relaxed) : 0};
  if (shape.sms == 0 || shape.threads_per_sm == 0) {
    cudaDeviceGetAttribute(&shape.sms, cudaDevAttrMultiProcessorCount, device);
    cudaDeviceGetAttribute(&shape.threads_per_sm,
                           cudaDevAttrMaxThreadsPerMultiProcessor, device);
    if (kept) {
      sms[device].store(shape.sms, std::memory_order_relaxed);
      threads[device].store(shape.threads_per_sm, std::memory_order_relaxed);
    }
  }
  return shape;
}

// The block's dynamic shared memory: one declaration for every kernel of a
// library, 16-byte aligned.
__device__ __forceinline__ unsigned char* dynamic_shared() {
  extern __shared__ __align__(16) unsigned char repro_dynamic_shared[];
  return repro_dynamic_shared;
}

}  // namespace repro
