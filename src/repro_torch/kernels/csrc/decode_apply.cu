// The server side of a fused round: decode the SecAgg level sum and apply
// the SGD step in one elementwise pass,
//
//     g = -x_max + z * scale;   w' = w - lr * g
//
// with exactly the float association of repro's grid.decode_sum followed by
// optim.sgd. Two entries:
//
//  * decode_apply_sum: z is the dense int32 sum. Replaces the Pallas kernel
//    repro/kernels/decode_apply_kernel.py:decode_apply_sum_2d (:103).
//  * unpack_decode_apply: z is field (i / W) of packed word (i % W), read
//    straight from the wire words. Replaces the Pallas kernel
//    repro/kernels/pack_kernel.py:unpack_decode_apply (:138). Unlike the
//    TPU kernel it takes any word count W, not only multiples of 128.
//
// Thread i owns coordinate i. Bound on an H100: bytes (read w and the sum,
// write w'); a handful of float ops per 12 bytes. The _rn intrinsics keep
// every step separately rounded, so the result matches the plain version
// bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float decode_apply(float w, int z, float neg_x_max,
                                              float scale, float lr) {
  const float g = __fadd_rn(neg_x_max, __fmul_rn(__int2float_rn(z), scale));
  return __fsub_rn(w, __fmul_rn(lr, g));
}

__global__ void decode_apply_sum_kernel(const float* __restrict__ w,
                                        const int* __restrict__ z,
                                        float* __restrict__ out, int n,
                                        float neg_x_max, float scale, float lr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = decode_apply(w[i], z[i], neg_x_max, scale, lr);
}

__global__ void unpack_decode_apply_kernel(const float* __restrict__ w,
                                           const int* __restrict__ words,
                                           float* __restrict__ out, int n,
                                           int n_words, int bits, float neg_x_max,
                                           float scale, float lr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t word = static_cast<uint32_t>(words[i % n_words]);
  const uint32_t f = static_cast<uint32_t>(i / n_words);
  const uint32_t mask = (1u << bits) - 1u;
  const int z = static_cast<int>((word >> (f * bits)) & mask);
  out[i] = decode_apply(w[i], z, neg_x_max, scale, lr);
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

int decode_apply_sum(const float* w, const int* z, float* out, int n,
                     float neg_x_max, float scale, float lr, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  decode_apply_sum_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w, z, out, n, neg_x_max, scale, lr);
  return static_cast<int>(cudaGetLastError());
}

int unpack_decode_apply(const float* w, const int* words, float* out, int n,
                        int n_words, int bits, float neg_x_max, float scale,
                        float lr, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  unpack_decode_apply_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      w, words, out, n, n_words, bits, neg_x_max, scale, lr);
  return static_cast<int>(cudaGetLastError());
}

const char* decode_apply_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
