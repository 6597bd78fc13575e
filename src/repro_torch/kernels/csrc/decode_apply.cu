// The server side of a fused round: decode the SecAgg level sum and apply
// the SGD step in one elementwise pass,
//
//     g = -x_max + z * scale;   w' = w - lr * g
//
// with exactly the float association of repro's grid.decode_sum followed by
// optim.sgd. Three entries:
//
//  * decode_apply_sum: z is the dense int32 sum. Replaces the Pallas kernel
//    repro/kernels/decode_apply_kernel.py:decode_apply_sum_2d (:103).
//  * unpack_decode_apply: z is field (i / W) of packed word (i % W), read
//    straight from the wire words. Replaces the Pallas kernel
//    repro/kernels/pack_kernel.py:unpack_decode_apply (:138). Unlike the
//    TPU kernel it takes any word count W, not only multiples of 128.
//  * decode_apply: the folded form w' = w - (shift + scale * z), with lr
//    folded into shift = -lr x_max and scale = lr 2 x_max / (n (m-1)). Not
//    bit-identical to the two above (another association), so no round
//    runs it; w is float32 or bfloat16, computed in float32 and rounded
//    once to w's type. Replaces the Pallas kernel
//    repro/kernels/decode_apply_kernel.py:decode_apply_2d (:33).
//
// Thread i owns coordinate i. Bound on an H100: bytes (read w and the sum,
// write w'); a handful of float ops per 12 bytes. The _rn intrinsics keep
// every step separately rounded, so the result matches the plain version
// bit for bit.
#include <cuda_bf16.h>
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

__device__ __forceinline__ float load_f32(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void decode_apply_folded_kernel(const T* __restrict__ w,
                                           const int* __restrict__ z,
                                           T* __restrict__ out, int n, float shift,
                                           float scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float step = __fadd_rn(shift, __fmul_rn(scale, __int2float_rn(z[i])));
  store(out, i, __fsub_rn(load_f32(w, i), step));
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

int decode_apply(const void* w, const int* z, void* out, int n, int bf16,
                 float shift, float scale, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    decode_apply_folded_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(w), z, static_cast<__nv_bfloat16*>(out), n,
        shift, scale);
  } else {
    decode_apply_folded_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(w), z, static_cast<float*>(out), n, shift, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* decode_apply_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
