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
//  * unpack_decode_apply: z is field (c / W) of packed word (c % W), read
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
// The first two take the walk of walk.cuh (decode_walk below):
// unpack_decode_apply walks the words as the codec does (V 2 or 1, picked
// by unpack_decode_walk from W, n and the three addresses, as
// kernels/pack_kernel.py:codec_walk does; kWalkGroups groups a thread);
// decode_apply_sum is the same walk with one field a word (K = 1, V = 1, the
// dense z in place of the words), kSumGroups coordinates a thread, kThreads
// apart. A thread issues all its loads (each word once, and w at each of
// its coordinates below n) before it uses the first, then stores; k = 32 /
// bits is a template argument, so no index needs a division. Bound on an
// H100: bytes (read w and the sum, write w'), a handful of float ops per 12
// bytes; but the round's 2.7 MB sit in L2, and the time is the launch's
// fixed cost plus each thread's chain of 14 to 21 issued instructions a
// coordinate, which the one or two warps a scheduler of a small grid do
// not hide. So the dense sum takes 4 coordinates a thread (217 blocks at
// the CNN's n = 222,030) where the codec's walk takes 12, and the packed
// entry the codec's walk (73 blocks at the paper's W = 74,010 and V = 2),
// each the fastest of the variants timed on an H100 (PERF.md). The _rn intrinsics keep every step separately rounded, so the
// result matches the plain version bit for bit.
//
// decode_apply gives thread i coordinate i.
#include <cuda_bf16.h>

#include "walk.cuh"

namespace {

using repro::Lanes;
constexpr int kThreads = repro::kWalkThreads;
constexpr int kSumGroups = 4;  // coordinates a thread of decode_apply_sum

__device__ __forceinline__ float decode_apply(float w, int z, float neg_x_max,
                                              float scale, float lr) {
  const float g = __fadd_rn(neg_x_max, __fmul_rn(__int2float_rn(z), scale));
  return __fsub_rn(w, __fmul_rn(lr, g));
}

// Decode + apply of the K fields of each of a thread's G V-groups of words.
// With K = 1 a word is the level itself.
template <int K, int V, int G>
__device__ __forceinline__ void decode_walk(const float* __restrict__ w,
                                            const int* __restrict__ words,
                                            float* __restrict__ out, int n, int n_words,
                                            int bits, float neg_x_max, float scale,
                                            float lr) {
  const int j0 = static_cast<int>(blockIdx.x * kThreads * G + threadIdx.x) * V;
  Lanes<V> in[G];
  Lanes<V, float> param[G][K];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int j = j0 + g * kThreads * V;
    if (j < n_words) in[g] = *reinterpret_cast<const Lanes<V>*>(words + j);
#pragma unroll
    for (int f = 0; f < K; ++f) {
      const int c = f * n_words + j;
      if (j < n_words && c < n) param[g][f] = *reinterpret_cast<const Lanes<V, float>*>(w + c);
    }
  }
  const uint32_t mask = K == 1 ? ~0u : (1u << bits) - 1u;  // bits <= 16 where K > 1
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int j = j0 + g * kThreads * V;
    if (j >= n_words) return;
#pragma unroll
    for (int f = 0; f < K; ++f) {
      const int c = f * n_words + j;
      if (c < n) {
        Lanes<V, float> o;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int z = static_cast<int>((static_cast<uint32_t>(in[g].v[i]) >> (f * bits)) & mask);
          o.v[i] = decode_apply(param[g][f].v[i], z, neg_x_max, scale, lr);
        }
        *reinterpret_cast<Lanes<V, float>*>(out + c) = o;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    decode_apply_sum_kernel(const float* __restrict__ w, const int* __restrict__ z,
                            float* __restrict__ out, int n, float neg_x_max, float scale,
                            float lr) {
  decode_walk<1, 1, kSumGroups>(w, z, out, n, n, 0, neg_x_max, scale, lr);
}

template <int K, int V>
__global__ void __launch_bounds__(kThreads)
    unpack_decode_apply_kernel(const float* __restrict__ w, const int* __restrict__ words,
                               float* __restrict__ out, int n, int n_words, int bits,
                               float neg_x_max, float scale, float lr) {
  decode_walk<K, V, repro::kWalkGroups>(w, words, out, n, n_words, bits, neg_x_max, scale,
                                        lr);
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

}  // namespace

extern "C" {

// The walk unpack_decode_apply takes over n fields of `bits` in n_words
// words, between w, words and out: its width *v and its grid *blocks.
// Returns cudaErrorInvalidValue for a width outside 1..16, n < 1, or
// k * n_words past INT_MAX.
int unpack_decode_walk(int n, int n_words, int bits, const void* w, const void* words,
                       const void* out, int* v, int* blocks) {
  return repro::walk(n, n_words, bits, {w, words, out}, v, blocks);
}

// Refuses n < 1, and n so large that the last thread's coordinate passes
// INT_MAX.
int decode_apply_sum(const float* w, const int* z, float* out, int n, float neg_x_max,
                     float scale, float lr, void* stream) {
  constexpr int kPerBlock = kThreads * kSumGroups;
  if (n < 1 || n > INT_MAX - kPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  decode_apply_sum_kernel<<<(n + kPerBlock - 1) / kPerBlock, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(w, z, out, n, neg_x_max,
                                                                 scale, lr);
  return static_cast<int>(cudaGetLastError());
}

int unpack_decode_apply(const float* w, const int* words, float* out, int n, int n_words,
                        int bits, float neg_x_max, float scale, float lr, void* stream) {
  int v, blocks;
  if (const int err = unpack_decode_walk(n, n_words, bits, w, words, out, &v, &blocks))
    return err;
  return repro::dispatch(bits, v, [&](auto k, auto width) {
    unpack_decode_apply_kernel<decltype(k)::value, decltype(width)::value>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            w, words, out, n, n_words, bits, neg_x_max, scale, lr);
    return static_cast<int>(cudaGetLastError());
  });
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
