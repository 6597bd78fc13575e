// The server side of a fused round: decode the SecAgg level sum and apply
// the SGD step in one elementwise pass,
//
//     g = -x_max + z * scale;   w' = w - lr * g
//
// with exactly the float association of repro's grid.decode_sum followed by
// optim.sgd. Three entries, and two _dev twins:
//
//  * decode_apply_sum: z is the dense int32 sum. Replaces the Pallas kernel
//    repro/kernels/decode_apply_kernel.py:decode_apply_sum_2d (:103).
//  * unpack_decode_apply: z is field (c / W) of packed word (c % W), read
//    straight from the wire words. Replaces the Pallas kernel
//    repro/kernels/pack_kernel.py:unpack_decode_apply (:138). Unlike the
//    TPU kernel it takes any word count W, not only multiples of 128.
//  * decode_apply_sum_dev, unpack_decode_apply_dev: the two entries above
//    at a realized cohort size n read from device memory (a heterogeneous
//    cohort, whose size exists only on the device in a captured round):
//    scale = f32(2 x_max) / f32(n (m-1)), the reference's arithmetic at a
//    traced n (the by-value entries take the scale rounded once from a
//    double, the reference's at a static n; the two differ by one ULP at
//    some n); at n = 0 (an empty round) w' = w. The reference decodes such
//    rounds in jnp (repro/kernels/decode_apply_kernel.py:138-181).
//  * decode_apply: the folded form w' = w - (shift + scale * z), with lr
//    folded into shift = -lr x_max and scale = lr 2 x_max / (n (m-1)). Not
//    bit-identical to the two above (another association), so no round
//    runs it; w is float32 or bfloat16, computed in float32 and rounded
//    once to w's type. Replaces the Pallas kernel
//    repro/kernels/decode_apply_kernel.py:decode_apply_2d (:33).
//
// All three take the walk of walk.cuh (decode_walk below), with the step a
// coordinate (Literal or Folded) and the parameters' type T (float, or
// __nv_bfloat16 for decode_apply) as template arguments:
// unpack_decode_apply walks the words as the codec does (V 2 or 1, picked
// by unpack_decode_walk from W, n and the three addresses, as
// kernels/pack_kernel.py:codec_walk does; kWalkGroups groups a thread);
// decode_apply_sum is the same walk with one field a word (K = 1, V = 1, the
// dense z in place of the words), kSumGroups coordinates a thread, kThreads
// apart; decode_apply the same dense walk, kFoldedGroups V-groups a thread,
// V 2 or 1 (decode_apply_walk: 2 where n is even and every operand is
// aligned to two of its elements, as kernels/decode_apply_kernel.py:
// folded_walk does). A thread issues all its loads (each word once, and w at
// each of its coordinates below n) before it uses the first, then stores;
// k = 32 / bits is a template argument, so no index needs a division. Bound
// on an H100: bytes (read w and the sum, write w'), a handful of float ops
// per 12 bytes (8 in bfloat16); but the round's 2.7 MB sit in L2, and the
// time is the launch's fixed cost plus each thread's chain of 14 to 21
// issued instructions a coordinate, which the one or two warps a scheduler
// of a small grid do not hide. So the dense sum takes 4 coordinates a
// thread (217 blocks at the CNN's n = 222,030) where the codec's walk takes
// 12, and the packed entry the codec's walk (73 blocks at the paper's W =
// 74,010 and V = 2), each the fastest of the variants timed on an H100
// (PERF.md). The _rn intrinsics keep every step separately rounded, so the
// result matches the plain version bit for bit.
#include <cuda_bf16.h>

#include "walk.cuh"

namespace {

using repro::Lanes;
constexpr int kThreads = repro::kWalkThreads;
constexpr int kSumGroups = 4;     // coordinates a thread of decode_apply_sum
constexpr int kFoldedGroups = 4;  // V-groups a thread of decode_apply

// The step of rows 3-4: decode_sum's g, then SGD.
struct Literal {
  float neg_x_max, scale, lr;
  __device__ __forceinline__ float operator()(float w, int z) const {
    const float g = __fadd_rn(neg_x_max, __fmul_rn(__int2float_rn(z), scale));
    return __fsub_rn(w, __fmul_rn(lr, g));
  }
};

// The step of an empty round (a _dev entry at n = 0): w unchanged.
struct Keep {
  __device__ __forceinline__ float operator()(float w, int) const { return w; }
};

// The scale of a _dev entry at the realized count n > 0.
__device__ __forceinline__ float count_scale(int n, float two_x_max, int m_minus_1) {
  return __fdiv_rn(two_x_max, __int2float_rn(n * m_minus_1));
}

// The step of decode_apply: w - (shift + scale * z).
struct Folded {
  float shift, scale;
  __device__ __forceinline__ float operator()(float w, int z) const {
    return __fsub_rn(w, __fadd_rn(shift, __fmul_rn(scale, __int2float_rn(z))));
  }
};

__device__ __forceinline__ float load_f32(float v) { return v; }
__device__ __forceinline__ float load_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T store_as(float v);
template <>
__device__ __forceinline__ float store_as<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Decode + apply of the K fields of each of a thread's G V-groups of words.
// With K = 1 a word is the level itself.
template <int K, int V, int G, typename T, class Step>
__device__ __forceinline__ void decode_walk(const T* __restrict__ w,
                                            const int* __restrict__ words,
                                            T* __restrict__ out, int n, int n_words,
                                            int bits, Step step) {
  const int j0 = static_cast<int>(blockIdx.x * kThreads * G + threadIdx.x) * V;
  Lanes<V> in[G];
  Lanes<V, T> param[G][K];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int j = j0 + g * kThreads * V;
    if (j < n_words) in[g] = *reinterpret_cast<const Lanes<V>*>(words + j);
#pragma unroll
    for (int f = 0; f < K; ++f) {
      const int c = f * n_words + j;
      if (j < n_words && c < n) param[g][f] = *reinterpret_cast<const Lanes<V, T>*>(w + c);
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
        Lanes<V, T> o;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int z = static_cast<int>((static_cast<uint32_t>(in[g].v[i]) >> (f * bits)) & mask);
          o.v[i] = store_as<T>(step(load_f32(param[g][f].v[i]), z));
        }
        *reinterpret_cast<Lanes<V, T>*>(out + c) = o;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    decode_apply_sum_kernel(const float* __restrict__ w, const int* __restrict__ z,
                            float* __restrict__ out, int n, float neg_x_max, float scale,
                            float lr) {
  decode_walk<1, 1, kSumGroups>(w, z, out, n, n, 0, Literal{neg_x_max, scale, lr});
}

template <int K, int V>
__global__ void __launch_bounds__(kThreads)
    unpack_decode_apply_kernel(const float* __restrict__ w, const int* __restrict__ words,
                               float* __restrict__ out, int n, int n_words, int bits,
                               float neg_x_max, float scale, float lr) {
  decode_walk<K, V, repro::kWalkGroups>(w, words, out, n, n_words, bits,
                                        Literal{neg_x_max, scale, lr});
}

__global__ void __launch_bounds__(kThreads)
    decode_apply_sum_dev_kernel(const float* __restrict__ w, const int* __restrict__ z,
                                float* __restrict__ out, int n, const int* __restrict__ count,
                                float neg_x_max, float two_x_max, int m_minus_1, float lr) {
  const int k = *count;
  if (k > 0)
    decode_walk<1, 1, kSumGroups>(w, z, out, n, n, 0,
                                  Literal{neg_x_max, count_scale(k, two_x_max, m_minus_1), lr});
  else
    decode_walk<1, 1, kSumGroups>(w, z, out, n, n, 0, Keep{});
}

template <int K, int V>
__global__ void __launch_bounds__(kThreads)
    unpack_decode_apply_dev_kernel(const float* __restrict__ w, const int* __restrict__ words,
                                   float* __restrict__ out, int n, int n_words, int bits,
                                   const int* __restrict__ count, float neg_x_max,
                                   float two_x_max, int m_minus_1, float lr) {
  const int k = *count;
  if (k > 0)
    decode_walk<K, V, repro::kWalkGroups>(
        w, words, out, n, n_words, bits,
        Literal{neg_x_max, count_scale(k, two_x_max, m_minus_1), lr});
  else
    decode_walk<K, V, repro::kWalkGroups>(w, words, out, n, n_words, bits, Keep{});
}

template <int V, typename T>
__global__ void __launch_bounds__(kThreads)
    decode_apply_folded_kernel(const T* __restrict__ w, const int* __restrict__ z,
                               T* __restrict__ out, int n, float shift, float scale) {
  decode_walk<1, V, kFoldedGroups>(w, z, out, n, n, 0, Folded{shift, scale});
}

template <typename T>
int launch_folded(const void* w, const int* z, void* out, int n, int v, int blocks,
                  float shift, float scale, cudaStream_t s) {
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (v == 2)
    decode_apply_folded_kernel<2><<<blocks, kThreads, 0, s>>>(wt, z, ot, n, shift, scale);
  else
    decode_apply_folded_kernel<1><<<blocks, kThreads, 0, s>>>(wt, z, ot, n, shift, scale);
  return static_cast<int>(cudaGetLastError());
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

// The walk decode_apply takes over n coordinates between w and out (float32,
// or bfloat16 where bf16 is set) and the int32 sum z: its width *v, 2 where
// n is even, w and out are aligned to two parameters and z to two ints,
// else 1, and its grid *blocks. Returns cudaErrorInvalidValue for n < 1, or
// n so large that the last thread's coordinate of a block of V = 2 passes
// INT_MAX.
int decode_apply_walk(int n, int bf16, const void* w, const void* z, const void* out,
                      int* v, int* blocks) {
  constexpr int kPerBlock = kThreads * kFoldedGroups * 2;
  if (n < 1 || n > INT_MAX - kPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t pair = bf16 ? 4 : 8;
  const bool pairs = n % 2 == 0 && reinterpret_cast<uintptr_t>(w) % pair == 0 &&
                     reinterpret_cast<uintptr_t>(out) % pair == 0 &&
                     reinterpret_cast<uintptr_t>(z) % 8 == 0;
  *v = pairs ? 2 : 1;
  *blocks = (n / *v + kThreads * kFoldedGroups - 1) / (kThreads * kFoldedGroups);
  return 0;
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

// decode_apply_sum at the realized count *count (device memory).
int decode_apply_sum_dev(const float* w, const int* z, float* out, int n, const int* count,
                         float neg_x_max, float two_x_max, int m_minus_1, float lr,
                         void* stream) {
  constexpr int kPerBlock = kThreads * kSumGroups;
  if (n < 1 || n > INT_MAX - kPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  decode_apply_sum_dev_kernel<<<(n + kPerBlock - 1) / kPerBlock, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      w, z, out, n, count, neg_x_max, two_x_max, m_minus_1, lr);
  return static_cast<int>(cudaGetLastError());
}

// unpack_decode_apply at the realized count *count (device memory).
int unpack_decode_apply_dev(const float* w, const int* words, float* out, int n, int n_words,
                            int bits, const int* count, float neg_x_max, float two_x_max,
                            int m_minus_1, float lr, void* stream) {
  int v, blocks;
  if (const int err = unpack_decode_walk(n, n_words, bits, w, words, out, &v, &blocks))
    return err;
  return repro::dispatch(bits, v, [&](auto k, auto width) {
    unpack_decode_apply_dev_kernel<decltype(k)::value, decltype(width)::value>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            w, words, out, n, n_words, bits, count, neg_x_max, two_x_max, m_minus_1, lr);
    return static_cast<int>(cudaGetLastError());
  });
}

// Refuses what decode_apply_walk refuses.
int decode_apply(const void* w, const int* z, void* out, int n, int bf16, float shift,
                 float scale, void* stream) {
  int v, blocks;
  if (const int err = decode_apply_walk(n, bf16, w, z, out, &v, &blocks)) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_folded<__nv_bfloat16>(w, z, out, n, v, blocks, shift, scale, s)
              : launch_folded<float>(w, z, out, n, v, blocks, shift, scale, s);
}

const char* decode_apply_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
