// The dense b-bit wire codec: planar pack and unpack of a flat int32 vector.
//
// Both kernels take the walk of walk.cuh: the layout, the V-groups, kGroups
// of them a thread, and the grid (codec_walk below, mirrored by
// kernels/pack_kernel.py).
//
//  * pack_flat: all k V-wide loads of a thread's groups are issued before
//    the first is used (fields at or past n read as 0); each is shifted
//    into place and added as uint32 (disjoint bit ranges while every level
//    is < 2^bits, so + is |; for other inputs it wraps exactly like the
//    plain version's int64 sum), then one V-wide store a group. Replaces
//    the Pallas kernel repro/kernels/pack_kernel.py:pack_flat (:66), whose
//    output-revisiting grid over fields becomes the unrolled loop.
//  * unpack_flat: one V-wide load a group (each word is read once), then
//    for each field below n one V-wide store of the words shifted as uint32
//    by f * bits and masked. A logical shift plus the mask equals the
//    reference's arithmetic shift plus mask at every width, including the
//    16-bit top field that sets the sign bit. Replaces the Pallas kernel
//    repro/kernels/pack_kernel.py:unpack_flat (:102).
//
// Unlike the TPU kernels these take any word count W (the paper's round has
// W = 74,010, not a multiple of 128: V = 2 there, V = 1 at 16 bits, where
// W = 111,015). Each moves a few bytes for a few integer ops: bound by bytes
// on an H100, but the round's 1.2 MB sit in L2 and take a fraction of a
// launch's fixed cost (about 1.05 us for one block on an H100 80GB HBM3 at
// 700 W). Above that the time grows with the blocks dispatched to an SM
// and with load round trips in series, so the loads issue together and two
// groups a thread halve the blocks (measurements in PERF.md).
#include "walk.cuh"

namespace {

using repro::Lanes;
constexpr int kThreads = repro::kWalkThreads;
constexpr int kGroups = repro::kWalkGroups;  // V-groups a thread, kThreads * V words apart

template <int K, int V>
__global__ void __launch_bounds__(kThreads)
    pack_flat_kernel(const int* __restrict__ z, int* __restrict__ words, int n, int n_words,
                     int bits) {
  const int w0 = static_cast<int>(blockIdx.x * kThreads * kGroups + threadIdx.x) * V;
  Lanes<V> field[kGroups][K];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int w = w0 + g * kThreads * V;
#pragma unroll
    for (int f = 0; f < K; ++f) {
      const bool live = w < n_words && f * n_words + w < n;  // f * n_words + w < k * W
      field[g][f] = live ? *reinterpret_cast<const Lanes<V>*>(z + f * n_words + w)
                         : Lanes<V>{};
    }
  }
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int w = w0 + g * kThreads * V;
    if (w >= n_words) return;
    Lanes<V> out;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      uint32_t word = 0;
#pragma unroll
      for (int f = 0; f < K; ++f) word += static_cast<uint32_t>(field[g][f].v[i]) << (f * bits);
      out.v[i] = static_cast<int>(word);
    }
    *reinterpret_cast<Lanes<V>*>(words + w) = out;
  }
}

template <int K, int V>
__global__ void __launch_bounds__(kThreads)
    unpack_flat_kernel(const int* __restrict__ words, int* __restrict__ z, int n, int n_words,
                       int bits) {
  const int w0 = static_cast<int>(blockIdx.x * kThreads * kGroups + threadIdx.x) * V;
  Lanes<V> in[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int w = w0 + g * kThreads * V;
    if (w < n_words) in[g] = *reinterpret_cast<const Lanes<V>*>(words + w);
  }
  const uint32_t mask = (1u << bits) - 1u;  // bits <= 16
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int w = w0 + g * kThreads * V;
    if (w >= n_words) return;
#pragma unroll
    for (int f = 0; f < K; ++f) {
      const int c = f * n_words + w;
      if (c < n) {
        Lanes<V> out;
#pragma unroll
        for (int i = 0; i < V; ++i)
          out.v[i] = static_cast<int>((static_cast<uint32_t>(in[g].v[i]) >> (f * bits)) & mask);
        *reinterpret_cast<Lanes<V>*>(z + c) = out;
      }
    }
  }
}

}  // namespace

extern "C" {

// The walk of n fields of `bits` in n_words words between the operands at
// a and b: its width *v and its grid *blocks. Returns cudaErrorInvalidValue
// for a width outside 1..16, n < 1, or k * n_words past INT_MAX.
int codec_walk(int n, int n_words, int bits, const void* a, const void* b, int* v,
               int* blocks) {
  return repro::walk(n, n_words, bits, {a, b}, v, blocks);
}

int pack_flat(const int* z, int* words, int n, int n_words, int bits, void* stream) {
  int v, blocks;
  if (const int err = codec_walk(n, n_words, bits, z, words, &v, &blocks)) return err;
  return repro::dispatch(bits, v, [&](auto k, auto width) {
    pack_flat_kernel<decltype(k)::value, decltype(width)::value>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(z, words, n, n_words,
                                                                    bits);
    return static_cast<int>(cudaGetLastError());
  });
}

int unpack_flat(const int* words, int* z, int n, int n_words, int bits, void* stream) {
  int v, blocks;
  if (const int err = codec_walk(n, n_words, bits, words, z, &v, &blocks)) return err;
  return repro::dispatch(bits, v, [&](auto k, auto width) {
    unpack_flat_kernel<decltype(k)::value, decltype(width)::value>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(words, z, n, n_words,
                                                                      bits);
    return static_cast<int>(cudaGetLastError());
  });
}

const char* pack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
