// The dense b-bit wire codec: planar pack and unpack of a flat int32 vector.
//
// Layout (repro_torch/core/wire.py): n coordinates pack into W int32 words,
// k = 32 / bits fields a word; coordinate c lives in field c / W of word
// c % W, at bit offset (c / W) * bits. Fields past n are 0.
//
// Both kernels walk the words in V-groups: group j is the V consecutive
// words [j*V, j*V + V), and field f of it the V levels z[f*W + j*V, + V).
// V is 2 where 2 words divide W, n and both operands' addresses, else 1
// (codec_walk below, mirrored by kernels/pack_kernel.py), so each access is
// one aligned V-wide load or store, neighbouring threads touch neighbouring
// addresses, and a group's field lies wholly below n or wholly at or past
// it. A thread walks kGroups groups, kThreads groups apart: the
// grid is ceil(W / (V * kThreads * kGroups)) blocks. k is a template
// argument, so the field loops unroll and no index needs a division or a
// 64-bit product (the entries check that k * W fits an int).
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
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 2;  // V-groups a thread, kThreads * V words apart

template <int V>
struct __align__(4 * V) Lanes {
  int v[V];
};

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

template <int N>
using Int = std::integral_constant<int, N>;

// Calls launch(Int<k>, Int<V>) for k = 32 / bits.
template <class Launch>
int dispatch(int bits, int v, Launch&& launch) {
  const auto with_v = [&](auto k) {
    return v == 2 ? launch(k, Int<2>{}) : launch(k, Int<1>{});
  };
  switch (32 / bits) {
    case 32: return with_v(Int<32>{});
    case 16: return with_v(Int<16>{});
    case 10: return with_v(Int<10>{});
    case 8: return with_v(Int<8>{});
    case 6: return with_v(Int<6>{});
    case 5: return with_v(Int<5>{});
    case 4: return with_v(Int<4>{});
    case 3: return with_v(Int<3>{});
    default: return with_v(Int<2>{});
  }
}

}  // namespace

extern "C" {

// The walk of n fields of `bits` in n_words words between the operands at
// a and b: its width *v and its grid *blocks. Returns cudaErrorInvalidValue
// for a width outside 1..16, n < 1, or k * n_words past INT_MAX.
int codec_walk(int n, int n_words, int bits, const void* a, const void* b, int* v,
               int* blocks) {
  if (bits < 1 || bits > 16 || n < 1 || n_words < 1 ||
      static_cast<long long>(32 / bits) * n_words > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool pairs = n_words % 2 == 0 && n % 2 == 0 && reinterpret_cast<uintptr_t>(a) % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(b) % 8 == 0;
  *v = pairs ? 2 : 1;
  *blocks = (n_words / *v + kThreads * kGroups - 1) / (kThreads * kGroups);
  return 0;
}

int pack_flat(const int* z, int* words, int n, int n_words, int bits, void* stream) {
  int v, blocks;
  if (const int err = codec_walk(n, n_words, bits, z, words, &v, &blocks)) return err;
  return dispatch(bits, v, [&](auto k, auto width) {
    pack_flat_kernel<decltype(k)::value, decltype(width)::value>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(z, words, n, n_words,
                                                                    bits);
    return static_cast<int>(cudaGetLastError());
  });
}

int unpack_flat(const int* words, int* z, int n, int n_words, int bits, void* stream) {
  int v, blocks;
  if (const int err = codec_walk(n, n_words, bits, words, z, &v, &blocks)) return err;
  return dispatch(bits, v, [&](auto k, auto width) {
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
