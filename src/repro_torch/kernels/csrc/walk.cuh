// The walk over b-bit wire words that the codec kernels (pack.cu) and the
// packed server decode (decode_apply.cu) share.
//
// Layout (repro_torch/core/wire.py): n coordinates pack into W int32 words,
// k = 32 / bits fields a word; coordinate c lives in field c / W of word
// c % W, at bit offset (c / W) * bits.
//
// Group j is the V consecutive words [j*V, j*V + V) and, for field f, the V
// coordinates [f*W + j*V, + V). A thread walks kWalkGroups groups,
// kWalkThreads groups apart, so that neighbouring threads touch neighbouring
// addresses: the grid is ceil(W / (V * kWalkThreads * kWalkGroups)) blocks.
// V is 2 where 2 divides W, n and every operand's address, else 1, so each
// access is one aligned V-wide load or store and a group of a field lies
// wholly below n or wholly at or past it. k is a template argument of the
// kernels (dispatch), so their field loops unroll and no index needs a
// division; walk refuses k * W past INT_MAX, so every index of a live group
// fits an int (and, as k >= 2, so does the last thread's group).
#pragma once
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace repro {

constexpr int kWalkThreads = 256;
constexpr int kWalkGroups = 2;

template <int V, typename T = int>
struct __align__(sizeof(T) * V) Lanes {
  T v[V];
};

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

// The walk of n fields of `bits` in n_words words between the operands at
// addrs: its width *v and its grid *blocks. Returns cudaErrorInvalidValue for
// a width outside 1..16, n < 1, or k * n_words past INT_MAX.
inline int walk(int n, int n_words, int bits, std::initializer_list<const void*> addrs,
                int* v, int* blocks) {
  if (bits < 1 || bits > 16 || n < 1 || n_words < 1 ||
      static_cast<long long>(32 / bits) * n_words > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  bool pairs = n_words % 2 == 0 && n % 2 == 0;
  for (const void* a : addrs) pairs = pairs && reinterpret_cast<uintptr_t>(a) % 8 == 0;
  *v = pairs ? 2 : 1;
  *blocks = (n_words / *v + kWalkThreads * kWalkGroups - 1) / (kWalkThreads * kWalkGroups);
  return 0;
}

}  // namespace repro
