// The element-wise QMGeo encode on an explicit RNG counter: the device side of
// kernels/qmgeo_kernel.py:qmgeo_encode_counters (core/qmgeo.py:
// quantize_with_uniforms), inlined by csrc/quantize.cu and the round sums of
// csrc/round_sum.cu.
//
//   1. stochastic rounding: lo = floor((x + x_max) / step) clamped to
//      [0, m-2]; j = lo + [u_0 < (x - B(lo)) / step]        (stream 0)
//   2. truncated two-sided geometric noise by inverse CDF over the m levels:
//      weights r^|k-j| = exp(|k-j| log r), normaliser in closed form,
//      z = #{k : cum_k <= u_1 * Z_j}, clamped to m-1        (stream 1)
//
// Float steps follow the reference's grouping with the _rn intrinsics (the
// library is built with -fmad=false) and expf, the accurate exponential, so
// the levels equal the plain version's on the card.
//
// What bounds it on an H100: bytes. An element reads 4 bytes and writes 4 (or
// none, in a round sum) and makes 2 splitmix32 draws. Step 2 computed as
// written costs 18 expf an element (the normaliser's two and one a level) and
// a chain of m dependent adds; yet every operand of that work depends on the
// bin j alone, and j takes only m values: |k - j|, j + 1 and m - 1 - j are
// exact small integers d in [0, m], so each expf is W[d] = expf(d * log r),
// the normaliser is Z[j], and the running sum after level k is C[j][k]. So a
// block builds, once, in shared memory and with the very expressions the
// element body would run (so no bit can change):
//
//   W[d]  for d in [0, m], one expf each;
//   Z[j]  for j in [0, m);
//   C[j]  (m <= 64) the running sums of row j, W[|i - j|] added for
//         i = 0..k in order, stored as a search tree (below).
//
// An element then takes its two draws, the rounding, target = u_1 * Z[j] and
// the count of C[j][k] <= target: no expf at all. Adding a weight >= 0
// rounds monotonically, so C[j][.] is nondecreasing and the count is a
// search. It is a branch-free binary search with a fixed trip count, so a
// warp's lanes stay in lockstep: with P the least power of two >= m, node n
// (1 <= n < P, the children of n are 2n and 2n + 1) holds C[j][k] for the k
// the search reads there, entries k >= m hold +inf, and
//
//   n = 1; log2(P) times: n = 2n + [tree[n][j] <= target];  z = n - P
//
// gives min(count, P - 1), then clamped to m - 1 as the walk's count is.
// Node-major (tree[n][j] at n * m + j) keeps the first two steps free of
// shared-memory bank conflicts at m = 16 and the last two at most 2- and
// 4-way, where a row-major C[j][k] puts up to 8 rows' lanes on one bank at
// every step. The paper's m = 16 is a template constant (QMGeoEncoder<16>,
// qmgeo_dispatch): 4 unrolled steps, 1.1 KB of tables a block. Other m up
// to 64 search a runtime tree (17 KB of tables at m = 64). Beyond 64 the
// tree outgrows its use: W alone stays in shared memory, and the element
// forms Z_j from it and walks cum = C[j][k] from it in registers, still
// without an expf. The table holds at most 4096 weights (16 KB); past it (m >
// 4095) the element makes W[d] itself by the same expression, so any m runs
// and every launch fits the 48 KB a block has without an opt-in.
// kernels/qmgeo_kernel.py transcribes the tables and both searches
// (level_tables, level_search).
//
// What is left holds the kernel at about twice its byte bound: each element
// is a serial chain (two IEEE divisions, whose slow-path checks are branches,
// then five dependent shared-memory reads) some 400 clocks long for about 106
// instructions, and a quarter-SM's 14 to 16 warps do not hide all of it. So
// the encoder asks its kernels (kBatch) to load 4 elements before encoding
// them, 4 loads in flight a thread: 6% to 13% faster on an H100. Interleaving
// the 4 searches step by step was slower (8 more registers, 48 warps an SM,
// spills in the packed round sum; PERF.md).
#pragma once
#include <cstddef>
#include <cstdint>

#include "prng.cuh"

namespace repro {

// Each float is the reference's Python double rounded once to float32.
struct QMGeoConsts {
  float c;
  float x_max;
  float step;
  float log_r;       // log(r)
  float inv_1mr;     // 1 / (1 - r)
  float r_over_1mr;  // r / (1 - r)
  int m;
};

constexpr int kQMGeoTreeMaxM = 64;        // larger m walk over W
constexpr int kQMGeoWalkWeights = 4096;   // W[d] the walk keeps, d < 4096

// The least power of two >= m.
__host__ __device__ constexpr int qmgeo_span(int m) {
  return m <= 1 ? 1 : 2 * qmgeo_span((m + 1) / 2);
}

// The most shared memory an encoder's tables take: the tree's at m = 64.
constexpr size_t kQMGeoMaxTableBytes =
    sizeof(float) * (2 * kQMGeoTreeMaxM + 1 + qmgeo_span(kQMGeoTreeMaxM) * kQMGeoTreeMaxM);
static_assert(sizeof(float) * kQMGeoWalkWeights <= kQMGeoMaxTableBytes, "walk table");

// kM > 0: m is the constant kM (<= 64), tree search unrolled; kM == 0: any
// m <= 64, tree search; kM < 0: any m, the walk over W.
template <int kM>
struct QMGeoEncoder {
  static constexpr bool kTree = kM >= 0;
  static constexpr int kBatch = 4;  // elements a thread loads at once
  QMGeoConsts p;
  int span;                 // P = qmgeo_span(m) (tree instances)
  const float* w = nullptr; // the block's tables, from setup: W, then Z and tree

  // how many weights the block keeps: W[0..m], or the walk's first 4096
  __host__ __device__ int weights() const {
    return kTree || p.m < kQMGeoWalkWeights ? p.m + 1 : kQMGeoWalkWeights;
  }

  // W, and for the tree Z[m] and P rows of m (row 0 unused)
  size_t shared_bytes() const {
    const size_t m = static_cast<size_t>(p.m);
    return sizeof(float) * (kTree ? 2 * m + 1 + static_cast<size_t>(span) * m
                                  : static_cast<size_t>(weights()));
  }

  // r^d
  __device__ __forceinline__ float weight(int d) const {
    return expf(__fmul_rn(static_cast<float>(d), p.log_r));
  }

  // Z_j = (1 - r^{j+1}) / (1-r) + r (1 - r^{m-1-j}) / (1-r)
  __device__ __forceinline__ float normaliser(float r_j1, float r_m1j) const {
    return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, r_j1), p.inv_1mr),
                     __fmul_rn(p.r_over_1mr, __fsub_rn(1.0f, r_m1j)));
  }

  // The walk's W[d]: from the table, or made here past it.
  __device__ __forceinline__ float walk_weight(int d) const {
    return d < kQMGeoWalkWeights ? w[d] : weight(d);
  }

  // Every thread of the block calls it, before its first element.
  __device__ __forceinline__ QMGeoEncoder setup(unsigned char* shared) const {
    const int m = kM > 0 ? kM : p.m;
    float* table = reinterpret_cast<float*>(shared);
    const int tid = threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
    const int threads = blockDim.x * blockDim.y * blockDim.z;
    const int count = kM > 0 ? kM + 1 : weights();
    for (int d = tid; d < count; d += threads) table[d] = weight(d);
    __syncthreads();
    if constexpr (kTree) {
      float* norm = table + m + 1;
      float* tree = norm + m;
      const int span_ = kM > 0 ? qmgeo_span(kM) : span;
      for (int j = tid; j < m; j += threads) {
        norm[j] = normaliser(table[j + 1], table[m - 1 - j]);
        float cum = 0.0f;
        for (int k = 0; k < span_ - 1; ++k) {
          if (k < m) cum = __fadd_rn(cum, table[k < j ? j - k : k - j]);
          // the node that reads index k: (k + 1 + P) >> (trailing zeros of k + 1, plus 1)
          const int node = (k + 1 + span_) >> __ffs(k + 1);
          tree[node * m + j] = k < m ? cum : __int_as_float(0x7f800000);  // +inf
        }
      }
      __syncthreads();
    }
    QMGeoEncoder bound = *this;
    bound.w = table;
    return bound;
  }

  __device__ __forceinline__ int operator()(float x, uint32_t seed,
                                            uint32_t counter) const {
    const int m = kM > 0 ? kM : p.m;
    const float u_round = random_uniform(seed, counter, 0);
    const float u_noise = random_uniform(seed, counter, 1);
    // jnp.clip: NaN passes through
    x = x < -p.c ? -p.c : (x > p.c ? p.c : x);

    // 1. stochastic rounding to a neighbouring level
    float t = floorf(__fdiv_rn(__fadd_rn(x, p.x_max), p.step));
    t = fminf(fmaxf(t, 0.0f), static_cast<float>(m - 2));
    const int lo = static_cast<int>(t);
    const float b_lo = __fadd_rn(-p.x_max, __fmul_rn(__int2float_rn(lo), p.step));
    const float p_up = __fdiv_rn(__fsub_rn(x, b_lo), p.step);
    const int j = lo + (u_round < p_up ? 1 : 0);

    // 2. the inverse CDF against the block's tables
    int z;
    if constexpr (kTree) {
      const float* norm = w + m + 1;
      const float* tree = norm + m;
      const float target = __fmul_rn(u_noise, norm[j]);
      const int span_ = kM > 0 ? qmgeo_span(kM) : span;
      int n = 1;
#pragma unroll
      for (int half = span_ >> 1; half > 0; half >>= 1) {
        n = 2 * n + (tree[n * m + j] <= target ? 1 : 0);
      }
      z = n - span_;
    } else {
      const float target =
          __fmul_rn(u_noise, normaliser(walk_weight(j + 1), walk_weight(m - 1 - j)));
      float cum = 0.0f;
      z = 0;
      for (int k = 0; k < m; ++k) {
        cum = __fadd_rn(cum, walk_weight(k < j ? j - k : k - j));
        z += cum <= target ? 1 : 0;
      }
    }
    // round-off in Z against the accumulated cum can push the target past it
    return z < m - 1 ? z : m - 1;
  }
};

// Calls launch(encoder) with the encoder for p.m: the unrolled tree search
// for the paper's m = 16, the runtime tree up to m = 64, the walk beyond.
template <class Launch>
int qmgeo_dispatch(const QMGeoConsts& p, Launch launch) {
  if (p.m == 16) return launch(QMGeoEncoder<16>{p, qmgeo_span(16)});
  if (p.m <= kQMGeoTreeMaxM) return launch(QMGeoEncoder<0>{p, qmgeo_span(p.m)});
  return launch(QMGeoEncoder<-1>{p, 0});
}

}  // namespace repro
