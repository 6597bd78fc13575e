// The element-wise PBM encode on an explicit RNG counter: the device side of
// kernels/pbm_kernel.py:pbm_encode_counters, inlined by csrc/quantize.cu and
// the round sums of csrc/round_sum.cu.
//
//   z = sum_{t < m} [u_t < 1/2 + (theta * x) / c],   u_t on stream t
//
// with the reference's association; the _rn intrinsics (and -fmad=false) keep
// every step separately rounded and the division IEEE.
//
// What bounds it on an H100: the integer pipes. The function needs every one
// of the m draws of an element whose p is inside (0, 1) (16 at the paper's
// m); each is a splitmix32 hash, three shift-xor pairs on the 16-lane ALU
// pipe and two multiplies on the FMA pipe. The design takes out the work
// around each draw that is not the hash, as rqm_encode.cuh does for RQM's
// keep draws:
//
//  * The test is an integer compare. u_t < p holds for the uniform
//    k * 2^-24 (k = bits >> 8) iff k < K with K = ceil(p * 2^24), exact in
//    float32, i.e. iff bits <= (K << 8) - 1 (mod 2^32). K is saturated to
//    [0, 2^24] and NaN gives 0 (no draw is below a NaN p). K = 2^24 (p >= 1)
//    wraps the threshold to 2^32 - 1, which takes every draw, as it should;
//    K = 0 (p <= 0 or NaN) would too, so the count is then 0. Both edges are
//    reached: theta = 1/2 is allowed, and x = -c, +c give p = 0, 1. No
//    >> 8, int->float conversion, multiply or float compare is left in the
//    draw loop (kernels/pbm_kernel.py:prob_threshold transcribes it).
//  * The paper's m = 16 is a template constant (PBMEncoder<16>,
//    pbm_dispatch): its draws unroll with their stream salts as immediates.
//    Any other m runs the same body as a loop.
#pragma once
#include <cstddef>
#include <cstdint>

#include "prng.cuh"

namespace repro {

// Each float is the reference's Python double rounded once to float32.
struct PBMConsts {
  float c;
  float theta;
  int m;
};

// kM > 0: m is the compile-time constant kM (== p.m); kM == 0: m = p.m.
template <int kM>
__device__ __forceinline__ int pbm_encode(float x, uint32_t seed, uint32_t counter,
                                          const PBMConsts& p) {
  const int m = kM > 0 ? kM : p.m;
  // jnp.clip: NaN passes through (two selects, not a branch)
  x = x < -p.c ? -p.c : x;
  x = x > p.c ? p.c : x;
  const float prob = __fadd_rn(0.5f, __fdiv_rn(__fmul_rn(p.theta, x), p.c));
  // K = ceil(prob * 2^24) in [0, 2^24]; fmaxf takes a NaN to 0
  const float k = fminf(fmaxf(ceilf(__fmul_rn(prob, 16777216.0f)), 0.0f), 16777216.0f);
  const uint32_t threshold = (static_cast<uint32_t>(k) << 8) - 1u;
  const uint32_t s = seed + counter * kGolden;  // random_bits(seed, counter, 0)'s input
  int z = 0;
#pragma unroll
  for (int t = 0; t < m; ++t) {
    z += mix32(s + static_cast<uint32_t>(t) * kStreamSalt) <= threshold ? 1 : 0;
  }
  return k != 0.0f ? z : 0;
}

template <int kM>
struct PBMEncoder {
  // elements a thread loads at once: 4 made the dense round sum 12% slower
  // on an H100 (the quantize 3% faster; PERF.md)
  static constexpr int kBatch = 1;
  PBMConsts p;
  size_t shared_bytes() const { return 0; }
  __device__ __forceinline__ PBMEncoder setup(unsigned char*) const { return *this; }
  __device__ __forceinline__ int operator()(float x, uint32_t seed,
                                            uint32_t counter) const {
    return pbm_encode<kM>(x, seed, counter, p);
  }
};

// Calls launch(encoder) with the encoder for p.m: unrolled for the paper's
// m = 16, the loop for any other m.
template <class Launch>
int pbm_dispatch(const PBMConsts& p, Launch launch) {
  if (p.m == 16) return launch(PBMEncoder<16>{p});
  return launch(PBMEncoder<0>{p});
}

}  // namespace repro
