// The element-wise PBM encode on an explicit RNG counter: the device side of
// kernels/pbm_kernel.py:pbm_encode_counters, inlined by csrc/quantize.cu and
// the round sums of csrc/round_sum.cu.
//
//   z = sum_{t < m} [u_t < 1/2 + (theta * x) / c],   u_t on stream t
//
// with the reference's association; the _rn intrinsics (and -fmad=false) keep
// every step separately rounded and the division IEEE.
#pragma once
#include <cstdint>

#include "prng.cuh"

namespace repro {

// Each float is the reference's Python double rounded once to float32.
struct PBMConsts {
  float c;
  float theta;
  int m;
};

__device__ __forceinline__ int pbm_encode(float x, uint32_t seed, uint32_t counter,
                                          const PBMConsts& p) {
  // jnp.clip: NaN passes through
  x = x < -p.c ? -p.c : (x > p.c ? p.c : x);
  const float prob = __fadd_rn(0.5f, __fdiv_rn(__fmul_rn(p.theta, x), p.c));
  int z = 0;
  for (int t = 0; t < p.m; ++t) {
    z += random_uniform(seed, counter, t) < prob ? 1 : 0;
  }
  return z;
}

struct PBMEncoder {
  PBMConsts p;
  __device__ __forceinline__ int operator()(float x, uint32_t seed,
                                            uint32_t counter) const {
    return pbm_encode(x, seed, counter, p);
  }
};

}  // namespace repro
