// The element-wise RQM encode on an explicit RNG counter: the device side of
// kernels/rqm_kernel.py:rqm_encode_counters, inlined by csrc/quantize.cu and
// the round sums of csrc/round_sum.cu. Float steps use the _rn intrinsics (and the library is built with
// -fmad=false), so nothing is contracted into an FMA and division is IEEE:
// the levels match the plain version and the JAX reference bit for bit.
#pragma once
#include <cstdint>

#include "prng.cuh"

namespace repro {

// Each float is the reference's Python double rounded once to float32.
struct RQMConsts {
  float c;
  float x_max;
  float step;
  float q;
  int m;
};

__device__ __forceinline__ int rqm_encode(float x, uint32_t seed, uint32_t counter,
                                          const RQMConsts& p) {
  // jnp.clip: NaN passes through
  x = x < -p.c ? -p.c : (x > p.c ? p.c : x);
  float t = floorf(__fdiv_rn(__fadd_rn(x, p.x_max), p.step));
  t = fminf(fmaxf(t, 0.0f), static_cast<float>(p.m - 2));
  const int j = static_cast<int>(t);

  // nearest kept level below (i_lo) and above (i_hi) the bin; the
  // endpoints are always kept, interior level l on stream l
  int i_lo = 0;
  int i_hi = p.m - 1;
  for (int lvl = 1; lvl < p.m - 1; ++lvl) {
    const bool keep = random_uniform(seed, counter, lvl) < p.q;
    if (keep && lvl <= j) i_lo = lvl;
    if (keep && lvl > j && lvl < i_hi) i_hi = lvl;
  }
  const float b_lo = __fadd_rn(-p.x_max, __fmul_rn(__int2float_rn(i_lo), p.step));
  const float b_hi = __fadd_rn(-p.x_max, __fmul_rn(__int2float_rn(i_hi), p.step));
  const float p_up = __fdiv_rn(__fsub_rn(x, b_lo), __fsub_rn(b_hi, b_lo));
  return random_uniform(seed, counter, p.m) < p_up ? i_hi : i_lo;
}

struct RQMEncoder {
  RQMConsts p;
  __device__ __forceinline__ int operator()(float x, uint32_t seed,
                                            uint32_t counter) const {
    return rqm_encode(x, seed, counter, p);
  }
};

}  // namespace repro
