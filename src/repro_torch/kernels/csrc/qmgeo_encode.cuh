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
#pragma once
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

__device__ __forceinline__ int qmgeo_encode(float x, uint32_t seed, uint32_t counter,
                                            const QMGeoConsts& p) {
  const float u_round = random_uniform(seed, counter, 0);
  const float u_noise = random_uniform(seed, counter, 1);
  // jnp.clip: NaN passes through
  x = x < -p.c ? -p.c : (x > p.c ? p.c : x);

  // 1. stochastic rounding to a neighbouring level
  float t = floorf(__fdiv_rn(__fadd_rn(x, p.x_max), p.step));
  t = fminf(fmaxf(t, 0.0f), static_cast<float>(p.m - 2));
  const int lo = static_cast<int>(t);
  const float b_lo = __fadd_rn(-p.x_max, __fmul_rn(__int2float_rn(lo), p.step));
  const float p_up = __fdiv_rn(__fsub_rn(x, b_lo), p.step);
  const int j = lo + (u_round < p_up ? 1 : 0);
  const float jf = __int2float_rn(j);

  // 2. Z_j = (1 - r^{j+1}) / (1-r) + r (1 - r^{m-1-j}) / (1-r)
  const float z_lo = __fmul_rn(
      __fsub_rn(1.0f, expf(__fmul_rn(__fadd_rn(jf, 1.0f), p.log_r))), p.inv_1mr);
  const float z_hi = __fmul_rn(
      p.r_over_1mr,
      __fsub_rn(1.0f, expf(__fmul_rn(__fsub_rn(static_cast<float>(p.m - 1), jf),
                                     p.log_r))));
  const float target = __fmul_rn(u_noise, __fadd_rn(z_lo, z_hi));
  float cum = 0.0f;
  int z = 0;
  for (int k = 0; k < p.m; ++k) {
    const float w = expf(__fmul_rn(fabsf(__fsub_rn(static_cast<float>(k), jf)), p.log_r));
    cum = __fadd_rn(cum, w);
    z += cum <= target ? 1 : 0;
  }
  // round-off in Z against the accumulated cum can push the target past it
  return z < p.m - 1 ? z : p.m - 1;
}

struct QMGeoEncoder {
  QMGeoConsts p;
  __device__ __forceinline__ int operator()(float x, uint32_t seed,
                                            uint32_t counter) const {
    return qmgeo_encode(x, seed, counter, p);
  }
};

}  // namespace repro
