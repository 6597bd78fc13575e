// The element-wise RQM encode on an explicit RNG counter: the device side of
// kernels/rqm_kernel.py:rqm_encode_counters, inlined by csrc/quantize.cu and
// the round sums of csrc/round_sum.cu. Float steps use the _rn intrinsics (and
// the library is built with -fmad=false), so nothing is contracted into an FMA
// and division is IEEE: the levels match the plain version and the JAX
// reference bit for bit.
//
// What bounds it on an H100: the integer ALU pipe (16 lanes a quarter-SM, half
// the issue rate), not bytes. An element reads 4 bytes and writes 4 (or none,
// in a round sum), and makes m-1 splitmix32 draws (15 at m=16); each is three
// shift-xor pairs on that pipe and two multiplies on the FMA pipe. The design
// takes out the work around each keep draw that is not the hash itself, which
// was as much again on the ALU pipe (I2FP, FSETP and two compare-and-selects):
//
//  * The keep test is an integer compare. The reference keeps level l iff
//    (bits >> 8) * 2^-24 < q in float32; for the integer k = bits >> 8 that
//    holds iff k < K with K = ceil(float32(q) * 2^24), i.e. iff
//    bits <= (K << 8) - 1 (mod 2^32), computed once on the host
//    (rqm_kernel.keep_constants). K = 2^24 (float32(q) == 1) wraps that to
//    2^32 - 1, which keeps everything, as it should; K = 0 (float32(q) == 0)
//    would too, so keep_any clears the mask then. No int->float conversion,
//    multiply or float compare is left in the keep loop.
//  * The kept levels go into a bit mask (bit b for level base + b, 32 levels a
//    word); the bracket is then two bit scans, the highest kept level at or
//    below the bin j (31 - clz) and the lowest above it (ffs - 1), in place of
//    two compare-and-selects per level. Words are walked in order, so any
//    m >= 2 is taken (m = 2 has no interior level).
//  * The paper's m = 16, which every RQM configuration of the port uses, is
//    a template constant (RQMEncoder<16>, rqm_dispatch): its 14 keep draws
//    unroll with their stream salt and bit position as immediates and no
//    branch on m. Any other m runs the same body as a loop. One instance for
//    every m loses at m = 16 on an H100 (rqm_quantize at 40 x 222,030,
//    scripts/torch_kernel_ab.py, PERF.md): this loop takes 1.28x the
//    constant instance, a mask word unrolled to 32 draws with a branch on m
//    before each 1.21x, and a jump into that word at its top level (a
//    switch falling through) 1.21x as well.
//
// Every keep draw is made, unconditionally. Walking out from j only as far as
// the nearest kept level on each side needs 4.5 to 4.7 keep draws per element
// at m=16, q=0.42, but a warp runs in lockstep until its slowest lane is done:
// simulated over 32-lane warps, an outward walk executes 15.1 draws per element
// on uniform inputs and 14.0 on gradient-like N(0, c/10) ones, against the 14
// of the unconditional loop, and 75% to 89% of warps run to full depth anyway.
// What shrinks is the cost of each draw, not their number.
#pragma once
#include <cstddef>
#include <cstdint>

#include "prng.cuh"

namespace repro {

// c, x_max and step are the reference's Python doubles rounded once to
// float32; keep_le and keep_any are rqm_kernel.keep_constants(q).
struct RQMConsts {
  float c;
  float x_max;
  float step;
  uint32_t keep_le;   // interior level l is kept iff its bits <= keep_le ...
  uint32_t keep_any;  // ... and keep_any (0 when float32(q) == 0, else ~0)
  int m;
};

// kM > 0: m is the compile-time constant kM (== p.m); kM == 0: m = p.m.
template <int kM>
__device__ __forceinline__ int rqm_encode(float x, uint32_t seed, uint32_t counter,
                                          const RQMConsts& p) {
  const int m = kM > 0 ? kM : p.m;
  // jnp.clip: NaN passes through
  x = x < -p.c ? -p.c : (x > p.c ? p.c : x);
  float t = floorf(__fdiv_rn(__fadd_rn(x, p.x_max), p.step));
  t = fminf(fmaxf(t, 0.0f), static_cast<float>(m - 2));
  const int j = static_cast<int>(t);

  // nearest kept level below (i_lo) and above (i_hi) the bin; the endpoints
  // are always kept, interior level l (1..m-2) draws on stream l
  const uint32_t s = seed + counter * kGolden;  // random_bits(seed, counter, 0)'s input
  int i_lo = 0;
  int i_hi = m - 1;
  for (int base = 0; base < m - 1; base += 32) {
    const int first = base < 1 ? 1 : base;
    const int last = base + 31 < m - 2 ? base + 31 : m - 2;
    uint32_t mask = 0;
#pragma unroll
    for (int lvl = first; lvl <= last; ++lvl) {
      const uint32_t bits = mix32(s + static_cast<uint32_t>(lvl) * kStreamSalt);
      mask |= static_cast<uint32_t>(bits <= p.keep_le) << (lvl - base);
    }
    mask &= p.keep_any;
    const int rel = j - base;  // bin's bit in this word
    const uint32_t at_or_below =
        rel < 0 ? 0u : (rel >= 31 ? ~0u : (2u << rel) - 1u);
    const uint32_t lo = mask & at_or_below;
    const uint32_t hi = mask & ~at_or_below;
    if (lo) i_lo = base + 31 - __clz(lo);
    if (hi && i_hi == m - 1) i_hi = base + __ffs(hi) - 1;
  }
  const float b_lo = __fadd_rn(-p.x_max, __fmul_rn(__int2float_rn(i_lo), p.step));
  const float b_hi = __fadd_rn(-p.x_max, __fmul_rn(__int2float_rn(i_hi), p.step));
  const float p_up = __fdiv_rn(__fsub_rn(x, b_lo), __fsub_rn(b_hi, b_lo));
  return random_uniform(seed, counter, m) < p_up ? i_hi : i_lo;
}

template <int kM>
struct RQMEncoder {
  // elements a thread loads at once: 4 took 2% to 6% off the m=16 entries
  // on an H100 and added 4% at m=64, but only with the registers to hold
  // four encodes in flight (80 a thread in the dense sum); within the 32
  // registers that keep the dense grid in one wave, 4 made the dense sum 4%
  // slower (PERF.md). 1 keeps the measured SASS.
  static constexpr int kBatch = 1;
  RQMConsts p;
  size_t shared_bytes() const { return 0; }
  __device__ __forceinline__ RQMEncoder setup(unsigned char*) const { return *this; }
  __device__ __forceinline__ int operator()(float x, uint32_t seed,
                                            uint32_t counter) const {
    return rqm_encode<kM>(x, seed, counter, p);
  }
};

// Calls launch(encoder) with the encoder for p.m: unrolled for the paper's
// m = 16, the loop for any other m.
template <class Launch>
int rqm_dispatch(const RQMConsts& p, Launch launch) {
  if (p.m == 16) return launch(RQMEncoder<16>{p});
  return launch(RQMEncoder<0>{p});
}

}  // namespace repro
