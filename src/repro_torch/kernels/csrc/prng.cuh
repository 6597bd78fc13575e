// Counter-based splitmix32 on uint32_t: the device side of kernels/prng.py
// and the same bits as repro/kernels/prng.py. All arithmetic wraps mod 2^32.
#pragma once
#include <cstdint>

namespace repro {

constexpr uint32_t kGolden = 0x9E3779B9u;      // splitmix increment
constexpr uint32_t kStreamSalt = 0xBF58476Du;

__device__ __forceinline__ uint32_t mix32(uint32_t z) {
  z = (z ^ (z >> 16)) * 0x85EBCA6Bu;
  z = (z ^ (z >> 13)) * 0xC2B2AE35u;
  return z ^ (z >> 16);
}

__device__ __forceinline__ uint32_t random_bits(uint32_t seed, uint32_t counter,
                                                uint32_t stream) {
  return mix32(seed + stream * kStreamSalt + counter * kGolden);
}

// (bits >> 8) * 2^-24: both steps are exact in float32.
__device__ __forceinline__ float uniform01(uint32_t bits) {
  return __fmul_rn(__uint2float_rn(bits >> 8), 5.9604644775390625e-08f);
}

__device__ __forceinline__ float random_uniform(uint32_t seed, uint32_t counter,
                                                uint32_t stream) {
  return uniform01(random_bits(seed, counter, stream));
}

// A kernel's seed: passed by value, or (the _dev entries) read once from
// device memory, so that a captured CUDA graph takes a new seed at each
// replay. The by-value instance is the kernel as it was before.
__device__ __forceinline__ uint32_t load_seed(uint32_t seed) { return seed; }
__device__ __forceinline__ uint32_t load_seed(const uint32_t* seed) { return __ldg(seed); }

}  // namespace repro
