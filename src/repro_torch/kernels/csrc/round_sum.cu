// The fused RQM round: clip -> encode -> weighted cohort sum, dense and packed.
//
// Replaces the Pallas kernels repro/kernels/fused_round_kernel.py:
// round_sum_2d (dense, :101) and round_sum_packed_2d (packed, :227).
//
// On the TPU the cohort rows are an inner sequential grid axis that revisits
// the output block. Here one thread owns one output column (dense) or one
// output word (packed) and loops over every cohort row in registers: no
// atomics, no cross-block reduction, and an integer sum in a fixed order.
// Consecutive threads read consecutive columns of x, so the loads coalesce.
//
// Each thread draws all m-2 keep streams and the rounding stream of every
// element (15 splitmix32 draws at m=16). The function needs fewer: only the
// draws out to the nearest kept level on each side of the bin, which is what
// chip_smoke.py counts for the kernel's bound.
//
// RNG counter of element (r, c): (row_offset + r) * dim + c, as in JAX.
#include <cuda_runtime.h>

#include <cstdint>

#include "rqm_encode.cuh"

namespace {

__global__ void round_sum_dense_kernel(const float* __restrict__ x,
                                       const int* __restrict__ w,
                                       int* __restrict__ out, int rows, int dim,
                                       uint32_t seed, uint32_t row_offset,
                                       repro::RQMConsts p) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= dim) return;
  uint32_t acc = 0;
  for (int r = 0; r < rows; ++r) {
    const uint32_t counter = (row_offset + static_cast<uint32_t>(r)) *
                                 static_cast<uint32_t>(dim) +
                             static_cast<uint32_t>(c);
    const int z = repro::rqm_encode(x[static_cast<size_t>(r) * dim + c], seed,
                                    counter, p);
    acc += static_cast<uint32_t>(z) * static_cast<uint32_t>(w[r]);
  }
  out[c] = static_cast<int>(acc);
}

// Word wi carries coordinate c = f * words + wi in field f. Coordinates past
// dim are padding and stay 0, so the words are canonical (wire.pack_bits of
// the dense sum). Shifts and sums are uint32_t: shifting into the sign bit
// of an int is undefined in C++17.
__global__ void round_sum_packed_kernel(const float* __restrict__ x,
                                        const int* __restrict__ w,
                                        int* __restrict__ out, int rows, int dim,
                                        int words, int bits, int fields,
                                        uint32_t seed, uint32_t row_offset,
                                        repro::RQMConsts p) {
  const int wi = blockIdx.x * blockDim.x + threadIdx.x;
  if (wi >= words) return;
  uint32_t acc = 0;
  for (int f = 0; f < fields; ++f) {
    const int c = f * words + wi;
    if (c >= dim) break;  // c grows with f: every later field is padding
    uint32_t partial = 0;
    for (int r = 0; r < rows; ++r) {
      const uint32_t counter = (row_offset + static_cast<uint32_t>(r)) *
                                   static_cast<uint32_t>(dim) +
                               static_cast<uint32_t>(c);
      const int z = repro::rqm_encode(x[static_cast<size_t>(r) * dim + c], seed,
                                      counter, p);
      partial += static_cast<uint32_t>(z) * static_cast<uint32_t>(w[r]);
    }
    acc += partial << (f * bits);
  }
  out[wi] = static_cast<int>(acc);
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

int rqm_round_sum_dense(const float* x, const int* w, int* out, int rows, int dim,
                        uint32_t seed, uint32_t row_offset, float c, float x_max,
                        float step, float q, int m, void* stream) {
  const repro::RQMConsts p{c, x_max, step, q, m};
  const int blocks = (dim + kThreads - 1) / kThreads;
  round_sum_dense_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, out, rows, dim, seed, row_offset, p);
  return static_cast<int>(cudaGetLastError());
}

int rqm_round_sum_packed(const float* x, const int* w, int* out, int rows, int dim,
                         int words, int bits, uint32_t seed, uint32_t row_offset,
                         float c, float x_max, float step, float q, int m,
                         void* stream) {
  const repro::RQMConsts p{c, x_max, step, q, m};
  const int fields = 32 / bits;
  const int blocks = (words + kThreads - 1) / kThreads;
  round_sum_packed_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, out, rows, dim, words, bits, fields, seed, row_offset, p);
  return static_cast<int>(cudaGetLastError());
}

const char* round_sum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
