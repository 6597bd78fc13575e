// The fused round: clip -> encode -> weighted cohort sum, dense and packed.
//
// Replaces the Pallas kernels repro/kernels/fused_round_kernel.py:
// round_sum_2d (dense, :101) and round_sum_packed_2d (packed, :227), for
// the encoders those take: rqm, pbm and qmgeo dense; rqm and qmgeo packed
// (the PBM mechanism's sum never travels packed: its decode is not the grid
// decode the packed apply performs).
//
// On the TPU the cohort rows are an inner sequential grid axis that revisits
// the output block. Here one thread owns one output column (dense) or one
// output word (packed) and loops over every cohort row in registers: no
// atomics, no cross-block reduction, and an integer sum in a fixed order.
// Consecutive threads read consecutive columns of x, so the loads coalesce.
// The kernels are templates over the encoder, whose per-element body is the
// same device function csrc/quantize.cu inlines (rqm_encode.cuh,
// pbm_encode.cuh, qmgeo_encode.cuh).
//
// The RQM encoder draws all m-2 keep streams and the rounding stream of every
// element (15 splitmix32 draws at m=16). The function needs fewer: only the
// draws out to the nearest kept level on each side of the bin, which is what
// chip_smoke.py counts for the kernel's bound.
//
// RNG counter of element (r, c): (row_offset + r) * dim + c, as in JAX.
#include <cuda_runtime.h>

#include <cstdint>

#include "pbm_encode.cuh"
#include "qmgeo_encode.cuh"
#include "rqm_encode.cuh"

namespace {

template <class Encoder>
__global__ void round_sum_dense_kernel(const float* __restrict__ x,
                                       const int* __restrict__ w,
                                       int* __restrict__ out, int rows, int dim,
                                       uint32_t seed, uint32_t row_offset,
                                       Encoder encode) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= dim) return;
  uint32_t acc = 0;
  for (int r = 0; r < rows; ++r) {
    const uint32_t counter = (row_offset + static_cast<uint32_t>(r)) *
                                 static_cast<uint32_t>(dim) +
                             static_cast<uint32_t>(c);
    const int z = encode(x[static_cast<size_t>(r) * dim + c], seed, counter);
    acc += static_cast<uint32_t>(z) * static_cast<uint32_t>(w[r]);
  }
  out[c] = static_cast<int>(acc);
}

// Word wi carries coordinate c = f * words + wi in field f. Coordinates past
// dim are padding and stay 0, so the words are canonical (wire.pack_bits of
// the dense sum). Shifts and sums are uint32_t: shifting into the sign bit
// of an int is undefined in C++17.
template <class Encoder>
__global__ void round_sum_packed_kernel(const float* __restrict__ x,
                                        const int* __restrict__ w,
                                        int* __restrict__ out, int rows, int dim,
                                        int words, int bits, int fields,
                                        uint32_t seed, uint32_t row_offset,
                                        Encoder encode) {
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
      const int z = encode(x[static_cast<size_t>(r) * dim + c], seed, counter);
      partial += static_cast<uint32_t>(z) * static_cast<uint32_t>(w[r]);
    }
    acc += partial << (f * bits);
  }
  out[wi] = static_cast<int>(acc);
}

constexpr int kThreads = 256;

template <class Encoder>
int launch_dense(const float* x, const int* w, int* out, int rows, int dim,
                 uint32_t seed, uint32_t row_offset, Encoder encode, void* stream) {
  const int blocks = (dim + kThreads - 1) / kThreads;
  round_sum_dense_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, out, rows, dim, seed, row_offset, encode);
  return static_cast<int>(cudaGetLastError());
}

template <class Encoder>
int launch_packed(const float* x, const int* w, int* out, int rows, int dim,
                  int words, int bits, uint32_t seed, uint32_t row_offset,
                  Encoder encode, void* stream) {
  const int fields = 32 / bits;
  const int blocks = (words + kThreads - 1) / kThreads;
  round_sum_packed_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, out, rows, dim, words, bits, fields, seed, row_offset, encode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rqm_round_sum_dense(const float* x, const int* w, int* out, int rows, int dim,
                        uint32_t seed, uint32_t row_offset, float c, float x_max,
                        float step, float q, int m, void* stream) {
  return launch_dense(x, w, out, rows, dim, seed, row_offset,
                      repro::RQMEncoder{{c, x_max, step, q, m}}, stream);
}

int pbm_round_sum_dense(const float* x, const int* w, int* out, int rows, int dim,
                        uint32_t seed, uint32_t row_offset, float c, float theta,
                        int m, void* stream) {
  return launch_dense(x, w, out, rows, dim, seed, row_offset,
                      repro::PBMEncoder{{c, theta, m}}, stream);
}

int qmgeo_round_sum_dense(const float* x, const int* w, int* out, int rows, int dim,
                          uint32_t seed, uint32_t row_offset, float c, float x_max,
                          float step, float log_r, float inv_1mr, float r_over_1mr,
                          int m, void* stream) {
  return launch_dense(
      x, w, out, rows, dim, seed, row_offset,
      repro::QMGeoEncoder{{c, x_max, step, log_r, inv_1mr, r_over_1mr, m}}, stream);
}

int rqm_round_sum_packed(const float* x, const int* w, int* out, int rows, int dim,
                         int words, int bits, uint32_t seed, uint32_t row_offset,
                         float c, float x_max, float step, float q, int m,
                         void* stream) {
  return launch_packed(x, w, out, rows, dim, words, bits, seed, row_offset,
                       repro::RQMEncoder{{c, x_max, step, q, m}}, stream);
}

int qmgeo_round_sum_packed(const float* x, const int* w, int* out, int rows, int dim,
                           int words, int bits, uint32_t seed, uint32_t row_offset,
                           float c, float x_max, float step, float log_r,
                           float inv_1mr, float r_over_1mr, int m, void* stream) {
  return launch_packed(
      x, w, out, rows, dim, words, bits, seed, row_offset,
      repro::QMGeoEncoder{{c, x_max, step, log_r, inv_1mr, r_over_1mr, m}}, stream);
}

const char* round_sum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
