// The per-element quantize of a (rows, dim) batch: one mechanism level per
// element, f32 in, i32 out. Three entries, one per mechanism:
//
//  * rqm_quantize replaces repro/kernels/rqm_kernel.py:rqm_quantize_2d (:120);
//  * pbm_quantize replaces repro/kernels/pbm_kernel.py:pbm_quantize_2d (:53);
//  * qmgeo_quantize replaces repro/kernels/qmgeo_kernel.py:qmgeo_quantize_2d
//    (:59).
//
// The TPU kernels tile the flattened batch into (block_rows, 128) VMEM blocks
// and derive each element's RNG counter from the block id. Here one thread
// takes one element at a time over a grid-stride loop; element i of the
// flattened batch draws counter row_offset * dim + i (mod 2^32), which is
// (row_offset + r) * dim + c for element (r, c), the counter the reference's
// _*_block bodies and the round sums of csrc/round_sum.cu give it.
//
// The per-element bodies are the same device functions the round sums inline
// (rqm_encode.cuh, pbm_encode.cuh, qmgeo_encode.cuh). Each element reads 4
// bytes and writes 4, and makes the encoder's splitmix32 draws: 15 for RQM
// and 16 for PBM at m=16, 2 for QMGeo, whose m+1 expf are made once a block
// into its level tables (no expf an element). The bound on an H100 is the
// larger of the 8 bytes per element and the draws the data needs on the
// integer pipes, which chip_smoke.py computes from the run's own data. The
// hashes, not the bytes, set RQM's and PBM's time: what their encoders do
// about that is in rqm_encode.cuh and pbm_encode.cuh. An encoder's setup runs
// once a block before the element loop (QMGeo's tables, in dynamic shared
// memory; nothing for the others). Neighbouring threads take neighbouring
// elements, so loads and stores coalesce, and the grid (up to 16 blocks of
// 256 per SM, two rounds of the 8 an SM holds at 32 registers a thread)
// keeps up to 64 warps on every SM to hide the encode's latency.
//
// Each entry has a _dev twin that reads the seed from device memory (one
// load a thread) where the entry takes it by value: a captured CUDA graph
// replays the launch with the seed its buffer holds then. Both are one
// template, so they give the same levels.
#include <cuda_runtime.h>

#include <cstdint>

#include "device.cuh"
#include "pbm_encode.cuh"
#include "qmgeo_encode.cuh"
#include "rqm_encode.cuh"

namespace {

template <class Encoder, class Seed>
__global__ void quantize_kernel(const float* __restrict__ x, int* __restrict__ z,
                                int64_t n, Seed seed_arg, uint32_t base,
                                Encoder encoder) {
  const Encoder encode = encoder.setup(repro::dynamic_shared());
  const uint32_t seed = repro::load_seed(seed_arg);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // an encoder with kBatch > 1 loads kBatch elements before it encodes
  // them, so a thread has that many loads in flight (qmgeo_encode.cuh)
  if constexpr (Encoder::kBatch > 1) {
    for (; i + (Encoder::kBatch - 1) * stride < n; i += Encoder::kBatch * stride) {
      float v[Encoder::kBatch];
#pragma unroll
      for (int b = 0; b < Encoder::kBatch; ++b) v[b] = x[i + b * stride];
#pragma unroll
      for (int b = 0; b < Encoder::kBatch; ++b) {
        z[i + b * stride] = encode(v[b], seed, base + static_cast<uint32_t>(i + b * stride));
      }
    }
  }
  for (; i < n; i += stride) {
    z[i] = encode(x[i], seed, base + static_cast<uint32_t>(i));
  }
}

constexpr int kThreads = 256;

template <class Encoder, class Seed>
int launch(const float* x, int* z, int rows, int dim, Seed seed,
           uint32_t row_offset, Encoder encode, void* stream) {
  const int64_t n = static_cast<int64_t>(rows) * dim;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  // two rounds of the blocks every SM holds: 16 an SM of an H100
  const repro::DeviceShape card = repro::device_shape();
  const int64_t max_blocks = static_cast<int64_t>(card.sms) * 2 * card.threads_per_sm / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  // (row_offset + r) * dim + c == row_offset * dim + i, mod 2^32
  const uint32_t base = row_offset * static_cast<uint32_t>(dim);
  const size_t shared = encode.shared_bytes();
  quantize_kernel<<<static_cast<int>(blocks), kThreads, shared,
                    static_cast<cudaStream_t>(stream)>>>(x, z, n, seed, base, encode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define REPRO_QUANTIZE_ENTRIES(SEED_T, SUFFIX)                                      \
  int rqm_quantize##SUFFIX(const float* x, int* z, int rows, int dim, SEED_T seed,     \
                           uint32_t row_offset, float c, float x_max, float step,     \
                           uint32_t keep_le, uint32_t keep_any, int m, void* stream) { \
    return repro::rqm_dispatch({c, x_max, step, keep_le, keep_any, m},                 \
                               [&](auto encode) {                                      \
      return launch(x, z, rows, dim, seed, row_offset, encode, stream);                \
    });                                                                                \
  }                                                                                    \
  int pbm_quantize##SUFFIX(const float* x, int* z, int rows, int dim, SEED_T seed,     \
                           uint32_t row_offset, float c, float theta, int m,           \
                           void* stream) {                                             \
    return repro::pbm_dispatch({c, theta, m}, [&](auto encode) {                       \
      return launch(x, z, rows, dim, seed, row_offset, encode, stream);                \
    });                                                                                \
  }                                                                                    \
  int qmgeo_quantize##SUFFIX(const float* x, int* z, int rows, int dim, SEED_T seed,   \
                             uint32_t row_offset, float c, float x_max, float step,   \
                             float log_r, float inv_1mr, float r_over_1mr, int m,     \
                             void* stream) {                                           \
    return repro::qmgeo_dispatch({c, x_max, step, log_r, inv_1mr, r_over_1mr, m},      \
                                 [&](auto encode) {                                    \
      return launch(x, z, rows, dim, seed, row_offset, encode, stream);                \
    });                                                                                \
  }

// the seed by value: rqm_quantize, pbm_quantize, qmgeo_quantize
REPRO_QUANTIZE_ENTRIES(uint32_t, )
// the seed from device memory: rqm_quantize_dev, pbm_quantize_dev, qmgeo_quantize_dev
REPRO_QUANTIZE_ENTRIES(const uint32_t*, _dev)

const char* quantize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
