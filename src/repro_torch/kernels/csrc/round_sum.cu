// The fused round: clip -> encode -> weighted cohort sum, dense and packed.
//
// Replaces the Pallas kernels repro/kernels/fused_round_kernel.py:
// round_sum_2d (dense, :101) and round_sum_packed_2d (packed, :227), for
// the encoders those take: rqm, pbm and qmgeo dense; rqm and qmgeo packed
// (the PBM mechanism's sum never travels packed: its decode is not the grid
// decode the packed apply performs).
//
// An encoder's setup runs once a block before the rows (the QMGeo encoder's
// level tables, in dynamic shared memory beside the packed kernel's partial
// sums; nothing for the others: qmgeo_encode.cuh).
// On the TPU the cohort rows are an inner sequential grid axis that revisits
// the output block. Here the rows are a loop inside a thread, the sum an
// integer one in registers: no atomics and no cross-block reduction. The
// kernels are templates over the encoder, whose per-element body is the same
// device function csrc/quantize.cu inlines (rqm_encode.cuh, pbm_encode.cuh,
// qmgeo_encode.cuh), so a round sum equals the quantize kernel's batch summed.
//
// What bounds them on an H100: the encode's instructions. A round reads the
// (rows, dim) batch once (35.5 MB at the paper's 40 x 222,030) and writes
// 0.9 MB dense or 0.3 MB packed; the RQM encoder makes m-1 splitmix32 draws
// per element (15 at m=16), of which the data needs 5.5 (out to the nearest
// kept level on each side, and the rounding draw; chip_smoke.py counts them
// for the bound). rqm_encode.cuh says why every keep draw is still made and
// how each costs less; the PBM encoder makes m draws, each a bare hash and an
// integer compare (pbm_encode.cuh), and the QMGeo encoder 2 and a search of
// its level tables (qmgeo_encode.cuh). What is left to the layout is to give every SM an
// equal share of the encodes, with enough warps to hide the hash's latency.
//
//  * Dense: see round_sum_dense_kernel.
//  * Packed: see round_sum_packed_kernel.
// In both, a warp reads 32 consecutive columns of a row, so the loads
// coalesce.
//
// Each entry has a _dev twin that reads the seed from device memory (one
// load a thread) where the entry takes it by value: a captured CUDA graph
// replays the launch with the seed its buffer holds then. Both are one
// template, so they give the same sums.
//
// RNG counter of element (r, c): (row_offset + r) * dim + c, as in JAX.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "device.cuh"
#include "pbm_encode.cuh"
#include "qmgeo_encode.cuh"
#include "rqm_encode.cuh"

namespace {

// sum_{r in [r_begin, r_end)} w[r] * encode(x[r][c]), wrapping. An encoder
// with kBatch > 1 takes kBatch rows at once, loaded before it encodes them
// (qmgeo_encode.cuh says why); the rest go one at a time.
template <class Encoder>
__device__ __forceinline__ uint32_t column_sum(const float* __restrict__ x,
                                               const int* __restrict__ w, int r_begin,
                                               int r_end, int dim, int c, uint32_t seed,
                                               uint32_t row_offset, const Encoder& encode) {
  uint32_t acc = 0;
  int r = r_begin;
  if constexpr (Encoder::kBatch > 1) {
    for (; r + Encoder::kBatch <= r_end; r += Encoder::kBatch) {
      float v[Encoder::kBatch];
#pragma unroll
      for (int b = 0; b < Encoder::kBatch; ++b) v[b] = x[static_cast<size_t>(r + b) * dim + c];
#pragma unroll
      for (int b = 0; b < Encoder::kBatch; ++b) {
        const uint32_t counter = (row_offset + static_cast<uint32_t>(r + b)) *
                                     static_cast<uint32_t>(dim) +
                                 static_cast<uint32_t>(c);
        const int z = encode(v[b], seed, counter);
        acc += static_cast<uint32_t>(z) * static_cast<uint32_t>(w[r + b]);
      }
    }
  }
  for (; r < r_end; ++r) {
    const uint32_t counter = (row_offset + static_cast<uint32_t>(r)) *
                                 static_cast<uint32_t>(dim) +
                             static_cast<uint32_t>(c);
    const int z = encode(x[static_cast<size_t>(r) * dim + c], seed, counter);
    acc += static_cast<uint32_t>(z) * static_cast<uint32_t>(w[r]);
  }
  return acc;
}

// Word wi carries coordinate c = f * words + wi in field f. A block owns a
// tile of kTile consecutive words; thread (t, f, g) = threadIdx (x, y, z)
// encodes column f * words + wi, wi the tile's t-th word, over the rows of
// group g, so a warp reads 32 consecutive columns of a row. The block's
// fields x groups partial sums of a word, each shifted to its field, meet in
// shared memory, and one thread adds them and writes the word once. All adds
// are uint32_t and wrap: they are associative and commutative mod 2^32, so
// any split gives the words one thread per word gives, bit for bit, at any
// weights and any bits (a 16-bit top field sets the sign bit; shifting into
// an int's sign bit is undefined in C++17). Coordinates past dim are padding
// and stay 0, so the words are canonical (wire.pack_bits of the dense sum).
//
// The layout is for balance. One thread per word, looping over its 3 fields
// x 40 rows (the kernel this one replaced), made 74,010 threads in 290
// blocks of 256 at the paper's shape (40 x 222,030, 10 bits): 26 SMs ran
// three blocks and 106 two, and the busiest SM encoded 1.37x the mean. Here
// launch_packed gives a column's rows to one group when one thread per
// column already fills the card (2048 threads an SM, which the register cap
// below keeps), else splits them into groups. At the paper's shape that is
// one group: 2313 blocks of 96 threads, each thread 40 encodes; an SM holds
// 21 such blocks, so all 2313 run in one wave, 17 or 18 on each SM, and the
// busiest SM's share of the encodes is 18 / (2313 / 132) = 1.03x the mean.
constexpr int kTile = 32;         // words per block, one warp's width
constexpr int kMaxBlock = 1024;   // kTile x fields x groups threads at most

// Shared bytes of the partial sums of `slots` = fields x groups, rounded up
// to 16 so that the encoder's tables after them are aligned.
__host__ __device__ constexpr size_t part_bytes(unsigned slots) {
  return (sizeof(uint32_t) * kTile * slots + 15) & ~static_cast<size_t>(15);
}
static_assert(part_bytes(kMaxBlock / kTile) + repro::kQMGeoMaxTableBytes <= 48 * 1024,
              "a block's shared memory fits the 48 KB a launch has without an opt-in");

template <class Encoder, class Seed>
__global__ void __launch_bounds__(kMaxBlock, 2)  // <= 32 registers: 2048 threads an SM
round_sum_packed_kernel(const float* __restrict__ x, const int* __restrict__ w,
                        int* __restrict__ out, int rows, int dim, int words, int bits,
                        int rows_per_group, Seed seed_arg, uint32_t row_offset,
                        Encoder encoder) {
  // [group][field][kTile] partial sums, then the encoder's tables
  uint32_t* part = reinterpret_cast<uint32_t*>(repro::dynamic_shared());
  const Encoder encode = encoder.setup(repro::dynamic_shared() +
                                       part_bytes(blockDim.y * blockDim.z));
  const uint32_t seed = repro::load_seed(seed_arg);
  const int t = threadIdx.x, f = threadIdx.y, g = threadIdx.z;
  const int wi = blockIdx.x * kTile + t;
  const int c = f * words + wi;
  uint32_t partial = 0;
  if (wi < words && c < dim) {
    const int r_end = min(rows, (g + 1) * rows_per_group);
    partial = column_sum(x, w, g * rows_per_group, r_end, dim, c, seed, row_offset, encode);
  }
  part[(g * blockDim.y + f) * kTile + t] = partial << (f * bits);
  __syncthreads();
  if (f == 0 && g == 0 && wi < words) {
    uint32_t acc = 0;
    for (int i = 0; i < static_cast<int>(blockDim.y * blockDim.z); ++i) {
      acc += part[i * kTile + t];
    }
    out[wi] = static_cast<int>(acc);
  }
}

// The dense sum's layout is for balance over the SMs. One thread per column
// loops over the rows, so a block's share of the encodes is its columns'.
// The kernel this one replaced used blocks of 256: 868 blocks at the paper's
// 40 x 222,030, 6 or 7 an SM, and the busiest SMs encoded 7 / 6.58 = 1.064x
// the mean. Here a block is kDenseThreads = 96 threads at most 32 registers
// (the bound below), so an SM holds 21 blocks and a grid of up to 132 x 21 =
// 2772 blocks runs in one wave: at the paper's shape 2313 blocks, 17 or 18
// an SM, and the busiest SM encodes 18 / 17.52 = 1.027x the mean, as the
// packed kernel's do.
//
// What that bought on an H100 (PERF.md, scripts/torch_kernel_ab.py): the
// three encoders' sums within 0.5% of the 256-thread layout's; no layout
// that evened the SMs or their schedulers out made any of them faster.
// Blocks of 64 and 128 gave the same times; splitting each column's rows
// over the four warps of a block (one on each scheduler, their partial sums
// added in shared memory; 1.008x the mean on the busiest scheduler) made
// the RQM sum 0% to 6% slower, PBM's 3% to 6% and QMGeo's 7% to 12%. What
// did take 2% off the RQM sum was loading 4 rows at once with 80 registers
// a thread, 3 blocks of 256 an SM; within 32 registers that costs 8% more
// ALU operations a row and the sum 4% (rqm_encode.cuh).
constexpr int kDenseThreads = 96;

template <class Encoder, class Seed>
__global__ void __launch_bounds__(kDenseThreads, 2048 / kDenseThreads)  // <= 32 registers
round_sum_dense_kernel(const float* __restrict__ x, const int* __restrict__ w,
                       int* __restrict__ out, int rows, int dim, Seed seed_arg,
                       uint32_t row_offset, Encoder encoder) {
  const Encoder encode = encoder.setup(repro::dynamic_shared());
  const uint32_t seed = repro::load_seed(seed_arg);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= dim) return;
  out[c] = static_cast<int>(column_sum(x, w, 0, rows, dim, c, seed, row_offset, encode));
}

template <class Encoder, class Seed>
int launch_dense(const float* x, const int* w, int* out, int rows, int dim, Seed seed,
                 uint32_t row_offset, Encoder encode, void* stream) {
  const int blocks = (dim + kDenseThreads - 1) / kDenseThreads;
  round_sum_dense_kernel<<<blocks, kDenseThreads, encode.shared_bytes(),
                           static_cast<cudaStream_t>(stream)>>>(x, w, out, rows, dim, seed,
                                                                row_offset, encode);
  return static_cast<int>(cudaGetLastError());
}

template <class Encoder, class Seed>
int launch_packed(const float* x, const int* w, int* out, int rows, int dim,
                  int words, int bits, Seed seed, uint32_t row_offset,
                  Encoder encode, void* stream) {
  const int fields = 32 / bits;
  const int tiles = (words + kTile - 1) / kTile;
  // split the rows only as far as the card has room for more threads
  const repro::DeviceShape card = repro::device_shape();
  const int64_t per_group = static_cast<int64_t>(tiles) * kTile * fields;
  int64_t groups = static_cast<int64_t>(card.sms) * card.threads_per_sm / per_group;
  if (groups > rows) groups = rows;
  if (groups > kMaxBlock / (kTile * fields)) groups = kMaxBlock / (kTile * fields);
  if (groups < 1) groups = 1;
  const int rows_per_group = static_cast<int>((rows + groups - 1) / groups);
  groups = (rows + rows_per_group - 1) / rows_per_group;  // no empty group
  const dim3 block(kTile, fields, static_cast<unsigned>(groups));
  const size_t shared = part_bytes(static_cast<unsigned>(fields * groups)) +
                        encode.shared_bytes();
  round_sum_packed_kernel<<<tiles, block, shared, static_cast<cudaStream_t>(stream)>>>(
      x, w, out, rows, dim, words, bits, rows_per_group, seed, row_offset, encode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define REPRO_ROUND_SUM_ENTRIES(SEED_T, SUFFIX)                                          \
  int rqm_round_sum_dense##SUFFIX(const float* x, const int* w, int* out, int rows,        \
                                  int dim, SEED_T seed, uint32_t row_offset, float c,      \
                                  float x_max, float step, uint32_t keep_le,               \
                                  uint32_t keep_any, int m, void* stream) {                \
    return repro::rqm_dispatch({c, x_max, step, keep_le, keep_any, m}, [&](auto encode) { \
      return launch_dense(x, w, out, rows, dim, seed, row_offset, encode, stream);         \
    });                                                                                    \
  }                                                                                        \
  int pbm_round_sum_dense##SUFFIX(const float* x, const int* w, int* out, int rows,        \
                                  int dim, SEED_T seed, uint32_t row_offset, float c,      \
                                  float theta, int m, void* stream) {                      \
    return repro::pbm_dispatch({c, theta, m}, [&](auto encode) {                           \
      return launch_dense(x, w, out, rows, dim, seed, row_offset, encode, stream);         \
    });                                                                                    \
  }                                                                                        \
  int qmgeo_round_sum_dense##SUFFIX(const float* x, const int* w, int* out, int rows,      \
                                    int dim, SEED_T seed, uint32_t row_offset, float c,    \
                                    float x_max, float step, float log_r, float inv_1mr,   \
                                    float r_over_1mr, int m, void* stream) {               \
    return repro::qmgeo_dispatch({c, x_max, step, log_r, inv_1mr, r_over_1mr, m},          \
                                 [&](auto encode) {                                        \
      return launch_dense(x, w, out, rows, dim, seed, row_offset, encode, stream);         \
    });                                                                                    \
  }                                                                                        \
  int rqm_round_sum_packed##SUFFIX(const float* x, const int* w, int* out, int rows,       \
                                   int dim, int words, int bits, SEED_T seed,              \
                                   uint32_t row_offset, float c, float x_max, float step,  \
                                   uint32_t keep_le, uint32_t keep_any, int m,             \
                                   void* stream) {                                         \
    return repro::rqm_dispatch({c, x_max, step, keep_le, keep_any, m}, [&](auto encode) { \
      return launch_packed(x, w, out, rows, dim, words, bits, seed, row_offset, encode,    \
                           stream);                                                        \
    });                                                                                    \
  }                                                                                        \
  int qmgeo_round_sum_packed##SUFFIX(const float* x, const int* w, int* out, int rows,     \
                                     int dim, int words, int bits, SEED_T seed,            \
                                     uint32_t row_offset, float c, float x_max,            \
                                     float step, float log_r, float inv_1mr,               \
                                     float r_over_1mr, int m, void* stream) {              \
    return repro::qmgeo_dispatch({c, x_max, step, log_r, inv_1mr, r_over_1mr, m},          \
                                 [&](auto encode) {                                        \
      return launch_packed(x, w, out, rows, dim, words, bits, seed, row_offset, encode,    \
                           stream);                                                        \
    });                                                                                    \
  }

// the seed by value: <rqm,pbm,qmgeo>_round_sum_dense, <rqm,qmgeo>_round_sum_packed
REPRO_ROUND_SUM_ENTRIES(uint32_t, )
// the seed from device memory: the same names with _dev
REPRO_ROUND_SUM_ENTRIES(const uint32_t*, _dev)

const char* round_sum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
