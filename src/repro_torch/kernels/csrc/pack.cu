// The dense b-bit wire codec: planar pack and unpack of a flat int32 vector.
//
// Layout (repro_torch/core/wire.py): n coordinates pack into W int32 words,
// k = 32 / bits fields a word; coordinate c lives in field c / W of word
// c % W, at bit offset (c / W) * bits. Fields past n are 0.
//
//  * pack_flat: thread w builds word w from the k fields z[f * W + w],
//    f < k. For each f the warp reads 32 neighbouring levels, so every load
//    is coalesced. The fields are shifted into place and added as uint32
//    (disjoint bit ranges while every level is < 2^bits, so + is |; for
//    other inputs it wraps exactly like the plain version's int64 sum).
//    Replaces the Pallas kernel repro/kernels/pack_kernel.py:pack_flat
//    (:66), whose output-revisiting grid over fields becomes the loop.
//  * unpack_flat: thread c reads word c % W, shifts it as uint32 by
//    (c / W) * bits and masks. A logical shift plus the mask equals the
//    reference's arithmetic shift plus mask at every width, including the
//    16-bit top field that sets the sign bit. Replaces the Pallas kernel
//    repro/kernels/pack_kernel.py:unpack_flat (:102).
//
// Unlike the TPU kernels these take any word count W (the paper's round has
// W = 74,010, not a multiple of 128). Both are bound by bytes on an H100: one
// read of the levels or words, one write of the other, a few integer ops
// a word.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void pack_flat_kernel(const int* __restrict__ z, int* __restrict__ words,
                                 int n, int n_words, int bits, int k) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n_words) return;
  uint32_t word = 0;
  for (int f = 0; f < k; ++f) {
    const long long c = static_cast<long long>(f) * n_words + w;
    if (c >= n) break;
    word += static_cast<uint32_t>(z[c]) << (f * bits);
  }
  words[w] = static_cast<int>(word);
}

__global__ void unpack_flat_kernel(const int* __restrict__ words, int* __restrict__ z,
                                   int n, int n_words, int bits) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const uint32_t word = static_cast<uint32_t>(words[c % n_words]);
  const uint32_t shift = static_cast<uint32_t>(c / n_words) * bits;
  const uint32_t mask = (1u << bits) - 1u;  // bits <= 16
  z[c] = static_cast<int>((word >> shift) & mask);
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

int pack_flat(const int* z, int* words, int n, int n_words, int bits, void* stream) {
  const int blocks = (n_words + kThreads - 1) / kThreads;
  pack_flat_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      z, words, n, n_words, bits, 32 / bits);
  return static_cast<int>(cudaGetLastError());
}

int unpack_flat(const int* words, int* z, int n, int n_words, int bits, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  unpack_flat_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      words, z, n, n_words, bits);
  return static_cast<int>(cudaGetLastError());
}

const char* pack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
