// What the port's kernels with host-buildable lane bodies share (chain.cu,
// extend.cu, kmer.cu, seedsw.cu): the lane-body qualifier, the entry
// names, min/max and the packed doubled text's decode.
//
// Compiled by nvcc, a source's lane bodies are __host__ __device__ and its
// entries are NAME_launch(..., stream); compiled by a host compiler (g++ -x
// c++), the same bodies give entries NAME_host(...) without a stream, which
// run every lane in turn, so the lane logic can be held against the plain
// versions on a machine without a card.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LANE_HD __host__ __device__
#define LANE_ENTRY(name) name##_launch
#define LANE_STREAM , cudaStream_t stream
#else
#define LANE_HD
#define LANE_ENTRY(name) name##_host
#define LANE_STREAM
#endif

template <typename T>
LANE_HD inline T max_(T a, T b) { return a > b ? a : b; }
template <typename T>
LANE_HD inline T min_(T a, T b) { return a < b ? a : b; }

// the code at position t (>= 0) of the packed doubled text: 16 codes a
// 32-bit word, the first in the top bits (layout.pack_doubled_rows), the
// word index clamped to the table's last word as the plain versions clamp
// it; the caller maps positions outside [0, seq_len) to its own code
LANE_HD inline int32_t packed_code(const int32_t* text, long long n_words,
                                   long long t) {
  const long long w = min_(t >> 4, n_words - 1);
  return static_cast<int32_t>(
      (static_cast<uint32_t>(text[w]) >> (2 * (15 - (t & 15)))) & 3u);
}
