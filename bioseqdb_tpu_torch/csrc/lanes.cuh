// What the port's kernels with host-buildable lane bodies share (chain.cu,
// extend.cu, fm.cu, fm_seed.cu, kmer.cu, resolve.cu, seedsw.cu): the
// lane-body qualifier, the entry names, min/max, the packed doubled text's
// decode, and the group exchanges of a kernel that runs several threads a
// read.
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

// ---- groups: G threads (a warp, or a quad of a warp) run one read ----
//
// A group body is written once for the card and the host. Code outside
// FOR_LANES is uniform: every thread of the group runs it on the same
// values (on the host it runs once). FOR_LANES(G, t) { ... } is the part
// each thread runs as lane t of its group: on the card one pass, t the
// thread's lane; on the host G passes in turn, t = 0 .. G - 1 (so a body
// may `continue`, never `break` or `return`). A value that crosses from
// the lanes to an exchange lives in a Lanes<T, G>: a register on the card,
// an array of G on the host. The exchanges (ballot, shfl, the reductions)
// are called from uniform code, all of the group's threads together; a
// lane reads what another lane wrote to shared memory only after
// group_sync<G>(). Bit t of a ballot is lane t's. A group body is a
// GROUP_FN: device code on the card (it uses the exchanges), host code in
// a host build.

#ifdef __CUDACC__
#define GROUP_FN __device__
template <typename T, int G>
struct Lanes {
  T v;
  __device__ __forceinline__ T& operator[](int) { return v; }
  __device__ __forceinline__ const T& operator[](int) const { return v; }
};
#define FOR_LANES(G, t) \
  for (int t = static_cast<int>(threadIdx.x) % (G), t##_pass = 0; \
       t##_pass < 1; ++t##_pass)

template <int G>
__device__ __forceinline__ unsigned group_mask() {
  return G == 32 ? 0xFFFFFFFFu
                 : ((1u << G) - 1u) << (threadIdx.x % 32 / G * G);
}
template <int G>
__device__ __forceinline__ void group_sync() { __syncwarp(group_mask<G>()); }
template <int G>
__device__ __forceinline__ uint32_t ballot(const Lanes<bool, G>& p) {
  const uint32_t m = __ballot_sync(group_mask<G>(), p.v);
  return G == 32 ? m : (m >> (threadIdx.x % 32 / G * G)) & ((1u << G) - 1u);
}
template <int G, typename T>
__device__ __forceinline__ T shfl(const Lanes<T, G>& x, int src) {
  return __shfl_sync(group_mask<G>(), x.v, src, G);
}
// each lane gets the value of lane t ^ m of its group (m < G)
template <int G, typename T>
__device__ __forceinline__ Lanes<T, G> shfl_xor(const Lanes<T, G>& x, int m) {
  return Lanes<T, G>{__shfl_xor_sync(group_mask<G>(), x.v, m, G)};
}
// each lane t >= d gets the value of lane t - d (the others their own)
template <int G, typename T>
__device__ __forceinline__ Lanes<T, G> shfl_up(const Lanes<T, G>& x, int d) {
  return Lanes<T, G>{__shfl_up_sync(group_mask<G>(), x.v, d, G)};
}
template <int G, typename T>
__device__ __forceinline__ T group_sum(const Lanes<T, G>& x) {
  T v = x.v;
  for (int o = G / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(group_mask<G>(), v, o, G);
  return v;
}
template <int G, typename T>
__device__ __forceinline__ T group_min(const Lanes<T, G>& x) {
  T v = x.v;
  for (int o = G / 2; o > 0; o >>= 1)
    v = min_(v, __shfl_xor_sync(group_mask<G>(), v, o, G));
  return v;
}
template <int G, typename T>
__device__ __forceinline__ T group_max(const Lanes<T, G>& x) {
  T v = x.v;
  for (int o = G / 2; o > 0; o >>= 1)
    v = max_(v, __shfl_xor_sync(group_mask<G>(), v, o, G));
  return v;
}
// uniform code's stores to device memory: lane 0 of the group
template <int G>
__device__ __forceinline__ bool group_leader() {
  return threadIdx.x % G == 0;
}
// a lane's min / max into a value other lanes of the block fold into too
// (shared or device memory): atomic on the card, in turn on the host
template <typename T>
__device__ __forceinline__ void fold_min(T* at, T v) { atomicMin(at, v); }
template <typename T>
__device__ __forceinline__ void fold_max(T* at, T v) { atomicMax(at, v); }
__device__ __forceinline__ void fold_or(uint64_t* at, uint64_t v) {
  atomicOr(reinterpret_cast<unsigned long long*>(at),
           static_cast<unsigned long long>(v));
}
__device__ __forceinline__ int popc32(uint32_t x) { return __popc(x); }
// the lowest / highest set bit of x != 0
__device__ __forceinline__ int low_bit(uint32_t x) { return __ffs(x) - 1; }
__device__ __forceinline__ int low_bit64(uint64_t x) {
  return __ffsll(static_cast<long long>(x)) - 1;
}
__device__ __forceinline__ int high_bit(uint32_t x) { return 31 - __clz(x); }
#else
#define GROUP_FN
template <typename T, int G>
struct Lanes {
  T v[G];
  T& operator[](int t) { return v[t]; }
  const T& operator[](int t) const { return v[t]; }
};
#define FOR_LANES(G, t) for (int t = 0; t < (G); ++t)

template <int G>
inline void group_sync() {}
template <int G>
inline uint32_t ballot(const Lanes<bool, G>& p) {
  uint32_t m = 0;
  for (int t = 0; t < G; ++t) m |= static_cast<uint32_t>(p[t]) << t;
  return m;
}
template <int G, typename T>
inline T shfl(const Lanes<T, G>& x, int src) { return x[src % G]; }
template <int G, typename T>
inline Lanes<T, G> shfl_xor(const Lanes<T, G>& x, int m) {
  Lanes<T, G> y;
  for (int t = 0; t < G; ++t) y[t] = x[t ^ m];
  return y;
}
template <int G, typename T>
inline Lanes<T, G> shfl_up(const Lanes<T, G>& x, int d) {
  Lanes<T, G> y;
  for (int t = 0; t < G; ++t) y[t] = x[t >= d ? t - d : t];
  return y;
}
template <int G, typename T>
inline T group_sum(const Lanes<T, G>& x) {
  T v = 0;
  for (int t = 0; t < G; ++t) v += x[t];
  return v;
}
template <int G, typename T>
inline T group_min(const Lanes<T, G>& x) {
  T v = x[0];
  for (int t = 1; t < G; ++t) v = min_(v, x[t]);
  return v;
}
template <int G, typename T>
inline T group_max(const Lanes<T, G>& x) {
  T v = x[0];
  for (int t = 1; t < G; ++t) v = max_(v, x[t]);
  return v;
}
template <int G>
inline bool group_leader() { return true; }
template <typename T>
inline void fold_min(T* at, T v) { if (v < *at) *at = v; }
template <typename T>
inline void fold_max(T* at, T v) { if (v > *at) *at = v; }
inline void fold_or(uint64_t* at, uint64_t v) { *at |= v; }
inline int popc32(uint32_t x) { return __builtin_popcount(x); }
inline int low_bit(uint32_t x) { return __builtin_ctz(x); }
inline int low_bit64(uint64_t x) { return __builtin_ctzll(x); }
inline int high_bit(uint32_t x) { return 31 - __builtin_clz(x); }

// host stand-ins for the card's types and intrinsics the bodies use
struct int4 {
  int x, y, z, w;
};
struct int2 {
  int x, y;
};
template <typename T>
inline T __ldg(const T* p) { return *p; }
#endif
