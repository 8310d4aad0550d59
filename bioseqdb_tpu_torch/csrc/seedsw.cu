// The long-read seed-SW filter's local Smith-Waterman for Hopper: every
// seed lane's best local affine-gap score against its reference window in
// one launch, a warp a lane.
//
// Replaces the TPU program of bioseqdb_tpu/kernels/seedsw.py:56
// _local_sw_batch (its 200-row fori_loop at :94), called from seed_sw_filter
// (:99): XLA compiled the loop into the one TPU device program; no Pallas.
// The kernel computes exactly what the plain version
// bioseqdb_tpu_torch/kernels/seedsw.py seed_sw_scores_plain computes (the
// window gathers and local_sw_batch; equal to the JAX package and to
// cpu/oracle.py's local_sw_score), score for score. The window bounds and
// the need mask stay eager torch ops (seedsw.py seed_sw_windows: a
// searchsorted over the references and ~30 elementwise ops, the same on
// every path); the kernel reads the query codes from the batch and the
// target from the packed doubled text itself, so no [N, 200] window buffer
// is made, and it runs over every lane with the need mask, with no host
// wait.
//
// What bounds it: a needed lane reads its query window (up to 200 codes)
// and ~13 text words and writes one score; the DP needs qlen columns x
// tlen rows of ~10 integer operations a cell (a column past the query's
// end holds code 4 and cannot raise the best score; the kernel computes
// all 200, as the plain version does). A batch of 4,096 reads of 1,500 bp
// needs ~4 x 10^9 such cells: ~1.3 ms at the card's issue rate against
// ~0.05 ms of bytes, so the operations bound it.
//
// Design:
// - A warp a lane, 4 lanes a block; a lane that is not needed returns at
//   once. Thread t holds the 7 columns 7t .. 7t + 6 (32 x 7 >= 200; the
//   columns past 199 compute nothing) with their H, E and query codes in
//   registers.
// - A row is the plain version's lazy-F prefix-max form, term for term:
//   E from the previous row's H; hne = max(diag, E, 0); opener = the
//   prefix max of hne[k] - oe_ins + e_ins * k (each thread over its
//   columns, then a warp scan of the threads' maxima, 5 shuffles); F[j] =
//   opener[j - 1] - e_ins * j (F[0] = -2^28); H = max(hne, F); the best
//   score the warp max of H over the rows below tlen.
// - The row's two halves (row_open, row_close) are __host__ __device__
//   functions of one thread's columns. Compiled without nvcc (g++ -x c++),
//   the file gives a host entry point that runs them over 32 emulated
//   threads with the same neighbour and scan exchanges the shuffles make,
//   so the lane logic can be held against the plain version on a machine
//   without a card.
// - Ranks (the window start and end) take the template type R (int32 or
//   int64, the index's rank dtype).

#include "lanes.cuh"

namespace {

constexpr int kLanesPerBlock = 4;      // warps a block: one lane a warp
constexpr int kWarp = 32;
constexpr int kWidth = 200;            // seedsw.py _W (MEM_SHORT_LEN)
constexpr int kCols = 7;               // columns a thread: 32 x 7 >= 200
constexpr int kNeg = -(1 << 28);       // seedsw.py NEG: F[0]
constexpr int kScanFloor = -(1 << 30); // below every opener value
constexpr int kRefused = 1;            // cudaErrorInvalidValue

struct SeedSwParams {
  const int32_t* codes;    // [B, W] read codes
  const int32_t* text;     // [n_words] packed doubled text, 16 codes a word
  const int32_t* qb;       // [N] query window start
  const int32_t* qe;       // [N] query window end
  const void* rb;          // [N] R, reference window start
  const void* re;          // [N] R, reference window end
  const uint8_t* need;     // [N] torch.bool
  int32_t* score;          // [N] out: the best score where needed, else 0
  long long n_words, seq_len, N, S, W;
  int32_t a, mis, o_del, e_del, o_ins, e_ins;
};


// one thread's columns of a lane: query codes, and H and E of the last row
struct Cols {
  int32_t q[kCols], h[kCols], e[kCols];
};

// the doubled text's code at t, 4 outside [0, seq_len) (extend.py
// window_doubled)
LANE_HD inline int32_t text_code(const SeedSwParams& p, long long t) {
  return t < 0 || t >= p.seq_len ? 4 : packed_code(p.text, p.n_words, t);
}

// thread th's query codes and zero rows for lane n
LANE_HD inline void cols_init(Cols& c, const SeedSwParams& p, long long n,
                                int th) {
  const int32_t qb = p.qb[n];
  const int32_t qlen = p.qe[n] - qb;
  const int32_t* row = p.codes + (n / p.S) * p.W;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int j = kCols * th + k;
    const long long col = static_cast<long long>(qb) + j;
    c.q[k] = (j < qlen && col < p.W) ? row[col] : 4;
    c.h[k] = c.e[k] = 0;
  }
}

// a row's first half on thread th's columns: E (from the last row's H),
// hne = max(diag, E, 0) into hne; returns the prefix max of hne[k] - oe_ins
// + e_ins * k over the thread's columns. hleft is the last row's H in the
// column before the thread's first (0 for thread 0)
LANE_HD inline int32_t row_open(Cols& c, const SeedSwParams& p, int th,
                                  int32_t ti, int32_t hleft,
                                  int32_t* hne) {
  const int32_t oe_del = p.o_del + p.e_del, oe_ins = p.o_ins + p.e_ins;
  int32_t om = kScanFloor;
  int32_t hdiag = hleft;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int j = kCols * th + k;
    if (j < kWidth) {   // the columns past 199 compute nothing
      const int32_t q = c.q[k];
      const int32_t sc = (ti < 4 && q < 4) ? (ti == q ? p.a : -p.mis) : -1;
      const int32_t diag = hdiag + sc;
      hdiag = c.h[k];
      c.e[k] = max_(c.e[k] - p.e_del, c.h[k] - oe_del);
      hne[k] = max_(max_(diag, c.e[k]), 0);
      om = max_(om, hne[k] - oe_ins + p.e_ins * j);
    }
  }
  return om;
}

// a row's second half: F from the opener prefix carried in (the max over
// the columns before the thread's first), H = max(hne, F); returns the
// thread's row max of H
LANE_HD inline int32_t row_close(Cols& c, const SeedSwParams& p, int th,
                                   int32_t carry, const int32_t* hne) {
  const int32_t oe_ins = p.o_ins + p.e_ins;
  int32_t running = carry, best = 0;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int j = kCols * th + k;
    if (j < kWidth) {
      const int32_t f = j == 0 ? kNeg : running - p.e_ins * j;
      c.h[k] = max_(hne[k], f);
      best = max_(best, c.h[k]);
      running = max_(running, hne[k] - oe_ins + p.e_ins * j);
    }
  }
  return best;
}

template <typename R>
LANE_HD inline int tlen_of(const SeedSwParams& p, long long n) {
  return static_cast<int>(static_cast<const R*>(p.re)[n] -
                          static_cast<const R*>(p.rb)[n]);
}

template <typename R>
LANE_HD inline long long rb_of(const SeedSwParams& p, long long n) {
  return static_cast<long long>(static_cast<const R*>(p.rb)[n]);
}

#ifdef __CUDACC__
template <typename R>
__global__ void __launch_bounds__(kLanesPerBlock * kWarp)
    seed_sw(const SeedSwParams p) {
  const long long n = static_cast<long long>(blockIdx.x) * kLanesPerBlock +
                      threadIdx.x / kWarp;
  const int th = threadIdx.x % kWarp;
  if (n >= p.N) return;
  if (!p.need[n]) {
    if (th == 0) p.score[n] = 0;
    return;
  }
  const unsigned full = 0xFFFFFFFFu;
  Cols c;
  cols_init(c, p, n, th);
  const int tlen = tlen_of<R>(p, n);
  const long long rb = rb_of<R>(p, n);
  int32_t best = 0;
  int32_t hne[kCols];
  for (int i = 0; i < tlen; ++i) {
    const int32_t ti = text_code(p, rb + i);
    int32_t hleft = __shfl_up_sync(full, c.h[kCols - 1], 1);
    if (th == 0) hleft = 0;
    int32_t scan = row_open(c, p, th, ti, hleft, hne);
    for (int off = 1; off < kWarp; off <<= 1) {
      const int32_t v = __shfl_up_sync(full, scan, off);
      if (th >= off) scan = max_(scan, v);
    }
    int32_t carry = __shfl_up_sync(full, scan, 1);
    if (th == 0) carry = kScanFloor;
    best = max_(best, row_close(c, p, th, carry, hne));
  }
  for (int off = kWarp / 2; off > 0; off >>= 1)
    best = max_(best, __shfl_xor_sync(full, best, off));
  if (th == 0) p.score[n] = best;
}
#else
// the kernel's warp for lane n on the host: the 32 threads' columns in
// turn, with the exchanges the shuffles make
template <typename R>
void seed_sw_host_lane(const SeedSwParams& p, long long n) {
  if (!p.need[n]) {
    p.score[n] = 0;
    return;
  }
  Cols c[kWarp];
  for (int th = 0; th < kWarp; ++th) cols_init(c[th], p, n, th);
  const int tlen = tlen_of<R>(p, n);
  const long long rb = rb_of<R>(p, n);
  int32_t best = 0;
  int32_t hne[kWarp][kCols], open[kWarp], hleft[kWarp];
  for (int i = 0; i < tlen; ++i) {
    const int32_t ti = text_code(p, rb + i);
    for (int th = 0; th < kWarp; ++th)
      hleft[th] = th == 0 ? 0 : c[th - 1].h[kCols - 1];
    for (int th = 0; th < kWarp; ++th)
      open[th] = row_open(c[th], p, th, ti, hleft[th], hne[th]);
    int32_t carry = kScanFloor;
    for (int th = 0; th < kWarp; ++th) {
      best = max_(best, row_close(c[th], p, th, carry, hne[th]));
      carry = max_(carry, open[th]);
    }
  }
  p.score[n] = best;
}
#endif

bool refused(long long rank_bytes, long long N, long long S, long long W) {
  return (rank_bytes != 4 && rank_bytes != 8) || N < 1 || S < 1 || W < 1 ||
         N % S != 0;
}

}  // namespace


// seed_sw_launch (nvcc; on `stream`) or seed_sw_host (a host compiler;
// every lane in turn): 0, or a CUDA error code (kRefused for a refused
// shape)
extern "C" int LANE_ENTRY(seed_sw)(
    long long rank_bytes, const int32_t* codes, const int32_t* text,
    const int32_t* qb, const int32_t* qe, const void* rb, const void* re,
    const uint8_t* need, int32_t* score, long long n_words,
    long long seq_len, long long N, long long S, long long W, long long a,
    long long mis, long long o_del, long long e_del, long long o_ins,
    long long e_ins LANE_STREAM) {
  if (refused(rank_bytes, N, S, W)) return kRefused;
  const SeedSwParams p{codes, text, qb, qe, rb, re, need, score, n_words,
                       seq_len, N, S, W,
                       static_cast<int32_t>(a), static_cast<int32_t>(mis),
                       static_cast<int32_t>(o_del),
                       static_cast<int32_t>(e_del),
                       static_cast<int32_t>(o_ins),
                       static_cast<int32_t>(e_ins)};
#ifdef __CUDACC__
  const unsigned grid =
      static_cast<unsigned>((N + kLanesPerBlock - 1) / kLanesPerBlock);
  if (rank_bytes == 8)
    seed_sw<long long><<<grid, kLanesPerBlock * kWarp, 0, stream>>>(p);
  else
    seed_sw<int32_t><<<grid, kLanesPerBlock * kWarp, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
#else
  for (long long n = 0; n < N; ++n) {
    if (rank_bytes == 8)
      seed_sw_host_lane<long long>(p, n);
    else
      seed_sw_host_lane<int32_t>(p, n);
  }
  return 0;
#endif
}
