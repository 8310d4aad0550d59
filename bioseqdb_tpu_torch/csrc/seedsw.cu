// The long-read seed-SW filter for Hopper: every seed lane's windows, its
// need test, its best local affine-gap score against its reference window
// and the filter's two outputs, in one launch.
//
// Replaces the TPU program of bioseqdb_tpu/kernels/seedsw.py:99
// seed_sw_filter: the activation and window bounds (:122-160) and
// _local_sw_batch (:56, its 200-row fori_loop at :94). XLA compiled them
// into the one TPU device program; no Pallas. The kernel computes exactly
// what the plain version bioseqdb_tpu_torch/kernels/seedsw.py
// seed_sw_filter_plain computes (seed_sw_windows, seed_sw_scores_plain and
// the keep / score selects; equal to the JAX package and to cpu/oracle.py's
// local_sw_score), bit for bit.
//
// What bounds it: a needed lane reads its seed, its query window (up to
// 199 codes) and ~13 text words and writes two values; the DP needs qlen
// columns x tlen rows of a few integer operations a cell (a column past the
// query's end holds code 4 and cannot raise the best score). A batch of
// 4,096 reads of 1,500 bp needs ~4.3 x 10^9 such cells against ~0.05 ms of
// bytes, so the operations bound it.
//
// Design:
// - A block takes a span of the lanes: N split evenly over two blocks an
//   SM, at most kSpan (a batch of 18 kb reads holds ~25,000 lanes, which
//   spans of kSpan gave 25 blocks). Its threads compute the lanes' windows
//   (the activation and min_hsp from a table by read length, made on the
//   device by the plain version's own torch expression, so that no float
//   log runs here), the strand cut at l_pac and the shrink to the reference
//   holding mid (a binary search of ref_offsets: searchsorted(right) - 1,
//   clamped). A lane that needs no SW writes its outputs at once; the
//   needed ones are listed in shared memory, keyed by (qlen, tlen), and the
//   list is sorted (a bitonic network), so that the groups of a warp take
//   lanes of like size and the long ones are shared out first.
// - A group of kGroup threads takes a task: two lanes packed in the 16-bit
//   halves of each register (the s16x2 body), or one lane in 32 bits (the
//   s32 body, for scoring options whose values could pass 16 bits). The
//   warps take tasks from the list in turn (a shared
//   counter); a warp's four tasks set its row count and its columns a
//   thread (the smallest of kBuckets sizes that holds their widest query),
//   so a lane computes its query's columns, not all 200.
// - Thread t holds columns t*C .. t*C + C - 1: their H, E and query profile
//   in registers (s16x2: a word of four int8 scores a column and lane, one
//   for each text code, picked by one prmt a cell pair; s32: the codes).
//   Rows pass from thread to thread as a wavefront: thread t works row s - t
//   at step s and hands its last column's H and its F carry to thread t + 1
//   by two shuffles a step; no per-row scan. F follows the sequential
//   recurrence F[j] = max(F[j-1], hne[j-1] - oe_ins) - e_ins, F[0] = -2^28,
//   which gives the plain version's prefix-max values (its F[0] sentinel is
//   -16384 in 16 bits, still below every reachable value). The recurrences
//   are DPX operations (__viaddmax / __vimax3, s16x2 or s32).
// - The s16x2 body is exact where every intermediate value fits 16 bits: H
//   lies in [0, 200a], E >= -(o_del + e_del), F >= -(o_ins + 2 e_ins), and
//   the profile's int8 bytes hold a and -mis; the entry checks the scoring
//   (fits16) and takes the s32 body otherwise. The filter's target windows
//   lie in [0, seq_len), so its text codes are 0..3 (the s16x2 profile has
//   no N row).
// - The lane, group and block bodies build for the host too (LANE_HD /
//   GROUP_FN, lanes.cuh): compiled without nvcc, the file gives an entry
//   seed_sw_filter_host that runs every block in turn, a warp's groups and a group's threads one after another with the
//   exchanges the shuffles make, so the CPU tests hold them against the
//   plain version.
// - Ranks (rbeg, the window ends, the reference tables) take the template
//   type R (int32 or int64, the index's rank dtype); the window arithmetic
//   wraps in R as the tensors' does.

#include "lanes.cuh"

namespace {

constexpr int kWidth = 200;            // seedsw.py _W (MEM_SHORT_LEN)
constexpr int kShortExt = 50;          // seedsw.py MEM_SHORT_EXT
constexpr int kGroup = 8;              // threads a task
constexpr int kWarp = 32;
constexpr int kWarpGroups = kWarp / kGroup;
constexpr int kMaxCols = (kWidth + kGroup - 1) / kGroup;   // columns a thread
constexpr int kBuckets = 8;            // column counts a thread: kMaxCols*k/8
constexpr int kThreads = 256;          // a block
constexpr int kMinBlocks = 2;          // blocks an SM the registers allow
constexpr int kGroups = kThreads / kGroup;
constexpr int kSpan = 1024;            // a block's lanes at most
constexpr int kSpanUnit = 32;          // a block's span is a multiple
constexpr int kHostBlocks = 3;         // the host build's blocks
constexpr int kNeg = -(1 << 28);       // seedsw.py NEG: F[0] (s32 body)
constexpr uint32_t kNeg16 = 0xC000C000u;    // -16384 a half: F[0] (s16x2)
constexpr uint32_t kFloor16 = 0x80008000u;  // -32768 a half
constexpr int kRefused = 1;            // cudaErrorInvalidValue
static_assert(kGroup * kMaxCols >= kWidth, "a group covers the window");
static_assert(kSpan <= 65536 && kWidth < 256, "a key packs qlen, tlen, lane");

struct Params {
  const int32_t* codes;       // [B, W] read codes
  const int32_t* lens;        // [B] read lengths
  const int32_t* text;        // [n_words] packed doubled text
  // the seeds and the index's references
  const void* rbeg;           // [N] R
  const int32_t* qbeg;        // [N]
  const int32_t* slen;        // [N]
  const uint8_t* valid;       // [N] torch.bool
  const void* ref_offsets;    // [n_refs] R
  const void* ref_lens;       // [n_refs] R
  const int32_t* act;         // [W + 1, 2]: (active, min_hsp) by length
  uint8_t* valid_out;         // [N] out
  int32_t* score;             // [N] out
  long long n_words, seq_len, l_pac, n_refs, N, S, W;
  int32_t a, mis, o_del, e_del, o_ins, e_ins;
};

// a needed lane's window: query columns [qb, qb + qlen) of read lane / S,
// target [rb, rb + tlen), and the lane's min_hsp
struct Window {
  int32_t qb, qlen, tlen, min_hsp;
  long long rb;
};

template <typename T>
LANE_HD inline T clampv(T v, T lo, T hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// R arithmetic that wraps as the rank tensors' does
template <typename R>
LANE_HD inline R wrap(long long v) {
  return static_cast<R>(static_cast<unsigned long long>(v));
}

// the doubled text's code at t, 4 outside [0, seq_len) (extend.py
// window_doubled)
LANE_HD inline int32_t text_code(const Params& p, long long t) {
  return t < 0 || t >= p.seq_len ? 4 : packed_code(p.text, p.n_words, t);
}

// kernels/fm.py rid_of then clamped: the last reference whose offset is at
// most x (searchsorted(right=True) - 1), in [0, n_refs)
template <typename R>
LANE_HD inline long long ref_of(const Params& p, R x) {
  const R* offs = static_cast<const R*>(p.ref_offsets);
  long long lo = 0, hi = p.n_refs;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (offs[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return clampv<long long>(lo - 1, 0, p.n_refs - 1);
}

// seedsw.py seed_sw_windows for lane n: whether it needs the SW, and its
// window; slen the seed's length
template <typename R>
LANE_HD inline bool filter_window(const Params& p, long long n, Window& w,
                                  int32_t& slen) {
  const long long b = n / p.S;
  const int32_t L = p.lens[b];
  slen = p.slen[n];
  const int32_t qbeg = p.qbeg[n];
  const R rbeg = static_cast<const R*>(p.rbeg)[n];
  const long long li = clampv<long long>(L, 0, p.W);
  const bool active = p.act[2 * li] != 0;
  w.min_hsp = p.act[2 * li + 1];
  const int32_t qe0 = wrap<int32_t>(static_cast<long long>(qbeg) + slen);
  const int32_t qb = max_(wrap<int32_t>(qbeg - 50LL), 0);
  const int32_t qe = min_(wrap<int32_t>(qe0 + 50LL), L);
  const R re0 = wrap<R>(static_cast<long long>(rbeg) + slen);
  const R mid = static_cast<R>(wrap<R>(static_cast<long long>(rbeg) + re0)
                               >> 1);
  R rb = max_(wrap<R>(static_cast<long long>(rbeg) - kShortExt),
              static_cast<R>(0));
  R re = min_(wrap<R>(static_cast<long long>(re0) + kShortExt),
              static_cast<R>(p.seq_len));
  const bool crosses = rb < p.l_pac && p.l_pac < re;
  const bool fwd = mid < p.l_pac;
  if (crosses && fwd) re = static_cast<R>(p.l_pac);
  if (crosses && !fwd) rb = static_cast<R>(p.l_pac);
  // shrink to the reference holding mid, on its strand
  const R x = fwd ? mid : wrap<R>(p.seq_len - 1 - mid);
  const long long rid = ref_of<R>(p, x);
  const R off = static_cast<const R*>(p.ref_offsets)[rid];
  const R end = wrap<R>(static_cast<long long>(off) +
                        static_cast<const R*>(p.ref_lens)[rid]);
  if (fwd) {
    rb = max_(rb, off);
    re = min_(re, end);
  } else {
    rb = max_(rb, wrap<R>(p.seq_len - end));
    re = min_(re, wrap<R>(p.seq_len - off));
  }
  const int32_t qlen = wrap<int32_t>(static_cast<long long>(qe) - qb);
  const R tlen = wrap<R>(static_cast<long long>(re) - rb);
  w.qb = qb;
  w.qlen = qlen;
  w.tlen = static_cast<int32_t>(tlen);
  w.rb = static_cast<long long>(rb);
  return active && p.valid[n] && slen < kWidth && qlen < kWidth &&
         tlen < kWidth && re > rb && qe > qb;
}

// a lane's outputs: the filter's valid and score (seedsw.py _filter)
LANE_HD inline void put(const Params& p, long long n, bool needed,
                        int32_t score, int32_t min_hsp, int32_t slen) {
  p.valid_out[n] = needed ? score >= min_hsp : p.valid[n] != 0;
  p.score[n] = needed ? score
                      : wrap<int32_t>(static_cast<long long>(slen) * p.a);
}

// a block's phase 1 for lane l of its span: the lane's window; a lane that
// needs no SW gets its outputs, a needed one its key and window in the
// block's list (returns whether it was listed)
template <typename R>
LANE_HD inline bool list_lane(const Params& p, long long n0, int l,
                              uint32_t* key, int32_t* qbs, int32_t* hsps,
                              long long* rbs) {
  const long long n = n0 + l;
  Window w;
  int32_t slen = 0;
  if (!filter_window<R>(p, n, w, slen)) {
    put(p, n, false, 0, 0, slen);
    return false;
  }
  *key = (static_cast<uint32_t>(w.qlen) << 24) |
         (static_cast<uint32_t>(w.tlen) << 16) | static_cast<uint32_t>(l);
  qbs[l] = w.qb;
  hsps[l] = w.min_hsp;
  rbs[l] = w.rb;
  return true;
}

// the lanes a block takes of N, `blocks` blocks wanted: N split evenly,
// in multiples of kSpanUnit, at most kSpan (the shared list's size), so
// that a call with few lanes (a batch of 18 kb reads holds ~25,000) still
// spreads over the card
LANE_HD inline long long block_span(long long N, long long blocks) {
  const long long per = (N + blocks - 1) / blocks;
  return min_<long long>(kSpan, (per + kSpanUnit - 1) / kSpanUnit *
                                    kSpanUnit);
}

// one compare-exchange of a descending bitonic sort of n (a power of 2)
// keys: pair i of the stage (size, stride)
LANE_HD inline void bitonic_step(uint32_t* keys, int size, int stride,
                                 int i) {
  const int lo = 2 * i - (i & (stride - 1));
  const int hi = lo + stride;
  const bool desc = (lo & size) == 0;
  const uint32_t x = keys[lo], y = keys[hi];
  if ((x < y) == desc) {
    keys[lo] = y;
    keys[hi] = x;
  }
}

LANE_HD inline int pow2_at_least(int m) {
  int n = 2;
  while (n < m) n <<= 1;
  return n;
}

// ---- the two bodies: a task's columns, its row and its scores ----

// one pair of 16-bit halves: the prmt of the profile and the s16x2 DPX
// forms (their host stand-ins per half)
#ifdef __CUDACC__
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}
__device__ __forceinline__ uint32_t addmax16(uint32_t a, uint32_t b,
                                             uint32_t c) {
  return __viaddmax_s16x2(a, b, c);
}
__device__ __forceinline__ uint32_t addmax16_relu(uint32_t a, uint32_t b,
                                                  uint32_t c) {
  return __viaddmax_s16x2_relu(a, b, c);
}
__device__ __forceinline__ uint32_t max16_relu(uint32_t a, uint32_t b) {
  return __vimax_s16x2_relu(a, b);
}
__device__ __forceinline__ uint32_t max3_16(uint32_t a, uint32_t b,
                                            uint32_t c) {
  return __vimax3_s16x2(a, b, c);
}
__device__ __forceinline__ int32_t addmax32(int32_t a, int32_t b,
                                            int32_t c) {
  return __viaddmax_s32(a, b, c);
}
__device__ __forceinline__ int32_t addmax32_relu(int32_t a, int32_t b,
                                                 int32_t c) {
  return __viaddmax_s32_relu(a, b, c);
}
#else
// the PTX prmt.b32 default mode: byte k of the result is byte (sel >> 4k)
// & 7 of {b, a}, or that byte's sign bit replicated where (sel >> 4k) & 8
inline uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  const uint64_t src = (static_cast<uint64_t>(b) << 32) | a;
  uint32_t d = 0;
  for (int k = 0; k < 4; ++k) {
    const uint32_t s = (sel >> (4 * k)) & 15u;
    uint32_t byte = static_cast<uint32_t>(src >> (8 * (s & 7))) & 0xFFu;
    if (s & 8) byte = (byte & 0x80u) ? 0xFFu : 0u;
    d |= byte << (8 * k);
  }
  return d;
}
inline int32_t half(uint32_t v, int k) {
  return static_cast<int16_t>(static_cast<uint16_t>(v >> (16 * k)));
}
inline uint32_t pack(int32_t lo, int32_t hi) {
  return static_cast<uint32_t>(static_cast<uint16_t>(lo)) |
         (static_cast<uint32_t>(static_cast<uint16_t>(hi)) << 16);
}
inline uint32_t addmax16(uint32_t a, uint32_t b, uint32_t c) {
  int32_t r[2];
  for (int k = 0; k < 2; ++k)
    r[k] = max_<int32_t>(static_cast<int16_t>(half(a, k) + half(b, k)),
                         half(c, k));
  return pack(r[0], r[1]);
}
inline uint32_t addmax16_relu(uint32_t a, uint32_t b, uint32_t c) {
  const uint32_t m = addmax16(a, b, c);
  return pack(max_(half(m, 0), 0), max_(half(m, 1), 0));
}
inline uint32_t max16_relu(uint32_t a, uint32_t b) {
  return pack(max_(max_(half(a, 0), half(b, 0)), 0),
              max_(max_(half(a, 1), half(b, 1)), 0));
}
inline uint32_t max3_16(uint32_t a, uint32_t b, uint32_t c) {
  return pack(max_(max_(half(a, 0), half(b, 0)), half(c, 0)),
              max_(max_(half(a, 1), half(b, 1)), half(c, 1)));
}
inline int32_t addmax32(int32_t a, int32_t b, int32_t c) {
  return max_(a + b, c);
}
inline int32_t addmax32_relu(int32_t a, int32_t b, int32_t c) {
  return max_(max_(a + b, c), 0);
}
#endif

// a task: its lanes (one for the s32 body, up to two for s16x2; lane k
// absent where tlen[k] is 0), their windows, and its rows
struct Task {
  long long n[2], rb[2];
  int32_t qb[2], qlen[2], tlen[2], min_hsp[2];
  int rows, qmax;
};

// the query code of column j of task lane k (4 past its window or the
// read's width)
LANE_HD inline int32_t query_code(const Params& p, const Task& tk, int k,
                                  int j) {
  if (j >= tk.qlen[k]) return 4;
  const long long col = static_cast<long long>(tk.qb[k]) + j;
  return col < p.W ? p.codes[(tk.n[k] / p.S) * p.W + col] : 4;
}

// the s16x2 body: a task's two lanes in the halves of each word
struct Body16 {
  using T = uint32_t;
  static constexpr int kLanes = 2;
  static constexpr bool kBucketed = true;   // columns a thread by the warp
  static constexpr T kSentinel = kNeg16;
  template <int C>
  struct Cols {
    uint32_t pa[C], pb[C], h[C], e[C];
  };
  // the scores, splatted over both halves
  struct Scores {
    uint32_t ne_del, noe_del, ne_ins, noe_ins_e;
    uint32_t mis_bytes, a;
  };
  static LANE_HD Scores scores(const Params& p) {
    const auto splat = [](int32_t v) {
      return static_cast<uint32_t>(static_cast<uint16_t>(v)) * 0x10001u;
    };
    return Scores{splat(-p.e_del), splat(-(p.o_del + p.e_del)),
                  splat(-p.e_ins), splat(-(p.o_ins + 2 * p.e_ins)),
                  static_cast<uint32_t>(static_cast<uint8_t>(-p.mis)) *
                      0x01010101u,
                  static_cast<uint32_t>(p.a)};
  }
  // a column's profile: byte c the score of text code c against query code
  // q (all -1 for q 4)
  static LANE_HD uint32_t profile(const Scores& s, int32_t q) {
    if (q >= 4) return 0xFFFFFFFFu;
    const int sh = 8 * q;
    return (s.mis_bytes & ~(0xFFu << sh)) | (s.a << sh);
  }
  template <int C>
  static LANE_HD void init(Cols<C>& c, const Params& p, const Scores& s,
                           const Task& tk, int t) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = C * t + k;
      c.pa[k] = profile(s, query_code(p, tk, 0, j));
      c.pb[k] = profile(s, query_code(p, tk, 1, j));
      c.h[k] = c.e[k] = 0;
    }
  }
  // row i's prmt selector: lane 0's text code into the low half, lane 1's
  // into the high one, each sign-extended
  static LANE_HD uint32_t code(const Params& p, const Task& tk, int k,
                               int i) {
    const int32_t c = i < tk.tlen[k] ? text_code(p, tk.rb[k] + i) : 0;
    return c < 4 ? static_cast<uint32_t>(c) : 0u;   // never 4: see above
  }
  static LANE_HD uint16_t row_key(const Params& p, const Task& tk, int i) {
    const uint32_t t0 = code(p, tk, 0, i), t1 = code(p, tk, 1, i);
    return static_cast<uint16_t>(t0 | ((8u + t0) << 4) | ((4u + t1) << 8) |
                                 ((12u + t1) << 12));
  }
  // a row on the thread's columns: f the F carried in (out: carried on),
  // hdiag the last row's H left of the first column; returns the row's max
  // of H
  template <int C>
  static GROUP_FN uint32_t row(Cols<C>& c, const Scores& s, uint16_t key,
                              uint32_t& f, uint32_t hdiag) {
    uint32_t rmax = 0;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const uint32_t sc = prmt(c.pa[k], c.pb[k], key);
      const uint32_t hp = c.h[k];
      c.e[k] = addmax16(c.e[k], s.ne_del, addmax16(hp, s.noe_del, kFloor16));
      const uint32_t hne = addmax16_relu(hdiag, sc, c.e[k]);
      hdiag = hp;
      const uint32_t h = max16_relu(hne, f);
      f = addmax16(f, s.ne_ins, addmax16(hne, s.noe_ins_e, kFloor16));
      c.h[k] = h;
      rmax = (k & 1) ? max3_16(rmax, c.h[k - 1], h) : rmax;
    }
    return (C & 1) ? max3_16(rmax, c.h[C - 1], 0u) : rmax;
  }
  // the best so far with row i's maxima, the halves past their lane's rows
  // masked out
  static GROUP_FN uint32_t fold(const Task& tk, int i, uint32_t best,
                               uint32_t rmax) {
    const uint32_t m = (i < tk.tlen[0] ? 0xFFFFu : 0u) |
                       (i < tk.tlen[1] ? 0xFFFF0000u : 0u);
    return max3_16(best, rmax & m, 0u);
  }
  static LANE_HD int32_t lane_score(uint32_t best, int k) {
    return static_cast<int16_t>(static_cast<uint16_t>(best >> (16 * k)));
  }
  static GROUP_FN uint32_t best_of(uint32_t a, uint32_t b) {
    return max3_16(a, b, 0u);
  }
};

// the s32 body: one lane, the plain version's int32 values
struct Body32 {
  using T = int32_t;
  static constexpr int kLanes = 1;
  static constexpr bool kBucketed = false;  // kMaxCols columns a thread
  static constexpr T kSentinel = kNeg;
  template <int C>
  struct Cols {
    int32_t q[C], h[C], e[C];
  };
  struct Scores {
    int32_t a, mis, e_del, oe_del, e_ins, oe_ins_e;
  };
  static LANE_HD Scores scores(const Params& p) {
    return Scores{p.a, p.mis, p.e_del, p.o_del + p.e_del, p.e_ins,
                  p.o_ins + 2 * p.e_ins};
  }
  template <int C>
  static LANE_HD void init(Cols<C>& c, const Params& p, const Scores&,
                           const Task& tk, int t) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      c.q[k] = query_code(p, tk, 0, C * t + k);
      c.h[k] = c.e[k] = 0;
    }
  }
  static LANE_HD uint16_t row_key(const Params& p, const Task& tk, int i) {
    return static_cast<uint16_t>(text_code(p, tk.rb[0] + i));
  }
  template <int C>
  static GROUP_FN int32_t row(Cols<C>& c, const Scores& s, uint16_t key,
                             int32_t& f, int32_t hdiag) {
    const int32_t ti = key;
    const int32_t sa = ti < 4 ? s.a : -1, sm = ti < 4 ? -s.mis : -1;
    int32_t rmax = 0;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int32_t q = c.q[k];
      const int32_t sc = q == ti ? sa : (q < 4 ? sm : -1);
      const int32_t hp = c.h[k];
      c.e[k] = addmax32(c.e[k], -s.e_del, hp - s.oe_del);
      const int32_t hne = addmax32_relu(hdiag, sc, c.e[k]);
      hdiag = hp;
      const int32_t h = max_(hne, f);
      f = addmax32(f, -s.e_ins, hne - s.oe_ins_e);
      c.h[k] = h;
      rmax = max_(rmax, h);
    }
    return rmax;
  }
  static GROUP_FN int32_t fold(const Task&, int, int32_t best,
                              int32_t rmax) {
    return max_(best, rmax);
  }
  static LANE_HD int32_t lane_score(int32_t best, int) { return best; }
  static GROUP_FN int32_t best_of(int32_t a, int32_t b) { return max_(a, b); }
};

// the columns a thread of bucket b computes
LANE_HD constexpr int bucket_cols(int b) {
  return (kMaxCols * (b + 1) + kBuckets - 1) / kBuckets;
}

// the smallest bucket whose threads cover qmax columns
LANE_HD inline int bucket_of(int qmax) {
  int b = 0;
  while (b + 1 < kBuckets && bucket_cols(b) * kGroup < qmax) ++b;
  return b;
}

// task k of a block's sorted list of m keys, for body K
template <class K>
LANE_HD inline Task task_of(const uint32_t* keys, int m, int k,
                            long long n0, const int32_t* qbs,
                            const int32_t* hsps, const long long* rbs) {
  Task tk{};
  for (int h = 0; h < K::kLanes; ++h) {
    const int e = K::kLanes * k + h;
    if (e >= m) continue;   // tlen 0: an absent lane
    const uint32_t key = keys[e];
    const int l = static_cast<int>(key & 0xFFFFu);
    tk.n[h] = n0 + l;
    tk.rb[h] = rbs[l];
    tk.qb[h] = qbs[l];
    tk.min_hsp[h] = hsps[l];
    tk.qlen[h] = static_cast<int32_t>(key >> 24);
    tk.tlen[h] = static_cast<int32_t>((key >> 16) & 0xFFu);
    tk.rows = max_(tk.rows, tk.tlen[h]);
    tk.qmax = max_(tk.qmax, tk.qlen[h]);
  }
  return tk;
}

// a group's task over `steps` wavefront steps (the warp's), C columns a
// thread; rowkey: the task's rows' keys (shared memory); returns the
// group's best (each half or the word), the same on every thread
template <class K, int C>
GROUP_FN typename K::T sw_task(const Params& p, const Task& tk, int steps,
                               const uint16_t* rowkey) {
  using T = typename K::T;
  const typename K::Scores s = K::scores(p);
  Lanes<typename K::template Cols<C>, kGroup> cols;
  Lanes<T, kGroup> fout, hout, hdiag, best;
  FOR_LANES(kGroup, t) {
    K::template init<C>(cols[t], p, s, tk, t);
    fout[t] = hout[t] = hdiag[t] = best[t] = 0;
  }
  for (int st = 0; st < steps; ++st) {
    const Lanes<T, kGroup> fin = shfl_up<kGroup>(fout, 1);
    const Lanes<T, kGroup> hin = shfl_up<kGroup>(hout, 1);
    FOR_LANES(kGroup, t) {
      const int i = st - t;
      if (i >= 0 && i < tk.rows) {
        T f = t == 0 ? T(K::kSentinel) : T(fin[t]);
        const T rmax = K::template row<C>(cols[t], s, rowkey[i], f,
                                          t == 0 ? T(0) : hdiag[t]);
        best[t] = K::fold(tk, i, best[t], rmax);
        fout[t] = f;
        hout[t] = cols[t].h[C - 1];
      }
      hdiag[t] = hin[t];
    }
  }
  for (int o = kGroup / 2; o > 0; o >>= 1) {
    const Lanes<T, kGroup> other = shfl_xor<kGroup>(best, o);
    FOR_LANES(kGroup, t) best[t] = K::best_of(best[t], other[t]);
  }
  return shfl<kGroup>(best, 0);
}

// the task's best at bucket b's columns a thread
template <class K, int B = 0>
GROUP_FN typename K::T sw_bucket(int b, const Params& p, const Task& tk,
                                 int steps, const uint16_t* rowkey) {
  if constexpr (B + 1 < kBuckets) {
    if (b != B) return sw_bucket<K, B + 1>(b, p, tk, steps, rowkey);
  }
  return sw_task<K, bucket_cols(B)>(p, tk, steps, rowkey);
}

// a group's task: its rows' keys, the SW, the lanes' outputs
template <class K>
GROUP_FN void run_task(const Params& p, const Task& tk, int steps,
                       int bucket, uint16_t* rowkey) {
  FOR_LANES(kGroup, t) {
    for (int i = t; i < tk.rows; i += kGroup) rowkey[i] = K::row_key(p, tk, i);
  }
  group_sync<kGroup>();
  typename K::T best;
  if constexpr (K::kBucketed)
    best = sw_bucket<K>(bucket, p, tk, steps, rowkey);
  else
    best = sw_task<K, kMaxCols>(p, tk, steps, rowkey);
  if (group_leader<kGroup>()) {
    for (int h = 0; h < K::kLanes; ++h)
      if (tk.tlen[h] > 0)
        put(p, tk.n[h], true, K::lane_score(best, h), tk.min_hsp[h], 0);
  }
  group_sync<kGroup>();   // the row keys read before the next task's
}

// the wavefront's steps of a warp whose tasks' most rows are `rows`
LANE_HD inline int steps_of(int rows) {
  return rows > 0 ? rows + kGroup - 1 : 0;
}

#ifdef __CUDACC__
template <class K, typename R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    seed_sw(const Params p, long long span_lanes) {
  __shared__ uint32_t keys[kSpan];
  __shared__ int32_t qbs[kSpan], hsps[kSpan];
  __shared__ long long rbs[kSpan];
  __shared__ uint16_t rowkeys[kGroups][kWidth];
  __shared__ int count, next;
  const long long n0 = static_cast<long long>(blockIdx.x) * span_lanes;
  const int span = static_cast<int>(min_<long long>(span_lanes, p.N - n0));
  if (threadIdx.x == 0) {
    count = 0;
    next = 0;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < span; l += kThreads) {
    uint32_t key;
    if (list_lane<R>(p, n0, l, &key, qbs, hsps, rbs))
      keys[atomicAdd(&count, 1)] = key;
  }
  __syncthreads();
  const int m = count;
  if (m == 0) return;
  const int n = pow2_at_least(m);
  for (int i = m + threadIdx.x; i < n; i += kThreads) keys[i] = 0;
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += kThreads)
        bitonic_step(keys, size, stride, i);
      __syncthreads();
    }
  const int tasks = (m + K::kLanes - 1) / K::kLanes;
  const int lane = threadIdx.x % kWarp;
  const int g = static_cast<int>(threadIdx.x) / kGroup;
  const unsigned full = 0xFFFFFFFFu;
  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(&next, kWarpGroups);
    base = __shfl_sync(full, base, 0);
    if (base >= tasks) break;
    const Task tk = task_of<K>(keys, m, base + lane / kGroup, n0, qbs, hsps,
                               rbs);
    const int rows = static_cast<int>(__reduce_max_sync(
        full, static_cast<unsigned>(tk.rows)));
    const int qmax = static_cast<int>(__reduce_max_sync(
        full, static_cast<unsigned>(tk.qmax)));
    run_task<K>(p, tk, steps_of(rows), bucket_of(qmax), rowkeys[g]);
  }
}
#else
// block blk on the host: phase 1 lane by lane, the same sort, then the
// tasks four (a warp's) at a time, a warp's groups in turn
template <class K, typename R>
void seed_sw_block(const Params& p, long long blk, long long span_lanes) {
  static uint32_t keys[kSpan];
  static int32_t qbs[kSpan], hsps[kSpan];
  static long long rbs[kSpan];
  static uint16_t rowkey[kWidth];
  const long long n0 = blk * span_lanes;
  const int span = static_cast<int>(min_<long long>(span_lanes, p.N - n0));
  int m = 0;
  for (int l = 0; l < span; ++l) {
    uint32_t key;
    if (list_lane<R>(p, n0, l, &key, qbs, hsps, rbs)) keys[m++] = key;
  }
  if (m == 0) return;
  const int n = pow2_at_least(m);
  for (int i = m; i < n; ++i) keys[i] = 0;
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      for (int i = 0; i < n / 2; ++i) bitonic_step(keys, size, stride, i);
  const int tasks = (m + K::kLanes - 1) / K::kLanes;
  for (int base = 0; base < tasks; base += kWarpGroups) {
    Task tk[kWarpGroups];
    int rows = 0, qmax = 0;
    for (int g = 0; g < kWarpGroups; ++g) {
      tk[g] = task_of<K>(keys, m, base + g, n0, qbs, hsps, rbs);
      rows = max_(rows, tk[g].rows);
      qmax = max_(qmax, tk[g].qmax);
    }
    for (int g = 0; g < kWarpGroups; ++g)
      run_task<K>(p, tk[g], steps_of(rows), bucket_of(qmax), rowkey);
  }
}
#endif

// whether the scoring's values fit the s16x2 body (see the design note)
inline bool fits16(const Params& p) {
  return p.a >= 0 && p.a <= 127 && p.mis >= 0 && p.mis <= 128 &&
         p.o_del >= 0 && p.e_del >= 0 && p.o_ins >= 0 && p.e_ins >= 0 &&
         p.o_del + 2 * p.e_del <= 16384 && p.o_ins + 3 * p.e_ins <= 16384;
}

template <class K>
int run(const Params& p, long long rank_bytes LANE_STREAM) {
#ifdef __CUDACC__
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    sms = 1;
  const long long span = block_span(p.N, static_cast<long long>(sms) *
                                             kMinBlocks);
  const unsigned grid = static_cast<unsigned>((p.N + span - 1) / span);
  if (rank_bytes == 8)
    seed_sw<K, long long><<<grid, kThreads, 0, stream>>>(p, span);
  else
    seed_sw<K, int32_t><<<grid, kThreads, 0, stream>>>(p, span);
  return static_cast<int>(cudaGetLastError());
#else
  const long long span = block_span(p.N, kHostBlocks);
  for (long long blk = 0; blk * span < p.N; ++blk) {
    if (rank_bytes == 8)
      seed_sw_block<K, long long>(p, blk, span);
    else
      seed_sw_block<K, int32_t>(p, blk, span);
  }
  return 0;
#endif
}

}  // namespace

// seed_sw_filter_launch (nvcc; on `stream`) or seed_sw_filter_host (a host
// compiler; every block in turn): seedsw.py _filter's valid and score of
// the N = B * S seed lanes, by the s16x2 body where the scoring fits it,
// else the s32 body. 0, or a CUDA error code (kRefused for a refused
// shape)
extern "C" int LANE_ENTRY(seed_sw_filter)(
    long long rank_bytes, const int32_t* codes, const int32_t* lens,
    const int32_t* text, const void* rbeg, const int32_t* qbeg,
    const int32_t* slen, const uint8_t* valid, const void* ref_offsets,
    const void* ref_lens, const int32_t* act, uint8_t* valid_out,
    int32_t* score, long long n_words, long long seq_len, long long l_pac,
    long long n_refs, long long N, long long S, long long W, long long a,
    long long mis, long long o_del, long long e_del, long long o_ins,
    long long e_ins LANE_STREAM) {
  if ((rank_bytes != 4 && rank_bytes != 8) || N < 1 || S < 1 || W < 1 ||
      N % S != 0 || n_refs < 1)
    return kRefused;
  const Params p{codes, lens, text, rbeg, qbeg, slen, valid, ref_offsets,
                 ref_lens, act, valid_out, score, n_words, seq_len, l_pac,
                 n_refs, N, S, W, static_cast<int32_t>(a),
                 static_cast<int32_t>(mis), static_cast<int32_t>(o_del),
                 static_cast<int32_t>(e_del), static_cast<int32_t>(o_ins),
                 static_cast<int32_t>(e_ins)};
#ifdef __CUDACC__
  return fits16(p) ? run<Body16>(p, rank_bytes, stream)
                   : run<Body32>(p, rank_bytes, stream);
#else
  return fits16(p) ? run<Body16>(p, rank_bytes) : run<Body32>(p, rank_bytes);
#endif
}
