// The extension stage's device loops for Hopper: every trip of a round's
// containment scan, its SW windows, the fold of its SW results into the
// region table, and the seedcov epilogue, each one launch.
//
// Replaces the TPU program around the one Pallas kernel of
// bioseqdb_tpu/kernels/extend.py extend_all (:155): the containment scan
// (containment_scan :280-346, a chunked_while at :341), the rounds'
// fori_loop (:543) with its window fetch and region merge
// (_extend_round :444-541; lax.cond at :405 and :439) and seedcov's
// fori_loop (cov_body :552-567). XLA compiled those loops into the one
// device program; the Pallas kernel inside, the banded SW (sw_pallas.py
// :258), is csrc/sw_extend.cu, launched between these kernels. Each
// kernel computes exactly what its plain twin in
// bioseqdb_tpu_torch/kernels/extend.py computes (extend_scan_plain,
// extend_windows_plain, extend_merge_plain, extend_seedcov_plain), which
// equal the JAX package, not bwa's C.
//
// What bounds them: each reads a read's seed slots, its region table and
// (windows) its read codes and a window of the packed text once, and
// writes its outputs once; the work between is a few dozen integer
// compares a seed the scan passes, R regions a seed for seedcov. So the
// card's memory rate bounds them, and the windows kernel, which writes
// two [B, W] and two [B, W + 4 * band + 64] int32 buffers (the SW
// kernel's interface), moves the most. The scan and seedcov are a thread
// a read walking a chain of dependent trips, latency bound as chain.cu's
// loops are.
//
// Design:
// - extend_scan, extend_merge (two entries, after the left and after the
//   right SW) and extend_seedcov: one thread a read, 128 a block. Reads
//   are independent (the plain twins act on each read's row alone), so a
//   lane runs its read's trips in order with no synchronisation. The
//   scan keeps the read's live regions (at most kMaxRegs, the wrapper
//   refuses more) in local arrays and streams the seed slots from device
//   memory, so S and C are unbounded. It loops until its own lane is
//   decided: the host no longer checks every 8 trips whether all are.
// - extend_windows: a warp a row of the sorted SW order (perm, from a
//   library argsort of the scan's work keys), both sides in one launch;
//   the warp's threads write consecutive columns, the target codes read
//   from the packed doubled text (16 bases a 32-bit word, the first base
//   in the high bits). It writes the inverse permutation, through which
//   the merge kernels read the sorted SW results.
// - Ranks and reference positions take the template type R (int32 or
//   int64, the index's rank dtype); query positions, lengths and scores
//   int32, as in the plain twins. Every sum and difference wraps in its
//   operands' type, as the tensors' do. Window positions are int64 (a
//   rank plus an int64 column index, as in torch).
// - cal_max_gap is float32 as torch computes it: the integer difference
//   rounded to float32 once, one true division, one addition, then
//   truncation to int32 (saturating, as the card converts).
// - The lane bodies are __host__ __device__ functions. Compiled without
//   nvcc (g++ -x c++), the file gives host entry points that run the
//   same bodies over every read (and every window row), so the lane logic
//   can be held against the plain twins on a machine without a card.
// - Each entry takes its arguments as one array of 64-bit integers
//   (pointers, then sizes and options, in the order kernels/extend_cuda.py
//   documents) and refuses a count that differs.

#include "lanes.cuh"

namespace {

constexpr int kThreads = 128;   // a block: one read a thread (windows: 4 rows)
constexpr int kWarp = 32;
constexpr int kMaxRegs = 16;    // regions a read (the wrapper raises above)
constexpr int kNoCode = 4;      // the code past a buffer's length
constexpr int kRefused = 1;     // cudaErrorInvalidValue
constexpr int kFields = 6;      // an SW result (sw.FIELDS), max_off last


// sums, differences and products that wrap in the operands' type, as
// torch's int32 and int64 tensors do (signed overflow is undefined in C++)
LANE_HD inline int32_t wrap32(long long v) {
  return static_cast<int32_t>(static_cast<uint32_t>(v));
}
LANE_HD inline int32_t add_(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
LANE_HD inline int32_t sub_(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}
LANE_HD inline int32_t mul_(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}
LANE_HD inline long long add_(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}
LANE_HD inline long long sub_(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) -
                                static_cast<unsigned long long>(b));
}
LANE_HD inline long long mul_(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) *
                                static_cast<unsigned long long>(b));
}

// torch's // on int32: the quotient rounded toward minus infinity
LANE_HD inline int32_t floordiv(int32_t a, int32_t d) {
  const int32_t q = a / d;
  return (a % d != 0 && ((a < 0) != (d < 0))) ? q - 1 : q;
}

// float32 steps rounded once each (no contraction), as torch computes them
LANE_HD inline float to_f32(int32_t v) {
#ifdef __CUDA_ARCH__
  return __int2float_rn(v);
#else
  return static_cast<float>(v);
#endif
}
LANE_HD inline float to_f32(long long v) {
#ifdef __CUDA_ARCH__
  return __ll2float_rn(v);
#else
  return static_cast<float>(v);
#endif
}
LANE_HD inline float div_f32(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}
LANE_HD inline float add_f32(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
// float32 -> int32 toward zero, saturating as the card converts (the host
// build spells it out: a C++ cast out of range is undefined)
LANE_HD inline int32_t f2i(float v) {
#ifdef __CUDA_ARCH__
  return __float2int_rz(v);
#else
  if (v != v) return 0;
  if (v <= -2147483648.0f) return INT32_MIN;
  if (v >= 2147483648.0f) return INT32_MAX;
  return static_cast<int32_t>(v);
#endif
}

struct Opts {
  int32_t match, o_del, e_del, o_ins, e_ins, bandwidth;
};

// bwa's cal_max_gap (extend.py cal_max_gap) on x in its type T
template <typename T>
LANE_HD int32_t max_gap(T x, const Opts& o) {
  const T m = mul_(x, static_cast<T>(o.match));
  const int32_t l_del = f2i(add_f32(
      div_f32(to_f32(sub_(m, static_cast<T>(o.o_del))),
              static_cast<float>(o.e_del)), 1.0f));
  const int32_t l_ins = f2i(add_f32(
      div_f32(to_f32(sub_(m, static_cast<T>(o.o_ins))),
              static_cast<float>(o.e_ins)), 1.0f));
  return min_(max_(max_(l_del, l_ins), 1), o.bandwidth * 2);
}

// the seed tables every kernel reads ([B, S] row-major; rbeg in R)
struct Seeds {
  const void* rbeg;
  const int32_t* qbeg;
  const int32_t* len;
  const int32_t* cis;      // the seed's chain, clamped into [0, C)
};

struct ScanParams {
  const int32_t* order;    // [B, S] the processing order of the slots
  const int32_t* n_usable; // [B]
  Seeds sd;
  const uint8_t* valid;    // [B, S] torch.bool
  const int32_t* lens;     // [B]
  const void* rmax0;       // [B, C] R
  const void* rmax1;       // [B, C] R
  const void* rb;          // [B, Rg] R: the region table
  const void* re;
  const int32_t* qb;
  const int32_t* qe;
  const int32_t* w;
  const int32_t* seedlen0;
  const int32_t* n_regs;   // [B]
  const uint8_t* was_ext;  // [B, S]
  const int32_t* cursor;   // [B]
  const uint8_t* overflow; // [B]
  int32_t* cursor_out;     // [B] out
  uint8_t* overflow_out;   // [B] out
  int32_t* slot;           // [B] out
  uint8_t* act;            // [B] out
  int32_t* work;           // [2, B] out
  long long B, S, C, Rg;
  Opts o;
};

struct WinParams {
  const long long* perm;   // [2, B] sorted row -> lane
  const int32_t* slot;     // [B]
  const uint8_t* act;      // [B]
  Seeds sd;
  const int32_t* lens;     // [B]
  const void* rmax0;       // [B, C] R
  const void* rmax1;
  const int32_t* codes;    // [B, W]
  const int32_t* pac;      // [n_words] the packed doubled text
  int32_t* qbuf;           // [2, B, W] out
  int32_t* tbuf;           // [2, B, T] out
  int32_t* qn;             // [2, B] out
  int32_t* tn;             // [2, B] out
  uint8_t* active;         // [2, B] out
  int32_t* h0;             // [B] out: the left side's, sorted
  int32_t* inv;            // [2, B] out: lane -> sorted row
  long long B, S, C, W, T, n_words, seq_len;
  int32_t match;
};

struct MergeParams {
  const int32_t* inv;      // [2, B]
  const uint8_t* retry;    // [B] sorted: the side's band-doubling retries
  const int32_t* r1[kFields];  // [B] sorted each: the first SW's results
  const int32_t* r2[kFields];  // and the retry's (r1 where none retried)
  const int32_t* slot;     // [B]
  const uint8_t* act;      // [B]
  Seeds sd;
  const int32_t* lens;     // [B]
  // the left merge's outputs: the right merge reads them
  int32_t* l_qb;           // [B]
  void* l_rb;              // [B] R
  int32_t* l_score;        // [B]
  int32_t* l_truesc;       // [B]
  int32_t* l_aw;           // [B]
  int32_t* h0;             // [B] out (left): the right side's h0, sorted
  // the right merge: the state in and out
  const int32_t* crid;     // [B, C]
  const void* regs[10];    // [B, Rg] each, in REG_FIELDS order
  const int32_t* n_regs;   // [B]
  const uint8_t* was_ext;  // [B, S]
  const int32_t* cursor;   // [B]
  void* regs_out[10];
  int32_t* n_regs_out;
  uint8_t* was_ext_out;
  int32_t* cursor_out;
  long long B, S, C, Rg;
  int32_t match, bandwidth, pen_clip;
};

struct CovParams {
  Seeds sd;
  const uint8_t* ok;       // [B, S] valid and in a chain
  const void* rb;          // [B, Rg] R
  const void* re;
  const int32_t* qb;
  const int32_t* qe;
  const int32_t* cchain;
  int32_t* seedcov;        // [B, Rg] out
  long long B, S, Rg;
};

// the seed at slot s of read b: its query start, length, chain and
// reference start
template <typename R>
struct Seed {
  int32_t q, l, c;
  R r;
  LANE_HD Seed(const Seeds& sd, long long at)
      : q(sd.qbeg[at]), l(sd.len[at]), c(sd.cis[at]),
        r(static_cast<const R*>(sd.rbeg)[at]) {}
};

// is the seed covered by one of the read's regions (near one of its ends,
// within the band the gap allows)?
template <typename R>
LANE_HD bool covered(const Seed<R>& s, int live, const R* rb, const R* re,
                    const int32_t* qb, const int32_t* qe, const int32_t* w,
                    const int32_t* sl0, int32_t lim, const Opts& o) {
  const int32_t qend = add_(s.q, s.l);
  const R rend = add_(s.r, static_cast<R>(s.l));
  for (int r = 0; r < live; ++r) {
    if (!(s.r >= rb[r] && rend <= re[r] && s.q >= qb[r] && qend <= qe[r] &&
          sub_(s.l, sl0[r]) <= lim))
      continue;
    const R qd = static_cast<R>(sub_(s.q, qb[r]));
    const R rd = sub_(s.r, rb[r]);
    const R wlim = static_cast<R>(min_(max_gap<R>(min_(qd, rd), o), w[r]));
    if (sub_(qd, rd) < wlim && sub_(rd, qd) < wlim) return true;
    const R qd2 = static_cast<R>(sub_(qe[r], qend));
    const R rd2 = sub_(re[r], rend);
    const R wlim2 = static_cast<R>(min_(max_gap<R>(min_(qd2, rd2), o), w[r]));
    if (sub_(qd2, rd2) < wlim2 && sub_(rd2, qd2) < wlim2) return true;
  }
  return false;
}

// the overlap rescue: an extended seed of the same chain, of similar
// length, overlapping it on another diagonal
template <typename R>
LANE_HD bool rescued(const Seed<R>& s, const Seeds& sd, const uint8_t* valid,
                    const uint8_t* was_ext, long long row, long long S) {
  const int32_t quarter = s.l >> 2;
  const int32_t sim = floordiv(add_(mul_(s.l, 19), 19), 20);
  for (long long t = 0; t < S; ++t) {
    if (!was_ext[row + t] || !valid[row + t] || sd.cis[row + t] != s.c)
      continue;
    const Seed<R> u(sd, row + t);
    if (u.l < sim) continue;
    const bool c1 = s.q <= u.q && sub_(add_(s.q, s.l), u.q) >= quarter &&
                    static_cast<R>(sub_(u.q, s.q)) != sub_(u.r, s.r);
    const bool c2 = u.q <= s.q && sub_(add_(u.q, u.l), s.q) >= quarter &&
                    static_cast<R>(sub_(s.q, u.q)) != sub_(s.r, u.r);
    if (c1 || c2) return true;
  }
  return false;
}

// the containment scan of read b (extend_scan_plain, one lane)
template <typename R>
LANE_HD void scan_lane(const ScanParams& p, long long b) {
  const long long row = b * p.S;
  const int32_t* order = p.order + row;
  const int32_t n_usable = p.n_usable[b];
  const int32_t nr = p.n_regs[b];
  const int live = static_cast<int>(min_<long long>(max_(nr, 0), p.Rg));
  R rb[kMaxRegs], re[kMaxRegs];
  int32_t qb[kMaxRegs], qe[kMaxRegs], w[kMaxRegs], sl0[kMaxRegs];
  const long long reg = b * p.Rg;
  for (int r = 0; r < live; ++r) {
    rb[r] = static_cast<const R*>(p.rb)[reg + r];
    re[r] = static_cast<const R*>(p.re)[reg + r];
    qb[r] = p.qb[reg + r];
    qe[r] = p.qe[reg + r];
    w[r] = p.w[reg + r];
    sl0[r] = p.seedlen0[reg + r];
  }
  const int32_t lens = p.lens[b];
  const int32_t lim = floordiv(lens, 10);
  const long long last = p.S - 1;
  int32_t cursor = p.cursor[b];
  while (cursor < n_usable) {
    const Seed<R> s(p.sd, row + order[min_<long long>(max_(cursor, 0), last)]);
    if (!covered<R>(s, live, rb, re, qb, qe, w, sl0, lim, p.o) ||
        rescued<R>(s, p.sd, p.valid, p.was_ext, row, p.S))
      break;
    cursor = add_(cursor, 1);
  }
  const int32_t slot = order[min_<long long>(max_(cursor, 0), last)];
  const bool todo = cursor < n_usable;
  const bool ovf_now = todo && nr >= p.Rg;
  const bool act = todo && !ovf_now;
  int32_t work[2] = {-1, -1};
  if (act) {
    const Seed<R> s(p.sd, row + slot);
    const long long ch = b * p.C + s.c;
    const R r0 = static_cast<const R*>(p.rmax0)[ch];
    const R r1 = static_cast<const R*>(p.rmax1)[ch];
    const int32_t qn[2] = {s.q, sub_(lens, add_(s.q, s.l))};
    const R tn[2] = {sub_(s.r, r0), sub_(r1, add_(s.r, static_cast<R>(s.l)))};
    for (int k = 0; k < 2; ++k)
      if (qn[k] > 0)
        work[k] = min_(wrap32(tn[k]), add_(qn[k], p.o.bandwidth));
  }
  p.cursor_out[b] = cursor;
  p.overflow_out[b] = p.overflow[b] || ovf_now;
  p.slot[b] = slot;
  p.act[b] = act;
  p.work[b] = work[0];
  p.work[p.B + b] = work[1];
}

// row `row` of the sorted SW order (side row / B), columns lane, lane +
// step, ... (extend_windows_plain, one row)
template <typename R>
LANE_HD void windows_row(const WinParams& p, long long row, int lane,
                        int step) {
  const int k = row >= p.B;
  const long long i = row - k * p.B;
  const long long b = p.perm[row];
  const int32_t slot = p.slot[b];
  const Seed<R> s(p.sd, b * p.S + slot);
  const long long ch = b * p.C + s.c;
  const int32_t qe0 = add_(s.q, s.l);
  const R re0 = add_(s.r, static_cast<R>(s.l));
  const int32_t qn = k == 0 ? s.q : sub_(p.lens[b], qe0);
  const R tn = k == 0 ? sub_(s.r, static_cast<const R*>(p.rmax0)[ch])
                      : sub_(static_cast<const R*>(p.rmax1)[ch], re0);
  const bool has = p.act[b] && qn > 0;
  // query: the prefix before the seed reversed, or the suffix after it
  const int32_t* codes = p.codes + b * p.W;
  int32_t* q = p.qbuf + row * p.W;
  const long long q0 = k == 0 ? static_cast<long long>(s.q) - 1 : qe0;
  const long long qdir = k == 0 ? -1 : 1;
  for (long long j = lane; j < p.W; j += step) {
    const long long at = q0 + qdir * j;
    q[j] = has && j < qn && at < p.W ? codes[min_(max_(at, 0LL), p.W - 1)]
                                     : kNoCode;
  }
  // target: the doubled text before the seed reversed, or after it
  int32_t* t = p.tbuf + row * p.T;
  const long long t0 = k == 0 ? static_cast<long long>(s.r) - 1
                              : static_cast<long long>(re0);
  for (long long j = lane; j < p.T; j += step) {
    int32_t v = kNoCode;
    const long long pos = t0 + qdir * j;
    if (has && j < static_cast<long long>(tn) && pos >= 0 && pos < p.seq_len) {
      v = packed_code(p.pac, p.n_words, pos);
    }
    t[j] = v;
  }
  if (lane == 0) {
    p.qn[row] = has ? qn : 0;
    p.tn[row] = has ? wrap32(tn) : 0;
    p.active[row] = has;
    p.inv[k * p.B + b] = static_cast<int32_t>(i);
    if (k == 0) p.h0[i] = mul_(s.l, p.match);
  }
}

// side k's SW result of lane b: the retry's where it retried (bwa keeps
// the wider band's result), and the band it ran at
struct Result {
  int32_t score, qle, tle, gtle, gscore, aw;
};

LANE_HD inline Result result(const MergeParams& p, int k, long long b) {
  const long long i = p.inv[k * p.B + b];
  const bool again = p.retry[i];
  const int32_t* const* f = again ? p.r2 : p.r1;
  return Result{f[0][i], f[1][i], f[2][i], f[3][i], f[4][i],
                again ? 2 * p.bandwidth : p.bandwidth};
}

// the left side's result folded into lane b (extend_merge_plain side 0)
template <typename R>
LANE_HD void merge_left_lane(const MergeParams& p, long long b) {
  const Seed<R> s(p.sd, b * p.S + p.slot[b]);
  const Result x = result(p, 0, b);
  const bool has = p.act[b] && s.q > 0;
  const bool local = x.gscore <= 0 || x.gscore <= sub_(x.score, p.pen_clip);
  const int32_t seed_sc = mul_(s.l, p.match);
  const int32_t score = has ? x.score : seed_sc;
  p.l_qb[b] = has && local ? sub_(s.q, x.qle) : 0;
  static_cast<R*>(p.l_rb)[b] =
      has ? sub_(s.r, static_cast<R>(local ? x.tle : x.gtle)) : s.r;
  p.l_score[b] = score;
  p.l_truesc[b] = has ? (local ? x.score : x.gscore) : seed_sc;
  p.l_aw[b] = has ? x.aw : p.bandwidth;
  p.h0[p.inv[p.B + b]] = score;
}

// the right side's result and the new region row of lane b, the state
// copied with it (extend_merge_plain side 1)
template <typename R>
LANE_HD void merge_right_lane(const MergeParams& p, long long b) {
  const int32_t slot = p.slot[b];
  const Seed<R> s(p.sd, b * p.S + slot);
  const Result x = result(p, 1, b);
  const bool act = p.act[b];
  const int32_t lens = p.lens[b];
  const int32_t qe0 = add_(s.q, s.l);
  const R re0 = add_(s.r, static_cast<R>(s.l));
  const bool has = act && sub_(lens, qe0) > 0;
  const bool local = x.gscore <= 0 || x.gscore <= sub_(x.score, p.pen_clip);
  const int32_t l_score = p.l_score[b];
  // the new row's ten fields (REG_FIELDS), R-typed rb and re first
  const R rb = static_cast<const R*>(p.l_rb)[b];
  const R re = has ? add_(re0, static_cast<R>(local ? x.tle : x.gtle)) : re0;
  const int32_t vals[8] = {
      p.l_qb[b],
      has ? (local ? add_(qe0, x.qle) : lens) : qe0,
      has ? x.score : l_score,
      add_(p.l_truesc[b],
           has ? sub_(local ? x.score : x.gscore, l_score) : 0),
      max_(p.l_aw[b], has ? x.aw : p.bandwidth),
      s.l,
      s.c,
      p.crid[b * p.C + s.c]};
  const int32_t nr = p.n_regs[b];
  const long long at = min_<long long>(nr, p.Rg - 1);
  const long long reg = b * p.Rg;
  for (long long r = 0; r < p.Rg; ++r) {
    const bool put = act && r == at;
    const long long e = reg + r;
    static_cast<R*>(p.regs_out[0])[e] =
        put ? rb : static_cast<const R*>(p.regs[0])[e];
    static_cast<R*>(p.regs_out[1])[e] =
        put ? re : static_cast<const R*>(p.regs[1])[e];
    for (int f = 0; f < 8; ++f)
      static_cast<int32_t*>(p.regs_out[2 + f])[e] =
          put ? vals[f] : static_cast<const int32_t*>(p.regs[2 + f])[e];
  }
  p.n_regs_out[b] = add_(nr, static_cast<int32_t>(act));
  const long long row = b * p.S;
  for (long long t = 0; t < p.S; ++t)
    p.was_ext_out[row + t] = p.was_ext[row + t] || (act && t == slot);
  const int32_t cursor = p.cursor[b];
  p.cursor_out[b] = act ? add_(cursor, 1) : cursor;
}

// read b's seedcov (extend_seedcov_plain, one lane)
template <typename R>
LANE_HD void seedcov_lane(const CovParams& p, long long b) {
  R rb[kMaxRegs], re[kMaxRegs];
  int32_t qb[kMaxRegs], qe[kMaxRegs], cc[kMaxRegs], acc[kMaxRegs];
  const int Rg = static_cast<int>(p.Rg);
  const long long reg = b * p.Rg;
  for (int r = 0; r < Rg; ++r) {
    rb[r] = static_cast<const R*>(p.rb)[reg + r];
    re[r] = static_cast<const R*>(p.re)[reg + r];
    qb[r] = p.qb[reg + r];
    qe[r] = p.qe[reg + r];
    cc[r] = p.cchain[reg + r];
    acc[r] = 0;
  }
  const long long row = b * p.S;
  for (long long t = 0; t < p.S; ++t) {
    if (!p.ok[row + t]) continue;
    const Seed<R> s(p.sd, row + t);
    const int32_t qend = add_(s.q, s.l);
    const R rend = add_(s.r, static_cast<R>(s.l));
    for (int r = 0; r < Rg; ++r)
      if (s.c == cc[r] && s.q >= qb[r] && qend <= qe[r] && s.r >= rb[r] &&
          rend <= re[r])
        acc[r] = add_(acc[r], s.l);
  }
  for (int r = 0; r < Rg; ++r) p.seedcov[reg + r] = acc[r];
}

#ifdef __CUDACC__
template <typename R>
__global__ void __launch_bounds__(kThreads) extend_scan(const ScanParams p) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (b < p.B) scan_lane<R>(p, b);
}

template <typename R>
__global__ void __launch_bounds__(kThreads)
    extend_windows(const WinParams p) {
  const long long row = static_cast<long long>(blockIdx.x) *
                            (kThreads / kWarp) + threadIdx.x / kWarp;
  if (row < 2 * p.B) windows_row<R>(p, row, threadIdx.x % kWarp, kWarp);
}

template <typename R, int kSide>
__global__ void __launch_bounds__(kThreads)
    extend_merge(const MergeParams p) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (b >= p.B) return;
  if (kSide == 0)
    merge_left_lane<R>(p, b);
  else
    merge_right_lane<R>(p, b);
}

template <typename R>
__global__ void __launch_bounds__(kThreads)
    extend_seedcov(const CovParams p) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (b < p.B) seedcov_lane<R>(p, b);
}

unsigned blocks(long long n, long long per) {
  return static_cast<unsigned>((n + per - 1) / per);
}
#endif

// the entries' argument array, read in order
struct Args {
  const long long* a;
  long long n, i;
  template <typename T>
  T ptr() {
    return reinterpret_cast<T>(i < n ? a[i++] : (++i, 0LL));
  }
  long long num() { return i < n ? a[i++] : (++i, 0LL); }
};

Seeds seeds(Args& g) {
  Seeds sd;
  sd.rbeg = g.ptr<const void*>();
  sd.qbeg = g.ptr<const int32_t*>();
  sd.len = g.ptr<const int32_t*>();
  sd.cis = g.ptr<const int32_t*>();
  return sd;
}

Opts opts(Args& g) {
  Opts o;
  o.match = static_cast<int32_t>(g.num());
  o.o_del = static_cast<int32_t>(g.num());
  o.e_del = static_cast<int32_t>(g.num());
  o.o_ins = static_cast<int32_t>(g.num());
  o.e_ins = static_cast<int32_t>(g.num());
  o.bandwidth = static_cast<int32_t>(g.num());
  return o;
}

bool bad_rank(long long rank_bytes) {
  return rank_bytes != 4 && rank_bytes != 8;
}

}  // namespace

#ifdef __CUDACC__
// launch kernel<R>, R from rank_bytes, on `stream`; the launch's error code
#define EXT_RUN(kernel, grid, p, ...)                                        \
  do {                                                                       \
    if (rank_bytes == 8)                                                     \
      kernel<long long __VA_ARGS__><<<(grid), kThreads, 0, stream>>>(p);     \
    else                                                                     \
      kernel<int32_t __VA_ARGS__><<<(grid), kThreads, 0, stream>>>(p);       \
    return static_cast<int>(cudaGetLastError());                             \
  } while (0)
#endif

// Each entry: extend_*_launch (nvcc; on `stream`) or extend_*_host (a host
// compiler; every read in turn) takes the argument array `a` of `n`
// values (kernels/extend_cuda.py lists them) and returns 0, or a CUDA
// error code (kRefused for a refused count, rank size or shape).

extern "C" int LANE_ENTRY(extend_scan)(const long long* a,
                                      long long n LANE_STREAM) {
  Args g{a, n, 0};
  const long long rank_bytes = g.num();
  ScanParams p;
  p.order = g.ptr<const int32_t*>();
  p.n_usable = g.ptr<const int32_t*>();
  p.sd = seeds(g);
  p.valid = g.ptr<const uint8_t*>();
  p.lens = g.ptr<const int32_t*>();
  p.rmax0 = g.ptr<const void*>();
  p.rmax1 = g.ptr<const void*>();
  p.rb = g.ptr<const void*>();
  p.re = g.ptr<const void*>();
  p.qb = g.ptr<const int32_t*>();
  p.qe = g.ptr<const int32_t*>();
  p.w = g.ptr<const int32_t*>();
  p.seedlen0 = g.ptr<const int32_t*>();
  p.n_regs = g.ptr<const int32_t*>();
  p.was_ext = g.ptr<const uint8_t*>();
  p.cursor = g.ptr<const int32_t*>();
  p.overflow = g.ptr<const uint8_t*>();
  p.cursor_out = g.ptr<int32_t*>();
  p.overflow_out = g.ptr<uint8_t*>();
  p.slot = g.ptr<int32_t*>();
  p.act = g.ptr<uint8_t*>();
  p.work = g.ptr<int32_t*>();
  p.B = g.num();
  p.S = g.num();
  p.C = g.num();
  p.Rg = g.num();
  p.o = opts(g);
  if (g.i != n || bad_rank(rank_bytes) || p.B < 1 || p.S < 1 || p.C < 1 ||
      p.Rg < 1 || p.Rg > kMaxRegs)
    return kRefused;
#ifdef __CUDACC__
  EXT_RUN(extend_scan, blocks(p.B, kThreads), p);
#else
  for (long long b = 0; b < p.B; ++b) {
    if (rank_bytes == 8)
      scan_lane<long long>(p, b);
    else
      scan_lane<int32_t>(p, b);
  }
  return 0;
#endif
}

extern "C" int LANE_ENTRY(extend_windows)(const long long* a,
                                         long long n LANE_STREAM) {
  Args g{a, n, 0};
  const long long rank_bytes = g.num();
  WinParams p;
  p.perm = g.ptr<const long long*>();
  p.slot = g.ptr<const int32_t*>();
  p.act = g.ptr<const uint8_t*>();
  p.sd = seeds(g);
  p.lens = g.ptr<const int32_t*>();
  p.rmax0 = g.ptr<const void*>();
  p.rmax1 = g.ptr<const void*>();
  p.codes = g.ptr<const int32_t*>();
  p.pac = g.ptr<const int32_t*>();
  p.qbuf = g.ptr<int32_t*>();
  p.tbuf = g.ptr<int32_t*>();
  p.qn = g.ptr<int32_t*>();
  p.tn = g.ptr<int32_t*>();
  p.active = g.ptr<uint8_t*>();
  p.h0 = g.ptr<int32_t*>();
  p.inv = g.ptr<int32_t*>();
  p.B = g.num();
  p.S = g.num();
  p.C = g.num();
  p.W = g.num();
  p.T = g.num();
  p.n_words = g.num();
  p.seq_len = g.num();
  p.match = static_cast<int32_t>(g.num());
  if (g.i != n || bad_rank(rank_bytes) || p.B < 1 || p.S < 1 || p.C < 1 ||
      p.W < 1 || p.T < 1 || p.n_words < 1)
    return kRefused;
#ifdef __CUDACC__
  EXT_RUN(extend_windows, blocks(2 * p.B, kThreads / kWarp), p);
#else
  for (long long row = 0; row < 2 * p.B; ++row) {
    if (rank_bytes == 8)
      windows_row<long long>(p, row, 0, 1);
    else
      windows_row<int32_t>(p, row, 0, 1);
  }
  return 0;
#endif
}

// the arguments both merge entries share, then the side's own
static int merge_common(Args& g, MergeParams& p) {
  p.inv = g.ptr<const int32_t*>();
  p.retry = g.ptr<const uint8_t*>();
  for (int f = 0; f < kFields; ++f) p.r1[f] = g.ptr<const int32_t*>();
  for (int f = 0; f < kFields; ++f) p.r2[f] = g.ptr<const int32_t*>();
  p.slot = g.ptr<const int32_t*>();
  p.act = g.ptr<const uint8_t*>();
  p.sd = seeds(g);
  p.lens = g.ptr<const int32_t*>();
  p.l_qb = g.ptr<int32_t*>();
  p.l_rb = g.ptr<void*>();
  p.l_score = g.ptr<int32_t*>();
  p.l_truesc = g.ptr<int32_t*>();
  p.l_aw = g.ptr<int32_t*>();
  return 0;
}

static void merge_sizes(Args& g, MergeParams& p) {
  p.B = g.num();
  p.S = g.num();
  p.C = g.num();
  p.Rg = g.num();
  p.match = static_cast<int32_t>(g.num());
  p.bandwidth = static_cast<int32_t>(g.num());
  p.pen_clip = static_cast<int32_t>(g.num());
}

static bool merge_refused(const Args& g, long long n, long long rank_bytes,
                          const MergeParams& p) {
  return g.i != n || bad_rank(rank_bytes) || p.B < 1 || p.S < 1 ||
         p.C < 1 || p.Rg < 1;
}

extern "C" int LANE_ENTRY(extend_merge_left)(const long long* a,
                                            long long n LANE_STREAM) {
  Args g{a, n, 0};
  const long long rank_bytes = g.num();
  MergeParams p = {};
  merge_common(g, p);
  p.h0 = g.ptr<int32_t*>();
  merge_sizes(g, p);
  if (merge_refused(g, n, rank_bytes, p)) return kRefused;
#ifdef __CUDACC__
  EXT_RUN(extend_merge, blocks(p.B, kThreads), p, , 0);
#else
  for (long long b = 0; b < p.B; ++b) {
    if (rank_bytes == 8)
      merge_left_lane<long long>(p, b);
    else
      merge_left_lane<int32_t>(p, b);
  }
  return 0;
#endif
}

extern "C" int LANE_ENTRY(extend_merge_right)(const long long* a,
                                             long long n LANE_STREAM) {
  Args g{a, n, 0};
  const long long rank_bytes = g.num();
  MergeParams p = {};
  merge_common(g, p);
  p.crid = g.ptr<const int32_t*>();
  for (int f = 0; f < 10; ++f) p.regs[f] = g.ptr<const void*>();
  p.n_regs = g.ptr<const int32_t*>();
  p.was_ext = g.ptr<const uint8_t*>();
  p.cursor = g.ptr<const int32_t*>();
  for (int f = 0; f < 10; ++f) p.regs_out[f] = g.ptr<void*>();
  p.n_regs_out = g.ptr<int32_t*>();
  p.was_ext_out = g.ptr<uint8_t*>();
  p.cursor_out = g.ptr<int32_t*>();
  merge_sizes(g, p);
  if (merge_refused(g, n, rank_bytes, p)) return kRefused;
#ifdef __CUDACC__
  EXT_RUN(extend_merge, blocks(p.B, kThreads), p, , 1);
#else
  for (long long b = 0; b < p.B; ++b) {
    if (rank_bytes == 8)
      merge_right_lane<long long>(p, b);
    else
      merge_right_lane<int32_t>(p, b);
  }
  return 0;
#endif
}

extern "C" int LANE_ENTRY(extend_seedcov)(const long long* a,
                                         long long n LANE_STREAM) {
  Args g{a, n, 0};
  const long long rank_bytes = g.num();
  CovParams p;
  p.sd = seeds(g);
  p.ok = g.ptr<const uint8_t*>();
  p.rb = g.ptr<const void*>();
  p.re = g.ptr<const void*>();
  p.qb = g.ptr<const int32_t*>();
  p.qe = g.ptr<const int32_t*>();
  p.cchain = g.ptr<const int32_t*>();
  p.seedcov = g.ptr<int32_t*>();
  p.B = g.num();
  p.S = g.num();
  p.Rg = g.num();
  if (g.i != n || bad_rank(rank_bytes) || p.B < 1 || p.S < 1 || p.Rg < 1 ||
      p.Rg > kMaxRegs)
    return kRefused;
#ifdef __CUDACC__
  EXT_RUN(extend_seedcov, blocks(p.B, kThreads), p);
#else
  for (long long b = 0; b < p.B; ++b) {
    if (rank_bytes == 8)
      seedcov_lane<long long>(p, b);
    else
      seedcov_lane<int32_t>(p, b);
  }
  return 0;
#endif
}
