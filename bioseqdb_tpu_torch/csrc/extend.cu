// The extension stage's device loops for Hopper: its set-up (the seed
// order and the chains' windows), every trip of a round's containment
// scan, its SW windows, the fold of its SW results into the region table,
// and the seedcov epilogue, each one launch.
//
// Replaces the TPU program around the one Pallas kernel of
// bioseqdb_tpu/kernels/extend.py extend_all (:155): the set-up (:195-250,
// two argsorts and the rmax fori_loop at :229-243), the containment scan
// (containment_scan :280-346, a chunked_while at :341), the rounds'
// fori_loop (:543) with its window fetch and region merge
// (_extend_round :444-541; lax.cond at :405 and :439) and seedcov's
// fori_loop (cov_body :552-567). XLA compiled those loops into the one
// device program; the Pallas kernel inside, the banded SW (sw_pallas.py
// :258), is csrc/sw_extend.cu, launched between these kernels. Each
// kernel computes exactly what its plain twin in
// bioseqdb_tpu_torch/kernels/extend.py computes (extend_setup_plain,
// extend_scan_plain, extend_windows_plain, extend_merge_plain,
// extend_seedcov_plain), which equal the JAX package, not bwa's C.
//
// The JAX program's two lax.conds (a round with no active read, a side
// with no retry) stay on the device: the scan adds its round's active
// reads to a count on the card, and the windows, the merges and the SW
// kernel take a pointer to a count (the round's, or the side's retries)
// as their gate and skip their work when it is 0. So the host never
// waits on the card between the rounds.
//
// What bounds them: each reads a read's seed slots, its region table and
// (windows) its read codes and a window of the packed text once, and
// writes its outputs once; the work between is a few dozen integer
// compares a seed the scan passes, R regions a seed for seedcov, and in
// the set-up S + C compares a seed (its counting ranks: at the main
// path's S 64 these instructions and its bytes bound it about equally).
// So the card's memory rate bounds them, and the windows kernel, which
// writes two [B, W] and two [B, W + 4 * band + 64] int32 buffers (the SW
// kernel's interface), moves the most. What a launch of the others costs
// is each read's chain of dependent loads (its slot, then its seed, then
// its regions or results) and the instructions its threads issue.
//
// Design:
// - extend_setup: a warp a read, its seeds' keys, windows and chains in
//   shared memory sized by the call (up to kSetupReads reads a block
//   within 48 KB), or where one read's do not fit (S past 3,056 with
//   int32 ranks at C 32, 2,037 with int64: about 36 kb and 24 kb reads,
//   half that in the fat retry, which doubles S) in a scratch buffer in
//   device memory that the wrapper allocates, a read's row of it. Both
//   stable argsorts of the plain twin are per read, so each is a counting
//   rank: a key's rank is the number of keys below it plus the number of
//   equal keys at lower slots, a permutation whose inverse is the stable
//   argsort (order[rank[s]] = s). The chain order's argsort (the rank of
//   each chain by the filter's order) is the same rank-and-scatter over C,
//   so it equals the argsort whatever the values are. A lane a seed
//   computes its key, its window ends and its chain, then a lane a seed
//   counts its rank over the S keys, and a lane a chain takes the min and
//   max of the windows of its seeds; a seed outside a chain (clamped to
//   chain 0 in cis) touches no window.
// - the gates: a gated kernel reads its gate once; 0 means no read of the
//   round is active (or no lane of the side retries). The windows kernel
//   then skips the two SW buffers and writes only the rows' small
//   outputs (qn, tn and active all 0, h0, inv), which the retry masks
//   read; the merges return at once; the right merge updates the state
//   in place when its outputs are its inputs (extend_all's rounds), so a
//   gated round leaves it as it was.
// - extend_scan: a warp a read (kScanGroup threads), 4 a block. Reads
//   are independent (the plain twins act on each read's row alone), and
//   within a read each trip's verdict is independent of the trips before
//   it: the region table, was_ext and valid change only in the merge,
//   which writes new tensors. So the scan is a find-first over the
//   ordered seeds from the cursor on: the first seed an accumulated
//   region does not cover, or that an extended seed rescues. The warp
//   puts the live regions (at most kMaxRegs, the wrapper refuses more) in
//   shared memory once, then takes 32 cursors a pass, a lane each: each
//   lane tests its seed against the regions, and the lanes that are
//   covered and lie before the first uncovered one test the rescue
//   against the read's extended and valid seeds only. Those are
//   collected in slot order by ballots over chunks of 32 slots, 32 a
//   batch, one a lane, and broadcast by shuffles; a read with more than
//   32 streams further batches, so S and C stay unbounded. A ballot of
//   the stopping lanes and its lowest bit give the new cursor, the
//   stopping lane's seed goes to the others by shuffles; no stop moves
//   the warp on 32 cursors. A read at n_usable loads nothing; a read with
//   no live region stops at its cursor without a pass; cal_max_gap's
//   divisions run only for a diagonal gap between the band's bounds
//   (near). kScanMinBlocks caps the registers at 48, so that more warps
//   fit an SM (PERF.md row 10 has the launch with and without the cap,
//   and with half a warp a read).
// - extend_merge_right: a group of kMergeGroup threads a read,
//   kMergeReads a block, so the main path's 16,384 reads fit the card in
//   one wave of blocks (PERF.md row 10: 16 a block). It copies the read's
//   region table field by field with the group's threads on
//   neighbouring elements, so a warp's store to a [B, R] field is one
//   contiguous run, the new row's fields chosen per element; its was_ext
//   row is copied 8 bytes a thread where source and destination share
//   their alignment (bytes for the head and tail), the slot just
//   extended set in the word that holds it.
// - extend_merge_left and extend_seedcov: one thread a read, 128 a
//   block. The left merge is a gather through inv, a few selects and a
//   scatter a read: on a group of 8, its leader working, it ran the same
//   chain in 8 times the warps and was slower on the card.
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

constexpr int kThreads = 128;   // a windows, seedcov or left merge block
constexpr int kWarp = 32;       // a windows row's threads
constexpr int kScanGroup = 32;  // the scan's threads a read
constexpr int kScanThreads = 128;   // a scan block
constexpr int kScanMinBlocks = 10;  // scan blocks an SM holds (<= 48 regs)
constexpr int kMergeGroup = 8;  // the right merge's threads a read
constexpr int kMergeReads = 64; // a right merge block's reads
constexpr int kMaxRegs = 16;    // regions a read (the wrapper raises above)
constexpr int kNoCode = 4;      // the code past a buffer's length
constexpr int kRefused = 1;     // cudaErrorInvalidValue
constexpr int kFields = 6;      // an SW result (sw.FIELDS), max_off last
constexpr int kSetupGroup = 32; // the set-up's threads a read
constexpr int kSetupReads = 4;  // a set-up block's reads at most
constexpr int kSetupSmem = 49152;   // a set-up block's shared memory at most
constexpr int32_t kUnusable = 0x7FFFFFF0;   // an unusable seed's sort key
static_assert(kScanGroup >= kMaxRegs && kScanGroup <= kWarp,
              "a read's group loads region r on its lane r");


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
  int32_t* count;          // [1] or null: the active reads are added to it
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
  const int32_t* gate;     // [1] or null: 0 skips the SW buffers
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
  const int32_t* gate;     // [1] or null: 0 skips the merge
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

struct SetupParams {
  const void* rbeg;        // [B, S] R
  const int32_t* qbeg;     // [B, S]
  const int32_t* len;      // [B, S]
  const uint8_t* valid;    // [B, S]
  const int32_t* score;    // [B, S], or null: len x match
  const int32_t* assign;   // [B, S] the seed's chain, < 0 for none
  const int32_t* forder;   // [B, C] the filter's chain order
  const int32_t* kept;     // [B, C]
  const void* f_rbeg;      // [B, C] R: the chain's first seed
  const int32_t* crid;     // [B, C] the chain's reference
  const int32_t* lens;     // [B]
  const void* ref_offsets; // [n_refs] R
  const void* ref_lens;    // [n_refs] R
  int32_t* order;          // [B, S] out: the processing order of the slots
  int32_t* n_usable;       // [B] out
  int32_t* cis;            // [B, S] out: assign clamped into [0, C)
  uint8_t* ok;             // [B, S] out: valid and in a chain
  void* rmax0;             // [B, C] R out: the chain's reference window
  void* rmax1;             // [B, C] R out
  unsigned char* scratch;  // [B, setup_bytes(S, C)] or null: the reads'
                           // tables in shared memory
  long long B, S, C, n_refs, l_pac, seq_len;
  Opts o;
};

// the seed at slot s of read b: its query start, length, chain and
// reference start
template <typename R>
struct Seed {
  int32_t q, l, c;
  R r;
  Seed() = default;
  LANE_HD Seed(const Seeds& sd, long long at)
      : q(sd.qbeg[at]), l(sd.len[at]), c(sd.cis[at]),
        r(static_cast<const R*>(sd.rbeg)[at]) {}
};

// a region's fields the scan tests a seed against
template <typename R>
struct Region {
  R rb, re;
  int32_t qb, qe, w, sl0;
};

// is the gap between diagonals qd and rd inside the band the region
// allows: sub_(qd, rd) and sub_(rd, qd) below min(max_gap(min(qd, rd)), w)?
// max_gap lies in [min(1, 2 * bandwidth), 2 * bandwidth], so its float
// divisions are needed only for a gap between those bounds (clamped by w)
template <typename R>
LANE_HD bool near(R qd, R rd, int32_t w, const Opts& o) {
  const R a = sub_(qd, rd), b = sub_(rd, qd);
  const R gap = max_(a, b);
  const int32_t band2 = o.bandwidth * 2;
  if (gap < static_cast<R>(min_(min_(1, band2), w))) return true;
  if (gap >= static_cast<R>(min_(band2, w))) return false;
  const R wlim = static_cast<R>(min_(max_gap<R>(min_(qd, rd), o), w));
  return a < wlim && b < wlim;
}

// does region g cover seed s (inside it, near one of its ends)?
template <typename R>
LANE_HD bool covers(const Region<R>& g, const Seed<R>& s, int32_t lim,
                    const Opts& o) {
  const int32_t qend = add_(s.q, s.l);
  const R rend = add_(s.r, static_cast<R>(s.l));
  if (!(s.r >= g.rb && rend <= g.re && s.q >= g.qb && qend <= g.qe &&
        sub_(s.l, g.sl0) <= lim))
    return false;
  return near<R>(static_cast<R>(sub_(s.q, g.qb)), sub_(s.r, g.rb), g.w, o) ||
         near<R>(static_cast<R>(sub_(g.qe, qend)), sub_(g.re, rend), g.w, o);
}

// the overlap rescue: does u, an extended and valid seed, rescue seed s
// (the same chain, of similar length, overlapping it on another
// diagonal)?
template <typename R>
LANE_HD bool rescues(const Seed<R>& s, const Seed<R>& u) {
  const int32_t quarter = s.l >> 2;
  const int32_t sim = floordiv(add_(mul_(s.l, 19), 19), 20);
  if (u.c != s.c || u.l < sim) return false;
  const bool c1 = s.q <= u.q && sub_(add_(s.q, s.l), u.q) >= quarter &&
                  static_cast<R>(sub_(u.q, s.q)) != sub_(u.r, s.r);
  const bool c2 = u.q <= s.q && sub_(add_(u.q, u.l), s.q) >= quarter &&
                  static_cast<R>(sub_(s.q, u.q)) != sub_(s.r, u.r);
  return c1 || c2;
}

// a scan group's shared memory: its read's live regions and the slots of
// a batch of its extended seeds
template <typename R>
struct ScanSmem {
  Region<R> reg[kMaxRegs];
  int32_t ext[kScanGroup];
};

// a batch of a read's extended and valid seeds, seed j on lane j
template <typename R>
struct ExtBatch {
  Lanes<int32_t, kScanGroup> q, l, c;
  Lanes<R, kScanGroup> r;
  int n;            // seeds in the batch
  long long next;   // the slot the next batch starts from (>= S: none)
};

// the batch of read `row`'s extended and valid seeds that starts at slot
// `from`: up to a group's width of them in slot order, compacted by
// ballots over chunks of that many slots
template <typename R>
GROUP_FN void collect(const ScanParams& p, long long row, long long from,
                      ScanSmem<R>& sm, ExtBatch<R>& e) {
  constexpr auto G = kScanGroup;
  int n = 0;
  long long pos = from;
  while (pos < p.S && n < G) {
    Lanes<bool, G> f, past;
    FOR_LANES(G, t) {
      const long long at = pos + t;
      f[t] = at < p.S && p.was_ext[row + at] && p.valid[row + at];
    }
    const uint32_t m = ballot(f);
    FOR_LANES(G, t) {
      const int idx = n + popc32(m & ((1u << t) - 1u));
      past[t] = f[t] && idx == G;   // the first seed the batch has no room for
      if (f[t] && idx < G) sm.ext[idx] = static_cast<int32_t>(pos + t);
    }
    const uint32_t over = ballot(past);
    if (over != 0) {
      pos += low_bit(over);
      n = G;
    } else {
      n += popc32(m);
      pos += G;
    }
  }
  group_sync<G>();
  FOR_LANES(G, t) {
    if (t >= n) continue;
    const Seed<R> u(p.sd, row + sm.ext[t]);
    e.q[t] = u.q;
    e.l[t] = u.l;
    e.c[t] = u.c;
    e.r[t] = u.r;
  }
  group_sync<G>();   // sm.ext is free for the next batch
  e.n = n;
  e.next = pos;
}

// the lanes of mask `need` whose seed a seed of batch e rescues
template <typename R>
GROUP_FN void rescue(const ExtBatch<R>& e, uint32_t need,
                     const Lanes<Seed<R>, kScanGroup>& s,
                     Lanes<bool, kScanGroup>& resc) {
  constexpr auto G = kScanGroup;
  for (int j = 0; j < e.n; ++j) {
    Seed<R> u;
    u.q = shfl(e.q, j);
    u.l = shfl(e.l, j);
    u.c = shfl(e.c, j);
    u.r = shfl(e.r, j);
    FOR_LANES(G, t) {
      if ((need >> t) & 1u && !resc[t] && rescues<R>(s[t], u))
        resc[t] = true;
    }
  }
}

// the containment scan of read b (extend_scan_plain, one read) by a group
// of kScanGroup threads; whether the read is active this round
template <typename R>
GROUP_FN bool scan_group(const ScanParams& p, long long b, ScanSmem<R>& sm) {
  constexpr auto G = kScanGroup;
  const long long row = b * p.S;
  const int32_t* order = p.order + row;
  const int32_t n_usable = p.n_usable[b];
  const int32_t nr = p.n_regs[b];
  const long long last = p.S - 1;
  const int32_t start = p.cursor[b];
  const int live = static_cast<int>(min_<long long>(max_(nr, 0), p.Rg));
  // where the sequential scan ends when no seed stops it
  int32_t cursor = start < n_usable ? n_usable : start;
  bool stopped = false;
  int32_t slot = 0;   // the stopping seed's slot and fields
  Seed<R> ss{};
  // with no live region nothing is covered: the cursor's seed stops it
  if (start < n_usable && live > 0) {
    const long long reg = b * p.Rg;
    FOR_LANES(G, t) {
      if (t >= live) continue;
      sm.reg[t] = Region<R>{static_cast<const R*>(p.rb)[reg + t],
                            static_cast<const R*>(p.re)[reg + t],
                            p.qb[reg + t], p.qe[reg + t], p.w[reg + t],
                            p.seedlen0[reg + t]};
    }
    group_sync<G>();
    const int32_t lim = floordiv(p.lens[b], 10);
    for (long long k = 0; start + k < n_usable; k += G) {
      Lanes<Seed<R>, G> s;
      Lanes<int32_t, G> at;
      Lanes<bool, G> in, cov, resc;
      FOR_LANES(G, t) {
        const long long c = start + k + t;
        in[t] = c < n_usable;
        cov[t] = resc[t] = false;
        if (!in[t]) continue;
        at[t] = order[min_(max_(c, 0LL), last)];
        s[t] = Seed<R>(p.sd, row + at[t]);
      }
      for (int r = 0; r < live; ++r) {
        const Region<R> g = sm.reg[r];
        FOR_LANES(G, t) {
          if (in[t] && !cov[t] && covers<R>(g, s[t], lim, p.o)) cov[t] = true;
        }
      }
      Lanes<bool, G> bare;   // in range and not covered
      FOR_LANES(G, t) bare[t] = in[t] && !cov[t];
      const uint32_t mc = ballot(cov), mb = ballot(bare);
      // only covered lanes before the first bare one can stop the scan
      const uint32_t need = mb != 0 ? mc & ((1u << low_bit(mb)) - 1u) : mc;
      // the extended seeds, a batch of G at a time
      for (long long from = 0; need != 0 && from < p.S;) {
        ExtBatch<R> e;
        collect<R>(p, row, from, sm, e);
        rescue<R>(e, need, s, resc);
        from = e.next;
      }
      Lanes<bool, G> stop;
      FOR_LANES(G, t) stop[t] = bare[t] || resc[t];
      const uint32_t ms = ballot(stop);
      if (ms != 0) {   // the first stopping lane's seed, by shuffles
        const int first_stop = low_bit(ms);
        Lanes<int32_t, G> q, l, c;
        Lanes<R, G> r;
        FOR_LANES(G, t) {
          q[t] = s[t].q;
          l[t] = s[t].l;
          c[t] = s[t].c;
          r[t] = s[t].r;
        }
        cursor = add_(start, static_cast<int32_t>(k + first_stop));
        slot = shfl(at, first_stop);
        ss.q = shfl(q, first_stop);
        ss.l = shfl(l, first_stop);
        ss.c = shfl(c, first_stop);
        ss.r = shfl(r, first_stop);
        stopped = true;
        break;
      }
    }
  }
  if (start < n_usable && live == 0) cursor = start;
  if (!stopped) {
    slot = order[min_<long long>(max_(cursor, 0), last)];
    if (cursor < n_usable) ss = Seed<R>(p.sd, row + slot);
  }
  const bool todo = cursor < n_usable;
  const bool ovf_now = todo && nr >= p.Rg;
  const bool act = todo && !ovf_now;
  int32_t work[2] = {-1, -1};
  if (act) {
    const long long ch = b * p.C + ss.c;
    const R r0 = static_cast<const R*>(p.rmax0)[ch];
    const R r1 = static_cast<const R*>(p.rmax1)[ch];
    const int32_t lens = p.lens[b];
    const int32_t qn[2] = {ss.q, sub_(lens, add_(ss.q, ss.l))};
    const R tn[2] = {sub_(ss.r, r0),
                     sub_(r1, add_(ss.r, static_cast<R>(ss.l)))};
    for (int k = 0; k < 2; ++k)
      if (qn[k] > 0)
        work[k] = min_(wrap32(tn[k]), add_(qn[k], p.o.bandwidth));
  }
  if (group_leader<G>()) {
    p.cursor_out[b] = cursor;
    p.overflow_out[b] = p.overflow[b] || ovf_now;
    p.slot[b] = slot;
    p.act[b] = act;
    p.work[b] = work[0];
    p.work[p.B + b] = work[1];
  }
  return act;
}

// is a gate closed: given, and its count 0
LANE_HD inline bool closed(const int32_t* gate) {
  return gate != nullptr && *gate == 0;
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
  // a gated round (no active read) writes no SW buffer: no launch reads it
  const long long W = closed(p.gate) ? 0 : p.W;
  const long long T = closed(p.gate) ? 0 : p.T;
  // query: the prefix before the seed reversed, or the suffix after it
  const int32_t* codes = p.codes + b * p.W;
  int32_t* q = p.qbuf + row * p.W;
  const long long q0 = k == 0 ? static_cast<long long>(s.q) - 1 : qe0;
  const long long qdir = k == 0 ? -1 : 1;
  for (long long j = lane; j < W; j += step) {
    const long long at = q0 + qdir * j;
    q[j] = has && j < qn && at < p.W ? codes[min_(max_(at, 0LL), p.W - 1)]
                                     : kNoCode;
  }
  // target: the doubled text before the seed reversed, or after it
  int32_t* t = p.tbuf + row * p.T;
  const long long t0 = k == 0 ? static_cast<long long>(s.r) - 1
                              : static_cast<long long>(re0);
  for (long long j = lane; j < T; j += step) {
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
  if (closed(p.gate)) return;
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

// the right side's result and the new region row of read b, the state
// copied with it (extend_merge_plain side 1), by a group of kMergeGroup
// threads. In place (the outputs are the inputs), only the new row, the
// slot's was_ext byte, n_regs and the cursor are written.
template <typename R>
GROUP_FN void merge_right_group(const MergeParams& p, long long b) {
  constexpr auto G = kMergeGroup;
  if (closed(p.gate)) return;
  const bool inplace = p.was_ext_out == p.was_ext;
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
  // the table, field by field: the group's threads on neighbouring rows
  FOR_LANES(G, t) {
    for (long long r = t; r < p.Rg; r += G) {
      const bool put = act && r == at;
      if (inplace && !put) continue;
      const long long e = reg + r;
      static_cast<R*>(p.regs_out[0])[e] =
          put ? rb : static_cast<const R*>(p.regs[0])[e];
      static_cast<R*>(p.regs_out[1])[e] =
          put ? re : static_cast<const R*>(p.regs[1])[e];
      for (int f = 0; f < 8; ++f)
        static_cast<int32_t*>(p.regs_out[2 + f])[e] =
            put ? vals[f] : static_cast<const int32_t*>(p.regs[2 + f])[e];
    }
  }
  // was_ext: 8-byte words between a head and a tail of bytes, where the
  // row's source and destination share their alignment (else bytes)
  const long long row = b * p.S;
  const uint8_t* src = p.was_ext + row;
  uint8_t* dst = p.was_ext_out + row;
  group_sync<G>();   // every thread has read n_regs before it is written
  if (inplace) {
    if (group_leader<G>() && act) {
      dst[slot] = 1;
      p.n_regs_out[b] = add_(nr, 1);
      p.cursor_out[b] = add_(p.cursor[b], 1);
    }
    return;
  }
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  const uintptr_t da = reinterpret_cast<uintptr_t>(dst);
  const long long head =
      ((sa ^ da) & 7u) == 0 ? min_<long long>((8 - (da & 7u)) & 7u, p.S)
                            : p.S;
  const long long words = (p.S - head) / 8;
  const long long tail = head + 8 * words;
  const long long mark = act ? slot : -1;   // the slot just extended
  FOR_LANES(G, t) {
    for (long long i = t; i < head; i += G) dst[i] = src[i] || i == mark;
    const uint64_t* sw = reinterpret_cast<const uint64_t*>(src + head);
    uint64_t* dw = reinterpret_cast<uint64_t*>(dst + head);
    for (long long k = t; k < words; k += G) {
      uint64_t v = sw[k];
      const long long in = mark - head - 8 * k;   // the mark's byte in it
      if (in >= 0 && in < 8) v |= 1ull << (8 * in);
      dw[k] = v;
    }
    for (long long i = tail + t; i < p.S; i += G)
      dst[i] = src[i] || i == mark;
  }
  if (group_leader<G>()) {
    p.n_regs_out[b] = add_(nr, static_cast<int32_t>(act));
    const int32_t cursor = p.cursor[b];
    p.cursor_out[b] = act ? add_(cursor, 1) : cursor;
  }
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

// the shared memory of a set-up group (one read): the seeds' window ends
// and sort keys, the chain of each seed (-1: none), the filter's order
// and its argsort
template <typename R>
LANE_HD inline long long setup_bytes(long long S, long long C) {
  return (2 * S * static_cast<long long>(sizeof(R)) + 8 * S + 8 * C + 15) &
         ~15LL;
}

template <typename R>
struct SetupSmem {
  R* b;             // [S] the seed's window start (in a chain)
  R* e;             // [S] its window end
  int32_t* key;     // [S] the sort key
  int32_t* chain;   // [S] the seed's chain, -1 outside one
  int32_t* forder;  // [C] the filter's order
  int32_t* crank;   // [C] its argsort: the rank of chain c
  LANE_HD SetupSmem(unsigned char* base, long long S, long long C)
      : b(reinterpret_cast<R*>(base)),
        e(reinterpret_cast<R*>(base) + S),
        key(reinterpret_cast<int32_t*>(base + 2 * S * sizeof(R))),
        chain(key + S),
        forder(chain + S),
        crank(forder + C) {}
};

// the set-up of read b (extend_setup_plain, one read) by a group of
// kSetupGroup threads
template <typename R>
GROUP_FN void setup_group(const SetupParams& p, long long b,
                          SetupSmem<R> sm) {
  constexpr auto G = kSetupGroup;
  const long long S = p.S, C = p.C;
  const long long row = b * S, crow = b * C;
  // the chains' ranks by the filter's order (a stable argsort of it)
  FOR_LANES(G, t) {
    for (long long j = t; j < C; j += G) sm.forder[j] = p.forder[crow + j];
  }
  group_sync<G>();
  FOR_LANES(G, t) {
    for (long long j = t; j < C; j += G) {
      const int32_t v = sm.forder[j];
      long long rank = 0;
      for (long long i = 0; i < C; ++i) {
        const int32_t u = sm.forder[i];
        rank += u < v || (u == v && i < j);
      }
      sm.crank[rank] = static_cast<int32_t>(j);
    }
  }
  group_sync<G>();
  // each seed's chain, key and window ends
  const int32_t lens = p.lens[b];
  const R big = static_cast<R>((sizeof(R) == 8 ? INT64_MAX : INT32_MAX) / 2);
  Lanes<int32_t, G> usable;
  FOR_LANES(G, t) {
    usable[t] = 0;
    for (long long s = t; s < S; s += G) {
      const long long at = row + s;
      const int32_t a = p.assign[at];
      const bool in = a >= 0;
      const int32_t c = static_cast<int32_t>(
          min_<long long>(max_<long long>(a, 0), C - 1));
      const bool valid = p.valid[at];
      const bool use = in && valid && p.kept[crow + c] > 0;
      p.cis[at] = c;
      p.ok[at] = valid && in;
      usable[t] += use;
      const int32_t q = p.qbeg[at], l = p.len[at];
      const int32_t sc = p.score != nullptr ? p.score[at] : mul_(l, p.o.match);
      sm.key[s] = use ? sm.crank[c] * (1 << 19) +
                            (4095 - min_(max_(sc, 0), 4095)) * (1 << 7) +
                            static_cast<int32_t>(S - 1 - s)
                      : kUnusable;
      sm.chain[s] = in ? c : -1;
      if (in) {
        const R r = static_cast<const R*>(p.rbeg)[at];
        const int32_t rem = sub_(sub_(lens, q), l);
        sm.b[s] = sub_(r, static_cast<R>(add_(q, max_gap<int32_t>(q, p.o))));
        sm.e[s] = add_(add_(add_(r, static_cast<R>(l)), static_cast<R>(rem)),
                       static_cast<R>(max_gap<int32_t>(rem, p.o)));
      }
    }
  }
  const int32_t n_usable = group_sum(usable);
  group_sync<G>();
  // the order: the stable argsort of the keys, by counting ranks
  FOR_LANES(G, t) {
    for (long long s = t; s < S; s += G) {
      const int32_t v = sm.key[s];
      long long rank = 0;
      for (long long i = 0; i < S; ++i) {
        const int32_t u = sm.key[i];
        rank += u < v || (u == v && i < s);
      }
      p.order[row + rank] = static_cast<int32_t>(s);
    }
  }
  // each chain's window over its seeds, then the strand and reference
  // clips of its first seed's side and reference
  const R l_pac = static_cast<R>(p.l_pac), seq_len = static_cast<R>(p.seq_len);
  FOR_LANES(G, t) {
    for (long long c = t; c < C; c += G) {
      R r0 = big, r1 = 0;
      for (long long s = 0; s < S; ++s) {
        if (sm.chain[s] != c) continue;
        r0 = min_(r0, sm.b[s]);
        r1 = max_(r1, sm.e[s]);
      }
      r0 = max_(r0, static_cast<R>(0));
      r1 = min_(r1, seq_len);
      const R first = static_cast<const R*>(p.f_rbeg)[crow + c];
      const bool crosses = r0 < l_pac && l_pac < r1;
      if (crosses && first < l_pac) r1 = l_pac;
      if (crosses && first >= l_pac) r0 = l_pac;
      const long long ref = min_<long long>(
          max_<long long>(p.crid[crow + c], 0), p.n_refs - 1);
      const R off = static_cast<const R*>(p.ref_offsets)[ref];
      const R rl = static_cast<const R*>(p.ref_lens)[ref];
      const bool rev = first >= l_pac;
      r0 = max_(r0, rev ? sub_(seq_len, add_(off, rl)) : off);
      r1 = min_(r1, rev ? sub_(seq_len, off) : add_(off, rl));
      static_cast<R*>(p.rmax0)[crow + c] = r0;
      static_cast<R*>(p.rmax1)[crow + c] = r1;
    }
  }
  if (group_leader<G>()) p.n_usable[b] = n_usable;
}

#ifdef __CUDACC__
template <typename R>
__global__ void __launch_bounds__(kScanThreads, kScanMinBlocks)
    extend_scan(const ScanParams p) {
  __shared__ ScanSmem<R> sm[kScanThreads / kScanGroup];
  __shared__ int n_act;   // the block's active reads
  if (threadIdx.x == 0) n_act = 0;
  __syncthreads();
  const int g = threadIdx.x / kScanGroup;
  const long long b =
      static_cast<long long>(blockIdx.x) * (kScanThreads / kScanGroup) + g;
  if (b < p.B && scan_group<R>(p, b, sm[g]) && group_leader<kScanGroup>())
    atomicAdd(&n_act, 1);
  __syncthreads();
  if (threadIdx.x == 0 && p.count != nullptr && n_act > 0)
    atomicAdd(p.count, n_act);
}

template <typename R>
__global__ void __launch_bounds__(kSetupGroup * kSetupReads)
    extend_setup(const SetupParams p, int reads) {
  extern __shared__ __align__(16) unsigned char setup_smem[];
  const int g = threadIdx.x / kSetupGroup;
  const long long b = static_cast<long long>(blockIdx.x) * reads + g;
  const long long bytes = setup_bytes<R>(p.S, p.C);
  if (g < reads && b < p.B)
    setup_group<R>(p, b, SetupSmem<R>(p.scratch != nullptr
                                          ? p.scratch + b * bytes
                                          : setup_smem + g * bytes,
                                      p.S, p.C));
}

template <typename R>
__global__ void __launch_bounds__(kThreads)
    extend_windows(const WinParams p) {
  const long long row = static_cast<long long>(blockIdx.x) *
                            (kThreads / kWarp) + threadIdx.x / kWarp;
  if (row < 2 * p.B) windows_row<R>(p, row, threadIdx.x % kWarp, kWarp);
}

template <typename R>
__global__ void __launch_bounds__(kThreads)
    extend_merge_left(const MergeParams p) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (b < p.B) merge_left_lane<R>(p, b);
}

template <typename R>
__global__ void __launch_bounds__(kMergeReads * kMergeGroup)
    extend_merge_right(const MergeParams p) {
  const long long b = static_cast<long long>(blockIdx.x) * kMergeReads +
                      threadIdx.x / kMergeGroup;
  if (b < p.B) merge_right_group<R>(p, b);
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
// launch kernel<R>, R from rank_bytes, on `stream` in blocks of `block`
// threads, `per` rows a block; the launch's error code
#define EXT_RUN(kernel, rows, per, block, p)                                 \
  do {                                                                       \
    const unsigned grid = blocks(rows, per);                                 \
    if (rank_bytes == 8)                                                     \
      kernel<long long><<<grid, (block), 0, stream>>>(p);                    \
    else                                                                     \
      kernel<int32_t><<<grid, (block), 0, stream>>>(p);                      \
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
  p.count = g.ptr<int32_t*>();
  p.B = g.num();
  p.S = g.num();
  p.C = g.num();
  p.Rg = g.num();
  p.o = opts(g);
  if (g.i != n || bad_rank(rank_bytes) || p.B < 1 || p.S < 1 || p.C < 1 ||
      p.Rg < 1 || p.Rg > kMaxRegs)
    return kRefused;
#ifdef __CUDACC__
  EXT_RUN(extend_scan, p.B, kScanThreads / kScanGroup, kScanThreads, p);
#else
  ScanSmem<long long> sm64;
  ScanSmem<int32_t> sm32;
  for (long long b = 0; b < p.B; ++b) {
    const bool act = rank_bytes == 8 ? scan_group<long long>(p, b, sm64)
                                     : scan_group<int32_t>(p, b, sm32);
    if (act && p.count != nullptr) ++*p.count;
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
  p.gate = g.ptr<const int32_t*>();
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
  EXT_RUN(extend_windows, 2 * p.B, kThreads / kWarp, kThreads, p);
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
  p.gate = g.ptr<const int32_t*>();
  merge_sizes(g, p);
  if (merge_refused(g, n, rank_bytes, p)) return kRefused;
#ifdef __CUDACC__
  EXT_RUN(extend_merge_left, p.B, kThreads, kThreads, p);
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
  p.gate = g.ptr<const int32_t*>();
  merge_sizes(g, p);
  // in place: every output its input, or none
  bool same = p.was_ext_out == p.was_ext && p.n_regs_out == p.n_regs &&
              p.cursor_out == p.cursor;
  bool apart = p.was_ext_out != p.was_ext && p.n_regs_out != p.n_regs &&
               p.cursor_out != p.cursor;
  for (int f = 0; f < 10; ++f) {
    same = same && p.regs_out[f] == p.regs[f];
    apart = apart && p.regs_out[f] != p.regs[f];
  }
  if (merge_refused(g, n, rank_bytes, p) || !(same || apart)) return kRefused;
#ifdef __CUDACC__
  EXT_RUN(extend_merge_right, p.B, kMergeReads, kMergeReads * kMergeGroup, p);
#else
  for (long long b = 0; b < p.B; ++b) {
    if (rank_bytes == 8)
      merge_right_group<long long>(p, b);
    else
      merge_right_group<int32_t>(p, b);
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
  EXT_RUN(extend_seedcov, p.B, kThreads, kThreads, p);
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

extern "C" int LANE_ENTRY(extend_setup)(const long long* a,
                                       long long n LANE_STREAM) {
  Args g{a, n, 0};
  const long long rank_bytes = g.num();
  SetupParams p;
  p.rbeg = g.ptr<const void*>();
  p.qbeg = g.ptr<const int32_t*>();
  p.len = g.ptr<const int32_t*>();
  p.valid = g.ptr<const uint8_t*>();
  p.score = g.ptr<const int32_t*>();
  p.assign = g.ptr<const int32_t*>();
  p.forder = g.ptr<const int32_t*>();
  p.kept = g.ptr<const int32_t*>();
  p.f_rbeg = g.ptr<const void*>();
  p.crid = g.ptr<const int32_t*>();
  p.lens = g.ptr<const int32_t*>();
  p.ref_offsets = g.ptr<const void*>();
  p.ref_lens = g.ptr<const void*>();
  p.order = g.ptr<int32_t*>();
  p.n_usable = g.ptr<int32_t*>();
  p.cis = g.ptr<int32_t*>();
  p.ok = g.ptr<uint8_t*>();
  p.rmax0 = g.ptr<void*>();
  p.rmax1 = g.ptr<void*>();
  p.scratch = g.ptr<unsigned char*>();
  p.B = g.num();
  p.S = g.num();
  p.C = g.num();
  p.n_refs = g.num();
  p.l_pac = g.num();
  p.seq_len = g.num();
  p.o = opts(g);
  if (g.i != n || bad_rank(rank_bytes) || p.B < 1 || p.S < 1 || p.C < 1 ||
      p.n_refs < 1)
    return kRefused;
  const long long bytes = rank_bytes == 8 ? setup_bytes<long long>(p.S, p.C)
                                          : setup_bytes<int32_t>(p.S, p.C);
  // a read's tables past a block's shared memory live in the scratch
  if ((bytes > kSetupSmem) != (p.scratch != nullptr)) return kRefused;
  const int reads = static_cast<int>(
      p.scratch != nullptr ? kSetupReads
                           : min_<long long>(kSetupReads, kSetupSmem / bytes));
#ifdef __CUDACC__
  const unsigned grid = blocks(p.B, reads);
  const unsigned smem =
      p.scratch != nullptr ? 0u : static_cast<unsigned>(reads * bytes);
  if (rank_bytes == 8)
    extend_setup<long long><<<grid, kSetupGroup * reads, smem, stream>>>(
        p, reads);
  else
    extend_setup<int32_t><<<grid, kSetupGroup * reads, smem, stream>>>(
        p, reads);
  return static_cast<int>(cudaGetLastError());
#else
  (void)reads;
  unsigned char* buf = p.scratch != nullptr ? nullptr
                                            : new unsigned char[bytes];
  for (long long b = 0; b < p.B; ++b) {
    unsigned char* at = p.scratch != nullptr ? p.scratch + b * bytes : buf;
    if (rank_bytes == 8)
      setup_group<long long>(p, b, SetupSmem<long long>(at, p.S, p.C));
    else
      setup_group<int32_t>(p, b, SetupSmem<int32_t>(at, p.S, p.C));
  }
  delete[] buf;
  return 0;
#endif
}
