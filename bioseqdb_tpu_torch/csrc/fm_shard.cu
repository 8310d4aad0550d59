// The index mesh's owner-sum loops for Hopper: the FM seeding machine, the
// SA walk and the exact backward search over an index whose Occ and
// SA-mark tables are split by row range across the ranks of a process
// group (dist/shard_index.py).
//
// Replaces the TPU program of bioseqdb_tpu/kernels/seed.py
// collect_seeds_device under shard_axis (its lax.while_loop, the owner sums
// at :736-743), of bioseqdb_tpu/kernels/fm.py sa_resolve under
// shard_axis (its lax.fori_loop at :536 over lf_step :491, then _sa_slot
// :462) and of bioseqdb_tpu/dist/shard_index.py backward_search_sharded
// (:155, its lax.fori_loop at :164-181). XLA compiled those loops, each
// step's psum inside, into the one TPU device program; no Pallas. On the card a step's owner sum is an
// all_reduce between processes, which no launch can hold, so every step is
// two launches with the all_reduce between them:
// - a query launch: this rank's partial of every value the step sums,
//   zero where the rank does not own the table row (kernels/fm.py
//   _local_row), into a buffer of exactly the shape and dtype that
//   kernels/fm.py _owner_sums stacks, so the collective's bytes stay the
//   plain twin's;
// - the all_reduce over the index group (kernels/fm.py _all_reduce), in
//   place on that buffer;
// - an apply launch: the step's update from the summed values.
// The kernels compute exactly what the plain twins compute step for step:
// kernels/seed.py _plain_machine's body under a group (no fetch sharing, no
// split-row stalls, no jump), kernels/fm.py sa_resolve_plain and
// backward_search_plain under a group. The host loop around them is the plain machine's own (the live
// lanes compacted every CHUNK steps), so every rank of the group makes the
// same launches and collectives on the same shapes.
//
// What bounds a step: its all_reduce. Each launch moves a few hundred bytes
// a lane (the lane's state, two 48-byte Occ rows or two major rows, the
// buffer) and lasts microseconds; the collective between them takes
// milliseconds under gloo (PERF.md row 18).
//
// Design, a simple kernel first:
// - A thread a lane, 128 threads a block. The machine's state lives in
//   device memory as the plain machine's tensors (kernels/seed.py
//   _machine_state): phase, round, x, i, j, ik, ik_end, the cand / prev /
//   curr stacks of P rows (k, s, end) and their counts, ret, rev1,
//   min_intv, r2i, last_start, the mems, n_mem, n_mem_r1, iters, it_r1,
//   it_r2, overflow. The plain version's whole-stack copies "prev = cand"
//   and "prev = curr" are copies of the lane's P x 3 rows here too.
// - The query runs the budget check, iters and the pivot step, writes
//   back the fields they can change, and the partials of occ4 at a and
//   a + s (a stored position's checkpoints plus its row's counts of the
//   four codes) for every lane in a pass; a finished lane, or one still
//   at its pivot, gets zero partials and reads no Occ row, since the
//   apply leaves it as it is (the plain step queries every lane and drops
//   those sums). The apply re-derives the step's source interval from the
//   post-pivot state, adds the major checkpoints (whole on every rank,
//   outside the sum), runs the FMD extension and the rest of the step,
//   and writes back the fields those can change.
// - The SA walk's query writes the mark-bit partial and the LF value's
//   (its major inside the sum: the code is decoded from the row, a dummy
//   on a rank that does not own it) as int64 [2, n]; the apply moves the
//   unmarked lanes one LF step. A mode argument gives the slot's round:
//   the popcount of the mark words before the rank (each word masked by
//   its owner) and the group's count, as int32 [2, n]; its apply adds the
//   major and writes the sample plus the steps, 0 off the lane mask.
// - The backward search (kernels/fm.py search_sharded), W steps over every
//   read, a thread a read: step t's query takes the read's column
//   lens - 1 - t and, where the step extends it (live, lo < hi, a base),
//   this rank's partial occ of its code at lo and at hi (the row's
//   checkpoint plus its count, zero off the rank's Occ rows; zero for a
//   read the step leaves) into the twin's int32 [1, 2B] buffer, lo first;
//   the apply adds the major rows and L2[c] + 1, kills a read at an
//   ambiguous base (lo = hi = 1), and after the last step applies the
//   empty rule. The step index is an argument the host loop rewrites.
// - Ranks and rank-valued state take the template type R (int32 or int64,
//   the index's rank dtype). Table rows are clamped where XLA's gathers
//   clamp them; sums are cast to R, so they wrap as the tensors' do.
// - The lane bodies are LANE_HD (lanes.cuh): compiled by a host compiler
//   the file gives entries fm_shard_query_host, ... that run every lane in
//   turn, which the CPU tests run through the same host loop in gloo ranks.

#include "lanes.cuh"
#include "occ.cuh"

namespace {

// phases and rounds: bioseqdb_tpu_torch/kernels/seed.py's
constexpr int PH_PIVOT = 0;
constexpr int PH_FWD = 1;
constexpr int PH_BWD = 2;
constexpr int PH_R3 = 3;
constexpr int PH_DONE = 4;
constexpr int RD_SMEM = 0;
constexpr int RD_RESEED = 1;
constexpr int RD_LAST = 2;

constexpr int kThreads = 128;   // a block: a lane a thread
constexpr int kRefused = 1;     // cudaErrorInvalidValue
constexpr long long kMachineArgs = 48;  // kernels/fm_shard_cuda.py machine_args
constexpr long long kSaArgs = 23;       // kernels/fm_shard_cuda.py sa_args
constexpr long long kBsArgs = 16;       // kernels/fm_shard_cuda.py bs_args

// the FM machine's call: its sizes and options, the tables, the owner-sum
// buffer and the state tensors of the call's lanes (B of them)
struct MParams {
  long long rank_bytes, B, W, M, P;
  long long n_octo;     // this rank's octo rows of the Occ table
  long long shard;      // this rank's index in the group
  long long n_major, primary, max_iters, min_seed_len, split_len,
      split_width, max_mem_intv;
  const int32_t* occ_rows;  // [n_octo * 8, 12] this rank's shard
  const void* occ_majors;   // [n_major, 4] R, whole
  const void* L2;           // [5] R
  int32_t* buf;             // [2B, 4]: the partials at a, then at a + s
  const int32_t* codes;     // [B, W]
  const int32_t* lens;      // [B]
  int32_t* phase;
  int32_t* round;
  int32_t* x;
  int32_t* i;
  int32_t* j;
  void* ik;                 // [B, 3] R: k, l, s
  int32_t* ik_end;
  void* cand;               // [B, P, 3] R: k, s, end
  int32_t* n_cand;
  void* prev;
  int32_t* n_prev;
  void* curr;
  int32_t* n_curr;
  int32_t* ret;
  uint8_t* rev1;            // torch.bool
  void* min_intv;           // [B] R
  int32_t* r2i;
  int32_t* last_start;
  void* mem_k;              // [B, M] R
  void* mem_s;
  void* mem_b;
  void* mem_e;
  int32_t* n_mem;
  int32_t* n_mem_r1;
  int32_t* iters;
  int32_t* it_r1;
  int32_t* it_r2;
  uint8_t* overflow;        // torch.bool
};

// the SA walk's call: n rank lanes, mode 0 an LF step, 1 the slot
struct SParams {
  long long rank_bytes, n, mode, shard;
  long long n_octo, n_major, n_words, n_cnt, n_sa_major, n_sample, primary;
  const int32_t* occ_rows;  // this rank's shard
  const void* occ_majors;   // whole
  const void* L2;
  const int32_t* sa_words;  // [n_words] this rank's shard of the mark bitmap
  const int32_t* sa_cnt;    // [n_cnt] this rank's shard
  const void* sa_majors;    // whole
  const void* sa_sample;    // whole
  void* r;                  // [n] R: the walk's ranks, in place
  void* steps;              // [n] R: its LF steps, in place
  void* buf;                // mode 0: int64 [2, n]; mode 1: int32 [2, n]
  const uint8_t* mask;      // [n] torch.bool, or null
  void* pos;                // [n] R, out (the slot's apply)
};

// the backward search's step t: B reads of W columns, their intervals in
// place
struct BParams {
  long long rank_bytes, B, W, t, shard, n_octo, n_major, primary;
  const int32_t* occ_rows;  // [n_octo * 8, 12] this rank's shard
  const void* occ_majors;   // [n_major, 4] R, whole
  const void* L2;           // [5] R
  const int32_t* codes;     // [B, W]
  const int32_t* lens;      // [B]
  void* lo;                 // [B] R, in place
  void* hi;                 // [B] R, in place
  int32_t* buf;             // [2B]: the partials at lo, then at hi
};

// kernels/fm.py _local_row under a group: the row of global row idx in
// this rank's shard of `rows` rows (clamped), and whether the rank owns it
struct Local {
  long long row;
  bool mine;
};

LANE_HD inline Local local_row(long long idx, long long shard,
                               long long rows) {
  const long long l = idx - shard * rows;
  return Local{clampv<long long>(l, 0, rows - 1), l >= 0 && l < rows};
}

// the Occ row of conceptual rank r in this rank's shard (kernels/fm.py
// occ_rows_for / _block_row under a group), its offset and the global
// block (for the major row)
template <typename R>
struct ShardRow {
  const int32_t* row;
  int off;
  R blk;
  bool mine;
};

template <typename R>
LANE_HD inline ShardRow<R> shard_row(const int32_t* occ_rows,
                                     long long n_octo, long long shard, R r,
                                     R primary) {
  const R jr = r - static_cast<R>(r > primary);
  const R blk = jr >> kLog2OccBlock;
  const Local o = local_row(static_cast<long long>(blk >> 3), shard, n_octo);
  return ShardRow<R>{occ_rows + (o.row * 8 + static_cast<long long>(blk & 7))
                                    * 12,
                     static_cast<int>(jr & 127), blk, o.mine};
}

template <typename R>
LANE_HD inline R cast(long long v) { return static_cast<R>(v); }

// ---- the FM machine ----

// a lane's scalar state (the plain machine's per-lane tensors)
template <typename R>
struct Lane {
  int phase, rnd, x, i, j, ik_end, n_cand, n_prev, n_curr, ret, r2i,
      last_start, n_mem, n_mem_r1, iters, it_r1, it_r2;
  bool rev1, overflow;
  R ik_k, ik_l, ik_s, min_intv;
};

template <typename R>
LANE_HD inline Lane<R> load_lane(const MParams& p, long long b) {
  const R* ik = static_cast<const R*>(p.ik) + 3 * b;
  return Lane<R>{p.phase[b],    p.round[b],  p.x[b],         p.i[b],
                 p.j[b],        p.ik_end[b], p.n_cand[b],    p.n_prev[b],
                 p.n_curr[b],   p.ret[b],    p.r2i[b],       p.last_start[b],
                 p.n_mem[b],    p.n_mem_r1[b], p.iters[b],   p.it_r1[b],
                 p.it_r2[b],    p.rev1[b] != 0, p.overflow[b] != 0,
                 ik[0],         ik[1],       ik[2],
                 static_cast<const R*>(p.min_intv)[b]};
}

// the fields the query can change (the budget and the pivot step)
template <typename R>
LANE_HD inline void store_query(const MParams& p, long long b,
                                const Lane<R>& s) {
  p.phase[b] = s.phase;
  p.round[b] = s.rnd;
  p.x[b] = s.x;
  p.i[b] = s.i;
  p.ik_end[b] = s.ik_end;
  p.n_cand[b] = s.n_cand;
  p.r2i[b] = s.r2i;
  p.n_mem_r1[b] = s.n_mem_r1;
  p.iters[b] = s.iters;
  p.it_r1[b] = s.it_r1;
  p.it_r2[b] = s.it_r2;
  p.overflow[b] = s.overflow ? 1 : 0;
  R* ik = static_cast<R*>(p.ik) + 3 * b;
  ik[0] = s.ik_k;
  ik[1] = s.ik_l;
  ik[2] = s.ik_s;
  static_cast<R*>(p.min_intv)[b] = s.min_intv;
}

// the fields the apply can change (the extension and the passes)
template <typename R>
LANE_HD inline void store_apply(const MParams& p, long long b,
                                const Lane<R>& s) {
  p.phase[b] = s.phase;
  p.x[b] = s.x;
  p.i[b] = s.i;
  p.j[b] = s.j;
  p.ik_end[b] = s.ik_end;
  p.n_cand[b] = s.n_cand;
  p.n_prev[b] = s.n_prev;
  p.n_curr[b] = s.n_curr;
  p.ret[b] = s.ret;
  p.r2i[b] = s.r2i;
  p.last_start[b] = s.last_start;
  p.n_mem[b] = s.n_mem;
  p.rev1[b] = s.rev1 ? 1 : 0;
  p.overflow[b] = s.overflow ? 1 : 0;
  R* ik = static_cast<R*>(p.ik) + 3 * b;
  ik[0] = s.ik_k;
  ik[1] = s.ik_l;
  ik[2] = s.ik_s;
}

// row `row` (k, s, end) of lane b's stack `st`
template <typename R>
LANE_HD inline R* stack_row(void* st, const MParams& p, long long b,
                            int row) {
  return static_cast<R*>(st) + (b * p.P + row) * 3;
}

template <typename R>
LANE_HD inline void copy_stack(void* dst, const void* src, const MParams& p,
                               long long b) {
  R* d = static_cast<R*>(dst) + b * p.P * 3;
  const R* s = static_cast<const R*>(src) + b * p.P * 3;
  for (long long k = 0; k < p.P * 3; ++k) d[k] = s[k];
}

// the code at column pos of read b, clamped: 0..3 a base, >= 4 ambiguous
LANE_HD inline int qat(const MParams& p, long long b, int pos) {
  return p.codes[b * p.W + clampv<long long>(pos, 0, p.W - 1)];
}

template <typename R>
LANE_HD inline void set_intv(const R* L2, Lane<R>& s, int c) {
  c = clampv(c, 0, 3);
  s.ik_k = L2[c] + 1;
  s.ik_l = L2[3 - c] + 1;
  s.ik_s = L2[c + 1] - L2[c];
}

// kernels/seed.py _plain_machine pivot_step for a lane at PH_PIVOT
template <typename R>
LANE_HD void pivot(const MParams& p, long long b, Lane<R>& s) {
  const R* L2 = static_cast<const R*>(p.L2);
  const int L = p.lens[b];
  const int qx = qat(p, b, s.x);
  if (s.rnd == RD_SMEM && s.x >= L) {   // round 1 done: round 2
    s.rnd = RD_RESEED;
    s.n_mem_r1 = s.n_mem;
    s.r2i = 0;
    s.it_r1 = s.iters;
  }
  bool go2 = false;
  R r2_s = 0, r2_b = 0, r2_e = 0;
  if (s.rnd == RD_RESEED) {
    const long long r2x = b * p.M + clampv<long long>(s.r2i, 0, p.M - 1);
    r2_s = static_cast<const R*>(p.mem_s)[r2x];
    r2_b = static_cast<const R*>(p.mem_b)[r2x];
    r2_e = static_cast<const R*>(p.mem_e)[r2x];
    const bool eligible =
        (r2_e - r2_b) >= p.split_len && r2_s <= p.split_width;
    if (s.r2i >= s.n_mem_r1) {          // round 2 exhausted: round 3
      s.rnd = RD_LAST;
      s.x = 0;
      s.it_r2 = s.iters;
    } else if (!eligible) {
      ++s.r2i;
    } else {
      go2 = true;
    }
  }
  const bool at_r3 = s.rnd == RD_LAST;
  const bool r3_off = at_r3 && (p.max_mem_intv <= 0 || s.x >= L);
  if (r3_off) s.phase = PH_DONE;
  bool go1 = false;
  if (s.rnd == RD_SMEM && s.x < L) {
    if (qx >= 4) ++s.x;
    else go1 = true;
  }
  if (go2) {
    s.x = static_cast<int>((r2_b + r2_e) >> 1);
    s.min_intv = r2_s + 1;
  } else if (go1) {
    s.min_intv = 1;
  }
  bool go = go1 || go2;
  const int qpiv = qat(p, b, s.x);
  if (go2 && qpiv >= 4) {   // a re-seed pivot on an N: skip it
    ++s.r2i;
    go = false;
  }
  if (go) {
    set_intv(L2, s, qpiv);
    s.ik_end = s.x + 1;
    s.i = s.x + 1;
    s.n_cand = 0;
    s.phase = PH_FWD;
  }
  if (at_r3 && !r3_off && p.max_mem_intv > 0) {
    const int q3 = qat(p, b, s.x);
    if (q3 >= 4) {
      ++s.x;
    } else {
      set_intv(L2, s, q3);
      s.i = s.x + 1;
      s.phase = PH_R3;
    }
  }
}

// the step's source interval from the post-pivot state: the backward
// pass's prev row (rev1's order) or the current bi-interval, (a, b, s)
// with s clamped at 0, and the two ranks the step queries, a and a + s
template <typename R>
struct Source {
  R a, bb, s_eff, posB, bwd_k, bwd_s, bwd_end;
  int qi;
  bool in_fwd, in_bwd, in_r3;
};

template <typename R>
LANE_HD inline Source<R> source(const MParams& p, long long b,
                                const Lane<R>& s) {
  Source<R> o;
  o.qi = qat(p, b, s.i);
  o.in_fwd = s.phase == PH_FWD;
  o.in_bwd = s.phase == PH_BWD;
  o.in_r3 = s.phase == PH_R3;
  const int j_eff = s.rev1 ? s.n_prev - 1 - s.j : s.j;
  const R* row = stack_row<R>(p.prev, p, b,
                              clampv(j_eff, 0, static_cast<int>(p.P) - 1));
  o.bwd_k = row[0];
  o.bwd_s = row[1];
  o.bwd_end = row[2];
  o.a = o.in_bwd ? o.bwd_k : s.ik_l;
  o.bb = o.in_bwd ? static_cast<R>(0) : s.ik_k;
  const R src_s = o.in_bwd ? o.bwd_s : s.ik_s;
  o.s_eff = src_s < 0 ? static_cast<R>(0) : src_s;
  o.posB = cast<R>(static_cast<long long>(o.a) + o.s_eff);
  return o;
}

// this rank's partial of occ4 at conceptual rank r into buf row `slot`:
// each code's checkpoint plus its count in the row's first off bases where
// the rank owns the row, else 0 (kernels/fm.py occ4_from_row's owner sum)
template <typename R>
GROUP_FN inline void occ_partial(const MParams& p, R r, long long slot) {
  const ShardRow<R> x = shard_row<R>(p.occ_rows, p.n_octo, p.shard, r,
                                     static_cast<R>(p.primary));
  int32_t* out = p.buf + slot * 4;
  if (!x.mine) {
    for (int c = 0; c < 4; ++c) out[c] = 0;
    return;
  }
  const OccWords ws = load_words(x.row);
  for (int c = 0; c < 4; ++c)
    out[c] = static_cast<int32_t>(static_cast<uint32_t>(__ldg(x.row + c)) +
                                  static_cast<uint32_t>(
                                      count_code(ws, c, x.off)));
}

// zero partials for lane b: the apply leaves a lane that is not in a pass
// as it is, so its sums are never read
GROUP_FN inline void no_partials(const MParams& p, long long b) {
  for (int c = 0; c < 4; ++c) {
    p.buf[b * 4 + c] = 0;
    p.buf[(p.B + b) * 4 + c] = 0;
  }
}

// the query for lane b: the budget, iters, the pivot step; the changed
// state written back and the partials at a and a + s (zero for a lane in
// no pass, finished or still at its pivot)
template <typename R>
GROUP_FN void machine_query_lane(const MParams& p, long long b) {
  if (p.phase[b] == PH_DONE) {
    no_partials(p, b);
    return;
  }
  Lane<R> s = load_lane<R>(p, b);
  if (s.iters >= p.max_iters) {   // the budget
    s.overflow = true;
    s.phase = PH_DONE;
  } else {
    ++s.iters;
  }
  if (s.phase == PH_PIVOT) pivot<R>(p, b, s);
  store_query<R>(p, b, s);
  if (s.phase != PH_FWD && s.phase != PH_BWD && s.phase != PH_R3) {
    no_partials(p, b);
    return;
  }
  const Source<R> src = source<R>(p, b, s);
  occ_partial<R>(p, src.a, b);
  occ_partial<R>(p, src.posB, p.B + b);
}

// push a mem row (k, s, begin, end) of lane b, or overflow
template <typename R>
LANE_HD inline void push_mem(const MParams& p, long long b, Lane<R>& s, R k,
                             R sz, R beg, R end) {
  if (s.n_mem >= p.M) {
    s.overflow = true;
    return;
  }
  const long long at = b * p.M + s.n_mem;
  static_cast<R*>(p.mem_k)[at] = k;
  static_cast<R*>(p.mem_s)[at] = sz;
  static_cast<R*>(p.mem_b)[at] = beg;
  static_cast<R*>(p.mem_e)[at] = end;
  ++s.n_mem;
}

// the apply for lane b: occ4 at a and a + s from the summed partials and
// the major rows, the FMD extension (kernels/fm.py fmd_extend_from_occ)
// by the step's code, and the rest of kernels/seed.py's body
template <typename R>
GROUP_FN void machine_apply_lane(const MParams& p, long long b) {
  const int ph = p.phase[b];
  if (ph != PH_FWD && ph != PH_BWD && ph != PH_R3) return;   // no pass
  Lane<R> s = load_lane<R>(p, b);
  const Source<R> src = source<R>(p, b, s);
  const R* L2 = static_cast<const R*>(p.L2);
  const R* majors = static_cast<const R*>(p.occ_majors);
  const R primary = static_cast<R>(p.primary);
  const int P = static_cast<int>(p.P);
  const int L = p.lens[b];
  const int qi = src.qi;
  const bool qok = qi < 4;

  R o1[4], cnt[4];
  {
    const R ja = src.a - static_cast<R>(src.a > primary);
    const R jb = src.posB - static_cast<R>(src.posB > primary);
    const R* ma = majors + major_index(ja >> kLog2OccBlock, p.n_major) * 4;
    const R* mb = majors + major_index(jb >> kLog2OccBlock, p.n_major) * 4;
    for (int c = 0; c < 4; ++c) {
      o1[c] = cast<R>(static_cast<long long>(p.buf[b * 4 + c]) + ma[c]);
      const R o2 =
          cast<R>(static_cast<long long>(p.buf[(p.B + b) * 4 + c]) + mb[c]);
      cnt[c] = o2 - o1[c];
    }
  }
  const int csel = clampv(src.in_bwd ? qi : 3 - qi, 0, 3);
  const R dollar =
      static_cast<R>(src.a <= primary && primary < src.posB);
  R suffix = 0;
  for (int c = csel + 1; c < 4; ++c) suffix += cnt[c];
  const R k4 = L2[csel] + 1 + o1[csel];
  const R l4 = src.bb + dollar + suffix;
  const R ok_k = src.in_bwd ? k4 : l4;
  const R ok_l = src.in_bwd ? l4 : k4;
  const R ok_s = cnt[csel];
  const int i = s.i;

  if (src.in_fwd) {          // forward pass of smem1
    const bool fwd_end = i >= L;
    const bool fwd_amb = i < L && qi >= 4;
    const bool fwd_ext = i < L && qok;
    const bool size_change = fwd_ext && ok_s != s.ik_s;
    if (fwd_end || fwd_amb || size_change) {
      if (s.n_cand >= P) {
        s.overflow = true;
      } else {
        R* row = stack_row<R>(p.cand, p, b, s.n_cand);
        row[0] = s.ik_k;
        row[1] = s.ik_s;
        row[2] = static_cast<R>(s.ik_end);
        ++s.n_cand;
      }
    }
    const bool drop_below = size_change && ok_s < s.min_intv;
    if (fwd_ext && !drop_below) {
      s.ik_k = ok_k;
      s.ik_l = ok_l;
      s.ik_s = ok_s;
      s.ik_end = i + 1;
      s.i = i + 1;
    }
    if (fwd_end || fwd_amb || drop_below) {   // prev = cand
      copy_stack<R>(p.prev, p.cand, p, b);
      s.n_prev = s.n_cand;
      s.rev1 = true;
      s.ret = static_cast<int>(
          stack_row<R>(p.cand, p, b, clampv(s.n_cand - 1, 0, P - 1))[2]);
      s.i = s.x - 1;
      s.j = 0;
      s.n_curr = 0;
      s.last_start = static_cast<int>(p.W) + 1;
      s.phase = PH_BWD;
    }
  } else if (src.in_bwd) {   // backward pass: one candidate a step
    const int bw_i = i;
    const bool c_ok = bw_i >= 0 && qok;
    const int ncr = s.n_curr;
    const R last_s = stack_row<R>(p.curr, p, b, clampv(ncr - 1, 0, P - 1))[1];
    const bool fail = !c_ok || ok_s < s.min_intv;
    const bool emit = fail && ncr == 0 && bw_i + 1 < s.last_start &&
                      (src.bwd_end - static_cast<R>(bw_i + 1)) >=
                          p.min_seed_len;
    if (emit) {
      s.last_start = bw_i + 1;
      push_mem<R>(p, b, s, src.bwd_k, src.bwd_s, static_cast<R>(bw_i + 1),
                  src.bwd_end);
    }
    const bool keep = c_ok && ok_s >= s.min_intv;
    if (keep && (ncr == 0 || ok_s != last_s)) {
      if (ncr >= P) {
        s.overflow = true;
      } else {
        R* row = stack_row<R>(p.curr, p, b, ncr);
        row[0] = ok_k;
        row[1] = ok_s;
        row[2] = src.bwd_end;
        ++s.n_curr;
      }
    }
    const int nj = s.j + 1;
    const bool dead = bw_i < 0 || qi >= 4;
    const bool row_done = nj >= s.n_prev || dead;
    s.j = row_done ? 0 : nj;
    if (row_done && s.n_curr == 0) {          // this pivot is finished
      s.phase = PH_PIVOT;
      if (s.rnd == RD_SMEM) s.x = s.ret;
      if (s.rnd == RD_RESEED) ++s.r2i;
    } else if (row_done) {                    // prev = curr: the next row
      copy_stack<R>(p.prev, p.curr, p, b);
      s.n_prev = s.n_curr;
      s.rev1 = false;
      s.n_curr = 0;
      s.i = bw_i - 1;
    }
  } else if (src.in_r3) {    // round 3: the LAST-like forward scan
    const bool r3_end = i >= L;
    const bool r3_amb = i < L && qi >= 4;
    const bool r3_ext = i < L && qok;
    const bool hit = r3_ext && ok_s < p.max_mem_intv &&
                     (i - s.x) >= p.min_seed_len;
    if (hit && ok_s > 0)
      push_mem<R>(p, b, s, ok_k, ok_s, static_cast<R>(s.x),
                  static_cast<R>(i + 1));
    if (r3_end || r3_amb || hit) {
      s.x = r3_end ? L : i + 1;
      s.phase = PH_PIVOT;
    }
    if (r3_ext && !hit) {
      s.ik_k = ok_k;
      s.ik_l = ok_l;
      s.ik_s = ok_s;
      s.i = i + 1;
    }
  }
  store_apply<R>(p, b, s);
}

// ---- the SA walk ----

// mode 0: the mark bit's partial and the LF value's (int64 [2, n]);
// mode 1: the slot's popcount part and the group's count (int32 [2, n])
template <typename R>
GROUP_FN void sa_query_lane(const SParams& p, long long k) {
  const R r = static_cast<const R*>(p.r)[k];
  if (p.mode == 0) {
    int64_t* out = static_cast<int64_t*>(p.buf);
    // kernels/fm.py _sa_mark_bit
    const Local w = local_row(static_cast<long long>(r >> 5), p.shard,
                              p.n_words);
    const uint32_t word = static_cast<uint32_t>(__ldg(p.sa_words + w.row));
    out[k] = w.mine ? static_cast<int64_t>((word >> static_cast<int>(r & 31))
                                           & 1u)
                    : 0;
    // kernels/fm.py _lf_value: the code read from the row (a dummy where
    // the rank does not own it), the major inside the sum
    const R primary = static_cast<R>(p.primary);
    const ShardRow<R> x = shard_row<R>(p.occ_rows, p.n_octo, p.shard, r,
                                       primary);
    const OccWords ws = load_words(x.row);
    uint32_t cw = 0;
    for (int t = 0; t < 8; ++t) {
      if (t == (x.off >> 4)) cw = ws.w[t];
    }
    const int c = static_cast<int>((cw >> (2 * (15 - (x.off & 15)))) & 3u);
    const R* L2 = static_cast<const R*>(p.L2);
    const R major = static_cast<const R*>(
        p.occ_majors)[major_index(x.blk, p.n_major) * 4 + c];
    const R lf = cast<R>(static_cast<long long>(L2[c]) + __ldg(x.row + c) +
                         count_code(ws, c, x.off) + 1 +
                         static_cast<long long>(major));
    out[p.n + k] = x.mine ? static_cast<int64_t>(lf) : 0;
  } else {
    int32_t* out = static_cast<int32_t*>(p.buf);
    // kernels/fm.py _sa_slot: each mark word masked by its owner
    const long long r5 = static_cast<long long>(r >> 7);
    const int wsel = static_cast<int>((r >> 5) & 3);
    const int bits = static_cast<int>(r & 31);
    uint32_t part = 0;
    for (int t = 0; t < 4; ++t) {
      const Local w = local_row(r5 * 4 + t, p.shard, p.n_words);
      const uint32_t word = static_cast<uint32_t>(__ldg(p.sa_words + w.row));
      const uint32_t m =
          t < wsel ? 0xFFFFFFFFu : (t == wsel ? (1u << bits) - 1u : 0u);
      if (w.mine) part += static_cast<uint32_t>(popc32(word & m));
    }
    const Local cn = local_row(r5, p.shard, p.n_cnt);
    out[k] = static_cast<int32_t>(part);
    out[p.n + k] = cn.mine ? __ldg(p.sa_cnt + cn.row) : 0;
  }
}

// mode 0: a lane whose rank is unmarked takes its LF step (rank 0 at the
// primary); mode 1: the slot's sample plus the steps, 0 off the mask
template <typename R>
GROUP_FN void sa_apply_lane(const SParams& p, long long k) {
  R* r = static_cast<R*>(p.r) + k;
  R* steps = static_cast<R*>(p.steps) + k;
  if (p.mode == 0) {
    const int64_t* in = static_cast<const int64_t*>(p.buf);
    if (in[k] != 0) return;   // marked: the lane keeps its rank
    const R lf = static_cast<R>(in[p.n + k]);
    *r = *r == static_cast<R>(p.primary) ? static_cast<R>(0) : lf;
    *steps = *steps + 1;
  } else {
    const int32_t* in = static_cast<const int32_t*>(p.buf);
    R* pos = static_cast<R*>(p.pos) + k;
    if (p.mask != nullptr && p.mask[k] == 0) {
      *pos = 0;
      return;
    }
    const long long r5 = static_cast<long long>(*r >> 7);
    const R major = static_cast<const R*>(p.sa_majors)[clampv<long long>(
        r5 >> kLog2Major, 0, p.n_sa_major - 1)];
    const int32_t part = static_cast<int32_t>(
        static_cast<uint32_t>(in[k]) + static_cast<uint32_t>(in[p.n + k]));
    const R slot = cast<R>(static_cast<long long>(part) + major);
    const R sample = static_cast<const R*>(p.sa_sample)[clampv<long long>(
        static_cast<long long>(slot), 0, p.n_sample - 1)];
    *pos = sample + *steps;
  }
}

// ---- the backward search ----

// step t of read b: its code (column lens - 1 - t, clamped), whether the
// read reaches the step, and whether the step extends its interval
struct BsStep {
  int c;
  bool live, active;
};

template <typename R>
LANE_HD inline BsStep bs_step(const BParams& p, long long b, R lo, R hi) {
  const long long L = p.lens[b];
  const int c = p.codes[b * p.W + clampv<long long>(L - 1 - p.t, 0,
                                                     p.W - 1)];
  const bool live = p.t < L;
  return BsStep{c, live, live && lo < hi && c < 4};
}

// this rank's partial of occ(c, r) (kernels/fm.py occ_stored's owner sum):
// the checkpoint plus the count where the rank owns the row, else 0
template <typename R>
GROUP_FN inline int32_t occ_part(const BParams& p, R r, int c) {
  const ShardRow<R> x = shard_row<R>(p.occ_rows, p.n_octo, p.shard, r,
                                     static_cast<R>(p.primary));
  if (!x.mine) return 0;
  return static_cast<int32_t>(
      static_cast<uint32_t>(__ldg(x.row + c)) +
      static_cast<uint32_t>(count_code(load_words(x.row), c, x.off)));
}

template <typename R>
GROUP_FN void bs_query_lane(const BParams& p, long long b) {
  const R lo = static_cast<const R*>(p.lo)[b];
  const R hi = static_cast<const R*>(p.hi)[b];
  const BsStep s = bs_step<R>(p, b, lo, hi);
  const int c = clampv(s.c, 0, 3);
  p.buf[b] = s.active ? occ_part<R>(p, lo, c) : 0;
  p.buf[p.B + b] = s.active ? occ_part<R>(p, hi, c) : 0;
}

// occ(c, r) from its summed partial: the major checkpoint added
template <typename R>
LANE_HD inline R occ_summed(const BParams& p, R r, int c, int32_t part) {
  const R jr = r - static_cast<R>(r > static_cast<R>(p.primary));
  const R major = static_cast<const R*>(p.occ_majors)[
      major_index(jr >> kLog2OccBlock, p.n_major) * 4 + c];
  return cast<R>(static_cast<long long>(part) +
                 static_cast<long long>(major));
}

template <typename R>
GROUP_FN void bs_apply_lane(const BParams& p, long long b) {
  R* lo = static_cast<R*>(p.lo) + b;
  R* hi = static_cast<R*>(p.hi) + b;
  R l = *lo, h = *hi;
  const BsStep s = bs_step<R>(p, b, l, h);
  if (s.active) {   // kernels/fm.py backward_ext
    const int c = clampv(s.c, 0, 3);
    const R C = static_cast<const R*>(p.L2)[c] + 1;
    l = cast<R>(static_cast<long long>(C) +
                occ_summed<R>(p, l, c, p.buf[b]));
    h = cast<R>(static_cast<long long>(C) +
                occ_summed<R>(p, h, c, p.buf[p.B + b]));
  } else if (s.live && s.c >= 4) {   // an ambiguous base kills the match
    l = 1;
    h = 1;
  }
  if (p.t == p.W - 1 && (h <= l || p.lens[b] == 0)) {   // the empty rule
    l = 0;
    h = 0;
  }
  *lo = l;
  *hi = h;
}

// ---- the entries' argument arrays ----

template <typename T>
inline T* ptr(long long v) {
  return reinterpret_cast<T*>(static_cast<intptr_t>(v));
}

inline bool machine_params(const long long* a, long long n_args,
                           MParams& p) {
  if (n_args != kMachineArgs) return false;
  long long k = 0;
  p.rank_bytes = a[k++];
  p.B = a[k++];
  p.W = a[k++];
  p.M = a[k++];
  p.P = a[k++];
  p.n_octo = a[k++];
  p.shard = a[k++];
  p.n_major = a[k++];
  p.primary = a[k++];
  p.max_iters = a[k++];
  p.min_seed_len = a[k++];
  p.split_len = a[k++];
  p.split_width = a[k++];
  p.max_mem_intv = a[k++];
  p.occ_rows = ptr<const int32_t>(a[k++]);
  p.occ_majors = ptr<const void>(a[k++]);
  p.L2 = ptr<const void>(a[k++]);
  p.buf = ptr<int32_t>(a[k++]);
  p.codes = ptr<const int32_t>(a[k++]);
  p.lens = ptr<const int32_t>(a[k++]);
  p.phase = ptr<int32_t>(a[k++]);
  p.round = ptr<int32_t>(a[k++]);
  p.x = ptr<int32_t>(a[k++]);
  p.i = ptr<int32_t>(a[k++]);
  p.j = ptr<int32_t>(a[k++]);
  p.ik = ptr<void>(a[k++]);
  p.ik_end = ptr<int32_t>(a[k++]);
  p.cand = ptr<void>(a[k++]);
  p.n_cand = ptr<int32_t>(a[k++]);
  p.prev = ptr<void>(a[k++]);
  p.n_prev = ptr<int32_t>(a[k++]);
  p.curr = ptr<void>(a[k++]);
  p.n_curr = ptr<int32_t>(a[k++]);
  p.ret = ptr<int32_t>(a[k++]);
  p.rev1 = ptr<uint8_t>(a[k++]);
  p.min_intv = ptr<void>(a[k++]);
  p.r2i = ptr<int32_t>(a[k++]);
  p.last_start = ptr<int32_t>(a[k++]);
  p.mem_k = ptr<void>(a[k++]);
  p.mem_s = ptr<void>(a[k++]);
  p.mem_b = ptr<void>(a[k++]);
  p.mem_e = ptr<void>(a[k++]);
  p.n_mem = ptr<int32_t>(a[k++]);
  p.n_mem_r1 = ptr<int32_t>(a[k++]);
  p.iters = ptr<int32_t>(a[k++]);
  p.it_r1 = ptr<int32_t>(a[k++]);
  p.it_r2 = ptr<int32_t>(a[k++]);
  p.overflow = ptr<uint8_t>(a[k++]);
  return k == kMachineArgs && (p.rank_bytes == 4 || p.rank_bytes == 8) &&
         p.B >= 0 && p.W >= 1 &&
         p.M >= 1 && p.P >= 1 && p.n_octo >= 1 && p.n_major >= 1 &&
         p.shard >= 0;
}

inline bool sa_params(const long long* a, long long n_args, SParams& p) {
  if (n_args != kSaArgs) return false;
  long long k = 0;
  p.rank_bytes = a[k++];
  p.n = a[k++];
  p.mode = a[k++];
  p.shard = a[k++];
  p.n_octo = a[k++];
  p.n_major = a[k++];
  p.n_words = a[k++];
  p.n_cnt = a[k++];
  p.n_sa_major = a[k++];
  p.n_sample = a[k++];
  p.primary = a[k++];
  p.occ_rows = ptr<const int32_t>(a[k++]);
  p.occ_majors = ptr<const void>(a[k++]);
  p.L2 = ptr<const void>(a[k++]);
  p.sa_words = ptr<const int32_t>(a[k++]);
  p.sa_cnt = ptr<const int32_t>(a[k++]);
  p.sa_majors = ptr<const void>(a[k++]);
  p.sa_sample = ptr<const void>(a[k++]);
  p.r = ptr<void>(a[k++]);
  p.steps = ptr<void>(a[k++]);
  p.buf = ptr<void>(a[k++]);
  p.mask = ptr<const uint8_t>(a[k++]);
  p.pos = ptr<void>(a[k++]);
  return k == kSaArgs && (p.rank_bytes == 4 || p.rank_bytes == 8) &&
         p.n >= 0 &&
         (p.mode == 0 || p.mode == 1) && p.shard >= 0 && p.n_octo >= 1 &&
         p.n_major >= 1 && p.n_words >= 1 && p.n_cnt >= 1 &&
         p.n_sa_major >= 1 && p.n_sample >= 1;
}

inline bool bs_params(const long long* a, long long n_args, BParams& p) {
  if (n_args != kBsArgs) return false;
  long long k = 0;
  p.rank_bytes = a[k++];
  p.B = a[k++];
  p.W = a[k++];
  p.t = a[k++];
  p.shard = a[k++];
  p.n_octo = a[k++];
  p.n_major = a[k++];
  p.primary = a[k++];
  p.occ_rows = ptr<const int32_t>(a[k++]);
  p.occ_majors = ptr<const void>(a[k++]);
  p.L2 = ptr<const void>(a[k++]);
  p.codes = ptr<const int32_t>(a[k++]);
  p.lens = ptr<const int32_t>(a[k++]);
  p.lo = ptr<void>(a[k++]);
  p.hi = ptr<void>(a[k++]);
  p.buf = ptr<int32_t>(a[k++]);
  return k == kBsArgs && (p.rank_bytes == 4 || p.rank_bytes == 8) &&
         p.B >= 0 && p.W >= 1 && p.t >= 0 && p.t < p.W && p.shard >= 0 &&
         p.n_octo >= 1 && p.n_major >= 1;
}

#ifdef __CUDACC__
template <typename R>
__global__ void __launch_bounds__(kThreads) bs_query_kernel(const BParams p) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (b < p.B) bs_query_lane<R>(p, b);
}

template <typename R>
__global__ void __launch_bounds__(kThreads) bs_apply_kernel(const BParams p) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (b < p.B) bs_apply_lane<R>(p, b);
}

template <typename R>
__global__ void __launch_bounds__(kThreads) machine_query_kernel(
    const MParams p) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (b < p.B) machine_query_lane<R>(p, b);
}

template <typename R>
__global__ void __launch_bounds__(kThreads) machine_apply_kernel(
    const MParams p) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (b < p.B) machine_apply_lane<R>(p, b);
}

template <typename R>
__global__ void __launch_bounds__(kThreads) sa_query_kernel(
    const SParams p) {
  const long long k = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (k < p.n) sa_query_lane<R>(p, k);
}

template <typename R>
__global__ void __launch_bounds__(kThreads) sa_apply_kernel(
    const SParams p) {
  const long long k = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (k < p.n) sa_apply_lane<R>(p, k);
}

inline unsigned grid_of(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}
#endif

}  // namespace

// The six entries, each taking the argument array kernels/fm_shard_cuda.py
// builds (its length first checked) and, from nvcc, the stream: 0, or a
// CUDA error code (kRefused for refused arguments). From a host compiler
// (NAME_host) every lane runs in turn.

extern "C" int LANE_ENTRY(fm_shard_query)(const long long* a,
                                          long long n_args LANE_STREAM) {
  MParams p;
  if (!machine_params(a, n_args, p)) return kRefused;
#ifdef __CUDACC__
  if (p.B == 0) return 0;
  if (p.rank_bytes == 8)
    machine_query_kernel<long long><<<grid_of(p.B), kThreads, 0, stream>>>(p);
  else
    machine_query_kernel<int32_t><<<grid_of(p.B), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
#else
  for (long long b = 0; b < p.B; ++b) {
    if (p.rank_bytes == 8)
      machine_query_lane<long long>(p, b);
    else
      machine_query_lane<int32_t>(p, b);
  }
  return 0;
#endif
}

extern "C" int LANE_ENTRY(fm_shard_apply)(const long long* a,
                                          long long n_args LANE_STREAM) {
  MParams p;
  if (!machine_params(a, n_args, p)) return kRefused;
#ifdef __CUDACC__
  if (p.B == 0) return 0;
  if (p.rank_bytes == 8)
    machine_apply_kernel<long long><<<grid_of(p.B), kThreads, 0, stream>>>(p);
  else
    machine_apply_kernel<int32_t><<<grid_of(p.B), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
#else
  for (long long b = 0; b < p.B; ++b) {
    if (p.rank_bytes == 8)
      machine_apply_lane<long long>(p, b);
    else
      machine_apply_lane<int32_t>(p, b);
  }
  return 0;
#endif
}

extern "C" int LANE_ENTRY(sa_shard_query)(const long long* a,
                                          long long n_args LANE_STREAM) {
  SParams p;
  if (!sa_params(a, n_args, p)) return kRefused;
#ifdef __CUDACC__
  if (p.n == 0) return 0;
  if (p.rank_bytes == 8)
    sa_query_kernel<long long><<<grid_of(p.n), kThreads, 0, stream>>>(p);
  else
    sa_query_kernel<int32_t><<<grid_of(p.n), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
#else
  for (long long k = 0; k < p.n; ++k) {
    if (p.rank_bytes == 8)
      sa_query_lane<long long>(p, k);
    else
      sa_query_lane<int32_t>(p, k);
  }
  return 0;
#endif
}

extern "C" int LANE_ENTRY(sa_shard_apply)(const long long* a,
                                          long long n_args LANE_STREAM) {
  SParams p;
  if (!sa_params(a, n_args, p)) return kRefused;
#ifdef __CUDACC__
  if (p.n == 0) return 0;
  if (p.rank_bytes == 8)
    sa_apply_kernel<long long><<<grid_of(p.n), kThreads, 0, stream>>>(p);
  else
    sa_apply_kernel<int32_t><<<grid_of(p.n), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
#else
  for (long long k = 0; k < p.n; ++k) {
    if (p.rank_bytes == 8)
      sa_apply_lane<long long>(p, k);
    else
      sa_apply_lane<int32_t>(p, k);
  }
  return 0;
#endif
}

extern "C" int LANE_ENTRY(bs_shard_query)(const long long* a,
                                          long long n_args LANE_STREAM) {
  BParams p;
  if (!bs_params(a, n_args, p)) return kRefused;
#ifdef __CUDACC__
  if (p.B == 0) return 0;
  if (p.rank_bytes == 8)
    bs_query_kernel<long long><<<grid_of(p.B), kThreads, 0, stream>>>(p);
  else
    bs_query_kernel<int32_t><<<grid_of(p.B), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
#else
  for (long long b = 0; b < p.B; ++b) {
    if (p.rank_bytes == 8)
      bs_query_lane<long long>(p, b);
    else
      bs_query_lane<int32_t>(p, b);
  }
  return 0;
#endif
}

extern "C" int LANE_ENTRY(bs_shard_apply)(const long long* a,
                                          long long n_args LANE_STREAM) {
  BParams p;
  if (!bs_params(a, n_args, p)) return kRefused;
#ifdef __CUDACC__
  if (p.B == 0) return 0;
  if (p.rank_bytes == 8)
    bs_apply_kernel<long long><<<grid_of(p.B), kThreads, 0, stream>>>(p);
  else
    bs_apply_kernel<int32_t><<<grid_of(p.B), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
#else
  for (long long b = 0; b < p.B; ++b) {
    if (p.rank_bytes == 8)
      bs_apply_lane<long long>(p, b);
    else
      bs_apply_lane<int32_t>(p, b);
  }
  return 0;
#endif
}
