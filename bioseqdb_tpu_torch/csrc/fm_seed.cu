// The FM seeding machine for Hopper: every step of every read in one launch.
//
// Replaces the TPU program of bioseqdb_tpu/kernels/seed.py:
// collect_seeds_device (its lax.while_loop, compiled by XLA into one
// program; no Pallas). It computes exactly what the plain version
// bioseqdb_tpu_torch/kernels/seed.py:_plain_machine computes, step for
// step: rounds 1-3 of bwa's mem_collect_intv (or round 2 alone from
// preloaded mems), the fetch-sharing split-row stall steps of the JAX
// machine, the round-3 jump, the per-lane step budget. Outputs: the mem
// tables (k, s, start, end), n_mem, iters, it_r1, it_r2 and overflow,
// written in place into the plain version's set-up tensors.
//
// What bounds it: a read is a chain of dependent steps (up to ~1,700 at
// 150 bp, ~9,800 at 1,500 bp), each an FMD extension whose two Occ block
// rows (48 bytes each, at ranks anywhere in the index) are addressed by
// the step before. So a launch lasts about as long as its slowest lane's
// chain of steps, each a dependent random read from device memory or L2
// (~0.5-1 us) plus its integer work: latency, not the card's memory rate
// (a 4.6 Mb genome's Occ table is ~3.5 MB and stays in L2) or its issue
// rate.
//
// Design:
// - One thread a read, 128 threads a block; each thread runs its lane
//   from the set-up state to PH_DONE with no synchronisation. Lanes are
//   independent and a PH_DONE lane's step is a no-op in the plain
//   version, so this equals its chunked loop with live-lane compaction.
// - A step is the plain version's body in its order: the budget check
//   and iters += 1; the pivot (which may move the lane to PH_FWD, PH_R3
//   or PH_R3J and extend it in the same step); the split-row stall; the
//   two Occ fetches; one of the PH_R3J / PH_FWD / PH_BWD / PH_R3
//   branches, chosen by the phase after the pivot. Updates that read the
//   state from before the step (ret, r2i, n_curr, curr, n_prev) read it
//   before it is written.
// - Scalars live in registers. The three candidate stacks (cand, prev,
//   curr: up to kMaxCand rows of (k, s, end)) are per-thread arrays in
//   local memory, copied whole where the plain version copies them. The
//   mems are read and written in the output tables.
// - Ranks and rank-valued state take the template type R (int32 or
//   int64, the index's rank dtype); positions, counts and phases int32.
//   Table rows are clamped where XLA's gathers clamp them.
// - An Occ row is three 16-byte loads; its counts are four popcounts of
//   eight words against the first-v-bases mask (kernels/fm.py
//   _row_counts).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// phases and rounds: bioseqdb_tpu_torch/kernels/seed.py's
constexpr int PH_PIVOT = 0;
constexpr int PH_FWD = 1;
constexpr int PH_BWD = 2;
constexpr int PH_R3 = 3;
constexpr int PH_DONE = 4;
constexpr int PH_R3J = 5;
constexpr int RD_SMEM = 0;
constexpr int RD_RESEED = 1;
constexpr int RD_LAST = 2;

constexpr int kThreads = 128;    // a block: one read a thread
constexpr int kMaxCand = 32;     // candidate stack rows (the wrapper raises above)
constexpr int kLog2OccBlock = 7;   // 128 bases an Occ block (fmindex.OCC_BLOCK)
constexpr int kLog2Major = 15;     // blocks a major checkpoint (fmindex.MAJOR_BLOCKS)
constexpr int kLog2FetchRow = 10;  // the JAX machine's fetch row: 1,024 bases

struct Params {
  const int32_t* codes;     // [B, W]
  const int32_t* lens;      // [B]
  const int32_t* phase0;    // [B] set-up phase
  const int32_t* round0;    // [B] set-up round
  const int32_t* n_mem_r1;  // [B] set-up round-1 mem count
  const int32_t* occ_rows;  // [n_octo * 8, 12]
  const void* occ_majors;   // [n_major, 4] R
  const void* L2;           // [5] R
  const void* jump;         // [4^J, 3] R, J > 0
  void* mem_k;              // [B, M] R, in place
  void* mem_s;
  void* mem_b;
  void* mem_e;
  int32_t* n_mem;           // [B] in: set-up count; out: final
  int32_t* iters;           // [B] out
  int32_t* it_r1;
  int32_t* it_r2;
  uint8_t* overflow;        // [B] out (torch.bool)
  long long n_octo, n_major, primary;
  int B, W, M, P, J, max_iters;
  int min_seed_len, split_len, split_width, max_mem_intv;
};

template <typename T>
__device__ __forceinline__ T clampv(T v, T lo, T hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// _MASK_TABLE[v]: the first v bases (2 bits each, big-endian) of a word
__device__ __forceinline__ uint32_t first_bases(int v) {
  return v == 0 ? 0u : (0x55555555u << (2 * (16 - v)));
}

// the jump key of the depth-J window at column pos (sum_t q[pos + t] << 2t;
// seed.py _jump_keys), or -1 when the window holds a code >= 4 or runs
// past W
__device__ __forceinline__ int jump_key(const int32_t* q, int pos, int W,
                                        int J) {
  int key = 0;
  for (int t = 0; t < J; ++t) {
    const int c = pos + t < W ? q[pos + t] : 4;
    if (c >= 4) return -1;
    key |= (c & 3) << (2 * t);
  }
  return key;
}

// occ4 at conceptual-prefix rank r (kernels/fm.py occ_rows_for +
// occ4_from_row): the Occ block row's checkpoint, the counts of each code
// in the row's first (j & 127) bases, and the major checkpoint
template <typename R>
__device__ __forceinline__ void occ4(const Params& p, const R* majors, R r,
                                     R primary, R out[4]) {
  const R jr = r - static_cast<R>(r > primary);
  const R blk = jr >> kLog2OccBlock;
  const long long octo =
      clampv<long long>(static_cast<long long>(blk >> 3), 0, p.n_octo - 1);
  const long long row = octo * 8 + static_cast<long long>(blk & 7);
  const int4* src = reinterpret_cast<const int4*>(p.occ_rows + row * 12);
  const int4 c = __ldg(src);
  const int4 wa = __ldg(src + 1);
  const int4 wb = __ldg(src + 2);
  const long long m = clampv<long long>(
      static_cast<long long>(blk >> kLog2Major), 0, p.n_major - 1);
  const R* mj = majors + m * 4;
  const int off = static_cast<int>(jr & 127);
  const uint32_t words[8] = {
      static_cast<uint32_t>(wa.x), static_cast<uint32_t>(wa.y),
      static_cast<uint32_t>(wa.z), static_cast<uint32_t>(wa.w),
      static_cast<uint32_t>(wb.x), static_cast<uint32_t>(wb.y),
      static_cast<uint32_t>(wb.z), static_cast<uint32_t>(wb.w)};
  int cnt[4] = {0, 0, 0, 0};
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const uint32_t mask = first_bases(clampv(off - 16 * w, 0, 16));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t x = words[w] ^ (static_cast<uint32_t>(k) * 0x55555555u);
      const uint32_t y = ~(x | (x >> 1)) & 0x55555555u;
      cnt[k] += __popc(y & mask);
    }
  }
  const int ck[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    out[k] = static_cast<R>(ck[k] + cnt[k]) + mj[k];
}

template <typename R>
__global__ void __launch_bounds__(kThreads) fm_seed_kernel(const Params p) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= p.B) return;
  const int W = p.W, M = p.M, P = p.P, J = p.J;
  const int32_t* q = p.codes + static_cast<long long>(b) * W;
  const R* majors = static_cast<const R*>(p.occ_majors);
  const R* jump = static_cast<const R*>(p.jump);
  R L2[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) L2[c] = static_cast<const R*>(p.L2)[c];
  const R primary = static_cast<R>(p.primary);
  const long long mo = static_cast<long long>(b) * M;
  R* mem_k = static_cast<R*>(p.mem_k) + mo;
  R* mem_s = static_cast<R*>(p.mem_s) + mo;
  R* mem_b = static_cast<R*>(p.mem_b) + mo;
  R* mem_e = static_cast<R*>(p.mem_e) + mo;
  const int L = p.lens[b];

  int phase = p.phase0[b], rnd = p.round0[b];
  int n_mem = p.n_mem[b], n_mem_r1 = p.n_mem_r1[b];
  int x = 0, i = 0, ik_end = 0, n_cand = 0, n_prev = 0, n_curr = 0, j = 0;
  int ret = 0, r2i = 0, last_start = W + 1, iters = 0, it_r1 = 0, it_r2 = 0;
  int jkey_pend = 0;
  bool rev1 = false, overflow = false;
  R ik_k = 0, ik_l = 0, ik_s = 0, min_intv = 1;
  R cand[kMaxCand][3], prev[kMaxCand][3], curr[kMaxCand][3];
  for (int t = 0; t < P; ++t)
    for (int e = 0; e < 3; ++e) cand[t][e] = prev[t][e] = curr[t][e] = 0;

  // code at column pos, clamped: 0..3 a base, >= 4 ambiguous
  auto qat = [&](int pos) { return q[clampv(pos, 0, W - 1)]; };
  auto set_intv = [&](int c) {
    c = clampv(c, 0, 3);
    ik_k = L2[c] + 1;
    ik_l = L2[3 - c] + 1;
    ik_s = L2[c + 1] - L2[c];
  };
  auto push_mem = [&](R k, R s, R beg, R end) {
    if (n_mem >= M) {
      overflow = true;
    } else {
      mem_k[n_mem] = k;
      mem_s[n_mem] = s;
      mem_b[n_mem] = beg;
      mem_e[n_mem] = end;
      ++n_mem;
    }
  };

  while (phase != PH_DONE) {
    if (iters >= p.max_iters) {   // the budget: no step left
      overflow = true;
      break;
    }
    ++iters;

    // ---- pivot: the next pivot / round transition ----
    if (phase == PH_PIVOT) {
      const int qx = qat(x);
      if (rnd == RD_SMEM && x >= L) {
        rnd = RD_RESEED;
        n_mem_r1 = n_mem;
        r2i = 0;
        it_r1 = iters;
      }
      bool go2 = false;
      R r2_s = 0, r2_b = 0, r2_e = 0;
      if (rnd == RD_RESEED) {
        const int r2x = clampv(r2i, 0, M - 1);
        r2_s = mem_s[r2x];
        r2_b = mem_b[r2x];
        r2_e = mem_e[r2x];
        const bool eligible =
            (r2_e - r2_b) >= p.split_len && r2_s <= p.split_width;
        if (r2i >= n_mem_r1) {          // round 2 exhausted: round 3
          rnd = RD_LAST;
          x = 0;
          it_r2 = iters;
        } else if (!eligible) {
          ++r2i;
        } else {
          go2 = true;
        }
      }
      const bool at_r3 = rnd == RD_LAST;
      const bool r3_off = at_r3 && (p.max_mem_intv <= 0 || x >= L);
      if (r3_off) phase = PH_DONE;
      bool go1 = false;
      if (rnd == RD_SMEM && x < L) {
        if (qx >= 4) ++x;
        else go1 = true;
      }
      if (go2) {
        x = static_cast<int>((r2_b + r2_e) >> 1);
        min_intv = r2_s + 1;
      } else if (go1) {
        min_intv = 1;
      }
      bool go = go1 || go2;
      const int qpiv = qat(x);
      if (go2 && qpiv >= 4) {   // a re-seed pivot on an N: skip it
        ++r2i;
        go = false;
      }
      if (go) {
        set_intv(qpiv);
        ik_end = x + 1;
        i = x + 1;
        n_cand = 0;
        phase = PH_FWD;
      }
      if (at_r3 && !r3_off && p.max_mem_intv > 0) {
        const int q3 = qat(x);
        if (q3 >= 4) {
          ++x;
        } else {
          bool go3 = true;
          if (J) {   // start at depth J from the table: clean window inside the read
            const int jk3 = jump_key(q, clampv(x, 0, W - 1), W, J);
            if (jk3 >= 0 && x + J <= L) {
              go3 = false;
              phase = PH_R3J;
              jkey_pend = jk3;
            }
          }
          if (go3) {
            set_intv(q3);
            i = x + 1;
            phase = PH_R3;
          }
        }
      }
    }

    // ---- the step's FMD extension ----
    const int qi = qat(i);
    const bool qok = qi < 4;
    const bool in_fwd = phase == PH_FWD;
    const bool in_bwd = phase == PH_BWD;
    const bool in_r3 = phase == PH_R3;
    const int j_eff = rev1 ? n_prev - 1 - j : j;
    const int jr = clampv(j_eff, 0, P - 1);
    const R bwd_k = prev[jr][0], bwd_s = prev[jr][1], bwd_end = prev[jr][2];
    const R a = in_bwd ? bwd_k : ik_l;
    const R bb = in_bwd ? static_cast<R>(0) : ik_k;
    const R src_s = in_bwd ? bwd_s : ik_s;
    const R s_eff = src_s < 0 ? static_cast<R>(0) : src_s;
    const R posB = a + s_eff;
    const bool consume = ((in_fwd || in_r3) && i < L && qok)
                         || (in_bwd && i >= 0 && qok);
    R ok_k = 0, ok_l = 0, ok_s = 0;
    if (consume) {
      // the JAX machine fetches one 1,024-base row a lane and stalls a
      // step when the pair (a, a + s) spans two rows
      const R jA = a - static_cast<R>(a > primary);
      const R jB = posB - static_cast<R>(posB > primary);
      if ((jA >> kLog2FetchRow) != (jB >> kLog2FetchRow)) {
        if (iters >= p.max_iters) {
          overflow = true;
          break;                       // PH_DONE: nothing else this step
        }
        ++iters;
      }
      R o1[4], o2[4];
      occ4<R>(p, majors, a, primary, o1);
      occ4<R>(p, majors, posB, primary, o2);
      // FMD backward extension (kernels/fm.py fmd_extend_from_occ); the
      // forward one swaps k and l and reads code 3 - q
      const int c = clampv(in_bwd ? qi : 3 - qi, 0, 3);
      const R dollar = static_cast<R>(a <= primary && primary < a + s_eff);
      R suffix = 0;
      for (int t = 3; t > c; --t) suffix += o2[t] - o1[t];
      const R k4 = L2[c] + 1 + o1[c];
      const R l4 = bb + dollar + suffix;
      ok_s = o2[c] - o1[c];
      ok_k = in_bwd ? k4 : l4;
      ok_l = in_bwd ? l4 : k4;
    }

    if (phase == PH_R3J) {   // the jump: depth J in one step
      ik_k = jump[jkey_pend * 3];
      ik_l = jump[jkey_pend * 3 + 1];
      ik_s = jump[jkey_pend * 3 + 2];
      i = x + J;
      phase = PH_R3;
    } else if (in_fwd) {     // forward pass of smem1
      const bool fwd_end = i >= L;
      const bool fwd_amb = i < L && qi >= 4;
      const bool fwd_ext = i < L && qok;
      const bool size_change = fwd_ext && ok_s != ik_s;
      if (fwd_end || fwd_amb || size_change) {
        if (n_cand >= P) {
          overflow = true;
        } else {
          cand[n_cand][0] = ik_k;
          cand[n_cand][1] = ik_s;
          cand[n_cand][2] = static_cast<R>(ik_end);
          ++n_cand;
        }
      }
      const bool drop_below = size_change && ok_s < min_intv;
      if (fwd_ext && !drop_below) {
        ik_k = ok_k;
        ik_l = ok_l;
        ik_s = ok_s;
        ik_end = i + 1;
        i = i + 1;
      }
      if (fwd_end || fwd_amb || drop_below) {
        for (int t = 0; t < P; ++t)
          for (int e = 0; e < 3; ++e) prev[t][e] = cand[t][e];
        n_prev = n_cand;
        rev1 = true;
        ret = static_cast<int>(cand[clampv(n_cand - 1, 0, P - 1)][2]);
        i = x - 1;
        j = 0;
        n_curr = 0;
        last_start = W + 1;
        phase = PH_BWD;
      }
    } else if (in_bwd) {     // backward pass: one candidate a step
      const int bw_i = i;
      const bool c_ok = bw_i >= 0 && qok;
      const int ncr = n_curr;
      const R last_s = curr[clampv(ncr - 1, 0, P - 1)][1];
      const bool fail = !c_ok || ok_s < min_intv;
      const bool emit = fail && ncr == 0 && bw_i + 1 < last_start
                        && (bwd_end - static_cast<R>(bw_i + 1)) >= p.min_seed_len;
      if (emit) {
        last_start = bw_i + 1;
        push_mem(bwd_k, bwd_s, static_cast<R>(bw_i + 1), bwd_end);
      }
      const bool keep = c_ok && ok_s >= min_intv;
      if (keep && (ncr == 0 || ok_s != last_s)) {
        if (ncr >= P) {
          overflow = true;
        } else {
          curr[ncr][0] = ok_k;
          curr[ncr][1] = ok_s;
          curr[ncr][2] = bwd_end;
          ++n_curr;
        }
      }
      const int nj = j + 1;
      const bool dead = bw_i < 0 || qi >= 4;
      const bool row_done = nj >= n_prev || dead;
      j = row_done ? 0 : nj;
      if (row_done && n_curr == 0) {          // this pivot is finished
        phase = PH_PIVOT;
        if (rnd == RD_SMEM) x = ret;
        if (rnd == RD_RESEED) ++r2i;
      } else if (row_done) {                  // the next row
        for (int t = 0; t < P; ++t)
          for (int e = 0; e < 3; ++e) prev[t][e] = curr[t][e];
        n_prev = n_curr;
        rev1 = false;
        n_curr = 0;
        i = bw_i - 1;
      }
    } else if (in_r3) {      // round 3: the LAST-like forward scan
      const bool r3_end = i >= L;
      const bool r3_amb = i < L && qi >= 4;
      const bool r3_ext = i < L && qok;
      const bool hit = r3_ext && ok_s < p.max_mem_intv
                       && (i - x) >= p.min_seed_len;
      if (hit && ok_s > 0)
        push_mem(ok_k, ok_s, static_cast<R>(x), static_cast<R>(i + 1));
      if (r3_end || r3_amb || hit) {
        x = r3_end ? L : i + 1;
        phase = PH_PIVOT;
      }
      if (r3_ext && !hit) {
        ik_k = ok_k;
        ik_l = ok_l;
        ik_s = ok_s;
        i = i + 1;
      }
    }
  }

  p.n_mem[b] = n_mem;
  p.iters[b] = iters;
  p.it_r1[b] = it_r1;
  p.it_r2[b] = it_r2;
  p.overflow[b] = overflow ? 1 : 0;
}

}  // namespace

// Runs the machine for B reads on `stream`; rank_bytes 4 or 8 picks the
// rank type. Returns the launch's CUDA error code (0: launched).
extern "C" int fm_seed_launch(
    int rank_bytes, const int32_t* codes, const int32_t* lens,
    const int32_t* phase0, const int32_t* round0, const int32_t* n_mem_r1,
    const int32_t* occ_rows, long long n_octo,
    const void* occ_majors, long long n_major, const void* L2,
    long long primary, const void* jump, void* mem_k, void* mem_s,
    void* mem_b, void* mem_e, int32_t* n_mem, int32_t* iters, int32_t* it_r1,
    int32_t* it_r2, uint8_t* overflow, int B, int W, int M, int P, int J,
    int max_iters, int min_seed_len, int split_len, int split_width,
    int max_mem_intv, cudaStream_t stream) {
  if (P < 1 || P > kMaxCand || (rank_bytes != 4 && rank_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{codes, lens, phase0, round0, n_mem_r1, occ_rows, occ_majors,
           L2, jump, mem_k, mem_s, mem_b, mem_e, n_mem, iters, it_r1, it_r2,
           overflow, n_octo, n_major, primary, B, W, M, P, J, max_iters,
           min_seed_len, split_len, split_width, max_mem_intv};
  const int grid = (B + kThreads - 1) / kThreads;
  if (rank_bytes == 8)
    fm_seed_kernel<long long><<<grid, kThreads, 0, stream>>>(p);
  else
    fm_seed_kernel<int><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
