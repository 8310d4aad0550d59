// Chaining and the chain filter for Hopper: every trip of every loop of a
// read in one launch, a group of 8 threads a read (chain_seeds) or a
// thread a read (filter_chains).
//
// Replaces the TPU program of bioseqdb_tpu/kernels/chain.py: chain_seeds
// (bwa's mem_chain insertion, its lax.fori_loop over the seed slots at
// :287) and filter_chains (mem_chain_flt: the weight loop over the seed
// slots at :351, the shadow loop over the chains in weight order at :422
// and the promotion loop over the chains at :432). XLA compiled those
// loops into the one TPU device program; no Pallas. The kernels compute
// exactly what the plain versions bioseqdb_tpu_torch/kernels/chain.py
// chain_seeds_plain and filter_chains_plain compute, trip for trip: the
// vectorised port, which equals the JAX package, not bwa's C.
//
// What bounds it: a read reads its seed slots once (rbeg in the rank
// type, qbeg, len, rid, valid: 17 or 21 bytes a slot) and writes its
// chain tables once; the work between is a few dozen integer compares a
// valid seed and a trip over the read's live chains, and C^2 compares in
// the filter. So the card's memory rate bounds it (about 3 KB a read on
// the main path, ~16 us for 16,384 reads), not its issue rate. A read's
// insertion loop is a chain of dependent steps (each seed's verdict reads
// the chains the seeds before it left), so what a launch costs is that
// chain's latency times the reads an SM runs in turn, and the
// instructions the SM issues for it.
//
// Design:
// - chain_seeds: a group of kChainGroup (8) threads a read, 16 reads a
//   128-thread block, so 16,384 reads make 1,024 blocks, all resident at
//   once (a thread a read filled 128 blocks, 4 warps an SM, with nothing
//   to hide a step's latency behind). A group is sized by the work of a
//   seed, not by C: a warp a read would issue every step of the serial
//   loop 32 times over, an 8-thread group 8 times, and four reads share
//   a warp's issue slots.
//   - The seed slots go in passes of kPassSlots (64): a lane loads eight
//     of a pass's valid flags, its loads issued together and the group's
//     coalesced; ballots over them list the valid slots in order in the
//     group's shared list (sm.live), and write assign -1 for the others.
//     The valid slots' fields then load G at a time, a lane a valid slot,
//     and each seed's fields reach the group by shuffles from its lane.
//   - The chain table: pos, the closest-chain search's only input, in
//     registers, lane t holding chains t * K .. t * K + K - 1 (K = 1, 2,
//     4 or 8 for C up to 8, 16, 32 and 64), the other fields in shared
//     memory (40 bytes a chain at most). The search is each lane's best of
//     its K chains (the first among equals), a group max (int64 as two
//     32-bit shuffles a step) and the lowest lane holding it, whose
//     chain is then the first slot among equals, as in the twin.
//   - The contained / grow / new-chain verdict is uniform: every thread
//     of the group reads the chosen chain's fields (broadcast loads) and
//     computes it; the group's leader writes the grown or opened chain,
//     between two group syncs. The seed's verdict goes to the lane of its
//     slot, and each G valid slots' assign is written together, as is the chain
//     table at the end.
//   The insertion order over the seeds stays serial, as in bwa's
//   mem_chain.
// - filter_chains: one thread a read, 128 threads a block; reads are
//   independent (the plain versions act on each read's row alone), so a
//   lane runs its read's loops in order with no synchronisation. Its
//   state (wq, endq, wr, endr, beg, end, weight, kept, first and the
//   order) lives in per-thread arrays of kMaxChains in local memory (C
//   is 16 at W <= 512, 32 above, 64 in the long-read fat retry; the
//   wrapper refuses more). Seed slots stream from device memory, so S is
//   unbounded. Its row-major [B, S] reads are strided across the threads
//   of a warp.
// - Ranks and reference positions take the template type R (int32 or
//   int64, the index's rank dtype); query positions, lengths and weights
//   int32, as in the plain versions. The shadow test's products are
//   float32 (an int32 tensor times a Python float in torch and JAX).
//   Every sum and difference wraps in its operands' type, as the
//   tensors' do (add_, sub_, wrap32), so equality holds for any input,
//   not only where nvcc and g++ happen to wrap signed overflow.
// - Every argument of the plain versions' vector ops that reads state
//   from before a trip (the shadow loop's kept and first) reads it
//   before the trip writes it: the shadow trip finds the first drop
//   chain in one pass over the chains and updates first in a second.
// - The per-read bodies are __host__ __device__ functions (chain_seeds'
//   a group body through csrc/lanes.cuh). Compiled without nvcc (g++ -x
//   c++), the file gives host entry points that run the same bodies over
//   every read, a group's lanes in turn, so the logic can be held against
//   the plain versions on a machine without a card.

#include "lanes.cuh"

namespace {

constexpr int kThreads = 128;                // a block
constexpr int kChainGroup = 8;               // chain_seeds' threads a read
constexpr int kChainMinBlocks = 8;           // its blocks an SM: 16,384 reads
constexpr int kMaxChains = 64;               // chain slots a read (the wrapper raises above)
constexpr int kNeg = -1073741824;            // chain.py NEG, -(1 << 30)
constexpr int kBegFill = 536870912;          // filter_chains' beg fill and no-drop rank, 1 << 29
constexpr long long kPosFill = 0x7FFFFFFF;   // order key of a missing chain, in the rank type
constexpr int kRefused = 1;                  // cudaErrorInvalidValue

struct ChainParams {
  const void* rbeg;        // [B, S] R
  const int32_t* qbeg;     // [B, S]
  const int32_t* len;      // [B, S]
  const int32_t* rid;      // [B, S]
  const uint8_t* valid;    // [B, S] torch.bool
  void* pos;               // [B, C] R, out
  int32_t* crid;           // [B, C] out
  int32_t* f_qbeg;         // [B, C] out
  void* f_rbeg;            // [B, C] R, out
  int32_t* l_qbeg;         // [B, C] out
  void* l_rbeg;            // [B, C] R, out
  int32_t* l_len;          // [B, C] out
  int32_t* n;              // [B] out
  int32_t* assign;         // [B, S] out
  uint8_t* overflow;       // [B] out (torch.bool)
  long long l_pac, B, S, C, bandwidth, max_chain_gap;
};

struct FilterParams {
  const int32_t* assign;   // [B, S]
  const int32_t* n;        // [B]
  const void* pos;         // [B, C] R
  const void* rbeg;        // [B, S] R
  const int32_t* qbeg;     // [B, S]
  const int32_t* len;      // [B, S]
  int32_t* weight;         // [B, C] out
  int32_t* kept;           // [B, C] out
  int32_t* order;          // [B, C] out
  int32_t* beg;            // [B, C] out
  int32_t* end;            // [B, C] out
  float mask_level, chain_drop_ratio;
  long long min_chain_weight, min_seed_len, max_chain_gap, B, S, C;
};


// int32 arithmetic that wraps, as torch's and XLA's int32 tensors do
LANE_HD inline int32_t wrap32(long long v) {
  return static_cast<int32_t>(static_cast<uint32_t>(v));
}

// sums and differences in the operands' type (int32 or the rank type) that
// wrap as the tensors' do: signed overflow is undefined in C++, so every
// sum the plain versions make goes through these
LANE_HD inline int32_t add_(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
LANE_HD inline int32_t sub_(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
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

// a float32 product rounded once (no contraction into a later op)
LANE_HD inline float mul_f32(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

// a chain_seeds group's chain table in shared memory (or, on the host, a
// buffer): C chains of each field
// a chain_seeds group's slots a pass: their valid flags load together
constexpr int kPassSlots = 8 * kChainGroup;

template <typename R>
struct ChainSmem {
  R* pos;
  R* f_rbeg;
  R* l_rbeg;
  int32_t* rid;
  int32_t* f_qbeg;
  int32_t* l_qbeg;
  int32_t* l_len;
  int32_t* live;   // [kPassSlots] a pass's valid slots, in order
  LANE_HD ChainSmem(unsigned char* base, int C)
      : pos(reinterpret_cast<R*>(base)),
        f_rbeg(pos + C),
        l_rbeg(f_rbeg + C),
        rid(reinterpret_cast<int32_t*>(l_rbeg + C)),
        f_qbeg(rid + C),
        l_qbeg(f_qbeg + C),
        l_len(l_qbeg + C),
        live(l_len + C) {}
};

template <typename R>
LANE_HD inline long long chain_bytes(long long C) {
  return (C * (3 * static_cast<long long>(sizeof(R)) + 16) + 4 * kPassSlots +
          15) & ~15LL;
}

// mem_chain's insertion loop for read b (chain_seeds_plain, one read) by a
// group of kChainGroup threads; lane t holds the pos of chains t * K ..
// t * K + K - 1 (K * kChainGroup >= C)
template <typename R, int K>
GROUP_FN void chain_seeds_group(const ChainParams& p, long long b,
                                ChainSmem<R> sm) {
  constexpr auto G = kChainGroup;
  const int C = static_cast<int>(p.C);
  FOR_LANES(G, t) {
    for (int c = t; c < C; c += G) {
      sm.pos[c] = sm.f_rbeg[c] = sm.l_rbeg[c] = 0;
      sm.rid[c] = -1;
      sm.f_qbeg[c] = sm.l_qbeg[c] = sm.l_len[c] = 0;
    }
  }
  Lanes<R, G> pos[K];   // the closest-chain search's values, in registers
  FOR_LANES(G, t) {
    for (int k = 0; k < K; ++k) pos[k][t] = 0;
  }
  group_sync<G>();
  const long long row = b * p.S;
  const R* rbegs = static_cast<const R*>(p.rbeg) + row;
  const R l_pac = static_cast<R>(p.l_pac);
  const R neg = static_cast<R>(kNeg);
  const R lowest = static_cast<R>(sizeof(R) == 8 ? INT64_MIN : INT32_MIN);
  int n = 0;
  bool overflow = false;
  for (long long base = 0; base < p.S; base += kPassSlots) {
    // the pass's valid flags, a lane's eight loads issued together; the
    // valid slots listed in order by ballots, the others' assign -1
    Lanes<bool, G> flag[kPassSlots / G];
    FOR_LANES(G, t) {
#pragma unroll
      for (int u = 0; u < kPassSlots / G; ++u) {
        const long long s = base + u * G + t;
        flag[u][t] = s < p.S && p.valid[row + s];
      }
    }
    int n_live = 0;
#pragma unroll
    for (int u = 0; u < kPassSlots / G; ++u) {
      const uint32_t m = ballot(flag[u]);
      FOR_LANES(G, t) {
        const long long s = base + u * G + t;
        if (flag[u][t])
          sm.live[n_live + popc32(m & ((1u << t) - 1u))] = u * G + t;
        else if (s < p.S)
          p.assign[row + s] = -1;
      }
      n_live += popc32(m);
    }
    group_sync<G>();
    // the valid slots G at a time: a lane loads one's fields
    for (int c0 = 0; c0 < n_live; c0 += G) {
      Lanes<R, G> rb;
      Lanes<int32_t, G> qb, ln, rd, col;
      FOR_LANES(G, t) {
        const long long s = base + sm.live[min_(c0 + t, n_live - 1)];
        rb[t] = rbegs[s];
        qb[t] = p.qbeg[row + s];
        ln[t] = p.len[row + s];
        rd[t] = p.rid[row + s];
        col[t] = -1;
      }
      for (int src = 0; src < min_(G, n_live - c0); ++src) {
        const R rbeg = shfl<G>(rb, src);
        const int32_t qbeg = shfl<G>(qb, src);
        const int32_t slen = shfl<G>(ln, src);
        const int32_t srid = shfl<G>(rd, src);
        // the closest chain: argmax over where(active & pos <= rbeg, pos,
        // NEG), the first slot among equals. A lane takes its chains' best
        // (the first among equals), the group its max, and the lowest lane
        // that holds it names the slot.
        Lanes<R, G> lane_best;
        Lanes<int32_t, G> lane_k;
        Lanes<bool, G> has;
        FOR_LANES(G, t) {
          has[t] = false;
          lane_best[t] = lowest;
          lane_k[t] = 0;
          for (int k = 0; k < K; ++k) {
            const R v = pos[k][t] <= rbeg ? pos[k][t] : neg;
            if (t * K + k < n && (!has[t] || v > lane_best[t])) {
              lane_best[t] = v;
              lane_k[t] = k;
              has[t] = true;
            }
          }
        }
        R best = neg;
        int ci = -1;
        if (n > 0) {
          best = group_max<G>(lane_best);
          Lanes<bool, G> at;
          FOR_LANES(G, t) { at[t] = has[t] && lane_best[t] == best; }
          const int lane = low_bit(ballot(at));
          ci = lane * K + shfl<G>(lane_k, lane);
        }
        // the inactive slots (from n on) all hold NEG, so the first of them
        // is a candidate too
        if (n < C && (ci < 0 || best < neg)) {
          best = neg;
          ci = n;
        }
        const bool found = best > neg;
        const R c_lr = sm.l_rbeg[ci], c_fr = sm.f_rbeg[ci];
        const int32_t c_lq = sm.l_qbeg[ci], c_ll = sm.l_len[ci];
        const R rend = add_(c_lr, static_cast<R>(c_ll));
        const bool same_rid = srid == sm.rid[ci];
        const bool contained =
            qbeg >= sm.f_qbeg[ci] && add_(qbeg, slen) <= add_(c_lq, c_ll) &&
            rbeg >= c_fr && add_(rbeg, static_cast<R>(slen)) <= rend;
        const bool diff_strand =
            (c_lr < l_pac || c_fr < l_pac) && rbeg >= l_pac;
        const int32_t dq = sub_(qbeg, c_lq);
        const R x = static_cast<R>(dq);
        const R y = sub_(rbeg, c_lr);
        const bool grow = y >= 0 && sub_(x, y) <= p.bandwidth &&
                          sub_(y, x) <= p.bandwidth &&
                          sub_(dq, c_ll) < p.max_chain_gap &&
                          sub_(y, static_cast<R>(c_ll)) < p.max_chain_gap;
        const bool base_ok = found && same_rid;
        int32_t verdict;   // the seed's chain, -2 contained, -1 refused
        int at_slot = -1;  // the chain slot it grows or opens
        bool fresh = false;
        if (base_ok && !contained && !diff_strand && grow) {
          verdict = at_slot = ci;
        } else if (base_ok && contained) {
          verdict = -2;
        } else if (n >= C) {   // a new chain with no slot left
          verdict = -1;
          overflow = true;
        } else {               // a new chain at slot n
          verdict = at_slot = n;
          fresh = true;
          FOR_LANES(G, t) {
            for (int k = 0; k < K; ++k)
              if (t * K + k == n) pos[k][t] = rbeg;
          }
          ++n;
        }
        if (at_slot >= 0) {
          group_sync<G>();   // every lane has read the chain before it moves
          if (group_leader<G>()) {
            if (fresh) {
              sm.pos[at_slot] = rbeg;
              sm.rid[at_slot] = srid;
              sm.f_qbeg[at_slot] = qbeg;
              sm.f_rbeg[at_slot] = rbeg;
            }
            sm.l_qbeg[at_slot] = qbeg;
            sm.l_rbeg[at_slot] = rbeg;
            sm.l_len[at_slot] = slen;
          }
          group_sync<G>();
        }
        FOR_LANES(G, t) {
          if (t == src) col[t] = verdict;
        }
      }
      FOR_LANES(G, t) {
        if (c0 + t < n_live)
          p.assign[row + base + sm.live[c0 + t]] = col[t];
      }
    }
    group_sync<G>();   // the list is read before the next pass writes it
  }
  const long long out = b * p.C;
  FOR_LANES(G, t) {
    for (int c = t; c < C; c += G) {
      static_cast<R*>(p.pos)[out + c] = sm.pos[c];
      p.crid[out + c] = sm.rid[c];
      p.f_qbeg[out + c] = sm.f_qbeg[c];
      static_cast<R*>(p.f_rbeg)[out + c] = sm.f_rbeg[c];
      p.l_qbeg[out + c] = sm.l_qbeg[c];
      static_cast<R*>(p.l_rbeg)[out + c] = sm.l_rbeg[c];
      p.l_len[out + c] = sm.l_len[c];
    }
  }
  if (group_leader<G>()) {
    p.n[b] = n;
    p.overflow[b] = overflow;
  }
}

// the chains a lane of a chain_seeds group holds at C chains a read
LANE_HD inline int chains_a_lane(long long C) {
  return C <= kChainGroup ? 1 : C <= 2 * kChainGroup ? 2
                              : C <= 4 * kChainGroup ? 4 : 8;
}

#ifndef __CUDACC__
// chain_seeds_group at the K that C takes (the host build's dispatch; the
// card's is the kernel's instantiation, launch_chain_seeds)
template <typename R>
void chain_seeds_read(const ChainParams& p, long long b, unsigned char* smem) {
  const ChainSmem<R> sm(smem, static_cast<int>(p.C));
  switch (chains_a_lane(p.C)) {
    case 1: chain_seeds_group<R, 1>(p, b, sm); break;
    case 2: chain_seeds_group<R, 2>(p, b, sm); break;
    case 4: chain_seeds_group<R, 4>(p, b, sm); break;
    default: chain_seeds_group<R, 8>(p, b, sm); break;
  }
}
#endif

// mem_chain_flt for read b (filter_chains_plain, one lane)
template <typename R>
LANE_HD void filter_chains_lane(const FilterParams& p, long long b) {
  int32_t wq[kMaxChains], endq[kMaxChains], wr[kMaxChains], beg[kMaxChains],
      end[kMaxChains], weight[kMaxChains], kept[kMaxChains],
      first[kMaxChains], rank_of[kMaxChains], order[kMaxChains],
      key[kMaxChains];
  R endr[kMaxChains];
  const int C = static_cast<int>(p.C);
  for (int c = 0; c < C; ++c) {
    wq[c] = endq[c] = wr[c] = end[c] = 0;
    endr[c] = 0;
    beg[c] = kBegFill;
  }
  // the weights: each assigned seed adds the part of its query and of its
  // reference span past its chain's end so far
  const long long row = b * p.S;
  const R* rbegs = static_cast<const R*>(p.rbeg) + row;
  for (long long s = 0; s < p.S; ++s) {
    const int32_t ci = p.assign[row + s];
    if (ci < 0) continue;
    const int c = min_(ci, C - 1);
    const int32_t qb = p.qbeg[row + s];
    const int32_t ln = p.len[row + s];
    const R rb = rbegs[s];
    const int32_t qe = add_(qb, ln);
    wq[c] = add_(wq[c], qb >= endq[c] ? ln : max_(sub_(qe, endq[c]), 0));
    endq[c] = max_(endq[c], qe);
    const R re = add_(rb, static_cast<R>(ln));
    const R add = rb >= endr[c] ? static_cast<R>(ln)
                                : max_(sub_(re, endr[c]), R(0));
    // the sum in the rank type, stored as int32 (put_row casts)
    wr[c] = wrap32(add_(static_cast<long long>(wr[c]),
                        static_cast<long long>(add)));
    endr[c] = max_(endr[c], re);
    beg[c] = min_(beg[c], qb);
    end[c] = max_(end[c], qe);
  }
  const int n = p.n[b];
  uint64_t alive = 0;
  for (int c = 0; c < C; ++c) {
    const int32_t w = c < n ? min_(wq[c], wr[c]) : -1;
    const bool a = c < n && w >= p.min_chain_weight;
    weight[c] = a ? w : -1;
    alive |= static_cast<uint64_t>(a) << c;
  }
  // the order: weight-descending, ties by chain pos ascending. pos_rank
  // is the stable rank of where(exists, pos, 0x7FFFFFFF); combined =
  // weight * C + (C - 1 - pos_rank) is unique, and rank_of (a slot's
  // place in the order) the stable rank of -combined
  const R* pos = static_cast<const R*>(p.pos) + b * p.C;
  R* const pkey = endr;   // the reference ends are spent
  for (int c = 0; c < C; ++c) pkey[c] = c < n ? pos[c] : R(kPosFill);
  for (int c = 0; c < C; ++c) {   // key = -combined
    int r = 0;
    for (int k = 0; k < C; ++k)
      r += pkey[k] < pkey[c] || (pkey[k] == pkey[c] && k < c);
    key[c] = wrap32(-static_cast<long long>(wrap32(
        static_cast<long long>(weight[c]) * C + (C - 1 - r))));
  }
  for (int c = 0; c < C; ++c) {
    int r = 0;
    for (int k = 0; k < C; ++k)
      r += key[k] < key[c] || (key[k] == key[c] && k < c);
    rank_of[c] = r;
    order[r] = c;
  }
  for (int c = 0; c < C; ++c) {
    kept[c] = 0;
    first[c] = -1;
  }
  if ((alive >> order[0]) & 1) kept[order[0]] = 3;   // the best is kept
  // the shadow loop, in weight order: a chain overlapped by a kept chain
  // (mask_level of the shorter span) is dropped when much lighter than
  // the first such chain that drops it, and marks the kept chains up to
  // that one as its shadows
  const float mask_level = p.mask_level;
  const float drop_ratio = p.chain_drop_ratio;
  for (int r = 1; r < C; ++r) {
    const int ci = order[r];
    if (!((alive >> ci) & 1)) continue;
    const int32_t bi = beg[ci], ei = end[ci], wi = weight[ci];
    const int32_t li = sub_(ei, bi);
    int32_t first_drop = kBegFill;
    bool large = false;
    for (int pass = 0; pass < 2; ++pass) {
      for (int j = 0; j < C; ++j) {
        if (kept[j] <= 0) continue;
        const int32_t b_max = max_(beg[j], bi);
        const int32_t e_min = min_(end[j], ei);
        const int32_t min_l = min_(li, sub_(end[j], beg[j]));
        const bool sig = e_min > b_max &&
                         static_cast<float>(sub_(e_min, b_max)) >=
                             mul_f32(static_cast<float>(min_l), mask_level) &&
                         min_l < p.max_chain_gap;
        if (!sig) continue;
        if (pass == 0) {
          const bool drop =
              static_cast<float>(wi) <
                  mul_f32(static_cast<float>(weight[j]), drop_ratio) &&
              sub_(weight[j], wi) >=
                  p.min_seed_len * 2;
          if (drop) first_drop = min_(first_drop, rank_of[j]);
        } else if (rank_of[j] <= first_drop) {
          large = true;
          if (first[j] < 0) first[j] = ci;
        }
      }
    }
    if (kept[ci] == 0)
      kept[ci] = first_drop < kBegFill ? 0 : (large ? 2 : 3);
  }
  // promote the shadows that kept chains reference, in slot order
  for (int c = 0; c < C; ++c) {
    const int32_t fi = first[c];
    if (kept[c] > 0 && fi >= 0) {
      const int f = min_(fi, C - 1);
      if (kept[f] == 0) kept[f] = 1;
    }
  }
  const long long out = b * p.C;
  for (int c = 0; c < C; ++c) {
    p.weight[out + c] = weight[c];
    p.kept[out + c] = kept[c];
    p.order[out + c] = order[c];
    p.beg[out + c] = beg[c];
    p.end[out + c] = end[c];
  }
}

#ifdef __CUDACC__
template <typename R, int K>
__global__ void __launch_bounds__(kThreads, kChainMinBlocks)
    chain_seeds(const ChainParams p) {
  extern __shared__ __align__(16) unsigned char chain_smem[];
  const int g = threadIdx.x / kChainGroup;
  const long long b =
      static_cast<long long>(blockIdx.x) * (kThreads / kChainGroup) + g;
  if (b < p.B)
    chain_seeds_group<R, K>(
        p, b, ChainSmem<R>(chain_smem + g * chain_bytes<R>(p.C),
                           static_cast<int>(p.C)));
}

// chain_seeds at the K that C takes, each K its own kernel (its own
// registers)
template <typename R>
void launch_chain_seeds(const ChainParams& p, unsigned grid, unsigned smem,
                        cudaStream_t stream) {
  switch (chains_a_lane(p.C)) {
    case 1: chain_seeds<R, 1><<<grid, kThreads, smem, stream>>>(p); break;
    case 2: chain_seeds<R, 2><<<grid, kThreads, smem, stream>>>(p); break;
    case 4: chain_seeds<R, 4><<<grid, kThreads, smem, stream>>>(p); break;
    default: chain_seeds<R, 8><<<grid, kThreads, smem, stream>>>(p); break;
  }
}

template <typename R>
__global__ void __launch_bounds__(kThreads)
    filter_chains(const FilterParams p) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (b < p.B) filter_chains_lane<R>(p, b);
}
#endif

bool refused(long long rank_bytes, long long B, long long C) {
  return (rank_bytes != 4 && rank_bytes != 8) || B < 1 || C < 1 ||
         C > kMaxChains;
}

}  // namespace


// chain_seeds_launch (nvcc; on `stream`) or chain_seeds_host (a host
// compiler; every read in turn): 0, or a CUDA error code (kRefused for a
// refused shape)
extern "C" int LANE_ENTRY(chain_seeds)(
    long long rank_bytes, const void* rbeg, const int32_t* qbeg,
    const int32_t* len, const int32_t* rid, const uint8_t* valid, void* pos,
    int32_t* crid, int32_t* f_qbeg, void* f_rbeg, int32_t* l_qbeg,
    void* l_rbeg, int32_t* l_len, int32_t* n, int32_t* assign,
    uint8_t* overflow, long long l_pac, long long B, long long S,
    long long C, long long bandwidth, long long max_chain_gap LANE_STREAM) {
  if (refused(rank_bytes, B, C)) return kRefused;
  const ChainParams p{rbeg,   qbeg,     len,   rid,    valid,  pos,
                      crid,   f_qbeg,   f_rbeg, l_qbeg, l_rbeg, l_len,
                      n,      assign,   overflow, l_pac, B,     S,
                      C,      bandwidth, max_chain_gap};
  const long long bytes = rank_bytes == 8 ? chain_bytes<long long>(C)
                                          : chain_bytes<int32_t>(C);
#ifdef __CUDACC__
  constexpr auto reads = kThreads / kChainGroup;
  const unsigned grid = static_cast<unsigned>((B + reads - 1) / reads);
  const unsigned smem = static_cast<unsigned>(reads * bytes);
  if (rank_bytes == 8)
    launch_chain_seeds<long long>(p, grid, smem, stream);
  else
    launch_chain_seeds<int32_t>(p, grid, smem, stream);
  return static_cast<int>(cudaGetLastError());
#else
  unsigned char* buf = new unsigned char[bytes];
  for (long long b = 0; b < B; ++b) {
    if (rank_bytes == 8)
      chain_seeds_read<long long>(p, b, buf);
    else
      chain_seeds_read<int32_t>(p, b, buf);
  }
  delete[] buf;
  return 0;
#endif
}

// filter_chains_launch / filter_chains_host, as above
extern "C" int LANE_ENTRY(filter_chains)(
    long long rank_bytes, const int32_t* assign, const int32_t* n,
    const void* pos, const void* rbeg, const int32_t* qbeg,
    const int32_t* len, int32_t* weight, int32_t* kept, int32_t* order,
    int32_t* beg, int32_t* end, double mask_level, double chain_drop_ratio,
    long long min_chain_weight, long long min_seed_len,
    long long max_chain_gap, long long B, long long S,
    long long C LANE_STREAM) {
  if (refused(rank_bytes, B, C)) return kRefused;
  const FilterParams p{assign, n, pos, rbeg, qbeg, len, weight, kept, order,
                       beg, end, static_cast<float>(mask_level),
                       static_cast<float>(chain_drop_ratio), min_chain_weight,
                       min_seed_len, max_chain_gap, B, S, C};
#ifdef __CUDACC__
  const unsigned grid = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  if (rank_bytes == 8)
    filter_chains<long long><<<grid, kThreads, 0, stream>>>(p);
  else
    filter_chains<int32_t><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
#else
  for (long long b = 0; b < B; ++b) {
    if (rank_bytes == 8)
      filter_chains_lane<long long>(p, b);
    else
      filter_chains_lane<int32_t>(p, b);
  }
  return 0;
#endif
}
