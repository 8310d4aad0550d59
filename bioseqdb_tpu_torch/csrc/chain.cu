// Chaining and the chain filter for Hopper: every trip of every loop of a
// read in one launch, a group of 8 threads a read (chain_seeds) or of 16
// or 32, a lane a chain (filter_chains).
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
// - filter_chains: a group of threads a read, a lane a chain: 16 threads
//   for C up to 16 (8 reads a 128-thread block, so 16,384 reads make
//   2,048 blocks, about one resident wave), a warp past it, two chains a
//   lane past 32 (C is 16 at W <= 512, 32 above, 64 in the long-read fat
//   retry; the wrapper refuses more). A chain's state (its weight folds,
//   beg, end, weight, kept, first shadow and place in the order) lives in
//   its lane's registers; what other lanes read (the order keys, the
//   order with each place's beg / end / weight, the first shadows) in the
//   group's shared memory. The seed slots stream in passes of 64, so S is
//   unbounded: a pass's assign loads coalesced, an assigned slot's fields
//   go to shared memory and its bit into its chain's 64-bit mask, and each
//   lane folds its own chains' seeds in slot order (a chain's weight
//   depends on that order). The two stable ranks of the order are a
//   lane's compares against the group's keys; the shadow loop's trips run
//   over the alive chains in weight order, each a group test of every
//   kept chain against the trip's (a group min of the drop chains' places,
//   a ballot for `large`); the promotion loop walks the kept chains with
//   a shadow in slot order as uniform mask arithmetic. The outputs go out
//   as coalesced rows.
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
//   chain by a group min over every lane's tests and updates first after
//   it.
// - The per-read bodies are group bodies (csrc/lanes.cuh). Compiled
//   without nvcc (g++ -x c++), the file gives host entry points that run
//   the same bodies over every read, a group's lanes in turn, so the
//   logic can be held against the plain versions on a machine without a
//   card.

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

// filter_chains' group: G threads a read, lane t holding chains t, t + G,
// .., t + (K - 1) * G (16 threads for C up to 16, a warp past it, two
// chains a lane past 32)
LANE_HD inline int filter_group(long long C) { return C <= 16 ? 16 : 32; }
LANE_HD inline int filter_chains_a_lane(long long C) {
  return C <= 32 ? 1 : 2;
}
constexpr int kFilterPass = 64;   // a filter group's seed slots a pass

// a filter group's shared memory (or, on the host, a buffer)
template <typename R>
struct FilterSmem {
  uint64_t* seeds;     // [C] a chain's assigned slots in the pass, a bit each
  uint64_t* alive_at;  // [1] the places in the order that alive chains hold
  R* rb;               // [kFilterPass] an assigned slot's rbeg, by its place
  R* pkey;             // [C] the order's position keys
  int32_t* qb;         // [kFilterPass] an assigned slot's qbeg
  int32_t* ln;         // [kFilterPass] its len
  int32_t* key;        // [C] -combined
  int32_t* order;      // [C] the chain at each place of the order
  int32_t* obeg;       // [C] beg, end and weight of that chain
  int32_t* oend;
  int32_t* ow;
  int32_t* first;      // [C] each chain's first shadow, for the promotion
  LANE_HD FilterSmem(unsigned char* base, int C)
      : seeds(reinterpret_cast<uint64_t*>(base)),
        alive_at(seeds + C),
        rb(reinterpret_cast<R*>(alive_at + 1)),
        pkey(rb + kFilterPass),
        qb(reinterpret_cast<int32_t*>(pkey + C)),
        ln(qb + kFilterPass),
        key(ln + kFilterPass),
        order(key + C),
        obeg(order + C),
        oend(obeg + C),
        ow(oend + C),
        first(ow + C) {}
};

template <typename R>
LANE_HD inline long long filter_bytes(long long C) {
  return (8 * (C + 1) +
          static_cast<long long>(sizeof(R)) * (kFilterPass + C) +
          4 * (2 * kFilterPass + 6 * C) + 15) &
         ~15LL;
}

// mem_chain_flt for read b (filter_chains_plain, one read) by a group of G
// threads, K chains a lane
template <typename R, int G, int K>
GROUP_FN void filter_chains_group(const FilterParams& p, long long b,
                                  FilterSmem<R> sm) {
  const int C = static_cast<int>(p.C);
  // a lane's chains' folds, in registers
  Lanes<int32_t, G> wq[K], endq[K], wr[K], beg[K], end[K];
  Lanes<R, G> endr[K];
  FOR_LANES(G, t) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      wq[k][t] = endq[k][t] = wr[k][t] = end[k][t] = 0;
      endr[k][t] = 0;
      beg[k][t] = kBegFill;
    }
    for (int c = t; c < C; c += G) sm.seeds[c] = 0;
    if (t == 0) *sm.alive_at = 0;
  }
  group_sync<G>();
  // the weights: each assigned seed adds the part of its query and of its
  // reference span past its chain's end so far, in slot order. A pass's
  // assign loads together (coalesced); an assigned slot's fields go to
  // shared memory and its bit to its chain's mask, and each lane then
  // folds its chains' seeds alone, in slot order (their bits ascending).
  const long long row = b * p.S;
  const R* rbegs = static_cast<const R*>(p.rbeg) + row;
  constexpr int U = kFilterPass / G;   // a lane's slots a pass
  for (long long base = 0; base < p.S; base += kFilterPass) {
    Lanes<int32_t, G> a[U];
    FOR_LANES(G, t) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long s = base + u * G + t;
        a[u][t] = s < p.S ? p.assign[row + s] : -1;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (a[u][t] < 0) continue;
        const int i = u * G + t;
        const long long s = base + i;
        sm.rb[i] = rbegs[s];
        sm.qb[i] = p.qbeg[row + s];
        sm.ln[i] = p.len[row + s];
        fold_or(sm.seeds + min_(a[u][t], C - 1), 1ULL << i);
      }
    }
    group_sync<G>();
    FOR_LANES(G, t) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = k * G + t;
        if (c >= C) continue;
        for (uint64_t m = sm.seeds[c]; m != 0; m &= m - 1) {
          const int i = low_bit64(m);
          const int32_t qb = sm.qb[i], ln = sm.ln[i];
          const R rb = sm.rb[i];
          const int32_t qe = add_(qb, ln);
          wq[k][t] = add_(wq[k][t], qb >= endq[k][t]
                                        ? ln
                                        : max_(sub_(qe, endq[k][t]), 0));
          endq[k][t] = max_(endq[k][t], qe);
          const R re = add_(rb, static_cast<R>(ln));
          const R add = rb >= endr[k][t] ? static_cast<R>(ln)
                                         : max_(sub_(re, endr[k][t]), R(0));
          // the sum in the rank type, stored as int32 (put_row casts)
          wr[k][t] = wrap32(add_(static_cast<long long>(wr[k][t]),
                                 static_cast<long long>(add)));
          endr[k][t] = max_(endr[k][t], re);
          beg[k][t] = min_(beg[k][t], qb);
          end[k][t] = max_(end[k][t], qe);
        }
        sm.seeds[c] = 0;
      }
    }
    group_sync<G>();   // the pass is folded before the next one loads
  }
  // the order: weight-descending, ties by chain pos ascending. pos_rank
  // is the stable rank of where(exists, pos, 0x7FFFFFFF); combined =
  // weight * C + (C - 1 - pos_rank) is unique, and rank_of (a chain's
  // place in the order) the stable rank of -combined: a lane ranks its
  // chains by compares against the group's keys in shared memory
  const int n = p.n[b];
  const R* pos = static_cast<const R*>(p.pos) + b * p.C;
  Lanes<int32_t, G> weight[K], rank_of[K];
  Lanes<bool, G> alive[K];
  FOR_LANES(G, t) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = k * G + t;
      const int32_t w = c < n ? min_(wq[k][t], wr[k][t]) : -1;
      alive[k][t] = c < C && c < n && w >= p.min_chain_weight;
      weight[k][t] = alive[k][t] ? w : -1;
      if (c < C) sm.pkey[c] = c < n ? pos[c] : R(kPosFill);
    }
  }
  group_sync<G>();
  FOR_LANES(G, t) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = k * G + t;
      if (c >= C) continue;
      const R v = sm.pkey[c];
      int r = 0;
      for (int j = 0; j < C; ++j) {
        const R u = sm.pkey[j];
        r += u < v || (u == v && j < c);
      }
      sm.key[c] = wrap32(-static_cast<long long>(wrap32(
          static_cast<long long>(weight[k][t]) * C + (C - 1 - r))));
    }
  }
  group_sync<G>();
  FOR_LANES(G, t) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = k * G + t;
      rank_of[k][t] = 0;
      if (c >= C) continue;
      const int32_t v = sm.key[c];
      int r = 0;
      for (int j = 0; j < C; ++j) {
        const int32_t u = sm.key[j];
        r += u < v || (u == v && j < c);
      }
      rank_of[k][t] = r;
      sm.order[r] = c;
      sm.obeg[r] = beg[k][t];
      sm.oend[r] = end[k][t];
      sm.ow[r] = weight[k][t];
      if (alive[k][t]) fold_or(sm.alive_at, 1ULL << r);
    }
  }
  group_sync<G>();
  // the best is kept; then the shadow loop, in weight order, over the
  // alive chains alone: a chain overlapped by a kept chain (mask_level of
  // the shorter span) is dropped when much lighter than the first such
  // chain that drops it, and marks the kept chains up to that one as its
  // shadows. Lane j tests its chains against the trip's, every test
  // reading kept as it stood before the trip; the first drop is a group
  // min of the drop chains' places, `large` a ballot.
  const uint64_t alive_at = *sm.alive_at;
  const int best = sm.order[0];
  Lanes<int32_t, G> kept[K], first[K];
  FOR_LANES(G, t) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      kept[k][t] = (alive_at & 1) && k * G + t == best ? 3 : 0;
      first[k][t] = -1;
    }
  }
  const float mask_level = p.mask_level;
  const float drop_ratio = p.chain_drop_ratio;
  for (uint64_t todo = alive_at & ~1ULL; todo != 0; todo &= todo - 1) {
    const int r = low_bit64(todo);
    const int ci = sm.order[r];
    const int32_t bi = sm.obeg[r], ei = sm.oend[r], wi = sm.ow[r];
    const int32_t li = sub_(ei, bi);
    Lanes<bool, G> sig[K];
    Lanes<int32_t, G> drop_at;
    FOR_LANES(G, t) {
      drop_at[t] = kBegFill;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        sig[k][t] = false;
        if (kept[k][t] <= 0) continue;
        const int32_t bj = beg[k][t], ej = end[k][t], wj = weight[k][t];
        const int32_t b_max = max_(bj, bi);
        const int32_t e_min = min_(ej, ei);
        const int32_t min_l = min_(li, sub_(ej, bj));
        sig[k][t] = e_min > b_max &&
                    static_cast<float>(sub_(e_min, b_max)) >=
                        mul_f32(static_cast<float>(min_l), mask_level) &&
                    min_l < p.max_chain_gap;
        const bool drop =
            sig[k][t] &&
            static_cast<float>(wi) <
                mul_f32(static_cast<float>(wj), drop_ratio) &&
            sub_(wj, wi) >= p.min_seed_len * 2;
        if (drop) drop_at[t] = min_(drop_at[t], rank_of[k][t]);
      }
    }
    const int32_t first_drop = group_min<G>(drop_at);
    Lanes<bool, G> large;
    FOR_LANES(G, t) {
      large[t] = false;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!sig[k][t] || rank_of[k][t] > first_drop) continue;
        large[t] = true;
        if (first[k][t] < 0) first[k][t] = ci;
      }
    }
    const bool any_large = ballot(large) != 0;
    FOR_LANES(G, t) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k * G + t == ci && kept[k][t] == 0)
          kept[k][t] = first_drop < kBegFill ? 0 : (any_large ? 2 : 3);
      }
    }
  }
  // promote the shadows that kept chains reference, in slot order: a
  // promoted chain past the one that promotes it promotes in its turn.
  // Every thread of the group runs the loop on the same masks.
  uint64_t kept_at = 0, has_first = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    Lanes<bool, G> kp, hf;
    FOR_LANES(G, t) {
      const int c = k * G + t;
      kp[t] = c < C && kept[k][t] > 0;
      hf[t] = c < C && first[k][t] >= 0;
      if (c < C) sm.first[c] = first[k][t];
    }
    kept_at |= static_cast<uint64_t>(ballot(kp)) << (k * G);
    has_first |= static_cast<uint64_t>(ballot(hf)) << (k * G);
  }
  group_sync<G>();
  uint64_t promoted = 0;
  for (uint64_t todo = kept_at & has_first; todo != 0; todo &= todo - 1) {
    const int c = low_bit64(todo);
    const int f = min_(sm.first[c], C - 1);
    if ((kept_at >> f) & 1) continue;
    kept_at |= 1ULL << f;
    promoted |= 1ULL << f;
    if (f > c && ((has_first >> f) & 1)) todo |= 1ULL << f;
  }
  // the outputs, a coalesced row each
  const long long out = b * p.C;
  FOR_LANES(G, t) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = k * G + t;
      if (c >= C) continue;
      p.weight[out + c] = weight[k][t];
      p.kept[out + c] = (promoted >> c) & 1 ? 1 : kept[k][t];
      p.order[out + c] = sm.order[c];
      p.beg[out + c] = beg[k][t];
      p.end[out + c] = end[k][t];
    }
  }
}

#ifndef __CUDACC__
// filter_chains_group at the G and K that C takes (the host build's
// dispatch; the card's is launch_filter_chains)
template <typename R>
void filter_chains_read(const FilterParams& p, long long b,
                        unsigned char* smem) {
  const FilterSmem<R> sm(smem, static_cast<int>(p.C));
  if (filter_group(p.C) == 16)
    filter_chains_group<R, 16, 1>(p, b, sm);
  else if (filter_chains_a_lane(p.C) == 1)
    filter_chains_group<R, 32, 1>(p, b, sm);
  else
    filter_chains_group<R, 32, 2>(p, b, sm);
}
#endif

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

template <typename R, int G, int K>
__global__ void __launch_bounds__(kThreads)
    filter_chains(const FilterParams p) {
  extern __shared__ __align__(16) unsigned char filter_smem[];
  const int g = threadIdx.x / G;
  const long long b = static_cast<long long>(blockIdx.x) * (kThreads / G) + g;
  if (b < p.B)
    filter_chains_group<R, G, K>(
        p, b, FilterSmem<R>(filter_smem + g * filter_bytes<R>(p.C),
                            static_cast<int>(p.C)));
}

// filter_chains at the G and K that C takes, each its own kernel
template <typename R>
void launch_filter_chains(const FilterParams& p, cudaStream_t stream) {
  const int G = filter_group(p.C);
  const unsigned grid = static_cast<unsigned>((p.B + kThreads / G - 1) /
                                              (kThreads / G));
  const unsigned smem =
      static_cast<unsigned>(kThreads / G * filter_bytes<R>(p.C));
  if (G == 16)
    filter_chains<R, 16, 1><<<grid, kThreads, smem, stream>>>(p);
  else if (filter_chains_a_lane(p.C) == 1)
    filter_chains<R, 32, 1><<<grid, kThreads, smem, stream>>>(p);
  else
    filter_chains<R, 32, 2><<<grid, kThreads, smem, stream>>>(p);
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
  if (rank_bytes == 8)
    launch_filter_chains<long long>(p, stream);
  else
    launch_filter_chains<int32_t>(p, stream);
  return static_cast<int>(cudaGetLastError());
#else
  unsigned char* buf = new unsigned char[rank_bytes == 8
                                             ? filter_bytes<long long>(C)
                                             : filter_bytes<int32_t>(C)];
  for (long long b = 0; b < B; ++b) {
    if (rank_bytes == 8)
      filter_chains_read<long long>(p, b, buf);
    else
      filter_chains_read<int32_t>(p, b, buf);
  }
  delete[] buf;
  return 0;
#endif
}
