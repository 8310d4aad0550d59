// Seed resolution around the SA walk, for Hopper: the expansion of each
// read's seed intervals into its seed slots, and the tests and outputs
// after the walk, each one launch.
//
// Replaces the TPU program of bioseqdb_tpu/kernels/chain.py resolve_seeds
// (:44-157) but its SA walk (csrc/fm.cu sa_resolve, launched between the
// two; under an index mesh csrc/fm_shard.cu's sharded walk, of the lanes
// the plain twin walks: kernels/chain.py resolve_seeds_sharded): the argsort of the intervals (:76), their counts and exclusive
// offsets (:84), each slot's interval (:90-105), the compaction cap's
// global offsets (:119) and the bridge and reference tests (:141-148). XLA
// compiled them into the one TPU device program; no Pallas. The kernels
// compute exactly what the plain version bioseqdb_tpu_torch/kernels/
// chain.py resolve_seeds_plain computes (the vectorised port, which equals
// the JAX package).
//
// What bounds them: resolve_expand reads a read's M intervals (5 values
// each) and writes its S slots (three R values and two flags each);
// resolve_finish reads those and the walked positions and writes the six
// outputs. Between, a read sorts its live intervals' keys, scans their
// counts and finds each slot's interval, all in shared memory: tens of
// instructions a slot. So the card's memory rate bounds them, and a
// launch costs about its bytes plus each read's short chain of shared
// memory passes.
//
// Design:
// - A warp a read, up to 4 a block, its intervals in shared memory sized
//   by the call; a read whose intervals do not fit a block's 48 KB
//   (M past 1,536 with int32 ranks, 877 with int64: reads of about 24 kb
//   and 13 kb on the FM seeder's M = W // 16 + 48) keeps them in a
//   scratch buffer in device memory instead, which the wrapper allocates
//   (a read's row of it, the same layout).
// - resolve_expand loads the read's [M, 5] block (contiguous) coalesced
//   into shared memory once. The plain version's stable argsort of the M
//   keys (dead intervals' kDeadKey) sorts the n_mem live keys alone, as
//   (key, index) entries, by csrc/sort.cuh's bitonic networks: in
//   registers as 32-bit entries where M <= 32 and the keys lie in [0,
//   2^27) (the main path: M 24), else as 64-bit ones (in
//   registers up to 32, in shared memory past it); the dead intervals
//   follow in index order, placed by arithmetic. That holds
//   wherever no live key lies past kDeadKey (a ballot); where one does,
//   all M are sorted, and where an int64 key does not fit 32 bits (a
//   ballot) every (key, index) pair is ranked by compares instead. The
//   exclusive offsets of the sorted counts are int32, the low 32 bits of
//   the plain version's 64-bit sums: a warp scan by shuffles of the
//   counts' low 32 bits, wrapping. A slot's interval is the number of
//   offsets at or below it, less one, a lane a slot: an upper-bound
//   binary search where no offset falls (a ballot), else the count
//   itself, which equals the plain version's compare-and-sum whatever
//   the offsets (negative counts and wrapped sums included).
// - resolve_expand writes the walk's ranks (a position row's position in
//   its rank's place: the walk's mask leaves it alone), the slot's query
//   start and seed length, the walk's mask (the valid rank rows) and each
//   read's count of walking lanes and its total > S overflow. The walk's
//   mask holds every walking lane, not only those under the compaction
//   cap: a lane past the cap is masked out of every output after the
//   walk, as the plain version masks it, so the cap is applied there.
// - The cap's global offset of a lane is the batch's running count of
//   walking lanes: the reads before it (one library cumsum over the B
//   per-read counts, the only op between the launches) plus its index
//   among its read's walking lanes, which resolve_finish counts with
//   ballots over chunks of 32 slots.
// - resolve_finish: a warp a read, a lane a slot: the position (the walk's,
//   or the position row's), the bridge test at l_pac, both ends' forward
//   positions and their references (a binary search over the reference
//   offsets that equals torch.searchsorted(right=True) - 1 on their
//   sorted table), and the six outputs.
// - Ranks and positions take the template type R (int32 or int64, the
//   index's rank dtype); sums and products wrap in R as the tensors' do.
// - The lane bodies build for the host too (GROUP_FN, lanes.cuh):
//   compiled without nvcc, the file gives entries resolve_expand_host and
//   resolve_finish_host that run every read in turn.

#include <type_traits>

#include "lanes.cuh"
#include "sort.cuh"

namespace {

constexpr int kGroup = 32;        // a read's threads
constexpr int kLoads = 4;         // a lane's loads of intervals at once
constexpr int kReads = 4;         // a block's reads at most
constexpr int kSmem = 49152;      // a block's shared memory at most
constexpr int kRefused = 1;       // cudaErrorInvalidValue
constexpr long long kDeadKey = 0x3FFFFFFF;   // a dead interval's sort key

template <typename R>
LANE_HD inline R wadd(R a, R b) {
  using U = typename std::conditional<sizeof(R) == 8, unsigned long long,
                                      uint32_t>::type;
  return static_cast<R>(static_cast<U>(a) + static_cast<U>(b));
}
template <typename R>
LANE_HD inline R wsub(R a, R b) {
  using U = typename std::conditional<sizeof(R) == 8, unsigned long long,
                                      uint32_t>::type;
  return static_cast<R>(static_cast<U>(a) - static_cast<U>(b));
}
template <typename R>
LANE_HD inline R wmul(R a, R b) {
  using U = typename std::conditional<sizeof(R) == 8, unsigned long long,
                                      uint32_t>::type;
  return static_cast<R>(static_cast<U>(a) * static_cast<U>(b));
}
// torch's // on R: the quotient rounded toward minus infinity
template <typename R>
LANE_HD inline R floordiv(R a, R d) {
  const R q = a / d;
  return (a % d != 0 && ((a < 0) != (d < 0))) ? q - 1 : q;
}

struct ExpandParams {
  const void* mems;       // [B, M, 5] R: k, l, s, start, end
  const int32_t* n_mem;   // [B]
  void* ranks;            // [B, S] R out: the walk's rank, a position
                          // row's position, else 1
  void* start;            // [B, S] R out: the slot's query start
  void* slen;             // [B, S] R out: its seed's length (end - start)
  uint8_t* walk;          // [B, S] out: a valid rank row (the walk's mask)
  uint8_t* posrow;        // [B, S] out: a valid position row
  int32_t* n_walk;        // [B] out: the read's walking lanes
  uint8_t* over;          // [B] out: its intervals hold more than S seeds
  unsigned char* scratch; // [B, expand_bytes(M)] or null: the reads'
                          // intervals in shared memory
  long long B, M, S, max_occ;
};

struct FinishParams {
  const void* ranks;      // [B, S] R: resolve_expand's
  const void* start;
  const void* slen;
  const uint8_t* walk;
  const uint8_t* posrow;
  const int32_t* n_walk;  // [B]
  const uint8_t* over;    // [B]
  const void* pos;        // [B, S] R: the walked positions
  const long long* ends;  // [B] the running count of walking lanes through
                          // each read (inclusive), or null: no cap
  const void* ref_offsets;   // [n_refs] R, sorted
  void* rbeg;             // [B, S] R out
  int32_t* qbeg;          // [B, S] out
  int32_t* len;           // [B, S] out
  int32_t* rid;           // [B, S] out
  uint8_t* valid;         // [B, S] out
  uint8_t* overflow;      // [B] out
  long long B, S, n_refs, cap, l_pac, seq_len;
};

// a read's interval tables: six rank values and two int32 an interval
// (of which the layout below uses 5 R + 12 bytes), rounded up to 16
template <typename R>
LANE_HD inline long long expand_bytes(long long M) {
  return (M * (6 * static_cast<long long>(sizeof(R)) + 8) + 15) & ~15LL;
}

template <typename R>
struct ExpandSmem {
  uint64_t* sort;  // [M] the sort's entries; after it, off
  int32_t* off;    // [M] the exclusive offsets of the counts, in sorted
                   // order (int32, as the plain version casts them)
  R* raw;          // [M, 5] the read's intervals: k, l, s, start, end
  int32_t* perm;   // [M] the interval at each sorted place
  LANE_HD ExpandSmem(unsigned char* base, long long M)
      : sort(reinterpret_cast<uint64_t*>(base)),
        off(reinterpret_cast<int32_t*>(base)),
        raw(reinterpret_cast<R*>(sort + M)),
        perm(reinterpret_cast<int32_t*>(raw + 5 * M)) {}
};

// an interval's sort key (resolve_seeds_plain's key of a live one)
template <typename R>
LANE_HD inline R interval_key(const R* row) {
  return wadd(wmul(row[3], static_cast<R>(4096)),
              min_(row[4], static_cast<R>(4095)));
}

// read b's intervals expanded into its S slots (resolve_seeds_plain up to
// the walk), by a group of kGroup threads. Indices within a read are int
// (the entry refuses an M or S past them).
template <typename R>
GROUP_FN void expand_group(const ExpandParams& p, long long b,
                           ExpandSmem<R> sm) {
  constexpr auto G = kGroup;
  const int M = static_cast<int>(p.M), S = static_cast<int>(p.S);
  const R* mems = static_cast<const R*>(p.mems) + b * p.M * 5;
  const int n_live = static_cast<int>(
      min_(max_<long long>(p.n_mem[b], 0), p.M));
  const R max_occ = static_cast<R>(p.max_occ);
  const R dead = static_cast<R>(kDeadKey);
  // the read's [M, 5] block (contiguous), loaded coalesced once, a lane's
  // kLoads loads issued before any is stored
  for (int i0 = 0; i0 < 5 * M; i0 += kLoads * G) {
    Lanes<R, G> v[kLoads];
    FOR_LANES(G, t) {
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * G + t;
        v[u][t] = i < 5 * M ? mems[i] : static_cast<R>(0);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * G + t;
        if (i < 5 * M) sm.raw[i] = v[u][t];
      }
    }
  }
  group_sync<G>();
  // the plain version's stable argsort of the keys (the dead ones
  // kDeadKey). Dead intervals come after every live one in index order
  // wherever no live key lies past kDeadKey (a live one equal to it has
  // the lower index), so only the live keys are sorted, and all M where
  // one does. Up to G intervals whose live keys lie in [0, 2^27) (queries
  // under 32 kb) sort in registers as 32-bit (key, index) entries, the
  // keys that fit 32 bits as 64-bit entries (in registers up to G, in the
  // buffer past it); an int64 key past 32 bits makes the read rank every
  // (key, index) pair by compares instead.
  Lanes<bool, G> high, wide, narrow;
  Lanes<uint32_t, G> small;   // lane m's 32-bit entry, where M <= G
  FOR_LANES(G, t) {
    high[t] = wide[t] = narrow[t] = false;
    small[t] = ~0u;
    for (int m = t; m < M; m += G) {
      const R key = m < n_live ? interval_key(sm.raw + 5 * m) : dead;
      high[t] = high[t] || key > dead;
      wide[t] = wide[t] || key != static_cast<R>(static_cast<int32_t>(key));
      narrow[t] = m < n_live && key >= 0 && key < (R(1) << 27);
      small[t] = (static_cast<uint32_t>(key) << 5) | static_cast<uint32_t>(m);
      sm.sort[m] = sort_entry(static_cast<int32_t>(key), m);
    }
  }
  const int n_sort = ballot(high) != 0 ? M : n_live;
  // every live key narrow: none past kDeadKey, so n_sort is n_live
  if (M <= G && popc32(ballot(narrow)) == n_live) {
    small = lane_sort<G>(small, n_live, ~0u);
    FOR_LANES(G, t) {
      if (t < M)
        sm.perm[t] = t < n_live ? static_cast<int32_t>(small[t] & 31u) : t;
    }
  } else if (ballot(wide) == 0) {
    group_sync<G>();
    group_sort<G>(sm.sort, n_sort);
    FOR_LANES(G, t) {
      for (int r = t; r < M; r += G)
        sm.perm[r] = r < n_sort ? entry_slot(sm.sort[r]) : r;
    }
  } else {
    auto key_of = [&](int m) {
      return m < n_live ? interval_key(sm.raw + 5 * m) : dead;
    };
    FOR_LANES(G, t) {
      for (int m = t; m < M; m += G) {
        const R v = key_of(m);
        int r = 0;
        for (int i = 0; i < M; ++i) {
          const R u = key_of(i);
          r += u < v || (u == v && i < m);
        }
        sm.perm[r] = m;
      }
    }
  }
  group_sync<G>();
  // the counts in sorted order and their exclusive offsets, int32 as the
  // plain version casts its 64-bit sums: the low 32 bits of the counts
  // summed by a warp scan a chunk of G, wrapping
  auto count_at = [&](int r) {
    const int m = sm.perm[r];
    return m < n_live ? min_(sm.raw[5 * m + 2], max_occ) : static_cast<R>(0);
  };
  uint32_t carry = 0;
  for (int c0 = 0; c0 < M; c0 += G) {
    Lanes<uint32_t, G> cnt, incl;
    FOR_LANES(G, t) {
      cnt[t] = incl[t] =
          c0 + t < M ? static_cast<uint32_t>(count_at(c0 + t)) : 0u;
    }
    for (int d = 1; d < G; d <<= 1) {
      const Lanes<uint32_t, G> up = shfl_up<G>(incl, d);
      FOR_LANES(G, t) {
        if (t >= d) incl[t] += up[t];
      }
    }
    FOR_LANES(G, t) {
      if (c0 + t < M)
        sm.off[c0 + t] = static_cast<int32_t>(carry + incl[t] - cnt[t]);
    }
    carry += shfl<G>(incl, G - 1);
  }
  group_sync<G>();
  // offsets that never fall (no negative count, no int32 wrap): a slot's
  // count of offsets at or below it is an upper-bound search; else the
  // count itself
  Lanes<bool, G> falls;
  FOR_LANES(G, t) {
    falls[t] = false;
    for (int r = t; r + 1 < M; r += G)
      falls[t] = falls[t] || sm.off[r] > sm.off[r + 1];
  }
  const bool rising = ballot(falls) == 0;
  const R total = wadd(static_cast<R>(sm.off[M - 1]), count_at(M - 1));
  const R lim = min_(total, static_cast<R>(S));
  const long long row = b * p.S;
  R* const ranks = static_cast<R*>(p.ranks) + row;
  R* const start = static_cast<R*>(p.start) + row;
  R* const slen = static_cast<R*>(p.slen) + row;
  Lanes<int32_t, G> walking;
  FOR_LANES(G, t) {
    walking[t] = 0;
    for (int s = t; s < S; s += G) {
      int n = 0;
      if (rising) {
        int hi = M;
        while (n < hi) {
          const int mid = (n + hi) >> 1;
          if (sm.off[mid] <= s)
            n = mid + 1;
          else
            hi = mid;
        }
      } else {
        for (int r = 0; r < M; ++r) n += sm.off[r] <= s;
      }
      const int mi = min_(max_(n - 1, 0), M - 1);
      const R* iv = sm.raw + 5 * sm.perm[mi];
      const bool valid = static_cast<R>(s) < lim;
      const bool pr = iv[1] > 0;
      const bool w = valid && !pr;
      R rank = pr ? iv[0] : static_cast<R>(1);
      if (w) {
        const R step = iv[2] > max_occ ? floordiv(iv[2], max_occ)
                                       : static_cast<R>(1);
        const int32_t off_in = static_cast<int32_t>(
            static_cast<uint32_t>(s) - static_cast<uint32_t>(sm.off[mi]));
        rank = wadd(iv[0], wmul(static_cast<R>(off_in), step));
      }
      ranks[s] = rank;
      start[s] = iv[3];
      slen[s] = wsub(iv[4], iv[3]);
      p.walk[row + s] = w;
      p.posrow[row + s] = valid && pr;
      walking[t] += w;
    }
  }
  const int32_t n_walk = group_sum(walking);
  if (group_leader<G>()) {
    p.n_walk[b] = n_walk;
    p.over[b] = total > static_cast<R>(S);
  }
}

// the doubled-text position's forward position (kernels/fm.py depos, a
// length of 1)
template <typename R>
LANE_HD inline R forward(R pos, R l_pac, R seq_len) {
  return pos >= l_pac ? wsub(wsub(seq_len, pos), static_cast<R>(1)) : pos;
}

// the reference of forward position v: torch.searchsorted(offsets, v,
// right=True) - 1 on the sorted offsets
template <typename R>
LANE_HD inline int32_t rid_of(const R* off, long long n, R v) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (off[mid] <= v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return static_cast<int32_t>(lo) - 1;
}

// read b's seeds after the walk (resolve_seeds_plain from the walk on),
// by a group of kGroup threads, a lane a slot
template <typename R>
GROUP_FN void finish_group(const FinishParams& p, long long b) {
  constexpr auto G = kGroup;
  const long long S = p.S, row = b * S;
  const R l_pac = static_cast<R>(p.l_pac), seq_len = static_cast<R>(p.seq_len);
  const R* off = static_cast<const R*>(p.ref_offsets);
  // the batch's walking lanes before this read
  const long long base =
      p.ends != nullptr ? p.ends[b] - p.n_walk[b] : 0;
  long long seen = 0;    // this read's walking lanes in earlier chunks
  bool cut = false;      // a lane past the cap
  for (long long c0 = 0; c0 < S; c0 += G) {
    Lanes<bool, G> w, trunc;
    FOR_LANES(G, t) {
      const long long s = c0 + t;
      w[t] = s < S && p.walk[row + s];
    }
    const uint32_t mw = ballot(w);
    FOR_LANES(G, t) {
      const long long s = c0 + t;
      trunc[t] = false;
      if (s >= S) continue;
      const long long j = seen + popc32(mw & ((1u << t) - 1u));
      trunc[t] = w[t] && p.ends != nullptr && base + j >= p.cap;
      const bool pr = p.posrow[row + s];
      const R pos = pr ? static_cast<const R*>(p.ranks)[row + s]
                       : static_cast<const R*>(p.pos)[row + s];
      const R sl = static_cast<const R*>(p.slen)[row + s];
      const R st = static_cast<const R*>(p.start)[row + s];
      const R end = wadd(pos, sl);
      const bool bridge = pos < l_pac && end > l_pac;
      const int32_t rb = rid_of(off, p.n_refs, forward(pos, l_pac, seq_len));
      const int32_t re = rid_of(
          off, p.n_refs,
          forward(wsub(end, static_cast<R>(1)), l_pac, seq_len));
      const bool ok = (w[t] || pr) && !trunc[t] && !bridge && rb == re;
      static_cast<R*>(p.rbeg)[row + s] = ok ? pos : static_cast<R>(0);
      p.qbeg[row + s] = ok ? static_cast<int32_t>(st) : 0;
      p.len[row + s] = ok ? static_cast<int32_t>(sl) : 0;
      p.rid[row + s] = ok ? rb : -1;
      p.valid[row + s] = ok;
    }
    cut = cut || ballot(trunc) != 0;
    seen += popc32(mw);
  }
  if (group_leader<G>()) p.overflow[b] = p.over[b] || cut;
}

#ifdef __CUDACC__
template <typename R>
__global__ void __launch_bounds__(kGroup * kReads)
    resolve_expand(const ExpandParams p, int reads) {
  extern __shared__ __align__(16) unsigned char expand_smem[];
  const int g = threadIdx.x / kGroup;
  const long long b = static_cast<long long>(blockIdx.x) * reads + g;
  const long long bytes = expand_bytes<R>(p.M);
  if (g < reads && b < p.B)
    expand_group<R>(p, b, ExpandSmem<R>(p.scratch != nullptr
                                            ? p.scratch + b * bytes
                                            : expand_smem + g * bytes,
                                        p.M));
}

template <typename R>
__global__ void __launch_bounds__(kGroup * kReads)
    resolve_finish(const FinishParams p) {
  const long long b = static_cast<long long>(blockIdx.x) * kReads +
                      threadIdx.x / kGroup;
  if (b < p.B) finish_group<R>(p, b);
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

bool bad_rank(long long rank_bytes) {
  return rank_bytes != 4 && rank_bytes != 8;
}

}  // namespace

// Each entry: resolve_*_launch (nvcc; on `stream`) or resolve_*_host (a
// host compiler; every read in turn) takes the argument array `a` of `n`
// values (kernels/resolve_cuda.py lists them: the rank size in bytes, the
// pointers, the sizes) and returns 0, or a CUDA error code (kRefused for a
// refused count, rank size or shape).

extern "C" int LANE_ENTRY(resolve_expand)(const long long* a,
                                         long long n LANE_STREAM) {
  Args g{a, n, 0};
  const long long rank_bytes = g.num();
  ExpandParams p;
  p.mems = g.ptr<const void*>();
  p.n_mem = g.ptr<const int32_t*>();
  p.ranks = g.ptr<void*>();
  p.start = g.ptr<void*>();
  p.slen = g.ptr<void*>();
  p.walk = g.ptr<uint8_t*>();
  p.posrow = g.ptr<uint8_t*>();
  p.n_walk = g.ptr<int32_t*>();
  p.over = g.ptr<uint8_t*>();
  p.scratch = g.ptr<unsigned char*>();
  p.B = g.num();
  p.M = g.num();
  p.S = g.num();
  p.max_occ = g.num();
  if (g.i != n || bad_rank(rank_bytes) || p.B < 1 || p.M < 1 || p.S < 1 ||
      p.max_occ < 1 || 5 * p.M > INT32_MAX || p.S > INT32_MAX)
    return kRefused;
  const long long bytes = rank_bytes == 8 ? expand_bytes<long long>(p.M)
                                          : expand_bytes<int32_t>(p.M);
  // a read's intervals past a block's shared memory live in the scratch
  if ((bytes > kSmem) != (p.scratch != nullptr)) return kRefused;
  const int reads = static_cast<int>(
      p.scratch != nullptr ? kReads : min_<long long>(kReads, kSmem / bytes));
#ifdef __CUDACC__
  const unsigned grid = blocks(p.B, reads);
  const unsigned smem =
      p.scratch != nullptr ? 0u : static_cast<unsigned>(reads * bytes);
  if (rank_bytes == 8)
    resolve_expand<long long><<<grid, kGroup * reads, smem, stream>>>(
        p, reads);
  else
    resolve_expand<int32_t><<<grid, kGroup * reads, smem, stream>>>(p,
                                                                     reads);
  return static_cast<int>(cudaGetLastError());
#else
  (void)reads;
  unsigned char* buf = p.scratch != nullptr ? nullptr
                                            : new unsigned char[bytes];
  for (long long b = 0; b < p.B; ++b) {
    unsigned char* at = p.scratch != nullptr ? p.scratch + b * bytes : buf;
    if (rank_bytes == 8)
      expand_group<long long>(p, b, ExpandSmem<long long>(at, p.M));
    else
      expand_group<int32_t>(p, b, ExpandSmem<int32_t>(at, p.M));
  }
  delete[] buf;
  return 0;
#endif
}

extern "C" int LANE_ENTRY(resolve_finish)(const long long* a,
                                         long long n LANE_STREAM) {
  Args g{a, n, 0};
  const long long rank_bytes = g.num();
  FinishParams p;
  p.ranks = g.ptr<const void*>();
  p.start = g.ptr<const void*>();
  p.slen = g.ptr<const void*>();
  p.walk = g.ptr<const uint8_t*>();
  p.posrow = g.ptr<const uint8_t*>();
  p.n_walk = g.ptr<const int32_t*>();
  p.over = g.ptr<const uint8_t*>();
  p.pos = g.ptr<const void*>();
  p.ends = g.ptr<const long long*>();
  p.ref_offsets = g.ptr<const void*>();
  p.rbeg = g.ptr<void*>();
  p.qbeg = g.ptr<int32_t*>();
  p.len = g.ptr<int32_t*>();
  p.rid = g.ptr<int32_t*>();
  p.valid = g.ptr<uint8_t*>();
  p.overflow = g.ptr<uint8_t*>();
  p.B = g.num();
  p.S = g.num();
  p.n_refs = g.num();
  p.cap = g.num();
  p.l_pac = g.num();
  p.seq_len = g.num();
  if (g.i != n || bad_rank(rank_bytes) || p.B < 1 || p.S < 1 ||
      p.n_refs < 1)
    return kRefused;
#ifdef __CUDACC__
  const unsigned grid = blocks(p.B, kReads);
  if (rank_bytes == 8)
    resolve_finish<long long><<<grid, kGroup * kReads, 0, stream>>>(p);
  else
    resolve_finish<int32_t><<<grid, kGroup * kReads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
#else
  for (long long b = 0; b < p.B; ++b) {
    if (rank_bytes == 8)
      finish_group<long long>(p, b);
    else
      finish_group<int32_t>(p, b);
  }
  return 0;
#endif
}
