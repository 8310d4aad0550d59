// Seed resolution around the SA walk, for Hopper: the expansion of each
// read's seed intervals into its seed slots, and the tests and outputs
// after the walk, each one launch.
//
// Replaces the TPU program of bioseqdb_tpu/kernels/chain.py resolve_seeds
// (:44-157) but its SA walk (csrc/fm.cu sa_resolve, launched between the
// two): the argsort of the intervals (:76), their counts and exclusive
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
// outputs. Between, a read does ~M^2 / 2 key compares (its sort) and ~S x
// M offset compares (each slot's interval), all in shared memory: tens of
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
//   (a read's row of it, the same layout). The plain version's stable
//   argsort of the M interval keys is a counting rank (a key's rank is
//   the number of smaller keys plus the number of equal keys at lower
//   indices; the sorted row at that rank is the interval): a lane an
//   interval. The exclusive offsets of the sorted counts are a running sum
//   in one lane (M is 16 to 142 on the port's paths). Each slot's
//   interval is the number of offsets at or below it, less one, a lane a
//   slot, which equals the plain version's compare-and-sum whatever the
//   offsets (negative counts included).
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

namespace {

constexpr int kGroup = 32;        // a read's threads
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

// a read's intervals in shared memory, sorted by their keys
template <typename R>
LANE_HD inline long long expand_bytes(long long M) {
  return (M * (6 * static_cast<long long>(sizeof(R)) + 8) + 15) & ~15LL;
}

template <typename R>
struct ExpandSmem {
  R* key;          // [M] the sort key, by the read's own order
  R* k;            // [M] by sorted position: the rank (or position)
  R* st;           // the query start
  R* en;           // the query end
  R* step;         // the sampling step
  R* cnt;          // the seeds it gives (0 if dead)
  int32_t* off;    // the exclusive offsets of cnt, int32
  int32_t* pr;     // a position row
  LANE_HD ExpandSmem(unsigned char* base, long long M)
      : key(reinterpret_cast<R*>(base)), k(key + M), st(k + M), en(st + M),
        step(en + M), cnt(step + M),
        off(reinterpret_cast<int32_t*>(cnt + M)), pr(off + M) {}
};

// read b's intervals expanded into its S slots (resolve_seeds_plain up to
// the walk), by a group of kGroup threads
template <typename R>
GROUP_FN void expand_group(const ExpandParams& p, long long b,
                           ExpandSmem<R> sm) {
  constexpr auto G = kGroup;
  const long long M = p.M, S = p.S;
  const R* mems = static_cast<const R*>(p.mems) + b * M * 5;
  const int32_t n_mem = p.n_mem[b];
  const R max_occ = static_cast<R>(p.max_occ);
  FOR_LANES(G, t) {
    for (long long m = t; m < M; m += G) {
      const R* row = mems + m * 5;
      sm.key[m] = m < n_mem ? wadd(wmul(row[3], static_cast<R>(4096)),
                                   min_(row[4], static_cast<R>(4095)))
                            : static_cast<R>(kDeadKey);
    }
  }
  group_sync<G>();
  // the stable argsort of the keys: interval m goes to its rank
  FOR_LANES(G, t) {
    for (long long m = t; m < M; m += G) {
      const R v = sm.key[m];
      long long r = 0;
      for (long long i = 0; i < M; ++i) {
        const R u = sm.key[i];
        r += u < v || (u == v && i < m);
      }
      const R* row = mems + m * 5;
      const R s = row[2];
      sm.k[r] = row[0];
      sm.st[r] = row[3];
      sm.en[r] = row[4];
      sm.step[r] = s > max_occ ? floordiv(s, max_occ) : static_cast<R>(1);
      sm.cnt[r] = m < n_mem ? min_(s, max_occ) : static_cast<R>(0);
      sm.pr[r] = row[1] > 0;
    }
  }
  group_sync<G>();
  // the exclusive offsets (summed in 64 bits, kept as int32)
  FOR_LANES(G, t) {
    if (t != 0) continue;
    long long run = 0;
    for (long long r = 0; r < M; ++r) {
      sm.off[r] = static_cast<int32_t>(static_cast<uint32_t>(
          static_cast<unsigned long long>(run)));
      run = static_cast<long long>(static_cast<unsigned long long>(run) +
                                   static_cast<unsigned long long>(
                                       static_cast<long long>(sm.cnt[r])));
    }
  }
  group_sync<G>();
  const R total = wadd(static_cast<R>(sm.off[M - 1]), sm.cnt[M - 1]);
  const R lim = min_(total, static_cast<R>(S));
  const long long row = b * S;
  Lanes<int32_t, G> walking;
  FOR_LANES(G, t) {
    walking[t] = 0;
    for (long long s = t; s < S; s += G) {
      long long n = 0;
      for (long long r = 0; r < M; ++r) n += sm.off[r] <= s;
      const long long mi = min_(max_(n - 1, 0LL), M - 1);
      const bool valid = static_cast<R>(s) < lim;
      const bool pr = sm.pr[mi] != 0;
      const R k0 = sm.k[mi];
      const int32_t off_in = static_cast<int32_t>(
          static_cast<uint32_t>(s) - static_cast<uint32_t>(sm.off[mi]));
      const bool w = valid && !pr;
      static_cast<R*>(p.ranks)[row + s] =
          pr ? k0
             : (w ? wadd(k0, wmul(static_cast<R>(off_in), sm.step[mi]))
                  : static_cast<R>(1));
      static_cast<R*>(p.start)[row + s] = sm.st[mi];
      static_cast<R*>(p.slen)[row + s] = wsub(sm.en[mi], sm.st[mi]);
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
      p.max_occ < 1)
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
