// SA resolution and backward search on the FM index, for Hopper: every
// step of every lane in one launch.
//
// Replaces the TPU program of bioseqdb_tpu/kernels/fm.py: sa_resolve (its
// lax.fori_loop at :536 over lf_step :491 and _sa_marked :451, then
// _sa_slot :462) and backward_search (its lax.fori_loop at :409 over
// backward_ext). XLA compiled those loops into the one TPU device program;
// no Pallas. The kernels compute exactly what the plain versions
// bioseqdb_tpu_torch/kernels/fm.py sa_resolve_plain and
// backward_search_plain compute: the vectorised port, which equals the
// JAX package.
//
// What bounds them: a lane is a chain of dependent steps (sa_resolve: at
// most sa_interval - 1 = 31 LF steps, each addressed by the one before;
// backward_search: one step a base, 150 at 150 bp), and each step reads a
// 48-byte Occ row, a major row and (sa_resolve) a mark word at ranks
// anywhere in the index. A 4.6 Mb genome's Occ table is ~3.5 MB and its
// mark bitmap ~1.2 MB, so they stay in L2: the distinct rows a launch
// touches are few kilobytes to megabytes, far below what the card moves in
// the launch's time. A launch lasts about as long as its slowest lane's
// chain of L2 round trips: latency, not the card's memory or issue rate.
//
// Design:
// - sa_resolve unmasked (the exact step, exact mode, the random and edge
//   sets): a thread a rank lane, 64 threads a block, so that a few
//   thousand lanes still spread over the card's SMs (backward_search: a
//   group a read, below). Lanes are independent; a lane stops as soon as its
//   result is fixed, which the plain loops' masks make exact: a marked
//   rank keeps its state (the plain loop holds r and steps there), and a
//   read whose interval is empty, or whose bases ran out, keeps it to the
//   end, where the empty test maps every dead interval to (0, 0).
// - sa_resolve under a lane mask (resolve_seeds' B x S rank lanes, of
//   which the main path walks a few dozen of a million, the FM-seeded
//   batch an eighth and long reads two fifths): kTileBlocks blocks of
//   kTileThreads an SM, the lanes split evenly over the blocks (a span a
//   block, kBlockLanes a pass). In a pass each thread takes a tile of
//   kTile lanes: it loads the tile's mask bytes in one 8-byte load, and
//   its warp writes the pass's zeros with 16-byte stores, neighbouring
//   threads on neighbouring addresses. The block lists its walking lanes
//   in shared memory (each warp's scan of its tiles' counts, then the
//   warps' counts in order) and its threads walk them one each in turn,
//   overwriting their zeros after a barrier. So a dense stretch of
//   walking lanes (a long read's first seed slots) is shared out over a
//   block's 256 threads, and a call with few lanes still spreads them
//   over the card. The mask and the positions must start on 16-byte
//   boundaries: the entry refuses others and the wrapper
//   (kernels/fm_cuda.py) copies a mask view that does not. PERF.md row
//   13 has the designs this replaced: a thread a lane in blocks of 64
//   (16,384 blocks of byte loads for the main path's mask), and lists a
//   warp (a dense stretch walked several to a thread).
// - sa_resolve issues a step's loads together: the mark word at r >> 5,
//   the Occ row of the stored position (checkpoints and words) and the
//   major row; the code is decoded from the row, so its checkpoint and
//   major entry are picked from registers, not loaded after. L2's four
//   entries are loaded once a lane.
// - backward_search runs a pair of threads a read (kBsGroup), kBsThreads
//   a block: lane 0 holds lo and lane 1 hi. A step loads each end's whole
//   Occ row (checkpoints and words, three 16-byte vectors) and major row by
//   addresses that depend on its rank alone, with 32-bit index arithmetic
//   where R is 32 bits; the code is picked from registers after the loads,
//   and the next step's code is loaded while this step's rows are in
//   flight, so no step waits on a code (a thread a read before, whose
//   every step loaded its code, then the rows it addressed). Where both
//   ends lie in one block the pair's loads are one request. Each lane
//   counts its end (occ.cuh count_code, which sa_resolve and fm_seed.cu
//   share; 32-bit sums where R is) and two shuffles swap the new ends.
//   Groups of 4 threads (lane 0 the checkpoints, lanes 1 and 2 the words,
//   lane 3 the majors, two rounds of shuffles summing them, each lane
//   repeating the address arithmetic) and the lean thread a read
//   were slower on the exact step (PERF.md row 14).
// - A lane off the mask writes 0 and loads nothing else, as the plain
//   code's zero-filled positions hold there.
// - Ranks and rank-valued state take the template type R (int32 or int64,
//   the index's rank dtype). Every table index is clamped as the plain
//   code clamps it (_clamped, _local_row), so a dummy lane (rank 1 in
//   exact_align_step) or a garbage rank reads what the plain code reads.
//   Sums run in long long and are cast to R, so they wrap as the
//   tensors' do.
// - The lane and warp bodies build for the host too (LANE_HD / GROUP_FN,
//   lanes.cuh): compiled without nvcc, the file gives entries
//   sa_resolve_host and backward_search_host that run every lane in turn
//   (a masked call in kHostBlocks blocks, a block's warps in turn between
//   what the card's barriers separate; a search's group lane by lane),
//   which the CPU tests hold against the plain versions.

#include "lanes.cuh"
#include "occ.cuh"

namespace {

constexpr int kThreads = 64;    // an unmasked block: one lane a thread
constexpr int kRefused = 1;     // cudaErrorInvalidValue
constexpr int kWarp = 32;
constexpr int kTile = 8;        // a masked call's lanes a thread a pass
constexpr int kWarpLanes = kWarp * kTile;   // a warp's lanes a pass
constexpr int kTileThreads = 256;   // a masked block
constexpr int kTileWarps = kTileThreads / kWarp;
constexpr int kBlockLanes = kTileWarps * kWarpLanes;   // a block's a pass
constexpr int kTileBlocks = 4;  // masked blocks an SM
constexpr int kSpanUnit = 16;   // a block's span of lanes is a multiple
constexpr int kHostBlocks = 3;  // the host build's blocks (spans of n / 3)
constexpr int kBsGroup = 2;     // backward_search: threads a read
constexpr int kBsThreads = 128; // backward_search: a block (64 reads)
static_assert(kTile == 4 || kTile == 8 || kTile == 16,
              "a tile's mask is one 4-, 8- or 16-byte load");
static_assert(kSpanUnit % kTile == 0 && kWarpLanes % kSpanUnit == 0,
              "a warp's tiles start on the mask's and positions' vectors");
static_assert(kBlockLanes <= 65536, "a walk list entry is 16 bits");

struct SaParams {
  const void* ranks;          // [n] R
  const uint8_t* mask;        // [n] torch.bool, or null: every lane walks
  void* pos;                  // [n] R, out
  const int32_t* occ_rows;    // [n_octo * 8, 12]
  const void* occ_majors;     // [n_major, 4] R
  const void* L2;             // [5] R
  const int32_t* sa_words;    // [n_words] the mark bitmap
  const int32_t* sa_cnt;      // [n_cnt] marks before each 128-rank group
  const void* sa_majors;      // [n_sa_major] R
  const void* sa_sample;      // [n_sample] R
  long long n_octo, n_major, n_words, n_cnt, n_sa_major, n_sample;
  long long primary, n, max_steps;
};

struct BsParams {
  const int32_t* codes;       // [B, W]
  const int32_t* lens;        // [B]
  void* lo;                   // [B] R, out
  void* hi;                   // [B] R, out
  const int32_t* occ_rows;
  const void* occ_majors;
  const void* L2;
  long long n_octo, n_major, primary, seq_len, B, W;
};

template <typename T>
LANE_HD inline T pick4(T a, T b, T c, T d, int k) {
  return k == 0 ? a : (k == 1 ? b : (k == 2 ? c : d));
}

// kernels/fm.py sa_resolve_plain for lane i: LF steps to a marked rank (at
// most max_steps), then the sample of its slot plus the steps
template <typename R>
GROUP_FN void sa_resolve_lane(const SaParams& p, long long i) {
  R* out = static_cast<R*>(p.pos);
  const R* majors = static_cast<const R*>(p.occ_majors);
  const R* L2 = static_cast<const R*>(p.L2);
  const long long l2[4] = {__ldg(L2), __ldg(L2 + 1), __ldg(L2 + 2),
                           __ldg(L2 + 3)};
  const R primary = static_cast<R>(p.primary);
  R r = __ldg(static_cast<const R*>(p.ranks) + i);
  long long steps = 0;
  for (; steps < p.max_steps; ++steps) {
    // the step's loads, all addressed by r alone
    const uint32_t mark = static_cast<uint32_t>(__ldg(
        p.sa_words + clampv<long long>(static_cast<long long>(r >> 5), 0,
                                       p.n_words - 1)));
    const R j = r - static_cast<R>(r > primary);
    const R blk = j >> kLog2OccBlock;
    const int32_t* row = p.occ_rows + occ_row_index(blk, p.n_octo) * 12;
    const int4 ck = __ldg(reinterpret_cast<const int4*>(row));
    const OccWords ws = load_words(row);
    const R* mrow = majors + major_index(blk, p.n_major) * 4;
    const R m0 = __ldg(mrow), m1 = __ldg(mrow + 1), m2 = __ldg(mrow + 2),
            m3 = __ldg(mrow + 3);
    if ((mark >> static_cast<int>(r & 31)) & 1u) break;   // marked: stop
    // LF (kernels/fm.py _lf_value): the code at the stored position j
    const int off = static_cast<int>(j & 127);
    uint32_t word = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      if (w == (off >> 4)) word = ws.w[w];
    }
    const int c = static_cast<int>((word >> (2 * (15 - (off & 15)))) & 3u);
    const long long lf = pick4(l2[0], l2[1], l2[2], l2[3], c)
                         + pick4(ck.x, ck.y, ck.z, ck.w, c)
                         + count_code(ws, c, off) + 1
                         + static_cast<long long>(pick4(m0, m1, m2, m3, c));
    r = r == primary ? static_cast<R>(0) : static_cast<R>(lf);
  }
  // the slot (kernels/fm.py _sa_slot): the marks before r in its 128-rank
  // group, the group's count and its major
  const long long r5 = static_cast<long long>(r >> 7);
  const int wsel = static_cast<int>((r >> 5) & 3);
  const int bits = static_cast<int>(r & 31);
  uint32_t part = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t word = static_cast<uint32_t>(
        __ldg(p.sa_words + clampv<long long>(r5 * 4 + k, 0, p.n_words - 1)));
    const uint32_t m =
        k < wsel ? 0xFFFFFFFFu : (k == wsel ? (1u << bits) - 1u : 0u);
    part += static_cast<uint32_t>(popc32(word & m));
  }
  const uint32_t cnt = static_cast<uint32_t>(
      __ldg(p.sa_cnt + clampv<long long>(r5, 0, p.n_cnt - 1)));
  const R major = __ldg(static_cast<const R*>(p.sa_majors)
                        + clampv<long long>(r5 >> kLog2Major, 0,
                                            p.n_sa_major - 1));
  // part + cnt in int32 (as the tensors add them), then the major in R
  const R slot = static_cast<R>(
      static_cast<long long>(static_cast<int32_t>(part + cnt))
      + static_cast<long long>(major));
  const R sample = __ldg(static_cast<const R*>(p.sa_sample)
                         + clampv<long long>(static_cast<long long>(slot), 0,
                                             p.n_sample - 1));
  out[i] = static_cast<R>(static_cast<long long>(sample) + steps);
}

// the mask bits of the T lanes at m (bit j: lane j), from one load
template <int T>
GROUP_FN inline uint32_t tile_bits(const uint8_t* m) {
  uint32_t w[4] = {0, 0, 0, 0};
  if constexpr (T == 16) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(m));
    w[0] = static_cast<uint32_t>(v.x);
    w[1] = static_cast<uint32_t>(v.y);
    w[2] = static_cast<uint32_t>(v.z);
    w[3] = static_cast<uint32_t>(v.w);
  } else if constexpr (T == 8) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(m));
    w[0] = static_cast<uint32_t>(v.x);
    w[1] = static_cast<uint32_t>(v.y);
  } else {
    w[0] = static_cast<uint32_t>(__ldg(reinterpret_cast<const int*>(m)));
  }
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < T; ++j)
    bits |= static_cast<uint32_t>(((w[j >> 2] >> (8 * (j & 3))) & 0xFFu) !=
                                  0) << j;
  return bits;
}

// the lanes [w0, w1) of a block's pass of a masked call by one of its
// warps (w1 - w0 <= kWarpLanes; w0 a multiple of kSpanUnit): lane t takes
// the tile of kTile lanes at w0 + kTile * t and loads its mask bytes in
// one load, and the warp writes 0 to all of its positions with 16-byte
// stores (a whole pass: neighbouring threads on neighbouring addresses;
// the tile that n cuts lane by lane). Returns the warp's walking lanes;
// walk[t] holds lane t's (bit j: lane w0 + kTile * t + j), before[t]
// those of the lanes before it. mask and pos are 16-byte aligned (the
// entry refuses them otherwise).
template <typename R>
GROUP_FN int sa_tiles_warp(const SaParams& p, long long w0, long long w1,
                           Lanes<uint32_t, kWarp>& walk,
                           Lanes<int, kWarp>& before) {
  constexpr int G = kWarp;
  constexpr int kVecs = kTile * static_cast<int>(sizeof(R)) / 16;
  R* out = static_cast<R*>(p.pos);
  const bool whole = w1 - w0 == kWarpLanes;
  Lanes<int, G> end;   // the inclusive scan of the counts
  FOR_LANES(G, t) {
    const long long i0 = w0 + static_cast<long long>(kTile) * t;
    uint32_t bits = 0;
    if (i0 + kTile <= w1) {
      bits = tile_bits<kTile>(p.mask + i0);
      int4* o = reinterpret_cast<int4*>(out + (whole ? w0 : i0));
      for (int k = 0; k < kVecs; ++k)   // a whole pass: coalesced
        o[whole ? t + k * G : k] = int4{0, 0, 0, 0};
    } else {
      for (long long i = i0; i < w1; ++i) {
        bits |= static_cast<uint32_t>(p.mask[i] != 0) << (i - i0);
        out[i] = 0;
      }
    }
    walk[t] = bits;
    end[t] = popc32(bits);
  }
  for (int d = 1; d < G; d <<= 1) {
    const Lanes<int, G> up = shfl_up<G>(end, d);
    FOR_LANES(G, t) {
      if (t >= d) end[t] += up[t];
    }
  }
  FOR_LANES(G, t) { before[t] = end[t] - popc32(walk[t]); }
  return shfl<G>(end, G - 1);
}

// a warp's walking lanes into its block's list from entry `at` on, as
// offsets `off` + kTile * t + j from the pass's first lane
GROUP_FN inline void sa_list_warp(long long off, int at,
                                  const Lanes<uint32_t, kWarp>& walk,
                                  const Lanes<int, kWarp>& before,
                                  uint16_t* list) {
  FOR_LANES(kWarp, t) {
    int k = at + before[t];
    for (uint32_t bits = walk[t]; bits != 0; bits &= bits - 1)
      list[k++] = static_cast<uint16_t>(off + kTile * t + low_bit(bits));
  }
}

// the lanes a block of a masked launch of `blocks` blocks takes: n split
// evenly, in multiples of kSpanUnit, so that a call whose lanes walk
// densely spreads its walks over every block launched
LANE_HD inline long long block_span(long long n, long long blocks) {
  const long long per = (n + blocks - 1) / blocks;
  return (per + kSpanUnit - 1) / kSpanUnit * kSpanUnit;
}

// one end of an interval at a step: its whole Occ row and major row,
// loaded by addresses that depend on the rank alone
template <typename R>
struct BsEnd {
  int4 ck;
  OccWords ws;
  R m[4];
  int off;
};

template <typename R>
GROUP_FN inline BsEnd<R> bs_end(const BsParams& p, R r, R primary) {
  const R jr = r - static_cast<R>(r > primary);
  const R blk = jr >> kLog2OccBlock;
  const int32_t* row = p.occ_rows + occ_row_index(blk, p.n_octo) * 12;
  const R* mj = static_cast<const R*>(p.occ_majors) +
                major_index(blk, p.n_major) * 4;
  return BsEnd<R>{__ldg(reinterpret_cast<const int4*>(row)), load_words(row),
                  {__ldg(mj), __ldg(mj + 1), __ldg(mj + 2), __ldg(mj + 3)},
                  static_cast<int>(jr & 127)};
}

// L2[c] + 1 + occ(c, end): the end's new value, summed in 32 bits where R
// is (the checkpoint and the row's count in int32, then the major in R)
template <typename R>
GROUP_FN inline R bs_next(const BsEnd<R>& x, int c, R l2c) {
  const uint32_t in_block = static_cast<uint32_t>(
      pick4(x.ck.x, x.ck.y, x.ck.z, x.ck.w, c)) +
      static_cast<uint32_t>(count_code(x.ws, c, x.off));
  const R major = pick4(x.m[0], x.m[1], x.m[2], x.m[3], c);
  if constexpr (sizeof(R) == 4)
    return static_cast<R>(in_block + static_cast<uint32_t>(major) +
                          static_cast<uint32_t>(l2c) + 1u);
  else
    return static_cast<R>(static_cast<long long>(static_cast<int32_t>(
                              in_block)) + major + l2c + 1);
}

// kernels/fm.py backward_search_plain for read b, a pair of threads a
// read: lane 0 holds lo, lane 1 hi. Each loads its end's whole Occ row and
// major row by an address that depends on the rank alone (where both ends
// lie in one block the pair's loads are one request), counts its end, and
// the pair swaps its new ends by two shuffles; the next step's code is
// loaded before this step's rows are counted
template <typename R>
GROUP_FN void backward_search_pair(const BsParams& p, long long b) {
  constexpr int G = kBsGroup;
  const R* L2 = static_cast<const R*>(p.L2);
  const R l2[4] = {__ldg(L2), __ldg(L2 + 1), __ldg(L2 + 2), __ldg(L2 + 3)};
  const R primary = static_cast<R>(p.primary);
  const int32_t* q = p.codes + b * p.W;
  const long long L = p.lens[b];
  const long long T = min_(L, p.W);   // the steps a live read takes
  // the plain loop's column (its clamp) and code (>= 4 ambiguous, a
  // negative one counted as 0, as the plain clamp(0, 3) does)
  const auto code = [&](long long t) {
    return clampv(__ldg(q + clampv<long long>(L - 1 - t, 0, p.W - 1)), 0, 4);
  };
  R lo = 0;
  R hi = static_cast<R>(p.seq_len + 1);
  int c = T > 0 ? code(0) : 0;
  for (long long t = 0; t < T && lo < hi; ++t) {
    const int cn = t + 1 < T ? code(t + 1) : 0;
    if (c >= 4) {   // an ambiguous base kills the match
      lo = 1;
      hi = 1;
      break;
    }
    Lanes<R, G> v;
    FOR_LANES(G, j) {
      const BsEnd<R> x = bs_end<R>(p, j == 0 ? lo : hi, primary);
      v[j] = bs_next<R>(x, c, pick4(l2[0], l2[1], l2[2], l2[3], c));
    }
    lo = shfl<G>(v, 0);
    hi = shfl<G>(v, 1);
    c = cn;
  }
  const bool empty = hi <= lo || L == 0;
  if (group_leader<G>()) {
    static_cast<R*>(p.lo)[b] = empty ? static_cast<R>(0) : lo;
    static_cast<R*>(p.hi)[b] = empty ? static_cast<R>(0) : hi;
  }
}

#ifdef __CUDACC__
template <typename R>
__global__ void __launch_bounds__(kThreads) sa_resolve_kernel(
    const SaParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i < p.n) sa_resolve_lane<R>(p, i);
}

// block b's span of a masked call, kBlockLanes lanes a pass: each warp
// tiles its kWarpLanes of the pass, the warps' walking lanes go into the
// block's list (the warps' counts summed in warp order), and the block's
// threads walk them one each in turn, overwriting their zeros
template <typename R>
__global__ void __launch_bounds__(kTileThreads) sa_resolve_masked(
    const SaParams p, long long span) {
  __shared__ uint16_t list[kBlockLanes];
  __shared__ int counts[kTileWarps];
  const int warp = static_cast<int>(threadIdx.x) / kWarp;
  const long long b0 = static_cast<long long>(blockIdx.x) * span;
  const long long b1 = min_(p.n, b0 + span);
  for (long long q0 = b0; q0 < b1; q0 += kBlockLanes) {
    const long long w0 = min_(b1, q0 + static_cast<long long>(warp) *
                                           kWarpLanes);
    const long long w1 = min_(b1, w0 + kWarpLanes);
    Lanes<uint32_t, kWarp> walk;
    Lanes<int, kWarp> before;
    const int mine = sa_tiles_warp<R>(p, w0, w1, walk, before);
    if (threadIdx.x % kWarp == 0) counts[warp] = mine;
    __syncthreads();   // the counts, and the zeros before the walks
    int at = 0, total = 0;
    for (int w = 0; w < kTileWarps; ++w) {
      at += w < warp ? counts[w] : 0;
      total += counts[w];
    }
    if (total != 0) {
      sa_list_warp(w0 - q0, at, walk, before, list);
      __syncthreads();
      for (int k = static_cast<int>(threadIdx.x); k < total;
           k += kTileThreads)
        sa_resolve_lane<R>(p, q0 + list[k]);
    }
    __syncthreads();   // the counts and the list read before the next pass
  }
}

// a masked launch's blocks: kTileBlocks an SM of the current device, but
// none with fewer lanes than threads
inline unsigned masked_grid(long long n) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    sms = 1;
  return static_cast<unsigned>(
      min_<long long>((n + kTileThreads - 1) / kTileThreads,
                      static_cast<long long>(sms) * kTileBlocks));
}

template <typename R>
__global__ void __launch_bounds__(kBsThreads) backward_search_kernel(
    const BsParams p) {
  const long long b = static_cast<long long>(blockIdx.x) *
                      (kBsThreads / kBsGroup) + threadIdx.x / kBsGroup;
  if (b < p.B) backward_search_pair<R>(p, b);
}
inline unsigned grid_of(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}
#endif

#ifndef __CUDACC__
// the masked kernel's blocks on the host (kHostBlocks of them), a block's
// warps in turn between what the card's barriers separate
template <typename R>
void sa_resolve_blocks(const SaParams& p) {
  uint16_t list[kBlockLanes];
  Lanes<uint32_t, kWarp> walk[kTileWarps];
  Lanes<int, kWarp> before[kTileWarps];
  int counts[kTileWarps];
  const long long span = block_span(p.n, kHostBlocks);
  for (long long b = 0; b < kHostBlocks; ++b) {
    const long long b0 = b * span;
    const long long b1 = min_(p.n, b0 + span);
    for (long long q0 = b0; q0 < b1; q0 += kBlockLanes) {
      for (int w = 0; w < kTileWarps; ++w) {
        const long long w0 = min_(b1, q0 + static_cast<long long>(w) *
                                               kWarpLanes);
        counts[w] = sa_tiles_warp<R>(p, w0, min_(b1, w0 + kWarpLanes),
                                     walk[w], before[w]);
      }
      int at = 0;
      for (int w = 0; w < kTileWarps; ++w) {
        const long long w0 = min_(b1, q0 + static_cast<long long>(w) *
                                               kWarpLanes);
        sa_list_warp(w0 - q0, at, walk[w], before[w], list);
        at += counts[w];
      }
      for (int k = 0; k < at; ++k) sa_resolve_lane<R>(p, q0 + list[k]);
    }
  }
}
#endif

}  // namespace

// sa_resolve_launch (nvcc; on `stream`) or sa_resolve_host (a host
// compiler; every lane in turn): pos[i] for the n ranks, rank_bytes 4 or 8
// picking R; mask may be null. 0, or a CUDA error code (kRefused for a
// refused shape)
extern "C" int LANE_ENTRY(sa_resolve)(
    long long rank_bytes, const void* ranks, const uint8_t* mask, void* pos,
    const int32_t* occ_rows, long long n_octo, const void* occ_majors,
    long long n_major, const void* L2, const int32_t* sa_words,
    long long n_words, const int32_t* sa_cnt, long long n_cnt,
    const void* sa_majors, long long n_sa_major, const void* sa_sample,
    long long n_sample, long long primary, long long n,
    long long max_steps LANE_STREAM) {
  if ((rank_bytes != 4 && rank_bytes != 8) || n_octo < 1 || n_major < 1
      || n_words < 1 || n_cnt < 1 || n_sa_major < 1 || n_sample < 1 || n < 0
      || max_steps < 0)
    return kRefused;
  // a masked call's tiles take vector loads and stores
  if (mask != nullptr && ((reinterpret_cast<uintptr_t>(mask) |
                           reinterpret_cast<uintptr_t>(pos)) & 15u) != 0)
    return kRefused;
  const SaParams p{ranks,   mask,       pos,     occ_rows, occ_majors,
                   L2,      sa_words,   sa_cnt,  sa_majors, sa_sample,
                   n_octo,  n_major,    n_words, n_cnt,    n_sa_major,
                   n_sample, primary,   n,       max_steps};
#ifdef __CUDACC__
  if (n == 0) return 0;
  if (mask != nullptr) {
    const unsigned grid = masked_grid(n);
    const long long span = block_span(n, grid);
    if (rank_bytes == 8)
      sa_resolve_masked<long long><<<grid, kTileThreads, 0, stream>>>(p,
                                                                     span);
    else
      sa_resolve_masked<int32_t><<<grid, kTileThreads, 0, stream>>>(p,
                                                                   span);
  } else if (rank_bytes == 8) {
    sa_resolve_kernel<long long><<<grid_of(n), kThreads, 0, stream>>>(p);
  } else {
    sa_resolve_kernel<int32_t><<<grid_of(n), kThreads, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
#else
  if (mask != nullptr) {
    if (rank_bytes == 8)
      sa_resolve_blocks<long long>(p);
    else
      sa_resolve_blocks<int32_t>(p);
    return 0;
  }
  for (long long i = 0; i < n; ++i) {
    if (rank_bytes == 8)
      sa_resolve_lane<long long>(p, i);
    else
      sa_resolve_lane<int32_t>(p, i);
  }
  return 0;
#endif
}

// backward_search_launch / backward_search_host, as above: (lo, hi) of the
// B reads of codes [B, W]
extern "C" int LANE_ENTRY(backward_search)(
    long long rank_bytes, const int32_t* codes, const int32_t* lens,
    void* lo, void* hi, const int32_t* occ_rows, long long n_octo,
    const void* occ_majors, long long n_major, const void* L2,
    long long primary, long long seq_len, long long B,
    long long W LANE_STREAM) {
  if ((rank_bytes != 4 && rank_bytes != 8) || n_octo < 1 || n_major < 1
      || B < 0 || W < 0)
    return kRefused;
  const BsParams p{codes,  lens,    lo,      hi,      occ_rows, occ_majors,
                   L2,     n_octo,  n_major, primary, seq_len,  B,
                   W};
#ifdef __CUDACC__
  if (B == 0) return 0;
  const unsigned grid = static_cast<unsigned>(
      (B + kBsThreads / kBsGroup - 1) / (kBsThreads / kBsGroup));
  if (rank_bytes == 8)
    backward_search_kernel<long long><<<grid, kBsThreads, 0, stream>>>(p);
  else
    backward_search_kernel<int32_t><<<grid, kBsThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
#else
  for (long long b = 0; b < B; ++b) {
    if (rank_bytes == 8)
      backward_search_pair<long long>(p, b);
    else
      backward_search_pair<int32_t>(p, b);
  }
  return 0;
#endif
}
