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
// - A thread a lane (a rank for sa_resolve, a read for backward_search),
//   64 threads a block, so that a few thousand lanes still spread over
//   the card's SMs. Lanes are independent; a lane stops as soon as its
//   result is fixed, which the plain loops' masks make exact: a marked
//   rank keeps its state (the plain loop holds r and steps there), and a
//   read whose interval is empty, or whose bases ran out, keeps it to the
//   end, where the empty test maps every dead interval to (0, 0).
// - sa_resolve issues a step's loads together: the mark word at r >> 5,
//   the Occ row of the stored position (checkpoints and words) and the
//   major row; the code is decoded from the row, so its checkpoint and
//   major entry are picked from registers, not loaded after. L2's four
//   entries are loaded once a lane.
// - backward_search fetches both Occ rows of a step (at lo and at hi)
//   before it counts either (occ.cuh occ_fetch / occ_value, the counting
//   fm_seed.cu shares).
// - An optional lane mask (resolve_seeds' rank lanes within its compact
//   cap): a lane off the mask writes 0 without a load, as the plain
//   code's zero-filled positions hold there.
// - Ranks and rank-valued state take the template type R (int32 or int64,
//   the index's rank dtype). Every table index is clamped as the plain
//   code clamps it (_clamped, _local_row), so a dummy lane (rank 1 in
//   exact_align_step) or a garbage rank reads what the plain code reads.
//   Sums run in long long and are cast to R, so they wrap as the
//   tensors' do.
// - The lane bodies build for the host too (LANE_HD / GROUP_FN,
//   lanes.cuh): compiled without nvcc, the file gives entries
//   sa_resolve_host and backward_search_host that run every lane in turn,
//   which the CPU tests hold against the plain versions.

#include "lanes.cuh"
#include "occ.cuh"

namespace {

constexpr int kThreads = 64;    // a block: one lane a thread
constexpr int kRefused = 1;     // cudaErrorInvalidValue

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
  if (p.mask != nullptr && !p.mask[i]) {
    out[i] = 0;
    return;
  }
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

// kernels/fm.py backward_search_plain for read b: the columns from
// lens - 1 down, each prepending its code to [lo, hi) by two Occ lookups
template <typename R>
GROUP_FN void backward_search_lane(const BsParams& p, long long b) {
  const R* majors = static_cast<const R*>(p.occ_majors);
  const R* L2 = static_cast<const R*>(p.L2);
  const R primary = static_cast<R>(p.primary);
  const int32_t* q = p.codes + b * p.W;
  const long long L = p.lens[b];
  R lo = 0;
  R hi = static_cast<R>(p.seq_len + 1);
  for (long long t = 0; t < p.W && t < L && lo < hi; ++t) {
    const int c = __ldg(q + clampv<long long>(L - 1 - t, 0, p.W - 1));
    if (c >= 4) {   // an ambiguous base kills the match
      lo = 1;
      hi = 1;
      break;
    }
    const OccFetch<R> flo =
        occ_fetch<R>(p.occ_rows, p.n_octo, majors, p.n_major, lo, primary, c);
    const OccFetch<R> fhi =
        occ_fetch<R>(p.occ_rows, p.n_octo, majors, p.n_major, hi, primary, c);
    const long long base = static_cast<long long>(__ldg(L2 + c)) + 1;
    lo = static_cast<R>(base + static_cast<long long>(occ_value(flo, c)));
    hi = static_cast<R>(base + static_cast<long long>(occ_value(fhi, c)));
  }
  const bool empty = hi <= lo || L == 0;
  static_cast<R*>(p.lo)[b] = empty ? static_cast<R>(0) : lo;
  static_cast<R*>(p.hi)[b] = empty ? static_cast<R>(0) : hi;
}

#ifdef __CUDACC__
template <typename R>
__global__ void __launch_bounds__(kThreads) sa_resolve_kernel(
    const SaParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i < p.n) sa_resolve_lane<R>(p, i);
}

template <typename R>
__global__ void __launch_bounds__(kThreads) backward_search_kernel(
    const BsParams p) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (b < p.B) backward_search_lane<R>(p, b);
}

inline unsigned grid_of(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
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
  const SaParams p{ranks,   mask,       pos,     occ_rows, occ_majors,
                   L2,      sa_words,   sa_cnt,  sa_majors, sa_sample,
                   n_octo,  n_major,    n_words, n_cnt,    n_sa_major,
                   n_sample, primary,   n,       max_steps};
#ifdef __CUDACC__
  if (n == 0) return 0;
  if (rank_bytes == 8)
    sa_resolve_kernel<long long><<<grid_of(n), kThreads, 0, stream>>>(p);
  else
    sa_resolve_kernel<int32_t><<<grid_of(n), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
#else
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
  if (rank_bytes == 8)
    backward_search_kernel<long long><<<grid_of(B), kThreads, 0, stream>>>(
        p);
  else
    backward_search_kernel<int32_t><<<grid_of(B), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
#else
  for (long long b = 0; b < B; ++b) {
    if (rank_bytes == 8)
      backward_search_lane<long long>(p, b);
    else
      backward_search_lane<int32_t>(p, b);
  }
  return 0;
#endif
}
