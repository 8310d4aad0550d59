// Batched banded affine-gap seed extension (bwa ksw_extend) for Hopper.
//
// Replaces the TPU kernel bioseqdb_tpu/kernels/sw_pallas.py:_sw_kernel
// (wrapper sw_extend_batch_pallas). It computes exactly what the plain
// version bioseqdb_tpu_torch/kernels/sw.py:sw_extend_batch computes, with
// the scoring matrix as arithmetic: +a on a match, -b on a mismatch, -1
// when either base is ambiguous (code > 3). All arithmetic is int32; the
// band clamp max_ins/max_del is float32, as in the TPU kernel.
//
// What bounds it: each lane is a chain of dependent target rows (up to
// ~qlen + band rows), and every row needs a prefix max over the query
// axis plus a handful of row reductions. The work per row is a few
// hundred int ops, so a lane is latency-bound on that chain, not on
// memory (the query row is read once, the target one int per row).
//
// Design: one warp per lane, so a lane that terminates (Z-drop, zero
// row, end of target) leaves at once and never waits for other lanes.
// The query axis is split into contiguous runs of CPT columns per
// thread, with H, E and the query codes in registers. F is a per-thread
// serial prefix max followed by a warp-shuffle scan; the row max, the
// argmax (ties to the largest column), the value at the band end and the
// first/last live columns are warp reductions. The target base of row i
// is read straight from global memory (one broadcast load per row).
// Nothing is allocated and nothing synchronises beyond the warp.

#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

template <int CPT>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sw_extend_kernel(const int* __restrict__ query, const int* __restrict__ qlen_p,
                 const int* __restrict__ target, const int* __restrict__ tlen_p,
                 const int* __restrict__ w0_p, const int* __restrict__ h0_p,
                 int* __restrict__ out, int B, int WQ, int WT, int a, int b,
                 int o_del, int e_del, int o_ins, int e_ins, int end_bonus,
                 int zdrop) {
  const int t = threadIdx.x & 31;
  const int lane = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (lane >= B) return;  // the whole warp leaves together

  const int qlen = qlen_p[lane];
  const int tlen = tlen_p[lane];
  const int h0 = h0_p[lane];
  const int oe_del = o_del + e_del;
  const int oe_ins = o_ins + e_ins;
  const int max_sc = max(a, 1);
  const int max_ins = (int)((float)(qlen * max_sc + end_bonus - o_ins) /
                                (float)e_ins + 1.0f);
  const int max_del = (int)((float)(qlen * max_sc + end_bonus - o_del) /
                                (float)e_del + 1.0f);
  int w = min(w0_p[lane], max(max_ins, 1));
  w = min(w, max(max_del, 1));

  const int j0 = t * CPT;
  const int* qrow = query + (size_t)lane * WQ;
  const int* trow = target + (size_t)lane * WT;
  int q[CPT], h[CPT], e[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int j = j0 + k;
    q[k] = j < WQ ? qrow[j] : 4;
    const int hf = (j == 0) ? h0 : h0 - oe_ins - e_ins * (j - 1);
    h[k] = (j < WQ && hf > 0 && j < qlen + 1) ? hf : 0;
    e[k] = 0;
  }

  int i = 0, beg = 0, end = qlen, mx = h0;
  int max_i = -1, max_j = -1, max_ie = -1, gscore = -1, max_off = 0;
  bool active = tlen > 0 && qlen > 0;

  while (active) {
    const int bg = max(beg, i - w);
    const int en = min(min(end, i + w + 1), qlen);
    const int tb = trow[min(i, WT - 1)];
    const int h1b = (bg == 0) ? max(h0 - (o_del + e_del * (i + 1)), 0) : 0;

    // M and the per-thread inclusive prefix max of t_ins + e_ins * j
    int m[CPT], pre[CPT];
    int run = kNeg;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int j = j0 + k;
      const bool inb = j >= bg && j < en && j < WQ;
      const int s = (q[k] > 3 || tb > 3) ? -1 : (q[k] == tb ? a : -b);
      const int mk = (inb && h[k] != 0) ? h[k] + s : 0;
      m[k] = mk;
      const int sc = inb ? max(mk - oe_ins, 0) + e_ins * j : kNeg;
      run = max(run, sc);
      pre[k] = run;
    }
    // warp scan of the thread totals -> max over all columns before j0
    int tot = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, tot, off);
      if (t >= off) tot = max(tot, v);
    }
    int excl = __shfl_up_sync(kFull, tot, 1);
    if (t == 0) excl = kNeg;

    int hrow[CPT];
    int best = -1, bestj = -1, h_end = 0;
    int prev_run = excl;  // inclusive prefix max at column j - 1
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int j = j0 + k;
      const bool inb = j >= bg && j < en && j < WQ;
      const int f = (j == 0) ? 0 : max(prev_run - e_ins * (j - 1), 0);
      prev_run = max(excl, pre[k]);
      const int ec = inb ? e[k] : 0;
      const int hr = inb ? max(max(m[k], ec), f) : 0;
      e[k] = inb ? max(ec - e_del, max(m[k] - oe_del, 0)) : 0;
      hrow[k] = hr;
      const int hm = inb ? hr : -1;
      if (hm >= best) {  // columns ascend: ties keep the largest j
        best = hm;
        bestj = j;
      }
      if (j == en - 1) h_end = hr;
    }
    const int row_max = __reduce_max_sync(kFull, best);
    const int m_best = max(row_max, 0);
    int mj = __reduce_max_sync(kFull, best == row_max ? bestj : -1);
    if (m_best <= 0) mj = -1;
    const int h_endm1 = (en > bg) ? __reduce_max_sync(kFull, h_end) : h1b;

    // rolling H holds H(i, j-1); the band start takes the boundary value
    int left = __shfl_up_sync(kFull, hrow[CPT - 1], 1);
    if (t == 0) left = 0;
    int first_live = 1 << 30, last_live = -1;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int j = j0 + k;
      const bool in_be = j >= bg && j <= en && j < WQ;
      const int hs = (k == 0) ? left : hrow[k - 1];
      const int nh = in_be ? ((j == bg) ? h1b : hs) : 0;
      h[k] = nh;
      if (in_be && (nh != 0 || e[k] != 0)) {
        first_live = min(first_live, j);
        last_live = max(last_live, j);
      }
    }
    first_live = __reduce_min_sync(kFull, first_live);
    last_live = __reduce_max_sync(kFull, last_live);

    if (en == qlen && gscore <= h_endm1) {
      gscore = h_endm1;
      max_ie = i;
    }
    const bool improved = m_best > mx;
    const int di = i - max_i;
    const int dj = mj - max_j;
    const bool zd1 = mx - m_best - (di - dj) * e_del > zdrop;
    const bool zd2 = mx - m_best - (dj - di) * e_ins > zdrop;
    const bool break_z = !improved && zdrop > 0 && (di > dj ? zd1 : zd2);
    if (improved) {
      max_off = max(max_off, abs(mj - i));
      mx = m_best;
      max_i = i;
      max_j = mj;
    }
    if (last_live >= 0) {
      beg = first_live;
      end = min(last_live + 2, qlen);
    } else {
      beg = en;
      end = min(bg + 1, qlen);
    }
    active = !(m_best == 0 || break_z || i + 1 >= tlen);
    ++i;
  }

  if (t == 0) {
    out[0 * B + lane] = mx;
    out[1 * B + lane] = max_j + 1;
    out[2 * B + lane] = max_i + 1;
    out[3 * B + lane] = max_ie + 1;
    out[4 * B + lane] = gscore;
    out[5 * B + lane] = max_off;
  }
}

template <int CPT>
void launch(const int* query, const int* qlen, const int* target,
            const int* tlen, const int* w0, const int* h0, int* out, int B,
            int WQ, int WT, int a, int b, int o_del, int e_del, int o_ins,
            int e_ins, int end_bonus, int zdrop, cudaStream_t stream) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sw_extend_kernel<CPT><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      query, qlen, target, tlen, w0, h0, out, B, WQ, WT, a, b, o_del, e_del,
      o_ins, e_ins, end_bonus, zdrop);
}

}  // namespace

// Plain C entry point (bound with ctypes). query int32[B, WQ], target
// int32[B, WT], qlen/tlen/w0/h0 int32[B], out int32[6, B] (score, qle,
// tle, gtle, gscore, max_off). WQ <= 320. Returns cudaGetLastError().
extern "C" int sw_extend_launch(const void* query, const void* qlen,
                                const void* target, const void* tlen,
                                const void* w0, const void* h0, void* out,
                                int B, int WQ, int WT, int a, int b,
                                int o_del, int e_del, int o_ins, int e_ins,
                                int end_bonus, int zdrop, void* stream) {
  const int cpt = (WQ + 31) / 32;
  auto* q = static_cast<const int*>(query);
  auto* ql = static_cast<const int*>(qlen);
  auto* tg = static_cast<const int*>(target);
  auto* tl = static_cast<const int*>(tlen);
  auto* w = static_cast<const int*>(w0);
  auto* hh = static_cast<const int*>(h0);
  auto* o = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define SW_CASE(N)                                                       \
  case N:                                                                \
    launch<N>(q, ql, tg, tl, w, hh, o, B, WQ, WT, a, b, o_del, e_del,    \
              o_ins, e_ins, end_bonus, zdrop, s);                        \
    break;
  switch (cpt) {
    SW_CASE(1) SW_CASE(2) SW_CASE(3) SW_CASE(4) SW_CASE(5)
    SW_CASE(6) SW_CASE(7) SW_CASE(8) SW_CASE(9) SW_CASE(10)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SW_CASE
  return (int)cudaGetLastError();
}
