// Batched banded affine-gap seed extension (bwa ksw_extend) for Hopper.
//
// Replaces the TPU kernel bioseqdb_tpu/kernels/sw_pallas.py:_sw_kernel
// (wrapper sw_extend_batch_pallas). It computes exactly what the plain
// version bioseqdb_tpu_torch/kernels/sw.py:sw_extend_batch computes, with
// the scoring matrix as arithmetic: +a on a match, -b on a mismatch, -1
// when either base is ambiguous (code > 3). The band clamp max_ins/max_del
// is float32, as in the TPU kernel.
//
// What bounds it: a lane is a chain of dependent target rows (up to ~250
// on the main path), and each row a prefix max (F) along the band, then
// a handful of reductions the next row's band depends on. So a launch
// lasts about as long as its longest lane's chain of rows: the kernel is
// bound by the latency of a row (~2,000 cycles for a wide row of one lane
// alone on an H100, most of it in the two passes over the stripe; see
// tools/sw_profile.py and PERF.md), not by the card's issue rate or
// memory. The query row is read once and the target one int a row.
//
// Design:
// - A lane is served by a group of G = 8 threads (the fastest on the main
//   path's launches of 2, 4, 8 and 16), so a lane that stops (Z-drop, zero
//   row, end of target) costs its warp little and 16,384 lanes are all
//   resident at once: at WQ = 160 a block of 16 lanes takes 24,832 bytes
//   of shared memory and 128 x 56 registers, so 9 blocks (36 warps) fit an
//   SM, 19,008 lanes on 132 SMs.
// - Only the band is computed. A row's in-band columns [bg, en) are cut
//   into G contiguous stripes; thread t walks its stripe in order. H, E
//   and the query codes of a lane live in shared memory, so the band
//   slides without moving data between threads.
// - Three layouts of a lane's columns, picked by the query width. Up to
//   WQ = 320 (every short-read launch) H and E hold every column, 9
//   bytes a column with the query code. Wider queries (long reads: WQ =
//   W, up to thousands) would need more shared memory than an SM has, so
//   H and E become a ring of R slots (a power of two), column j in slot
//   j & (R - 1), while the query codes keep one byte a column. That is
//   exact because a row touches only columns [bg, en + 1], at most 2w + 3
//   of them (bg >= i - w, en <= i + w + 1), and the band never moves left:
//   every column a row reads was written by the row before it, or holds
//   the boundary row when the row is the first. So R >= 2 * max_w + 3,
//   with max_w the widest band of the launch (the caller's bound on w0):
//   512 slots, 4 KB a lane, for the band-doubling retry's w = 200. Reads
//   past a stripe's end (values never used) may alias a live slot; no
//   write does. Shared memory then grows with WQ by one byte a column.
//   Keeping H and E in device memory instead would have put every cell's
//   two loads and two stores on the L2.
// - The wide layout: where the ring's block (16 lanes' query rows and
//   rings) passes the card's per-block shared memory (WQ above 12,468 at
//   w <= 100, 10,420 at w <= 200 on an H100), the query codes stay in the
//   int32 query tensor in device memory and only the ring is in shared
//   memory: 16 x 4 KB at w <= 200, whatever WQ. A thread reads its
//   stripe's codes there in pass 1, the band's columns only (about 2w + 3
//   a row, so a block's working set of ~26 KB stays in L1 from row to
//   row while the band slides one column a row). Fewer lanes a block would
//   have kept the codes in shared memory but still capped WQ (a lane's
//   row alone passes 227 KB at WQ ~ 228,000) and changed the lane count
//   the other layouts are tuned for; this keeps one block shape and no
//   width cap. The first and last live columns are reduced as two 32-bit
//   values there (a min and a max), not packed into 16-bit halves, so WQ
//   past 65,535 runs too; the other layouts keep the packed form.
// - F runs serially inside a stripe as g = max(g - e_ins, max(M - oe_ins,
//   0)), and across the stripes as a log2(G)-step shuffle max-scan of each
//   stripe's max(t_ins + e_ins * j) (the plain version's prefix-max form):
//   a row is two passes over the stripe (M and the stripe total first,
//   then the cells) with the scan between.
// - The row's reductions are fused into one round of log2(G) shuffle
//   steps: the row max and its column (ties to the largest j) as one
//   packed key, the first and last live columns as one per-halfword max,
//   and H at the band end.
// - The recurrences use the s32 DPX forms (__viaddmax_s32 for E and F,
//   __vimax3_s32 for H, __vibmax_s32 for the row max and its column). A
//   packed int16x2 path for lanes whose values fit int16 (two columns an
//   instruction) was timed in turns against this one and was no faster on
//   the main path's launches, since it does not shorten a row's chain of
//   dependent steps (PERF.md).
// - The rolling H of the plain version (H(i, j-1) at column j) is written
//   in place: a thread writes its own stripe shifted by one column and
//   takes the value at its first column from its left neighbour by one
//   shuffle, so no thread writes a cell another one still reads. Columns
//   left of the band are never visited again (the band start never moves
//   left); the two columns right of it are set each row, since the next
//   row's band ends at most there.
// - Each warp stays converged: its groups run the row loop until its last
//   lane stops, so every shuffle can name the whole warp.
// Nothing is allocated and nothing synchronises beyond the warp.

#include <cuda_runtime.h>

namespace {

constexpr int G = 8;           // threads serving one lane
constexpr int kThreads = 128;  // a block: kThreads / G lanes
constexpr int kNeg = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 4;  // cells a thread loads before it computes them

// Built with -DSW_PROFILE (tools/sw_profile.py), the kernel adds the
// cycles of each phase of lane 0's rows to sw_prof: [0] the whole row,
// [k] the phase that ends at mark k, [9] the rows. Otherwise the marks
// are empty.
#ifdef SW_PROFILE
__device__ unsigned long long sw_prof[10];
#define SW_ROW_BEGIN \
  long long c_[9];   \
  c_[0] = clock64();
#define SW_MARK(k) c_[k] = clock64()
#define SW_ROW_END(who)                                               \
  if (who) {                                                          \
    atomicAdd(&sw_prof[0], (unsigned long long)(c_[8] - c_[0]));      \
    for (int k_ = 1; k_ < 9; ++k_)                                    \
      atomicAdd(&sw_prof[k_], (unsigned long long)(c_[k_] - c_[k_ - 1])); \
    atomicAdd(&sw_prof[9], 1ull);                                     \
  }
#else
#define SW_ROW_BEGIN
#define SW_MARK(k)
#define SW_ROW_END(who)
#endif

struct Args {
  const int* query;
  const int* qlen;
  const int* target;
  const int* tlen;
  const int* w0;
  const int* h0;
  int* out;
  int B, WQ, WT, a, b, o_del, e_del, o_ins, e_ins, end_bonus, zdrop;
  int ring;  // H and E slots of a lane in a ring layout (a power of two)
  const int* gate;  // null, or a count: 0 makes the launch return at once
};

// One lane's scalar state, held alike by every thread that serves it.
struct Lane {
  int qlen, tlen, h0, w;
  int i, beg, end, mx, max_i, max_j, max_ie, gscore, max_off;
  bool active;

  // real: false for the padding threads of the last block past B
  __device__ void init(const Args& p, int lane, bool real) {
    qlen = real ? p.qlen[lane] : 0;
    tlen = real ? p.tlen[lane] : 0;
    h0 = real ? p.h0[lane] : 0;
    const int max_sc = max(p.a, 1);
    const int max_ins = (int)((float)(qlen * max_sc + p.end_bonus - p.o_ins) /
                                  (float)p.e_ins + 1.0f);
    const int max_del = (int)((float)(qlen * max_sc + p.end_bonus - p.o_del) /
                                  (float)p.e_del + 1.0f);
    w = min(real ? p.w0[lane] : 0, max(max_ins, 1));
    w = min(w, max(max_del, 1));
    i = 0, beg = 0, end = qlen, mx = h0;
    max_i = -1, max_j = -1, max_ie = -1, gscore = -1, max_off = 0;
    active = tlen > 0 && qlen > 0;
  }

  // The end of row i, whose band was [bg, en): its largest H (best, -1
  // for an empty band) at column bestj (the largest j among ties), H at
  // the band's last column (h_endm1), and the first and last live columns
  // of the rolled-over H and E over [bg, en] when any_live.
  __device__ void row(const Args& p, int bg, int en, int h_endm1, int best,
                      int bestj, bool any_live, int first, int last) {
    const int m_best = max(best, 0);
    const int mj = m_best > 0 ? bestj : -1;
    if (en == qlen && gscore <= h_endm1) {
      gscore = h_endm1;
      max_ie = i;
    }
    const bool improved = m_best > mx;
    const int di = i - max_i;
    const int dj = mj - max_j;
    const bool zd1 = mx - m_best - (di - dj) * p.e_del > p.zdrop;
    const bool zd2 = mx - m_best - (dj - di) * p.e_ins > p.zdrop;
    const bool break_z = !improved && p.zdrop > 0 && (di > dj ? zd1 : zd2);
    if (improved) {
      max_off = max(max_off, abs(mj - i));
      mx = m_best;
      max_i = i;
      max_j = mj;
    }
    if (any_live) {
      beg = first;
      end = min(last + 2, qlen);
    } else {
      beg = en;
      end = min(bg + 1, qlen);
    }
    active = !(m_best == 0 || break_z || i + 1 >= tlen);
    ++i;
  }

  __device__ void write(const Args& p, int lane) const {
    p.out[0 * p.B + lane] = mx;
    p.out[1 * p.B + lane] = max_j + 1;
    p.out[2 * p.B + lane] = max_i + 1;
    p.out[3 * p.B + lane] = max_ie + 1;
    p.out[4 * p.B + lane] = gscore;
    p.out[5 * p.B + lane] = max_off;
  }
};

// Columns of one lane in shared memory: the band ends at qlen <= WQ and a
// row writes up to column en + 1; a stripe's last chunk may run up to
// G + kChunk - 2 columns past the band end.
__host__ __device__ constexpr int lane_cols(int WQ) { return WQ + G + kChunk; }

constexpr int kFullMaxWQ = 320;  // widest query of the every-column layout
constexpr int kPackedMaxWQ = 65000;  // live_pair's 16-bit halves

// a lane's layout: every column, the ring with the query codes in shared
// memory, or the ring alone (the codes read from device memory)
enum Layout { kAllCols = 0, kRing = 1, kWide = 2 };

// H and E slots of a lane: every column, or the ring's R slots
__host__ __device__ constexpr int lane_slots(int WQ, int ring, int layout) {
  return layout == kAllCols ? lane_cols(WQ) : ring;
}

// Shared memory of one lane: H and E as int32, then (but in the wide
// layout) one byte of query code a column.
__host__ __device__ constexpr int lane_bytes(int WQ, int ring, int layout) {
  return (lane_slots(WQ, ring, layout) * 8 +
          (layout == kWide ? 0 : lane_cols(WQ)) + 15) & ~15;
}

// a thread's first and last live column as (65535 - first, last + 1):
// one per-halfword max over the group gives the group's; 0 for none
__device__ __forceinline__ unsigned live_pair(int first, int last) {
  return last >= 0
             ? ((unsigned)(65535 - first) << 16) | (unsigned)(last + 1)
             : 0u;
}

// The shared-memory slot of column j: the column itself, or its ring slot
template <int kLayout>
struct Cols {
  int mask;
  __device__ __forceinline__ int operator()(int j) const {
    return kLayout != kAllCols ? (j & mask) : j;
  }
};

template <int kLayout>
__global__ void __launch_bounds__(kThreads) sw_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char sw_smem[];
  const int t = threadIdx.x % G;
  const int slot = threadIdx.x / G;
  const int lane = blockIdx.x * (kThreads / G) + slot;
  const bool real = lane < p.B;  // groups past B idle along with their warp
  if (p.gate != nullptr && *p.gate == 0) return;  // nothing to extend

  const int WQ = p.WQ;
  const int NC = lane_cols(WQ);
  const int NS = kLayout != kAllCols ? p.ring : NC;  // H and E slots
  const Cols<kLayout> col{p.ring - 1};
  int* H = reinterpret_cast<int*>(
      sw_smem + (size_t)slot * lane_bytes(WQ, p.ring, kLayout));
  int* E = H + NS;
  unsigned char* Q = reinterpret_cast<unsigned char*>(E + NS);

  Lane ln;
  ln.init(p, lane, real);
  // a warp whose lanes all have an empty query or target (a retry's idle
  // lanes, sorted last) writes their start state without loading a row
  if (!__any_sync(kFull, ln.active)) {
    if (real && t == 0) ln.write(p, lane);
    return;
  }
  const int qlen = ln.qlen, h0 = ln.h0, w = ln.w;
  const int a = p.a, b = p.b, e_del = p.e_del, e_ins = p.e_ins;
  const int oe_del = p.o_del + e_del;
  const int oe_ins = p.o_ins + e_ins;

  const int* qrow = p.query + (size_t)(real ? lane : 0) * WQ;
  const int* trow = p.target + (size_t)(real ? lane : 0) * p.WT;
  if (kLayout != kWide) {
    for (int j = t; j < NC; j += G) {
      const int q = (real && j < WQ) ? qrow[j] : 4;
      Q[j] = (unsigned char)((q >= 0 && q <= 3) ? q : 4);
    }
  }
  // the boundary row's H (in the ring, of the columns the first row reads)
  for (int j = t; j < NS; j += G) {
    const int hf = (j == 0) ? h0 : h0 - oe_ins - e_ins * (j - 1);
    H[j] = (j < WQ && hf > 0 && j < qlen + 1) ? hf : 0;
    E[j] = 0;
  }
  __syncwarp();

  // Target bases are read G rows at a time, a chunk ahead of use, so no
  // row waits on device memory: thread t holds row r + t of the current
  // chunk [r, r + G) and of the next one.
  const auto tbase = [&](int row) { return trow[min(row, p.WT - 1)]; };
  int t_cur = tbase(t), t_next = tbase(G + t);
  int tb_raw = __shfl_sync(kFull, t_cur, 0, G);  // this row's target base

  // The warp stays converged: its groups run the row loop until the last
  // of its lanes stops (a stopped lane has an empty band and keeps its
  // state).
  while (__any_sync(kFull, ln.active)) {
    SW_ROW_BEGIN
    const int i = ln.i;
    const int bg = max(ln.beg, i - w);
    const int en = min(min(ln.end, i + w + 1), qlen);
    const int h1b = (bg == 0) ? max(h0 - (oe_del + e_del * i), 0) : 0;
    const int tb = min(max(tb_raw, 0), 4);
    // the next row's base, fetched now so that no row waits on a shuffle
    const int k_nx = (i + 1) & (G - 1);
    const int tb_nx = __shfl_sync(kFull, k_nx ? t_cur : t_next, k_nx, G);
    const int n = ln.active ? en - bg : 0;  // in-band columns (none if <= 0)

    // this row's scores: sa on a match, sb on a mismatch, -1 on an
    // ambiguous query base (code 4)
    const int sa = tb <= 3 ? a : -1;
    const int sb = tb <= 3 ? -b : -1;
    const int L = (max(n, 0) + G - 1) / G;
    const int c0 = bg + t * L;
    const int c1 = min(c0 + L, en);
    SW_MARK(1);

    // pass 1: M of each cell (stored over H, whose old value only M
    // needs), and the stripe's max of t_ins + e_ins * j for the F scan.
    // Cells go kChunk at a time, loads first; a chunk may run past the
    // stripe end c1 into the next stripe or the lane's padding, where it
    // only reads.
    int g = 0;
    for (int c = c0; c < c0 + L; c += kChunk) {
      int hv[kChunk], qv[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        hv[u] = H[col(c + u)];
        if (kLayout == kWide) {  // the codes past c1 are never used
          const int q = __ldg(qrow + min(c + u, WQ - 1));
          qv[u] = (q >= 0 && q <= 3) ? q : 4;
        } else {
          qv[u] = Q[c + u];
        }
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const bool ok = c + u < c1;
        const int s = qv[u] == tb ? sa : (qv[u] > 3 ? -1 : sb);
        const int m = hv[u] != 0 ? hv[u] + s : 0;
        if (ok) H[col(c + u)] = m;
        const int gn = __viaddmax_s32(g, -e_ins, __viaddmax_s32(m, -oe_ins, 0));
        g = ok ? gn : g;
      }
    }
    SW_MARK(2);
    int run = c1 > c0 ? g + e_ins * (c1 - 1) : kNeg;
#pragma unroll
    for (int d = 1; d < G; d <<= 1) {
      const int v = __shfl_up_sync(kFull, run, d, G);
      if (t >= d) run = max(run, v);
    }
    int excl = __shfl_up_sync(kFull, run, 1, G);
    if (t == 0) excl = kNeg;
    SW_MARK(3);

    // pass 2: the cells. g is F at the next column; H is written shifted
    // by one column (H[j] = H(i, j-1)), H[c0] after the loop.
    g = max(excl - e_ins * (c0 - 1), 0);
    int best = -1, bestj = -1, first = 1 << 30, last = -1, hprev = 0;
    for (int c = c0; c < c0 + L; c += kChunk) {
      int mv[kChunk], ev[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        mv[u] = H[col(c + u)];
        ev[u] = E[col(c + u)];
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int j = c + u;
        const bool ok = j < c1;
        const int m = mv[u], ec = ev[u];
        const int f = g;
        const int gn = __viaddmax_s32(g, -e_ins, __viaddmax_s32(m, -oe_ins, 0));
        g = ok ? gn : g;
        const int hr = __vimax3_s32(m, ec, f);
        const int enx =
            __viaddmax_s32(ec, -e_del, __viaddmax_s32(m, -oe_del, 0));
        if (ok) {
          E[col(j)] = enx;
          H[col(j)] = hprev;
        }
        bool ge;
        best = __vibmax_s32(ok ? hr : -2, best, &ge);
        bestj = ge ? j : bestj;
        if (ok && (hprev | enx) != 0) {  // live: H(i, j-1) or E(i, j)
          first = min(first, j);
          last = j;
        }
        hprev = ok ? hr : hprev;
      }
    }
    SW_MARK(4);
    const int left = __shfl_up_sync(kFull, hprev, 1, G);
    int h_end = 0;
    if (c1 > c0) {
      const int hc0 = t == 0 ? h1b : left;
      H[col(c0)] = hc0;
      if (hc0 != 0) {
        first = c0;
        last = max(last, c0);
      }
      if (c1 == en) {  // this thread holds the band end
        h_end = hprev;
        H[col(en)] = hprev;
        E[col(en)] = 0;
        H[col(en + 1)] = 0;
        E[col(en + 1)] = 0;
        if (hprev != 0) {
          first = min(first, en);
          last = en;
        }
      }
    }
    SW_MARK(5);
    // the row max and its column as one 64-bit key: values may need all
    // 32 bits
    long long key = (long long)best * 4294967296LL + (bestj + 1);
    bool any_live;
    int live_first, live_last;
    if (kLayout == kWide) {  // columns past 65,535: two 32-bit reductions
#pragma unroll
      for (int d = G / 2; d > 0; d >>= 1) {
        key = max(key, __shfl_xor_sync(kFull, key, d, G));
        first = min(first, __shfl_xor_sync(kFull, first, d, G));
        last = max(last, __shfl_xor_sync(kFull, last, d, G));
        h_end = max(h_end, __shfl_xor_sync(kFull, h_end, d, G));  // H >= 0
      }
      any_live = last >= 0;
      live_first = first;
      live_last = last;
    } else {
      unsigned live = live_pair(first, last);
#pragma unroll
      for (int d = G / 2; d > 0; d >>= 1) {
        key = max(key, __shfl_xor_sync(kFull, key, d, G));
        live = __vmaxu2(live, __shfl_xor_sync(kFull, live, d, G));
        h_end = max(h_end, __shfl_xor_sync(kFull, h_end, d, G));  // H >= 0
      }
      any_live = (live & 0xffffu) != 0;
      live_first = 65535 - (int)(live >> 16);
      live_last = (int)(live & 0xffffu) - 1;
    }
    best = (int)(key >> 32);
    bestj = (int)(key & 0xffffffffLL) - 1;
    SW_MARK(6);
    // An empty band (n <= 0) leaves H and E as they are: its row max is 0,
    // so the lane stops after this row.

    if (ln.active) {
      ln.row(p, bg, en, n > 0 ? h_end : h1b, best, bestj, any_live,
             live_first, live_last);
      tb_raw = tb_nx;
      if ((ln.i & (G - 1)) == 0) {
        t_cur = t_next;
        t_next = tbase(ln.i + G + t);
      }
    }
    SW_MARK(7);
    __syncwarp();  // this row's H and E before the next row reads them
    SW_MARK(8);
    SW_ROW_END(lane == 0 && t == 0)
  }

  if (real && t == 0) ln.write(p, lane);
}

// The ring's slots for bands up to max_w: the least power of two that
// holds a row's 2 * max_w + 3 columns (0 in the every-column layout).
int ring_slots(int WQ, int max_w) {
  if (WQ <= kFullMaxWQ) return 0;
  int r = 16;
  while (r < 2 * max_w + 3) r <<= 1;
  return r;
}

// The card's shared memory a block may take (its opt-in limit).
int smem_optin() {
  static const int v = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return n;
  }();
  return v;
}

// The block's shared memory at query width WQ with bands up to max_w in
// a layout.
int block_bytes(int WQ, int max_w, int layout) {
  return kThreads / G * lane_bytes(WQ, ring_slots(WQ, max_w), layout);
}

// The layout of a launch: every column up to WQ = 320; above it the ring
// with the codes in shared memory where its block fits the card (and WQ
// fits live_pair's halves), else the wide layout.
int pick_layout(int WQ, int max_w) {
  if (WQ <= kFullMaxWQ) return kAllCols;
  return WQ <= kPackedMaxWQ && block_bytes(WQ, max_w, kRing) <= smem_optin()
             ? kRing
             : kWide;
}

// Lets the kernel's instantiation take `bytes` of shared memory a block
// and asks for the SM's whole carveout as shared memory, so that as many
// lanes as fit stay resident. The first call at the every-column layout
// sets WQ = 320's size; a wider ring launch raises the limit to its
// size, once a size, so that a CUDA graph capture replaying a launch
// already made sets nothing. Returns false past the card's limit.
template <int kLayout>
bool set_smem(int bytes) {
  static int allowed = 0;
  static const bool carveout = [] {
    cudaFuncSetAttribute(sw_kernel<kLayout>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    return true;
  }();
  (void)carveout;
  if (bytes > smem_optin()) return false;
  if (bytes > allowed) {
    allowed = kLayout != kAllCols
                  ? bytes
                  : kThreads / G * lane_bytes(kFullMaxWQ, 0, kAllCols);
    cudaFuncSetAttribute(sw_kernel<kLayout>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, allowed);
  }
  return true;
}

bool set_smem(int layout, int bytes) {
  return layout == kAllCols   ? set_smem<kAllCols>(bytes)
         : layout == kRing ? set_smem<kRing>(bytes)
                           : set_smem<kWide>(bytes);
}

}  // namespace

// The layout a launch at query width WQ with bands up to max_w takes, for
// reports and checks: 0 every column, 1 the ring, 2 the wide layout.
extern "C" int sw_extend_layout(int WQ, int max_w) {
  return pick_layout(WQ, max_w);
}

// Occupancy of the kernel at query width WQ and bands up to max_w, for
// reports: blocks of kThreads resident on one SM, or -1 on a CUDA error
// or past the card's shared-memory limit.
extern "C" int sw_extend_blocks_per_sm(int WQ, int max_w) {
  int n = 0;
  const int layout = pick_layout(WQ, max_w);
  const int bytes = block_bytes(WQ, max_w, layout);
  if (!set_smem(layout, bytes)) return -1;
  const cudaError_t rc =
      layout == kAllCols ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                            &n, sw_kernel<kAllCols>, kThreads, bytes)
      : layout == kRing ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                              &n, sw_kernel<kRing>, kThreads, bytes)
                        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                              &n, sw_kernel<kWide>, kThreads, bytes);
  return rc == 0 ? n : -1;
}

#ifdef SW_PROFILE
// the phase counters of a profile build: copied out to / zeroed from a
// host array of 10 unsigned 64-bit ints
extern "C" int sw_prof_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, sw_prof, sizeof(sw_prof));
}
extern "C" int sw_prof_zero() {
  const unsigned long long z[10] = {0};
  return (int)cudaMemcpyToSymbol(sw_prof, z, sizeof(z));
}
#endif

// Plain C entry points (bound with ctypes). query int32[B, WQ], target
// int32[B, WT], qlen/tlen/w0/h0 int32[B], out int32[6, B] (score, qle,
// tle, gtle, gscore, max_off). max_w bounds every lane's w0 (it sizes the
// ring of a WQ > 320 launch; a lane's band past it would be wrong).
// sw_extend_gated_launch also takes `gate`, a device int32 (or null): a
// launch whose gate reads 0 returns at once and writes nothing (the
// extension stage's rounds with no active read or no retry, whose results
// no one reads). Any WQ runs (the wide layout past the ring's shared
// memory). Returns cudaErrorInvalidValue for bad sizes, else
// cudaGetLastError().
extern "C" int sw_extend_gated_launch(const void* query, const void* qlen,
                                      const void* target, const void* tlen,
                                      const void* w0, const void* h0,
                                      void* out, int B, int WQ, int WT,
                                      int a, int b, int o_del, int e_del,
                                      int o_ins, int e_ins, int end_bonus,
                                      int zdrop, int max_w, const void* gate,
                                      void* stream) {
  if (WQ < 1 || WT < 1 || max_w < 0) return (int)cudaErrorInvalidValue;
  const int ring = ring_slots(WQ, max_w);
  const Args p{static_cast<const int*>(query), static_cast<const int*>(qlen),
               static_cast<const int*>(target), static_cast<const int*>(tlen),
               static_cast<const int*>(w0), static_cast<const int*>(h0),
               static_cast<int*>(out), B, WQ, WT, a, b, o_del, e_del, o_ins,
               e_ins, end_bonus, zdrop, ring, static_cast<const int*>(gate)};
  const int layout = pick_layout(WQ, max_w);
  const int smem = block_bytes(WQ, max_w, layout);
  if (!set_smem(layout, smem)) return (int)cudaErrorInvalidValue;
  const int lanes = kThreads / G;
  const dim3 grid((B + lanes - 1) / lanes);
  const auto st = static_cast<cudaStream_t>(stream);
  if (layout == kAllCols)
    sw_kernel<kAllCols><<<grid, kThreads, smem, st>>>(p);
  else if (layout == kRing)
    sw_kernel<kRing><<<grid, kThreads, smem, st>>>(p);
  else
    sw_kernel<kWide><<<grid, kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int sw_extend_launch(const void* query, const void* qlen,
                                const void* target, const void* tlen,
                                const void* w0, const void* h0, void* out,
                                int B, int WQ, int WT, int a, int b,
                                int o_del, int e_del, int o_ins, int e_ins,
                                int end_bonus, int zdrop, int max_w,
                                void* stream) {
  return sw_extend_gated_launch(query, qlen, target, tlen, w0, h0, out, B,
                                WQ, WT, a, b, o_del, e_del, o_ins, e_ins,
                                end_bonus, zdrop, max_w, nullptr, stream);
}
