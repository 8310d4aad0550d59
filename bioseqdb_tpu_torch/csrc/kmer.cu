// Minimizer-table seeding for Hopper: BWA-MEM's rounds 1 and 3 (and the
// round-2 certificate) of every read in one launch, a thread a read.
//
// Replaces the TPU program of bioseqdb_tpu/kernels/kmer.py:340
// collect_seeds_kmer: the read's (k 14, w 6) minimizers (_select_minimizers
// :270), the table lookups, the diagonal dedup (:454), each diagonal's match
// reach (_match_reach :297, the reach loop :472), the top-2 statistics,
// round 1 (:506), the round-2 certificate (:526) and the round-3 chase
// (:539-591). XLA compiled those loops into the one TPU device program; no
// Pallas. The kernel computes exactly what the plain version
// bioseqdb_tpu_torch/kernels/kmer.py collect_seeds_kmer_plain computes (the
// vectorised port, equal to the JAX package), output for output.
//
// What bounds it: a read reads its codes once, one bucket word and one
// 14-entry window of a table row a minimizer, and the text words under its
// few candidate diagonals; it writes M seed slots. That is ~2-3 KB a read,
// ~10 us for 16,384 reads at the card's memory rate. The work between is a
// few thousand integer operations a read (the k-mer hashes, the minimizer
// runs, one compare a diagonal and position for the reach and the top-2
// merge), ~0.1 G instructions a batch: under the byte bound's time at the
// card's issue rate. One thread a read runs its read's steps as one
// dependent chain, so what a launch costs is one read's chain of local-
// memory steps at the card's latency, not its rates.
//
// Design:
// - One thread a read, 128 threads a block. A warp a read is the natural
//   shape for the reach and the dedup (data-parallel over positions and
//   candidates), and at B = 16,384 a thread a read fills only 128 blocks;
//   it was not taken because the whole body then is one plain function,
//   the same for the card and for a g++ build of this file, which the CPU
//   tests hold against the plain version. The warp shape is later work.
// - Per-read state in per-thread arrays sized by the static limits (W <=
//   kMaxWidth, nmz <= kMaxNmz, dmax <= kMaxDmax, smax <= kMaxSmax, M <=
//   kMaxMem; the wrapper refuses more): the hashes, the minimizer slots,
//   the sorted distinct diagonals, and per position R1, R2, I1 (the top-2
//   reaches and the first argmax diagonal) and the round-3 count.
// - The plain version's chunked top-2 merge (8 diagonals a chunk) is a
//   merge of top-2 multisets with the first argmax, which is associative:
//   taking the diagonals one at a time in order gives the same R1, R2 and
//   I1. Diagonals past the valid ones (the dedup's 0x7FFFFFFF fill) have
//   reach p, which changes nothing that the final max(., p) does not, so
//   the loop stops at the valid ones.
// - The dedup keeps the DC + 1 smallest distinct diagonals in a sorted
//   list: the first DC are the plain version's successive masked minima,
//   and a (DC + 1)-th one is its d_overflow.
// - Every sum that can wrap in the plain version's int32 tensors (d1 + p)
//   wraps the same way here (wrap_add).

#include "lanes.cuh"

namespace {

constexpr int kThreads = 128;        // a block: one read a thread
constexpr int kK = 14;               // index/layout.py K
constexpr int kWin = 6;              // index/layout.py WIN
constexpr int kMaxWidth = 320;       // pipeline.py KMER_MAX_WIDTH
constexpr int kMaxNmz = 104;         // layout.nmz_for(320)
constexpr int kMaxDmax = 40;         // layout.dmax_for's cap
constexpr int kMaxSmax = 14;         // layout.smax_for's cap
constexpr int kMaxMem = 64;          // seed slots a read
constexpr int kBig = 0x7FFFFFFF;     // kmer.py _BIG
constexpr uint32_t kUMax = 0xFFFFFFFFu;  // an invalid k-mer's hash
constexpr int kRefused = 1;          // cudaErrorInvalidValue

struct KmerParams {
  const int32_t* bmeta;     // [2^bb] (offset << 4) | min(count, 15)
  const int32_t* entries;   // [n_rows, 32] packed (pos << low_bits) | low key
  const int32_t* text;      // [n_words] packed doubled text, 16 codes a word
  const int32_t* codes;     // [B, W]
  const int32_t* lens;      // [B]
  int32_t* mem_pos;         // [B, M] out
  int32_t* mem_s;           // [B, M] out
  int32_t* mem_b;           // [B, M] out
  int32_t* mem_e;           // [B, M] out
  int32_t* n_mem;           // [B] out
  uint8_t* needs_r2;        // [B] out (torch.bool)
  uint8_t* overflow;        // [B] out (torch.bool)
  int32_t* why;             // [B] out, the fallback bits
  long long n_rows, n_words, seq_len, B, W, bb, min_seed_len, split_len,
      split_width, max_mem_intv, smax, dmax, nmz, M;
};


// an int32 sum that wraps, as the tensors' do
LANE_HD inline int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// murmur3's finalizer (layout._mix32, kmer.py mix32), native uint32
LANE_HD inline uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// a read code in a byte: bits 0-1 its low two bits (the k-mer's), bit 2 set
// for a code >= 4 (ambiguous: no k-mer, no match), bit 3 for a negative
// code (a k-mer base that matches no text code)
LANE_HD inline uint8_t code8(int32_t c) {
  return static_cast<uint8_t>((c & 3) | (c >= 4 ? 4 : 0) | (c < 0 ? 8 : 0));
}


// add v to the sorted list of the cap smallest distinct values
LANE_HD inline void insert_distinct(int32_t* dl, int& nd, int cap,
                                    int32_t v) {
  int k = 0;
  while (k < nd && dl[k] < v) ++k;
  if ((k < nd && dl[k] == v) || k >= cap) return;
  for (int m = min_(nd, cap - 1); m > k; --m) dl[m] = dl[m - 1];
  dl[k] = v;
  if (nd < cap) ++nd;
}

// collect_seeds_kmer_plain for read b (one lane)
LANE_HD void kmer_seed_lane(const KmerParams& p, long long b) {
  const int W = static_cast<int>(p.W);
  const int NP = W - kK + 1;
  const int NW = NP - kWin + 1;
  const int M = static_cast<int>(p.M);
  const int msl = static_cast<int>(p.min_seed_len);
  const int smax = static_cast<int>(p.smax);
  const int32_t len = p.lens[b];
  const int32_t* row = p.codes + b * p.W;
  uint8_t c8[kMaxWidth];
  for (int q = 0; q < W; ++q) c8[q] = code8(row[q]);

  // ---- k-mer hashes (an invalid k-mer hashes to kUMax) ----
  uint32_t h[kMaxWidth];
  {
    uint32_t km = 0;
    int last_bad = -1;
    for (int q = 0; q < W; ++q) {
      km = ((km << 2) | (c8[q] & 3u)) & ((1u << (2 * kK)) - 1u);
      if (c8[q] & 4) last_bad = q;
      const int j = q - kK + 1;
      if (j >= 0)
        h[j] = (last_bad < j && j + kK <= len) ? mix32(km) : kUMax;
    }
  }

  // ---- minimizers (run-length form), compacted in position order ----
  const int nmz_c = min_(static_cast<int>(p.nmz), NP);
  int16_t mzpos[kMaxNmz];
  uint32_t mzkey[kMaxNmz];   // the k-mer; kUMax marks an invalid one
  int nsel = 0;
  for (int j = 0; j < NP; ++j) {
    const uint32_t hj = h[j];
    int L = 0, R = 0;
    for (int u = 1; u < kWin && j >= u && h[j - u] > hj; ++u) ++L;
    for (int u = 1; u < kWin && j < NP - u && h[j + u] >= hj; ++u) ++R;
    const int s_lo = max_(max_(j - kWin + 1, 0), j - L);
    const int s_hi = min_(min_(j, NW - 1), j + R - kWin + 1);
    if (s_lo > s_hi) continue;
    if (nsel < nmz_c) {   // the k-mer and its validity, again
      uint32_t km = 0;
      bool ok = j + kK <= len;
      for (int t = 0; t < kK; ++t) {
        km = (km << 2) | (c8[j + t] & 3u);
        ok = ok && !(c8[j + t] & 4);
      }
      mzpos[nsel] = static_cast<int16_t>(j);
      mzkey[nsel] = ok ? km : kUMax;
    }
    ++nsel;
  }
  const bool mz_overflow = nsel > nmz_c;

  // ---- table lookups -> the DC + 1 smallest distinct diagonals ----
  const int low_bits = 2 * kK - static_cast<int>(p.bb);
  const uint32_t low_mask = (1u << low_bits) - 1u;
  const long long nrows0 = (p.n_rows - 1) / 2;
  const int DC = min_(static_cast<int>(p.dmax), nmz_c * smax);
  int32_t dl[kMaxDmax + 1];
  int nd = 0;
  bool capped_any = false;
  for (int i = 0; i < min_(nsel, nmz_c); ++i) {
    const uint32_t key = mzkey[i];
    if (key == kUMax) continue;   // not mzok
    const int32_t bm = p.bmeta[key >> low_bits];
    const int32_t o0 = bm >> 4;
    const int cnt = bm & 15;
    if (cnt > smax) {
      capped_any = true;
      continue;
    }
    const int col0 = o0 & 31;
    const bool use1 = col0 > 32 - smax;
    long long r = use1 ? nrows0 + ((o0 - 16) >> 5) : (o0 >> 5);
    r = r < 0 ? 0 : (r >= p.n_rows ? p.n_rows - 1 : r);
    const int col = use1 ? col0 - 16 : col0;
    const int32_t* erow = p.entries + r * 32;
    for (int t = 0; t < cnt; ++t) {
      const int tt = col + t;
      const uint32_t ev = tt < 32 ? static_cast<uint32_t>(erow[tt]) : 0u;
      if ((ev & low_mask) != (key & low_mask)) continue;
      insert_distinct(dl, nd, DC + 1,
                      static_cast<int32_t>(ev >> low_bits) - mzpos[i]);
    }
  }
  const bool d_overflow = nd > DC;
  const int D = min_(nd, DC);   // valid diagonals, ascending
  for (int k = D; k < DC; ++k) dl[k] = kBig;

  // ---- each valid diagonal's reach -> the top-2 statistics ----
  int16_t R1[kMaxWidth], R2[kMaxWidth];
  uint8_t I1[kMaxWidth], cnt3[kMaxWidth];
  for (int q = 0; q < W; ++q) {
    R1[q] = R2[q] = 0;
    I1[q] = cnt3[q] = 0;
  }
  for (int k = 0; k < D; ++k) {
    const long long d = dl[k];
    int next = W;   // the first mismatch at or after q (W: none)
    for (int q = W - 1; q >= 0; --q) {
      const long long t = d + q;
      const bool match = t >= 0 && t < p.seq_len && c8[q] < 4 &&
                         packed_code(p.text, p.n_words, t) == c8[q];
      if (!match) next = q;
      if (next > R1[q]) {
        R2[q] = R1[q];
        R1[q] = static_cast<int16_t>(next);
        I1[q] = static_cast<uint8_t>(k);
      } else if (next > R2[q]) {
        R2[q] = static_cast<int16_t>(next);
      }
      cnt3[q] += next >= q + msl + 1;
    }
  }

  // ---- the round-2 certificate's last repeat position ----
  int16_t lastrep[kMaxWidth];
  {
    int last = -1;
    for (int q = 0; q < W; ++q) {
      if (max_(static_cast<int>(R2[q]), q) >= q + msl) last = q;
      lastrep[q] = static_cast<int16_t>(last);
    }
  }

  // ---- round 1: SMEMs at the strict increases of E = R1 ----
  int32_t* mem_pos = p.mem_pos + b * p.M;
  int32_t* mem_s = p.mem_s + b * p.M;
  int32_t* mem_b = p.mem_b + b * p.M;
  int32_t* mem_e = p.mem_e + b * p.M;
  int n_r1 = 0;
  bool multi1_any = false, needs_r2 = false;
  int Eprev = -1;
  for (int q = 0; q < W; ++q) {
    const int E = max_(static_cast<int>(R1[q]), q);
    if (E > Eprev && E - q >= msl) {
      if (max_(static_cast<int>(R2[q]), q) >= E) multi1_any = true;
      if (n_r1 < M) {
        mem_b[n_r1] = q;
        mem_e[n_r1] = E;
        mem_pos[n_r1] = wrap_add(dl[I1[q]], q);
        mem_s[n_r1] = 1;
        const int pivot = min_(max_((q + E) >> 1, 0), W - 1);
        const int lr = lastrep[pivot];
        if (E - q >= p.split_len && 1 <= p.split_width && lr >= 0 &&
            lr > pivot - msl)
          needs_r2 = true;
      }
      ++n_r1;
    }
    Eprev = E;
  }
  bool r1_overflow = n_r1 > M;

  // ---- round 3: the deterministic successor chase ----
  int n = n_r1;
  bool r3_multi = false, r3_stuck = false;
  if (p.max_mem_intv > 0) {
    int16_t namb[kMaxWidth], nvalid[kMaxWidth];
    int na = W, nv = W;
    for (int q = W - 1; q >= 0; --q) {
      if ((c8[q] & 4) || q >= len)
        na = q;
      else
        nv = q;
      namb[q] = static_cast<int16_t>(na);
      nvalid[q] = static_cast<int16_t>(nv);
    }
    const int T = W / (msl + 1) + 18;
    int cur = nvalid[0];
    bool ovf3 = false;
    for (int it = 0; it < T && cur < W; ++it) {
      const int x = cur;
      const int stop = x + msl;
      const bool clean = namb[x] > stop;
      const int s_here = cnt3[x];
      if (clean && s_here >= 1) {   // an emission
        if (s_here >= 2) r3_multi = true;
        if (n < M) {
          mem_pos[n] = wrap_add(dl[I1[x]], x);
          mem_s[n] = s_here;
          mem_b[n] = x;
          mem_e[n] = stop + 1;
          ++n;
        } else {
          ovf3 = true;
        }
      }
      const int nx = clean ? stop + 1 : namb[x] + 1;
      cur = nx >= W ? W : nvalid[nx];
    }
    r3_stuck = cur < W;
    r1_overflow = r1_overflow || ovf3;
  }
  for (int s = min_(n, M); s < M; ++s)
    mem_pos[s] = mem_s[s] = mem_b[s] = mem_e[s] = 0;

  const bool bits[7] = {mz_overflow, capped_any, d_overflow, multi1_any,
                        r1_overflow, r3_multi, r3_stuck};
  int32_t why = 0;
  for (int k = 0; k < 7; ++k) why |= static_cast<int32_t>(bits[k]) << k;
  p.n_mem[b] = n;
  p.overflow[b] = why != 0;
  p.needs_r2[b] = needs_r2 && why == 0;
  p.why[b] = why;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(kThreads) kmer_seed(const KmerParams p) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (b < p.B) kmer_seed_lane(p, b);
}
#endif

bool refused(const KmerParams& p) {
  const int NP = static_cast<int>(p.W) - kK + 1;
  return p.B < 1 || p.W > kMaxWidth || NP - kWin + 1 < 1 || p.nmz < 1 ||
         p.nmz > kMaxNmz || p.dmax < 1 || p.dmax > kMaxDmax || p.smax < 1 ||
         p.smax > kMaxSmax || p.M < 1 || p.M > kMaxMem || p.bb < 14 ||
         p.bb > 26 || p.min_seed_len < 1 || p.n_rows < 1 || p.n_words < 1;
}

}  // namespace


// kmer_seed_launch (nvcc; on `stream`) or kmer_seed_host (a host compiler;
// every read in turn): 0, or a CUDA error code (kRefused for a refused
// shape)
extern "C" int LANE_ENTRY(kmer_seed)(
    const int32_t* bmeta, const int32_t* entries, const int32_t* text,
    const int32_t* codes, const int32_t* lens, int32_t* mem_pos,
    int32_t* mem_s, int32_t* mem_b, int32_t* mem_e, int32_t* n_mem,
    uint8_t* needs_r2, uint8_t* overflow, int32_t* why, long long n_rows,
    long long n_words, long long seq_len, long long B, long long W,
    long long bb, long long min_seed_len, long long split_len,
    long long split_width, long long max_mem_intv, long long smax,
    long long dmax, long long nmz, long long M LANE_STREAM) {
  const KmerParams p{bmeta,    entries,   text,         codes,     lens,
                     mem_pos,  mem_s,     mem_b,        mem_e,     n_mem,
                     needs_r2, overflow,  why,          n_rows,    n_words,
                     seq_len,  B,         W,            bb,        min_seed_len,
                     split_len, split_width, max_mem_intv, smax,   dmax,
                     nmz,      M};
  if (refused(p)) return kRefused;
#ifdef __CUDACC__
  const unsigned grid = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  kmer_seed<<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
#else
  for (long long b = 0; b < B; ++b) kmer_seed_lane(p, b);
  return 0;
#endif
}
