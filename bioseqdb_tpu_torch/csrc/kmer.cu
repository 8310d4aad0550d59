// Minimizer-table seeding for Hopper: BWA-MEM's rounds 1 and 3 (and the
// round-2 certificate) of every read in one launch, a warp a read.
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
// ~7 us for 16,384 reads at the card's memory rate. The work between is a
// few thousand integer operations a read, ~0.1 G instructions a batch:
// under the byte bound's time at the card's issue rate. So what a launch
// costs is latency: the length of a read's chain of dependent steps.
// A thread a read (the first version) ran every step of a read in turn
// over per-thread arrays sized by the static caps, 6,240 bytes of stack in
// local memory that missed L1: 0.58 ms, ~1.2% of the bound.
//
// Design: a warp a read, 4 warps a block; every stage but the round-3
// chase is data-parallel over the read's positions, minimizers or
// candidates, so a warp runs each as a few passes of 32 lanes with the
// exchanges in between, and the chain shrinks from ~W steps a stage to
// ~W / 32. The per-read state is in shared memory, carved per warp by the
// call's W, nmz and smax (Smem), not by the static caps:
// - codes: one coalesced load (lane t owns positions t, t + 32, ...);
// - k-mer hashes: a lane a run of consecutive starts, the k-mer rolled
//   along it; minimizer runs: per position; the selected ones are
//   compacted in position order with a ballot and a prefix popcount, so
//   nsel, mz_overflow and the first nmz_c slots are the plain version's;
// - lookups: a lane a minimizer, so all bucket words and row windows are
//   in flight together; each minimizer's hits go to its own smax slots,
//   with their count; capped_any is a vote;
// - dedup: the plain version keeps the DC + 1 smallest distinct diagonals
//   (the last is d_overflow), a set that does not depend on order: so
//   the warp takes them as repeated warp minima over the hits;
// - reach, a diagonal at a time in ascending order: the match flags over
//   the positions, the text words loaded coalesced; "the first mismatch at
//   or after q" a suffix scan of ballots (a chunk's mismatch mask and the
//   carry from the chunks after it); each position's top-2 merge run by
//   the lane that owns it, over the diagonals in order, so the first
//   argmax (next > R1) is the plain version's. The plain version's merge
//   of 8-diagonal chunks is associative, so one at a time is the same;
// - the round-2 certificate's last repeat position and the chase's next
//   ambiguous / next valid position: ballot scans as above;
// - round 1: a per-position test and an ordered compaction (multi1_any
//   over every emission, past M included; needs_r2 over the first M);
// - round 3: the successor chase is sequential by nature; the whole warp
//   runs it on the same values over shared memory, lane 0 stores.
// Every sum that can wrap in the plain version's int32 tensors (d1 + p)
// wraps the same way here (wrap_add). Compiled by a host compiler, the
// same warp body runs over 32 emulated lanes (lanes.cuh), which the CPU
// tests hold against the plain version.

#include "lanes.cuh"

namespace {

constexpr int kWarp = 32;            // a read's threads
constexpr int kWarps = 4;            // reads a block
constexpr int kK = 14;               // index/layout.py K
constexpr int kWin = 6;              // index/layout.py WIN
constexpr int kMaxWidth = 320;       // pipeline.py KMER_MAX_WIDTH
constexpr int kMaxChunks = kMaxWidth / kWarp;   // a lane's positions
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

// a position's top-2 statistics in one word: R1 and R2 (the two largest
// reaches, <= W < 512), I1 (the first argmax diagonal, < 64) and the
// round-3 count (<= D < 64)
LANE_HD inline uint32_t stat_word(int r1, int r2, int i1, int c3) {
  return static_cast<uint32_t>(r1) | static_cast<uint32_t>(r2) << 9 |
         static_cast<uint32_t>(i1) << 18 | static_cast<uint32_t>(c3) << 24;
}
LANE_HD inline int stat_r1(uint32_t s) { return s & 511; }
LANE_HD inline int stat_r2(uint32_t s) { return (s >> 9) & 511; }
LANE_HD inline int stat_i1(uint32_t s) { return (s >> 18) & 63; }
LANE_HD inline int stat_c3(uint32_t s) { return (s >> 24) & 63; }

// a warp's shared memory, by the call's sizes: byte offsets of each array
// and the total (16-byte aligned). The hashes live until the minimizers
// are picked; the candidate slots then take their place.
struct Smem {
  int stat, lastrep, namb, nvalid, mzpos, mzkey, nhit, dl, c8, kmw, hh,
      cand, total;
};

LANE_HD inline int up16(int n) { return (n + 15) & ~15; }

LANE_HD inline Smem smem_of(int W, int nmz_c, int smax) {
  Smem m;
  int o = 0;
  m.stat = o;    o += up16(4 * W);
  m.lastrep = o; o += up16(2 * W);
  m.namb = o;    o += up16(2 * W);
  m.nvalid = o;  o += up16(2 * W);
  m.mzpos = o;   o += up16(4 * nmz_c);
  m.mzkey = o;   o += up16(4 * nmz_c);
  m.nhit = o;    o += up16(4 * nmz_c);
  m.dl = o;      o += up16(4 * (kMaxDmax + 1));
  m.c8 = o;      o += up16(W);
  m.kmw = o;
  m.hh = o + up16(4 * W);
  m.cand = o;
  m.total = o + max_(2 * up16(4 * W), up16(4 * nmz_c * smax));
  return m;
}

// collect_seeds_kmer_plain for read b, by a warp over its shared memory sm
GROUP_FN void kmer_seed_warp(const KmerParams& p, long long b,
                             unsigned char* sm) {
  constexpr auto G = kWarp;
  const int W = static_cast<int>(p.W);
  const int NP = W - kK + 1;
  const int NW = NP - kWin + 1;
  const int M = static_cast<int>(p.M);
  const int msl = static_cast<int>(p.min_seed_len);
  const int smax = static_cast<int>(p.smax);
  const int nch = (W + G - 1) / G;   // position chunks of a warp's width
  const int32_t len = p.lens[b];
  const int32_t* row = p.codes + b * p.W;
  const int nmz_c = min_(static_cast<int>(p.nmz), NP);
  const Smem o = smem_of(W, nmz_c, smax);
  uint32_t* stat = reinterpret_cast<uint32_t*>(sm + o.stat);
  int16_t* lastrep = reinterpret_cast<int16_t*>(sm + o.lastrep);
  int16_t* namb = reinterpret_cast<int16_t*>(sm + o.namb);
  int16_t* nvalid = reinterpret_cast<int16_t*>(sm + o.nvalid);
  int32_t* mzpos = reinterpret_cast<int32_t*>(sm + o.mzpos);
  uint32_t* mzkey = reinterpret_cast<uint32_t*>(sm + o.mzkey);
  int32_t* nhit = reinterpret_cast<int32_t*>(sm + o.nhit);
  int32_t* dl = reinterpret_cast<int32_t*>(sm + o.dl);
  uint8_t* c8 = sm + o.c8;
  uint32_t* kmw = reinterpret_cast<uint32_t*>(sm + o.kmw);
  uint32_t* hh = reinterpret_cast<uint32_t*>(sm + o.hh);
  int32_t* cand = reinterpret_cast<int32_t*>(sm + o.cand);

  FOR_LANES(G, t) {
    for (int q = t; q < W; q += G) c8[q] = code8(row[q]);
  }
  group_sync<G>();

  // ---- k-mer hashes (an invalid k-mer hashes to kUMax): a lane a run of
  // consecutive starts, the k-mer rolled along it ----
  const int seg = (NP + G - 1) / G;
  FOR_LANES(G, t) {
    const int j0 = t * seg, j1 = min_(j0 + seg, NP);
    if (j0 >= j1) continue;
    uint32_t km = 0;
    int last_bad = j0 - 1;   // the last ambiguous base read so far
    for (int q = j0; q < j1 + kK - 1; ++q) {
      km = ((km << 2) | (c8[q] & 3u)) & ((1u << (2 * kK)) - 1u);
      if (c8[q] & 4) last_bad = q;
      const int j = q - kK + 1;
      if (j >= j0) {
        const bool ok = last_bad < j && j + kK <= len;
        kmw[j] = ok ? km : kUMax;
        hh[j] = ok ? mix32(km) : kUMax;
      }
    }
  }
  group_sync<G>();

  // ---- minimizers (run-length form), compacted in position order ----
  int nsel = 0;
  for (int r = 0; r * G < NP; ++r) {
    Lanes<bool, G> sel;
    FOR_LANES(G, t) {
      const int j = r * G + t;
      sel[t] = false;
      if (j >= NP) continue;
      const uint32_t hj = hh[j];
      int L = 0, R = 0;
      for (int u = 1; u < kWin && j >= u && hh[j - u] > hj; ++u) ++L;
      for (int u = 1; u < kWin && j < NP - u && hh[j + u] >= hj; ++u) ++R;
      const int s_lo = max_(max_(j - kWin + 1, 0), j - L);
      const int s_hi = min_(min_(j, NW - 1), j + R - kWin + 1);
      sel[t] = s_lo <= s_hi;
    }
    const uint32_t mask = ballot(sel);
    FOR_LANES(G, t) {
      const int idx = nsel + popc32(mask & ((1u << t) - 1u));
      if (sel[t] && idx < nmz_c) {
        mzpos[idx] = r * G + t;
        mzkey[idx] = kmw[r * G + t];
      }
    }
    nsel += popc32(mask);
  }
  const bool mz_overflow = nsel > nmz_c;
  group_sync<G>();

  // ---- table lookups: a lane a minimizer, its hits in its smax slots ----
  const int nl = min_(nsel, nmz_c);
  const int low_bits = 2 * kK - static_cast<int>(p.bb);
  const uint32_t low_mask = (1u << low_bits) - 1u;
  const long long nrows0 = (p.n_rows - 1) / 2;
  Lanes<bool, G> capped;
  FOR_LANES(G, t) {
    capped[t] = false;
    for (int i = t; i < nl; i += G) {
      int32_t* slot = cand + i * smax;
      int n_hit = 0;   // its hits: slot[0 .. n_hit)
      const uint32_t key = mzkey[i];
      const int32_t bm = key == kUMax ? 0 : p.bmeta[key >> low_bits];
      const int cnt = bm & 15;
      if (cnt > smax) capped[t] = true;   // key != kUMax: bm was loaded
      if (key != kUMax && cnt <= smax) {
        const int32_t o0 = bm >> 4;
        const int col0 = o0 & 31;
        const bool use1 = col0 > 32 - smax;
        long long r = use1 ? nrows0 + ((o0 - 16) >> 5) : (o0 >> 5);
        r = r < 0 ? 0 : (r >= p.n_rows ? p.n_rows - 1 : r);
        const int col = use1 ? col0 - 16 : col0;
        const int32_t* erow = p.entries + r * 32;
        for (int u = 0; u < cnt; ++u) {
          const int tt = col + u;
          const uint32_t ev = tt < 32 ? static_cast<uint32_t>(erow[tt]) : 0u;
          if ((ev & low_mask) == (key & low_mask))
            slot[n_hit++] = static_cast<int32_t>(ev >> low_bits) - mzpos[i];
        }
      }
      nhit[i] = n_hit;
    }
  }
  const bool capped_any = ballot(capped) != 0;
  group_sync<G>();

  // ---- the DC + 1 smallest distinct diagonals: repeated warp minima over
  // the hits, each lane over its own minimizers' (a hit is < 2^30, so
  // kBig means none) ----
  const int DC = min_(static_cast<int>(p.dmax), nmz_c * smax);
  int nd = 0;
  int32_t last = INT32_MIN;   // every diagonal is > -kMaxWidth
  while (nd <= DC) {
    Lanes<int32_t, G> m;
    FOR_LANES(G, t) {
      int32_t best = kBig;
      for (int i = t; i < nl; i += G) {
        for (int u = 0; u < nhit[i]; ++u) {
          const int32_t v = cand[i * smax + u];
          if (v > last && v < best) best = v;
        }
      }
      m[t] = best;
    }
    const int32_t mn = group_min(m);
    if (mn == kBig) break;
    dl[nd++] = mn;   // every lane the same value
    last = mn;
  }
  const bool d_overflow = nd > DC;
  const int D = min_(nd, DC);   // valid diagonals, ascending
  for (int k = D; k < DC; ++k) dl[k] = kBig;

  // ---- each valid diagonal's reach -> the top-2 statistics ----
  FOR_LANES(G, t) {
    for (int q = t; q < W; q += G) stat[q] = 0;
  }
  for (int k = 0; k < D; ++k) {
    const long long d = dl[k];
    // the mismatch flags of a lane's positions, bit r for position
    // r * G + t (past W: a mismatch), the text loads all in flight
    Lanes<uint32_t, G> mm;
    FOR_LANES(G, t) {
      uint32_t bits = 0;
#pragma unroll
      for (int r = 0; r < kMaxChunks; ++r) {
        const int q = r * G + t;
        const long long tq = d + q;
        if (r < nch &&
            !(q < W && tq >= 0 && tq < p.seq_len && c8[q] < 4 &&
              packed_code(p.text, p.n_words, tq) == c8[q]))
          bits |= 1u << r;
      }
      mm[t] = bits;
    }
    int carry = W;   // the first mismatch in the chunks after this one
    for (int r = nch - 1; r >= 0; --r) {
      Lanes<bool, G> bit;
      FOR_LANES(G, t) bit[t] = (mm[t] >> r) & 1u;
      const uint32_t mask = ballot(bit);
      FOR_LANES(G, t) {
        const int q = r * G + t;
        if (q >= W) continue;
        const uint32_t after = mask >> t;   // mismatches at or after q
        const int next = after ? q + low_bit(after) : carry;
        const uint32_t s = stat[q];
        int r1 = stat_r1(s), r2 = stat_r2(s), i1 = stat_i1(s);
        if (next > r1) {
          r2 = r1;
          r1 = next;
          i1 = k;
        } else if (next > r2) {
          r2 = next;
        }
        stat[q] = stat_word(r1, r2, i1,
                            stat_c3(s) + (next >= q + msl + 1 ? 1 : 0));
      }
      if (mask) carry = r * G + low_bit(mask);
    }
  }
  group_sync<G>();

  // ---- the round-2 certificate's last repeat position ----
  {
    int carry = -1;   // the last repeat in the chunks before this one
    for (int r = 0; r < nch; ++r) {
      Lanes<bool, G> f;
      FOR_LANES(G, t) {
        const int q = r * G + t;
        f[t] = q < W && max_(stat_r2(stat[q]), q) >= q + msl;
      }
      const uint32_t mask = ballot(f);
      FOR_LANES(G, t) {
        const int q = r * G + t;
        const uint32_t upto = mask & (0xFFFFFFFFu >> (31 - t));
        if (q < W)
          lastrep[q] = static_cast<int16_t>(upto ? r * G + high_bit(upto)
                                                 : carry);
      }
      if (mask) carry = r * G + high_bit(mask);
    }
  }
  group_sync<G>();

  // ---- round 1: SMEMs at the strict increases of E = R1 ----
  int32_t* mem_pos = p.mem_pos + b * p.M;
  int32_t* mem_s = p.mem_s + b * p.M;
  int32_t* mem_b = p.mem_b + b * p.M;
  int32_t* mem_e = p.mem_e + b * p.M;
  int n_r1 = 0;
  Lanes<bool, G> multi1, r2_lane;
  FOR_LANES(G, t) multi1[t] = r2_lane[t] = false;
  for (int r = 0; r < nch; ++r) {
    Lanes<bool, G> em;
    FOR_LANES(G, t) {
      const int q = r * G + t;
      em[t] = false;
      if (q >= W) continue;
      const int E = max_(stat_r1(stat[q]), q);
      const int Eprev = q ? max_(stat_r1(stat[q - 1]), q - 1) : -1;
      em[t] = E > Eprev && E - q >= msl;
    }
    const uint32_t mask = ballot(em);
    FOR_LANES(G, t) {
      if (!em[t]) continue;
      const int q = r * G + t;
      const uint32_t s = stat[q];
      const int E = max_(stat_r1(s), q);
      if (max_(stat_r2(s), q) >= E) multi1[t] = true;
      const int idx = n_r1 + popc32(mask & ((1u << t) - 1u));
      if (idx < M) {
        mem_b[idx] = q;
        mem_e[idx] = E;
        mem_pos[idx] = wrap_add(dl[stat_i1(s)], q);
        mem_s[idx] = 1;
        const int pivot = min_(max_((q + E) >> 1, 0), W - 1);
        const int lr = lastrep[pivot];
        if (E - q >= p.split_len && 1 <= p.split_width && lr >= 0 &&
            lr > pivot - msl)
          r2_lane[t] = true;
      }
    }
    n_r1 += popc32(mask);
  }
  const bool multi1_any = ballot(multi1) != 0;
  const bool needs_r2 = ballot(r2_lane) != 0;
  bool r1_overflow = n_r1 > M;

  // ---- round 3: the deterministic successor chase ----
  int n = n_r1;
  bool r3_multi = false, r3_stuck = false;
  if (p.max_mem_intv > 0) {
    int ca = W, cv = W;   // the next ambiguous / valid position after
    for (int r = nch - 1; r >= 0; --r) {
      Lanes<bool, G> amb, val;
      FOR_LANES(G, t) {
        const int q = r * G + t;
        const bool bad = q >= W || (c8[q] & 4) || q >= len;
        amb[t] = bad;
        val[t] = q < W && !bad;
      }
      const uint32_t ma = ballot(amb), mv = ballot(val);
      FOR_LANES(G, t) {
        const int q = r * G + t;
        if (q >= W) continue;
        const uint32_t a = ma >> t, v = mv >> t;
        namb[q] = static_cast<int16_t>(a ? q + low_bit(a) : ca);
        nvalid[q] = static_cast<int16_t>(v ? q + low_bit(v) : cv);
      }
      if (ma) ca = r * G + low_bit(ma);
      if (mv) cv = r * G + low_bit(mv);
    }
    group_sync<G>();
    const int T = W / (msl + 1) + 18;
    int cur = nvalid[0];
    bool ovf3 = false;
    for (int it = 0; it < T && cur < W; ++it) {
      const int x = cur;
      const int stop = x + msl;
      const bool clean = namb[x] > stop;
      const uint32_t s = stat[x];
      const int s_here = stat_c3(s);
      if (clean && s_here >= 1) {   // an emission
        if (s_here >= 2) r3_multi = true;
        if (n < M) {
          if (group_leader<G>()) {
            mem_pos[n] = wrap_add(dl[stat_i1(s)], x);
            mem_s[n] = s_here;
            mem_b[n] = x;
            mem_e[n] = stop + 1;
          }
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
  FOR_LANES(G, t) {
    for (int s = min_(n, M) + t; s < M; s += G)
      mem_pos[s] = mem_s[s] = mem_b[s] = mem_e[s] = 0;
  }

  const bool bits[7] = {mz_overflow, capped_any, d_overflow, multi1_any,
                        r1_overflow, r3_multi, r3_stuck};
  int32_t why = 0;
  for (int k = 0; k < 7; ++k) why |= static_cast<int32_t>(bits[k]) << k;
  if (group_leader<G>()) {
    p.n_mem[b] = n;
    p.overflow[b] = why != 0;
    p.needs_r2[b] = needs_r2 && why == 0;
    p.why[b] = why;
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(kWarp * kWarps)
    kmer_seed(const KmerParams p, const int warp_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = threadIdx.x / kWarp;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + w;
  if (b < p.B) kmer_seed_warp(p, b, smem + w * warp_bytes);
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
  const int nmz_c = static_cast<int>(min_(nmz, W - kK + 1));
  const int warp_bytes = smem_of(static_cast<int>(W), nmz_c,
                                 static_cast<int>(smax)).total;
#ifdef __CUDACC__
  const int bytes = kWarps * warp_bytes;   // <= 41.4 KB at the caps
  const unsigned grid = static_cast<unsigned>((B + kWarps - 1) / kWarps);
  kmer_seed<<<grid, kWarp * kWarps, bytes, stream>>>(p, warp_bytes);
  return static_cast<int>(cudaGetLastError());
#else
  unsigned char* sm = new unsigned char[warp_bytes];
  for (long long b = 0; b < B; ++b) kmer_seed_warp(p, b, sm);
  delete[] sm;
  return 0;
#endif
}
