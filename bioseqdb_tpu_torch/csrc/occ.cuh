// The FM index's Occ counting, shared by the kernels that read the Occ
// table (fm.cu, fm_seed.cu): the block row of a stored BWT position, the
// count of a code in a row's first bases, and occ(c, r) for a conceptual
// prefix rank, as bioseqdb_tpu_torch/kernels/fm.py computes them.
//
// The table (FMDevice.occ_rows) is int32 [n_octo * 8, 12]: a row covers
// 128 stored bases, its first four ints the checkpoint counts of the four
// codes, the other eight the bases packed 16 a word, the first in the top
// bits. occ_majors [n_major, 4] holds the major checkpoints, one a 2^15
// blocks, in the rank type R. Table rows are clamped where XLA's gathers
// clamp them (kernels/fm.py _block_row, _occ_major_rows). What loads a
// table (__ldg) or counts bits (popc32) is device code on the card
// (GROUP_FN), host code in a host build.

#pragma once

#include "lanes.cuh"

constexpr int kLog2OccBlock = 7;   // 128 bases an Occ block (fmindex.OCC_BLOCK)
constexpr int kLog2Major = 15;     // blocks a major checkpoint (fmindex.MAJOR_BLOCKS)

template <typename T>
LANE_HD inline T clampv(T v, T lo, T hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// _MASK_TABLE[v]: the first v bases (2 bits each, big-endian) of a word
LANE_HD inline uint32_t first_bases(int v) {
  return v == 0 ? 0u : (0x55555555u << (2 * (16 - v)));
}

// the Occ table row of block blk (kernels/fm.py _block_row): octo row
// blk >> 3 clamped, sub-block blk & 7
template <typename R>
LANE_HD inline long long occ_row_index(R blk, long long n_octo) {
  const long long octo =
      clampv<long long>(static_cast<long long>(blk >> 3), 0, n_octo - 1);
  return octo * 8 + static_cast<long long>(blk & 7);
}

// the major checkpoint row of block blk, clamped
template <typename R>
LANE_HD inline long long major_index(R blk, long long n_major) {
  return clampv<long long>(static_cast<long long>(blk >> kLog2Major), 0,
                           n_major - 1);
}

// an Occ row's eight packed words, loaded as two 16-byte vectors
struct OccWords {
  uint32_t w[8];
};

GROUP_FN inline OccWords load_words(const int32_t* row) {
  const int4 wa = __ldg(reinterpret_cast<const int4*>(row) + 1);
  const int4 wb = __ldg(reinterpret_cast<const int4*>(row) + 2);
  return OccWords{{static_cast<uint32_t>(wa.x), static_cast<uint32_t>(wa.y),
                   static_cast<uint32_t>(wa.z), static_cast<uint32_t>(wa.w),
                   static_cast<uint32_t>(wb.x), static_cast<uint32_t>(wb.y),
                   static_cast<uint32_t>(wb.z), static_cast<uint32_t>(wb.w)}};
}

// the count of code c in a row's first off bases (kernels/fm.py
// _row_counts), off in [0, 127]
GROUP_FN inline int count_code(const OccWords& ws, int c, int off) {
  const uint32_t pat = static_cast<uint32_t>(c) * 0x55555555u;
  int cnt = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const uint32_t x = ws.w[w] ^ pat;
    const uint32_t y = ~(x | (x >> 1)) & 0x55555555u;
    cnt += popc32(y & first_bases(clampv(off - 16 * w, 0, 16)));
  }
  return cnt;
}

// what occ(c, r) reads for a conceptual-prefix rank r: the checkpoint of
// c in the Occ block row of the stored position jr = r - (r > primary),
// the row's words, the major checkpoint of c, and off = jr & 127, the
// row's bases before jr. Every load is issued here, so a caller that
// fetches several ranks before it counts has their loads in flight
// together.
template <typename R>
struct OccFetch {
  int ck;
  OccWords ws;
  R mj;
  int off;
};

template <typename R>
GROUP_FN inline OccFetch<R> occ_fetch(const int32_t* occ_rows,
                                      long long n_octo, const R* majors,
                                      long long n_major, R r, R primary,
                                      int c) {
  const R jr = r - static_cast<R>(r > primary);
  const R blk = jr >> kLog2OccBlock;
  const int32_t* src = occ_rows + occ_row_index(blk, n_octo) * 12;
  return OccFetch<R>{__ldg(src + c), load_words(src),
                     __ldg(majors + major_index(blk, n_major) * 4 + c),
                     static_cast<int>(jr & 127)};
}

// occ(c, r) from its fetch: the checkpoint, the c bases in the row's first
// off bases, and the major checkpoint (kernels/fm.py occ_stored)
template <typename R>
GROUP_FN inline R occ_value(const OccFetch<R>& f, int c) {
  return static_cast<R>(f.ck + count_code(f.ws, c, f.off)) + f.mj;
}

// occ(c, r): the count of code c before conceptual-prefix rank r
// (kernels/fm.py occB, or occ_rows_for + occ4_from_row for one code)
template <typename R>
GROUP_FN inline R occ_code(const int32_t* occ_rows, long long n_octo,
                          const R* majors, long long n_major, R r, R primary,
                          int c) {
  return occ_value(
      occ_fetch<R>(occ_rows, n_octo, majors, n_major, r, primary, c), c);
}
