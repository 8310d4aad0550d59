// Batched single-region finalize — native host kernel.
//
// The per-record tail of mem_reg2aln (bwa.cpp:158 consumes it from
// libbwa) for the dominant case of exactly one candidate region per
// read: infer the band width, run banded global alignment with the
// band-doubling retry loop, walk the CIGAR for NM/MD, squeeze
// leading/trailing deletions, and render the CIGAR text with soft
// clips. One call finalizes a whole batch (OpenMP over rows); the
// Python per-read path (cpu/oracle.py:reg2aln) stays the semantic
// oracle and tests pin bit-equality against it.
//
// Two entry points:
//  - reg2aln1_batch_c: takes dense pre-oriented qq/rr windows (the
//    original interface, kept for tests);
//  - finalize_fast2_c: additionally extracts the oriented windows from
//    the raw read codes + pac itself (what align/finalize.py's
//    fast_fields used to do in numpy — the extraction was ~half the
//    host finalize cost at 16K-read batches), and emits the final
//    rebased position. Outputs are compact over the selected rows.

#include <cstdint>
#include <cstdio>
#include <vector>

extern "C" int32_t ksw_global_c(
    int32_t qlen, const uint8_t* query, int32_t tlen, const uint8_t* target,
    const int8_t* mat, int32_t o_del, int32_t e_del, int32_t o_ins,
    int32_t e_ins, int32_t w, uint32_t* cigar_out, int32_t cigar_cap,
    int32_t* n_cigar);

namespace {

constexpr int32_t NEG_INF = -0x40000000;

// cpu/oracle.py:infer_bw — (int) matches Python int() (trunc toward 0).
int32_t infer_bw_c(int32_t l1, int32_t l2, int32_t score, int32_t a,
                   int32_t q, int32_t r) {
    if (l1 == l2 && l1 * a - score < ((q + r - a) << 1)) return 0;
    int32_t mn = l1 < l2 ? l1 : l2;
    int32_t w = (int32_t)((double)(mn * a - score - q) / r + 2.0);
    int32_t d = l1 > l2 ? l1 - l2 : l2 - l1;
    return w > d ? w : d;
}

char* put_u32(char* p, uint32_t v) {
    char tmp[12];
    int n = 0;
    do { tmp[n++] = '0' + (char)(v % 10); v /= 10; } while (v);
    while (n) *p++ = tmp[--n];
    return p;
}

const char MD_BASE[5] = {'A', 'C', 'G', 'T', 'N'};
const char OP_CHR[3] = {'M', 'I', 'D'};

struct RowOut {
    int32_t cig_len, md_len, nm, lead_d, ref_consumed, status;
};

// The whole reg2aln alignment tail for one oriented (q, t) window pair.
// Writes CIGAR text then MD text at `base` (text_stride bytes available;
// MD is staged in the upper half, then packed down). Returns status 0 on
// success, 1 on any buffer overflow / failed alignment.
RowOut reg2aln1_row(
    const uint8_t* q, const uint8_t* t, int32_t lq, int32_t lt,
    int32_t truesc, int32_t w_reg, int32_t clip5, int32_t clip3,
    const int8_t* mat, int32_t o_del, int32_t e_del, int32_t o_ins,
    int32_t e_ins, int32_t a, int32_t bw, std::vector<uint32_t>& cig,
    char* base, int64_t text_stride) {
    RowOut out{0, 0, 0, 0, 0, 1};
    if (lq <= 0) return out;
    if ((size_t)(lq + lt + 2) > cig.size()) cig.resize(lq + lt + 2);

    // --- band inference + retry loop (reg2aln) ---
    int32_t w2a = infer_bw_c(lq, lt, truesc, a, o_del, e_del);
    int32_t w2b = infer_bw_c(lq, lt, truesc, a, o_ins, e_ins);
    int32_t w2 = w2a > w2b ? w2a : w2b;
    if (w2 > bw) w2 = w2 < w_reg ? w2 : w_reg;
    int32_t last_sc = -(1 << 30), it = 0, score = 0, ncig = 0;
    for (;;) {
        w2 = w2 < (bw << 2) ? w2 : (bw << 2);
        if (lq == lt && w2 == 0) {
            score = 0;
            for (int32_t j = 0; j < lq; ++j)
                score += mat[(size_t)t[j] * 5 + q[j]];
            cig[0] = (uint32_t)lq << 4 | 0;
            ncig = 1;
        } else {
            score = ksw_global_c(lq, q, lt, t, mat, o_del, e_del,
                                 o_ins, e_ins, w2, cig.data(),
                                 (int32_t)cig.size(), &ncig);
            if (score == NEG_INF) return out;
        }
        if (score == last_sc || w2 == (bw << 2)) break;
        last_sc = score;
        w2 <<= 1;
        ++it;
        if (!(it < 3 && score < truesc - a)) break;
    }

    // --- NM/MD walk over the full cigar (cigar_nm_md) ---
    // Layout: the CIGAR text length isn't known yet, so MD is built in
    // the buffer's tail half and packed down after the cigar afterward
    // (forward copy, dst < src, overlap-safe).
    char* md_begin = base + (text_stride >> 1);
    char* mp = md_begin;
    char* md_cap = base + text_stride;
    int32_t nm = 0, qi = 0, ti = 0, match_run = 0;
    bool ovf = false;
    for (int32_t c = 0; c < ncig && !ovf; ++c) {
        int32_t n = (int32_t)(cig[c] >> 4);
        int32_t op = (int32_t)(cig[c] & 0xF);
        if (op == 0) {  // M
            for (int32_t j = 0; j < n; ++j) {
                uint8_t qc = q[qi + j], tc = t[ti + j];
                if (qc != tc || qc > 3) {
                    if (mp + 14 > md_cap) { ovf = true; break; }
                    mp = put_u32(mp, (uint32_t)match_run);
                    *mp++ = MD_BASE[tc < 4 ? tc : 4];
                    match_run = 0;
                    ++nm;
                } else {
                    ++match_run;
                }
            }
            qi += n;
            ti += n;
        } else if (op == 1) {  // I
            qi += n;
            nm += n;
        } else {  // D
            if (mp + 14 + n > md_cap) { ovf = true; break; }
            mp = put_u32(mp, (uint32_t)match_run);
            match_run = 0;
            *mp++ = '^';
            for (int32_t j = 0; j < n; ++j) {
                uint8_t tc = t[ti + j];
                *mp++ = MD_BASE[tc < 4 ? tc : 4];
            }
            ti += n;
            nm += n;
        }
    }
    if (ovf || mp + 12 > md_cap) return out;
    mp = put_u32(mp, (uint32_t)match_run);
    const int32_t mlen = (int32_t)(mp - md_begin);

    // --- squeeze leading/trailing deletions (reg2aln) ---
    int32_t c0 = 0, c1 = ncig;
    int32_t ld = 0;
    if (c1 > c0 && (cig[c0] & 0xF) == 2) {
        ld = (int32_t)(cig[c0] >> 4);
        ++c0;
    }
    if (c1 > c0 && (cig[c1 - 1] & 0xF) == 2) --c1;
    int32_t rcons = 0;
    for (int32_t c = c0; c < c1; ++c) {
        int32_t op = (int32_t)(cig[c] & 0xF);
        if (op == 0 || op == 2) rcons += (int32_t)(cig[c] >> 4);
    }

    // --- CIGAR text with soft clips ---
    char* cp = base;
    char* cig_cap_p = md_begin;  // cigar text must stay below MD
    if (clip5) {
        if (cp + 13 > cig_cap_p) return out;
        cp = put_u32(cp, (uint32_t)clip5);
        *cp++ = 'S';
    }
    for (int32_t c = c0; c < c1; ++c) {
        if (cp + 13 > cig_cap_p) return out;
        cp = put_u32(cp, cig[c] >> 4);
        *cp++ = OP_CHR[cig[c] & 0xF];
    }
    if (clip3) {
        if (cp + 13 > cig_cap_p) return out;
        cp = put_u32(cp, (uint32_t)clip3);
        *cp++ = 'S';
    }

    // --- pack MD right after the cigar text ---
    const int32_t clen = (int32_t)(cp - base);
    for (int32_t j = 0; j < mlen; ++j) base[clen + j] = md_begin[j];

    out.cig_len = clen;
    out.md_len = mlen;
    out.nm = nm;
    out.lead_d = ld;
    out.ref_consumed = rcons;
    out.status = 0;
    return out;
}

}  // namespace

extern "C" {

// Per row: runs reg2aln's alignment tail and writes
//   text[row*text_stride .. ]          = CIGAR text (cig_len bytes)
//   text[row*text_stride + cig_len ..] = MD text (md_len bytes)
// status: 0 ok; 1 = buffer overflow (caller falls back to the
// per-read path for that row).
void reg2aln1_batch_c(
    int32_t n_rows,
    const uint8_t* qq, int64_t q_stride,
    const uint8_t* rr, int64_t r_stride,
    const int32_t* Lq, const int32_t* Lt,
    const int32_t* truesc, const int32_t* w_reg,
    const int32_t* clip5, const int32_t* clip3,
    const int8_t* mat /* 5x5 */, int32_t o_del, int32_t e_del,
    int32_t o_ins, int32_t e_ins, int32_t a /* match */, int32_t bw,
    char* text, int64_t text_stride,
    int32_t* cig_len, int32_t* md_len, int32_t* nm_out,
    int32_t* lead_d, int32_t* ref_consumed, int32_t* status) {
#pragma omp parallel
    {
        std::vector<uint32_t> cig;
#pragma omp for schedule(dynamic, 64)
        for (int32_t row = 0; row < n_rows; ++row) {
            RowOut o = reg2aln1_row(
                qq + (int64_t)row * q_stride, rr + (int64_t)row * r_stride,
                Lq[row], Lt[row], truesc[row], w_reg[row], clip5[row],
                clip3[row], mat, o_del, e_del, o_ins, e_ins, a, bw, cig,
                text + (int64_t)row * text_stride, text_stride);
            cig_len[row] = o.cig_len;
            md_len[row] = o.md_len;
            nm_out[row] = o.nm;
            lead_d[row] = o.lead_d;
            ref_consumed[row] = o.ref_consumed;
            status[row] = o.status;
        }
    }
}

// Fused single-region finalize over selected batch rows: extracts the
// oriented query/target windows from the packed read codes and the
// forward pac (exactly as align/finalize.py:fast_fields oriented them:
// reverse-strand regions read the query reversed — NOT complemented —
// and the pac complemented), computes the soft-clip lengths, runs the
// reg2aln tail, and emits the doubled-text position after the
// leading-deletion squeeze. All outputs are compact over `sel` order.
void finalize_fast2_c(
    int32_t n_sel, const int32_t* sel,
    const uint8_t* codes, int64_t codes_stride, const int32_t* lens,
    const uint8_t* pac, int64_t l_pac, int64_t n_len /* doubled seq_len */,
    const int64_t* qb, const int64_t* qe,
    const int64_t* rb, const int64_t* re,
    const int32_t* truesc, const int32_t* w_reg,
    const int8_t* mat /* 5x5 */, int32_t o_del, int32_t e_del,
    int32_t o_ins, int32_t e_ins, int32_t a /* match */, int32_t bw,
    char* text, int64_t text_stride,
    int32_t* cig_len, int32_t* md_len, int32_t* nm_out,
    int32_t* lead_d, int32_t* ref_consumed,
    int64_t* pos_out, int32_t* clip5_out, int32_t* clip3_out,
    int32_t* status) {
#pragma omp parallel
    {
        std::vector<uint32_t> cig;
        std::vector<uint8_t> qbuf, tbuf;
#pragma omp for schedule(dynamic, 64)
        for (int32_t k = 0; k < n_sel; ++k) {
            const int32_t row = sel[k];
            const int64_t b_q = qb[row], e_q = qe[row];
            const int64_t b_r = rb[row], e_r = re[row];
            const int32_t lq = (int32_t)(e_q - b_q);
            const int32_t lt = (int32_t)(e_r - b_r);
            const bool rev = b_r >= l_pac;
            if ((size_t)lq > qbuf.size()) qbuf.resize(lq);
            if ((size_t)lt > tbuf.size()) tbuf.resize(lt);

            const uint8_t* q = codes + (int64_t)row * codes_stride;
            // clamp like fast_fields' np.clip(qpos, 0, W-1): defensive
            // against malformed device coordinates
            const int64_t qmax = codes_stride - 1;
            if (rev) {
                for (int32_t j = 0; j < lq; ++j) {
                    int64_t p = e_q - 1 - j;
                    qbuf[j] = q[p < 0 ? 0 : (p > qmax ? qmax : p)];
                }
            } else {
                for (int32_t j = 0; j < lq; ++j) {
                    int64_t p = b_q + j;
                    qbuf[j] = q[p < 0 ? 0 : (p > qmax ? qmax : p)];
                }
            }
            // target window on the forward strand; reverse regions read
            // [n - re, n - rb) complemented (fast_fields' rstart/rr)
            const int64_t rstart = rev ? n_len - e_r : b_r;
            for (int32_t j = 0; j < lt; ++j) {
                int64_t p = rstart + j;
                if (p < 0) p = 0;
                if (p >= l_pac) p = l_pac - 1;
                uint8_t v = pac[p];
                tbuf[j] = rev ? (uint8_t)(3 - v) : v;
            }
            const int32_t L = lens[row];
            const int32_t c5 = (int32_t)(rev ? (int64_t)L - e_q : b_q);
            const int32_t c3 = (int32_t)(rev ? b_q : (int64_t)L - e_q);

            RowOut o = reg2aln1_row(
                qbuf.data(), tbuf.data(), lq, lt, truesc[row], w_reg[row],
                c5, c3, mat, o_del, e_del, o_ins, e_ins, a, bw, cig,
                text + (int64_t)k * text_stride, text_stride);
            cig_len[k] = o.cig_len;
            md_len[k] = o.md_len;
            nm_out[k] = o.nm;
            lead_d[k] = o.lead_d;
            ref_consumed[k] = o.ref_consumed;
            pos_out[k] = (rev ? n_len - e_r : b_r) + o.lead_d;
            clip5_out[k] = c5;
            clip3_out[k] = c3;
            status[k] = o.status;
        }
    }
}

}  // extern "C"
