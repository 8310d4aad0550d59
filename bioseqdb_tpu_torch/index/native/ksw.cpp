// Banded global affine-gap alignment with CIGAR — native host kernel.
//
// C++ twin of cpu/ksw.py:ksw_global (the clean-room ksw_global2
// equivalent; role of libbwa's ksw.c consumed via mem_reg2aln at
// bwa.cpp:158). Python is the semantic reference and stays the test
// oracle; this native version runs the per-read CIGAR generation on the
// host finalize hot path (~1000x the Python speed). Must match the
// Python kernel bit-for-bit including tie-breaks (tests pin them).
//
// Compiled into libsais_tpu.so alongside the SA-IS builder.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {
constexpr int32_t NEG_INF = -0x40000000;
}

extern "C" {

// Returns the alignment score; writes up to *n_cigar ops as len<<4|op
// (op: 0=M, 1=I, 2=D) into cigar_out. Returns NEG_INF on cap overflow.
int32_t ksw_global_c(
    int32_t qlen, const uint8_t* query, int32_t tlen, const uint8_t* target,
    const int8_t* mat /* 5x5 row-major */, int32_t o_del, int32_t e_del,
    int32_t o_ins, int32_t e_ins, int32_t w, uint32_t* cigar_out,
    int32_t cigar_cap, int32_t* n_cigar) {
    *n_cigar = 0;
    if (qlen == 0) {
        if (tlen > 0) {
            if (cigar_cap < 1) return NEG_INF;
            cigar_out[0] = (uint32_t)tlen << 4 | 2;
            *n_cigar = 1;
            return -(o_del + e_del * tlen);
        }
        return 0;
    }
    if (tlen == 0) {
        if (cigar_cap < 1) return NEG_INF;
        cigar_out[0] = (uint32_t)qlen << 4 | 1;
        *n_cigar = 1;
        return -(o_ins + e_ins * qlen);
    }
    const int32_t oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
    int32_t diff = tlen > qlen ? tlen - qlen : qlen - tlen;
    if (w < diff) w = diff;
    const int64_t n_col = (int64_t)qlen < 2LL * w + 1 ? qlen : 2LL * w + 1;

    std::vector<int32_t> h(qlen + 2), e(qlen + 2);
    std::vector<uint8_t> z((size_t)tlen * n_col);
    for (int32_t j = 0; j <= qlen + 1; ++j) h[j] = e[j] = NEG_INF;
    h[0] = 0;
    int32_t wcap = qlen < w ? qlen : w;
    for (int32_t j = 1; j <= wcap; ++j) h[j] = -(o_ins + e_ins * j);

    int32_t h1 = NEG_INF;
    for (int32_t i = 0; i < tlen; ++i) {
        int32_t f = NEG_INF;
        int32_t beg = i - w > 0 ? i - w : 0;
        int32_t end = i + w < qlen - 1 ? i + w : qlen - 1;  // inclusive
        h1 = beg == 0 ? -(o_del + e_del * (i + 1)) : NEG_INF;
        const int8_t* q = &mat[(size_t)target[i] * 5];
        uint8_t* zi = &z[(size_t)i * n_col];
        for (int32_t j = beg; j <= end; ++j) {
            int32_t M = h[j], ecur = e[j];
            uint8_t d;
            h[j] = h1;
            M += q[query[j]];
            d = M >= ecur ? 0 : 1;
            int32_t hh = M >= ecur ? M : ecur;
            d = hh >= f ? d : 2;
            hh = hh >= f ? hh : f;
            h1 = hh;
            int32_t t = M - oe_del;
            ecur -= e_del;
            d |= ecur > t ? 1 << 2 : 0;
            ecur = ecur > t ? ecur : t;
            e[j] = ecur;
            t = M - oe_ins;
            f -= e_ins;
            d |= f > t ? 2 << 4 : 0;
            f = f > t ? f : t;
            zi[j - beg] = d;
        }
        h[end + 1] = h1;
        e[end + 1] = NEG_INF;
    }
    const int32_t score = h1;

    // traceback (matches the Python kernel's state machine)
    std::vector<uint8_t> ops;
    ops.reserve(qlen + tlen);
    int which = 0;
    int32_t i = tlen - 1, k = qlen - 1;
    while (i >= 0 && k >= 0) {
        int32_t beg = i - w > 0 ? i - w : 0;
        uint8_t tmp = z[(size_t)i * n_col + (k - beg)];
        which = tmp >> (which << 1) & 3;
        if (which == 0) {
            ops.push_back(0);
            --i;
            --k;
        } else if (which == 1) {
            ops.push_back(2);
            --i;
        } else {
            ops.push_back(1);
            --k;
        }
    }
    while (i >= 0) ops.push_back(2), --i;
    while (k >= 0) ops.push_back(1), --k;

    // run-length encode in forward order
    int32_t n = 0;
    for (int64_t p = (int64_t)ops.size() - 1; p >= 0;) {
        uint8_t op = ops[p];
        int32_t run = 0;
        while (p >= 0 && ops[p] == op) ++run, --p;
        if (n >= cigar_cap) return NEG_INF;
        cigar_out[n++] = (uint32_t)run << 4 | op;
    }
    *n_cigar = n;
    return score;
}

}  // extern "C"

extern "C" {

// Local affine-gap Smith-Waterman (ksw_align2 role, used by mate rescue):
// returns the best local score; writes query/target begin/end (end
// inclusive) of the best local alignment and an approximate second-best
// score among cells whose target end lies at least qlen/2 away from the
// best end (the KSW_XSUBO sub-optimal used for csub).
int32_t ksw_local_c(
    int32_t qlen, const uint8_t* query, int32_t tlen, const uint8_t* target,
    const int8_t* mat, int32_t o_del, int32_t e_del, int32_t o_ins,
    int32_t e_ins, int32_t* qb, int32_t* qe, int32_t* tb, int32_t* te,
    int32_t* score2) {
    *qb = *qe = *tb = *te = -1;
    *score2 = 0;
    if (qlen <= 0 || tlen <= 0) return 0;
    const int32_t oe_del = o_del + e_del, oe_ins = o_ins + e_ins;

    auto forward = [&](const uint8_t* q, const uint8_t* t, int32_t ql,
                       int32_t tl, int32_t* bi, int32_t* bj,
                       int32_t* sub, int32_t sub_gap) -> int32_t {
        std::vector<int32_t> h(ql + 1, 0), e(ql + 1, 0);
        int32_t best = 0;
        std::vector<int32_t> row_best(tl, 0);
        *bi = *bj = -1;
        for (int32_t i = 0; i < tl; ++i) {
            int32_t f = 0, h_diag = 0;  // H(i-1, j-1), starts at column 0
            const int8_t* qp = &mat[(size_t)t[i] * 5];
            int32_t rb = 0;
            for (int32_t j = 0; j < ql; ++j) {
                int32_t M = h_diag > 0 ? h_diag + qp[q[j]] : qp[q[j]];
                if (M < 0) M = 0;
                h_diag = h[j + 1];
                int32_t ecur = e[j + 1];
                int32_t hh = M > ecur ? M : ecur;
                hh = hh > f ? hh : f;
                h[j + 1] = hh;
                if (hh > rb) rb = hh;
                if (hh > best) best = hh, *bi = i, *bj = j;
                int32_t tt = M - oe_del;
                ecur -= e_del;
                e[j + 1] = ecur > tt ? ecur : (tt > 0 ? tt : 0);
                tt = M - oe_ins;
                f -= e_ins;
                f = f > tt ? f : (tt > 0 ? tt : 0);
            }
            row_best[i] = rb;
        }
        if (sub) {
            int32_t s2 = 0;
            for (int32_t i = 0; i < tl; ++i)
                if (*bi < 0 || (i < *bi - sub_gap || i > *bi + sub_gap))
                    s2 = row_best[i] > s2 ? row_best[i] : s2;
            *sub = s2;
        }
        return best;
    };

    int32_t bi, bj, sub;
    int32_t score = forward(query, target, qlen, tlen, &bi, &bj, &sub,
                            qlen / 2 > 1 ? qlen / 2 : 1);
    if (score <= 0) return 0;
    *qe = bj;
    *te = bi;
    *score2 = sub;
    // find the start with a reverse pass over the consumed prefixes
    std::vector<uint8_t> qr(bj + 1), tr(bi + 1);
    for (int32_t j = 0; j <= bj; ++j) qr[j] = query[bj - j];
    for (int32_t i = 0; i <= bi; ++i) tr[i] = target[bi - i];
    int32_t bi2, bj2;
    forward(qr.data(), tr.data(), bj + 1, bi + 1, &bi2, &bj2, nullptr, 0);
    *qb = bj - bj2;
    *tb = bi - bi2;
    return score;
}

}  // extern "C"
