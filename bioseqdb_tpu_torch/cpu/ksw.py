"""Scalar affine-gap DP kernels — clean-room ksw_extend2 / ksw_global2.

The reference delegates these to libbwa's ksw.c (consumed through
mem_align1 / mem_reg2aln at bwa.cpp:149,158). These are clean-room
reimplementations of the *published semantics* of those routines —
banded extension with Z-drop and end-bonus bookkeeping, and banded
global alignment with a direction matrix for CIGAR traceback — written
as the host oracle the device kernels are validated against. Tie-break
order in both kernels follows the documented cell-update order
(M >= E, H >= F, E > t, F > t) because CIGAR identity depends on it.

Conventions: ``i`` walks the target (reference) and ``j`` the query;
a vertical move consumes target only (CIGAR D, o_del/e_del), a
horizontal move consumes query only (CIGAR I, o_ins/e_ins).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NEG_INF = -0x40000000


def fill_scmat(a: int, b: int) -> np.ndarray:
    """5x5 scoring matrix (bwa_fill_scmat): match a, mismatch -b,
    anything involving an ambiguous base -1."""
    mat = np.full((5, 5), -1, dtype=np.int32)
    for i in range(4):
        for j in range(4):
            mat[i, j] = a if i == j else -b
    return mat


@dataclass
class ExtendResult:
    score: int     # best extension score (from h0)
    qle: int       # query length of the best local extension
    tle: int       # target length of the best local extension
    gtle: int      # target length of the best to-query-end extension
    gscore: int    # best score among alignments reaching the query end
    max_off: int   # max diagonal offset observed at score updates


def ksw_extend(
    query: np.ndarray,
    target: np.ndarray,
    mat: np.ndarray,
    o_del: int,
    e_del: int,
    o_ins: int,
    e_ins: int,
    w: int,
    end_bonus: int,
    zdrop: int,
    h0: int,
) -> ExtendResult:
    """Banded affine-gap extension (ksw_extend2 semantics).

    Extends an alignment seeded with score ``h0`` at (0, 0) into
    query[0:] x target[0:]; alignments must start at the origin.
    """
    qlen, tlen = len(query), len(target)
    if qlen == 0 or tlen == 0:
        return ExtendResult(h0, 0, 0, 0, -1, 0)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins

    # query profile
    qp = mat[:, query]  # (5, qlen): qp[t, j] = mat[t, query[j]]

    # adjust w if too large
    max_sc = int(mat.max())
    max_ins = int((qlen * max_sc + end_bonus - o_ins) / e_ins + 1.0)
    w = min(w, max(max_ins, 1))
    max_del = int((qlen * max_sc + end_bonus - o_del) / e_del + 1.0)
    w = min(w, max(max_del, 1))

    # DP arrays: h[j] = H(i-1, j-1) rolling, e[j] = E(i, j)
    h = np.zeros(qlen + 2, dtype=np.int64)
    e = np.zeros(qlen + 2, dtype=np.int64)
    h[0] = h0
    h[1] = h0 - oe_ins if h0 > oe_ins else 0
    j = 2
    while j <= qlen and h[j - 1] > e_ins:
        h[j] = h[j - 1] - e_ins
        j += 1

    max_score, max_i, max_j = h0, -1, -1
    max_ie, gscore = -1, -1
    max_off = 0
    beg, end = 0, qlen

    for i in range(tlen):
        f = 0
        m_best = 0
        mj = -1
        q = qp[target[i]]
        beg = max(beg, i - w)
        end = min(end, i + w + 1, qlen)
        if beg == 0:
            h1 = h0 - (o_del + e_del * (i + 1))
            if h1 < 0:
                h1 = 0
        else:
            h1 = 0
        for j in range(beg, end):
            # invariant: h[j] = H(i-1, j-1), e[j] = E(i, j), f = F(i, j),
            # h1 = H(i, j-1)
            M = int(h[j])
            ecur = int(e[j])
            h[j] = h1  # store H(i, j-1) for the next row
            M = M + int(q[j]) if M else 0
            hh = M if M >= ecur else ecur
            hh = hh if hh >= f else f
            h1 = hh
            if hh > m_best:
                m_best, mj = hh, j
            t = M - oe_del
            t = t if t > 0 else 0
            ecur -= e_del
            ecur = ecur if ecur > t else t
            e[j] = ecur
            t = M - oe_ins
            t = t if t > 0 else 0
            f -= e_ins
            f = f if f > t else t
        h[end] = h1
        e[end] = 0
        if end == qlen:  # reached the query end: track to-end score
            # ties update max_ie (the later row wins), matching the
            # reference kernel's `gscore > h1 ? keep : update`
            if gscore <= h1:
                max_ie, gscore = i, h1
        if m_best == 0:
            break
        if m_best > max_score:
            max_score, max_i, max_j = m_best, i, mj
            max_off = max(max_off, abs(mj - i))
        elif zdrop > 0:
            if i - max_i > mj - max_j:
                if max_score - m_best - ((i - max_i) - (mj - max_j)) * e_del > zdrop:
                    break
            else:
                if max_score - m_best - ((mj - max_j) - (i - max_i)) * e_ins > zdrop:
                    break
        # shrink the band to live cells
        j = beg
        while j < end and h[j] == 0 and e[j] == 0:
            j += 1
        beg = j
        j = end
        while j >= beg and h[j] == 0 and e[j] == 0:
            j -= 1
        end = min(j + 2, qlen)

    return ExtendResult(
        score=int(max_score),
        qle=max_j + 1,
        tle=max_i + 1,
        gtle=max_ie + 1,
        gscore=int(gscore),
        max_off=int(max_off),
    )


def ksw_global(
    query: np.ndarray,
    target: np.ndarray,
    mat: np.ndarray,
    o_del: int,
    e_del: int,
    o_ins: int,
    e_ins: int,
    w: int,
) -> tuple[int, list[tuple[int, str]]]:
    """Banded global affine alignment with CIGAR (ksw_global2 semantics).

    Dispatches to the native C++ twin (index/native/ksw.cpp) on the
    finalize hot path; ``ksw_global_py`` below is the semantic reference
    the native kernel is pinned against.
    """
    try:
        from bioseqdb_tpu_torch.index.native.build import ksw_global_native

        return ksw_global_native(query, target, mat, o_del, e_del, o_ins,
                                 e_ins, w)
    except (OSError, ImportError):  # no toolchain: fall back to Python
        return ksw_global_py(query, target, mat, o_del, e_del, o_ins, e_ins, w)


def ksw_global_py(
    query: np.ndarray,
    target: np.ndarray,
    mat: np.ndarray,
    o_del: int,
    e_del: int,
    o_ins: int,
    e_ins: int,
    w: int,
) -> tuple[int, list[tuple[int, str]]]:
    """Pure-Python reference implementation of ``ksw_global``."""
    qlen, tlen = len(query), len(target)
    if qlen == 0:
        return (-(o_del + e_del * tlen) if tlen else 0), (
            [(tlen, "D")] if tlen else []
        )
    if tlen == 0:
        return -(o_ins + e_ins * qlen), [(qlen, "I")]
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    w = max(w, abs(tlen - qlen))
    n_col = min(qlen, 2 * w + 1)

    qp = mat[:, query]
    h = np.full(qlen + 1, NEG_INF, dtype=np.int64)
    e = np.full(qlen + 1, NEG_INF, dtype=np.int64)
    h[0] = 0
    for j in range(1, min(qlen, w) + 1):
        h[j] = -(o_ins + e_ins * j)
    z = np.zeros((tlen, n_col), dtype=np.uint8)

    for i in range(tlen):
        f = NEG_INF
        beg = max(0, i - w)
        end = min(qlen - 1, i + w)  # inclusive
        h1 = -(o_del + e_del * (i + 1)) if beg == 0 else NEG_INF
        q = qp[target[i]]
        for j in range(beg, end + 1):
            # h[j] = H(i-1, j-1), e[j] = E(i, j), f = F(i, j), h1 = H(i, j-1)
            M = int(h[j])
            ecur = int(e[j])
            h[j] = h1
            M += int(q[j])
            d = 0 if M >= ecur else 1
            hh = M if M >= ecur else ecur
            d = d if hh >= f else 2
            hh = hh if hh >= f else f
            h1 = hh
            t = M - oe_del
            ecur -= e_del
            d |= 1 << 2 if ecur > t else 0
            ecur = ecur if ecur > t else t
            e[j] = ecur
            t = M - oe_ins
            f -= e_ins
            d |= 2 << 4 if f > t else 0
            f = f if f > t else t
            z[i, j - beg] = d
        h[end + 1] = h1
        e[end + 1] = NEG_INF

    score = int(h1)
    # traceback
    ops: list[str] = []
    which = 0
    i, k = tlen - 1, qlen - 1
    while i >= 0 and k >= 0:
        beg = max(0, i - w)
        tmp = int(z[i, k - beg])
        which = (tmp >> (which << 1)) & 3
        if which == 0:
            ops.append("M")
            i -= 1
            k -= 1
        elif which == 1:
            ops.append("D")
            i -= 1
        else:
            ops.append("I")
            k -= 1
    while i >= 0:
        ops.append("D")
        i -= 1
    while k >= 0:
        ops.append("I")
        k -= 1
    ops.reverse()
    cigar: list[tuple[int, str]] = []
    for op in ops:
        if cigar and cigar[-1][1] == op:
            cigar[-1] = (cigar[-1][0] + 1, op)
        else:
            cigar.append((1, op))
    return score, cigar


def cigar_to_string(cigar: list[tuple[int, str]]) -> str:
    return "".join(f"{n}{op}" for n, op in cigar)


def cigar_nm_md(
    cigar: list[tuple[int, str]],
    query: np.ndarray,
    target: np.ndarray,
) -> tuple[int, str]:
    """NM (edit distance) and MD tag for an alignment (bwa_gen_cigar2's
    NM/MD walk): mismatches counted over M runs, indel lengths added.
    M runs are vectorized (this sits on the per-read hot path)."""
    nm = 0
    md: list[str] = []
    qi = ti = 0
    match_run = 0
    base = "ACGTN"
    for n, op in cigar:
        if op == "M":
            qs = np.asarray(query[qi : qi + n])
            ts = np.asarray(target[ti : ti + n])
            mism = np.flatnonzero((qs != ts) | (qs > 3))
            prev = -1
            for j in mism:
                md.append(str(match_run + int(j) - prev - 1))
                md.append(base[min(int(ts[j]), 4)])
                match_run = 0
                prev = int(j)
            match_run += n - 1 - prev
            nm += len(mism)
            qi += n
            ti += n
        elif op == "I":
            qi += n
            nm += n
        elif op == "D":
            md.append(str(match_run))
            match_run = 0
            md.append(
                "^" + "".join(base[min(int(c), 4)] for c in target[ti : ti + n])
            )
            ti += n
            nm += n
    md.append(str(match_run))
    return nm, "".join(md)
