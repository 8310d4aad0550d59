"""Clean-room CPU BWA-MEM oracle.

The reference's entire alignment capability is two libbwa calls:
``mem_align1`` and ``mem_reg2aln`` (bwa.cpp:149,158). This module is a
clean-room reimplementation of that pipeline's published semantics —
SMEM seeding (bwt_smem1a / mem_collect_intv), seed chaining (mem_chain
+ test_and_merge), chain filtering (mem_chain_flt), banded extension
(mem_chain2aln over ksw_extend), dedup/patch (mem_sort_dedup_patch),
primary marking (mem_mark_primary_se), MAPQ (mem_approx_mapq_se), and
finalization with CIGAR/NM (mem_reg2aln over ksw_global) — against this
package's FM-index. No bwa binary exists in this environment, so this
oracle *is* the correctness gate: the batched TPU pipeline must
reproduce it, and tests pin both against brute-force oracles where one
exists.

Scalar and deliberately simple; used on hundreds of reads in tests,
never on the hot path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.cpu.ksw import (
    cigar_nm_md,
    fill_scmat,
    ksw_extend,
    ksw_global,
)
from bioseqdb_tpu_torch.index.fmindex import FMIndex

MAX_BAND_TRY = 2
PATCH_MAX_R_BW = 0.25
PATCH_MIN_SC_RATIO = 0.90


# -- SMEM seeding ----------------------------------------------------------


@dataclass
class BiInterval:
    """bwtintv_t: (k, l, s) + the query span [start, end)."""

    k: int
    l: int
    s: int
    start: int
    end: int


def set_intv(idx: FMIndex, c: int) -> tuple[int, int, int]:
    """Initial bi-interval of a single base (bwt_set_intv)."""
    L2 = idx.L2
    return int(L2[c]) + 1, int(L2[3 - c]) + 1, int(L2[c + 1] - L2[c])


def smem1(idx: FMIndex, q: np.ndarray, x: int, min_intv: int) -> tuple[int, list[BiInterval]]:
    """SMEMs through pivot x (bwt_smem1 semantics, i.e. bwt_smem1a with
    max_intv = 0 — the only configuration bwa-mem's seeding uses).

    Forward pass: extend [x, i) rightward, recording an interval each
    time its size shrinks, until it would drop below ``min_intv``, hit
    an ambiguous base, or reach the end. Backward pass: extend each
    candidate leftward (longest-first); a candidate that cannot extend
    further is an SMEM iff no longer candidate survived to the same
    left edge and it is not contained in an already-emitted SMEM.
    Returns (next_pivot, mems sorted by start).
    """
    length = len(q)
    if q[x] > 3:
        return x + 1, []
    k, l, s = set_intv(idx, int(q[x]))
    curr: list[tuple[int, int, int, int]] = []  # (k, l, s, end)
    ik = (k, l, s, x + 1)

    i = x + 1
    while i < length:
        if q[i] < 4:
            k4, l4, s4 = idx.fmd_extend(ik[0], ik[1], ik[2], is_back=False)
            ok = (int(k4[q[i]]), int(l4[q[i]]), int(s4[q[i]]))
            if ok[2] != ik[2]:
                curr.append(ik)
                if ok[2] < min_intv:
                    break
            ik = (ok[0], ok[1], ok[2], i + 1)
        else:
            curr.append(ik)
            break
        i += 1
    if i == length:
        curr.append(ik)
    curr.reverse()  # longest match first
    ret = curr[0][3]

    mems: list[BiInterval] = []
    prev = curr
    i = x - 1
    while i >= -1:
        c = -1 if i < 0 or q[i] >= 4 else int(q[i])
        curr2: list[tuple[int, int, int, int]] = []
        for p in prev:
            ok = None
            if c >= 0:
                k4, l4, s4 = idx.fmd_extend(p[0], p[1], p[2], is_back=True)
                ok = (int(k4[c]), int(l4[c]), int(s4[c]))
            if c < 0 or ok[2] < min_intv:
                if not curr2:  # no longer match reached this left edge
                    if not mems or i + 1 < mems[-1].start:  # not contained
                        mems.append(
                            BiInterval(k=p[0], l=p[1], s=p[2], start=i + 1, end=p[3])
                        )
            elif not curr2 or ok[2] != curr2[-1][2]:
                curr2.append((ok[0], ok[1], ok[2], p[3]))
        if not curr2:
            break
        prev = curr2
        i -= 1
    mems.reverse()  # sorted by start
    return ret, mems


def seed_strategy1(
    idx: FMIndex, q: np.ndarray, x: int, min_len: int, max_intv: int
) -> tuple[int, BiInterval | None]:
    """Third-round LAST-like seeding (bwt_seed_strategy1): forward-extend
    from x until the interval drops below max_intv with length >= min_len."""
    length = len(q)
    if q[x] > 3:
        return x + 1, None
    k, l, s = set_intv(idx, int(q[x]))
    i = x + 1
    while i < length:
        if q[i] < 4:
            k4, l4, s4 = idx.fmd_extend(k, l, s, is_back=False)
            ok = (int(k4[q[i]]), int(l4[q[i]]), int(s4[q[i]]))
            if ok[2] < max_intv and i - x >= min_len:
                if ok[2] > 0:
                    return i + 1, BiInterval(ok[0], ok[1], ok[2], x, i + 1)
                return i + 1, None
            k, l, s = ok
        else:
            return i + 1, None
        i += 1
    return length, None


def collect_intv(idx: FMIndex, opt: AlignOptions, q: np.ndarray) -> tuple[list[BiInterval], float]:
    """mem_collect_intv: three seeding rounds + frac_rep computation."""
    length = len(q)
    max_occ = opt.resolve_max_occ(idx.n_refs)
    split_len = int(opt.min_seed_len * opt.reseed_factor + 0.499)
    mems: list[BiInterval] = []

    # round 1: all SMEMs of length >= min_seed_len
    x = 0
    while x < length:
        if q[x] < 4:
            x, found = smem1(idx, q, x, min_intv=1)
            for p in found:
                if p.end - p.start >= opt.min_seed_len:
                    mems.append(p)
        else:
            x += 1

    # round 2: re-seed inside long low-occurrence SMEMs
    for p in list(mems):
        if p.end - p.start < split_len or p.s > opt.split_width:
            continue
        _, found = smem1(idx, q, (p.start + p.end) >> 1, min_intv=p.s + 1)
        for m in found:
            if m.end - m.start >= opt.min_seed_len:
                mems.append(m)

    # round 3: LAST-like seeds
    if opt.max_mem_intv > 0:
        x = 0
        while x < length:
            if q[x] < 4:
                x, m = seed_strategy1(idx, q, x, opt.min_seed_len, opt.max_mem_intv)
                if m is not None:
                    mems.append(m)
            else:
                x += 1

    mems.sort(key=lambda p: (p.start, p.end))

    # frac_rep from round-boundary-free scan over all collected intervals
    b = e = l_rep = 0
    for p in mems:
        if p.s <= max_occ:
            continue
        if p.start > e:
            l_rep += e - b
            b, e = p.start, p.end
        else:
            e = max(e, p.end)
    l_rep += e - b
    return mems, l_rep / max(length, 1)


# -- chaining --------------------------------------------------------------


@dataclass
class Seed:
    rbeg: int
    qbeg: int
    len: int
    score: int


@dataclass
class Chain:
    pos: int                 # rbeg of the first seed (kbtree key)
    rid: int
    seeds: list[Seed] = field(default_factory=list)
    w: int = 0               # weight (mem_chain_weight)
    kept: int = 0
    first: int = -1
    frac_rep: float = 0.0
    is_alt: bool = False


def cal_max_gap(opt: AlignOptions, qlen: int) -> int:
    l_del = int((qlen * opt.match_score - opt.o_del) / opt.e_del + 1.0)
    l_ins = int((qlen * opt.match_score - opt.o_ins) / opt.e_ins + 1.0)
    return min(max(max(l_del, l_ins), 1), opt.bandwidth << 1)


def intv2rid(idx: FMIndex, rb: int, re: int) -> int:
    """bns_intv2rid: rid if [rb, re) stays on one strand of one ref."""
    if rb < idx.l_pac < re:
        return -2
    fb, _ = idx.depos(rb, 1)
    fe, _ = idx.depos(re - 1, 1)
    rid_b = idx.rid_of(fb)
    rid_e = idx.rid_of(fe) if rb < re else rid_b
    return rid_b if rid_b == rid_e else -1


def test_and_merge(opt: AlignOptions, l_pac: int, c: Chain, p: Seed, seed_rid: int) -> int:
    """1 = merged/contained, 0 = request a new chain (mem_chain's helper)."""
    last = c.seeds[-1]
    qend = last.qbeg + last.len
    rend = last.rbeg + last.len
    if seed_rid != c.rid:
        return 0
    if (
        p.qbeg >= c.seeds[0].qbeg and p.qbeg + p.len <= qend
        and p.rbeg >= c.seeds[0].rbeg and p.rbeg + p.len <= rend
    ):
        return 1  # contained seed
    if (last.rbeg < l_pac or c.seeds[0].rbeg < l_pac) and p.rbeg >= l_pac:
        return 0  # different strand
    x = p.qbeg - last.qbeg  # non-negative (seeds sorted by qbeg)
    y = p.rbeg - last.rbeg
    if (
        y >= 0 and x - y <= opt.bandwidth and y - x <= opt.bandwidth
        and x - last.len < opt.max_chain_gap and y - last.len < opt.max_chain_gap
    ):
        c.seeds.append(p)
        return 1
    return 0


def chain_weight(c: Chain) -> int:
    w_q = end = 0
    for s in c.seeds:
        if s.qbeg >= end:
            w_q += s.len
        elif s.qbeg + s.len > end:
            w_q += s.qbeg + s.len - end
        end = max(end, s.qbeg + s.len)
    w_r = end = 0
    for s in sorted(c.seeds, key=lambda s: s.rbeg):
        if s.rbeg >= end:
            w_r += s.len
        elif s.rbeg + s.len > end:
            w_r += s.rbeg + s.len - end
        end = max(end, s.rbeg + s.len)
    return min(w_q, w_r)


def mem_chain(idx: FMIndex, opt: AlignOptions, q: np.ndarray) -> list[Chain]:
    """mem_chain: resolve seed positions (max_occ-sampled) and grow chains
    via closest-chain insertion (kbtree emulated with a sorted list)."""
    import bisect

    mems, frac_rep = collect_intv(idx, opt, q)
    max_occ = opt.resolve_max_occ(idx.n_refs)
    chains: list[Chain] = []   # kept sorted by .pos
    keys: list[int] = []

    for p in mems:
        slen = p.end - p.start
        step = p.s // max_occ if p.s > max_occ else 1
        k = count = 0
        while k < p.s and count < max_occ:
            rbeg = idx.sa_at(p.k + k)
            seed = Seed(rbeg=rbeg, qbeg=p.start, len=slen, score=slen)
            rid = intv2rid(idx, rbeg, rbeg + slen)
            if rid >= 0:
                # find the chain with the largest pos <= rbeg
                ci = bisect.bisect_right(keys, rbeg) - 1
                merged = 0
                if ci >= 0:
                    merged = test_and_merge(opt, idx.l_pac, chains[ci], seed, rid)
                if not merged:
                    c = Chain(pos=rbeg, rid=rid, seeds=[seed], frac_rep=frac_rep,
                              is_alt=bool(idx.ref_is_alt[rid])
                              if len(idx.ref_is_alt) else False)
                    j = bisect.bisect_right(keys, rbeg)
                    keys.insert(j, rbeg)
                    chains.insert(j, c)
            k += step
            count += 1
    return chains


def chain_flt(opt: AlignOptions, chains: list[Chain]) -> list[Chain]:
    """mem_chain_flt: weight, sort, drop shadowed/weak chains."""
    if not chains:
        return []
    for c in chains:
        c.w = chain_weight(c)
        c.first = -1
        c.kept = 0
    chains = [c for c in chains if c.w >= opt.min_chain_weight]
    if not chains:
        return []
    # weight descending; ties broken by chain position ascending — the
    # reference's introsort is unstable on ties, so this clean-room
    # build pins a deterministic order (device chaining matches it)
    chains.sort(key=lambda c: (-c.w, c.pos))

    def chn_beg(c: Chain) -> int:
        return c.seeds[0].qbeg

    def chn_end(c: Chain) -> int:
        return c.seeds[-1].qbeg + c.seeds[-1].len

    kept_idx = [0]
    chains[0].kept = 3
    for i in range(1, len(chains)):
        large_ovlp = False
        broke = False
        for j in kept_idx:
            b_max = max(chn_beg(chains[j]), chn_beg(chains[i]))
            e_min = min(chn_end(chains[j]), chn_end(chains[i]))
            if e_min > b_max and (not chains[j].is_alt or chains[i].is_alt):
                li = chn_end(chains[i]) - chn_beg(chains[i])
                lj = chn_end(chains[j]) - chn_beg(chains[j])
                min_l = min(li, lj)
                if e_min - b_max >= min_l * opt.mask_level and min_l < opt.max_chain_gap:
                    large_ovlp = True
                    if chains[j].first < 0:
                        chains[j].first = i
                    if (
                        chains[i].w < chains[j].w * opt.chain_drop_ratio
                        and chains[j].w - chains[i].w >= opt.min_seed_len * 2
                    ):
                        broke = True
                        break
        if not broke:
            kept_idx.append(i)
            chains[i].kept = 2 if large_ovlp else 3
    for j in kept_idx:
        if chains[j].first >= 0:
            chains[chains[j].first].kept = 1
    return [c for c in chains if c.kept > 0]


# -- extension -------------------------------------------------------------


@dataclass
class AlnReg:
    """mem_alnreg_t."""

    rb: int = 0
    re: int = 0
    qb: int = 0
    qe: int = 0
    rid: int = -1
    score: int = 0
    truesc: int = 0
    sub: int = 0
    csub: int = 0
    sub_n: int = 0
    w: int = 0
    seedcov: int = 0
    secondary: int = -1
    seedlen0: int = 0
    n_comp: int = 1
    frac_rep: float = 0.0
    is_alt: bool = False
    hash: int = 0


def get_dseq(idx: FMIndex, rb: int, re: int) -> np.ndarray:
    """bns_get_seq: codes of the doubled text window [rb, re)."""
    L, n = idx.l_pac, idx.seq_len
    assert 0 <= rb <= re <= n
    if re <= L:
        return idx.pac[rb:re].copy()
    if rb >= L:
        return (3 - idx.pac[n - re : n - rb])[::-1].copy()
    raise ValueError("window bridges the forward-reverse boundary")


def chain2aln(
    idx: FMIndex, opt: AlignOptions, q: np.ndarray, c: Chain, regs: list[AlnReg],
    mat: np.ndarray,
) -> None:
    """mem_chain2aln: extend each seed (best-scoring first) left + right
    with banded SW unless already covered by an existing region."""
    l_query = len(q)
    l_pac = idx.l_pac
    rmax0, rmax1 = idx.seq_len, 0
    for t in c.seeds:
        b = t.rbeg - (t.qbeg + cal_max_gap(opt, t.qbeg))
        e = t.rbeg + t.len + (l_query - t.qbeg - t.len) + cal_max_gap(
            opt, l_query - t.qbeg - t.len
        )
        rmax0 = min(rmax0, b)
        rmax1 = max(rmax1, e)
    rmax0 = max(rmax0, 0)
    rmax1 = min(rmax1, idx.seq_len)
    if rmax0 < l_pac < rmax1:  # crossing the strand boundary: pick one side
        if c.seeds[0].rbeg < l_pac:
            rmax1 = l_pac
        else:
            rmax0 = l_pac
    # clip to the reference containing the first seed (bns_fetch_seq):
    # extensions must not run across concatenated reference boundaries
    mid = c.seeds[0].rbeg
    fwd_mid, mid_rev = idx.depos(mid, 1)
    rid_mid = idx.rid_of(fwd_mid)
    far_beg = int(idx.ref_offsets[rid_mid])
    far_end = far_beg + int(idx.ref_lens[rid_mid])
    if mid_rev:
        far_beg, far_end = idx.seq_len - far_end, idx.seq_len - far_beg
    rmax0 = max(rmax0, far_beg)
    rmax1 = min(rmax1, far_end)
    rseq = get_dseq(idx, rmax0, rmax1)

    # process seeds best-score-first (srt order: descending score, ties
    # broken toward the later seed, matching the reference's uint64 sort)
    srt = sorted(range(len(c.seeds)), key=lambda i: (c.seeds[i].score, i))
    srt.reverse()
    extended = [False] * len(c.seeds)

    for ki in range(len(srt)):
        sidx = srt[ki]
        s = c.seeds[sidx]
        # test whether the seed is contained in an existing region
        covered = None
        for p in regs:
            if (
                s.rbeg < p.rb or s.rbeg + s.len > p.re
                or s.qbeg < p.qb or s.qbeg + s.len > p.qe
            ):
                continue
            if s.len - p.seedlen0 > 0.1 * l_query:
                continue
            qd, rd = s.qbeg - p.qb, s.rbeg - p.rb
            max_gap = cal_max_gap(opt, min(qd, rd))
            w = min(max_gap, p.w)
            if qd - rd < w and rd - qd < w:
                covered = p
                break
            qd, rd = p.qe - (s.qbeg + s.len), p.re - (s.rbeg + s.len)
            max_gap = cal_max_gap(opt, min(qd, rd))
            w = min(max_gap, p.w)
            if qd - rd < w and rd - qd < w:
                covered = p
                break
        if covered is not None:
            # the seed sits inside an existing region; still extend it if
            # some already-extended overlapping seed of similar length lies
            # on a different diagonal (the region may represent a different
            # alignment than this seed's). Earlier srt entries = already
            # processed; the reference marks skipped ones srt[i] = 0.
            need = False
            for i2 in range(ki):
                if not extended[srt[i2]]:
                    continue
                t = c.seeds[srt[i2]]
                if t.len < s.len * 0.95:
                    continue
                if (
                    s.qbeg <= t.qbeg and s.qbeg + s.len - t.qbeg >= s.len // 4
                    and t.qbeg - s.qbeg != t.rbeg - s.rbeg
                ):
                    need = True
                    break
                if (
                    t.qbeg <= s.qbeg and t.qbeg + t.len - s.qbeg >= s.len // 4
                    and s.qbeg - t.qbeg != s.rbeg - t.rbeg
                ):
                    need = True
                    break
            if not need:
                continue  # extension not performed for this seed

        a = AlnReg(rid=c.rid, frac_rep=c.frac_rep, seedlen0=s.len, w=opt.bandwidth)
        a.score = a.truesc = -1
        aw = [opt.bandwidth, opt.bandwidth]

        if s.qbeg:  # left extension
            qs = q[: s.qbeg][::-1].copy()
            tmp = s.rbeg - rmax0
            rs = rseq[:tmp][::-1].copy()
            res = None
            for itry in range(MAX_BAND_TRY):
                prev_sc = a.score
                aw[0] = opt.bandwidth << itry
                res = ksw_extend(
                    qs, rs, mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                    aw[0], opt.pen_clip5, opt.zdrop, s.len * opt.match_score,
                )
                a.score = res.score
                if a.score == prev_sc or res.max_off < (aw[0] >> 1) + (aw[0] >> 2):
                    break
            if res.gscore <= 0 or res.gscore <= a.score - opt.pen_clip5:
                a.qb = s.qbeg - res.qle
                a.rb = s.rbeg - res.tle
                a.truesc = a.score
            else:
                a.qb = 0
                a.rb = s.rbeg - res.gtle
                a.truesc = res.gscore
        else:
            a.score = a.truesc = s.len * opt.match_score
            a.qb = 0
            a.rb = s.rbeg

        if s.qbeg + s.len != l_query:  # right extension
            sc0 = a.score
            qe = s.qbeg + s.len
            re = s.rbeg + s.len - rmax0
            res = None
            for itry in range(MAX_BAND_TRY):
                prev_sc = a.score
                aw[1] = opt.bandwidth << itry
                res = ksw_extend(
                    q[qe:], rseq[re:], mat, opt.o_del, opt.e_del, opt.o_ins,
                    opt.e_ins, aw[1], opt.pen_clip3, opt.zdrop, sc0,
                )
                a.score = res.score
                if a.score == prev_sc or res.max_off < (aw[1] >> 1) + (aw[1] >> 2):
                    break
            if res.gscore <= 0 or res.gscore <= a.score - opt.pen_clip3:
                a.qe = qe + res.qle
                a.re = rmax0 + re + res.tle
                a.truesc += a.score - sc0
            else:
                a.qe = l_query
                a.re = rmax0 + re + res.gtle
                a.truesc += res.gscore - sc0
        else:
            a.qe = l_query
            a.re = s.rbeg + s.len

        a.seedcov = sum(
            t.len
            for t in c.seeds
            if t.qbeg >= a.qb and t.qbeg + t.len <= a.qe
            and t.rbeg >= a.rb and t.rbeg + t.len <= a.re
        )
        a.w = max(aw[0], aw[1])
        extended[sidx] = True
        regs.append(a)


# -- dedup / patch ---------------------------------------------------------


MEM_SHORT_EXT = 50
MEM_SHORT_LEN = 200
MEM_HSP_COEF = 1.1
MEM_MINSC_COEF = 5.5
MEM_SEEDSW_COEF = 0.05


def local_sw_score(q: np.ndarray, t: np.ndarray, mat: np.ndarray,
                   o_del: int, e_del: int, o_ins: int, e_ins: int) -> int:
    """Best local (Smith-Waterman) affine-gap score — score only (the
    role of ksw_align2's x.score inside mem_seed_sw). Row loop over the
    target; the within-row F recursion uses the lazy-F prefix-max form
    (exact for nonnegative gap-open costs)."""
    m = len(q)
    if m == 0 or len(t) == 0:
        return 0
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    jj = np.arange(m, dtype=np.int64)
    qv = np.asarray(q, np.int64)
    H = np.zeros(m, np.int64)      # H(i-1, j)
    E = np.zeros(m, np.int64)      # E(i, j)
    best = 0
    for ti in t:
        srow = mat[int(ti), qv]
        diag = np.concatenate([[0], H[:-1]]) + srow
        E = np.maximum(E - e_del, H - oe_del)
        hne = np.maximum(np.maximum(diag, E), 0)
        opener = np.maximum.accumulate(hne - oe_ins + e_ins * jj)
        F = np.concatenate([[-1 << 30], opener[:-1]]) - e_ins * jj
        H = np.maximum(hne, F)
        best = max(best, int(H.max()))
    return best


def _clip_to_ref(idx: FMIndex, rb: int, re: int, mid: int) -> tuple[int, int]:
    """bns_fetch_seq's boundary clip: shrink the doubled-text window
    [rb, re) to the reference containing ``mid`` (same strand)."""
    n, L = idx.seq_len, idx.l_pac
    if mid < L:
        rid = idx.rid_of(mid)
        off = int(idx.ref_offsets[rid])
        end = off + int(idx.ref_lens[rid])
        return max(rb, off), min(re, end)
    fmid = n - 1 - mid
    rid = idx.rid_of(fmid)
    off = int(idx.ref_offsets[rid])
    end = off + int(idx.ref_lens[rid])
    frb, fre = max(n - re, off), min(n - rb, end)
    return n - fre, n - frb


def mem_seed_sw(idx: FMIndex, opt: AlignOptions, q: np.ndarray, s: Seed,
                mat: np.ndarray) -> int:
    """mem_seed_sw: re-score a short seed with local SW over a +-50
    window; -1 = seed long/window large enough that no check is needed."""
    if s.len >= MEM_SHORT_LEN:
        return -1
    l_query = len(q)
    l_pac = idx.l_pac
    qb, qe = s.qbeg, s.qbeg + s.len
    rb, re = s.rbeg, s.rbeg + s.len
    mid = (rb + re) >> 1
    qb = max(qb - MEM_SHORT_EXT, 0)
    qe = min(qe + MEM_SHORT_EXT, l_query)
    rb = max(rb - MEM_SHORT_EXT, 0)
    re = min(re + MEM_SHORT_EXT, l_pac << 1)
    if rb < l_pac < re:
        if mid < l_pac:
            re = l_pac
        else:
            rb = l_pac
    if qe - qb >= MEM_SHORT_LEN or re - rb >= MEM_SHORT_LEN:
        return -1
    rb, re = _clip_to_ref(idx, rb, re, mid)
    rseq = get_dseq(idx, rb, re)
    return local_sw_score(q[qb:qe], rseq, mat, opt.o_del, opt.e_del,
                          opt.o_ins, opt.e_ins)


def seed_sw_filter_active(opt: AlignOptions, l_query: int) -> bool:
    """Whether mem_flt_chained_seeds runs for this query length (its
    early-return guard inverted): only for long queries (~>= 900 bp at
    default options)."""
    if l_query <= 0:
        return False
    min_l = (MEM_HSP_COEF * opt.min_chain_weight if opt.min_chain_weight
             else MEM_MINSC_COEF * np.log(l_query))
    return min_l <= MEM_SEEDSW_COEF * l_query


def flt_chained_seeds(idx: FMIndex, opt: AlignOptions, q: np.ndarray,
                      chains: list[Chain], mat: np.ndarray) -> list[Chain]:
    """mem_flt_chained_seeds: for long queries, re-score each short seed
    with a windowed local SW and drop seeds below the min-HSP score."""
    if not seed_sw_filter_active(opt, len(q)):
        return chains
    min_l = (MEM_HSP_COEF * opt.min_chain_weight if opt.min_chain_weight
             else MEM_MINSC_COEF * np.log(len(q)))
    min_hsp = int(opt.match_score * min_l + 0.499)
    for c in chains:
        kept = []
        for s in c.seeds:
            s.score = mem_seed_sw(idx, opt, q, s, mat)
            if s.score < 0 or s.score >= min_hsp:
                s.score = s.len * opt.match_score if s.score < 0 else s.score
                kept.append(s)
        c.seeds = kept
    return [c for c in chains if c.seeds]


def infer_bw(l1: int, l2: int, score: int, a: int, q: int, r: int) -> int:
    if l1 == l2 and l1 * a - score < (q + r - a) << 1:
        return 0
    w = int((min(l1, l2) * a - score - q) / r + 2.0)
    return max(w, abs(l1 - l2))


def patch_reg(
    idx: FMIndex, opt: AlignOptions, q: np.ndarray, a: AlnReg, b: AlnReg,
    mat: np.ndarray,
) -> tuple[int, int]:
    """mem_patch_reg: try to merge colinear split alignments a (left) and
    b (right) with one global alignment. Returns (score, w); score 0 = no."""
    assert a.rid == b.rid and a.rb <= b.rb
    if a.rb < idx.l_pac <= b.rb:
        return 0, 0
    if a.qb >= b.qb or a.qe >= b.qe or a.re >= b.re:
        return 0, 0
    w = abs((a.re - b.rb) - (a.qe - b.qb))
    r = abs(
        (a.re - b.rb) / (b.re - a.rb) - (a.qe - b.qb) / (b.qe - a.qb)
    )
    if a.re < b.rb or a.qe < b.qb:  # no overlap
        if w > opt.bandwidth << 1 or r >= PATCH_MAX_R_BW:
            return 0, 0
    elif w > opt.bandwidth << 2 or r >= PATCH_MAX_R_BW * 2:
        return 0, 0
    w += min(a.w, b.w)
    w = min(w, opt.bandwidth << 2)
    try:
        rseq = get_dseq(idx, a.rb, b.re)
    except ValueError:
        return 0, 0
    qseg = q[a.qb : b.qe]
    if a.rb >= idx.l_pac:
        qseg = qseg[::-1].copy()
        rseq = rseq[::-1].copy()
    score, _ = ksw_global(
        qseg, rseq, mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, w
    )
    q_s = int((b.qe - a.qb) / ((b.qe - b.qb) + (a.qe - a.qb)) * (b.score + a.score) + 0.499)
    r_s = int((b.re - a.rb) / ((b.re - b.rb) + (a.re - a.rb)) * (b.score + a.score) + 0.499)
    if score / max(q_s, r_s) < PATCH_MIN_SC_RATIO:
        return 0, 0
    return score, w


def sort_dedup_patch(
    idx: FMIndex, opt: AlignOptions, q: np.ndarray, regs: list[AlnReg],
    mat: np.ndarray,
) -> list[AlnReg]:
    """mem_sort_dedup_patch."""
    if len(regs) <= 1:
        return regs
    regs.sort(key=lambda p: (p.re, p.rb))  # sort by END position (mem_ars2)
    for p in regs:
        p.n_comp = 1
    for i in range(1, len(regs)):
        p = regs[i]
        if p.rid != regs[i - 1].rid or p.rb >= regs[i - 1].re + opt.max_chain_gap:
            continue
        for j in range(i - 1, -1, -1):
            qreg = regs[j]
            if p.rid != qreg.rid or p.rb >= qreg.re + opt.max_chain_gap:
                break
            if qreg.qe == qreg.qb:
                continue  # excluded
            or_ = qreg.re - p.rb
            oq = (qreg.qe - p.qb) if qreg.qb < p.qb else (p.qe - qreg.qb)
            mr = min(qreg.re - qreg.rb, p.re - p.rb)
            mq = min(qreg.qe - qreg.qb, p.qe - p.qb)
            if or_ > opt.mask_level_redun * mr and oq > opt.mask_level_redun * mq:
                if p.score < qreg.score:
                    p.qe = p.qb  # exclude p
                    break
                qreg.qe = qreg.qb  # exclude q
            elif qreg.rb < p.rb:
                score, w = patch_reg(idx, opt, q, qreg, p, mat)
                if score > 0:
                    p.n_comp += qreg.n_comp + 1
                    p.seedcov = max(p.seedcov, qreg.seedcov)
                    p.score = p.truesc = score
                    p.qb, p.rb = qreg.qb, qreg.rb
                    p.w = w
                    qreg.qe = qreg.qb
    regs = [p for p in regs if p.qe > p.qb]
    regs.sort(key=lambda p: (-p.score, p.rb, p.qb))  # mem_ars
    return regs


# -- primary marking + MAPQ ------------------------------------------------


def hash_64(key: int) -> int:
    mask = (1 << 64) - 1
    key = (key + (~(key << 32) & mask)) & mask
    key ^= key >> 22
    key = (key + (~(key << 13) & mask)) & mask
    key ^= key >> 8
    key = (key + (key << 3)) & mask
    key ^= key >> 15
    key = (key + (~(key << 27) & mask)) & mask
    key ^= key >> 31
    return key


def mark_primary(opt: AlignOptions, regs: list[AlnReg], rand_id: int = 0) -> list[AlnReg]:
    """mem_mark_primary_se (single-end): sort by score (hash tie-break),
    mark overlapped regions secondary, fill sub/sub_n."""
    if not regs:
        return regs
    for i, r in enumerate(regs):
        r.sub = r.sub_n = 0
        r.secondary = -1
        r.hash = hash_64(rand_id + i)
    regs.sort(key=lambda r: (-r.score, r.is_alt, r.hash))
    tmp = opt.match_score + opt.mismatch_penalty
    tmp = max(tmp, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    z: list[int] = [0]
    for i in range(1, len(regs)):
        placed = False
        for k in z:
            b_max = max(regs[k].qb, regs[i].qb)
            e_min = min(regs[k].qe, regs[i].qe)
            if e_min > b_max:
                min_l = min(regs[i].qe - regs[i].qb, regs[k].qe - regs[k].qb)
                if e_min - b_max >= min_l * opt.mask_level:
                    if regs[k].sub == 0:
                        regs[k].sub = regs[i].score
                    if regs[k].score - regs[i].score <= tmp and (
                        regs[k].is_alt or not regs[i].is_alt
                    ):
                        regs[k].sub_n += 1
                    regs[i].secondary = k
                    placed = True
                    break
        if not placed:
            z.append(i)
    return regs


def approx_mapq(opt: AlignOptions, a: AlnReg) -> int:
    """mem_approx_mapq_se."""
    import math

    mapq_coef_len = 50
    mapq_coef_fac = math.log(mapq_coef_len)
    sub = a.sub if a.sub else opt.min_seed_len * opt.match_score
    sub = max(sub, a.csub)
    if sub >= a.score:
        return 0
    l = max(a.qe - a.qb, a.re - a.rb)
    identity = 1.0 - (l * opt.match_score - a.score) / (
        opt.match_score + opt.mismatch_penalty
    ) / l
    if a.score == 0:
        mapq = 0
    else:
        tmp = 1.0 if l < mapq_coef_len else mapq_coef_fac / math.log(l)
        tmp *= identity * identity
        mapq = int(6.02 * (a.score - sub) / opt.match_score * tmp * tmp + 0.499)
    if a.sub_n > 0:
        mapq -= int(4.343 * math.log(a.sub_n + 1) + 0.499)
    mapq = min(mapq, 60)
    mapq = max(mapq, 0)
    mapq = int(mapq * (1.0 - a.frac_rep) + 0.499)
    return mapq


# -- finalization ----------------------------------------------------------


@dataclass
class Aln:
    """mem_aln_t: the final per-record alignment."""

    pos: int = -1            # 0-based position within the reference
    rid: int = -1
    flag: int = 0
    is_rev: bool = False
    mapq: int = 0
    NM: int = 0
    cigar: list = field(default_factory=list)  # [(len, op)] incl. soft clips
    score: int = 0
    sub: int = -1
    MD: str = ""


def reg2aln(
    idx: FMIndex, opt: AlignOptions, q: np.ndarray, ar: AlnReg, mat: np.ndarray,
) -> Aln:
    """mem_reg2aln: global alignment for the CIGAR + flag/pos/NM/MD."""
    a = Aln()
    l_query = len(q)
    if ar is None or ar.rb < 0 or ar.re < 0:
        a.flag |= 0x4
        return a
    qb, qe, rb, re = ar.qb, ar.qe, ar.rb, ar.re
    a.mapq = approx_mapq(opt, ar) if ar.secondary < 0 else 0
    if ar.secondary >= 0:
        a.flag |= 0x100
    w2 = max(
        infer_bw(qe - qb, re - rb, ar.truesc, opt.match_score, opt.o_del, opt.e_del),
        infer_bw(qe - qb, re - rb, ar.truesc, opt.match_score, opt.o_ins, opt.e_ins),
    )
    if w2 > opt.bandwidth:
        w2 = min(w2, ar.w)
    qseg = q[qb:qe].copy()
    is_rev = rb >= idx.l_pac
    last_sc = -(1 << 30)
    i = 0
    while True:
        w2 = min(w2, opt.bandwidth << 2)
        rseq = get_dseq(idx, rb, re)
        qq, rr = (qseg[::-1].copy(), rseq[::-1].copy()) if is_rev else (qseg, rseq)
        if qe - qb == re - rb and w2 == 0:
            score = int(mat[np.asarray(rr), np.asarray(qq)].sum())
            cigar = [(qe - qb, "M")]
        else:
            score, cigar = ksw_global(
                qq, rr, mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, w2
            )
        if score == last_sc or w2 == opt.bandwidth << 2:
            break
        last_sc = score
        w2 <<= 1
        i += 1
        if not (i < 3 and score < ar.truesc - opt.match_score):
            break
    a.NM, a.MD = cigar_nm_md(cigar, qq, rr)
    a.score = ar.score
    a.is_rev = is_rev
    if is_rev:
        a.flag |= 0x10

    pos = idx.depos(rb, re - rb)[0] if not is_rev else idx.seq_len - re
    # squeeze out leading/trailing deletions
    if cigar and cigar[0][1] == "D":
        pos += cigar[0][0]
        cigar = cigar[1:]
    if cigar and cigar[-1][1] == "D":
        cigar = cigar[:-1]
    # soft clips
    clip5 = l_query - qe if is_rev else qb
    clip3 = qb if is_rev else l_query - qe
    if clip5:
        cigar = [(clip5, "S")] + cigar
    if clip3:
        cigar = cigar + [(clip3, "S")]
    a.cigar = cigar
    a.rid = idx.rid_of(pos)
    a.pos = pos - int(idx.ref_offsets[a.rid])
    a.sub = max(ar.sub, ar.csub)
    return a


# -- top level -------------------------------------------------------------


def mem_align1(
    idx: FMIndex, opt: AlignOptions, q: np.ndarray, rand_id: int = 0
) -> list[AlnReg]:
    """The whole per-read pipeline (mem_align1 / mem_align1_core)."""
    mat = fill_scmat(opt.match_score, opt.mismatch_penalty)
    chains = mem_chain(idx, opt, q)
    chains = chain_flt(opt, chains)
    # long queries only (~>= 900 bp at defaults): windowed seed-SW filter
    chains = flt_chained_seeds(idx, opt, q, chains, mat)
    regs: list[AlnReg] = []
    for c in chains:
        chain2aln(idx, opt, q, c, regs, mat)
    regs = sort_dedup_patch(idx, opt, q, regs, mat)
    # flag ALT-contig regions before primary marking (mem_align1_core's
    # anns[rid].is_alt pass)
    if len(idx.ref_is_alt):
        for r in regs:
            if 0 <= r.rid < len(idx.ref_is_alt):
                r.is_alt = bool(idx.ref_is_alt[r.rid])
    regs = mark_primary(opt, regs, rand_id)
    return regs


def align_read(
    idx: FMIndex, opt: AlignOptions, q: np.ndarray, rand_id: int = 0,
    min_score: int = 30, all_hits: bool = True,
) -> list[Aln]:
    """mem_align1 + mem_reg2aln over every region (the reference's usage,
    bwa.cpp:149-181): returns finalized alignments for all regions with
    score >= min_score (bwa's opt->T)."""
    mat = fill_scmat(opt.match_score, opt.mismatch_penalty)
    regs = mem_align1(idx, opt, q, rand_id)
    out = []
    for r in regs:
        if r.score < min_score:
            continue
        if r.secondary >= 0:
            # mem_reg2sam's XA_drop_ratio gate relative to the shadowing
            # primary applies in both output modes
            if r.score < regs[r.secondary].score * opt.xa_drop_ratio:
                continue
            if not all_hits:
                continue
        out.append(reg2aln(idx, opt, q, r, mat))
    return out
