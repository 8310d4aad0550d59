"""Paired-end alignment: insert-size stats, pair selection, PE SAM.

The reference exposes no paired-end surface (its SQL functions are
single-read), but its engine (libbwa) does; BASELINE.md config 3 calls
for paired-end reads. This implements the published behavior of bwa's
pairing layer as clean-room equivalents:

- ``mem_infer_dir``: orientation + insert size from two doubled-text
  coordinates (bwamem_pair.c semantics).
- ``pestat``: per-orientation insert-size distributions from the batch's
  confidently-mapped pairs — percentile fences, mean/std within fences,
  mapping bounds (MIN_DIR_CNT 10, OUTLIER_BOUND 2, MAPPING_BOUND 3,
  MAX_STDDEV 4).
- ``mem_pair``: best-scoring consistent pair across the two ends'
  candidate regions with the erfc insert-size bonus; unpaired fallback
  with ``pen_unpaired``; PE MAPQ uplift (min(q_se+40, q_pe) rule).
- ``mem_matesw``: mate rescue — when no mate region is
  pairing-consistent with an anchor, the mate (or its revcomp) is
  locally aligned (native ksw_local) inside each viable insert window
  and rescued regions join pairing score-sorted.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from bioseqdb_tpu_torch.align.finalize import (add_sa_tags, aln_to_hit,
                                               frac_rep_of, regions_to_alnregs)
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.result import Hit, ReadResult
from bioseqdb_tpu_torch.cpu import oracle as O
from bioseqdb_tpu_torch.cpu.ksw import fill_scmat
from bioseqdb_tpu_torch.index.fmindex import FMIndex

MIN_DIR_CNT = 10
OUTLIER_BOUND = 2.0
MAPPING_BOUND = 3.0
MAX_STDDEV = 4.0


def infer_dir(l_pac: int, b1: int, b2: int) -> tuple[int, int]:
    """Orientation (0=FF', 1=FR, 2=RF, 3=RR-ish per bwa's encoding) and
    insert distance from two doubled-text begin coordinates."""
    r1, r2 = b1 >= l_pac, b2 >= l_pac
    p2 = b2 if r1 == r2 else (l_pac << 1) - 1 - b2
    dist = p2 - b1 if p2 > b1 else b1 - p2
    d = (0 if r1 == r2 else 1) ^ (0 if p2 > b1 else 3)
    return d, int(dist)


@dataclass
class PeStat:
    failed: bool = True
    low: int = 0
    high: int = 0
    avg: float = 0.0
    std: float = 100.0


def infer_dir_vec(l_pac: int, b1: np.ndarray, b2: np.ndarray):
    """Vectorized infer_dir over pair arrays."""
    r1, r2 = b1 >= l_pac, b2 >= l_pac
    same = r1 == r2
    p2 = np.where(same, b2, (l_pac << 1) - 1 - b2)
    dist = np.abs(p2 - b1)
    d = np.where(same, 0, 1) ^ np.where(p2 > b1, 0, 3)
    return d, dist


def pestat(reg_pairs, opt: AlignOptions, l_pac: int) -> list[PeStat]:
    """Insert-size statistics per orientation from best-region pairs.

    ``reg_pairs``: iterable of (regs_end1, regs_end2) — mark_primary'd
    region lists (best first).
    """
    rb1, rb2, s1, s2 = [], [], [], []
    for r1, r2 in reg_pairs:
        if not r1 or not r2:
            continue
        rb1.append(r1[0].rb)
        rb2.append(r2[0].rb)
        s1.append(r1[0].score)
        s2.append(r2[0].score)
    return pestat_arrays(np.asarray(rb1, np.int64), np.asarray(rb2, np.int64),
                         np.asarray(s1), np.asarray(s2), opt, l_pac)


def pestat_arrays(rb1, rb2, s1, s2, opt: AlignOptions,
                  l_pac: int) -> list[PeStat]:
    """pestat over best-pair coordinate/score arrays (vector front)."""
    isize = [[] for _ in range(4)]
    if len(rb1):
        ok = (np.asarray(s1) >= opt.min_score) & (np.asarray(s2) >= opt.min_score)
        d, dist = infer_dir_vec(l_pac, np.asarray(rb1), np.asarray(rb2))
        ok &= dist > 0
        for dd in range(4):
            isize[dd] = dist[ok & (d == dd)].tolist()
    out = []
    for d in range(4):
        vals = sorted(isize[d])
        st = PeStat()
        if len(vals) < MIN_DIR_CNT:
            out.append(st)
            continue
        n = len(vals)
        p25 = vals[int(0.25 * n + 0.499)]
        p50 = vals[int(0.50 * n + 0.499)]
        p75 = vals[int(0.75 * n + 0.499)]
        st.low = max(int(p25 - OUTLIER_BOUND * (p75 - p25) + 0.499), 1)
        st.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + 0.499)
        inliers = [v for v in vals if st.low <= v <= st.high]
        if not inliers:
            out.append(st)
            continue
        st.avg = sum(inliers) / len(inliers)
        st.std = math.sqrt(
            sum((v - st.avg) ** 2 for v in inliers) / len(inliers)
        ) or 1.0
        st.high = int(p75 + MAPPING_BOUND * (p75 - p25) + 0.499)
        st.low = max(int(p25 - MAPPING_BOUND * (p75 - p25) + 0.499), 1)
        st.low = min(st.low, int(st.avg - MAX_STDDEV * st.std + 0.499))
        st.high = max(st.high, int(st.avg + MAX_STDDEV * st.std + 0.499))
        st.low = max(st.low, 1)
        st.failed = False
        out.append(st)
    return out


def raw_mapq(diff: int, a: int) -> int:
    return int(6.02 * diff / a + 0.499)


def mem_pair(
    opt: AlignOptions, l_pac: int, pes: list[PeStat],
    regs1: list[O.AlnReg], regs2: list[O.AlnReg],
) -> tuple[int, int, int, tuple[int, int]]:
    """Best consistent pair across the two ends' regions.

    Returns (score, sub, n_sub, (i1, i2)); score <= 0 means no pair.
    Scores are o = s1 + s2 + insert bonus (bwa's erfc term).
    """
    cands = []
    for which, regs in ((0, regs1), (1, regs2)):
        for i, e in enumerate(regs):
            if e.secondary >= 0:
                continue
            cands.append((e.rb, which, i, e.score))
    best = (-1, 0, 0, (-1, -1))
    scores = []
    for a_i, (rb1, w1, i1, s1) in enumerate(cands):
        for rb2, w2, i2, s2 in cands:
            if w1 == w2:
                continue
            if w1 == 1:
                continue  # count each unordered pair once, end1 first
            d, dist = infer_dir(l_pac, rb1, rb2)
            st = pes[d]
            if st.failed or not (st.low <= dist <= st.high):
                continue
            ns = (dist - st.avg) / st.std
            q = int(
                -4.343 * math.log10(2.0 * math.erfc(abs(ns) * (2 ** -0.5)) + 1e-300)
                + 0.499
            )
            # bonus is negative-log-prob scaled; bwa caps the penalty so a
            # consistent pair is never penalized below its SE scores
            bonus = -q
            scores.append((s1 + s2 + max(bonus, -opt.pen_unpaired), i1, i2))
    if not scores:
        return 0, 0, 0, (-1, -1)
    scores.sort(key=lambda t: -t[0])
    score, i1, i2 = scores[0]
    sub = scores[1][0] if len(scores) > 1 else 0
    tmp = opt.match_score + opt.mismatch_penalty
    n_sub = sum(1 for s, _, _ in scores[1:] if score - s <= tmp)
    return score, sub, n_sub, (i1, i2)


def mem_matesw(
    idx: FMIndex, opt: AlignOptions, pes: list[PeStat], anchor: O.AlnReg,
    mate_codes: np.ndarray, mate_regs: list[O.AlnReg], mat: np.ndarray,
) -> int:
    """Mate rescue (mem_matesw): when no mate region lands at a
    pairing-consistent distance from ``anchor``, run local SW of the
    mate (or its revcomp) inside each viable insert window and insert
    any hit scoring >= min_seed_len into ``mate_regs`` (sorted by
    score). Returns the number of rescued regions."""
    from bioseqdb_tpu_torch.index.native.build import ksw_local_native

    l_pac = idx.l_pac
    l_ms = len(mate_codes)
    skip = [st.failed for st in pes]
    for m in mate_regs:
        d, dist = infer_dir(l_pac, anchor.rb, m.rb)
        if not pes[d].failed and pes[d].low <= dist <= pes[d].high:
            skip[d] = True
    if all(skip):
        return 0
    n = 0
    for r in range(4):
        if skip[r]:
            continue
        is_rev = (r >> 1) != (r & 1)
        is_larger = not (r >> 1)
        seq = mate_codes
        if is_rev:
            seq = np.where(mate_codes < 4, 3 - mate_codes, 4)[::-1].astype(np.uint8)
        if not is_rev:
            rb = anchor.rb + (pes[r].low if is_larger else -pes[r].high)
            re = anchor.rb + (pes[r].high if is_larger else -pes[r].low) + l_ms
        else:
            rb = anchor.rb + (pes[r].low if is_larger else -pes[r].high) - l_ms
            re = anchor.rb + (pes[r].high if is_larger else -pes[r].low)
        rb = max(rb, 0)
        re = min(re, 2 * l_pac)
        if rb >= re:
            continue
        # clip to the anchor's reference (bns_fetch_seq semantics)
        mid = (rb + re) >> 1
        fwd_mid, mid_rev = idx.depos(mid, 1)
        rid = idx.rid_of(fwd_mid)
        far_beg = int(idx.ref_offsets[rid])
        far_end = far_beg + int(idx.ref_lens[rid])
        if mid_rev:
            far_beg, far_end = idx.seq_len - far_end, idx.seq_len - far_beg
        rb, re = max(rb, far_beg), min(re, far_end)
        if rid != anchor.rid or re - rb < opt.min_seed_len:
            continue
        ref = O.get_dseq(idx, rb, re)
        score, qb, qe, tb, te, score2 = ksw_local_native(
            seq, ref, mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins
        )
        if score >= opt.min_seed_len and qb >= 0:
            b = O.AlnReg(
                rid=anchor.rid,
                qb=l_ms - qe if is_rev else qb,
                qe=l_ms - qb if is_rev else qe,
                rb=2 * l_pac - (rb + te) if is_rev else rb + tb,
                re=2 * l_pac - (rb + tb) if is_rev else rb + te,
                score=score, truesc=score, csub=score2,
                secondary=-1, w=opt.bandwidth,
            )
            b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
            # insert keeping the list score-sorted
            pos = next(
                (i for i, m in enumerate(mate_regs) if m.score < b.score),
                len(mate_regs),
            )
            mate_regs.insert(pos, b)
            n += 1
    return n


FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MUNMAP = 0x8
FLAG_REVERSE = 0x10
FLAG_MREVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80


def _pairs_prelude(idx: FMIndex, opt: AlignOptions, batch1, out1, batch2,
                   out2):
    """Shared vector front of the two PE finalizers: fast fields per end,
    insert-size stats, the fast-pair mask (single-region both ends and
    provably no mate rescue), and region lists for everything else."""
    from bioseqdb_tpu_torch.align.finalize import (fast_fields,
                                                   frac_rep_of_out,
                                                   maybe_unpack)

    out1 = maybe_unpack(out1)
    out2 = maybe_unpack(out2)

    mat = fill_scmat(opt.match_score, opt.mismatch_penalty)
    max_occ = opt.resolve_max_occ(idx.n_refs)
    n = min(batch1.n, batch2.n)

    frac1 = frac_rep_of_out(out1, batch1.lens, max_occ)
    frac2 = frac_rep_of_out(out2, batch2.lens, max_occ)
    f1 = fast_fields(idx, opt, batch1, out1, frac1)
    f2 = fast_fields(idx, opt, batch2, out2, frac2)
    cand = f1["fast"][:n] & f2["fast"][:n]

    def regs_for(batch, out, i, rid_base):
        q = batch.codes[i, : batch.lens[i]].astype(np.uint8)
        if out["overflow"][i]:
            regs = O.mem_align1(idx, opt, q, rand_id=rid_base + i)
        else:
            frac = (frac1 if rid_base == 0 else frac2)[i]
            regs = regions_to_alnregs(out, i, float(frac))
            regs = O.sort_dedup_patch(idx, opt, q, regs, mat)
            regs = O.mark_primary(opt, regs, rid_base + i)
        return q, regs

    all_regs: dict[int, tuple] = {}
    for i in range(n):
        if not cand[i]:
            all_regs[i] = (regs_for(batch1, out1, i, 0),
                           regs_for(batch2, out2, i, 1 << 20))

    # insert-size stats over ALL pairs: fast rows from the vector fields,
    # the rest from their region lists
    rb1l, rb2l, s1l, s2l = (
        [f1["rb"][:n][cand]], [f2["rb"][:n][cand]], [f1["score"][:n][cand]],
        [f2["score"][:n][cand]],
    )
    for i, ((q1, r1), (q2, r2)) in all_regs.items():
        if r1 and r2:
            rb1l.append([r1[0].rb]); rb2l.append([r2[0].rb])
            s1l.append([r1[0].score]); s2l.append([r2[0].score])
    pes = pestat_arrays(
        np.concatenate([np.asarray(x, np.int64) for x in rb1l]),
        np.concatenate([np.asarray(x, np.int64) for x in rb2l]),
        np.concatenate([np.asarray(x, np.int64) for x in s1l]),
        np.concatenate([np.asarray(x, np.int64) for x in s2l]),
        opt, idx.l_pac,
    )

    # pairs provably skipping mate rescue: for a single-region mate, the
    # rescue loop is a no-op iff every non-failed orientation is exactly
    # the pair's orientation AND the pair's distance is within bounds
    failed = np.array([st.failed for st in pes])
    low = np.array([st.low for st in pes], np.int64)
    high = np.array([st.high for st in pes], np.int64)
    n_active = int((~failed).sum())

    def no_rescue(rb_a, rb_m):
        if n_active == 0:
            return np.ones(len(rb_a), bool)
        d, dist = infer_dir_vec(idx.l_pac, rb_a, rb_m)
        cons = (~failed[d]) & (low[d] <= dist) & (dist <= high[d])
        return cons & (n_active == 1) & (~failed[d])

    fast_pair = cand.copy()
    if cand.any():
        rb1c, rb2c = f1["rb"][:n], f2["rb"][:n]
        nr = np.zeros(n, bool)
        nr[cand] = (no_rescue(rb1c[cand], rb2c[cand])
                    & no_rescue(rb2c[cand], rb1c[cand]))
        fast_pair &= nr

    # rescue-needed candidate rows fall back to the full path
    for i in np.flatnonzero(cand & ~fast_pair):
        i = int(i)
        all_regs[i] = (regs_for(batch1, out1, i, 0),
                       regs_for(batch2, out2, i, 1 << 20))
    return n, mat, f1, f2, pes, fast_pair, all_regs


def _pair_slow_one(idx, opt, mat, pes, name, q1, regs1, q2, regs2,
                   rid1: int = 0, rid2: int = 1 << 20):
    """Full per-pair path (mate rescue + mem_pair) for one template."""
    if any(not st.failed for st in pes):
        n1, n2 = len(regs1), len(regs2)
        for (regs_a, q_m, regs_m) in ((regs1, q2, regs2), (regs2, q1, regs1)):
            if not regs_a:
                continue
            best = regs_a[0].score
            anchors = [
                r for r in regs_a if r.score >= best - opt.pen_unpaired
            ][: opt.max_matesw]
            for a in anchors:
                mem_matesw(idx, opt, pes, a, q_m, regs_m, mat)
        # bwa mem_sam_pe re-runs mem_mark_primary_se AFTER rescue so
        # rescue-inserted regions get secondary marks; without the
        # re-mark a rescued duplicate of an existing region would be
        # emitted as an extra supplementary record (round-4 review)
        if len(regs1) != n1:
            regs1 = O.mark_primary(opt, regs1, rid1)
        if len(regs2) != n2:
            regs2 = O.mark_primary(opt, regs2, rid2)
    return _pair_one(idx, opt, mat, pes, name, q1, regs1, q2, regs2)


def finalize_pairs(
    idx: FMIndex, opt: AlignOptions, batch1, out1, batch2, out2,
) -> list[tuple[ReadResult, ReadResult]]:
    """Pair the two ends of each template and produce per-end results
    with PE flags/MAPQ. batchN/outN as in finalize_batch.

    The dominant case — both ends single-region fast-eligible
    (finalize.fast_fields) and provably not triggering mate rescue —
    runs without building region lists or calling reg2aln: vector window
    math + a light per-pair assembly. Everything else takes the full
    per-read path. Pinned equal by tests/test_paired.py."""
    n, mat, f1, f2, pes, fast_pair, all_regs = _pairs_prelude(
        idx, opt, batch1, out1, batch2, out2)

    results = []
    for i in range(n):
        if fast_pair[i]:
            results.append(
                _fast_pair_one(idx, opt, pes, batch1.names[i], f1, f2, i)
            )
            continue
        (q1, regs1), (q2, regs2) = all_regs[i]
        results.append(_pair_slow_one(idx, opt, mat, pes, batch1.names[i],
                                      q1, regs1, q2, regs2,
                                      rid1=i, rid2=(1 << 20) + i))
    return results


def finalize_pairs_columns(idx: FMIndex, opt: AlignOptions,
                           batch1, out1, batch2, out2):
    """Columnar PE finalize (the throughput path, VERDICT r1 item 5):
    the per-pair Python of `_fast_pair_one` — orientation/insert check,
    erfc pairing bonus, PE MAPQ uplift, flags/TLEN — computed as ARRAYS
    over every fast pair at once; only rescue-candidates/multi-region
    templates run the scalar path (into ``extra``). Returns
    (cols1, cols2): AlignColumns per end with PE columns attached
    (pe_flag/pnext/tlen/rnext_rid). Exactly equal to finalize_pairs
    (tests/test_paired.py::test_columns_pe_equal)."""
    import scipy.special

    from bioseqdb_tpu_torch.align.columns import AlignColumns

    n, mat, f1, f2, pes, fast_pair, all_regs = _pairs_prelude(
        idx, opt, batch1, out1, batch2, out2)
    B = n
    l_pac = idx.l_pac

    def empty_cols(f):
        z32 = lambda: np.zeros(B, np.int32)
        z64 = lambda: np.zeros(B, np.int64)
        return AlignColumns(
            n=B, mapped=np.zeros(B, bool), fast=fast_pair.copy(),
            pos=z64(), ref_end=z64(), rid=z32(), mapq=z32(), nm=z32(),
            score=z32(), sub=np.full(B, -1, np.int32),
            is_rev=np.zeros(B, bool), qb=z64(), qe=z64(),
            text=f.get("text", np.zeros(0, np.uint8)),
            toff=np.full(B, -1, np.int64), cig_len=z32(), md_len=z32(),
            extra={},
            pe_flag=z32(), pnext=z64(), tlen=z64(),
            rnext_rid=np.full(B, -1, np.int32),
        )

    cols1, cols2 = empty_cols(f1), empty_cols(f2)
    rows = np.flatnonzero(fast_pair)
    if rows.size:
        s1 = f1["score"][rows].astype(np.int64)
        s2 = f2["score"][rows].astype(np.int64)
        d, dist = infer_dir_vec(l_pac, f1["rb"][rows], f2["rb"][rows])
        failed = np.array([st.failed for st in pes])
        low = np.array([st.low for st in pes], np.int64)
        high = np.array([st.high for st in pes], np.int64)
        avg = np.array([st.avg for st in pes])
        std = np.array([st.std if st.std else 1.0 for st in pes])
        within = (~failed[d]) & (low[d] <= dist) & (dist <= high[d])
        ns = (dist - avg[d]) / std[d]
        q = np.floor(-4.343 * np.log10(
            2.0 * scipy.special.erfc(np.abs(ns) * (2 ** -0.5)) + 1e-300
        ) + 0.499).astype(np.int64)
        pscore = s1 + s2 + np.maximum(-q, -opt.pen_unpaired)
        score_un = s1 + s2 - opt.pen_unpaired
        paired = within & (pscore > 0) & (pscore > score_un)
        # PE MAPQ uplift (exactly _fast_pair_one's scalar math)
        subo = np.maximum(0, score_un)
        q_pe = np.clip(
            np.floor(6.02 * (pscore - subo) / opt.match_score + 0.499),
            0, 60)
        fr = 0.5 * (f1["frac_rep"][rows] + f2["frac_rep"][rows])
        q_pe = np.floor(q_pe * (1.0 - fr) + 0.499).astype(np.int64)

        def fill_end(cols, f, q_pe, paired):
            q_se = f["mapq"][rows].astype(np.int64)
            mapq = np.where(paired,
                            np.where(q_se > q_pe, q_se,
                                     np.minimum(q_pe, q_se + 40)),
                            q_se)
            cols.mapped[rows] = True
            cols.pos[rows] = f["local"][rows]
            cols.ref_end[rows] = f["local"][rows] + f["ref_consumed"][rows]
            cols.rid[rows] = f["rid"][rows]
            cols.mapq[rows] = mapq
            cols.nm[rows] = f["nm"][rows]
            cols.score[rows] = f["score"][rows]
            cols.sub[rows] = 0  # single region: sub = csub = 0
            cols.is_rev[rows] = f["is_rev"][rows]
            cols.qb[rows] = f["qb"][rows]
            cols.qe[rows] = f["qe"][rows]
            slots = f["tslot"][rows]
            cols.toff[rows] = slots * f["stride"]
            cols.cig_len[rows] = f["cig_len"][slots]
            cols.md_len[rows] = f["md_len"][slots]

        fill_end(cols1, f1, q_pe, paired)
        fill_end(cols2, f2, q_pe, paired)

        # PE columns (exactly _pe_info's scalar logic; fast rows always
        # have both ends mapped)
        same = cols1.rid[rows] == cols2.rid[rows]
        for cols, mate, r1bit in ((cols1, cols2, True), (cols2, cols1, False)):
            flag = np.full(rows.shape[0],
                           FLAG_PAIRED | (FLAG_READ1 if r1bit else FLAG_READ2),
                           np.int32)
            flag |= np.where(mate.is_rev[rows], FLAG_MREVERSE, 0)
            proper = paired & same
            flag |= np.where(proper, FLAG_PROPER, 0)
            cols.pe_flag[rows] = flag
            cols.rnext_rid[rows] = np.where(same, -2, mate.rid[rows])
            cols.pnext[rows] = mate.pos[rows]
            lo = np.minimum(cols.pos[rows], mate.pos[rows])
            hi = np.maximum(cols.ref_end[rows], mate.ref_end[rows])
            tl = hi - lo
            neg = (cols.pos[rows] > mate.pos[rows]) | (
                (cols.pos[rows] == mate.pos[rows])
                & (cols.ref_end[rows] > mate.ref_end[rows]))
            cols.tlen[rows] = np.where(proper, np.where(neg, -tl, tl), 0)

    # slow rows: full per-pair path; results live in extra (the PE
    # emitter renders them through sam_record_pe)
    for i in np.flatnonzero(~fast_pair[:n]).tolist():
        (q1, regs1), (q2, regs2) = all_regs[i]
        r1, r2 = _pair_slow_one(idx, opt, mat, pes, batch1.names[i],
                                q1, regs1, q2, regs2,
                                rid1=i, rid2=(1 << 20) + i)
        cols1.extra[i] = r1
        cols2.extra[i] = r2
        for cols, r in ((cols1, r1), (cols2, r2)):
            h = r.primary
            if h is not None:
                cols.mapped[i] = True
                cols.pos[i] = h.ref_begin
                cols.ref_end[i] = h.ref_end
                cols.rid[i] = h.rid
                cols.mapq[i] = h.mapq
                cols.nm[i] = h.nm
                cols.score[i] = h.score
                cols.sub[i] = h.sub
                cols.is_rev[i] = h.is_reverse
    return cols1, cols2


def _fast_pair_one(idx, opt, pes, name, f1, f2, i):
    """_pair_one for a fast pair: single candidate region per end, no
    rescue; mem_pair degenerates to one orientation/distance check."""
    from bioseqdb_tpu_torch.align.finalize import fast_hit

    l_pac = idx.l_pac
    s1, s2 = int(f1["score"][i]), int(f2["score"][i])
    d, dist = infer_dir(l_pac, int(f1["rb"][i]), int(f2["rb"][i]))
    st = pes[d]
    paired = False
    pscore = 0
    if not st.failed and st.low <= dist <= st.high:
        ns = (dist - st.avg) / st.std
        q = int(
            -4.343 * math.log10(2.0 * math.erfc(abs(ns) * (2 ** -0.5)) + 1e-300)
            + 0.499
        )
        pscore = s1 + s2 + max(-q, -opt.pen_unpaired)
        score_un = s1 + s2 - opt.pen_unpaired
        paired = pscore > 0 and pscore > score_un
    h1 = fast_hit(idx, f1, i, name, None)
    h2 = fast_hit(idx, f2, i, name, None)
    if paired:
        score_un = s1 + s2 - opt.pen_unpaired
        subo = max(0, score_un)
        q_pe = raw_mapq(pscore - subo, opt.match_score)
        q_pe = max(0, min(60, q_pe))
        fr = 0.5 * (float(f1["frac_rep"][i]) + float(f2["frac_rep"][i]))
        q_pe = int(q_pe * (1.0 - fr) + 0.499)
        for hit in (h1, h2):
            q_se = hit.mapq
            hit.mapq = q_se if q_se > q_pe else min(q_pe, q_se + 40)
    res1 = ReadResult(query_name=name, hits=[h1])
    res2 = ReadResult(query_name=name, hits=[h2])
    res1.pe = _pe_info(h1, h2, True, paired)   # type: ignore[attr-defined]
    res2.pe = _pe_info(h2, h1, False, paired)  # type: ignore[attr-defined]
    return res1, res2


def _pair_one(idx, opt, mat, pes, name, q1, regs1, q2, regs2):
    l_pac = idx.l_pac
    z = [0, 0]
    paired = False
    score = sub = n_sub = 0
    if regs1 and regs2:
        score, sub, n_sub, (i1, i2) = mem_pair(opt, l_pac, pes, regs1, regs2)
        if score > 0:
            score_un = regs1[0].score + regs2[0].score - opt.pen_unpaired
            if score > score_un:
                z = [i1, i2]
                paired = True
    ends = []
    supps: list[list[Hit]] = []
    for r, (q, regs) in enumerate(((q1, regs1), (q2, regs2))):
        sup: list[Hit] = []
        if regs:
            reg = regs[z[r]]
            aln = O.reg2aln(idx, opt, q, reg, mat)
            hit = aln_to_hit(idx, aln, reg, name, None)
            ends.append(hit)
            # other primary parts of a split read ride as supplementary
            # records (bwa mem_sam_pe: non-secondary regs besides the
            # paired one get flag 0x800)
            for k, rg_ in enumerate(regs):
                if k == z[r] or rg_.secondary >= 0 or rg_.score < opt.min_score:
                    continue
                a2 = O.reg2aln(idx, opt, q, rg_, mat)
                h2 = aln_to_hit(idx, a2, rg_, name, None)
                h2.is_supplementary = True
                sup.append(h2)
        else:
            ends.append(None)
        supps.append(sup)

    if paired:
        # PE MAPQ uplift (published mem_sam_pe rule)
        score_un = regs1[0].score + regs2[0].score - opt.pen_unpaired
        subo = max(sub, score_un)
        q_pe = raw_mapq(score - subo, opt.match_score)
        if n_sub > 0:
            q_pe -= int(4.343 * math.log(n_sub + 1) + 0.499)
        q_pe = max(0, min(60, q_pe))
        fr = 0.5 * (regs1[0].frac_rep + regs2[0].frac_rep)
        q_pe = int(q_pe * (1.0 - fr) + 0.499)
        for hit in ends:
            if hit is None:
                continue
            q_se = hit.mapq
            hit.mapq = q_se if q_se > q_pe else min(q_pe, q_se + 40)

    h1, h2 = ends
    # bwa caps a non-ALT supplementary record's MAPQ at its end's
    # primary MAPQ (post-uplift); SA tags carry the capped value
    for prim, sup in zip(ends, supps):
        if prim is None:
            continue
        for h in sup:
            if not h.is_alt and h.mapq > prim.mapq:
                h.mapq = prim.mapq
    hits1 = ([h1] if h1 else []) + supps[0]
    hits2 = ([h2] if h2 else []) + supps[1]
    add_sa_tags(hits1)
    add_sa_tags(hits2)
    res1 = ReadResult(query_name=name, hits=hits1)
    res2 = ReadResult(query_name=name, hits=hits2)
    res1.pe = _pe_info(h1, h2, True, paired)   # type: ignore[attr-defined]
    res2.pe = _pe_info(h2, h1, False, paired)  # type: ignore[attr-defined]
    for h in supps[0]:
        h.pe = _pe_info(h, h2, True, paired)
    for h in supps[1]:
        h.pe = _pe_info(h, h1, False, paired)
    return res1, res2


@dataclass
class PEInfo:
    flag_extra: int
    rnext: str
    pnext: int
    tlen: int


def _pe_info(this: Hit | None, mate: Hit | None, is_read1: bool,
             proper: bool) -> PEInfo:
    flag = FLAG_PAIRED | (FLAG_READ1 if is_read1 else FLAG_READ2)
    rnext, pnext, tlen = "*", 0, 0
    if mate is None:
        flag |= FLAG_MUNMAP
    else:
        if mate.is_reverse:
            flag |= FLAG_MREVERSE
        if this is not None and mate.ref_name == this.ref_name:
            rnext = "="
            pnext = mate.ref_begin
            if proper:
                flag |= FLAG_PROPER
                lo = min(this.ref_begin, mate.ref_begin)
                hi = max(this.ref_end, mate.ref_end)
                tlen = hi - lo
                if this.ref_begin > mate.ref_begin or (
                    this.ref_begin == mate.ref_begin and this.ref_end > mate.ref_end
                ):
                    tlen = -tlen
        else:
            rnext = mate.ref_name if mate else "*"
            pnext = mate.ref_begin if mate else 0
    return PEInfo(flag_extra=flag, rnext=rnext, pnext=pnext, tlen=tlen)
