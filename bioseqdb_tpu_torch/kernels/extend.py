"""Seed extension (bwa mem_chain2aln) on torch tensors.

The port of ``bioseqdb_tpu/kernels/extend.py`` ``extend_all``: seeds are
visited in the reference order (kept chains by descending weight, seeds
by descending score, ties to the later seed; the score is the seed-SW
filter's where it ran, else length x match); each is skipped when an
accumulated region covers it (with the overlap-rescue test) or extended
left and right by the banded SW, with bwa's band-doubling retry. The
per-read sequential loop becomes global rounds: every lane scans to its
next seed to extend, then one batched SW call serves all active lanes.

``sw_one`` launches the hand-written CUDA kernel (``sw_cuda.py``) for
tensors on a CUDA device, and the plain ``sw.sw_extend_batch`` only for
tensors on the CPU. The SW lanes are sorted by expected DP row count
before the kernel (a permutation: results are identical).
"""

from __future__ import annotations

import torch

from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels.kmer import doubled_codes
from bioseqdb_tpu_torch.kernels.rows import pick_row, put_row
from bioseqdb_tpu_torch.kernels.sw import sw_extend_batch
from bioseqdb_tpu_torch.kernels.sw_cuda import sw_extend_cuda

SCAN_CHUNK = 8   # containment-scan steps between live-lane checks


def window_doubled(pac_rows, seq_len: int, pos: torch.Tensor) -> torch.Tensor:
    """Codes of the doubled text at int positions ``pos``; positions
    outside [0, seq_len) read 4."""
    pos = pos.to(torch.int64)
    code = doubled_codes(pac_rows, pos)
    return torch.where((pos >= 0) & (pos < seq_len), code, 4).to(torch.int32)


def cal_max_gap(qlen, match_score, o_del, e_del, o_ins, e_ins, bandwidth):
    f32 = lambda x: x.to(torch.float32)
    l_del = (f32(qlen * match_score - o_del) / float(e_del) + 1.0).to(torch.int32)
    l_ins = (f32(qlen * match_score - o_ins) / float(e_ins) + 1.0).to(torch.int32)
    return torch.maximum(l_del, l_ins).clamp(min=1).clamp(max=bandwidth << 1)


def extend_all(fm: kfm.FMDevice, pac_rows, codes, lens, seeds: dict,
               chains: dict, flt: dict, mat, match_score: int,
               mismatch_penalty: int, o_del: int, e_del: int, o_ins: int,
               e_ins: int, bandwidth: int, zdrop: int, pen_clip5: int,
               pen_clip3: int, max_rounds: int = 6, max_regs: int = 8) -> dict:
    """Run the extension stage. Returns the per-read region table
    (rb/re/qb/qe/score/truesc/w/seedlen0/cchain/rid/seedcov int32[B, R])
    with n_regs and overflow."""
    B, S = seeds["rbeg"].shape
    C = chains["pos"].shape[1]
    R = max_regs
    dev = codes.device
    i32 = torch.int32
    W = codes.shape[1]
    max_qlen = W
    # a window spans the read plus the band-bounded gap on both sides
    max_tlen = W + 4 * bandwidth + 64
    seq_len, l_pac = fm.seq_len, fm.l_pac
    codes = codes.to(i32)
    lens = lens.to(i32)
    slen = seeds["len"]

    # ---- the global seed processing order ----
    ci = chains["assign"]
    in_chain = ci >= 0
    cis = ci.clamp(0, C - 1)
    crank = torch.gather(torch.argsort(flt["order"], dim=1, stable=True), 1,
                         cis.long())
    ckept = torch.gather(flt["kept"], 1, cis.long()) > 0
    usable = in_chain & ckept & seeds["valid"]
    sidx = torch.arange(S, device=dev)[None, :]
    # seed score: len * match, unless the long-read seed-SW filter
    # (kernels/seedsw.py) re-scored it (bwa's s->score)
    sscore = seeds.get("score")
    if sscore is None:
        sscore = slen * match_score
    key = (crank * (1 << 19)
           + (4095 - sscore.clamp(0, 4095)) * (1 << 7)
           + (S - 1 - sidx))
    key = torch.where(usable, key, 0x7FFFFFF0)
    order = torch.argsort(key, dim=1, stable=True)
    n_usable = usable.sum(1, dtype=i32)

    # ---- per-chain rmax windows ----
    qbeg, rbeg = seeds["qbeg"], seeds["rbeg"]
    qlen_rem = lens[:, None] - qbeg - slen
    gap_l = cal_max_gap(qbeg, match_score, o_del, e_del, o_ins, e_ins, bandwidth)
    gap_r = cal_max_gap(qlen_rem, match_score, o_del, e_del, o_ins, e_ins,
                        bandwidth)
    big = (2**31 - 1) // 2
    b_all = torch.where(in_chain, rbeg - (qbeg + gap_l), big)
    e_all = torch.where(in_chain, rbeg + slen + qlen_rem + gap_r, 0)
    rmax0 = torch.full((B, C), big, dtype=i32, device=dev).scatter_reduce(
        1, cis.long(), b_all.to(i32), "amin")
    rmax1 = torch.zeros(B, C, dtype=i32, device=dev).scatter_reduce(
        1, cis.long(), e_all.to(i32), "amax")
    rmax0 = rmax0.clamp(min=0)
    rmax1 = rmax1.clamp(max=seq_len)
    cfirst = chains["f_rbeg"]
    crosses = (rmax0 < l_pac) & (l_pac < rmax1)
    rmax1 = torch.where(crosses & (cfirst < l_pac), l_pac, rmax1)
    rmax0 = torch.where(crosses & (cfirst >= l_pac), l_pac, rmax0)
    # clip to the reference holding the first seed (bns_fetch_seq)
    crid = chains["rid"].long().clamp(0, fm.ref_offsets.shape[0] - 1)
    roff = fm.ref_offsets[crid]
    rlen_ref = fm.ref_lens[crid]
    mid_rev = cfirst >= l_pac
    rmax0 = torch.maximum(rmax0, torch.where(
        mid_rev, seq_len - (roff + rlen_ref), roff))
    rmax1 = torch.minimum(rmax1, torch.where(
        mid_rev, seq_len - roff, roff + rlen_ref))

    # ---- extension rounds ----
    zr = lambda v=0: torch.full((B, R), v, dtype=i32, device=dev)
    regs = dict(rb=zr(), re=zr(), qb=zr(), qe=zr(), score=zr(), truesc=zr(),
                w=zr(), seedlen0=zr(), cchain=zr(-1), rid=zr(-1))
    n_regs = torch.zeros(B, dtype=i32, device=dev)
    cursor = torch.zeros(B, dtype=i32, device=dev)
    was_ext = torch.zeros(B, S, dtype=torch.bool, device=dev)
    overflow = torch.zeros(B, dtype=torch.bool, device=dev)
    wcols = torch.arange(max_qlen, device=dev)[None, :]
    tcols = torch.arange(max_tlen, device=dev)[None, :]
    rr = torch.arange(R, device=dev)[None, :]
    gap = lambda x: cal_max_gap(x, match_score, o_del, e_del, o_ins, e_ins,
                                bandwidth)

    def scan_body(cursor, decided):
        slot = pick_row(order, cursor.clamp(0, S - 1))
        active = (cursor < n_usable) & ~decided
        sq = pick_row(qbeg, slot)[:, None]
        sr = pick_row(rbeg, slot)[:, None]
        sl = pick_row(slen, slot)[:, None]
        inside = ((rr < n_regs[:, None])
                  & (sr >= regs["rb"]) & (sr + sl <= regs["re"])
                  & (sq >= regs["qb"]) & (sq + sl <= regs["qe"])
                  & ((sl - regs["seedlen0"]) <= (lens[:, None] // 10)))
        qd = sq - regs["qb"]
        rd = sr - regs["rb"]
        wlim = torch.minimum(gap(torch.minimum(qd, rd)), regs["w"])
        near1 = ((qd - rd) < wlim) & ((rd - qd) < wlim)
        qd2 = regs["qe"] - (sq + sl)
        rd2 = regs["re"] - (sr + sl)
        wlim2 = torch.minimum(gap(torch.minimum(qd2, rd2)), regs["w"])
        near2 = ((qd2 - rd2) < wlim2) & ((rd2 - qd2) < wlim2)
        covered = (inside & (near1 | near2)).any(1)
        # overlap rescue: an extended same-chain seed of similar length
        # on a different diagonal
        cand = was_ext & (cis == pick_row(cis, slot)[:, None]) & seeds["valid"]
        c1 = ((sq <= qbeg) & ((sq + sl - qbeg) >= (sl >> 2))
              & ((qbeg - sq) != (rbeg - sr)))
        c2 = ((qbeg <= sq) & ((qbeg + slen - sq) >= (sl >> 2))
              & ((sq - qbeg) != (sr - rbeg)))
        simlen = slen >= (sl * 19 + 19) // 20
        need = (cand & simlen & (c1 | c2)).any(1)
        skip = active & covered & ~need
        cursor = torch.where(skip, cursor + 1, cursor)
        decided = decided | (active & ~skip) | (cursor >= n_usable)
        return cursor, decided

    def containment_scan(cursor):
        decided = torch.zeros(B, dtype=torch.bool, device=dev)
        while not bool(decided.all()):
            for _ in range(SCAN_CHUNK):
                cursor, decided = scan_body(cursor, decided)
        return cursor, pick_row(order, cursor.clamp(0, S - 1)), cursor < n_usable

    def sw_one(qbuf, qn, tbuf, tn, w, bonus, h0, max_w):
        if qbuf.is_cuda:
            return sw_extend_cuda(
                qbuf, qn, tbuf, tn, w, h0, match_score=match_score,
                mismatch_penalty=mismatch_penalty, o_del=o_del, e_del=e_del,
                o_ins=o_ins, e_ins=e_ins, end_bonus=bonus, zdrop=zdrop,
                max_w=max_w)
        return sw_extend_batch(qbuf, qn, tbuf, tn, mat, o_del, e_del, o_ins,
                               e_ins, w, bonus, zdrop, h0, max_qlen)

    def sw_with_retry(qbuf, qn, tbuf, tn, h0, bonus, active, prev_sc):
        """One ksw_extend with bwa's band doubling: retry at twice the
        band iff the score moved and the max offset filled the band."""
        qn_a = torch.where(active, qn, 0).to(i32)
        w1 = torch.full((B,), bandwidth, dtype=i32, device=dev)
        perm = None
        if qbuf.is_cuda:
            # rows until the band empties ~ min(tlen, qlen + band); idle
            # lanes last
            work = torch.where(qn_a > 0, torch.minimum(tn, qn_a + bandwidth),
                               -1)
            perm = torch.argsort(-work, stable=True)
            qbuf, qn_a, tbuf, tn, h0, prev_sc, active = (
                x[perm].contiguous() for x in
                (qbuf, qn_a, tbuf, tn, h0, prev_sc, active))
        r1 = sw_one(qbuf, qn_a, tbuf, tn, w1, bonus, h0, bandwidth)
        retry = (active & (r1["score"] != prev_sc)
                 & (r1["max_off"] >= ((w1 >> 1) + (w1 >> 2))))
        out = r1
        aw = w1
        if bool(retry.any()):
            w2 = w1 * 2
            r2 = sw_one(qbuf, torch.where(retry, qn_a, 0).to(i32), tbuf, tn,
                        w2, bonus, h0, 2 * bandwidth)
            out = {k: torch.where(retry, r2[k], r1[k]) for k in r1}
            aw = torch.where(retry, w2, w1)
        if perm is not None:
            inv = torch.argsort(perm)
            out = {k: v[inv] for k, v in out.items()}
            aw = aw[inv]
        return out, aw

    def extend_round(regs, n_regs, cursor, was_ext, act, slot):
        sq = pick_row(qbeg, slot)
        sr = pick_row(rbeg, slot)
        sl = pick_row(slen, slot)
        c = pick_row(cis, slot)
        r0 = pick_row(rmax0, c)
        r1_ = pick_row(rmax1, c)

        # ---- left extension: reversed query prefix vs reversed target ----
        lq = sq
        lt = sr - r0
        qidx = (sq[:, None] - 1 - wcols)
        qbuf_l = torch.gather(codes, 1, qidx.clamp(0, W - 1))
        qbuf_l = torch.where(wcols < lq[:, None], qbuf_l, 4).to(i32)
        traw_l = window_doubled(pac_rows, seq_len, sr[:, None] - 1 - tcols)
        tbuf_l = torch.where(tcols < lt[:, None], traw_l, 4).to(i32)
        has_l = act & (lq > 0)
        resL, awL = sw_with_retry(
            qbuf_l, lq, tbuf_l, torch.where(has_l, lt, 0).to(i32),
            (sl * match_score).to(i32), pen_clip5, has_l,
            torch.full((B,), -1, dtype=i32, device=dev))
        local_l = ((resL["gscore"] <= 0)
                   | (resL["gscore"] <= resL["score"] - pen_clip5))
        qb = torch.where(has_l & local_l, sq - resL["qle"], 0)
        rb = torch.where(has_l, torch.where(local_l, sr - resL["tle"],
                                            sr - resL["gtle"]), sr)
        score_l = torch.where(has_l, resL["score"], sl * match_score)
        truesc_l = torch.where(
            has_l, torch.where(local_l, resL["score"], resL["gscore"]),
            sl * match_score)

        # ---- right extension ----
        qe0 = sq + sl
        rq = lens - qe0
        re0 = sr + sl
        rt = r1_ - re0
        qidx = qe0[:, None] + wcols
        qbuf_r = torch.where(qidx < W, torch.gather(
            codes, 1, qidx.clamp(0, W - 1)), 4)
        qbuf_r = torch.where(wcols < rq[:, None], qbuf_r, 4).to(i32)
        traw_r = window_doubled(pac_rows, seq_len, re0[:, None] + tcols)
        tbuf_r = torch.where(tcols < rt[:, None], traw_r, 4).to(i32)
        has_r = act & (rq > 0)
        resR, awR = sw_with_retry(
            qbuf_r, rq, tbuf_r, torch.where(has_r, rt, 0).to(i32),
            score_l.to(i32), pen_clip3, has_r, score_l.to(i32))
        local_r = ((resR["gscore"] <= 0)
                   | (resR["gscore"] <= resR["score"] - pen_clip3))
        qe = torch.where(has_r, torch.where(local_r, qe0 + resR["qle"], lens),
                         qe0)
        re = torch.where(has_r, torch.where(local_r, re0 + resR["tle"],
                                            re0 + resR["gtle"]), re0)
        score = torch.where(has_r, resR["score"], score_l)
        truesc = truesc_l + torch.where(
            has_r, torch.where(local_r, resR["score"], resR["gscore"])
            - score_l, 0)
        aw = torch.maximum(torch.where(has_l, awL, bandwidth),
                           torch.where(has_r, awR, bandwidth))

        slot_r = n_regs.clamp(max=R - 1)
        regs = dict(regs)
        for name, v in (("rb", rb), ("re", re), ("qb", qb), ("qe", qe),
                        ("score", score), ("truesc", truesc), ("w", aw),
                        ("seedlen0", sl), ("cchain", c),
                        ("rid", pick_row(chains["rid"], c))):
            regs[name] = put_row(regs[name], slot_r, v, act)
        n_regs = n_regs + act.to(i32)
        was_ext = was_ext | ((sidx == slot[:, None]) & act[:, None])
        cursor = torch.where(act, cursor + 1, cursor)
        return regs, n_regs, cursor, was_ext

    for _ in range(max_rounds):
        cursor, slot, todo = containment_scan(cursor)
        ovf_now = todo & (n_regs >= R)
        overflow = overflow | ovf_now
        act = todo & ~ovf_now
        if bool(act.any()):
            regs, n_regs, cursor, was_ext = extend_round(
                regs, n_regs, cursor, was_ext, act, slot)
    overflow = overflow | (cursor < n_usable)

    # seedcov per region: seeds of the region's chain fully inside it
    okc = ((seeds["valid"] & in_chain)[:, :, None]
           & (cis[:, :, None] == regs["cchain"][:, None, :]))
    q3, r3, l3 = qbeg[:, :, None], rbeg[:, :, None], slen[:, :, None]
    inside = (okc & (q3 >= regs["qb"][:, None]) & (q3 + l3 <= regs["qe"][:, None])
              & (r3 >= regs["rb"][:, None]) & (r3 + l3 <= regs["re"][:, None]))
    regs["seedcov"] = torch.where(inside, l3, 0).sum(1, dtype=i32)
    return dict(regs=regs, n_regs=n_regs, overflow=overflow)
