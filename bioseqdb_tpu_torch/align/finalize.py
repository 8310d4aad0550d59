"""Host finalization of device-produced candidate regions.

The tail of the per-read pipeline that the reference runs inside
mem_align1/mem_reg2aln (bwa.cpp:149-181): redundancy dedup + colinear
patching, primary/secondary marking, MAPQ, and CIGAR/NM generation via
banded global alignment. Runs on host over the compact region tables
the device pipeline emits (a handful of rows per read); reads flagged
``overflow`` by any device stage fall back to the full host oracle.

Determinism: the reference seeds its primary-marking hash tie-break
with lrand48(); here each read uses its stable batch row id, so results
are reproducible run-to-run and match `cpu.oracle.align_read(rand_id=row)`.
"""

from __future__ import annotations

import numpy as np

from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.result import Hit, ReadResult
from bioseqdb_tpu_torch.cpu import oracle as O
from bioseqdb_tpu_torch.cpu.ksw import cigar_to_string, fill_scmat
from bioseqdb_tpu_torch.index.fmindex import FMIndex
from bioseqdb_tpu_torch.io.batch import ReadBatch


def frac_rep_of(mems: np.ndarray, n_mem: int, max_occ: int, l_query: int) -> float:
    """Repetitive-coverage fraction from the seed intervals
    (mem_chain's l_rep computation over sorted intervals)."""
    if n_mem == 0 or l_query == 0:
        return 0.0
    rows = mems[:n_mem]
    rows = rows[np.lexsort((rows[:, 4], rows[:, 3]))]
    b = e = l_rep = 0
    for k, l, s, start, end in rows:
        if s <= max_occ:
            continue
        if start > e:
            l_rep += e - b
            b, e = int(start), int(end)
        else:
            e = max(e, int(end))
    l_rep += e - b
    return l_rep / l_query


# extend_all's max_regs default (kernels/extend.py): the dense region
# tables are (B, R) with R = 8 everywhere the Aligner drives the device
DEFAULT_MAX_REGS = 8


def maybe_unpack(out: dict, max_regs: int = DEFAULT_MAX_REGS) -> dict:
    """Undo the device-side region packing (pipeline._pack_out).

    Rebuilds the dense (B, R) tables (int16 fields widened to int32 so
    downstream host arithmetic cannot overflow). Reads whose rows fell
    past the pack capacity (off + n_regs > cap) are flagged ``overflow``
    and take the host-oracle path — the packed form drops only their
    rows, never anyone else's."""
    if "off" not in out:
        return out
    off = np.asarray(out["off"]).astype(np.int64)
    n_regs = np.asarray(out["n_regs"])
    nr = np.minimum(n_regs, max_regs).astype(np.int64)
    flat0 = np.asarray(next(iter(out["regs"].values())))
    cap = flat0.shape[0]
    lost = off + nr > cap
    B, R = off.shape[0], max_regs
    valid = (np.arange(R)[None, :] < nr[:, None]) & ~lost[:, None]
    src = (off[:, None] + np.arange(R)[None, :])[valid]
    regs = {}
    for k, flat in out["regs"].items():
        flat = np.asarray(flat)
        dt = np.int64 if flat.dtype == np.int64 else np.int32
        dense = np.zeros((B, R), dt)
        dense[valid] = flat[src].astype(dt)
        regs[k] = dense
    out = dict(out, regs=regs, overflow=np.asarray(out["overflow"]) | lost)
    del out["off"]
    return out


def regions_to_alnregs(out: dict, i: int, frac_rep: float) -> list[O.AlnReg]:
    regs = []
    r = out["regs"]
    for j in range(int(out["n_regs"][i])):
        regs.append(
            O.AlnReg(
                rb=int(r["rb"][i, j]), re=int(r["re"][i, j]),
                qb=int(r["qb"][i, j]), qe=int(r["qe"][i, j]),
                score=int(r["score"][i, j]), truesc=int(r["truesc"][i, j]),
                w=int(r["w"][i, j]), seedlen0=int(r["seedlen0"][i, j]),
                seedcov=int(r["seedcov"][i, j]), frac_rep=frac_rep,
                rid=int(r["rid"][i, j]),
            )
        )
    return regs


def aln_to_hit(
    idx: FMIndex, aln: O.Aln, reg: O.AlnReg, name: str,
    query_id: int | None,
) -> Hit:
    ref_consumed = sum(n for n, op in aln.cigar if op in "MD")
    return Hit(
        ref_id=int(idx.ref_ids[aln.rid]) if len(idx.ref_ids) else aln.rid,
        ref_name=idx.ref_names[aln.rid],
        ref_begin=aln.pos,
        ref_end=aln.pos + ref_consumed,
        query_id=query_id,
        query_name=name,
        query_begin=reg.qb,
        query_end=reg.qe,
        is_primary=reg.secondary < 0,
        is_secondary=reg.secondary >= 0,
        is_reverse=aln.is_rev,
        cigar=cigar_to_string(aln.cigar),
        score=aln.score,
        mapq=aln.mapq,
        nm=aln.NM,
        md=aln.MD,
        # XS only on primary records (bwa mem_reg2sam: sub = -1 when
        # p->secondary >= 0, else max(sub, csub) — reg2aln fills it)
        sub=aln.sub if reg.secondary < 0 else -1,
        rid=aln.rid,
        is_alt=bool(idx.ref_is_alt[aln.rid])
        if 0 <= aln.rid < len(idx.ref_is_alt) else False,
    )


def add_sa_tags(hits: list[Hit]) -> None:
    """SA:Z on every primary part of a split read (bwa mem_aln2sam:
    when other non-secondary hits exist, each non-secondary record
    lists the others as "rname,pos,strand,cigar,mapq,nm;" — the CIGAR
    in its stored soft-clip form). No-op unless >= 2 primary parts."""
    parts = [h for h in hits if not h.is_secondary]
    if len(parts) < 2:
        return
    ent = [
        f"{h.ref_name},{h.ref_begin + 1},{'-' if h.is_reverse else '+'},"
        f"{h.cigar},{h.mapq},{h.nm};"
        for h in parts
    ]
    for k, h in enumerate(parts):
        h.sa = "".join(e for j, e in enumerate(ent) if j != k)


def finalize_read(
    idx: FMIndex, opt: AlignOptions, q: np.ndarray, regs: list[O.AlnReg],
    mat: np.ndarray, rand_id: int, name: str, query_id: int | None,
    all_hits: bool = True,
) -> ReadResult:
    regs = O.sort_dedup_patch(idx, opt, q, regs, mat)
    if len(idx.ref_is_alt):
        for r in regs:
            if 0 <= r.rid < len(idx.ref_is_alt):
                r.is_alt = bool(idx.ref_is_alt[r.rid])
    regs = O.mark_primary(opt, regs, rand_id)
    return emit_read_hits(idx, opt, q, regs, mat, name, query_id, all_hits)


def emit_read_hits(
    idx: FMIndex, opt: AlignOptions, q: np.ndarray, regs: list[O.AlnReg],
    mat: np.ndarray, name: str, query_id: int | None, all_hits: bool = True,
) -> ReadResult:
    """Filter marked regions (min_score, XA_drop_ratio) and build the
    final per-read records — shared by the device path and the host
    oracle fallback so both apply identical output rules."""
    hits: list[Hit] = []
    xa: list[str] = []
    for r in regs:
        if r.score < opt.min_score:
            continue
        if r.secondary >= 0:
            # XA_drop_ratio gate relative to the primary it shadows
            prim = regs[r.secondary]
            if r.score < prim.score * opt.xa_drop_ratio:
                continue
            if not all_hits:
                # bwa-mem default output: alternates go to the primary's
                # XA:Z: tag instead of separate records
                aln = O.reg2aln(idx, opt, q, r, mat)
                from bioseqdb_tpu_torch.cpu.ksw import cigar_to_string

                strand = "-" if aln.is_rev else "+"
                xa.append(
                    f"{idx.ref_names[aln.rid]},{strand}{aln.pos + 1},"
                    f"{cigar_to_string(aln.cigar)},{aln.NM}"
                )
                continue
        aln = O.reg2aln(idx, opt, q, r, mat)
        hits.append(aln_to_hit(idx, aln, r, name, query_id))
    # non-first primary parts of a chimeric read are supplementary
    # (mem_reg2sam: `if (l && p->secondary < 0) flag |= 0x800`)
    first_primary = None
    for h in hits:
        if not h.is_secondary:
            if first_primary is not None:
                h.is_supplementary = True
                # bwa mem_reg2sam caps a non-ALT supplementary record's
                # MAPQ at the first primary's (the SA tag below carries
                # the capped value)
                if not h.is_alt and h.mapq > first_primary.mapq:
                    h.mapq = first_primary.mapq
            else:
                first_primary = h
    add_sa_tags(hits)
    res = ReadResult(query_name=name, hits=hits)
    if xa and hits and len(xa) <= opt.max_xa_hits:
        hits[0].xa = ";".join(xa) + ";"
    return res


def frac_rep_batch(mems: np.ndarray, n_mem: np.ndarray, max_occ: int,
                   lens: np.ndarray) -> np.ndarray:
    """Vectorized frac_rep_of over the whole batch: union length of the
    query spans of high-occurrence seed intervals."""
    B, M, _ = mems.shape
    mm = np.arange(M)[None, :]
    valid = (mm < n_mem[:, None]) & (mems[:, :, 2] > max_occ)
    start = np.where(valid, mems[:, :, 3], 1 << 20).astype(np.int64)
    end = np.where(valid, mems[:, :, 4], 1 << 20).astype(np.int64)
    key = start * (1 << 21) + end
    order = np.argsort(key, axis=1)
    ss = np.take_along_axis(start, order, axis=1)
    ee = np.take_along_axis(end, order, axis=1)
    vv = np.take_along_axis(valid, order, axis=1)
    run = np.maximum.accumulate(np.where(vv, ee, 0), axis=1)
    prev = np.concatenate([np.zeros((B, 1), np.int64), run[:, :-1]], axis=1)
    contrib = np.where(vv, np.maximum(ee - np.maximum(ss, prev), 0), 0)
    l_rep = contrib.sum(axis=1)
    return np.where(lens > 0, l_rep / np.maximum(lens, 1), 0.0)


def fast_fields(
    idx: FMIndex, opt: AlignOptions, batch: ReadBatch, out: dict,
    frac_rep: np.ndarray,
) -> dict:
    """Vectorized finalize fields for every single-region read.

    With exactly one candidate region, mem_sort_dedup_patch and
    mem_mark_primary_se are no-ops (the region stays primary with
    sub = csub = sub_n = 0), so the whole per-read tail reduces to
    mem_reg2aln — run batched: MAPQ/rid math vectorized here, and
    everything per-row (oriented window extraction from codes/pac, band
    inference, banded global alignment with the band-doubling retry,
    NM/MD, CIGAR text, position) in one native OpenMP call
    (index/native/finalize1.cpp:finalize_fast2_c).

    Must agree exactly with the per-read path (tests/test_finalize_fast).
    Returns a dict of per-row vectors with a ``fast`` eligibility mask;
    CIGAR/MD text lives in a compact blob (``text``/``stride``/``tslot``
    + ``cig_len``/``md_len``) decoded on demand by ``fast_cigar_md`` —
    ``fast_hit``/SE & PE assemblers build Hits from it."""
    from bioseqdb_tpu_torch.index.native.build import finalize_fast2

    r = out["regs"]
    B = len(batch.names)
    n_regs = np.asarray(out["n_regs"])[:B]
    overflow = np.asarray(out["overflow"])[:B]
    lens = np.asarray(batch.lens).astype(np.int64)[:B]
    qb = np.asarray(r["qb"])[:B, 0].astype(np.int64)
    qe = np.asarray(r["qe"])[:B, 0].astype(np.int64)
    rb = np.asarray(r["rb"])[:B, 0].astype(np.int64)
    re = np.asarray(r["re"])[:B, 0].astype(np.int64)
    score = np.asarray(r["score"])[:B, 0].astype(np.int64)
    truesc = np.asarray(r["truesc"])[:B, 0]
    w_reg = np.asarray(r["w"])[:B, 0]
    Lq = qe - qb
    Lt = re - rb
    a, b = opt.match_score, opt.mismatch_penalty
    n = idx.seq_len
    l_pac = idx.l_pac
    is_rev = rb >= l_pac
    # the target window must not bridge the forward/reverse junction,
    # and a pathological span mismatch goes to the per-read path
    in_strand = np.where(is_rev, rb >= l_pac, re <= l_pac)
    fast = (
        (~overflow) & (n_regs == 1) & (Lq > 0) & (Lt > 0) & in_strand
        & (Lt <= Lq + (opt.bandwidth << 2) + 16)
    )
    f = dict(fast=fast, L=Lq, qb=qb, qe=qe, rb=rb, re=re, score=score,
             frac_rep=np.asarray(frac_rep)[:B])
    if not fast.any():
        return f
    sel = np.flatnonzero(fast)

    mat = fill_scmat(a, b)
    (text, stride, cig_len, md_len, nm_s, lead_d_s, rcons_s, pos_s,
     clip5_s, clip3_s, status) = finalize_fast2(
        sel, np.asarray(batch.codes), lens, np.asarray(idx.pac), l_pac, n,
        qb, qe, rb, re, truesc, w_reg, mat,
        opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, a, opt.bandwidth,
    )
    if (status != 0).any():  # native buffer overflow: per-read fallback
        fast[sel[status != 0]] = False

    def scatter(vals, dtype=np.int64):
        full = np.zeros(B, dtype)
        full[sel] = vals
        return full

    nm = scatter(nm_s)
    lead_d = scatter(lead_d_s)
    ref_consumed = scatter(rcons_s)
    clip5 = np.where(is_rev, lens - qe, qb)
    clip3 = np.where(is_rev, qb, lens - qe)
    # text blob slot per batch row (-1 = none); CIGAR/MD decoded lazily
    tslot = np.full(B, -1, np.int64)
    tslot[sel] = np.arange(sel.shape[0])

    # ---- MAPQ (approx_mapq with sub=csub=0, sub_n=0) ----
    sub = float(opt.min_seed_len * a)
    lmax = np.maximum(Lq, Lt).astype(np.float64)
    identity = 1.0 - (lmax * a - score) / (a + b) / np.maximum(lmax, 1)
    tmp = np.where(lmax < 50, 1.0, np.log(50) / np.log(np.maximum(lmax, 2)))
    tmp *= identity * identity
    mapq = np.floor(6.02 * (score - sub) / a * tmp * tmp + 0.499)
    mapq = np.clip(mapq, 0, 60)
    mapq = np.floor(mapq * (1.0 - f["frac_rep"]) + 0.499).astype(np.int64)
    mapq = np.where(sub >= score, 0, mapq)
    mapq = np.where(score == 0, 0, mapq)

    # ---- position / rid (after the leading-D squeeze shift) ----
    pos = np.where(is_rev, n - re, rb) + lead_d
    rid = np.searchsorted(np.asarray(idx.ref_offsets), pos, side="right") - 1
    local = pos - np.asarray(idx.ref_offsets)[rid]
    f.update(is_rev=is_rev, nm=nm, mapq=mapq, rid=rid, local=local,
             clip5=clip5, clip3=clip3, ref_consumed=ref_consumed,
             text=text, stride=stride, tslot=tslot,
             cig_len=cig_len, md_len=md_len)
    return f


def fast_cigar_md(f: dict, i: int) -> tuple[str, str]:
    """Decode row ``i``'s CIGAR and MD strings from the fast-finalize
    text blob (built natively by finalize_fast2_c)."""
    k = int(f["tslot"][i])
    if k < 0:
        return "", ""
    off = k * f["stride"]
    cl = int(f["cig_len"][k])
    ml = int(f["md_len"][k])
    blob = f["text"]
    cig = blob[off : off + cl].tobytes().decode("ascii")
    md = blob[off + cl : off + cl + ml].tobytes().decode("ascii")
    return cig, md


def fast_hit(idx: FMIndex, f: dict, i: int, name: str,
             query_id: int | None) -> Hit:
    """Assemble the Hit for single-region row ``i`` from the vectorized
    fields (CIGAR/MD text decoded from the native batch's blob)."""
    rid = int(f["rid"][i])
    local = int(f["local"][i])
    cigar, md = fast_cigar_md(f, i)
    return Hit(
        ref_id=int(idx.ref_ids[rid]) if len(idx.ref_ids) else rid,
        ref_name=idx.ref_names[rid],
        ref_begin=local,
        ref_end=local + int(f["ref_consumed"][i]),
        query_id=query_id,
        query_name=name,
        query_begin=int(f["qb"][i]),
        query_end=int(f["qe"][i]),
        is_primary=True,
        is_secondary=False,
        is_reverse=bool(f["is_rev"][i]),
        cigar=cigar,
        score=int(f["score"][i]),
        mapq=int(f["mapq"][i]),
        nm=int(f["nm"][i]),
        md=md,
        sub=0,  # single region: sub = csub = 0 (XS:i:0, like bwa)
        rid=rid,
    )


def _finalize_fast(
    idx: FMIndex, opt: AlignOptions, batch: ReadBatch, out: dict,
    frac_rep: np.ndarray, with_query_ids: bool,
) -> tuple[np.ndarray, list[ReadResult | None]]:
    f = fast_fields(idx, opt, batch, out, frac_rep)
    fast = f["fast"]
    results: list[ReadResult | None] = [None] * len(batch.names)
    if not fast.any():
        return fast, results
    # bulk-pull columns to Python scalars once; per-row numpy indexing
    # costs ~1 us/field and dominates at batch scale
    rows = np.flatnonzero(fast)
    ref_names = idx.ref_names
    ref_ids = idx.ref_ids.tolist() if len(idx.ref_ids) else None
    cols = {k: f[k][rows].tolist() for k in (
        "rid", "local", "ref_consumed", "qb", "qe", "is_rev", "score",
        "mapq", "nm")}
    blob = f["text"]  # uint8; slice views decode per row (no full copy)
    stride = f["stride"]
    tslots = f["tslot"][rows].tolist()
    cig_lens = f["cig_len"].tolist()
    md_lens = f["md_len"].tolist()
    min_score = opt.min_score
    names = batch.names
    for k, i in enumerate(rows.tolist()):
        name = names[i]
        if cols["score"][k] < min_score:
            results[i] = ReadResult(query_name=name, hits=[])
            continue
        rid = cols["rid"][k]
        local = cols["local"][k]
        slot = tslots[k]
        off = slot * stride
        cl = cig_lens[slot]
        ml = md_lens[slot]
        results[i] = ReadResult(query_name=name, hits=[Hit(
            ref_id=ref_ids[rid] if ref_ids is not None else rid,
            ref_name=ref_names[rid],
            ref_begin=local,
            ref_end=local + cols["ref_consumed"][k],
            query_id=i if with_query_ids else None,
            query_name=name,
            query_begin=cols["qb"][k],
            query_end=cols["qe"][k],
            is_primary=True,
            is_secondary=False,
            is_reverse=bool(cols["is_rev"][k]),
            cigar=blob[off : off + cl].tobytes().decode("ascii"),
            score=cols["score"][k],
            mapq=cols["mapq"][k],
            nm=cols["nm"][k],
            md=blob[off + cl : off + cl + ml].tobytes().decode("ascii"),
            sub=0,  # single region: sub = csub = 0 (XS:i:0, like bwa)
            rid=rid,
        )])
    return fast, results


def frac_rep_of_out(out: dict, lens: np.ndarray, max_occ: int) -> np.ndarray:
    """frac_rep per read from the pipeline output: the device-computed
    l_rep column when present (default), else the host reduction over
    the raw mems tables (keep_mems runs)."""
    lens = np.asarray(lens)
    if out.get("l_rep") is not None:
        l_rep = np.asarray(out["l_rep"])[: len(lens)].astype(np.int64)
        return np.where(lens > 0, l_rep / np.maximum(lens, 1), 0.0)
    return frac_rep_batch(np.asarray(out["mems"]), np.asarray(out["n_mem"]),
                          max_occ, lens)


def finalize_batch(
    idx: FMIndex, opt: AlignOptions, batch: ReadBatch, out: dict,
    with_query_ids: bool = True, all_hits: bool = True,
) -> list[ReadResult]:
    out = maybe_unpack(out)
    mat = fill_scmat(opt.match_score, opt.mismatch_penalty)
    max_occ = opt.resolve_max_occ(idx.n_refs)
    frac_all = frac_rep_of_out(out, batch.lens, max_occ)
    fast, results = _finalize_fast(idx, opt, batch, out, frac_all,
                                   with_query_ids)
    for i, name in enumerate(batch.names):
        if results[i] is not None:
            continue
        q = batch.codes[i, : batch.lens[i]].astype(np.uint8)
        qid = i if with_query_ids else None
        if out["overflow"][i]:
            # device caps exceeded: run the whole read on the host oracle,
            # then apply the same output rules as the device path
            regs = O.mem_align1(idx, opt, q, rand_id=i)
            results[i] = emit_read_hits(idx, opt, q, regs, mat, name, qid,
                                        all_hits)
            continue
        regs = regions_to_alnregs(out, i, float(frac_all[i]))
        results[i] = finalize_read(idx, opt, q, regs, mat, i, name, qid,
                                   all_hits)
    return results
