"""Columnar (arrays-first) alignment results.

The TPU-native serving format: one arrays-of-columns record batch
instead of per-read Python objects. Carries exactly the information of
the reference's per-match record (``BwaMatch``, bwa.h:15-30 /
``bwa_result``, bioseqdb--0.0.0.sql:196-212) for each read's PRIMARY
alignment as numpy columns, with CIGAR/MD text in one shared byte blob;
the minority of reads that need the full multi-hit treatment
(secondary/supplementary/XA records, device-cap overflows) keep their
complete ``ReadResult`` in ``extra``.

``finalize_columns`` is the batch finalize entry for throughput-path
callers (the benchmark, the CLI's SAM writer): it skips the per-read
object assembly entirely for fast rows. ``to_results`` materializes the
classic ``list[ReadResult]`` on demand — ``finalize_batch`` semantics.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.result import ReadResult
from bioseqdb_tpu_torch.index.fmindex import FMIndex
from bioseqdb_tpu_torch.io.batch import ReadBatch


@dataclass
class AlignColumns:
    """Primary-alignment columns for a read batch (arrays-first)."""

    n: int
    mapped: np.ndarray       # bool[n] has a reported primary alignment
    fast: np.ndarray         # bool[n] row lives in the columns (else extra)
    pos: np.ndarray          # int64[n] 0-based ref-local begin
    ref_end: np.ndarray      # int64[n] ref-local end (pos + ref consumed)
    rid: np.ndarray          # int32[n] reference row index
    mapq: np.ndarray         # int32[n]
    nm: np.ndarray           # int32[n] edit distance
    score: np.ndarray        # int32[n]
    sub: np.ndarray          # int32[n] sub-optimal score (XS; -1 = none)
    is_rev: np.ndarray       # bool[n]
    qb: np.ndarray           # int64[n] query match begin
    qe: np.ndarray           # int64[n] query match end
    # CIGAR/MD text blob: row i's CIGAR at [toff[i], toff[i]+cig_len[i]),
    # its MD right after (md_len[i] bytes). toff -1 = no text (unmapped
    # or extra row).
    text: np.ndarray         # uint8 blob
    toff: np.ndarray         # int64[n]
    cig_len: np.ndarray      # int32[n]
    md_len: np.ndarray       # int32[n]
    # full per-read results for rows not representable as one primary
    # column row (multi-hit output, overflows). Indexed by row id.
    extra: dict[int, ReadResult]
    # paired-end columns (None for single-end batches; see
    # align/paired.py finalize_pairs_columns): SAM flag bits beyond
    # 0x10, mate position, template length, and the mate reference
    # (-1 = '*', -2 = '=', else the mate's rid)
    pe_flag: np.ndarray | None = None
    pnext: np.ndarray | None = None
    tlen: np.ndarray | None = None
    rnext_rid: np.ndarray | None = None

    def cigar(self, i: int) -> str:
        o = int(self.toff[i])
        if o < 0:
            return ""
        return self.text[o : o + int(self.cig_len[i])].tobytes().decode("ascii")

    def md(self, i: int) -> str:
        o = int(self.toff[i])
        if o < 0:
            return ""
        o += int(self.cig_len[i])
        return self.text[o : o + int(self.md_len[i])].tobytes().decode("ascii")


def finalize_columns(
    idx: FMIndex, opt: AlignOptions, batch: ReadBatch, out: dict,
    all_hits: bool = True,
) -> AlignColumns:
    """Columnar batch finalize: native fast path straight into columns;
    per-read path only for rows the fast path can't represent."""
    from bioseqdb_tpu_torch.align import finalize as F

    out = F.maybe_unpack(out)
    max_occ = opt.resolve_max_occ(idx.n_refs)
    frac_all = F.frac_rep_of_out(out, batch.lens, max_occ)
    f = F.fast_fields(idx, opt, batch, out, frac_all)
    B = len(batch.names)
    fast = f["fast"]

    z32 = lambda: np.zeros(B, np.int32)
    z64 = lambda: np.zeros(B, np.int64)
    cols = AlignColumns(
        n=B, mapped=np.zeros(B, bool), fast=fast.copy(),
        pos=z64(), ref_end=z64(), rid=z32(), mapq=z32(), nm=z32(),
        score=z32(), sub=np.full(B, -1, np.int32),
        is_rev=np.zeros(B, bool), qb=z64(), qe=z64(),
        text=f.get("text", np.zeros(0, np.uint8)),
        toff=np.full(B, -1, np.int64), cig_len=z32(), md_len=z32(),
        extra={},
    )
    if fast.any():
        sel = np.flatnonzero(fast)
        ok = fast[sel] & (f["score"][sel] >= opt.min_score)
        cols.mapped[sel] = ok
        cols.pos[sel] = f["local"][sel]
        cols.ref_end[sel] = f["local"][sel] + f["ref_consumed"][sel]
        cols.rid[sel] = f["rid"][sel]
        cols.mapq[sel] = f["mapq"][sel]
        cols.nm[sel] = f["nm"][sel]
        cols.score[sel] = f["score"][sel]
        cols.sub[sel] = np.where(ok, 0, -1)  # single region: XS:i:0
        cols.is_rev[sel] = f["is_rev"][sel]
        cols.qb[sel] = f["qb"][sel]
        cols.qe[sel] = f["qe"][sel]
        slots = f["tslot"][sel]
        cols.toff[sel] = np.where(
            cols.mapped[sel], slots * f["stride"], -1)
        cols.cig_len[sel] = np.where(cols.mapped[sel], f["cig_len"][slots], 0)
        cols.md_len[sel] = np.where(cols.mapped[sel], f["md_len"][slots], 0)

    # slow rows: run the classic per-read path and mirror the primary
    mat = F.fill_scmat(opt.match_score, opt.mismatch_penalty)
    for i in np.flatnonzero(~fast).tolist():
        q = batch.codes[i, : batch.lens[i]].astype(np.uint8)
        name = batch.names[i]
        if out["overflow"][i]:
            regs = F.O.mem_align1(idx, opt, q, rand_id=i)
            res = F.emit_read_hits(idx, opt, q, regs, mat, name, i, all_hits)
        else:
            regs = F.regions_to_alnregs(out, i, float(frac_all[i]))
            res = F.finalize_read(idx, opt, q, regs, mat, i, name, i,
                                  all_hits)
        cols.extra[i] = res
        h = res.primary
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
            cols.qb[i] = h.query_begin
            cols.qe[i] = h.query_end
    return cols
