"""SAM emission.

The finalize stage the reference delegates to htslib macros + the SQL
tuplestore (bwa.cpp:70-77 cigar_compressed_to_string; extension.cpp:282-305
build_tuple_bwa). Emits SAM 1.6 text records; the correctness gate is
record equality against the CPU oracle on the staged configs
(BASELINE.md).
"""

from __future__ import annotations

from typing import Iterable

from bioseqdb_tpu_torch.align.result import Hit, ReadResult
from bioseqdb_tpu_torch.index.fmindex import FMIndex

FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100  # BAM_FSECONDARY — bwa.cpp:169-170
FLAG_SUPPLEMENTARY = 0x800

_COMP = str.maketrans("ACGTNWSMKRYBDHV", "TGCANWSKMYRVHDB")


def revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def sam_header(index: FMIndex, program_args: str = "",
               read_group: str | None = None) -> str:
    lines = ["@HD\tVN:1.6\tSO:unsorted"]
    for name, length in zip(index.ref_names, index.ref_lens):
        lines.append(f"@SQ\tSN:{name}\tLN:{int(length)}")
    if read_group:
        # bwa mem -R semantics: a full @RG line with literal \t separators
        lines.append(read_group.replace("\\t", "\t"))
    pg = "@PG\tID:bioseqdb-tpu\tPN:bioseqdb-tpu\tVN:0.1.0"
    if program_args:
        pg += f"\tCL:{program_args}"
    lines.append(pg)
    return "\n".join(lines) + "\n"


def hit_flag(hit: Hit) -> int:
    flag = 0
    if hit.is_reverse:
        flag |= FLAG_REVERSE
    if hit.is_secondary:
        flag |= FLAG_SECONDARY
    if getattr(hit, "is_supplementary", False):
        flag |= FLAG_SUPPLEMENTARY
    return flag


def rg_id(read_group: str | None) -> str | None:
    """The ID field of an ``@RG`` header line (bwa mem -R): the value
    every record's RG:Z tag carries."""
    if not read_group:
        return None
    for fld in read_group.replace("\\t", "\t").split("\t"):
        if fld.startswith("ID:"):
            return fld[3:]
    return None


def _tail_tags(hit: Hit, rg: str | None) -> list[str]:
    """Optional tags in bwa's mem_aln2sam order: NM, MD, AS, XS, RG,
    SA, XA (reference behavior source: mem_reg2aln consumed at
    bwa.cpp:158)."""
    fields = [f"NM:i:{getattr(hit, 'nm', 0)}"]
    if getattr(hit, "md", ""):
        fields.append(f"MD:Z:{hit.md}")
    fields.append(f"AS:i:{hit.score}")
    if getattr(hit, "sub", -1) >= 0:
        fields.append(f"XS:i:{hit.sub}")
    if rg:
        fields.append(f"RG:Z:{rg}")
    if getattr(hit, "sa", ""):
        fields.append(f"SA:Z:{hit.sa}")
    if getattr(hit, "xa", ""):
        fields.append(f"XA:Z:{hit.xa}")
    return fields


def _clip_lens(cigar: str) -> tuple[int, int]:
    """(leading, trailing) soft-clip lengths of a CIGAR string."""
    lead = trail = 0
    i = 0
    while i < len(cigar) and cigar[i].isdigit():
        i += 1
    if i < len(cigar) and cigar[i] == "S":
        lead = int(cigar[:i])
    if cigar.endswith("S"):
        j = len(cigar) - 2
        while j >= 0 and cigar[j].isdigit():
            j -= 1
        trail = int(cigar[j + 1 : -1])
    return lead, trail


def hard_clip(hit: Hit, out_seq: str, out_qual: str) -> tuple[str, str, str]:
    """bwa mem_aln2sam's supplementary-record convention: clip ops
    render as H instead of S and SEQ/QUAL are trimmed to the aligned
    span (skipped for ALT-contig hits, which stay soft-clipped).
    Returns (cigar, seq, qual) as they should print."""
    if not getattr(hit, "is_supplementary", False) or getattr(
            hit, "is_alt", False):
        return hit.cigar, out_seq, out_qual
    lead, trail = _clip_lens(hit.cigar)
    if lead or trail:
        out_seq = out_seq[lead : len(out_seq) - trail]
        if out_qual != "*":
            out_qual = out_qual[lead : len(out_qual) - trail]
    return hit.cigar.replace("S", "H"), out_seq, out_qual


def sam_record(result: ReadResult, hit: Hit | None, seq: str,
               qual: str | None = None, rg: str | None = None) -> str:
    """One SAM line. ``hit=None`` emits the unmapped record."""
    qual = qual or "*"
    if hit is None:
        return "\t".join([
            result.query_name, str(FLAG_UNMAPPED), "*", "0", "0", "*",
            "*", "0", "0", seq, qual,
        ] + ([f"RG:Z:{rg}"] if rg else []))
    flag = hit_flag(hit)
    out_seq = revcomp(seq) if hit.is_reverse else seq
    out_qual = qual if qual == "*" else (qual[::-1] if hit.is_reverse else qual)
    cigar, out_seq, out_qual = hard_clip(hit, out_seq, out_qual)
    if hit.is_secondary:
        out_seq, out_qual = "*", "*"
    fields = [
        result.query_name,
        str(flag),
        hit.ref_name,
        str(hit.ref_begin + 1),  # SAM POS is 1-based
        str(hit.mapq),
        cigar,
        "*", "0", "0",
        out_seq,
        out_qual,
    ] + _tail_tags(hit, rg)
    return "\t".join(fields)


def sam_record_pe(result: ReadResult, seq: str, qual: str | None = None,
                  rg: str | None = None, hit: Hit | None = None,
                  pe=None) -> str:
    """One SAM line for a paired end (result.pe carries mate info).

    Carries the same optional-tag set as the single-end record — bwa
    emits NM/MD/AS/XS (and RG/SA/XA) on paired records too (mem_reg2aln
    consumed at bwa.cpp:158; VERDICT r2 item 5). ``hit``/``pe``
    override the default primary record — supplementary parts of a
    split read pass themselves with their own PEInfo."""
    pe = pe if pe is not None else result.pe
    qual = qual or "*"
    hit = hit if hit is not None else result.primary
    if hit is None:
        rnext = pe.rnext if pe else "*"
        pnext = (pe.pnext + 1) if pe and pe.rnext != "*" else 0
        flag = FLAG_UNMAPPED | (pe.flag_extra if pe else 0)
        return "\t".join([
            result.query_name, str(flag), "*", "0", "0", "*",
            rnext, str(pnext), "0", seq, qual,
        ] + ([f"RG:Z:{rg}"] if rg else []))
    flag = hit_flag(hit) | (pe.flag_extra if pe else 0)
    out_seq = revcomp(seq) if hit.is_reverse else seq
    out_qual = qual if qual == "*" else (qual[::-1] if hit.is_reverse else qual)
    cigar, out_seq, out_qual = hard_clip(hit, out_seq, out_qual)
    return "\t".join([
        result.query_name,
        str(flag),
        hit.ref_name,
        str(hit.ref_begin + 1),
        str(hit.mapq),
        cigar,
        pe.rnext if pe else "*",
        str(pe.pnext + 1) if pe and pe.rnext != "*" else "0",
        str(pe.tlen) if pe else "0",
        out_seq,
        out_qual,
    ] + _tail_tags(hit, rg))


def emit_sam_pairs(pair_results, index: FMIndex, seqs1, seqs2,
                   quals1=None, quals2=None, header: bool = True,
                   program_args: str = "",
                   read_group: str | None = None) -> str:
    """Render paired results ((res1, res2) per template) to SAM text."""
    out = [sam_header(index, program_args, read_group)] if header else []
    rg = rg_id(read_group)
    for i, (r1, r2) in enumerate(pair_results):
        q1 = quals1[i] if quals1 else None
        q2 = quals2[i] if quals2 else None
        out.append(_pe_records(r1, seqs1[i], q1, rg))
        out.append(_pe_records(r2, seqs2[i], q2, rg))
    return "".join(out)


def _pe_records(res: ReadResult, seq: str, qual: str | None,
                rg: str | None) -> str:
    """All SAM lines for one paired end: the primary record, then any
    supplementary parts of a split read (each with its own PEInfo,
    attached by align.paired._pair_one)."""
    lines = [sam_record_pe(res, seq, qual, rg) + "\n"]
    for h in res.hits[1:]:
        if getattr(h, "is_supplementary", False):
            lines.append(sam_record_pe(res, seq, qual, rg, hit=h, pe=h.pe)
                         + "\n")
    return "".join(lines)


def emit_sam(results: Iterable[ReadResult], index: FMIndex, seqs: list[str],
             quals: list[str] | None = None, header: bool = True,
             program_args: str = "",
             read_group: str | None = None) -> str:
    """Render results to SAM text. ``seqs[i]`` is read i's original text."""
    out = [sam_header(index, program_args, read_group)] if header else []
    rg = rg_id(read_group)
    for i, res in enumerate(results):
        q = quals[i] if quals else None
        if not res.hits:
            out.append(sam_record(res, None, seqs[i], q, rg) + "\n")
            continue
        for hit in res.hits:
            out.append(sam_record(res, hit, seqs[i], q, rg) + "\n")
    return "".join(out)


def emit_sam_pair_columns(cols1, cols2, index: FMIndex, batch1, batch2,
                          header: bool = True, program_args: str = "",
                          seqs1: list[str] | None = None,
                          seqs2: list[str] | None = None,
                          read_group: str | None = None) -> str:
    """Render a columnar PE batch (align/paired.py
    finalize_pairs_columns) to interleaved SAM text — the PE counterpart
    of emit_sam_columns. Fast rows render straight from the columns;
    rows with full per-pair results (cols.extra) go through
    sam_record_pe."""
    out = [sam_header(index, program_args, read_group)] if header else []
    rg = rg_id(read_group)
    rgt = f"\tRG:Z:{rg}" if rg else ""
    ref_names = index.ref_names
    ends = (
        (cols1, batch1, seqs1),
        (cols2, batch2, seqs2),
    )
    pulled = []
    for cols, batch, seqs in ends:
        pulled.append(dict(
            names=batch.names, quals=batch.qualities, codes=batch.codes,
            lens=(batch.lens.tolist() if hasattr(batch.lens, "tolist")
                  else batch.lens),
            mapped=cols.mapped.tolist(), pos=cols.pos.tolist(),
            rid=cols.rid.tolist(), mapq=cols.mapq.tolist(),
            nm=cols.nm.tolist(), score=cols.score.tolist(),
            sub=cols.sub.tolist(), is_rev=cols.is_rev.tolist(),
            toff=cols.toff.tolist(), cig_len=cols.cig_len.tolist(),
            md_len=cols.md_len.tolist(), blob=cols.text,
            pe_flag=cols.pe_flag.tolist(), pnext=cols.pnext.tolist(),
            tlen=cols.tlen.tolist(), rnext_rid=cols.rnext_rid.tolist(),
            extra=cols.extra, seqs=seqs,
        ))
    n = min(cols1.n, cols2.n)
    for i in range(n):
        for p in pulled:
            if i in p["extra"]:
                res = p["extra"][i]
                seq = (p["seqs"][i] if p["seqs"] is not None else
                       bytes(p["codes"][i, : p["lens"][i]])
                       .translate(_FWD_TR).decode())
                q = p["quals"][i] if p["quals"] else None
                out.append(_pe_records(res, seq, q, rg))
                continue
            q = p["quals"][i] if p["quals"] else "*"
            flag = int(p["pe_flag"][i]) | (16 if p["is_rev"][i] else 0)
            if p["is_rev"][i]:
                seq = (revcomp(p["seqs"][i]) if p["seqs"] is not None else
                       bytes(p["codes"][i, : p["lens"][i]])
                       .translate(_REV_TR)[::-1].decode())
                if q != "*":
                    q = q[::-1]
            else:
                seq = (p["seqs"][i] if p["seqs"] is not None else
                       bytes(p["codes"][i, : p["lens"][i]])
                       .translate(_FWD_TR).decode())
            rr = p["rnext_rid"][i]
            rnext = "*" if rr == -1 else ("=" if rr == -2 else ref_names[rr])
            pnext = p["pnext"][i] + 1 if rr != -1 else 0
            o = p["toff"][i]
            cig = p["blob"][o : o + p["cig_len"][i]].tobytes().decode("ascii")
            md = p["blob"][o + p["cig_len"][i]
                           : o + p["cig_len"][i] + p["md_len"][i]
                           ].tobytes().decode("ascii")
            xs = f"\tXS:i:{p['sub'][i]}" if p["sub"][i] >= 0 else ""
            out.append(
                f"{p['names'][i]}\t{flag}\t{ref_names[p['rid'][i]]}"
                f"\t{p['pos'][i] + 1}\t{p['mapq'][i]}\t{cig}\t{rnext}"
                f"\t{pnext}\t{p['tlen'][i]}\t{seq}\t{q}"
                f"\tNM:i:{p['nm'][i]}\tMD:Z:{md}\tAS:i:{p['score'][i]}"
                f"{xs}{rgt}\n"
            )
    return "".join(out)


# --- columnar emission (align/columns.py AlignColumns) ---

_FWD_TR = bytes.maketrans(bytes(range(5)), b"ACGTN")
_REV_TR = bytes.maketrans(bytes(range(5)), b"TGCAN")


def emit_sam_columns(cols, index: FMIndex, batch, header: bool = True,
                     program_args: str = "", seqs: list[str] | None = None,
                     read_group: str | None = None) -> str:
    """Render an AlignColumns batch to SAM text.

    The throughput-path emitter: one primary line per fast row straight
    from the columns (seq decoded with C-level bytes.translate, CIGAR/MD
    sliced from the shared blob); rows with full multi-hit results
    (cols.extra) go through the classic per-record path.

    ``seqs`` (optional) supplies the original read text per row —
    exotic IUPAC letters survive in the SEQ field instead of decoding
    to N from the 2-bit-plus-ambiguity codes.
    """
    out = [sam_header(index, program_args, read_group)] if header else []
    rg = rg_id(read_group)
    rgt = f"\tRG:Z:{rg}" if rg else ""
    names = batch.names
    quals = batch.qualities
    codes = batch.codes
    lens = batch.lens.tolist() if hasattr(batch.lens, "tolist") else batch.lens
    mapped = cols.mapped.tolist()
    pos = cols.pos.tolist()
    rid = cols.rid.tolist()
    mapq = cols.mapq.tolist()
    nm = cols.nm.tolist()
    score = cols.score.tolist()
    sub = cols.sub.tolist()
    is_rev = cols.is_rev.tolist()
    toff = cols.toff.tolist()
    cig_len = cols.cig_len.tolist()
    md_len = cols.md_len.tolist()
    blob = cols.text
    ref_names = index.ref_names
    extra = cols.extra
    for i, name in enumerate(names):
        if i in extra:
            res = extra[i]
            seq = (seqs[i] if seqs is not None
                   else bytes(codes[i, : lens[i]]).translate(_FWD_TR).decode())
            q = quals[i] if quals else None
            if not res.hits:
                out.append(sam_record(res, None, seq, q, rg) + "\n")
            else:
                for hit in res.hits:
                    out.append(sam_record(res, hit, seq, q, rg) + "\n")
            continue
        q = quals[i] if quals else "*"
        if not mapped[i]:
            seq = (seqs[i] if seqs is not None
                   else bytes(codes[i, : lens[i]]).translate(_FWD_TR).decode())
            out.append(f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t{q}{rgt}\n")
            continue
        if is_rev[i]:
            seq = (revcomp(seqs[i]) if seqs is not None else
                   bytes(codes[i, : lens[i]]).translate(_REV_TR)[::-1].decode())
            if q != "*":
                q = q[::-1]
            flag = 16
        else:
            seq = (seqs[i] if seqs is not None else
                   bytes(codes[i, : lens[i]]).translate(_FWD_TR).decode())
            flag = 0
        o = toff[i]
        cig = blob[o : o + cig_len[i]].tobytes().decode("ascii")
        md = blob[o + cig_len[i] : o + cig_len[i] + md_len[i]].tobytes().decode("ascii")
        out.append(
            f"{name}\t{flag}\t{ref_names[rid[i]]}\t{pos[i] + 1}\t{mapq[i]}"
            f"\t{cig}\t*\t0\t0\t{seq}\t{q}\tNM:i:{nm[i]}\tMD:Z:{md}"
            f"\tAS:i:{score[i]}"
            + (f"\tXS:i:{sub[i]}" if sub[i] >= 0 else "") + rgt + "\n"
        )
    return "".join(out)
