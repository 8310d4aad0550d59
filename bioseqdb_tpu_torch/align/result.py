"""Alignment result records.

``Hit`` mirrors the reference's per-match record — ``BwaMatch``
(bwa.h:15-30) / the 15-field ``bwa_result`` SQL composite
(bioseqdb--0.0.0.sql:196-212) — with proper typed fields instead of SQL
datums, plus ``mapq``/``ref_name`` which the SQL surface lacked but SAM
emission needs.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Hit:
    ref_id: int              # user-supplied reference id (bwa_result.ref_id)
    ref_name: str
    ref_begin: int           # 0-based, on the forward reference strand
    ref_end: int
    query_id: int | None     # row id in multi-query mode, None single-query
    query_name: str
    query_begin: int         # 0-based match span on the query
    query_end: int
    is_primary: bool
    is_secondary: bool
    is_reverse: bool
    cigar: str
    score: int
    mapq: int
    nm: int = 0          # edit distance (SAM NM tag)
    md: str = ""         # SAM MD tag ("" = not computed)
    sub: int = -1        # sub-optimal score (SAM XS tag; -1 = not emitted,
                         # bwa mem_aln2sam: XS only on primary records)
    rid: int = -1        # internal reference row index
    xa: str = ""         # SAM XA tag payload (alternate hits), "" = none
    is_supplementary: bool = False  # SAM 0x800: non-first primary part of a
                                    # chimeric read (mem_reg2sam rule)
    sa: str = ""         # SAM SA tag payload: the OTHER primary parts of a
                         # split read, "rname,pos,strand,cigar,mapq,nm;"
                         # each (bwa mem_aln2sam rule; "" = not chimeric)
    is_alt: bool = False  # hit lies on an ALT contig (keeps soft clips on
                          # supplementary records, like bwa)
    pe: object = None    # PEInfo for non-primary PE records (the primary's
                         # rides on ReadResult.pe); None otherwise

    @property
    def ref_match_len(self) -> int:
        return self.ref_end - self.ref_begin

    @property
    def query_match_len(self) -> int:
        return self.query_end - self.query_begin


@dataclass
class ReadResult:
    """All hits for one read, primary first."""

    query_name: str
    hits: list[Hit]
    pe: object = None  # PEInfo when this end belongs to a pair

    @property
    def mapped(self) -> bool:
        return bool(self.hits)

    @property
    def primary(self) -> Hit | None:
        return self.hits[0] if self.hits else None
