"""The search API on a torch device.

The port of ``bioseqdb_tpu/api.py``: the Python equivalents of the
reference's two SQL entry points (bioseqdb--0.0.0.sql:214-222;
extension.cpp:311-378):

- ``search(query, references, options)``         == nuclseq_search_bwa
- ``multi_search(queries, references, options)`` == nuclseq_multi_search_bwa

Each returned ``SearchResult`` carries the same 15 fields as the SQL
``bwa_result`` composite (bioseqdb--0.0.0.sql:196-212), including the
decoded reference subsequence with ambiguity holes laid back over it
(extract_reference_subseq, bwa.cpp:55-68) and the matched query
subsequence. ``query_id`` is None in single-query mode, as the reference
emits NULL there (extension.cpp:289,301-302).

``references`` is an ``Aligner``, an ``FMIndex`` or an iterable of
reference sequences; the index is built once a call unless an ``FMIndex``
or an ``Aligner`` is passed. ``device`` is used only when the call builds
the ``Aligner`` itself.
"""

from __future__ import annotations

from dataclasses import dataclass

from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.index.fmindex import FMIndex
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.seq.codec import Sequence


@dataclass
class SearchResult:
    """One match: field for field the reference's bwa_result row."""

    ref_id: int
    ref_subseq: str
    ref_match_start: int
    ref_match_end: int
    ref_match_len: int
    query_id: int | None
    query_subseq: str
    query_match_start: int
    query_match_end: int
    query_match_len: int
    is_primary: bool
    is_secondary: bool
    is_reverse: bool
    cigar: str
    score: int
    # beyond the SQL surface
    ref_name: str = ""
    mapq: int = 0
    nm: int = 0


def _as_aligner(references, options: AlignOptions | None,
                device) -> Aligner:
    if isinstance(references, Aligner):
        return references
    if not isinstance(references, FMIndex):
        references = build_index(references)
    return Aligner.build(references, options, device=device)


def _seq_text(s) -> str:
    return s.to_text() if isinstance(s, Sequence) else str(s)


def _to_search_results(aligner: Aligner, texts, results, multi: bool
                       ) -> list[SearchResult]:
    idx = aligner.index
    out: list[SearchResult] = []
    for i, res in enumerate(results):
        text = texts[i]
        for h in res.hits:
            off = int(idx.ref_offsets[h.rid])
            out.append(SearchResult(
                ref_id=h.ref_id,
                ref_subseq=idx.extract_subseq(off + h.ref_begin,
                                              off + h.ref_end),
                ref_match_start=h.ref_begin,
                ref_match_end=h.ref_end,
                ref_match_len=h.ref_end - h.ref_begin,
                query_id=i if multi else None,
                query_subseq=text[h.query_begin : h.query_end],
                query_match_start=h.query_begin,
                query_match_end=h.query_end,
                query_match_len=h.query_end - h.query_begin,
                is_primary=h.is_primary,
                is_secondary=h.is_secondary,
                is_reverse=h.is_reverse,
                cigar=h.cigar,
                score=h.score,
                ref_name=h.ref_name,
                mapq=h.mapq,
                nm=h.nm,
            ))
    return out


def search(query, references, options: AlignOptions | None = None,
           device="cuda") -> list[SearchResult]:
    """Single-query search (nuclseq_search_bwa semantics)."""
    aligner = _as_aligner(references, options, device)
    text = _seq_text(query)
    results = aligner.align_batch(pack_reads([text], ["q"]))
    return _to_search_results(aligner, [text], results, multi=False)


def multi_search(queries, references, options: AlignOptions | None = None,
                 device="cuda") -> list[SearchResult]:
    """Multi-query search (nuclseq_multi_search_bwa semantics);
    ``query_id`` is the row number of each query."""
    aligner = _as_aligner(references, options, device)
    texts = [_seq_text(q) for q in queries]
    batch = pack_reads(texts, [f"q{i}" for i in range(len(texts))])
    results = aligner.align_batch(batch)
    return _to_search_results(aligner, texts, results, multi=True)
