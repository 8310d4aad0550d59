"""High-level index construction from sequences or FASTA files.

The offline analogue of ``BwaIndex::add_ref_sequence`` + ``build``
(reference: bwa.cpp:82-128), minus its defects (SURVEY.md §7): reference
sequences concatenate contiguously (no accidental 4-base alignment
padding), hole offsets rebase correctly, and ids are a proper int64
column instead of a pointer stuffed into ``char* name`` (bwa.cpp:89).
Unlike the reference — which rebuilds the index inside every SQL call
(extension.cpp:326,359) — the built index is a value you keep, share
across devices, and serialize (FMIndex.save/load).
"""

from __future__ import annotations

import numpy as np

from bioseqdb_tpu_torch.index.fmindex import FMIndex, build_fmindex_from_codes
from bioseqdb_tpu_torch.seq.codec import CHAR_OF, Sequence


def adaptive_sa_interval(doubled_len: int) -> int:
    """SA sample interval by doubled-text size.

    bwa hardcodes 32 (bwt_cal_sa(bwt, 32), bwa.cpp:113) because its
    on-disk .sa size mattered; on TPU the sampled SA is an in-HBM int32
    array and the resolve kernel's LF walk is a fixed ``interval - 1``
    trip loop of two row-gathers per lane — so a denser sample trades
    cheap HBM for a ~(interval_a-1)/(interval_b-1) resolve speedup.
    Resolution results are interval-independent (property-tested)."""
    if doubled_len < 1 << 28:   # <= chr20-class: 4 B/base extra
        return 4
    if doubled_len < 1 << 31:   # still int32 ranks
        return 8
    return 32                   # GRCh38-class (int64 ranks): bwa's 32


def build_index(refs, sa_interval: int | None = None, alt_names=None) -> FMIndex:
    """Build an FMIndex from an iterable of references.

    Each item may be a ``Sequence``, a ``str``, ``(name, seq)``, or
    ``(id, name, seq)``; ids default to the row number (the reference
    passes ids through from SQL, extension.cpp:215). ``alt_names`` marks
    references as ALT contigs (the role of bwa's .alt file): ALT hits
    never shadow primary-reference hits in chain filtering or primary
    marking. ``sa_interval=None`` picks the SA sample density by genome
    size (adaptive_sa_interval).
    """
    pac_parts: list[np.ndarray] = []
    ref_ids: list[int] = []
    ref_names: list[str] = []
    ref_offsets: list[int] = []
    ref_lens: list[int] = []
    hole_offsets: list[np.ndarray] = []
    hole_lens: list[np.ndarray] = []
    hole_chars: list[np.ndarray] = []

    offset = 0
    for row, item in enumerate(refs):
        rid, name = row, str(row)
        if isinstance(item, tuple):
            if len(item) == 3:
                rid, name, seq = item
            else:
                name, seq = item
                try:
                    rid = int(name)
                except (TypeError, ValueError):
                    rid = row
        else:
            seq = item
        if not isinstance(seq, Sequence):
            seq = Sequence.from_text(seq)
        pac_parts.append(seq.codes)
        ref_ids.append(int(rid))
        ref_names.append(str(name))
        ref_offsets.append(offset)
        ref_lens.append(len(seq))
        hole_offsets.append(seq.hole_offsets + offset)  # correct rebase
        hole_lens.append(seq.hole_lens)
        hole_chars.append(CHAR_OF[seq.hole_codes])
        offset += len(seq)

    if not pac_parts:
        raise ValueError("cannot build an index from zero reference sequences")

    pac = np.concatenate(pac_parts) if pac_parts else np.zeros(0, np.uint8)
    if sa_interval is None:
        sa_interval = adaptive_sa_interval(2 * len(pac))
    alt_set = set(alt_names or ())
    return build_fmindex_from_codes(
        pac,
        ref_ids=ref_ids,
        ref_names=ref_names,
        ref_offsets=ref_offsets,
        ref_lens=ref_lens,
        ref_is_alt=[n in alt_set for n in ref_names],
        hole_offsets=np.concatenate(hole_offsets) if hole_offsets else None,
        hole_lens=np.concatenate(hole_lens) if hole_lens else None,
        hole_chars=np.concatenate(hole_chars) if hole_chars else None,
        sa_interval=sa_interval,
    )


def build_index_from_fasta(path, sa_interval: int | None = None) -> FMIndex:
    from bioseqdb_tpu_torch.io.fasta import read_fasta

    return build_index(
        ((rec.name, rec.sequence) for rec in read_fasta(path)),
        sa_interval=sa_interval,
    )
