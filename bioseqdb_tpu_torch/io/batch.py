"""Fixed-width packed read batches — the device-side unit of work.

Replaces the reference's one-row-at-a-time SPI cursor feed
(extension.cpp:156-195, batch size 1) with rectangular uint8 code
arrays sized for TPU: reads are padded to a common width and batches
padded to a lane-friendly count, so every downstream kernel sees static
shapes (SURVEY.md §7 "irregular control flow on TPU").

Code convention inside batches: A/C/G/T = 0..3, ``AMBIG_CODE`` (4) for
any IUPAC-ambiguous base *and* for tail padding — code 4 never matches
any reference base during seeding, which is exactly bwa's treatment of
N in queries.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from bioseqdb_tpu_torch.seq.codec import CODE_OF

AMBIG_CODE = 4

# ASCII -> batch code: ACGT->0..3, other allowed IUPAC ->4, invalid ->255
BATCH_CODE_OF = CODE_OF.copy()
BATCH_CODE_OF[(BATCH_CODE_OF >= 4) & (BATCH_CODE_OF != 255)] = AMBIG_CODE


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class ReadBatch:
    """A rectangular batch of reads.

    codes:  uint8[n_padded, width] — 0..3 bases, 4 = ambiguous/padding
    lens:   int32[n_padded] — true lengths (0 for batch-padding rows)
    names:  read names (len == n, the true count)
    """

    codes: np.ndarray
    lens: np.ndarray
    names: list[str] = field(default_factory=list)
    qualities: list[str] | None = None

    @property
    def n(self) -> int:
        return len(self.names)

    @property
    def n_padded(self) -> int:
        return int(self.codes.shape[0])

    @property
    def width(self) -> int:
        return int(self.codes.shape[1])

    def read_text(self, i: int) -> str:
        from bioseqdb_tpu_torch.seq.codec import CHAR_OF

        return CHAR_OF[self.codes[i, : self.lens[i]]].tobytes().decode("ascii")


def pack_reads(
    seqs,
    names=None,
    qualities=None,
    width: int | None = None,
    pad_reads_to: int = 8,
    pad_width_to: int = 32,
) -> ReadBatch:
    """Pack str/bytes sequences into a ``ReadBatch``.

    width defaults to the max read length, rounded up to ``pad_width_to``;
    the batch dimension is rounded up to ``pad_reads_to`` so re-compiles
    are amortized across similarly-shaped batches.
    """
    seqs = list(seqs)
    n = len(seqs)
    if names is None:
        names = [f"read{i}" for i in range(n)]
    raws = [s.encode("ascii") if isinstance(s, str) else bytes(s) for s in seqs]
    maxlen = max((len(r) for r in raws), default=0)
    if width is None:
        width = _round_up(max(maxlen, 1), pad_width_to)
    elif maxlen > width:
        raise ValueError(f"read of length {maxlen} exceeds batch width {width}")
    n_padded = _round_up(max(n, 1), pad_reads_to)

    codes = np.full((n_padded, width), AMBIG_CODE, dtype=np.uint8)
    lens = np.zeros(n_padded, dtype=np.int32)
    for i, raw in enumerate(raws):
        arr = BATCH_CODE_OF[np.frombuffer(raw, dtype=np.uint8)]
        if (arr == 255).any():
            bad = chr(raw[int(np.argmax(arr == 255))])
            raise ValueError(f"invalid nucleotide in read {names[i]!r}: '{bad}'")
        codes[i, : len(raw)] = arr
        lens[i] = len(raw)
    return ReadBatch(codes=codes, lens=lens, names=list(names), qualities=qualities)


def pack_reads_from_file(path, batch_size: int = 65536, **kw):
    """Stream a FASTA/FASTQ file into successive ReadBatches."""
    from bioseqdb_tpu_torch.io.fasta import read_seqs

    seqs: list[str] = []
    names: list[str] = []
    quals: list[str] = []
    any_qual = False
    for rec in read_seqs(path):
        seqs.append(rec.sequence)
        names.append(rec.name)
        quals.append(rec.quality or "")
        any_qual = any_qual or rec.quality is not None
        if len(seqs) >= batch_size:
            yield pack_reads(seqs, names, quals if any_qual else None, **kw)
            seqs, names, quals, any_qual = [], [], [], False
    if seqs:
        yield pack_reads(seqs, names, quals if any_qual else None, **kw)


def revcomp_codes(codes: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Reverse-complement each row in place of its true length.

    Vectorized: row i maps position j -> lens[i]-1-j; bases complement as
    3-c, ambiguous (4) stays 4; tail padding stays 4.
    """
    n, w = codes.shape
    out = np.full_like(codes, AMBIG_CODE)
    cols = np.arange(w)[None, :]
    src = lens[:, None] - 1 - cols  # source index for each output col
    valid = src >= 0
    src_clip = np.clip(src, 0, w - 1)
    vals = np.take_along_axis(codes, src_clip, axis=1)
    comp = np.where(vals < 4, 3 - vals, vals)
    out[valid] = comp[valid]
    return out
