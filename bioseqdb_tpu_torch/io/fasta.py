"""Streaming FASTA/FASTQ parsing.

The ingest analogue of the reference's ``bioseqdb-import`` CLI
(reference: bioseqdb-import/main.cpp): instead of one libpq INSERT per
record (main.cpp:51-56), records stream into packed fixed-width arrays
(see io.batch). The uppercasing rule follows main.cpp:66-67 — lowercase
(soft-masked) residues are uppercased at ingest, since the strict codec
rejects them (extension.cpp:42-45 commentary).
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator


@dataclass
class FastaRecord:
    name: str          # first whitespace token of the header
    description: str   # full header line (without '>'/'@')
    sequence: str      # uppercased residues
    quality: str | None = None  # FASTQ only


def _open_text(path) -> io.TextIOBase:
    if hasattr(path, "read"):
        return path
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="ascii")
    return open(path, "rt", encoding="ascii")


def read_fasta(path) -> Iterator[FastaRecord]:
    """Yield records from a FASTA file (plain or gzip)."""
    fh = _open_text(path)
    try:
        header = None
        chunks: list[str] = []
        for line in fh:
            line = line.rstrip("\r\n")
            if not line:
                continue
            if line.startswith(">"):
                if header is not None:
                    yield _make_record(header, "".join(chunks))
                header = line[1:]
                chunks = []
            else:
                if header is None:
                    raise ValueError("FASTA parse error: sequence before header")
                chunks.append(line.upper())
        if header is not None:
            yield _make_record(header, "".join(chunks))
    finally:
        if not hasattr(path, "read"):
            fh.close()


def read_fastq(path) -> Iterator[FastaRecord]:
    """Yield records from a FASTQ file (plain or gzip)."""
    fh = _open_text(path)
    try:
        while True:
            header = fh.readline()
            if not header:
                return
            header = header.rstrip("\r\n")
            if not header:
                continue
            if not header.startswith("@"):
                raise ValueError(f"FASTQ parse error: expected '@', got {header[:20]!r}")
            seq = fh.readline().rstrip("\r\n")
            plus = fh.readline()
            if not plus.startswith("+"):
                raise ValueError("FASTQ parse error: expected '+' separator")
            qual = fh.readline().rstrip("\r\n")
            if len(qual) != len(seq):
                raise ValueError("FASTQ parse error: quality/sequence length mismatch")
            rec = _make_record(header[1:], seq.upper())
            rec.quality = qual
            yield rec
    finally:
        if not hasattr(path, "read"):
            fh.close()


def read_seqs(path) -> Iterator[FastaRecord]:
    """Sniff FASTA vs FASTQ from the first byte and dispatch."""
    if hasattr(path, "read"):
        raise TypeError("read_seqs requires a path; use read_fasta/read_fastq for streams")
    fh = _open_text(path)
    first = fh.read(1)
    fh.close()
    if first == "@":
        return read_fastq(path)
    return read_fasta(path)


def _make_record(header: str, seq: str) -> FastaRecord:
    name = header.split()[0] if header.split() else header
    return FastaRecord(name=name, description=header, sequence=seq)


def write_fasta(path, records, width: int = 70) -> None:
    own = not hasattr(path, "write")
    fh = open(path, "wt", encoding="ascii") if own else path
    try:
        for rec in records:
            name, seq = (rec.name, rec.sequence) if isinstance(rec, FastaRecord) else rec
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width] + "\n")
    finally:
        if own:
            fh.close()


def write_fastq(path, records) -> None:
    own = not hasattr(path, "write")
    fh = open(path, "wt", encoding="ascii") if own else path
    try:
        for rec in records:
            q = rec.quality if rec.quality is not None else "I" * len(rec.sequence)
            fh.write(f"@{rec.description}\n{rec.sequence}\n+\n{q}\n")
    finally:
        if own:
            fh.close()
