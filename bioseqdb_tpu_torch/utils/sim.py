"""Synthetic genomes and reads for tests and benchmarks.

The environment has no network access and no bundled genomes, so the
staged configs (BASELINE.md: lambda 48kb, E. coli 4.6Mb, chr20 64Mb, ...)
are stood in for by seeded random genomes of the same scale. Reads carry
ground truth (position, strand, edits) for oracle-free spot checks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def simulate_genome(length: int, seed: int = 0, n_frac: float = 0.0) -> str:
    """Random ACGT genome; optional fraction of N positions."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=length, dtype=np.uint8)
    out = _BASES[codes]
    if n_frac > 0:
        mask = rng.random(length) < n_frac
        out = out.copy()
        out[mask] = ord("N")
    return out.tobytes().decode("ascii")


@dataclass
class SimulatedReads:
    reads: list[str]
    names: list[str]
    positions: np.ndarray   # 0-based start on the forward reference
    strands: np.ndarray     # False = forward, True = reverse-complement
    n_subs: np.ndarray      # substitutions injected per read


def simulate_pairs(
    genome: str,
    n_pairs: int,
    read_len: int = 150,
    insert_mean: float = 400.0,
    insert_std: float = 50.0,
    sub_rate: float = 0.0,
    seed: int = 0,
    name_prefix: str = "pair",
):
    """FR-orientation paired reads: R1 forward at p, R2 = revcomp of the
    fragment end. Returns (SimulatedReads r1, SimulatedReads r2,
    insert_sizes)."""
    rng = np.random.default_rng(seed)
    L = len(genome)
    inserts = np.clip(
        rng.normal(insert_mean, insert_std, n_pairs), 2 * read_len, L - 1
    ).astype(np.int64)
    starts = rng.integers(0, L - inserts.max() - 1, size=n_pairs)
    g = np.frombuffer(genome.encode("ascii"), dtype=np.uint8)
    lut = np.zeros(256, dtype=np.uint8)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
    gc = lut[g]

    def make(pos, rc):
        codes = gc[pos : pos + read_len].copy()
        if sub_rate > 0:
            m = rng.random(read_len) < sub_rate
            codes[m] = (codes[m] + rng.integers(1, 4, size=int(m.sum()))) % 4
        if rc:
            codes = (3 - codes)[::-1]
        return _BASES[codes].tobytes().decode("ascii")

    r1, r2 = [], []
    p2s = np.zeros(n_pairs, dtype=np.int64)
    for i in range(n_pairs):
        p1 = int(starts[i])
        p2 = p1 + int(inserts[i]) - read_len
        p2s[i] = p2
        r1.append(make(p1, False))
        r2.append(make(p2, True))
    names = [f"{name_prefix}{i}" for i in range(n_pairs)]
    sr1 = SimulatedReads(reads=r1, names=names, positions=starts.astype(np.int64),
                         strands=np.zeros(n_pairs, bool), n_subs=np.zeros(n_pairs, np.int32))
    sr2 = SimulatedReads(reads=r2, names=names, positions=p2s,
                         strands=np.ones(n_pairs, bool), n_subs=np.zeros(n_pairs, np.int32))
    return sr1, sr2, inserts


def simulate_reads(
    genome: str,
    n_reads: int,
    read_len: int = 150,
    sub_rate: float = 0.0,
    rc_frac: float = 0.5,
    seed: int = 0,
    name_prefix: str = "sim",
) -> SimulatedReads:
    """Sample uniform reads, optionally reverse-complemented and mutated."""
    rng = np.random.default_rng(seed)
    g = np.frombuffer(genome.encode("ascii"), dtype=np.uint8)
    lut = np.zeros(256, dtype=np.uint8)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
    gc = lut[g]  # genome as 2-bit codes (N -> 0; fine for simulation)

    L = len(genome)
    if L < read_len:
        raise ValueError("genome shorter than read length")
    pos = rng.integers(0, L - read_len + 1, size=n_reads)
    strands = rng.random(n_reads) < rc_frac

    reads: list[str] = []
    n_subs = np.zeros(n_reads, dtype=np.int32)
    for i in range(n_reads):
        codes = gc[pos[i] : pos[i] + read_len].copy()
        if sub_rate > 0:
            m = rng.random(read_len) < sub_rate
            n_subs[i] = int(m.sum())
            # substitute with a different base: add 1..3 mod 4
            codes[m] = (codes[m] + rng.integers(1, 4, size=int(m.sum()))) % 4
        if strands[i]:
            codes = (3 - codes)[::-1]
        reads.append(_BASES[codes].tobytes().decode("ascii"))
    names = [f"{name_prefix}{i}" for i in range(n_reads)]
    return SimulatedReads(
        reads=reads,
        names=names,
        positions=pos.astype(np.int64),
        strands=strands,
        n_subs=n_subs,
    )
