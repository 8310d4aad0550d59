"""The paired-end leg of the port on the card.

    python -m bioseqdb_tpu_torch.tools.pe_leg

Builds the index of a simulated genome of chr20's size (64 Mb, seed 20;
``bench.py``'s ``bench_chr20``, BASELINE.md config 3), then
simulates batches of FR pairs (150 bp, 1% substitutions, inserts 400 +-
40) with ``simulate_pairs`` and runs each through the fused two-mate
step ``device_regions_pair`` -> the pair overflow retry
``absorb_overflow_pair`` -> ``finalize_pairs_columns``, timing each
part on the host clock (the device stages return host arrays, so each
has waited for the card). It counts R1 and R2 at their
simulated position and strand, and the proper pairs, and holds every
pair with a mate off truth against the host: the slow PE path of
``align/paired.py`` (the host oracle's ``mem_align1`` regions for both
mates, then ``_pair_slow_one`` with the batch's own insert-size
statistics) must give both primary records (mapped, position, strand,
score, proper bit) as the port's columns do. The pairs that differ are
``pe_ne_oracle``.

The first batch (pair seed 900) is the warm-up; the next two (901, 902)
are timed. It prints the set-up times (genome, ``build_index``, kmer
table, upload) and one JSON line a batch, then a summary line.
``chip_smoke.py`` drives the same functions on the main path's 4.6 Mb
genome. Needs a CUDA device; without one it raises.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass

import numpy as np
import torch

from bioseqdb_tpu_torch.align import paired
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.cpu import oracle as O
from bioseqdb_tpu_torch.cpu.ksw import fill_scmat
from bioseqdb_tpu_torch.index import layout
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import ReadBatch, pack_reads
from bioseqdb_tpu_torch.tools.shapes import card_line
from bioseqdb_tpu_torch.utils.sim import (SimulatedReads, simulate_genome,
                                          simulate_pairs)

# bench.py's paired-end leg: 8,192 pairs a batch (16,384 device rows, the
# single-end batch's count), 150 bp, 1% substitutions, FR inserts 400 +- 40
PAIRS = 8192
READ_LEN = 150
SUB_RATE = 0.01
INSERT_MEAN, INSERT_STD = 400, 40
STAGES = ("device_regions_pair", "absorb_overflow_pair",
          "finalize_pairs_columns")
# the chr20-scale leg
GENOME_LEN, GENOME_SEED = 64_000_000, 20
PAIR_SEED, TIMED_BATCHES = 900, 2


@dataclass
class PairBatch:
    sims: tuple[SimulatedReads, SimulatedReads]
    batches: tuple[ReadBatch, ReadBatch]


def simulate(genome: str, n_pairs: int, seed: int) -> PairBatch:
    sr1, sr2, _ = simulate_pairs(genome, n_pairs, read_len=READ_LEN,
                                 insert_mean=INSERT_MEAN,
                                 insert_std=INSERT_STD, sub_rate=SUB_RATE,
                                 seed=seed)
    return PairBatch((sr1, sr2), (pack_reads(sr1.reads, sr1.names),
                                  pack_reads(sr2.reads, sr2.names)))


def run_batch(al: Aligner, pb: PairBatch) -> dict:
    """One pair batch through the three stages; the columns, the
    absorbed out dicts, the rows that overflowed before the retry, and
    each stage's host seconds. Both device stages return host arrays, so
    each has waited for the device when it returns."""
    b1, b2 = pb.batches
    t = [time.perf_counter()]
    out1, out2 = al.device_regions_pair(b1, b2)
    t.append(time.perf_counter())
    n_ovf = int(out1["overflow"][: b1.n].sum()
                + out2["overflow"][: b2.n].sum())
    outs = al.absorb_overflow_pair(b1, out1, b2, out2)
    t.append(time.perf_counter())
    cols = paired.finalize_pairs_columns(al.index, al.options, b1, outs[0],
                                         b2, outs[1])
    t.append(time.perf_counter())
    return dict(cols=cols, outs=outs, n_ovf=n_ovf,
                seconds=dict(zip(STAGES, np.diff(t).tolist())))


def proper_bits(cols) -> np.ndarray:
    """The proper-pair bit of each row: the PE column of a fast row, the
    PEInfo of a row finalized on the slow path (``cols.extra``)."""
    flag = cols.pe_flag.copy()
    for i, res in cols.extra.items():
        flag[i] = res.pe.flag_extra
    return (flag & paired.FLAG_PROPER) > 0


def check(al: Aligner, pb: PairBatch, res: dict) -> dict:
    """Truth counts of one batch, and ``pe_ne_oracle``: the pairs with a
    mate off truth whose primary records differ from the host's slow PE
    path."""
    idx, opt = al.index, al.options
    (b1, b2), cols = pb.batches, res["cols"]
    n = len(pb.sims[0].positions)
    at = [c.mapped[:n] & (c.pos[:n] == s.positions)
          & (c.is_rev[:n] == s.strands.astype(bool))
          for c, s in zip(cols, pb.sims)]
    proper = [proper_bits(c) for c in cols]
    off = np.flatnonzero(~(at[0] & at[1]))
    pes = paired._pairs_prelude(idx, opt, b1, res["outs"][0], b2,
                                res["outs"][1])[4]
    mat = fill_scmat(opt.match_score, opt.mismatch_penalty)
    ne = 0
    for i in off.tolist():
        q1, q2 = (np.asarray(b.codes)[i, : b.lens[i]].astype(np.uint8)
                  for b in (b1, b2))
        r1 = O.mem_align1(idx, opt, q1, rand_id=i)
        r2 = O.mem_align1(idx, opt, q2, rand_id=(1 << 20) + i)
        ends = paired._pair_slow_one(idx, opt, mat, pes, b1.names[i], q1, r1,
                                     q2, r2, rid1=i, rid2=(1 << 20) + i)
        for c, p, e in zip(cols, proper, ends):
            h = e.primary
            want = ((True, h.ref_begin, h.is_reverse, h.score,
                     bool(e.pe.flag_extra & paired.FLAG_PROPER))
                    if h else (False,))
            got = ((True, int(c.pos[i]), bool(c.is_rev[i]), int(c.score[i]),
                    bool(p[i])) if c.mapped[i] else (False,))
            if want != got:
                ne += 1
                break
    return dict(pairs=n, r1_truth=int(at[0].sum()), r2_truth=int(at[1].sum()),
                proper=int(proper[0][:n].sum()), off_truth_pairs=int(off.size),
                pe_ne_oracle=ne)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the paired-end leg needs a CUDA device")
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    genome = simulate_genome(GENOME_LEN, seed=GENOME_SEED)
    t1 = time.perf_counter()
    idx = build_index([("sim", genome)])
    t2 = time.perf_counter()
    layout.kmer_table_arrays(idx)
    t3 = time.perf_counter()
    al = Aligner.build(idx, AlignOptions(), device="cuda")
    t4 = time.perf_counter()
    setup = dict(genome_s=t1 - t0, index_s=t2 - t1, kmer_table_s=t3 - t2,
                 aligner_build_s=t4 - t3)
    print(f"{GENOME_LEN} b genome: simulate {setup['genome_s']:.1f} s, "
          f"build_index {setup['index_s']:.1f} s, kmer table "
          f"{setup['kmer_table_s']:.1f} s, Aligner.build (upload) "
          f"{setup['aligner_build_s']:.1f} s", flush=True)
    batches = []
    for k in range(TIMED_BATCHES + 1):
        pb = simulate(genome, PAIRS, PAIR_SEED + k)
        res = run_batch(al, pb)
        row = dict(seed=PAIR_SEED + k, warm_up=k == 0, n_ovf=res["n_ovf"],
                   **res["seconds"], **check(al, pb, res))
        row["reads_per_s"] = 2 * PAIRS / sum(res["seconds"].values())
        print(json.dumps(row), flush=True)
        batches.append(row)
    timed = batches[1:]
    print(json.dumps(dict(
        setup, genome_len=GENOME_LEN, pairs=PAIRS,
        reads_per_s=[r["reads_per_s"] for r in timed],
        pe_ne_oracle=sum(r["pe_ne_oracle"] for r in batches),
        r1_truth=sum(r["r1_truth"] for r in timed),
        r2_truth=sum(r["r2_truth"] for r in timed),
        proper=sum(r["proper"] for r in timed),
        timed_pairs=sum(r["pairs"] for r in timed))), flush=True)


if __name__ == "__main__":
    main()
