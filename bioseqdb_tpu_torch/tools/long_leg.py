"""The long-read leg of the port on the card.

    python -m bioseqdb_tpu_torch.tools.long_leg [--warm-reads N] [--timed-reads N]

Builds the index of the main path's simulated genome (4.6 Mb, seed 1),
then simulates batches of 1,500 bp single-end reads at 1% substitutions
(read seed 300: the warm-up, 1,024 reads; read seed 301: 4,096 reads,
timed) and runs each through ``device_regions`` -> ``absorb_overflow``
-> ``finalize_columns``, timing each part on the host clock (the device
stages return host arrays, so each has waited for the card). Batches
this wide leave the kmer seeder for the FM state machine, and the
seed-SW filter runs before extension. The timed batch runs under
``stage_clock``, which synchronises around each stage of the device
step: the FM machine's seconds and its slowest lane's steps, the
seed-SW filter's seconds, and the other stages'. It counts reads at
their simulated position and strand, and holds every read off it
against the host oracle (``ne_oracle``: the reads whose primary record
differs).

It prints the set-up times and one JSON line a batch, with every clocked
stage call in order (``events``: the device step's, then the overflow
retry's). ``chip_smoke.py``
drives the same functions on the main path's index, and uses
``run_batch``, ``check`` and ``stage_clock`` for its FM-seeded main path
too. Needs a CUDA device; without one it raises.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from bioseqdb_tpu_torch.align import pipeline
from bioseqdb_tpu_torch.align.columns import finalize_columns
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.cpu import oracle as O
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import ReadBatch, pack_reads
from bioseqdb_tpu_torch.tools.shapes import card_line
from bioseqdb_tpu_torch.tools.sw_sets import GENOME_LEN
from bioseqdb_tpu_torch.utils.sim import (SimulatedReads, simulate_genome,
                                          simulate_reads)

READ_LEN = 1500
SUB_RATE = 0.01
WARM_READS, TIMED_READS = 1024, 4096
WARM_SEED, TIMED_SEED = 300, 301
GENOME_SEED = 1          # the main path's genome
STAGES = ("device_regions", "absorb_overflow", "finalize_columns")
# the device step's stages, as the pipeline module calls them
CLOCKED = ("collect_seeds_kmer", "collect_seeds_device", "resolve_seeds",
           "chain_seeds", "filter_chains", "seed_sw_filter", "extend_all")


def simulate(genome: str, n: int, seed: int, read_len: int = READ_LEN
             ) -> tuple[SimulatedReads, ReadBatch]:
    sim = simulate_reads(genome, n, read_len=read_len, sub_rate=SUB_RATE,
                         seed=seed)
    return sim, pack_reads(sim.reads, sim.names)


def run_batch(al: Aligner, batch: ReadBatch) -> dict:
    """One batch through the three stages: the columns, the absorbed out
    dict, the rows that overflowed before the retry, and each stage's
    host seconds."""
    t = [time.perf_counter()]
    out = al.device_regions(batch)
    t.append(time.perf_counter())
    n_ovf = int(np.asarray(out["overflow"])[: batch.n].sum())
    out = al.absorb_overflow(batch, out)
    t.append(time.perf_counter())
    cols = finalize_columns(al.index, al.options, batch, out)
    t.append(time.perf_counter())
    return dict(cols=cols, out=out, n_ovf=n_ovf,
                seconds=dict(zip(STAGES, np.diff(t).tolist())))


def check(al: Aligner, sim: SimulatedReads, batch: ReadBatch, cols) -> dict:
    """Reads at their simulated origin, and ``ne_oracle``: the reads off
    it whose primary record (mapped, position, strand, score) differs
    from the host oracle's."""
    n = len(sim.positions)
    at = (cols.mapped[:n] & (cols.pos[:n] == sim.positions)
          & (cols.is_rev[:n] == sim.strands.astype(bool)))
    off = np.flatnonzero(~at)
    ne = 0
    for i in off.tolist():
        q = np.asarray(batch.codes)[i, : batch.lens[i]].astype(np.uint8)
        regs = O.align_read(al.index, al.options, q, rand_id=i,
                            min_score=al.options.min_score, all_hits=True)
        prim = next((a for a in regs if not a.flag & 0x100), None)
        if prim is None:
            agree = not cols.mapped[i]
        else:
            agree = (bool(cols.mapped[i]) and int(cols.pos[i]) == prim.pos
                     and bool(cols.is_rev[i]) == bool(prim.is_rev)
                     and int(cols.score[i]) == prim.score)
        ne += not agree
    return dict(reads=n, truth=int(at.sum()), off_truth=int(off.size),
                ne_oracle=ne, host_oracle_rows=len(cols.extra))


class stage_clock:
    """Within the block, each stage of the device step (the ``CLOCKED``
    functions of ``align/pipeline.py``) runs between two device
    synchronisations, and ``events`` gets (name, seconds, steps) for each
    call, in order: ``steps`` is the FM machine's slowest lane's step
    count (``iters``), None for the other stages."""

    def __init__(self):
        self.events = []

    @staticmethod
    def _sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def _wrap(self, name, fn):
        def clocked(*args, **kw):
            self._sync()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self._sync()
            steps = (int(out["iters"].max())
                     if name == "collect_seeds_device" else None)
            self.events.append((name, time.perf_counter() - t0, steps))
            return out
        return clocked

    def __enter__(self):
        self.saved = {n: getattr(pipeline, n) for n in CLOCKED}
        for n, fn in self.saved.items():
            setattr(pipeline, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(pipeline, n, fn)

    def split(self) -> dict:
        """Seconds by stage over the block (every call summed), and the
        FM machine's first call (the device step's, before any retry):
        its seconds, slowest-lane steps and seconds a step."""
        out = {}
        for name, sec, _ in self.events:
            out[name] = out.get(name, 0.0) + sec
        fm = next(((s, k) for n, s, k in self.events
                   if n == "collect_seeds_device"), None)
        if fm is not None and fm[1]:
            out.update(fm_machine_s=fm[0], fm_machine_steps=fm[1],
                       fm_s_per_step=fm[0] / fm[1])
        return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warm-reads", type=int, default=WARM_READS)
    ap.add_argument("--timed-reads", type=int, default=TIMED_READS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the long-read leg needs a CUDA device")
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    genome = simulate_genome(GENOME_LEN, seed=GENOME_SEED)
    idx = build_index([("sim", genome)])
    t1 = time.perf_counter()
    al = Aligner.build(idx, AlignOptions(), device="cuda")
    t2 = time.perf_counter()
    print(f"{GENOME_LEN} b genome + build_index {t1 - t0:.1f} s, "
          f"Aligner.build {t2 - t1:.1f} s", flush=True)
    for seed, n in ((WARM_SEED, args.warm_reads),
                    (TIMED_SEED, args.timed_reads)):
        if n <= 0:
            continue
        sim, batch = simulate(genome, n, seed)
        with stage_clock() as clock:
            res = run_batch(al, batch)
        total = sum(res["seconds"].values())
        row = dict(seed=seed, warm_up=seed == WARM_SEED,
                   n_ovf=res["n_ovf"], **res["seconds"],
                   reads_per_s=n / total, bases_per_s=n * READ_LEN / total,
                   stages=clock.split(), events=clock.events,
                   **check(al, sim, batch, res["cols"]))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
