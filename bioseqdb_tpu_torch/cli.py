"""Command-line interface of the port.

The port of ``bioseqdb_tpu/cli.py``, with the same commands, flags and
defaults:
- ``index`` / ``align``: the engine proper (the role the SQL functions
  nuclseq_search_bwa / nuclseq_multi_search_bwa played,
  extension.cpp:311-378), bwa-style invocation.
- ``import``: the bioseqdb-import analogue (bioseqdb-import/main.cpp):
  streams FASTA/FASTQ into packed .npz read-batch shards, with a
  manifest so an interrupted import resumes.

``index`` writes the file format the JAX package reads, and ``import``
the same shards. ``align`` runs on the card unless ``--cpu`` is given;
without a card it fails, and nothing falls back to the CPU. A full-mode
batch whose device step fails is run once more; when it fails twice it
is reported on standard error and skipped, and ``align`` still exits 0,
as the JAX CLI does.

Usage:
    python -m bioseqdb_tpu_torch index ref.fa -o ref.idx
    python -m bioseqdb_tpu_torch align ref.idx reads.fq -o out.sam
    python -m bioseqdb_tpu_torch import reads.fq -o shards/ --batch-size 65536
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

from bioseqdb_tpu_torch.align.columns import finalize_columns
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.index.builder import build_index_from_fasta
from bioseqdb_tpu_torch.index.fmindex import FMIndex
from bioseqdb_tpu_torch.io.batch import pack_reads_from_file
from bioseqdb_tpu_torch.sam.emit import (emit_sam, emit_sam_columns,
                                         emit_sam_pair_columns, sam_header)
from bioseqdb_tpu_torch.utils.profiling import StageTimer, device_trace


def _cmd_index(args) -> int:
    t0 = time.time()
    idx = build_index_from_fasta(args.fasta, sa_interval=args.sa_interval)
    idx.save(args.output)
    print(
        f"[bioseqdb-tpu] indexed {idx.n_refs} sequence(s), {idx.l_pac} bases "
        f"in {time.time() - t0:.2f}s -> {args.output}",
        file=sys.stderr,
    )
    return 0


def _cmd_align(args) -> int:
    idx = FMIndex.load(args.index)
    opts = AlignOptions(
        min_seed_len=args.min_seed_len,
        max_occ=args.max_occ,
        match_score=args.match_score,
        mismatch_penalty=args.mismatch_penalty,
        o_del=args.open_del, e_del=args.ext_del,
        o_ins=args.open_ins, e_ins=args.ext_ins,
        pen_clip5=args.clip5, pen_clip3=args.clip3,
        zdrop=args.zdrop, bandwidth=args.bandwidth,
        min_score=args.min_score,
    )
    aligner = Aligner.build(idx, opts, device="cpu" if args.cpu else "cuda",
                            mode=args.mode)
    out = open(args.output, "w") if args.output != "-" else sys.stdout
    timer = StageTimer()
    trace = (device_trace(args.profile) if args.profile
             else contextlib.nullcontext())
    t0 = time.time()
    n = 0
    try:
        out.write(sam_header(idx, program_args=" ".join(sys.argv[1:]),
                             read_group=args.rg))
        if args.mate:
            it1 = pack_reads_from_file(args.reads, batch_size=args.batch_size)
            it2 = pack_reads_from_file(args.mate, batch_size=args.batch_size)
            with trace:
                for b1, b2 in zip(it1, it2):
                    with timer.stage("align_pe", b1.n + b2.n):
                        c1, c2 = aligner.align_pairs_columns(b1, b2)
                        s1 = [b1.read_text(i) for i in range(b1.n)]
                        s2 = [b2.read_text(i) for i in range(b2.n)]
                        out.write(emit_sam_pair_columns(
                            c1, c2, idx, b1, b2, header=False,
                            seqs1=s1, seqs2=s2, read_group=args.rg))
                    n += b1.n + b2.n
        elif args.mode == "exact":
            with trace:
                for batch in pack_reads_from_file(
                        args.reads, batch_size=args.batch_size):
                    with timer.stage("align", batch.n):
                        results = aligner.align_batch(batch)
                        seqs = [batch.read_text(i) for i in range(batch.n)]
                        out.write(emit_sam(results, idx, seqs,
                                           batch.qualities, header=False,
                                           read_group=args.rg))
                    n += batch.n
        else:
            # device_regions returns host arrays, so the device step of
            # batch k+1 does not overlap the host's finalize of batch k
            # (the JAX CLI dispatches it first)
            with trace:
                for batch in pack_reads_from_file(
                        args.reads, batch_size=args.batch_size):
                    if _align_full_batch(aligner, idx, batch, out, timer,
                                         args.rg):
                        n += batch.n
    finally:
        if out is not sys.stdout:
            out.close()
    dt = time.time() - t0
    timer.report()
    print(
        f"[bioseqdb-tpu] aligned {n} reads in {dt:.2f}s "
        f"({n / max(dt, 1e-9):,.0f} reads/s)",
        file=sys.stderr,
    )
    return 0


def _align_full_batch(aligner, idx, batch, out, timer,
                      read_group=None) -> bool:
    """Align, finalize and write one full-mode batch; False when it failed
    twice and was skipped. Reads are stateless work items, so recovery is
    batch-granular (SURVEY.md section 5): a failed batch is run once more
    from the host copy before it is reported and skipped. Stages:
    ``device_dispatch`` the device step (it returns host arrays),
    ``device_wait`` the overflow rows' device retry, ``finalize`` the host
    finalize and the SAM text."""
    for attempt in (1, 2):
        try:
            with timer.stage("device_dispatch"):
                regions = aligner.device_regions(batch)
            with timer.stage("device_wait", batch.n):
                regions = aligner.absorb_overflow(batch, regions)
            with timer.stage("finalize", batch.n):
                cols = finalize_columns(idx, aligner.options, batch, regions)
                seqs = [batch.read_text(i) for i in range(batch.n)]
                text = emit_sam_columns(cols, idx, batch, header=False,
                                        seqs=seqs, read_group=read_group)
            out.write(text)
            return True
        except Exception as e:  # a device fault: retry the batch once
            if attempt == 2:
                print(f"[bioseqdb-tpu] batch of {batch.n} reads failed twice "
                      f"({type(e).__name__}: {e}); skipping", file=sys.stderr)
                return False
            print(f"[bioseqdb-tpu] batch failed ({type(e).__name__}); "
                  "retrying once", file=sys.stderr)
    return False


def _cmd_import(args) -> int:
    """Bulk ingest with a per-shard manifest so interrupted imports resume
    (SURVEY.md section 5: batch-granular recovery, unlike the reference's
    all-or-nothing single transaction, main.cpp:46,73)."""
    os.makedirs(args.output, exist_ok=True)
    manifest_path = os.path.join(args.output, "manifest.json")
    done: dict = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as fh:
            done = json.load(fh).get("shards", {})
        print(f"[bioseqdb-tpu] resuming: {len(done)} shard(s) present",
              file=sys.stderr)
    n = 0
    shards = dict(done)
    for i, batch in enumerate(
            pack_reads_from_file(args.reads, batch_size=args.batch_size)):
        name = f"shard{i:05d}.npz"
        path = os.path.join(args.output, name)
        if name in done and os.path.exists(path):
            n += batch.n
            continue
        # np.savez appends ".npz" to a name that lacks it
        tmp = path + ".tmp"
        np.savez_compressed(tmp, codes=batch.codes, lens=batch.lens,
                            names=np.array(batch.names))
        os.replace(tmp + ".npz", path)
        shards[name] = batch.n
        with open(manifest_path, "w") as fh:
            json.dump({"source": str(args.reads), "shards": shards}, fh)
        n += batch.n
        print(f"[bioseqdb-tpu] wrote {name} ({batch.n} reads)",
              file=sys.stderr)
    print(f"[bioseqdb-tpu] imported {n} reads", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bioseqdb-tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("index", help="build an FM-index from FASTA")
    pi.add_argument("fasta")
    pi.add_argument("-o", "--output", required=True)
    pi.add_argument("--sa-interval", type=int, default=None)
    pi.set_defaults(fn=_cmd_index)

    pa = sub.add_parser("align",
                        help="align FASTA/FASTQ reads against an index")
    pa.add_argument("index")
    pa.add_argument("reads")
    pa.add_argument("--mate", help="mate FASTA/FASTQ for paired-end alignment")
    pa.add_argument("-o", "--output", default="-")
    pa.add_argument("--batch-size", type=int, default=2048)
    # scoring/heuristic knobs mirroring bwa mem's flags and the reference
    # SQL bwa_options fields (bioseqdb--0.0.0.sql:160-194)
    pa.add_argument("-k", "--min-seed-len", type=int, default=19)
    pa.add_argument("-c", "--max-occ", type=int, default=None)
    pa.add_argument("-A", "--match-score", type=int, default=1)
    pa.add_argument("-B", "--mismatch-penalty", type=int, default=4)
    pa.add_argument("-O", "--open-del", type=int, default=6)
    pa.add_argument("-E", "--ext-del", type=int, default=1)
    pa.add_argument("--open-ins", type=int, default=6)
    pa.add_argument("--ext-ins", type=int, default=1)
    pa.add_argument("-L5", "--clip5", type=int, default=5)
    pa.add_argument("-L3", "--clip3", type=int, default=5)
    pa.add_argument("-d", "--zdrop", type=int, default=100)
    pa.add_argument("-w", "--bandwidth", type=int, default=100)
    pa.add_argument("-T", "--min-score", type=int, default=30)
    pa.add_argument("-R", "--rg",
                    help="@RG header line (\\t-separated, bwa -R style)")
    pa.add_argument(
        "--mode", choices=["full", "exact"], default="full",
        help="full BWA-MEM pipeline or the exact-match fast path (exact: "
             "fast path with approximate MAPQ=60/0 and no NM/MD)")
    pa.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain torch kernels); without it "
                         "the CUDA device, and no card is an error")
    pa.add_argument("--profile",
                    help="write a torch.profiler Chrome trace into this "
                         "directory")
    pa.set_defaults(fn=_cmd_align)

    pm = sub.add_parser("import",
                        help="pack reads into .npz shards (bulk ingest)")
    pm.add_argument("reads")
    pm.add_argument("-o", "--output", required=True)
    pm.add_argument("--batch-size", type=int, default=65536)
    pm.set_defaults(fn=_cmd_import)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
