"""The leg of the port past 2^31 doubled bases (int64 ranks) on the card.

    python -m bioseqdb_tpu_torch.tools.big_leg [--genome-gb 1.1] [--index-dir DIR] [--index-shards N]

Simulates a genome of ``--genome-gb`` billion bases (default 1.1, seed
5: 2.2 G doubled bases, past the int32 rank range; the size of the JAX
package's ``tools/bigindex_check.py`` and ``tools/grch38_bench_leg.py``),
builds its index with the port's builder (the int64 SA-IS path), saves
it under ``--index-dir`` (default ``.big_leg/`` in the checkout, listed
in ``.gitignore``) and loads it from there on a later run. Then
``Aligner.build(idx, device="cuda")``, with nothing forced, must choose
int64 ranks, the FM seeder (the kmer table holds int32 positions), the
round-3 jump at depth 8 and a candidate stack of 24. Two batches of
16,384 150 bp reads at 1% substitutions (read seeds 500, the warm-up,
and 501, timed) go through ``device_regions`` -> ``absorb_overflow`` ->
``finalize_columns`` under ``long_leg.stage_clock``, as in
``tools/long_leg.py``. Each FM machine call of the warm-up batch is
recorded (``tools/fm_machine.py``) and then made again on the
``fm_seed`` kernel and on its plain twin: bit-equal on all six outputs,
with the largest mem rank (past 2^31 on this index), both times and the
steps.

``--index-shards N`` (N >= 2) runs the same two batches index-sharded
instead: N ranks (``dist/launch.py``; ``gloo`` on ``cuda:0`` when the
host has fewer GPUs than ranks, else ``nccl``), each mapping the saved
index and building its shard of the FM tables (``dist/shard_index.py``):
the warm-up batch, the timed batch clocked (``tools/dist_leg.py``'s
``summary``: the stage split and the collectives, a device sync around
each), then the timed batch unclocked for reads/s; the sharded
step runs the FM seeder without fetch sharing or the jump, and no
overflow retry (overflowed rows go to the host oracle). Past 2^31 with
int64 ranks is where a major checkpoint added outside the owner sum
shows (the JAX package's ``tools/bigindex_sharded_check.py``).

It prints JSON lines: the set-up (the genome, the build or the load, the
save, ``Aligner.build`` with its host pack of the doubled text and the
upload, the device tables' bytes and the choices made), then one line a
batch: each stage's host seconds, the device step's stage split (the FM
machine's seconds, its slowest lane's steps and seconds a step), reads/s,
reads at their simulated origin (``truth``), rows overflowing before the
retry, rows left to the host finalize, and ``ne_oracle`` over the reads
off truth (``long_leg.check``). Heavy: the build takes tens of GB of
host memory and tens of minutes. Needs a CUDA device; without one it
raises.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import resource
import time
import types

import torch

from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.index.fmindex import FMIndex
from bioseqdb_tpu_torch.tools import fm_machine, long_leg
from bioseqdb_tpu_torch.tools.shapes import card_line
from bioseqdb_tpu_torch.utils.sim import simulate_genome

GENOME_GB, GENOME_SEED = 1.1, 5
BATCH, READ_LEN = 16_384, 150
WARM_SEED, TIMED_SEED = 500, 501
INDEX_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".big_leg")


def emit(**row) -> None:
    """One JSON line, with the process's peak host memory so far."""
    kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    print(json.dumps(dict(row, peak_rss_gb=kb / 2**20)), flush=True)


def index_for(genome: str, path: str) -> tuple[FMIndex, dict]:
    """The genome's index: loaded from ``path`` when a build was saved
    there, else built and saved (a failed save is reported, not raised);
    with the seconds each part took."""
    t0 = time.perf_counter()
    if os.path.exists(os.path.join(path, "meta.json")):
        idx = FMIndex.load(path)
        return idx, dict(load_s=time.perf_counter() - t0)
    idx = build_index([("big", genome)])
    t1 = time.perf_counter()
    try:
        idx.save(path)
    except OSError as e:     # no room to keep it: the run goes on
        return idx, dict(build_index_s=t1 - t0, save_error=str(e))
    return idx, dict(build_index_s=t1 - t0,
                     save_s=time.perf_counter() - t1)


def device_bytes(al: Aligner) -> dict:
    """Bytes of the tables ``al`` holds on the card."""
    fm = sum(v.numel() * v.element_size() for v in al.fm
             if isinstance(v, torch.Tensor))
    return dict(fm_tables=fm,
                pac_rows=al.pac_rows.numel() * al.pac_rows.element_size(),
                jump=(al.jump.table.numel() * al.jump.table.element_size()
                      if al.jump is not None else 0))


def choices(al: Aligner) -> dict:
    """What ``Aligner.build`` chose for the index, unforced."""
    return dict(seq_len=int(al.index.seq_len),
                rank_dtype=str(al.fm.rank_dtype).removeprefix("torch."),
                seeder="kmer" if al.kmer is not None else "fm",
                jump_depth=al.jump.depth if al.jump is not None else 0,
                max_cand=al._step_kwargs(READ_LEN)[0]["max_cand"])


def run(al: Aligner, genome: str, seed: int, record: list | None = None
        ) -> dict:
    """One batch of the leg, clocked and checked; with ``record``, its
    FM machine calls are recorded there."""
    t0 = time.perf_counter()
    sim, batch = long_leg.simulate(genome, BATCH, seed, read_len=READ_LEN)
    sim_s = time.perf_counter() - t0
    rec = (fm_machine.recording(record) if record is not None
           else contextlib.nullcontext())
    with long_leg.stage_clock() as clock, rec:
        res = long_leg.run_batch(al, batch)
    total = sum(res["seconds"].values())
    t0 = time.perf_counter()
    chk = long_leg.check(al, sim, batch, res["cols"])
    return dict(seed=seed, warm_up=seed == WARM_SEED, simulate_s=sim_s,
                **res["seconds"], reads_per_s=BATCH / total,
                overflow=res["n_ovf"], stages=clock.split(),
                events=clock.events, **chk,
                check_s=time.perf_counter() - t0)


def machine_check(calls: list) -> list[dict]:
    """``fm_seed`` against its plain twin at each recorded machine call:
    bit-equal on all six outputs (raises if not); the kernel's time (CUDA
    events, median of 3), the plain twin's, the slowest lane's and the
    summed steps, and the largest mem rank (k)."""
    rows = []
    for call in calls:
        got = call.run()
        torch.cuda.synchronize()
        plain_ms, want, touched = call.plain_ms()
        err = fm_machine.max_abs_err(got, want)
        n = got["n_mem"].clamp(min=0, max=got["mems"].shape[1])
        held = (torch.arange(got["mems"].shape[1], device=n.device)[None]
                < n[:, None])
        rows.append(dict(
            shape=call.shape, max_abs_err=err, ms=call.kernel_ms(),
            plain_ms=plain_ms, slowest_steps=int(got["iters"].max()),
            summed_steps=int(got["iters"].sum()),
            extending_steps=touched["steps"],
            max_mem_k=int(got["mems"][..., 0][held].max())
            if held.any() else 0))
        if err != 0:
            raise AssertionError(f"fm_seed disagrees with plain: {rows[-1]}")
    return rows


def run_sharded(idx: FMIndex, path: str, genome: str, n_shards: int
                ) -> None:
    """The two batches on an ``index`` mesh of ``n_shards`` ranks, each
    loading the index saved at ``path``; one JSON line a batch."""
    from bioseqdb_tpu_torch.kernels import build
    from bioseqdb_tpu_torch.tools import dist_leg

    build.build()
    batches = {seed: long_leg.simulate(genome, BATCH, seed,
                                       read_len=READ_LEN)
               for seed in (WARM_SEED, TIMED_SEED)}
    # the timed batch's clocked run (its stage split and collectives)
    # comes between the warm-up and the unclocked run that gives reads/s
    jobs = [dict(kind="columns", batch=batches[WARM_SEED][1]),
            dict(kind="regions", batch=batches[TIMED_SEED][1], clock=True),
            dict(kind="columns", batch=batches[TIMED_SEED][1])]
    t0 = time.perf_counter()
    res, backend = dist_leg.spawn_tasks(
        [dict(cell=((n_shards,), ("index",)), idx=path, jobs=jobs)],
        n_shards, "cuda", timeout_s=3000.0,
        # rank 0 finalizes a batch (overflowed rows in the host oracle)
        # while the others wait in the next batch's first collective
        collective_timeout_s=1800.0)
    cell = res[0]["tasks"][0]
    emit(index_shards=n_shards, backend=backend,
         spawn_s=time.perf_counter() - t0, aligner_build_s=cell["build_s"])
    host = types.SimpleNamespace(index=idx, options=AlignOptions())
    for k, seed in ((0, WARM_SEED), (2, TIMED_SEED)):
        job = cell["jobs"][k]
        sec = job["seconds"]
        row = (dist_leg.summary(job, cell["jobs"][1], BATCH)
               if seed == TIMED_SEED else
               dict(**sec, reads_per_s=BATCH / sum(sec.values())))
        t0 = time.perf_counter()
        chk = long_leg.check(host, *batches[seed], job["cols"])
        emit(batch=dict(seed=seed, warm_up=seed == WARM_SEED, **row,
                        overflow=job["n_ovf"],
                        sw_extend=[r["tasks"][0]["jobs"][k]["sw_extend"]
                                   for r in res],
                        **chk, check_s=time.perf_counter() - t0))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-gb", type=float, default=GENOME_GB)
    ap.add_argument("--index-dir", default=None,
                    help=f"default: {INDEX_DIR}/<size>")
    ap.add_argument("--index-shards", type=int, default=1,
                    help="ranks of an index-sharded run (default 1: one "
                    "device, unsharded)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the big-index leg needs a CUDA device")
    n = int(args.genome_gb * 1e9)
    path = args.index_dir or os.path.join(INDEX_DIR, f"genome_{n}_seed5")
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    genome = simulate_genome(n, seed=GENOME_SEED)
    setup = dict(genome_bases=n, simulate_genome_s=time.perf_counter() - t0)
    emit(genome=setup, index_dir=path)    # before the long build
    idx, times = index_for(genome, path)
    setup.update(times, doubled_bases=int(idx.seq_len),
                 past_2_31=idx.seq_len >= 2**31, index_dir=path)
    emit(setup=setup)
    if args.index_shards > 1:
        if "save_error" in times:
            raise RuntimeError("the sharded run loads the saved index: "
                               + times["save_error"])
        run_sharded(idx, path, genome, args.index_shards)
        return
    t0 = time.perf_counter()
    al = Aligner.build(idx, AlignOptions(), device="cuda")
    torch.cuda.synchronize()
    chosen = choices(al)
    emit(aligner_build_s=time.perf_counter() - t0,
         device_bytes=device_bytes(al), choices=chosen,
         cuda_max_allocated=torch.cuda.max_memory_allocated())
    want = dict(rank_dtype="int64", seeder="fm", jump_depth=8, max_cand=24)
    if idx.seq_len >= 2**31 and any(chosen[k] != v for k, v in want.items()):
        raise AssertionError(f"choices past 2^31: {chosen}, not {want}")
    calls = []
    for seed in (WARM_SEED, TIMED_SEED):
        emit(batch=run(al, genome, seed,
                       record=calls if seed == WARM_SEED else None))
    emit(fm_seed_vs_plain=machine_check(calls))


if __name__ == "__main__":
    main()
