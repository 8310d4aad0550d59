"""The data-parallel and index-sharded leg of the port.

    python -m bioseqdb_tpu_torch.tools.dist_leg [--reads N] [--cpu]

Builds the index of the main path's genome (4.6 Mb, seed 1; at 4.6 Mb
its major checkpoints are nonzero) and one batch of 150 bp reads (read
seed 101, 16,384 by default), aligns it on one device FM-seeded (the
reference records), then spawns one process per rank
(``dist/launch.py``) for each cell:

- ``data`` 2: the kmer-seeded ``Aligner`` on a data mesh, each rank
  half the rows, its records held against a single-device kmer run;
- ``index`` 2: the FM tables split in two (``dist/shard_index.py``);
- ``data`` 2 x ``index`` 2 (4 ranks), on a quarter of the batch.

Ranks take ``cuda:(rank % device_count)`` with ``nccl`` when every rank
has a GPU of its own, else ``gloo`` (``launch.cuda_backend``); ``--cpu``
runs the ranks on the CPU with ``gloo``. Each cell runs its batch twice
in the same ranks: clocked first (``long_leg.stage_clock`` and
``kernels/fm.py``'s timed ``COLLECTIVES``, which synchronise the device
around each stage and each collective; this run is also the warm-up),
then unclocked. It prints one JSON line a cell: the backend, reads/s
and the stage seconds of the unclocked run; the clocked run's device
step, its stage seconds, the FM machine's slowest lane's steps and
seconds a step, and the collectives of the step (calls, bytes, seconds
and share of the clocked step); the reads at their simulated origin,
``ne_oracle`` over the reads off it, and the reads whose records differ
from the reference on rows that overflowed in neither run
(``rows_differ``).

``chip_smoke.py`` spawns ``run_tasks`` (``spawn_tasks``) and uses
``head``, ``rows_differ``, ``sam_by_read`` and ``summary`` for its dist
phase;
the tests spawn ``run_tasks`` and ``rank_stall`` on the CPU. Rank
functions must be module-level: a spawned child imports this module,
which imports the port alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from bioseqdb_tpu_torch.align import pipeline
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.dist import launch
from bioseqdb_tpu_torch.dist import mesh as dmesh
from bioseqdb_tpu_torch.dist import shard_index as dshard
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.tools import long_leg

GENOME_LEN, GENOME_SEED, READ_LEN, READ_SEED = 4_600_000, 1, 150, 101
BATCH = 16_384
CELLS = (("data", (2,), ("data",), "kmer"),
         ("index", (2,), ("index",), "fm"),
         ("data x index", (2, 2), ("data", "index"), "fm"))


def forbidden_modules() -> list[str]:
    """Modules of jax or the JAX package loaded in this process."""
    return sorted(k for k, v in sys.modules.items() if v is not None
                  and k.split(".")[0] in ("jax", "jaxlib", "bioseqdb_tpu"))


def _job(al: Aligner, job: dict, rank: int) -> dict:
    kind, batch = job["kind"], job["batch"]
    if kind == "regions":
        t0 = time.perf_counter()
        out = al.device_regions(batch)
        return dict(out=out, seconds=dict(
            device_regions=time.perf_counter() - t0))
    if kind == "align":
        t0 = time.perf_counter()
        res = al.align_batch(batch)
        return dict(results=res, seconds=dict(
            align_batch=time.perf_counter() - t0))
    if kind == "pairs":
        return dict(results=al.align_pairs(*batch))
    if kind == "columns":
        return long_leg.run_batch(al, batch, finalize=rank == 0)
    if kind == "queries":
        codes, lens = (torch.from_numpy(np.asarray(a)).to(al.device)
                       for a in (batch.codes, batch.lens))
        t0 = time.perf_counter()
        lo, hi = dshard.backward_search_sharded(al.fms, codes, lens, al.mesh)
        intervals = (lo.cpu().numpy(), hi.cpu().numpy())
        return dict(intervals=intervals, seconds=dict(
            backward_search_sharded=time.perf_counter() - t0))
    if kind == "shard_check":
        from bioseqdb_tpu_torch.tools import shard_calls

        return dict(shard=shard_calls.shard_check(al, batch,
                                                  search=job.get("search")))
    raise ValueError(f"job kind {kind!r}")


def _cell(rank: int, device_type: str, shape, names, idx, jobs: list
          ) -> dict:
    if isinstance(idx, str):         # a saved index: each rank maps it
        from bioseqdb_tpu_torch.index.fmindex import FMIndex

        idx = FMIndex.load(idx)
    dev = dmesh.rank_device(device_type)
    mesh = dmesh.make_mesh(shape, names, device_type)
    als, built, rows = {}, {}, []
    for job in jobs:
        key = (job.get("mode", "full"), job.get("seeder"))
        if key not in als:
            t0 = time.perf_counter()
            als[key] = Aligner.build(idx, AlignOptions(), device=dev,
                                     mode=key[0], seeder=key[1], mesh=mesh)
            built["/".join(str(k) for k in key)] = time.perf_counter() - t0
        build.reset_launches()
        kfm.reset_collectives(timed=bool(job.get("clock")))
        if job.get("clock"):
            with long_leg.stage_clock((pipeline, dshard)) as sc:
                r = _job(als[key], job, rank)
            r["stages"] = sc.split()
        else:
            r = _job(als[key], job, rank)
        r.update(**{k: build.LAUNCHES[k] for k in build.PATH_KERNELS},
                 collectives=dict(kfm.COLLECTIVES))
        kfm.reset_collectives()
        rows.append(r if rank == 0 else dict(
            {k: r[k] for k in build.PATH_KERNELS}, stages=r.get("stages"),
            collectives=r.get("collectives"), shard=r.get("shard"),
            intervals=r.get("intervals")))
    return dict(jobs=rows, build_s=built)


def _queries(device_type: str, world_size: int, idx, codes=None, lens=None,
             ranks=None, rank_dtype=None, sa_interval: int = 32) -> dict:
    dev = dmesh.rank_device(device_type)
    mesh = dmesh.make_mesh((world_size,), ("index",), device_type)
    fms = dshard.shard_index(idx, mesh, dev, rank_dtype=rank_dtype)
    out = dict(rank_dtype=str(fms.fm.rank_dtype),
               tables={k: getattr(fms.fm, k).cpu().numpy()
                       for k in ("blocks", "sa_cnt", "sa_words")},
               pac=fms.pac.cpu().numpy())
    if codes is not None:
        lo, hi = dshard.backward_search_sharded(
            fms, torch.from_numpy(codes).to(dev),
            torch.from_numpy(lens).to(dev), mesh)
        out.update(lo=lo.cpu().numpy(), hi=hi.cpu().numpy())
    if ranks is not None:
        out["pos"] = dshard.sa_resolve_sharded(
            fms, torch.from_numpy(ranks).to(dev, fms.fm.rank_dtype), mesh,
            sa_interval=sa_interval).cpu().numpy()
    return out


def run_tasks(rank: int, world_size: int, device_type: str, tasks: list
              ) -> dict:
    """A rank function: each task in order on this rank's device, and
    the modules of jax it loaded (``forbidden``).

    - ``dict(cell=(shape, names), idx=..., jobs=[...])`` (``idx`` an
      ``FMIndex`` or the directory of a saved one): the mesh
      ``shape`` x ``names``, an ``Aligner`` a (mode, seeder) pair of the
      jobs (``job["mode"]``, default full; ``job["seeder"]``), then each
      job: ``kind`` ``regions`` (``device_regions``), ``align``
      (``align_batch``), ``pairs`` (``align_pairs`` of a batch pair) or
      ``columns`` (``long_leg.run_batch``, finalized on rank 0) or, on
      an index mesh, ``queries`` (``backward_search_sharded`` of the
      batch's reads: ``intervals``, lo and hi, every rank) or
      ``shard_check`` (``shard_calls.shard_check``: the step's FM machine
      calls, SA walks, window fetches and ``resolve_seeds`` call,
      recorded, and the backward search of ``job["search"]`` (codes,
      lens) if given, on the kernels and on their plain twins, clocked;
      every rank returns it); with
      ``job["clock"]`` under ``long_leg.stage_clock`` and with the owner
      sums timed. Rank 0 returns the jobs' results; every rank the
      launches of each ``build.PATH_KERNELS`` kernel and
      ``kernels/fm.py``'s ``COLLECTIVES`` a job (counts zeroed just
      before the job and read just after), the stage split of a clocked
      job and the build seconds.
    - ``dict(queries=dict(idx=..., codes=, lens=, ranks=, rank_dtype=,
      sa_interval=))``: an ``index`` mesh of every rank, this rank's
      shard of ``idx`` (its tables as numpy), ``backward_search_sharded``
      of (codes, lens) and ``sa_resolve_sharded`` of ``ranks`` (each
      skipped when None)."""
    out = []
    for task in tasks:
        if "queries" in task:
            out.append(_queries(device_type, world_size, **task["queries"]))
        else:
            out.append(_cell(rank, device_type, *task["cell"], task["idx"],
                             task["jobs"]))
    return dict(rank=rank, tasks=out, forbidden=forbidden_modules())


def rank_stall(rank: int, world_size: int, stall_rank: int,
               seconds: float) -> int:
    """A rank function for the launcher's deadline: every rank but
    ``stall_rank`` enters an all_reduce, which ``stall_rank`` never
    joins (it sleeps ``seconds``)."""
    if rank == stall_rank:
        time.sleep(seconds)
        return rank
    t = torch.ones(1)
    torch.distributed.all_reduce(t)
    return int(t.item())


def head(batch, n: int):
    """The first ``n`` reads of a batch."""
    return dataclasses.replace(batch, codes=batch.codes[:n],
                               lens=batch.lens[:n], names=batch.names[:n])


def rows_differ(a, b, rows) -> list[int]:
    """The rows of ``rows`` whose records differ between two batches'
    ``AlignColumns``: every primary column, the CIGAR and MD, and the
    per-read result where either keeps one."""
    out = []
    fields = ("mapped", "fast", "pos", "ref_end", "rid", "mapq", "nm",
              "score", "sub", "is_rev", "qb", "qe")
    for i in np.asarray(rows).tolist():
        same = all(getattr(a, f)[i] == getattr(b, f)[i] for f in fields)
        same = same and a.cigar(i) == b.cigar(i) and a.md(i) == b.md(i)
        ea, eb = a.extra.get(i), b.extra.get(i)
        if ea is not None or eb is not None:
            same = same and (ea is not None and eb is not None and
                             dataclasses.asdict(ea) == dataclasses.asdict(eb))
        if not same:
            out.append(i)
    return out


def sam_by_read(sam: str) -> dict:
    """SAM records grouped by read name (QNAME), in order."""
    out = {}
    for line in sam.splitlines():
        out.setdefault(line.split("\t", 1)[0], []).append(line)
    return out


def summary(timed: dict, clocked: dict, n: int) -> dict:
    """A cell's numbers from two runs of one batch: stage seconds and
    reads/s from ``timed``, an unclocked columns job; from ``clocked``
    (its clock synchronises the device around each stage and each
    collective) the device step's stages, the FM machine's slowest
    lane's steps and seconds a step, and the collectives (calls, bytes,
    seconds and their share of the clocked device step)."""
    sec = timed["seconds"]
    st = clocked["stages"]
    co = clocked["collectives"]
    row = dict(**sec, reads_per_s=n / sum(sec.values()),
               clocked_step=clocked["seconds"]["device_regions"],
               step_stages={k: st[k] for k in long_leg.CLOCKED if k in st},
               collectives=co,
               collective_share=co["seconds"]
               / clocked["seconds"]["device_regions"])
    if "fm_machine_steps" in st:
        row.update(fm_steps=st["fm_machine_steps"],
                   fm_ms_per_step=1e3 * st["fm_s_per_step"])
    return row


def spawn_tasks(tasks: list, world: int, device_type: str,
                timeout_s: float = 900.0, collective_timeout_s: float = 120.0
                ) -> tuple[list, str]:
    """``run_tasks`` in ``world`` ranks through ``launch.spawn``; (their
    returns, the backend). Raises when a rank loaded jax."""
    backend = (launch.cuda_backend(world) if device_type == "cuda"
               else "gloo")
    res = launch.spawn(run_tasks, world, backend,
                       args=(device_type, tasks), timeout_s=timeout_s,
                       collective_timeout_s=collective_timeout_s)
    bad = [r["forbidden"] for r in res if r["forbidden"]]
    if bad:
        raise AssertionError(f"a rank imported jax or the JAX package: {bad}")
    return res, backend


def main(argv=None) -> None:
    from bioseqdb_tpu_torch.index.builder import build_index
    from bioseqdb_tpu_torch.tools.shapes import card_line
    from bioseqdb_tpu_torch.utils.sim import simulate_genome

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=BATCH)
    ap.add_argument("--cpu", action="store_true",
                    help="ranks on the CPU (gloo)")
    args = ap.parse_args(argv)
    device_type = "cpu" if args.cpu else "cuda"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the dist leg needs a CUDA device (or --cpu)")
        print(card_line(), flush=True)
        build.build()
    t0 = time.perf_counter()
    genome = simulate_genome(GENOME_LEN, seed=GENOME_SEED)
    idx = build_index([("sim", genome)])
    sim, batch = long_leg.simulate(genome, args.reads, READ_SEED, READ_LEN)
    print(json.dumps(dict(setup_s=time.perf_counter() - t0)), flush=True)
    dev = "cpu" if args.cpu else "cuda"
    ref = {}
    for seeder in ("kmer", "fm"):
        al = Aligner.build(idx, AlignOptions(), device=dev, seeder=seeder)
        ref[seeder] = (al, long_leg.run_batch(al, batch))
    for name, shape, names, seeder in CELLS:
        b = head(batch, args.reads // 4) if len(shape) == 2 else batch
        # the clocked run (the stage split and the collectives) is also
        # the ranks' warm-up; reads/s and the records come from the
        # unclocked run after it
        jobs = [dict(kind="regions", batch=b, seeder=seeder, clock=True),
                dict(kind="columns", batch=b, seeder=seeder)]
        t0 = time.perf_counter()
        res, backend = spawn_tasks(
            [dict(cell=(shape, names), idx=idx, jobs=jobs)],
            int(np.prod(shape)), device_type)
        cell = res[0]["tasks"][0]
        clocked, job = cell["jobs"]
        al, want = ref[seeder]
        n = b.n
        both = np.flatnonzero(~job["ovf"] & ~want["ovf"][:n])
        diff = rows_differ(job["cols"], want["cols"], both)
        sim_b = dataclasses.replace(sim, positions=sim.positions[:n],
                                    strands=sim.strands[:n])
        print(json.dumps(dict(
            cell=name, backend=backend, ranks=len(res),
            spawn_s=time.perf_counter() - t0,
            build_s=cell["build_s"],
            **{k: sum(r["tasks"][0]["jobs"][1][k] for r in res)
               for k in build.PATH_KERNELS},
            **summary(job, clocked, n), overflow=int(job["n_ovf"]),
            compared=int(both.size), rows_differ=len(diff),
            **long_leg.check(al, sim_b, b, job["cols"]))), flush=True)

if __name__ == "__main__":
    main()
