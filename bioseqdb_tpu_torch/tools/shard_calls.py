"""The index mesh's sharded FM machine and SA walk, held against their
plain twins.

``csrc/fm_shard.cu``'s four kernels (``kernels/fm_shard_cuda.py``) run
the FM machine (``seed.collect_seeds_sharded``) and the SA walk
(``fm.sa_walk_sharded``) of an index group, a query launch, an
``all_reduce`` and an apply launch a step. Here:

- ``host_library`` builds the source for the host with g++ (its
  ``*_host`` entries), so that ``pair_rank``, a rank function for
  ``dist/launch.py``, runs the same loops on CPU tensors in gloo ranks
  (``tests/test_torch_shard_machine.py``), or on the card
  (``tests/test_torch_dist_cuda.py``), and returns both routes' outputs
  and ``COLLECTIVES``;
- ``edge_refs`` / ``edge_batches`` make the tests' references and
  reads: a genome with a repeat of its start, 120 bp and 250 bp reads
  with ambiguous, empty, all-N, junk, repeat-crossing and text-edge
  ones;
- ``machine_pair`` / ``walk_pair`` run one call on the kernels and on
  the plain twin under the group (on the card, with ``clock``, each
  launch and each ``all_reduce`` between CUDA events, through wrapped
  entries and a wrapped ``kfm._all_reduce``, and the plain twin's
  seconds with its ``all_reduce`` timed apart), ``recording`` records
  the calls an index-mesh step makes, ``shard_check`` runs both routes
  on them (``tools/dist_leg.py``'s ``shard_check`` job, which
  ``chip_smoke.py``'s dist phase runs), ``launch_ms`` times a launch in
  a CUDA graph and ``machine_bytes`` / ``walk_bytes`` give the bytes
  that launch must move, its bound's numerator.
"""

from __future__ import annotations

import contextlib
import ctypes
import shutil
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from bioseqdb_tpu_torch.dist import mesh as dmesh
from bioseqdb_tpu_torch.dist import shard_index as dshard
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels import fm_shard_cuda as fsc
from bioseqdb_tpu_torch.kernels import seed
from bioseqdb_tpu_torch.utils.sim import simulate_genome, simulate_reads

MACHINE_OUTPUTS = ("mems", "n_mem", "overflow", "iters", "it_r1", "it_r2")
MACHINE_KW = ("min_seed_len", "split_len", "split_width", "max_mem_intv",
              "max_cand", "max_mem", "max_iters", "entry_reseed",
              "reseed_entry")


def host_library(out_dir) -> Path:
    """csrc/fm_shard.cu built for the host with g++ (its host entries) in
    ``out_dir``; the path, which a rank process loads (``pair_rank``).
    Raises without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    so = Path(out_dir) / "libfm_shard_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-o", str(so),
                    str(build.CSRC / build.SOURCES["fm_shard"])], check=True)
    return so


def edge_refs(genome: str, seed_: int = 82) -> list:
    """The references the tests index: ``genome`` and a second contig
    that repeats its first 400 bases, then a T, then 2 kb of its own
    (``seed_``). On seed 81's 30 kb genome (a G after those 400 bases)
    the whole text sorts first among the suffixes that start with the
    repeat, so a forward extension's interval starts at the primary rank
    (its ``$`` test at the edge), and reads across the repeat's end give
    a backward row two long candidates."""
    return [("ref", genome),
            ("rep", genome[:400] + "T" + simulate_genome(2000, seed=seed_))]


def edge_batches(refs: list, seed_: int = 5):
    """The CPU tests' two batches on ``edge_refs``: (short, wide). Short:
    20 simulated 120 bp reads, one with Ns scattered through it, an
    empty read, an all-N read, a junk read (random bases), 16 reads
    across the repeat's end with two substitutions each and their
    reverse complements' 2 (both strands), and three across the text's
    end (the reverse complement of the genome's start, then what follows
    it in the repeat's copy, or junk), W 120. Wide: four simulated 250 bp
    reads, a 120 bp one, a 250 bp read with an N run, a junk one and an
    empty one, W 250 (past the full step's 200-base caps)."""
    genome, rep = refs[0][1], refs[1][1]
    rng = np.random.default_rng(seed_)
    junk = lambda n: "".join(rng.choice(list("ACGT"), n))
    rc = lambda s: s[::-1].translate(str.maketrans("ACGTN", "TGCAN"))

    def with_ns(s: str) -> str:
        s = list(s)
        for p in rng.choice(len(s), 6, replace=False):
            s[p] = "N"
        return "".join(s)

    def subs(s: str, k: int) -> str:
        s = list(s)
        for p in rng.choice(len(s), k, replace=False):
            s[p] = "ACGT"[("ACGT".index(s[p]) + 1) % 4]
        return "".join(s)

    short = simulate_reads(genome, 20, read_len=120, sub_rate=0.03,
                           seed=seed_).reads
    short += [with_ns(short[0]), "", "N" * 120, junk(120)]
    for st in range(300, 400, 12):
        r = subs(rep[st:st + 120], 2)
        short += [r, rc(r)]
    short += [rc(genome[:60]) + rc(genome[-60:]),
              rc(genome[:80]) + rc(genome[-40:]), rc(genome[:60]) + junk(60)]
    wide = simulate_reads(genome, 4, read_len=250, sub_rate=0.03,
                          seed=seed_ + 1).reads
    w = wide[1]
    wide += [short[1], w[:100] + "N" * 12 + w[112:], junk(250), ""]
    return (pack_reads(short, [f"s{k}" for k in range(len(short))]),
            pack_reads(wide, [f"w{k}" for k in range(len(wide))]))


def unmarked_primary(fm, shard: int):
    """This rank's shard ``fm`` with the primary rank's mark bit cleared
    where the rank owns its word (``fm_calls.unmarked_primary`` on a
    shard): a walk that reaches the primary then takes its LF step (rank
    0), as no real index does."""
    w = (fm.primary >> 5) - shard * fm.sa_words.shape[0]
    if not 0 <= w < fm.sa_words.shape[0]:
        return fm
    words = fm.sa_words.clone()
    v = int(words[w]) & 0xFFFFFFFF & ~(1 << (fm.primary & 31))
    words[w] = v - (1 << 32) if v >= 1 << 31 else v
    return fm._replace(sa_words=words)


def machine_call(batch, opt, **kw) -> dict:
    """A machine call on ``batch``'s reads with ``opt``'s seeding options
    and the full step's caps (``dist/shard_index.py``: max_cand and
    max_mem 16 up to 200 bases wide), ``kw`` on top."""
    W = batch.codes.shape[1]
    caps = dict(max_cand=16, max_mem=16) if W <= 200 else {}
    as_i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32)
    return dict(codes=as_i32(batch.codes), lens=as_i32(batch.lens),
                kw=dict(min_seed_len=opt.min_seed_len,
                        split_len=int(opt.min_seed_len * opt.reseed_factor
                                      + 0.499),
                        split_width=opt.split_width,
                        max_mem_intv=opt.max_mem_intv, **caps, **kw))


def _to(call: dict, dev) -> dict:
    return dict(call, codes=call["codes"].to(dev), lens=call["lens"].to(dev))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _events(events: list) -> dict:
    """{name: (launches, lanes, device ms summed)} of (name, start event,
    end event, lanes) tuples."""
    out = {}
    for name, e0, e1, lanes in events:
        n, ln, ms = out.get(name, (0, 0, 0.0))
        out[name] = (n + 1, ln + lanes, ms + e0.elapsed_time(e1))
    return out


def _event_pair():
    return tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))


@contextlib.contextmanager
def _clocked(on: bool, dev):
    """When ``on`` (on the card): yields (entries, sums): the card's
    entries, each launch between two CUDA events, with ``kfm._all_reduce``
    wrapped the same way for the block; ``sums`` gets ``_events``' sums
    after it. Otherwise (None, {})."""
    sums = {}
    if not on or dev.type != "cuda":
        yield None, sums
        return
    events, card, reduce = [], fsc.card_entries(), kfm._all_reduce

    def entry(name):
        def call(args, lanes: int, device) -> None:
            e0, e1 = _event_pair()
            e0.record()
            card[name](args, lanes, device)
            e1.record()
            events.append((name, e0, e1, lanes))
        return call

    def all_reduce(buf, group) -> None:
        e0, e1 = _event_pair()
        e0.record()
        reduce(buf, group)
        e1.record()
        events.append(("all_reduce", e0, e1, 0))

    kfm._all_reduce = all_reduce
    try:
        yield {name: entry(name) for name in fsc.ENTRIES}, sums
        _sync(dev)
        sums.update(_events(events))
    finally:
        kfm._all_reduce = reduce


def machine_pair(fm, group, call: dict, entries: dict | None = None,
                 clock: bool = False) -> dict:
    """``call`` (``machine_call``'s dict, on ``fm``'s device) on the
    kernels (``seed.collect_seeds_sharded``; ``entries`` None: the card's)
    and on the plain twin (``collect_seeds_plain``) under ``group``:
    each route's outputs (numpy) and ``COLLECTIVES`` (calls, bytes), and
    with ``clock`` (on the card) the kernels' launch and all_reduce
    events (``events``: name -> launches, lanes, ms), both routes'
    seconds and the plain twin's ms a step outside its all_reduce
    (``plain_step_ms``, a list of one)."""
    dev = fm.L2.device
    call = _to(call, dev)
    out = {}
    for route in ("kernel", "plain"):
        kfm.reset_collectives(timed=clock and route == "plain")
        with _clocked(clock and route == "kernel", dev) as (clocked, ev):
            _sync(dev)
            t0 = time.perf_counter()
            if route == "kernel":
                res = seed.collect_seeds_sharded(
                    fm, call["codes"], call["lens"], group=group,
                    entries=clocked or entries, **call["kw"])
            else:
                res = seed.collect_seeds_plain(
                    fm, call["codes"], call["lens"], group=group,
                    **call["kw"])
            _sync(dev)
            sec = time.perf_counter() - t0
        out[route] = dict(out={k: res[k].cpu().numpy()
                               for k in MACHINE_OUTPUTS},
                          collectives=dict(kfm.COLLECTIVES), seconds=sec,
                          events=ev, plain_step_ms=[_plain_step_ms(sec)])
        kfm.reset_collectives()
    return out


def _plain_step_ms(sec: float) -> float:
    """A timed run's ms a step outside its all_reduce (``COLLECTIVES``
    of that run)."""
    co = kfm.COLLECTIVES
    return 1e3 * (sec - co["seconds"]) / max(co["calls"], 1)


def walk_pair(fm, group, ranks: torch.Tensor, sa_interval: int,
              mask: torch.Tensor | None = None,
              entries: dict | None = None, clock: bool = False,
              plain_reps: int = 3) -> dict:
    """``machine_pair`` for the SA walk: ``fm.sa_walk_sharded`` and
    ``fm.sa_resolve_plain`` under ``group`` on ``ranks`` (and ``mask``).
    With ``clock`` the plain twin runs once untimed, then ``plain_reps``
    times timed (``plain_step_ms``: each run's ms a step outside its
    all_reduce; the outputs and collectives are the last run's)."""
    dev = fm.L2.device
    r = ranks.to(dev, fm.rank_dtype)
    m = None if mask is None else mask.to(dev)
    out = {}
    for route in ("kernel", "plain"):
        reps = plain_reps if clock and route == "plain" else 1
        if reps > 1:
            kfm.sa_resolve_plain(fm, r, sa_interval, group, m)   # warm-up
        step_ms = []
        for _ in range(reps):
            kfm.reset_collectives(timed=clock and route == "plain")
            with _clocked(clock and route == "kernel", dev) as (clocked,
                                                                ev):
                _sync(dev)
                t0 = time.perf_counter()
                if route == "kernel":
                    pos = kfm.sa_walk_sharded(fm, r, sa_interval, group, m,
                                              clocked or entries)
                else:
                    pos = kfm.sa_resolve_plain(fm, r, sa_interval, group, m)
                _sync(dev)
                sec = time.perf_counter() - t0
            step_ms.append(_plain_step_ms(sec))
        out[route] = dict(out=dict(pos=pos.cpu().numpy()),
                          collectives=dict(kfm.COLLECTIVES), seconds=sec,
                          events=ev, plain_step_ms=step_ms)
        kfm.reset_collectives()
    return out


def pair_equal(pair: dict) -> bool:
    """Both routes' outputs bit-equal, and their all_reduce calls and
    bytes equal."""
    k, p = pair["kernel"], pair["plain"]
    return (all(np.array_equal(k["out"][n], p["out"][n]) for n in p["out"])
            and all(k["collectives"][n] == p["collectives"][n]
                    for n in ("calls", "bytes")))


def pair_rank(rank: int, world_size: int, device_type: str,
              lib_path: str | None, idx, calls: list, walks: list,
              rank_dtypes: tuple = (torch.int32,)) -> dict:
    """A rank function (``dist/launch.py``): an index mesh of every rank
    on ``device_type``, this rank's shard of ``idx`` at each of
    ``rank_dtypes``, and for each ``machine_call`` of ``calls`` and each
    walk of ``walks`` (dict(ranks=, sa_interval=, mask=,
    unmarked_primary=): the last on ``unmarked_primary``'s shard) the pair of
    routes (``machine_pair`` / ``walk_pair``): the kernels on the card
    (``lib_path`` None), or on the CPU through the host build at
    ``lib_path``. On the CPU, then the dispatchers on CPU tensors under
    the group (``collect_seeds_device`` on the first call's first two
    reads at a 40-step budget, ``sa_resolve`` on the first walk), which
    must take the plain twins and never build or load a library
    (``built``: ``build.library``'s loads). Returns dict(rank, dtypes:
    [{machine: [...], walks: [...]}], dispatch, built, launches (of the
    shard kernels), forbidden)."""
    from bioseqdb_tpu_torch.tools.dist_leg import forbidden_modules

    entries = (None if lib_path is None
               else fsc.host_entries(ctypes.CDLL(lib_path)))
    dev = dmesh.rank_device(device_type)
    mesh = dmesh.make_mesh((world_size,), ("index",), device_type)
    group = mesh.get_group("index")
    out = []
    for rdt in rank_dtypes:
        fm = dshard.shard_index(idx, mesh, dev, rank_dtype=rdt).fm
        out.append(dict(
            rank_dtype=str(fm.rank_dtype),
            machine=[machine_pair(fm, group, c, entries) for c in calls],
            walks=[walk_pair(unmarked_primary(fm, dist.get_rank(group))
                             if w.get("unmarked_primary") else fm, group,
                             w["ranks"], w["sa_interval"], w.get("mask"),
                             entries) for w in walks]))
    dispatch = None
    if device_type == "cpu":
        fm = dshard.shard_index(idx, mesh, dev).fm
        c = calls[0]
        kw = dict(c["kw"], max_iters=40)
        got = seed.collect_seeds_device(fm, c["codes"][:2], c["lens"][:2],
                                        group=group, **kw)
        want = seed.collect_seeds_plain(fm, c["codes"][:2], c["lens"][:2],
                                        group=group, **kw)
        w = walks[0]
        r = w["ranks"].to(fm.rank_dtype)
        dispatch = (all(torch.equal(got[k], want[k])
                        for k in MACHINE_OUTPUTS)
                    and torch.equal(
                        kfm.sa_resolve(fm, r, w["sa_interval"], group),
                        kfm.sa_resolve_plain(fm, r, w["sa_interval"], group)))
    return dict(rank=rank, dtypes=out, dispatch=dispatch,
                built=build.library.cache_info().misses,
                launches={k: build.LAUNCHES[k] for k in build.SHARD_KERNELS},
                forbidden=forbidden_modules())


@contextlib.contextmanager
def recording():
    """Within the block, every FM machine call and SA walk the index
    mesh's step makes (``dist/shard_index.py``'s ``collect_seeds_device``,
    ``kernels/chain.py``'s ``kfm.sa_resolve`` under a group) is recorded
    in the yielded dict: ``machine`` (``machine_call``'s dicts, inputs on
    the CPU) and ``walks`` (dict(ranks, sa_interval, mask)); the calls
    still run."""
    from bioseqdb_tpu_torch.kernels import chain

    rec = dict(machine=[], walks=[])
    collect, resolve = dshard.collect_seeds_device, chain.kfm.sa_resolve

    def collect_rec(fm, codes, lens, **kw):
        rec["machine"].append(dict(
            codes=codes.to(torch.int32).cpu(),
            lens=lens.to(torch.int32).cpu(),
            kw={k: v for k, v in kw.items() if k in MACHINE_KW}))
        return collect(fm, codes, lens, **kw)

    def resolve_rec(fm, ranks, sa_interval=32, group=None, mask=None):
        if group is not None:
            rec["walks"].append(dict(
                ranks=ranks.cpu(), sa_interval=sa_interval,
                mask=None if mask is None else mask.cpu()))
        return resolve(fm, ranks, sa_interval, group, mask)

    dshard.collect_seeds_device = collect_rec
    chain.kfm.sa_resolve = resolve_rec
    try:
        yield rec
    finally:
        dshard.collect_seeds_device = collect
        chain.kfm.sa_resolve = resolve


def _occ_blocks(fm, r: torch.Tensor, shard: int):
    """The global Occ block of each conceptual rank ``r`` and whether this
    rank (``shard``) owns its octo row (csrc/fm_shard.cu shard_row)."""
    jr = r - (r > fm.primary).to(r.dtype)
    blk = jr >> kfm.LOG2_OCC_BLOCK
    local = (blk >> 3) - shard * fm.blocks.shape[0]
    return blk, (local >= 0) & (local < fm.blocks.shape[0])


def _distinct(t: torch.Tensor) -> int:
    return int(torch.unique(t).numel())


def _majors(fm, blk: torch.Tensor) -> torch.Tensor:
    """The major row of each Occ block (csrc/occ.cuh major_index)."""
    return (blk >> kfm.LOG2_MAJOR).clamp(0, fm.occ_majors.shape[0] - 1)


def _sources(st: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Each lane's two queried ranks, a and a + s, from its post-pivot
    state (csrc/fm_shard.cu source): the prev row of a backward pass,
    else the bi-interval."""
    P = st["prev"].shape[1]
    j = torch.where(st["rev1"], st["n_prev"] - 1 - st["j"], st["j"])
    j = j.clamp(0, P - 1).long()[:, None, None].expand(-1, 1, 3)
    row = st["prev"].gather(1, j)[:, 0]
    bwd = st["phase"] == seed.PH_BWD
    a = torch.where(bwd, row[:, 0], st["ik"][:, 1])
    s = torch.where(bwd, row[:, 1], st["ik"][:, 2]).clamp(min=0)
    return a, a + s


def machine_bytes(fm, st: dict, shard: int, kernel: str) -> int:
    """The bytes one launch of ``kernel`` must move for the lanes of
    ``st`` (a chunk's state as the launch finds it, after the query's
    pivot) on rank ``shard``: for each lane the least that a lane in its
    phase needs, the distinct table rows once, L2 once.
    The query (a lane's phase read and its 32 bytes of partials written;
    a lane in a pass also reads and writes iters and reads its source:
    ik's l and s, or in a backward pass j, rev1 and a prev row's k and
    s; a lane at its pivot reads at least its round, x, length and code
    and writes iters and x): 36 bytes a finished lane, 64 one at its
    pivot, 44 + 2 rb in a forward or round-3 pass, 49 + 2 rb backward,
    and each distinct Occ row this rank owns at a or a + s once (48
    bytes). The apply (a lane in no pass reads its phase alone; a lane
    in a pass reads its 32 bytes of sums and the least its pass needs: a
    forward step that extends reads i, its length, its code and ik and
    writes ik, ik_end and i; round 3 the same without ik_end; a backward
    step reads i, its code, j, rev1, n_prev, n_curr, a prev row's k and
    s and min_intv and writes j): 4 bytes, 56 + 6 rb forward, 52 + 6 rb
    round 3, 65 + 3 rb backward, and each distinct major row at a or
    a + s once (4 rb). rb: the rank's bytes."""
    rb = fm.rank_dtype.itemsize
    ph = st["phase"]
    count = lambda *q: sum(int((ph == x).sum()) for x in q)
    in_pass = (ph == seed.PH_FWD) | (ph == seed.PH_BWD) | (ph == seed.PH_R3)
    a, b = _sources(st)
    blk, mine = _occ_blocks(fm, torch.cat([a[in_pass], b[in_pass]]), shard)
    if kernel == "fm_shard_query":
        return (36 * count(seed.PH_DONE) + 64 * count(seed.PH_PIVOT)
                + (44 + 2 * rb) * count(seed.PH_FWD, seed.PH_R3)
                + (49 + 2 * rb) * count(seed.PH_BWD)
                + 48 * _distinct(blk[mine]) + 5 * rb)
    return (4 * count(seed.PH_DONE, seed.PH_PIVOT)
            + (56 + 6 * rb) * count(seed.PH_FWD)
            + (52 + 6 * rb) * count(seed.PH_R3)
            + (65 + 3 * rb) * count(seed.PH_BWD)
            + 4 * rb * _distinct(_majors(fm, blk)) + 5 * rb)


def walk_bytes(fm, r: torch.Tensor, buf: torch.Tensor, shard: int,
               kernel: str) -> int:
    """The bytes one LF step's launch of ``kernel`` must move for the
    ranks ``r`` on rank ``shard`` (``buf``: the query's partials, as the
    apply finds them). The query: each rank read, 16 bytes of partials
    written, and once each the distinct mark words (4 bytes), Occ rows
    (48) and major rows (one rank-wide entry) of the ranks this rank owns,
    L2 once. The apply: a marked lane reads its 8-byte mark sum; an
    unmarked one also its LF sum, its rank and its steps, and writes
    both (16 + 4 rb)."""
    rb = fm.rank_dtype.itemsize
    if kernel == "sa_shard_query":
        w = r >> 5
        local = w - shard * fm.sa_words.shape[0]
        word_mine = (local >= 0) & (local < fm.sa_words.shape[0])
        blk, mine = _occ_blocks(fm, r, shard)
        return ((rb + 16) * r.numel() + 4 * _distinct(w[word_mine])
                + 48 * _distinct(blk[mine])
                + rb * _distinct(_majors(fm, blk[mine])) + 5 * rb)
    marked = int((buf[0] != 0).sum())
    return 8 * marked + (16 + 4 * rb) * (r.numel() - marked)


def max_abs_err(pair: dict) -> int:
    """The largest |kernel - plain| over every output of a pair."""
    k, p = pair["kernel"]["out"], pair["plain"]["out"]
    return max(int(np.abs(k[n].astype(np.int64) - p[n].astype(np.int64))
                   .max(initial=0)) for n in p)


def _summary(pair: dict, kernels: tuple) -> dict:
    """A clocked pair's numbers: equal, max_abs_err, the steps (all_reduce
    calls) and bytes of both routes, each kernel's launches, lanes and ms
    a launch, the all_reduce's ms a step, both routes' seconds and the
    plain twin's ms a step outside its all_reduce (the median of its
    timed runs, and the runs' list)."""
    k, p = pair["kernel"], pair["plain"]
    steps = k["collectives"]["calls"]
    ev = k["events"]
    row = dict(equal=pair_equal(pair), max_abs_err=max_abs_err(pair),
               steps=steps, bytes=k["collectives"]["bytes"],
               plain_steps=p["collectives"]["calls"],
               plain_bytes=p["collectives"]["bytes"],
               kernel_s=k["seconds"], plain_s=p["seconds"],
               plain_reduce_s=p["collectives"]["seconds"],
               plain_step_ms=p["plain_step_ms"],
               plain_ms_per_step=statistics.median(p["plain_step_ms"]))
    n, _, ms = ev.get("all_reduce", (0, 0, 0.0))
    row["all_reduce_ms_per_step"] = ms / max(n, 1)
    for name in kernels:
        n, lanes, ms = ev.get(name, (0, 0, 0.0))
        row[name] = dict(launches=n, lanes=lanes, ms=ms / max(n, 1))
    return row


def launch_ms(fm, group, call: dict | None = None,
              walk: dict | None = None) -> dict:
    """The card's device ms a launch of each kernel of a machine ``call``
    (its first chunk: the live lanes of ``collect_seeds_sharded``'s
    set-up, after one query, the pivot) or of a ``walk``'s LF step, from
    a CUDA graph of 20 back-to-back launches (``shapes.graph_ms``: no
    host enqueue, no all_reduce between them, so each apply sums this
    rank's partials alone; the query's replays find the same state, the
    machine apply's move it on), with the bytes that launch must move at
    the state its replays start from (``machine_bytes`` / ``walk_bytes``):
    {name: dict(ms, bytes, lanes)}."""
    from bioseqdb_tpu_torch.tools.shapes import graph_ms

    dev, shard = fm.L2.device, dist.get_rank(group)
    entries = fsc.card_entries()
    if call is not None:
        c = _to(call, dev)
        st, kw = seed._sharded_setup(fm, c["codes"], c["lens"], group=group,
                                     **c["kw"])
        _, sub = seed._live(st)
        _, args = seed._chunk_args(fm, sub, shard, kw)
        n = sub["phase"].shape[0]
        names = fsc.ENTRIES[:2]
        entries[names[0]](args, n, dev)     # the pivot
        need = lambda name: machine_bytes(fm, sub, shard, name)
    else:
        r = walk["ranks"].to(dev, fm.rank_dtype).reshape(-1).clone()
        n = r.shape[0]
        buf = torch.empty((2, n), dtype=torch.int64, device=dev)
        args = fsc.pack(fsc.sa_args(fm, r, torch.zeros_like(r), buf, 0,
                                    shard))
        names = fsc.ENTRIES[2:]
        need = lambda name: walk_bytes(fm, r, buf, shard, name)
    out = {}
    for name in names:
        nbytes = need(name)
        out[name] = dict(ms=graph_ms(lambda name=name: entries[name](
                             args, n, dev)), bytes=nbytes, lanes=n)
    return out


def shard_check(al, batch, mask_seed: int = 7) -> dict:
    """On an index-mesh ``Aligner`` (in every rank of the group): the FM
    machine calls and SA walks of ``al.device_regions(batch)`` recorded,
    then each run again on the kernels and on the plain twin under the
    group, clocked (``machine_pair`` / ``walk_pair``), every walk also
    under a lane mask (half the lanes, from ``mask_seed``, the same on
    every rank). Returns dict(machine=[...], walks=[...]) of ``_summary``
    rows (with the call's lanes and width, and each unmasked call's
    ``launch_ms`` as ``graph``) and ``walk_plain_ms``, the median over
    every walk's timed plain runs of its ms a step outside the
    all_reduce (a whole step: both launches' work)."""
    fm, group = al.fms.fm, al.mesh.get_group("index")
    with recording() as rec:
        al.device_regions(batch)
    out = dict(machine=[], walks=[])
    for call in rec["machine"]:
        row = _summary(machine_pair(fm, group, call, clock=True),
                       fsc.ENTRIES[:2])
        row.update(lanes=int(call["codes"].shape[0]),
                   width=int(call["codes"].shape[1]),
                   graph=launch_ms(fm, group, call=call))
        out["machine"].append(row)
    gen = torch.Generator().manual_seed(mask_seed)
    for w in rec["walks"]:
        n, iv = w["ranks"].numel(), w["sa_interval"]
        mask = torch.rand(w["ranks"].shape, generator=gen) < 0.5
        for m in (w["mask"], mask):
            row = _summary(
                walk_pair(fm, group, w["ranks"], iv, m, clock=True),
                fsc.ENTRIES[2:])
            row.update(lanes=n, sa_interval=iv, masked=m is not None)
            if m is None:
                row["graph"] = launch_ms(fm, group, walk=w)
            out["walks"].append(row)
    out["walk_plain_ms"] = statistics.median(
        [t for row in out["walks"] for t in row["plain_step_ms"]] or [0.0])
    return out
