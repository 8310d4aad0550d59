"""The index mesh's sharded loops, held against their plain twins.

``csrc/fm_shard.cu``'s kernels (``kernels/fm_shard_cuda.py``) run the
FM machine (``seed.collect_seeds_sharded``), the SA walk
(``fm.sa_walk_sharded``) and the backward search (``fm.search_sharded``)
of an index group, a query launch, an ``all_reduce`` and an apply launch
a step; ``csrc/extend.cu``'s ``windows_shard_query`` and
``extend_windows`` run its window fetch
(``extend.extend_windows_sharded``), and ``csrc/resolve.cu``'s two
kernels ``resolve_seeds`` around the sharded walk
(``chain.resolve_seeds_sharded``). Here:

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
  that launch must move, its bound's numerator;
- ``host_libraries`` builds the three sources for the host, and
  ``route_rank`` runs the window fetch, ``resolve_seeds`` and the
  backward search of an index-mesh step (recorded) on the kernels and on
  their twins under the group (``windows_pair``, ``resolve_pair``,
  ``search_pair``), on the host builds in gloo ranks
  (``tests/test_torch_shard_extend.py``) or on the card
  (``tests/test_torch_dist_cuda.py``, with a forced build failure);
  ``shard_check`` replays a step's window fetches and ``resolve_seeds``
  call and a search too, ``windows_launch_ms`` / ``resolve_launch_ms``
  / ``search_launch_ms`` time their launches in a CUDA graph and
  ``windows_bytes`` / ``search_bytes`` give their bounds' bytes.
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
from bioseqdb_tpu_torch.kernels import build, chain, extend
from bioseqdb_tpu_torch.kernels import extend_cuda as ecu
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels import fm_shard_cuda as fsc
from bioseqdb_tpu_torch.kernels import resolve_cuda as rcu
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


def _rc(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGTN", "TGCAN"))


def strand_batch(refs: list):
    """Eight 120 bp reads at ``edge_refs``' repeat contig's end, the last
    forward base (l_pac): four forward, a substitution at base 110, and
    their reverse complements (the first of the reverse strand), a
    substitution at base 10, so that their windows run across the
    strands' boundary and the extended seeds' targets reach its last
    forward base and its first reverse one."""
    rep = refs[1][1]
    sub = lambda s, i: s[:i] + "ACGT"[("ACGT".index(s[i]) + 1) % 4] + s[i + 1:]
    ends = [rep[len(rep) - end - 120:len(rep) - end] for end in (0, 7, 30, 80)]
    reads = [sub(r, 110) for r in ends] + [sub(_rc(r), 10) for r in ends]
    return pack_reads(reads, [f"e{k}" for k in range(len(reads))])


def search_batch(refs: list, short) -> tuple[np.ndarray, np.ndarray]:
    """The backward search's reads on ``edge_refs`` as (codes, lens):
    16 exact reads of the genome, half 120 bp (full width) and half 20 to
    119 bp, every other pair reverse-complemented; three 100 bp copies of
    the repeated 400 bases (two hits each); the genome's last 120 bases,
    the reverse complement of its first 120 (in the repeat too) and its
    first 120 with an N; then ``short``'s reads (``edge_batches``:
    substitutions, an N-sprinkled, an empty, an all-N and a junk read)."""
    genome, rep = refs[0][1], refs[1][1]
    rng = np.random.default_rng(11)
    reads = []
    for k in range(16):
        n = 120 if k % 2 else int(rng.integers(20, 120))
        st = int(rng.integers(0, len(genome) - n))
        r = genome[st:st + n]
        reads.append(r if k % 4 < 2 else _rc(r))
    reads += [rep[st:st + 100] for st in (0, 150, 290)]
    reads += [genome[-120:], _rc(genome[:120]),
              genome[:60] + "N" + genome[61:120]]
    b = pack_reads(reads, [f"x{k}" for k in range(len(reads))])
    parts = [np.asarray(b.codes), np.asarray(short.codes)]
    W = max(x.shape[1] for x in parts)
    return (np.concatenate([np.pad(x, ((0, 0), (0, W - x.shape[1])),
                                   constant_values=4) for x in parts]),
            np.concatenate([np.asarray(b.lens), np.asarray(short.lens)]))


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


def route_hooks(libs: dict | None = None) -> dict:
    """The kernels the sharded routes launch: ``entries`` (the
    ``fm_shard`` entries), ``ext`` (``extend_cuda.launch``'s signature)
    and ``res`` (``resolve_cuda.launch``'s): the card's (``libs`` None)
    or the host builds' at ``libs`` (``host_libraries``' paths)."""
    if libs is None:
        return dict(entries=fsc.card_entries(), ext=ecu.launch,
                    res=rcu.launch)
    return dict(entries=fsc.host_entries(ctypes.CDLL(libs["fm_shard"])),
                ext=ecu.host_launcher(ctypes.CDLL(libs["extend"])),
                res=rcu.host_launcher(ctypes.CDLL(libs["resolve"])))


@contextlib.contextmanager
def _clocked(on: bool, dev, hooks: dict | None = None):
    """Yields (hooks, sums). When ``on`` (on the card): ``hooks``
    (``route_hooks``' dict; the card's by default) with each launch
    between two CUDA events, and ``kfm._all_reduce`` wrapped the same way
    for the block; ``sums`` gets ``_events``' sums after it. Otherwise
    ``hooks`` as given and {}."""
    sums = {}
    if not on or dev.type != "cuda":
        yield hooks, sums
        return
    events, reduce = [], kfm._all_reduce
    card = dict(route_hooks(), **(hooks or {}))

    def timed(name: str, fn, lanes: int, *a):
        e0, e1 = _event_pair()
        e0.record()
        out = fn(*a)
        e1.record()
        events.append((name, e0, e1, lanes))
        return out

    def entry(name):
        return lambda args, lanes, device: timed(
            name, card["entries"][name], lanes, args, lanes, device)

    ext = lambda kernel, *a: timed(kernel, card["ext"], 0, kernel, *a)
    res = lambda kernel, *a: timed(kernel, card["res"], 0, kernel, *a)
    kfm._all_reduce = lambda buf, group: timed("all_reduce", reduce, 0, buf,
                                               group)
    try:
        yield dict(entries={name: entry(name) for name in card["entries"]},
                   ext=ext, res=res), sums
        _sync(dev)
        sums.update(_events(events))
    finally:
        kfm._all_reduce = reduce


def _route_pair(dev, kernel, plain, hooks: dict | None = None,
                clock: bool = False, plain_reps: int = 1) -> dict:
    """One call on the kernels (``kernel(hooks)``: ``hooks`` None takes
    the card's) and on its plain twin (``plain()``) under a group: each
    route's outputs (a dict of tensors, as numpy), ``COLLECTIVES``
    (calls, bytes) and seconds. With ``clock`` (on the card) the kernel
    route's launches and ``all_reduce``s between CUDA events
    (``events``: name -> launches, lanes, ms), and the plain twin run
    ``plain_reps`` times with its ``all_reduce``s timed, after an
    untimed warm-up where ``plain_reps`` > 1 (``plain_step_ms``: each
    run's ms a step outside them; the outputs and collectives are the
    last run's)."""
    out = {}
    for route in ("kernel", "plain"):
        reps = plain_reps if clock and route == "plain" else 1
        if clock and route == "plain" and plain_reps > 1:
            plain()                                   # warm-up
        step_ms = []
        for _ in range(reps):
            kfm.reset_collectives(timed=clock and route == "plain")
            with _clocked(clock and route == "kernel", dev, hooks) as (h,
                                                                       ev):
                _sync(dev)
                t0 = time.perf_counter()
                res = kernel(h) if route == "kernel" else plain()
                _sync(dev)
                sec = time.perf_counter() - t0
            step_ms.append(_plain_step_ms(sec))
        out[route] = dict(out={k: v.cpu().numpy() for k, v in res.items()},
                          collectives=dict(kfm.COLLECTIVES), seconds=sec,
                          events=ev, plain_step_ms=step_ms)
        kfm.reset_collectives()
    return out


def machine_pair(fm, group, call: dict, entries: dict | None = None,
                 clock: bool = False) -> dict:
    """``call`` (``machine_call``'s dict, on ``fm``'s device) on the
    kernels (``seed.collect_seeds_sharded``; ``entries`` None: the card's)
    and on the plain twin (``collect_seeds_plain``) under ``group``
    (``_route_pair``: the plain twin once, its ms a step outside its
    all_reduce a list of one)."""
    dev = fm.L2.device
    call = _to(call, dev)
    hooks = None if entries is None else dict(entries=entries)
    pick = lambda res: {k: res[k] for k in MACHINE_OUTPUTS}
    return _route_pair(
        dev, lambda h: pick(seed.collect_seeds_sharded(
            fm, call["codes"], call["lens"], group=group,
            entries=h and h["entries"], **call["kw"])),
        lambda: pick(seed.collect_seeds_plain(
            fm, call["codes"], call["lens"], group=group, **call["kw"])),
        hooks, clock)


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
    ``fm.sa_resolve_plain`` under ``group`` on ``ranks`` (and ``mask``);
    with ``clock`` the plain twin warmed, then timed ``plain_reps``
    times."""
    dev = fm.L2.device
    r = ranks.to(dev, fm.rank_dtype)
    m = None if mask is None else mask.to(dev)
    hooks = None if entries is None else dict(entries=entries)
    return _route_pair(
        dev, lambda h: dict(pos=kfm.sa_walk_sharded(
            fm, r, sa_interval, group, m, h and h["entries"])),
        lambda: dict(pos=kfm.sa_resolve_plain(fm, r, sa_interval, group, m)),
        hooks, clock, plain_reps)


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
    """Within the block, every FM machine call, SA walk, window fetch and
    ``resolve_seeds`` call the index mesh's step makes
    (``dist/shard_index.py``'s ``collect_seeds_device`` and
    ``resolve_seeds``, ``kernels/chain.py``'s ``kfm.sa_resolve`` and
    ``kernels/extend.py``'s ``extend_windows`` under a group) is recorded
    in the yielded dict: ``machine`` (``machine_call``'s dicts, inputs on
    the CPU), ``walks`` (dict(ranks, sa_interval, mask)), ``windows``
    (dict(tab, scan, perm, p), the step's tensors on its device) and
    ``resolve`` (dict(mems, n_mem, kw)); the calls still run."""
    rec = dict(machine=[], walks=[], windows=[], resolve=[])
    collect, resolve = dshard.collect_seeds_device, chain.kfm.sa_resolve
    windows, seeds = extend.extend_windows, dshard.resolve_seeds

    def windows_rec(tab, fm, pac, scan, perm, p, group=None, gate=None):
        if group is not None:
            rec["windows"].append(dict(tab=tab, scan=scan, perm=perm, p=p))
        return windows(tab, fm, pac, scan, perm, p, group, gate)

    def seeds_rec(fm, mems, n_mem, **kw):
        rec["resolve"].append(dict(mems=mems, n_mem=n_mem, kw={
            k: v for k, v in kw.items() if k != "group"}))
        return seeds(fm, mems, n_mem, **kw)

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
    extend.extend_windows = windows_rec
    dshard.resolve_seeds = seeds_rec
    try:
        yield rec
    finally:
        dshard.collect_seeds_device = collect
        chain.kfm.sa_resolve = resolve
        extend.extend_windows = windows
        dshard.resolve_seeds = seeds


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
        steps = torch.zeros_like(r)    # held: the apply writes it
        args = fsc.pack(fsc.sa_args(fm, r, steps, buf, 0, shard))
        names = fsc.ENTRIES[2:]
        need = lambda name: walk_bytes(fm, r, buf, shard, name)
    out = {}
    for name in names:
        nbytes = need(name)
        out[name] = dict(ms=graph_ms(lambda name=name: entries[name](
                             args, n, dev)), bytes=nbytes, lanes=n)
    return out


def shard_check(al, batch, mask_seed: int = 7, search=None) -> dict:
    """On an index-mesh ``Aligner`` (in every rank of the group): the FM
    machine calls, SA walks, window fetches and ``resolve_seeds`` calls
    of ``al.device_regions(batch)`` recorded, then each run again on the
    kernels and on the plain twin under the group, clocked
    (``machine_pair`` / ``walk_pair`` / ``windows_pair`` /
    ``resolve_pair``), every walk also under a lane mask (half the lanes,
    from ``mask_seed``, the same on every rank); and the backward search
    of ``search`` (codes, lens), if given (``search_pair``). Returns
    dict(machine=[...], walks=[...], windows=[...], resolve=[...],
    search=row or None) of ``_summary`` rows (with each call's lanes and
    width; the machine's and the unmasked walks' ``launch_ms``, the first
    window fetch's ``windows_launch_ms``, the first resolve call's
    ``resolve_launch_ms`` and the search's ``search_launch_ms`` as
    ``graph``) and ``walk_plain_ms``, the median over every walk's timed
    plain runs of its ms a step outside the all_reduce (a whole step:
    both launches' work)."""
    fm, pac = al.fms.fm, al.fms.pac
    group = al.mesh.get_group("index")
    with recording() as rec:
        al.device_regions(batch)
    out = dict(machine=[], walks=[], windows=[], resolve=[], search=None)
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
    for k, call in enumerate(rec["windows"]):
        row = _summary(windows_pair(fm, pac, group, call, clock=True),
                       WINDOWS_LAUNCHES)
        row.update(lanes=int(call["scan"]["sel"].numel()),
                   width=int(call["tab"]["codes"].shape[1]))
        if k == 0:
            row["graph"] = windows_launch_ms(fm, pac, group, call)
        out["windows"].append(row)
    for k, call in enumerate(rec["resolve"]):
        row = _summary(resolve_pair(fm, group, call, clock=True),
                       RESOLVE_LAUNCHES)
        row.update(lanes=int(call["mems"].shape[0]
                             * call["kw"]["max_seeds"]))
        if k == 0:
            row["graph"] = resolve_launch_ms(fm, group, call)
        out["resolve"].append(row)
    if search is not None:
        codes, lens = (torch.as_tensor(np.asarray(a), dtype=torch.int32)
                       for a in search)
        row = _summary(search_pair(fm, group, codes, lens, clock=True,
                                   plain_reps=2), fsc.SEARCH_ENTRIES)
        row.update(lanes=int(codes.shape[0]), width=int(codes.shape[1]),
                   graph=search_launch_ms(fm, group, codes, lens))
        out["search"] = row
    return out


# ---- the window fetch, resolve_seeds and the backward search ----

# the sources the three routes build for the host, and the kernels they
# launch on the card
ROUTE_SOURCES = ("fm_shard", "extend", "resolve")
ROUTE_KERNELS = (*build.WINDOWS_SHARD_KERNELS, "extend_windows",
                 *build.RESOLVE_KERNELS, "sa_shard_query", "sa_shard_apply",
                 *build.SEARCH_SHARD_KERNELS)
WINDOW_OUTPUTS = ("qbuf", "tbuf", "qn", "tn", "active", "h0", "inv")
# the launches a route's clocked pair reports (``_summary``)
WINDOWS_LAUNCHES = (*build.WINDOWS_SHARD_KERNELS, "extend_windows")
RESOLVE_LAUNCHES = (*build.RESOLVE_KERNELS, "sa_shard_query",
                    "sa_shard_apply")
RESOLVE_OUTPUTS = ("rbeg", "qbeg", "len", "rid", "valid", "overflow")


def host_libraries(out_dir) -> dict:
    """``ROUTE_SOURCES`` built for the host with g++ (their host entries)
    in ``out_dir``, one g++ each, concurrently: {source: path}, which a
    rank process loads (``route_hooks``). Raises without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    paths = {n: Path(out_dir) / f"lib{n}_host.so" for n in ROUTE_SOURCES}
    procs = {n: subprocess.Popen(
        [gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-o",
         str(paths[n]), str(build.CSRC / build.SOURCES[n])])
        for n in ROUTE_SOURCES}
    failed = [n for n, pr in procs.items() if pr.wait() != 0]
    if failed:
        raise RuntimeError(f"g++ failed for {failed}")
    return {n: str(path) for n, path in paths.items()}


def windows_pair(fm, pac, group, call: dict, hooks: dict | None = None,
                 clock: bool = False) -> dict:
    """A recorded window fetch (``recording``'s ``windows``) on the
    kernels (``extend.extend_windows_sharded``) and on the plain twin
    under ``group`` (``_route_pair``)."""
    a = (call["tab"], fm, pac, call["scan"], call["perm"], call["p"])
    return _route_pair(
        fm.L2.device,
        lambda h: extend.extend_windows_sharded(*a, group,
                                                run=h and h.get("ext")),
        lambda: extend.extend_windows_plain(*a, group), hooks, clock)


def _walk_on(h: dict | None):
    """The walk ``chain.resolve_seeds_sharded`` takes on ``h``'s entries
    (None: its default, ``kfm.sa_resolve``)."""
    if h is None or "entries" not in h:
        return None
    return lambda fm, r, iv, group: kfm.sa_walk_sharded(
        fm, r, iv, group, entries=h["entries"])


def resolve_pair(fm, group, call: dict, hooks: dict | None = None,
                 clock: bool = False) -> dict:
    """A ``resolve_seeds`` call (``recording``'s ``resolve``) on the
    kernels (``chain.resolve_seeds_sharded``) and on the plain twin under
    ``group`` (``_route_pair``)."""
    mems, n_mem, kw = call["mems"], call["n_mem"], call["kw"]
    return _route_pair(
        fm.L2.device,
        lambda h: chain.resolve_seeds_sharded(
            fm, mems, n_mem, group=group, run=h and h.get("res"),
            walk=_walk_on(h), **kw),
        lambda: chain.resolve_seeds_plain(fm, mems, n_mem, group=group,
                                          **kw), hooks, clock)


def search_pair(fm, group, codes: torch.Tensor, lens: torch.Tensor,
                hooks: dict | None = None, clock: bool = False,
                plain_reps: int = 1) -> dict:
    """The backward search of (``codes``, ``lens``) on the kernels
    (``fm.search_sharded``) and on the plain twin under ``group``
    (``_route_pair``)."""
    dev = fm.L2.device
    codes, lens = codes.to(dev, torch.int32), lens.to(dev, torch.int32)
    as_dict = lambda lohi: dict(lo=lohi[0], hi=lohi[1])
    return _route_pair(
        dev, lambda h: as_dict(kfm.search_sharded(
            fm, codes, lens, group, entries=h and h.get("entries"))),
        lambda: as_dict(kfm.backward_search_plain(fm, codes, lens, group)),
        hooks, clock, plain_reps)


def wide_resolve_calls(call: dict, copies: int = 3, caps=(None, 0, 600)
                       ) -> list[dict]:
    """``call`` (a recorded ``resolve_seeds`` call) with its reads
    repeated ``copies`` times, past the no-buffer size of 4,096 lanes
    when ``copies`` x B x S is, at each compaction cap of ``caps``: every
    walking lane (None, the index mesh's step), the JAX buffer's (B * S)
    // 4 (0) and a cap that cuts (a number)."""
    mems = call["mems"].repeat(copies, 1, 1)
    n_mem = call["n_mem"].repeat(copies)
    return [dict(mems=mems, n_mem=n_mem, kw=dict(call["kw"], compact_cap=c))
            for c in caps]


def window_reach(fm, calls: list) -> dict:
    """Over recorded window fetches, the round lanes (a lane a side with
    a target window) whose T columns reach past the text's ends
    (``text_end``), across the strands' boundary l_pac (``strand``), and
    whose window a chain's reference window cuts short (``clipped``: tn
    below T)."""
    out = dict(text_end=0, strand=0, clipped=0, lanes=0)
    for c in calls:
        tab, scan, p = c["tab"], c["scan"], c["p"]
        T = tab["codes"].shape[1] + 4 * p["bandwidth"] + 64
        has, _, tn = extend._sides(tab, scan["act"], scan["slot"])
        sq, sr, sl, _, _, _ = extend._lanes(tab, scan["slot"])
        first = torch.stack([sr.long() - T, (sr + sl).long()])
        last = first + T - 1
        out["lanes"] += int(has.sum())
        out["text_end"] += int((has & ((first < 0)
                                       | (last >= fm.seq_len))).sum())
        out["strand"] += int((has & (first < fm.l_pac)
                              & (last >= fm.l_pac)).sum())
        out["clipped"] += int((has & (tn < T)).sum())
    return out


def _forced_failures(dev, group, fms, windows: dict, resolve: dict,
                     codes, lens, out_dir) -> dict:
    """Each route on CUDA tensors under ``group`` with the three sources
    made unbuildable (``build.CSRC`` a copy under ``out_dir`` with an
    ``#error`` line added to each, built into a fresh directory): {route:
    the error it raised, or None if it ran}. The build is restored after."""
    import tempfile

    src = Path(tempfile.mkdtemp(dir=out_dir, prefix="csrc_"))
    shutil.copytree(build.CSRC, src, dirs_exist_ok=True)
    for n in ROUTE_SOURCES:
        f = src / build.SOURCES[n]
        f.write_text(f.read_text() + "\n#error forced build failure\n")
    saved = build.CSRC, build.BUILD_DIR
    build.CSRC, build.BUILD_DIR = src, src / "_build"
    build.library.cache_clear()
    calls = dict(
        windows=lambda: extend.extend_windows(
            windows["tab"], fms.fm, fms.pac, windows["scan"],
            windows["perm"], windows["p"], group),
        resolve=lambda: chain.resolve_seeds(
            fms.fm, resolve["mems"], resolve["n_mem"], group=group,
            **resolve["kw"]),
        search=lambda: kfm.backward_search(fms.fm, codes.to(dev),
                                           lens.to(dev), group))
    out = {}
    try:
        for name, fn in calls.items():
            try:
                fn()
                out[name] = None
            except RuntimeError as e:
                out[name] = str(e)[:200]
    finally:
        build.CSRC, build.BUILD_DIR = saved
        build.library.cache_clear()
    return out


@contextlib.contextmanager
def twin_calls():
    """Within the block, the calls of ``extend_windows_plain``,
    ``resolve_seeds_plain`` and ``backward_search_plain`` on CUDA tensors
    under a group (none may happen: those routes launch their kernels
    there) are counted in the yielded dict."""
    counts = dict(windows=0, resolve=0, search=0)
    saved = (extend.extend_windows_plain, chain.resolve_seeds_plain,
             kfm.backward_search_plain)

    def counting(name, fn, cuda, group_at):
        def call(*a, **kw):
            group = kw.get("group", a[group_at] if len(a) > group_at
                           else None)
            if group is not None and cuda(*a):
                counts[name] += 1
            return fn(*a, **kw)
        return call

    extend.extend_windows_plain = counting(
        "windows", saved[0], lambda tab, *a: tab["order"].is_cuda, 6)
    chain.resolve_seeds_plain = counting(
        "resolve", saved[1], lambda fm, mems, *a: mems.is_cuda, 7)
    kfm.backward_search_plain = counting(
        "search", saved[2], lambda fm, codes, *a: codes.is_cuda, 3)
    try:
        yield counts
    finally:
        (extend.extend_windows_plain, chain.resolve_seeds_plain,
         kfm.backward_search_plain) = saved


def route_rank(rank: int, world_size: int, device_type: str,
               libs: dict | None, idx, batches: list, search: tuple,
               rank_dtypes: tuple = (torch.int32,),
               broken_dir: str | None = None) -> dict:
    """A rank function (``dist/launch.py``): an index mesh of every rank
    on ``device_type`` and, at each of ``rank_dtypes``, an ``Aligner`` on
    this rank's shard of ``idx`` whose step (``device_regions`` of each
    of ``batches``) is recorded (``recording``), then each recorded window
    fetch and ``resolve_seeds`` call (and ``wide_resolve_calls`` of the
    first) and the backward search of ``search`` (codes, lens) as pairs
    of routes (``windows_pair``, ``resolve_pair``, ``search_pair``): on
    the card (``libs`` None) or on the CPU through the host builds at
    ``libs``. Also: ``reach`` (``window_reach``); on the card ``twins``
    (``twin_calls`` over the step and a ``backward_search_sharded`` call:
    all must be 0) and ``launches`` (of ``ROUTE_KERNELS`` over the pairs),
    and with ``broken_dir`` ``broken`` (``_forced_failures``); on the CPU
    ``dispatch`` (the dispatchers on CPU tensors under the group equal
    the twins) and ``built`` (``build.library``'s loads: must be 0).
    Returns dict(rank, dtypes: [...], dispatch, built, forbidden)."""
    import dataclasses

    from bioseqdb_tpu_torch.align.options import AlignOptions
    from bioseqdb_tpu_torch.align.pipeline import Aligner
    from bioseqdb_tpu_torch.tools.dist_leg import forbidden_modules

    hooks = None if libs is None else route_hooks(libs)
    dev = dmesh.rank_device(device_type)
    mesh = dmesh.make_mesh((world_size,), ("index",), device_type)
    group = mesh.get_group("index")
    codes, lens = (torch.as_tensor(np.asarray(a), dtype=torch.int32)
                   for a in search)
    out, dispatch = [], None
    for rdt in rank_dtypes:
        al = dataclasses.replace(
            Aligner.build(idx, AlignOptions(), device=dev, mesh=mesh),
            fms=dshard.shard_index(idx, mesh, dev, rank_dtype=rdt))
        fm, pac = al.fms.fm, al.fms.pac
        with recording() as rec, twin_calls() as twins:
            for b in batches:
                al.device_regions(b)
            dshard.backward_search_sharded(al.fms, codes.to(dev),
                                           lens.to(dev), mesh)
        build.reset_launches()
        res_calls = rec["resolve"] + wide_resolve_calls(rec["resolve"][0])
        row = dict(
            rank_dtype=str(fm.rank_dtype),
            windows=[windows_pair(fm, pac, group, c, hooks)
                     for c in rec["windows"]],
            resolve=[dict(resolve_pair(fm, group, c, hooks),
                          lanes=int(c["mems"].shape[0]
                                    * c["kw"]["max_seeds"]),
                          cap=c["kw"]["compact_cap"])
                     for c in res_calls],
            search=search_pair(fm, group, codes, lens, hooks),
            reach=window_reach(fm, rec["windows"]))
        if device_type == "cuda":
            row.update(twins=twins, launches={
                k: build.LAUNCHES[k] for k in ROUTE_KERNELS})
            if broken_dir is not None and rdt == rank_dtypes[0]:
                row["broken"] = _forced_failures(
                    dev, group, al.fms, rec["windows"][0], res_calls[-1],
                    codes, lens, broken_dir)
        elif dispatch is None:
            w, r = rec["windows"][0], rec["resolve"][0]
            a = (w["tab"], fm, pac, w["scan"], w["perm"], w["p"], group)
            got = [extend.extend_windows(*a),
                   chain.resolve_seeds(fm, r["mems"], r["n_mem"],
                                       group=group, **r["kw"]),
                   dict(zip("lh", kfm.backward_search(fm, codes, lens,
                                                      group)))]
            want = [extend.extend_windows_plain(*a),
                    chain.resolve_seeds_plain(fm, r["mems"], r["n_mem"],
                                              group=group, **r["kw"]),
                    dict(zip("lh", kfm.backward_search_plain(
                        fm, codes, lens, group)))]
            dispatch = all(torch.equal(g[k], x[k]) for g, x in zip(got, want)
                           for k in x)
        out.append(row)
    return dict(rank=rank, dtypes=out, dispatch=dispatch,
                built=build.library.cache_info().misses,
                forbidden=forbidden_modules())


def windows_bytes(fm, tab: dict, scan: dict, out: dict, shard: int,
                  kernel: str, pac_rows: int) -> int:
    """The bytes one launch of ``kernel`` must move in a window fetch
    (``out``: the query's outputs, or the apply's): the query reads each
    round lane's entry of ``sel``, its slot and its seed's start and
    length, and once each the forward codes this rank owns in the lanes'
    windows (a byte each), and writes its 2 n T partials and the lanes'
    rows (4 bytes); the apply (``extend_windows``' summed-target mode)
    reads what the packed-text mode reads but a target's code from the
    sums (a byte, up to tn) and each active lane's row, and writes every
    output once."""
    rb = tab["rbeg"].element_size()
    size = lambda t: t.numel() * t.element_size()
    sel = scan["sel"]
    n = sel.numel()
    if kernel == "windows_shard_query":
        T = out["buf"].numel() // max(2 * n, 1)
        slot = scan["slot"][sel].long()
        sr = tab["rbeg"][sel, slot].long()
        re0 = sr + tab["len"][sel, slot].long()
        cols = torch.arange(T, device=sel.device)
        pos = torch.cat([(sr - 1)[:, None] - cols, re0[:, None] + cols])
        q = pos.clamp(0, fm.seq_len - 1)
        local = torch.where(q < fm.l_pac, q, fm.seq_len - 1 - q) - (
            shard * pac_rows)
        owned = _distinct(local[(local >= 0) & (local < pac_rows)])
        return n * (8 + 4 + rb + 4 + 4) + size(out["buf"]) + owned
    qn, tn = out["qn"].long(), out["tn"].long()
    B = tab["rbeg"].shape[0]
    seed_bytes = rb + 12
    return (B * (2 * 8 + 4 + 1 + seed_bytes + 4 + 2 * rb)
            + 4 * int(qn.sum()) + int(tn.sum()) + 4 * n
            + sum(size(out[k]) for k in WINDOW_OUTPUTS))


def search_bytes(fm, codes: torch.Tensor, lens: torch.Tensor,
                 lo: torch.Tensor, hi: torch.Tensor, t: int, shard: int,
                 kernel: str) -> int:
    """The bytes one launch of ``kernel`` at the search's step ``t`` must
    move for the intervals (lo, hi) it finds: the query reads each read's
    length, its step's code and interval and writes its 8 bytes of
    partials, and reads once each the distinct Occ rows this rank owns at
    the extended reads' lo and hi (48 bytes); the apply reads the same
    per read and an extended read's 8 bytes of sums, writes the
    intervals it changes (an extended or killed read's), and reads once
    each the distinct major rows at the extended reads' ends (4 rb) and
    L2."""
    rb = fm.rank_dtype.itemsize
    B, W = codes.shape
    col = (lens.long() - 1 - t).clamp(0, W - 1)
    c = codes.gather(1, col[:, None])[:, 0]
    live = t < lens
    act = live & (lo < hi) & (c < 4)
    per_read = B * (4 + 4 + 2 * rb)
    r = torch.cat([lo[act], hi[act]])
    blk, mine = _occ_blocks(fm, r, shard)
    if kernel == "bs_shard_query":
        return per_read + 8 * B + 48 * _distinct(blk[mine])
    changed = int((act | (live & (c >= 4))).sum())
    return (per_read + 8 * int(act.sum()) + 2 * rb * changed
            + 4 * rb * _distinct(_majors(fm, blk)) + 5 * rb)


def windows_launch_ms(fm, pac, group, call: dict) -> dict:
    """The card's device ms a launch of the window fetch's two kernels on
    a recorded call (``recording``'s ``windows``), from a CUDA graph of 20
    back-to-back launches (``shapes.graph_ms``): the query, and after one
    real ``all_reduce`` of its buffer, ``extend_windows`` on the sums;
    with the bytes each must move (``windows_bytes``): {name: dict(ms,
    bytes, lanes)}."""
    from bioseqdb_tpu_torch.tools.shapes import graph_ms

    shard = dist.get_rank(group)
    tab, scan, perm, p = (call[k] for k in ("tab", "scan", "perm", "p"))
    q, qargs, qt = ecu.windows_query_args(tab, fm, pac, scan["sel"],
                                          scan["slot"], p, shard)
    ecu.launch("windows_shard_query", "windows_shard_query", q, qargs, qt)
    kfm._all_reduce(q["buf"], group)
    o, aargs, at = ecu.windows_args(tab, fm.seq_len, None, scan, perm, p,
                                    sums=q["buf"], sel_of=q["sel_of"],
                                    l_pac=fm.l_pac)
    ecu.launch("extend_windows", "extend_windows", o, aargs, at)
    rows = pac.shape[0]
    return {name: dict(ms=graph_ms(lambda: ecu.launch(name, name, *run)),
                       bytes=windows_bytes(fm, tab, scan, run[0], shard,
                                           name, rows), lanes=lanes)
            for name, run, lanes in (
                ("windows_shard_query", (q, qargs, qt),
                 int(scan["sel"].numel())),
                ("extend_windows", (o, aargs, at), 2 * int(perm.shape[1])))}


def resolve_launch_ms(fm, group, call: dict) -> dict:
    """``windows_launch_ms`` for a recorded ``resolve_seeds`` call: the
    expansion, then (after the route's sharded walk, every rank) the
    finish; with each one's bytes and instructions
    (``resolve_calls.ResolveCall.counts``): {name: dict(ms, bytes, instr,
    lanes)}."""
    from bioseqdb_tpu_torch.tools.resolve_calls import ResolveCall
    from bioseqdb_tpu_torch.tools.shapes import graph_ms

    mems, n_mem, kw = call["mems"], call["n_mem"], call["kw"]
    seen = {}

    def run(kernel: str, *a):
        seen[kernel] = a
        return rcu.launch(kernel, *a)

    res = chain.resolve_seeds_sharded(fm, mems, n_mem, group=group, run=run,
                                      **kw)
    counts = ResolveCall.of(fm, mems, n_mem, **kw).counts(
        seen["resolve_expand"][0], res)
    return {name: dict(ms=graph_ms(lambda: rcu.launch(name, *seen[name])),
                       bytes=counts[key]["read"] + counts[key]["written"],
                       instr=counts[key]["instr"],
                       lanes=int(mems.shape[0]))
            for name, key in (("resolve_expand", "expand"),
                              ("resolve_finish", "finish"))}


def search_launch_ms(fm, group, codes: torch.Tensor, lens: torch.Tensor
                     ) -> dict:
    """``windows_launch_ms`` for the backward search's first step (every
    read of length live, its interval the whole text): the query, and
    after one real ``all_reduce`` of its partials, the apply (whose
    replays move the intervals on, as a step does); with the bytes each
    must move at that step (``search_bytes``): {name: dict(ms, bytes,
    lanes)}."""
    from bioseqdb_tpu_torch.tools.shapes import graph_ms

    dev, shard = fm.L2.device, dist.get_rank(group)
    codes = codes.to(dev, torch.int32).contiguous()
    lens = lens.to(dev, torch.int32).contiguous()
    B = codes.shape[0]
    lo = torch.zeros(B, dtype=fm.rank_dtype, device=dev)
    hi = torch.full((B,), fm.seq_len + 1, dtype=fm.rank_dtype, device=dev)
    buf = torch.empty((1, 2 * B), dtype=torch.int32, device=dev)
    args = fsc.pack(fsc.bs_args(fm, codes, lens, lo, hi, buf, shard))
    entries = fsc.card_entries()
    need = {name: search_bytes(fm, codes, lens, lo, hi, 0, shard, name)
            for name in fsc.SEARCH_ENTRIES}
    entries["bs_shard_query"](args, B, dev)
    kfm._all_reduce(buf, group)
    return {name: dict(ms=graph_ms(lambda: entries[name](args, B, dev)),
                       bytes=need[name], lanes=B)
            for name in fsc.SEARCH_ENTRIES}
