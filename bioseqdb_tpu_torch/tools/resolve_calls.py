"""Seed resolution's kernels (``resolve_expand``, ``resolve_finish``)
against the plain twin, at the shapes the pipeline gives them.

- ``recording(calls)``: inside the block, every ``resolve_seeds`` call of
  ``align/pipeline.py`` is recorded (its tensors cloned) as a
  ``ResolveCall`` and then made as usual;
- ``ResolveCall``: one call; ``run`` makes it through the kernels (CUDA
  tensors) or the plain twin ``chain.resolve_seeds_plain``, ``host`` on
  the g++ build of ``csrc/resolve.cu`` (CPU tensors, the walk plain),
  ``expand_ms`` / ``finish_ms`` time each kernel's launch in a CUDA
  graph, ``plain_ms`` the plain twin's parts before and after its walk,
  ``clocked`` a whole call, ``counts`` gives what each kernel's bound
  needs, ``shifted`` moves every position past 2^31 (int64 ranks);
- ``edge_calls``: calls on ``fm_calls.edge_setup``'s index (SA interval
  32) that hold the cases the kernels must get right: the compaction cap
  flooded at ``compact_cap`` 4,096 and at (B x S) // 4, position rows
  mixed with rank rows, intervals sampled past ``max_occ``, reads whose
  intervals hold more than S seeds, seeds bridging l_pac and reference
  ends, B x S <= 4,096 (no compaction buffer), no cap, a cap that cuts
  inside a read, the M and S of 8 kb, 18 kb and 25 kb reads and of the
  18 kb fat retry (a read's intervals past a block's shared memory);
  ``random_calls`` random intervals from a seed;
- ``host_library``: ``csrc/resolve.cu`` built for the host with g++.

``chip_smoke.py``'s resolve phase and the resolve kernels' tests use it.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import inspect
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from bioseqdb_tpu_torch.align import pipeline
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels import chain as kch
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels import resolve_cuda as rcu
from bioseqdb_tpu_torch.kernels.extend_cuda import array, bind
from bioseqdb_tpu_torch.tools import fm_calls, shapes

FIELDS = ("rbeg", "qbeg", "len", "rid", "valid", "overflow")
_SIG = inspect.signature(kch.resolve_seeds)
PAST_2_31 = fm_calls.PAST_2_31
# instructions the bound charges: a key or offset compare (~3), a slot's
# interval, rank and stores (~30); a slot's tests after the walk (~40) and
# a step of each end's reference search (~4)
RESOLVE_INSTR = dict(compares=3, slots=30, finish=40, search=4)


@dataclasses.dataclass
class ResolveCall:
    """A ``resolve_seeds`` call: every parameter by name."""

    args: dict

    @classmethod
    def of(cls, *args, **kw) -> "ResolveCall":
        bound = _SIG.bind(*args, **kw)
        bound.apply_defaults()
        a = dict(bound.arguments)
        for k in ("mems", "n_mem"):
            a[k] = a[k].clone()
        return cls(a)

    def replace(self, **kw) -> "ResolveCall":
        return ResolveCall(dict(self.args, **kw))

    @property
    def fm(self):
        return self.args["fm"]

    @property
    def dims(self) -> tuple[int, int, int]:
        """(B, M, S)."""
        B, M, _ = self.args["mems"].shape
        return B, M, self.args["max_seeds"]

    @property
    def cap(self) -> int:
        B, _, S = self.dims
        return kch.walk_cap(B, S, self.args["compact_cap"])

    @property
    def shape(self) -> str:
        B, M, S = self.dims
        rdt = str(self.args["mems"].dtype).removeprefix("torch.")
        return (f"B {B}, M {M}, S {S}, max_occ {self.args['max_occ']}, cap "
                f"{self.cap}, ranks {rdt}")

    def run(self, plain: bool = False) -> dict:
        fn = kch.resolve_seeds_plain if plain else kch.resolve_seeds
        return fn(**self.args)

    def _expand_inputs(self) -> tuple:
        a = self.args
        return (a["mems"].contiguous(), a["n_mem"].to(torch.int32),
                a["max_occ"], a["max_seeds"])

    def _ends(self, n_walk: torch.Tensor):
        B, _, S = self.dims
        return torch.cumsum(n_walk, 0) if self.cap < B * S else None

    def host(self, lib: ctypes.CDLL) -> dict:
        """The call on the host build ``lib`` of csrc/resolve.cu (CPU
        tensors): the expansion's lane bodies, the plain walk under its
        mask, then the finish's lane bodies."""
        ex, args, _ = rcu.expand_args(*self._expand_inputs())
        _host(lib, "resolve_expand", args)
        pos = kfm.sa_resolve_plain(self.fm, ex["ranks"],
                                   self.args["sa_interval"], mask=ex["walk"])
        out, args, _ = rcu.finish_args(self.fm, ex, pos,
                                       self._ends(ex["n_walk"]), self.cap)
        _host(lib, "resolve_finish", args)
        return out

    def stages(self) -> tuple[dict, torch.Tensor, torch.Tensor | None]:
        """On the card: the expansion's outputs, the walked positions and
        the running counts of walking lanes (None without a cap)."""
        ex = rcu.resolve_expand_cuda(*self._expand_inputs())
        pos = kfm.sa_resolve(self.fm, ex["ranks"], self.args["sa_interval"],
                             mask=ex["walk"])
        return ex, pos, self._ends(ex["n_walk"])

    def expand_ms(self, calls: int = 20, reps: int = 5) -> float:
        """``resolve_expand``'s device milliseconds a launch (a CUDA
        graph of ``calls`` launches, the median of ``reps`` replays)."""
        inputs = self._expand_inputs()
        return shapes.graph_ms(lambda: rcu.resolve_expand_cuda(*inputs),
                               calls, reps)

    def finish_ms(self, calls: int = 20, reps: int = 5) -> float:
        """``resolve_finish``'s device milliseconds a launch, as
        ``expand_ms``."""
        ex, pos, ends = self.stages()
        return shapes.graph_ms(lambda: rcu.resolve_finish_cuda(
            self.fm, ex, pos, ends, self.cap), calls, reps)

    def walk_ms(self, calls: int = 20, reps: int = 5) -> dict:
        """The SA walk's device milliseconds a launch (CUDA graphs) under
        the expansion's mask, every walking lane (``all``: the kernels'
        route, the cap applied after the walk), and under the mask of the
        lanes within the cap alone (``capped``); and the lanes walking,
        ``walking``."""
        ex, _, _ = self.stages()
        walk = ex["walk"]
        flat = walk.reshape(-1)
        capped = (flat & (torch.cumsum(flat.to(torch.int32), 0) <= self.cap)
                  ).reshape(walk.shape)
        ranks, iv = ex["ranks"], self.args["sa_interval"]
        ms = {k: shapes.graph_ms(lambda m=m: kfm.sa_resolve(
            self.fm, ranks, iv, mask=m), calls, reps)
              for k, m in (("all", walk), ("capped", capped))}
        return dict(ms, walking=int(flat.sum()))

    def plain_ms(self) -> tuple[float, float, dict]:
        """The plain twin's milliseconds before its walk and after it
        (CUDA events around the walk's call), and its outputs."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        walk = kfm.sa_resolve

        def timed(*args, **kw):
            ev[1].record()
            out = walk(*args, **kw)
            ev[2].record()
            return out

        torch.cuda.synchronize()
        kfm.sa_resolve = timed
        try:
            ev[0].record()
            out = self.run(plain=True)
            ev[3].record()
        finally:
            kfm.sa_resolve = walk
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3]), out

    def clocked(self, plain: bool = False) -> float:
        """Seconds of one call between two device synchronisations."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.run(plain)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def counts(self, ex: dict, out: dict) -> dict:
        """What each kernel's bound needs, from the expansion's outputs
        ``ex`` and the call's ``out``: each input read once where the
        function needs it and each output written once. The expansion
        reads the live intervals and the row counts and writes every
        slot's three R values and two flags and each read's count and
        overflow; the finish reads each slot's two flags, a valid slot's
        position (walked or the row's), start and length, the reads'
        counts, and the reference offsets, and writes the six outputs.
        Instructions: the sort's and the slots' compares, a slot's work
        (RESOLVE_INSTR)."""
        a = self.args
        B, M, S = self.dims
        rb = a["mems"].element_size()
        live = a["n_mem"].long().clamp(0, M)
        n_live = int(live.sum())
        valid = int((ex["walk"] | ex["posrow"]).sum())
        n_refs = self.fm.ref_offsets.numel()
        size = lambda t: t.numel() * t.element_size()
        c = RESOLVE_INSTR
        search = 2 * max(n_refs.bit_length(), 1) * c["search"]
        return dict(
            expand=dict(
                read=5 * rb * n_live + 4 * B,
                written=sum(size(ex[k]) for k in ex),
                instr=c["compares"] * (B * M * M + B * S * M)
                + c["slots"] * B * S),
            finish=dict(
                read=2 * B * S + 3 * rb * valid + (4 + 1 + 8) * B
                + rb * n_refs,
                written=sum(size(out[k]) for k in FIELDS),
                instr=(c["finish"] + search) * valid))

    def shifted(self, by: int = PAST_2_31) -> "ResolveCall":
        """The call with int64 ranks and every rank value and position
        past 2^31: the index's values (``fm_calls.shifted``), the
        intervals' k column, l_pac and the reference offsets moved by
        ``by`` and the doubled length by twice it, as if ``by`` bases lay
        before the first reference."""
        fm = fm_calls.shifted(self.fm, by)
        fm = fm._replace(ref_offsets=fm.ref_offsets + by, l_pac=fm.l_pac + by,
                         seq_len=fm.seq_len + 2 * by)
        mems = self.args["mems"].to(torch.int64).clone()
        mems[:, :, 0] += by
        return self.replace(fm=fm, mems=mems)


def _host(lib: ctypes.CDLL, entry: str, args: list) -> None:
    rc = bind(lib, f"{entry}_host", stream=False)(array(args), len(args))
    if rc != 0:
        raise RuntimeError(f"{entry}_host refused its arguments ({rc})")


def max_abs_err(got: dict, want: dict) -> int:
    """The largest difference over ``resolve_seeds``' outputs (0:
    bit-equal; -1 for a mismatched key, shape or dtype)."""
    if got.keys() != want.keys():
        return -1
    err = 0
    for k in want:
        a, b = got[k], want[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            return -1
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


@contextlib.contextmanager
def recording(calls: list):
    """Record every ``resolve_seeds`` call ``align/pipeline.py`` makes in
    the block into ``calls``, then make it."""
    saved = pipeline.resolve_seeds

    def rec(*args, **kw):
        calls.append(ResolveCall.of(*args, **kw))
        return saved(*args, **kw)

    pipeline.resolve_seeds = rec
    try:
        yield calls
    finally:
        pipeline.resolve_seeds = saved


def _mems(es, rng, B: int, M: int, rank_frac: float, big_frac: float,
          edges: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(mems int64 [B, M, 5], n_mem int32 [B]) on ``es``'s index: rank
    rows (three quarters of 1-3 occurrences, the others 4-40, but
    ``big_frac`` of them 400-900) and position rows (l 1), ``rank_frac``
    of the rows ranks; with ``edges``, a quarter of the position rows at
    l_pac and at the ends of each reference on both strands (lengths
    19-30 around them: some bridge)."""
    idx = es.idx
    n1 = idx.seq_len + 1
    u = rng.random((B, M))
    s = np.where(u < big_frac, rng.integers(400, 901, (B, M)),
                 np.where(u < 0.75, rng.integers(1, 4, (B, M)),
                          rng.integers(4, 41, (B, M))))
    k = rng.integers(0, n1 - 900, (B, M))
    posrow = rng.random((B, M)) >= rank_frac
    k = np.where(posrow, rng.integers(0, idx.seq_len - 200, (B, M)), k)
    if edges:
        l_pac, seq = idx.l_pac, idx.seq_len
        offs = [int(o) for o in idx.ref_offsets] + [l_pac]
        marks = np.array([l_pac] + [x for o in offs
                                    for x in (o, seq - o)], np.int64)
        at = posrow & (rng.random((B, M)) < 0.25)
        k = np.where(at, np.clip(rng.choice(marks, (B, M))
                                 + rng.integers(-30, 8, (B, M)), 0, seq - 1),
                     k)
    s = np.where(posrow, 1, s)
    start = rng.integers(0, 120, (B, M))
    end = start + rng.integers(19, 31, (B, M))
    mems = np.stack([k, posrow.astype(np.int64), s, start, end], -1)
    return (torch.from_numpy(mems),
            torch.from_numpy(rng.integers(0, M + 1, B).astype(np.int32)))


def edge_calls(es, fm, device="cpu") -> dict:
    """{name: call} on ``es``'s index with ``fm`` (either rank dtype) on
    ``device`` (see the module's docstring)."""
    rng = np.random.default_rng(71)
    rdt = fm.rank_dtype
    t = lambda x: x.to(device)
    iv = es.idx.sa_interval

    def call(B, M, S, cap, max_occ=500, rank_frac=0.7, big_frac=0.03):
        mems, n_mem = _mems(es, rng, B, M, rank_frac, big_frac, edges=True)
        return ResolveCall.of(fm, t(mems.to(rdt)), t(n_mem), max_occ, S,
                              sa_interval=iv, compact_cap=cap)

    return {
        # K = min((B x S) // 4, 4096) = 4096 of ~17,000 rank lanes
        "cap 4096 flooded": call(640, 24, 64, 4096),
        # K = (B x S) // 4, the rank lanes ~ 2/3 of the slots
        "cap (B x S) // 4 flooded": call(192, 24, 64, 0, rank_frac=0.9),
        "no cap": call(256, 24, 64, None),
        # K 64: the cap cuts inside a read, every read after it overflows
        "cap 64": call(96, 16, 64, 64),
        # max_occ 2: nearly every rank row sampled, totals past S
        "max_occ 2": call(128, 24, 64, 0, max_occ=2, big_frac=0.2),
        "position rows only": call(256, 24, 64, 4096, rank_frac=0.0),
        "B x S <= 4096": call(48, 24, 64, 4096),
        "S 8": call(128, 24, 8, 0),
        "M 142, S 189": call(64, 142, 189, None, big_frac=0.05),
        # the FM seeder's M = W // 16 + 48 and S = W // 12 + 64 at 8 kb,
        # 18 kb (int64: past a block's shared memory) and 25 kb (int32
        # too) reads, and the 18 kb fat retry (M 32, S doubled)
        "M 548, S 730 (8 kb)": call(8, 548, 730, None, big_frac=0.05),
        "M 1173, S 1564 (18 kb)": call(4, 1173, 1564, None, big_frac=0.05),
        "M 1610, S 2147 (25 kb)": call(2, 1610, 2147, None, big_frac=0.05),
        "M 32, S 3128 (18 kb fat retry)": call(3, 32, 3128, None,
                                               max_occ=2, big_frac=0.2),
    }


def random_calls(es, fm, seed: int, device="cpu", B: int = 512, M: int = 24,
                 S: int = 64) -> dict:
    """{name: call}: random intervals from ``seed`` on ``es``'s index,
    counts from -3 (negative: dead counts and offsets that fall) to 900,
    query spans of any order, max_occ 1-600, at a cap that floods."""
    rng = np.random.default_rng(seed)
    mems, n_mem = _mems(es, rng, B, M, 0.6, 0.1, edges=True)
    mems[:, :, 2] = torch.from_numpy(np.where(
        rng.random((B, M)) < 0.05, rng.integers(-3, 1, (B, M)),
        mems[:, :, 2].numpy()))
    mems[:, :, 3:] = torch.from_numpy(rng.integers(0, 200, (B, M, 2)))
    max_occ = int(rng.integers(1, 601))
    return {f"random {seed}": ResolveCall.of(
        fm, mems.to(fm.rank_dtype).to(device), n_mem.to(device), max_occ, S,
        sa_interval=es.idx.sa_interval, compact_cap=(B * S) // 8)}


def host_library(out_dir) -> ctypes.CDLL:
    """csrc/resolve.cu built for the host with g++ (its host entries) in
    ``out_dir``, loaded; raises without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    so = Path(out_dir) / "libresolve_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-o", str(so), str(build.CSRC / build.SOURCES["resolve"])],
                   check=True)
    return ctypes.CDLL(str(so))
