"""The extension stage's kernels against their plain twins, at the shapes
the pipeline gives them.

- ``recording(calls)``: inside the block, every ``extend_all`` call of
  ``align/pipeline.py`` is recorded (its tensors cloned) as an
  ``ExtendCall`` and then made as usual;
- ``ExtendCall``: one ``extend_all`` call; ``run`` makes it with the
  kernels (on CUDA tensors) or with every stage's plain twin, ``stages``
  makes it and returns each stage call it made (``StageCall``, inputs
  cloned), ``syncs`` counts the host's waits on the device in a run,
  ``clocked`` splits a run's seconds into its parts, ``lanes`` takes
  some reads of the call;
- ``StageCall``: one call of ``extend_setup``, ``extend_scan``,
  ``extend_windows``, ``extend_merge`` (``side`` 0 or 1) or
  ``extend_seedcov``; ``run`` makes
  it on the kernel or the plain twin, ``host`` on a host build of
  ``csrc/extend.cu`` (``host_library``), ``kernel_ms`` times a launch in a
  CUDA graph, ``plain_ms`` the plain twin, ``counts`` gives what the
  bound needs (bytes read and written, instructions), ``shifted`` moves
  every reference coordinate past 2^31 (int64 ranks);
- ``ExtendCall.wall`` times a run between synchronisations at its ends
  (``extend_all``'s own route: its CUDA graph on the card), ``capture_s``
  one that captures that graph,
  ``graph_ms`` the device time of the gated launches of a whole call in a
  CUDA graph, ``route(name)`` forces one of ``extend.ROUTES`` in a block
  (``gates``: launch by launch, no host wait; ``guards``: the host skips
  dead rounds and retries, reading the device), ``ungated()`` runs the
  launches with every gate left off, ``dead`` is the call with no usable
  seed (every round dead); ``run`` with ``plain``, ``stages``, ``clocked``
  and ``graph_ms`` run the call launch by launch (the gates), as the
  graph captures it;
- ``edge_calls(rank_dtype)``: a hand-made edge set, simulated from a seed
  on a small two-reference genome with a repeat and aligned on the CPU:
  covered seeds skipped with and without the overlap rescue, band-doubling
  retries at bandwidth 8, overflow at max_regs 1, windows at the strand
  boundary and at each reference's ends;
- ``random_calls``: every stage on narrow random inputs;
  ``setup_calls``: the set-up on random inputs at the paths' S and C
  and at those of 8 kb and 18 kb reads (past a block's shared memory)
  (ties in the keys and the filter's order, unusable seeds, chains
  across l_pac, windows clipped at reference ends);
- ``lane_cases(rank_dtype)``: the boundaries of the kernels' thread
  layout: the scan's first stop on each edge lane of a pass, n_usable off
  a multiple of 32, more extended seeds than a warp, 0 and 16 live
  regions; the right merge at R 1 and 16 and at S 40 and 70.

``chip_smoke.py``'s extend phase and the extension tests use it.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import inspect
import shutil
import subprocess
import time
import types
from pathlib import Path

import numpy as np
import torch

from bioseqdb_tpu_torch.align import pipeline
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import build, extend
from bioseqdb_tpu_torch.kernels import extend_cuda as ecu
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels.seed import build_r3_jump
from bioseqdb_tpu_torch.tools import shapes
from bioseqdb_tpu_torch.utils.sim import simulate_genome, simulate_reads

KINDS = build.EXTEND_KERNELS
_SIG = inspect.signature(extend.extend_all)
_PLAIN = dict(extend_setup=extend.extend_setup_plain,
              extend_scan=extend.extend_scan_plain,
              extend_windows=extend.extend_windows_plain,
              extend_merge=extend.extend_merge_plain,
              extend_seedcov=extend.extend_seedcov_plain)
_CUDA = dict(extend_setup=ecu.extend_setup_cuda,
             extend_scan=ecu.extend_scan_cuda,
             extend_windows=ecu.extend_windows_cuda,
             extend_merge=ecu.extend_merge_cuda,
             extend_seedcov=ecu.extend_seedcov_cuda)
_ARGS = dict(extend_setup=ecu.setup_args,
             extend_scan=ecu.scan_args, extend_windows=ecu.windows_args,
             extend_merge=ecu.merge_args, extend_seedcov=ecu.seedcov_args)
PARTS = ("setup", "scan", "windows", "sw", "merge", "seedcov")
PAST_2_31 = 1 << 32   # the shift of ``StageCall.shifted``
# instructions the bound charges: a scan trip's compares and selects
# (~12) and ~20 a live region it tests (the containment test and two
# gap computations); a merge lane's ~40 and ~3 a region-table entry it
# copies; a seedcov seed's ~8 a region; a window code's ~4
SCAN_INSTR = dict(trips=12, region_tests=20)
MERGE_INSTR = dict(lanes=40, entries=3)
SEEDCOV_INSTR = 8
WINDOW_INSTR = 4
# the set-up: a compare of two keys in a counting rank or of a seed's
# chain in a window scan (~3); a seed's key, gaps and window ends (~60)
SETUP_INSTR = dict(compares=3, seeds=60)


def _clone(v, memo: dict):
    """A deep copy of ``v``'s tensors (a dict or tuple of them), each
    distinct tensor copied once per ``memo``."""
    if isinstance(v, torch.Tensor):
        if id(v) not in memo:
            memo[id(v)] = (v, v.clone())   # keep v alive: ids stay unique
        return memo[id(v)][1]
    if isinstance(v, dict):
        return {k: _clone(x, memo) for k, x in v.items()}
    if type(v) in (tuple, list):   # not an FMDevice: it never changes
        return type(v)(_clone(x, memo) for x in v)
    return v


def _to(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, dict):
        return {k: _to(x, device) for k, x in v.items()}
    if type(v) in (tuple, list):
        return type(v)(_to(x, device) for x in v)
    if isinstance(v, kfm.FMDevice):
        return kfm.FMDevice(*(_to(x, device) for x in v))
    return v


def max_abs_err(got, want) -> int:
    """The largest difference over two outputs (tensors, or dicts of
    them, nested); -1 for a mismatched structure, shape or dtype."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            return -1
        errs = [max_abs_err(got[k], want[k]) for k in want]
        return -1 if -1 in errs else max(errs, default=0)
    if got.shape != want.shape or got.dtype != want.dtype:
        return -1
    if not want.numel():
        return 0
    return int((got.long() - want.long()).abs().max())


@contextlib.contextmanager
def plain_stages():
    """Within the block, ``extend_all`` runs every stage's plain twin,
    on any device (the SW stays the kernel on CUDA tensors)."""
    saved = {k: getattr(extend, k) for k in KINDS}
    for k in KINDS:   # each twin takes its dispatcher's arguments
        setattr(extend, k, _PLAIN[k])
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(extend, k, fn)


@dataclasses.dataclass
class StageCall:
    """A call of stage ``kind`` (its dispatcher's arguments, ``args``)."""

    kind: str
    args: tuple

    @property
    def side(self) -> int | None:
        return self.args[0] if self.kind == "extend_merge" else None

    @property
    def tab(self) -> dict:
        """The seed tables (the set-up's seeds)."""
        return self.args[1] if self.kind == "extend_merge" else self.args[0]

    @property
    def name(self) -> str:
        return (self.kind if self.side is None
                else f"{self.kind} {('left', 'right')[self.side]}")

    @property
    def entry(self) -> str:
        """The name of the call's entry in csrc/extend.cu."""
        if self.side is None:
            return self.kind
        return ("extend_merge_left", "extend_merge_right")[self.side]

    def _wrapper_args(self) -> tuple:
        """The CUDA wrapper's arguments (the dispatcher's, but the
        windows take the text's length for the FMDevice)."""
        if self.kind == "extend_windows":
            tab, fm, pac, scan, perm, p, *_ = self.args
            return tab, fm.seq_len, pac, scan, perm, p
        return self.args

    def kernel_args(self) -> tuple[object, list, list]:
        """The entry's (outputs, allocated; argument array; tensors)."""
        return _ARGS[self.kind](*self._wrapper_args())

    def run(self, plain: bool = False):
        if plain:
            return _PLAIN[self.kind](*self.args)
        return _CUDA[self.kind](*self._wrapper_args())

    def host(self, lib):
        """The call on the host build ``lib`` of csrc/extend.cu (CPU
        tensors): the kernel's lane bodies, every lane in turn."""
        out, args, _ = self.kernel_args()
        rc = ecu.bind(lib, f"{self.entry}_host", stream=False)(
            ecu.array(args), len(args))
        if rc != 0:
            raise RuntimeError(f"{self.entry}_host refused its arguments "
                               f"({rc})")
        return out

    def kernel_ms(self, calls: int = 20, reps: int = 5) -> float:
        """The kernel's device milliseconds a launch: a CUDA graph of
        ``calls`` launches, the median of ``reps`` replays
        (``shapes.graph_ms``)."""
        return shapes.graph_ms(self.run, calls, reps)

    def plain_ms(self) -> tuple[float, object]:
        """The plain twin's milliseconds (CUDA events) and outputs."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        out = self.run(plain=True)
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]), out

    @property
    def shape(self) -> str:
        tab = self.tab
        B, S = tab["rbeg"].shape
        rdt = str(tab["rbeg"].dtype).removeprefix("torch.")
        extra = ""
        if self.kind == "extend_windows":
            extra = f", W {tab['codes'].shape[1]}"
        return f"B {B}, S {S}{extra}, ranks {rdt}"

    def shifted(self) -> "StageCall":
        """The call with every reference coordinate (rbeg, the chain
        windows, the regions' rb and re, the left result's rb) moved up
        by PAST_2_31 in int64: what the stages compute is invariant to
        it (differences and comparisons), their rb and re outputs move
        with it. Not for ``extend_windows``, which reads the text there."""
        if self.kind == "extend_windows":
            raise ValueError("the windows read the text at the positions")
        up = lambda t: t.to(torch.int64) + PAST_2_31

        def move(d: dict, keys) -> dict:
            return {k: up(v) if k in keys else v for k, v in d.items()}

        args = list(self.args)
        if self.kind == "extend_setup":
            # as if PAST_2_31 bases came before the first reference: every
            # doubled-text position, l_pac and the offsets move by it, the
            # doubled length by twice it
            seeds, chains, flt, lens, refs, p = args
            refs = dict(refs, offsets=up(refs["offsets"]),
                        lens=refs["lens"].to(torch.int64),
                        l_pac=refs["l_pac"] + PAST_2_31,
                        seq_len=refs["seq_len"] + 2 * PAST_2_31)
            return StageCall(self.kind, (move(seeds, ("rbeg",)),
                                         move(chains, ("f_rbeg", "pos")),
                                         flt, lens, refs, p))
        i = 1 if self.kind == "extend_merge" else 0
        args[i] = move(self.tab, ("rbeg", "rmax0", "rmax1"))
        if self.kind == "extend_seedcov":
            args[1] = move(args[1], ("rb", "re"))
        else:
            st = dict(args[i + 1])
            st["regs"] = move(st["regs"], ("rb", "re"))
            args[i + 1] = st
        if self.kind == "extend_merge" and self.side == 1:
            args[-1] = move(args[-1], ("rb",))
        return StageCall(self.kind, tuple(args))

    def counts(self, out) -> dict:
        """What the call's bound needs, from its outputs ``out``: the
        bytes it must read (each input once where the function needs it:
        the scan, the per-lane vectors, the live regions, the visited
        seed slots' order entries and fields, the was_ext masks and the
        active lanes' chain windows; the windows, the active rows' query
        codes and packed text words and each lane's seed; the merges, the
        lanes' seeds, results and state; seedcov, the ok mask, the fields
        of the ok slots and the region table) and write (every output
        once), and the instructions (SCAN_INSTR, MERGE_INSTR,
        SEEDCOV_INSTR a unit, WINDOW_INSTR a code written)."""
        tab = self.tab
        B, S = tab["rbeg"].shape
        rb = tab["rbeg"].element_size()
        seed = rb + 12
        size = lambda t: t.numel() * t.element_size()
        tree = lambda o: (sum(tree(v) for v in o.values())
                          if isinstance(o, dict) else size(o))
        written = tree(out)
        if self.kind == "extend_setup":
            seeds, chains = self.args[0], self.args[1]
            C = chains["f_rbeg"].shape[1]
            per_seed = rb + 4 + 4 + 1 + 4 + (4 if "score" in seeds else 0)
            read = (B * S * per_seed + B * C * (4 + 4 + rb + 4) + 4 * B
                    + 2 * self.args[4]["offsets"].numel() * rb)
            instr = (SETUP_INSTR["compares"] * B * (S * S + C * C + C * S)
                     + SETUP_INSTR["seeds"] * B * S)
            return dict(read=read, written=written, instr=instr)
        if self.kind == "extend_scan":
            st = self.args[1]
            live = st["n_regs"].clamp(0, st["regs"]["rb"].shape[1]).long()
            trips = (out["cursor"] - st["cursor"]).long() + (
                out["cursor"] < tab["n_usable"]).long()
            read = (B * 17 + int(live.sum()) * (2 * rb + 16)
                    + int(trips.sum()) * (4 + seed) + size(st["was_ext"])
                    + int(st["was_ext"].sum()) * seed
                    + int(out["act"].sum()) * 2 * rb)
            instr = (SCAN_INSTR["trips"] * int(trips.sum())
                     + SCAN_INSTR["region_tests"] * int((trips * live).sum()))
            return dict(read=read, written=written, instr=instr,
                        trips=int(trips.sum()))
        if self.kind == "extend_windows":
            qn, tn = out["qn"].long(), out["tn"].long()
            read = (B * (2 * 8 + 4 + 1 + seed + 4 + 2 * rb)
                    + 4 * int(qn.sum()) + 4 * int(((tn + 15) // 16 + 1).sum()))
            return dict(read=read, written=written,
                        instr=WINDOW_INSTR * (out["qbuf"].numel()
                                              + out["tbuf"].numel()),
                        codes=int(qn.sum() + tn.sum()))
        if self.kind == "extend_merge":
            st, retry, side = self.args[2], self.args[7], self.side
            res = 5 * 4 * (B + int(retry.sum()))
            read = B * (4 + 1 + seed + 8 + 1 + 4) + res
            if side == 1:
                read += B * (16 + rb + 8) + tree(st["regs"]) + size(
                    st["was_ext"]) + 8 * B
            entries = tree(out) // 4 if side == 1 else 0
            return dict(read=read, written=written,
                        instr=MERGE_INSTR["lanes"] * B
                        + MERGE_INSTR["entries"] * entries)
        regs = self.args[1]
        ok = tab["ok"]
        n_ok = int(ok.sum())
        R = regs["rb"].shape[1]
        read = size(ok) + n_ok * seed + B * R * (2 * rb + 12)
        return dict(read=read, written=written,
                    instr=SEEDCOV_INSTR * n_ok * R)


@dataclasses.dataclass
class ExtendCall:
    """An ``extend_all`` call: every parameter by name."""

    args: dict

    @classmethod
    def of(cls, *args, **kw) -> "ExtendCall":
        bound = _SIG.bind(*args, **kw)
        bound.apply_defaults()
        memo = {}
        a = dict(bound.arguments)
        for k in ("codes", "lens", "seeds", "chains", "flt", "mat"):
            a[k] = _clone(a[k], memo)
        return cls(a)

    def replace(self, **kw) -> "ExtendCall":
        return ExtendCall(dict(self.args, **kw))

    def to(self, device) -> "ExtendCall":
        """The call with every tensor (the FMDevice's too) on ``device``."""
        return ExtendCall({k: _to(v, device) for k, v in self.args.items()})

    def lanes(self, idx) -> "ExtendCall":
        """The call on the reads ``idx`` only (index tensor or slice)."""
        a = dict(self.args)
        for k in ("codes", "lens"):
            a[k] = a[k][idx]
        for k in ("seeds", "chains", "flt"):
            a[k] = {n: v[idx] for n, v in a[k].items()}
        return ExtendCall(a)

    @property
    def dims(self) -> tuple[int, int, int]:
        """(B, S, R)."""
        B, S = self.args["seeds"]["rbeg"].shape
        return B, S, self.args["max_regs"]

    @property
    def shape(self) -> str:
        B, S, R = self.dims
        W = self.args["codes"].shape[1]
        rdt = str(self.args["seeds"]["rbeg"].dtype).removeprefix("torch.")
        return (f"B {B}, W {W}, S {S}, R {R}, band "
                f"{self.args['bandwidth']}, ranks {rdt}")

    def eager(self):
        """A context in which ``extend_all`` runs the call launch by
        launch: the gates on CUDA tensors where no route is forced
        (what its CUDA graph captures), else as it would."""
        if self.args["codes"].is_cuda and extend._ROUTE in (None, "graph"):
            return route("gates")
        return contextlib.nullcontext()

    def run(self, plain: bool = False) -> dict:
        """``extend_all`` on the call: with the kernels on CUDA tensors
        (through its CUDA graph; the plain twins on CPU tensors), or every
        stage's plain twin, launch by launch."""
        if plain:
            with plain_stages(), self.eager():
                return extend.extend_all(**self.args)
        return extend.extend_all(**self.args)

    def stages(self, plain: bool = False) -> tuple[dict, list]:
        """``run``'s outputs and every stage call it made, in order, its
        inputs cloned as they were at the call (the right merge updates
        the state in place on the card). A call's gate is left off: a
        replay computes every output."""
        calls = []
        with (plain_stages() if plain else contextlib.nullcontext(),
              self.eager()):
            saved = {k: getattr(extend, k) for k in KINDS}

            def recorder(kind):
                def rec(*args, **kw):
                    calls.append(StageCall(kind, _clone(args, {})))
                    return saved[kind](*args, **kw)
                return rec

            for k in KINDS:
                setattr(extend, k, recorder(k))
            try:
                out = extend.extend_all(**self.args)
            finally:
                for k, fn in saved.items():
                    setattr(extend, k, fn)
        return out, calls

    def syncs(self, plain: bool = False) -> int:
        """The host's waits on the device in a run: every Tensor
        ``__bool__``, ``__int__`` and ``item`` call it makes (on CUDA
        tensors each waits for the card)."""
        n = [0]
        saved = {k: getattr(torch.Tensor, k) for k in
                 ("__bool__", "__int__", "item")}

        def counting(fn):
            def f(self, *a):
                n[0] += 1
                return fn(self, *a)
            return f

        for k, fn in saved.items():
            setattr(torch.Tensor, k, counting(fn))
        try:
            self.run(plain)
        finally:
            for k, fn in saved.items():
                setattr(torch.Tensor, k, fn)
        return n[0]

    @property
    def dead(self) -> "ExtendCall":
        """The call with every chain dropped by the filter (kept 0): no
        seed is usable, so every round is dead."""
        flt = self.args["flt"]
        return self.replace(flt=dict(flt, kept=torch.zeros_like(flt["kept"])))

    def wall(self, plain: bool = False) -> float:
        """Seconds of one run between two device synchronisations, at its
        ends only: the host's dispatch and the device's work overlap."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.run(plain)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def capture_s(self) -> float:
        """Seconds of a run that captures ``extend_all``'s CUDA graph (the
        cached graphs dropped first) and replays it, between two device
        synchronisations."""
        extend._GRAPHS.clear()
        return self.wall()

    def graph_ms(self, reps: int = 5) -> float:
        """Device milliseconds of one run with the kernels: a CUDA graph
        of one call's gated launches (what ``extend_all`` captures), the
        median of ``reps`` replays, so that the host's enqueue does not
        count."""
        with self.eager():
            return shapes.graph_ms(self.run, 1, reps)

    def clocked(self, plain: bool = False) -> dict:
        """A run's seconds by part (PARTS: each stage's calls summed, the
        SW launches), each between two device synchronisations, with
        ``total`` (the run, synchronised at its ends) and ``rest`` (the
        set-up, the sort and the retry masks)."""
        sync = (torch.cuda.synchronize if torch.cuda.is_available()
                else (lambda: None))
        sec = dict.fromkeys(PARTS, 0.0)
        part = dict(extend_setup="setup", extend_scan="scan",
                    extend_windows="windows", extend_merge="merge",
                    extend_seedcov="seedcov", sw_extend_cuda="sw")

        def clock(name, fn):
            def timed(*args, **kw):
                sync()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                sync()
                sec[part[name]] += time.perf_counter() - t0
                return out
            return timed

        with (plain_stages() if plain else contextlib.nullcontext(),
              self.eager()):
            saved = {k: getattr(extend, k) for k in part}
            for k, fn in saved.items():
                setattr(extend, k, clock(k, fn))
            try:
                sync()
                t0 = time.perf_counter()
                extend.extend_all(**self.args)
                sync()
                total = time.perf_counter() - t0
            finally:
                for k, fn in saved.items():
                    setattr(extend, k, fn)
        return dict(sec, total=total, rest=total - sum(sec.values()))


@contextlib.contextmanager
def route(name: str | None):
    """Within the block, ``extend_all`` runs every call by route
    ``name`` (one of ``extend.ROUTES``; None: the device and the group
    decide; an index mesh keeps the host's guards whatever it is)."""
    if name is not None and name not in extend.ROUTES:
        raise ValueError(f"no route {name!r}")
    saved = extend._ROUTE
    extend._ROUTE = name
    try:
        yield
    finally:
        extend._ROUTE = saved


@contextlib.contextmanager
def ungated():
    """Within the block, ``extend_all``'s windows, merges and SW launches
    take no gate: a dead round, or a side with no retry, runs every
    launch in full (for the cost of a dead round without its gate)."""
    names = ("extend_windows", "extend_merge", "sw_extend_cuda")
    saved = {k: getattr(extend, k) for k in names}

    def drop(fn):
        def f(*args, gate=None, **kw):
            return fn(*args, **kw)
        return f

    for k, fn in saved.items():
        setattr(extend, k, drop(fn))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(extend, k, fn)


@contextlib.contextmanager
def recording(calls: list):
    """Record every ``extend_all`` call ``align/pipeline.py`` makes in the
    block into ``calls``, then make it."""
    saved = pipeline.extend_all

    def rec(*args, **kw):
        calls.append(ExtendCall.of(*args, **kw))
        return saved(*args, **kw)

    pipeline.extend_all = rec
    try:
        yield calls
    finally:
        pipeline.extend_all = saved


def host_library(out_dir) -> ctypes.CDLL:
    """csrc/extend.cu built for the host with g++ (its host entries) in
    ``out_dir``, loaded; raises without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    so = Path(out_dir) / "libextend_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-o", str(so), str(build.CSRC / build.SOURCES["extend"])],
                   check=True)
    return ctypes.CDLL(str(so))


def census(call: ExtendCall) -> dict:
    """What a call exercises, from a plain run's stage calls: the seeds
    the scan skipped as covered (``skips``), the lanes whose scan the
    overlap rescue stopped (``rescued``: with no seed extended yet they
    would have skipped on), the band-doubling retries of both sides
    (``retries``), the reads that overflowed, and the active lanes whose
    chain window ends at the strand boundary l_pac (``strand``) or at a
    reference's end elsewhere (``ref_end``)."""
    out, calls = call.stages(plain=True)
    fm = call.args["fm"]
    l_pac = fm.l_pac
    ends = set()
    for o, n in zip(fm.ref_offsets.tolist(), fm.ref_lens.tolist()):
        ends |= {o, o + n, 2 * l_pac - o, 2 * l_pac - o - n}
    ends.discard(l_pac)
    n = dict.fromkeys(("skips", "rescued", "retries", "strand", "ref_end"), 0)
    for sc in calls:
        if sc.kind == "extend_scan":
            tab, st, p = sc.args
            got = sc.run(plain=True)
            n["skips"] += int((got["cursor"] - st["cursor"]).sum())
            bare = extend.extend_scan_plain(
                tab, dict(st, was_ext=torch.zeros_like(st["was_ext"])), p)
            n["rescued"] += int((bare["cursor"] != got["cursor"]).sum())
        elif sc.kind == "extend_merge":
            n["retries"] += int(sc.args[7].sum())
        elif sc.kind == "extend_windows":
            tab, scan = sc.args[0], sc.args[3]
            act = scan["act"]
            c = tab["cis"].gather(1, scan["slot"][:, None].long())
            win = torch.cat([tab[k].gather(1, c.long())[act]
                             for k in ("rmax0", "rmax1")])
            n["strand"] += int((win == l_pac).sum())
            n["ref_end"] += sum(int((win == e).sum()) for e in ends)
    return dict(n, overflow=int(out["overflow"].sum()))

# ---- the edge set ----

def _edit(s: str, rng) -> str:
    """An indel or a clip: delete, insert or replace a run of bases."""
    p = int(rng.integers(20, len(s) - 30))
    k = int(rng.integers(2, 14))
    ins = "".join("ACGT"[c] for c in rng.integers(0, 4, k))
    return [s[:p] + s[p + k :], s[:p] + ins + s[p:], s[:p] + ins + s[p + k :]
            ][int(rng.integers(0, 3))][:150]


def _revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGTN", "TGCAN"))


def edge_reads(seed: int = 61) -> tuple[list[tuple[str, str]], list[str]]:
    """(the genome's references, the reads): a 24 kb reference holding a
    400 bp repeat three times (once slightly mutated) and a 64 bp tandem
    repeat, and a 6 kb one; simulated reads with substitutions and
    indels, reads across the repeat copies (covered seeds), reads with a
    tandem unit dropped or doubled (the overlap rescue), chimeric reads, and
    reads at both ends of each reference on either strand (windows
    clipped at a reference end and at the strand boundary, l_pac)."""
    rng = np.random.default_rng(seed)
    core = simulate_genome(24_000, seed=seed)
    rep = simulate_genome(400, seed=seed + 1)
    rep2 = "".join(c if rng.random() > 0.03 else "ACGT"[rng.integers(0, 4)]
                   for c in rep)
    unit = simulate_genome(8, seed=seed + 4)
    g = (core[:6000] + rep + core[6000:9000] + unit * 8 + core[9000:12000]
         + rep + core[12000:18000] + rep2 + core[18000:])
    h = simulate_genome(6_000, seed=seed + 2)
    sim = simulate_reads(g, 40, read_len=150, sub_rate=0.02, seed=seed + 3)
    reads = list(sim.reads[:20]) + [_edit(r, rng) for r in sim.reads[20:]]
    t = 9400   # the tandem's start: a unit dropped or doubled there puts
    # seeds of one chain on two diagonals that overlap in the read
    for k in range(6):
        a, cut = t - 30 - 11 * k, t + 8 * (k % 4)
        reads += [(g[a:cut] + g[cut + 8 :])[:150],
                  (g[a:cut] + unit + g[cut:])[:150]]
    for k in range(6):   # across the repeat copies, tandem within a read
        a = 6000 + 70 * k
        reads.append(g[a - 40 : a + 110])
        reads.append(g[a + 200 : a + 275] + g[a + 200 : a + 275])
    reads += [g[3000:3075] + g[15000:15075], g[20:100] + h[50:120],
              rep[:150], _revcomp(rep[200:350])]
    for ref in (g, h):   # the ends of each reference, both strands
        for r in (ref[:150], ref[-150:], ref[5:140], ref[-140:-5]):
            reads += [r, _revcomp(r)]
    return [("g", g), ("h", h)], reads


def edge_calls(rank_dtype: torch.dtype = torch.int32, device="cpu",
               retry: bool = False
               ) -> tuple[list[tuple[str, "ExtendCall"]], "object"]:
    """([(name, call)], the index): the edge set's ``extend_all`` calls on
    ``device``, recorded from a kmer-seeded CPU batch of ``edge_reads``
    (``rank_dtype`` ranks): at the default options (band 100, 8 regions),
    at bandwidth 8 (band-doubling retries) and at max_regs 1 (overflow);
    with ``retry``, also the fat retry of the batch's overflowed rows
    (``absorb_overflow``: S 128, 16 regions, the FM seeder)."""
    refs, reads = edge_reads()
    idx = build_index(refs)
    al = pipeline.Aligner.build(idx, AlignOptions(), device="cpu")
    if rank_dtype == torch.int64:
        fm = kfm.FMDevice.from_host(idx, "cpu", rank_dtype=torch.int64)
        al = dataclasses.replace(al, fm=fm, jump=build_r3_jump(fm))
    batch = pack_reads(reads, [f"e{i}" for i in range(len(reads))])
    calls = []
    with recording(calls):
        out = al.device_regions(batch)
        if retry:
            al.absorb_overflow(batch, out)
    step = calls[0].to(device)
    named = [("default", step), ("band 8", step.replace(bandwidth=8)),
             ("max_regs 1", step.replace(max_regs=1))]
    return named + [(f"fat retry {k}", c.to(device))
                    for k, c in enumerate(calls[1:], 1)], idx

def random_calls(rank_dtype: torch.dtype = torch.int32, seed: int = 5,
                 B: int = 1024, S: int = 24, C: int = 6, R: int = 8,
                 W: int = 48, bandwidth: int = 8, device="cpu"
                 ) -> list[StageCall]:
    """One call of each stage (both merge sides) on random inputs made
    with numpy from ``seed``: values in narrow ranges, so that the
    boundaries of every test (equal lengths and diagonals, zero and
    clamped gaps, gscore 0, windows off both ends of the text, full and
    overfull region tables) come up often. Not states a run reaches:
    every input, as the kernels must equal their twins on any."""
    rng = np.random.default_rng(seed)
    ri = lambda lo, hi, *shape: torch.from_numpy(
        rng.integers(lo, hi, shape).astype(np.int64))
    i32 = lambda t: t.to(torch.int32)
    rk = lambda t: t.to(rank_dtype)
    flag = lambda pr, *shape: torch.from_numpy(rng.random(shape) < pr)
    n_words = 256
    seq_len = 16 * n_words - 37
    diag = ri(0, 4, B, S) * 3 + torch.where(flag(0.5, B, 1),
                                           ri(0, 200, B, 1),
                                           seq_len - ri(0, 200, B, 1))
    qbeg = ri(0, 40, B, S)
    slen = ri(4, 30, B, S)
    rbeg = diag + qbeg
    valid = flag(0.85, B, S)
    tab = dict(order=i32(torch.from_numpy(rng.permuted(
                   np.tile(np.arange(S), (B, 1)), axis=1))),
               n_usable=i32(ri(0, S + 1, B)), qbeg=i32(qbeg), rbeg=rk(rbeg),
               len=i32(slen), cis=i32(ri(0, C, B, S)), valid=valid,
               ok=valid & flag(0.8, B, S), lens=i32(ri(0, 90, B)),
               codes=i32(ri(0, 5, B, W)),
               rmax0=rk(ri(-30, seq_len, B, C)),
               rmax1=rk(ri(0, seq_len + 40, B, C)),
               crid=i32(ri(-1, 3, B, C)))
    # regions around random seeds, ends jittered by a few bases
    at = ri(0, S, B, R)
    q0, l0, r0 = (torch.gather(x, 1, at) for x in (qbeg, slen, rbeg))
    qb = q0 - ri(0, 6, B, R)
    qe = q0 + l0 + ri(-2, 6, B, R)
    rb = r0 - (q0 - qb) + ri(-3, 4, B, R)
    re = rb + (qe - qb) + ri(-3, 4, B, R)
    regs = dict(rb=rk(rb), re=rk(re), qb=i32(qb), qe=i32(qe),
                score=i32(ri(0, 60, B, R)), truesc=i32(ri(0, 60, B, R)),
                w=i32(ri(0, 2 * bandwidth + 4, B, R)),
                seedlen0=i32(l0 + ri(-4, 12, B, R)),
                cchain=i32(ri(-1, C, B, R)), rid=i32(ri(-1, 3, B, R)))
    n_usable = tab["n_usable"].long()
    st = dict(regs=regs, n_regs=i32(ri(0, R + 2, B)),
              cursor=i32(torch.minimum(ri(0, S, B), n_usable + ri(0, 2, B))),
              was_ext=flag(0.3, B, S), overflow=flag(0.1, B))
    opts = AlignOptions()
    p = dict(match_score=opts.match_score, o_del=opts.o_del,
             e_del=opts.e_del, o_ins=opts.o_ins, e_ins=opts.e_ins,
             bandwidth=bandwidth, pen_clip5=opts.pen_clip5,
             pen_clip3=opts.pen_clip3)
    scan = dict(slot=i32(ri(0, S, B)), act=flag(0.7, B))
    perm = torch.stack([torch.randperm(B, generator=torch.Generator()
                                       .manual_seed(seed + k))
                        for k in range(2)])
    fm = types.SimpleNamespace(seq_len=seq_len)
    pac = i32(ri(-(1 << 31), 1 << 31, n_words))
    win = extend.extend_windows_plain(tab, fm, pac, scan, perm, p)
    res = lambda: {f: i32(ri(lo, hi, B)) for f, (lo, hi) in zip(
        ("score", "qle", "tle", "gtle", "gscore", "max_off"),
        ((-5, 60), (0, 40), (0, 60), (0, 60), (-8, 60), (0, 20)))}
    retry = flag(0.3, B)
    left = extend.extend_merge_plain(0, tab, st, scan, win, res(), res(),
                                     retry, p)
    calls = [StageCall("extend_scan", (tab, st, p)),
             StageCall("extend_windows", (tab, fm, pac, scan, perm, p, None)),
             StageCall("extend_merge", (0, tab, st, scan, win, res(), res(),
                                        retry, p, None)),
             StageCall("extend_merge", (1, tab, st, scan, win, res(), res(),
                                        flag(0.3, B), p, left)),
             StageCall("extend_seedcov", (tab, regs))]
    calls = [StageCall(c.kind, _to(c.args, device)) for c in calls]
    return calls + [setup_call(rank_dtype, seed, B, S, C, bandwidth=bandwidth,
                               device=device)]


# the set-up's random references: four of 1,200, 1,800, 1,100 and 900
# bases (l_pac 5,000)
SETUP_REFS = ((0, 1200), (1200, 1800), (3000, 1100), (4100, 900))


def setup_call(rank_dtype: torch.dtype = torch.int32, seed: int = 5,
               B: int = 1024, S: int = 64, C: int = 16, score: bool = False,
               bandwidth: int = 100, device="cpu") -> StageCall:
    """An ``extend_setup`` call on random inputs made with numpy from
    ``seed``: seeds and chains' first seeds near the references' ends and
    the strand boundary (l_pac 5,000, four references), so that windows
    cross l_pac and are clipped at reference ends; chain indices past C
    and negative (outside a chain); the filter's order in a narrow range
    (ties) and ``kept`` 0-3; 15% of the seeds not valid; with ``score``,
    seed scores from -50 to 5,000 (clamped at 0 and 4,095), so that keys
    of one chain tie but for the slot."""
    rng = np.random.default_rng(seed)
    ri = lambda lo, hi, *shape: torch.from_numpy(
        rng.integers(lo, hi, shape).astype(np.int64))
    i32 = lambda t: t.to(torch.int32)
    l_pac = sum(n for _, n in SETUP_REFS)
    seq_len = 2 * l_pac
    marks = [0, l_pac, seq_len] + [x for o, n in SETUP_REFS
                                   for x in (o, o + n, seq_len - o,
                                             seq_len - o - n)]
    near = lambda *shape: (torch.from_numpy(rng.choice(marks, shape))
                           + ri(-300, 300, *shape)).clamp(0, seq_len - 1)
    seeds = dict(rbeg=near(B, S).to(rank_dtype), qbeg=i32(ri(0, 150, B, S)),
                 len=i32(ri(10, 60, B, S)),
                 valid=torch.from_numpy(rng.random((B, S)) < 0.85))
    if score:
        seeds["score"] = i32(ri(-50, 5000, B, S))
    chains = dict(assign=i32(ri(-2, C + 2, B, S)),
                  f_rbeg=near(B, C).to(rank_dtype),
                  rid=i32(ri(-1, len(SETUP_REFS) + 1, B, C)))
    flt = dict(order=i32(ri(0, max(C // 2, 1), B, C)),
               kept=i32(ri(0, 4, B, C)))
    refs = dict(offsets=torch.tensor([o for o, _ in SETUP_REFS],
                                     dtype=rank_dtype),
                lens=torch.tensor([n for _, n in SETUP_REFS],
                                  dtype=rank_dtype),
                l_pac=l_pac, seq_len=seq_len)
    opts = AlignOptions()
    p = dict(match_score=opts.match_score, o_del=opts.o_del,
             e_del=opts.e_del, o_ins=opts.o_ins, e_ins=opts.e_ins,
             bandwidth=bandwidth, pen_clip5=opts.pen_clip5,
             pen_clip3=opts.pen_clip3)
    return StageCall("extend_setup", _to(
        (seeds, chains, flt, i32(ri(0, 300, B)), refs, p), device))


# setup_calls' cases: (B, S, C, scores)
_SETUP = {"S 64, C 16": (256, 64, 16, False),
          "S 64, C 16, scores": (256, 64, 16, True),
          "S 128, C 32": (128, 128, 32, False),
          "S 128, C 32, scores": (128, 128, 32, True),
          "S 189, C 32": (96, 189, 32, False),
          "S 189, C 32, scores": (96, 189, 32, True),
          "S 1536, C 256, scores": (4, 1536, 256, True),
          # 8 kb and 18 kb reads (S = W // 12 + 64, C 32) and the 18 kb
          # fat retry (S and C doubled): past a block's shared memory at
          # both rank dtypes, so its tables take the scratch
          "S 730, C 32, scores (8 kb)": (8, 730, 32, True),
          "S 1564, C 32 (18 kb)": (4, 1564, 32, False),
          "S 3128, C 64, scores (18 kb fat retry)": (3, 3128, 64, True)}
SETUP_CASES = tuple(_SETUP)


def setup_calls(rank_dtype: torch.dtype = torch.int32, device="cpu"
                ) -> dict[str, StageCall]:
    """{name (SETUP_CASES): set-up call} at the port's paths' S and C (64
    and 16, 128 and 32, 189 and 32), with and without seed scores, at
    1,536 and 256, and at those of 8 kb and 18 kb reads and the 18 kb fat
    retry (a few reads each)."""
    return {name: setup_call(rank_dtype, seed=40 + k, B=B, S=S, C=C,
                             score=score, device=device)
            for k, (name, (B, S, C, score)) in enumerate(_SETUP.items())}


# ---- the lane cases: the warp scan's and the group merge's boundaries ----

LANE_CASES = ("scan stops at lanes 0, 31, 32", "scan n_usable off 32",
              "scan with every slot extended", "scan with no live regions",
              "scan with 16 live regions", "R 1", "R 16", "S 40", "S 70",
              "S 70 was_ext at an odd address")
_GEOMETRY = dict(lens=1000, qe=900, bare_q=950, rescue_dq=5, rescue_dr=55)


def _scan_stops(specs: list, S: int, live: int = 1, all_ext: bool = False,
                rank_dtype: torch.dtype = torch.int32, seed: int = 0,
                rescuers: tuple = (), invalid: tuple = ()
                ) -> tuple[StageCall, torch.Tensor]:
    """(a scan call of one read a spec, the cursor each read must end at).
    A spec is (cursor, n_usable, stop, how): every seed the read scans
    lies on diagonal 0 inside its last live region (covered), but the one
    ``stop`` positions past the cursor (None: none), which is uncovered
    (``how`` "bare") or covered and rescued (``how`` "rescued") by an
    extended seed of its chain on another diagonal. That rescuer is the
    slot at scanned position S - 1 (n_usable stays below it): slot
    ``rescuers[b % len(rescuers)]`` for read b, S - 1 if none are given.
    Scanned position j < S - 1 holds another slot, its seed at query 10 +
    7j mod 800 and chain j mod 16, so seeds of one chain lie 112 bases
    apart and rescue none before the stop. ``all_ext`` marks every slot
    extended; the slots ``invalid`` are not valid (so no rescuer)."""
    rng = np.random.default_rng(seed)
    B, C, R = len(specs), 16, max(live, 8)
    g = _GEOMETRY
    order = np.zeros((B, S), np.int64)
    q = np.zeros((B, S), np.int64)
    c = np.zeros((B, S), np.int64)
    was_ext = np.full((B, S), all_ext)
    want = np.zeros(B, np.int64)
    cursors, n_usable = np.zeros(B, np.int64), np.zeros(B, np.int64)
    valid = torch.ones(B, S, dtype=torch.bool)
    valid[:, list(invalid)] = False
    xs = np.array([rescuers[b % len(rescuers)] if rescuers else S - 1
                   for b in range(B)])
    for b, (cur, nu, stop, how) in enumerate(specs):
        x = xs[b]
        order[b, : S - 1] = rng.permutation(np.delete(np.arange(S), x))
        order[b, S - 1] = x
        j = np.arange(S - 1)
        q[b, order[b, : S - 1]] = 10 + (7 * j) % 800
        c[b, order[b, : S - 1]] = j % C
        cursors[b], n_usable[b] = cur, nu
        end = nu if cur < nu else cur
        if live == 0 and cur < nu:
            end = cur
        elif stop is not None and 0 <= stop and cur + stop < nu:
            end = cur + stop
            at = order[b, end]
            if how == "bare":
                q[b, at] = g["bare_q"]
            else:
                q[b, x] = q[b, at] + g["rescue_dq"]
                c[b, x] = c[b, at]
                was_ext[b, x] = True
        want[b] = end
    r = q.copy()   # diagonal 0, but a rescuer's (its query start > 0)
    rows = np.arange(B)
    r[rows, xs] += np.where(q[rows, xs] > 0, g["rescue_dr"] - g["rescue_dq"],
                            0)
    i32 = lambda a: torch.from_numpy(np.asarray(a)).to(torch.int32)
    rk = lambda a: torch.from_numpy(np.asarray(a)).to(rank_dtype)
    full = lambda v, dt=torch.int32: torch.full((B, R), v, dtype=dt)
    tab = dict(order=i32(order), n_usable=i32(n_usable), qbeg=i32(q),
               rbeg=rk(r), len=torch.full((B, S), 20, dtype=torch.int32),
               cis=i32(c), valid=valid,
               lens=torch.full((B,), g["lens"], dtype=torch.int32),
               rmax0=torch.zeros(B, C, dtype=rank_dtype),
               rmax1=torch.full((B, C), 2000, dtype=rank_dtype),
               codes=torch.zeros(B, 1, dtype=torch.int32))
    # the last live region covers; the others lie past every seed
    far = 1_000_000 + 1000 * torch.arange(R)[None, :].expand(B, R)
    rb = far.clone()
    re = far + 100
    if live:
        rb[:, live - 1], re[:, live - 1] = 0, 100_000
    regs = dict(rb=rb.to(rank_dtype), re=re.to(rank_dtype), qb=full(0),
                qe=full(g["qe"]), score=full(0), truesc=full(0), w=full(100),
                seedlen0=full(1000), cchain=full(0), rid=full(0))
    st = dict(regs=regs, n_regs=torch.full((B,), live, dtype=torch.int32),
              cursor=i32(cursors), was_ext=torch.from_numpy(was_ext),
              overflow=torch.zeros(B, dtype=torch.bool))
    opts = AlignOptions()
    p = dict(match_score=opts.match_score, o_del=opts.o_del,
             e_del=opts.e_del, o_ins=opts.o_ins, e_ins=opts.e_ins,
             bandwidth=opts.bandwidth, pen_clip5=opts.pen_clip5,
             pen_clip3=opts.pen_clip3)
    return StageCall("extend_scan", (tab, st, p)), torch.from_numpy(want)


def lane_cases(rank_dtype: torch.dtype = torch.int32, device="cpu"
               ) -> dict[str, tuple[list[StageCall], torch.Tensor | None]]:
    """{case (LANE_CASES): (its stage calls, the cursor each read of a
    scan case must end at, or None)}: the boundaries of the kernels'
    thread layout. The scan cases (``_scan_stops``): a first stop on
    lane 0, 1, 31, 32, 33, 63 and 64 of a pass, bare and rescued, from
    cursors 0 and 5; n_usable of 1, 31, 33, 45, 63, 65 and 79, ending
    there or stopping on its last lane; every slot extended (70, slot 5
    not valid, so the batches of 32 are slots 0-32, 33-64 and 65-69,
    split inside a chunk: the rescuer at 32, 33, 64, 65 or 69); no live
    regions; 16. The others
    are ``random_calls`` (every stage, 256 reads) at R 1 and 16 (the
    right merge's table under and over the group's 8 threads) and at S 40
    and 70 (its was_ext rows in 8-byte words, 70 with a byte head and
    tail; and once more with the right merge's was_ext one byte past an
    aligned address, so its rows copy byte by byte)."""
    lanes = [(cur, 99, stop, how) for cur in (0, 5)
             for stop in (0, 1, 31, 32, 33, 63, 64, None)
             for how in ("bare", "rescued")]
    usable = [(cur, nu, stop, how) for nu in (1, 31, 33, 45, 63, 65, 79)
              for cur in sorted({0, min(2, nu), nu - 1, nu})
              for stop, how in ((None, "bare"), (nu - 1 - cur, "bare"),
                                (nu - 1 - cur, "rescued"))]
    every = [(cur, 69, stop, how) for cur in (0, 3)
             for stop in (0, 31, 32, 40, None) for how in ("bare", "rescued")]
    few = [(cur, 39, stop, "bare") for cur in (0, 5, 38, 39)
           for stop in (0, 7, None)]
    cases = {
        LANE_CASES[0]: _scan_stops(lanes, 100, rank_dtype=rank_dtype),
        LANE_CASES[1]: _scan_stops(usable, 80, rank_dtype=rank_dtype, seed=1),
        LANE_CASES[2]: _scan_stops(every, 70, all_ext=True,
                                   rank_dtype=rank_dtype, seed=2,
                                   rescuers=(32, 33, 64, 65, 69),
                                   invalid=(5,)),
        LANE_CASES[3]: _scan_stops(few, 40, live=0, rank_dtype=rank_dtype,
                                   seed=3),
        LANE_CASES[4]: _scan_stops(lanes, 100, live=16,
                                   rank_dtype=rank_dtype, seed=4)}
    out = {k: ([StageCall(s.kind, _to(s.args, device))], want)
           for k, (s, want) in cases.items()}
    for name, seed, S, R in (("R 1", 11, 24, 1), ("R 16", 12, 24, 16),
                             ("S 40", 13, 40, 8), ("S 70", 14, 70, 8)):
        out[name] = (random_calls(rank_dtype, seed=seed, B=256, S=S, R=R,
                                  device=device), None)
    right = out["S 70"][0][3]
    st = dict(right.args[2], was_ext=_at_odd_address(right.args[2]["was_ext"]))
    out[LANE_CASES[-1]] = ([StageCall(right.kind, (
        *right.args[:2], st, *right.args[3:]))], None)
    return out


def _at_odd_address(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts one element past the start
    of its storage."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out
