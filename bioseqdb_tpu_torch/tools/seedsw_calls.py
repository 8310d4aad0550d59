"""The seed-SW kernel against its plain twin, at the shapes the pipeline
gives it.

- ``recording(calls)``: inside the block, every ``seed_sw_filter`` call
  of ``align/pipeline.py`` is recorded (its tensors cloned) as a
  ``FilterCall`` and then made as usual; ``plain_filter()``: inside the
  block the pipeline filters with the plain twin;
- ``FilterCall``: one ``seed_sw_filter`` call; ``run`` makes it with the
  kernel (CUDA tensors) or as ``seed_sw_filter_plain``, ``host`` on a
  host build of ``csrc/seedsw.cu`` (``host_library``), ``kernel_ms``
  times a call in a CUDA graph, ``plain_ms`` the plain twin, ``windows``
  gives its windows (``seed_sw_windows``), ``counts`` what the bound
  needs (bytes read and written, the DP cells the needed lanes' windows
  span), ``shifted`` moves it past 2^31 (int64 ranks);
- ``SCORINGS``: the scorings every hand-made call is made at: the
  defaults (the s16x2 body), asymmetric gaps with a min_chain_weight, and
  ``WIDE`` (match and mismatch scores past the s16x2 body's bytes: the
  s32 body);
- ``edge_calls(rank_dtype)``: hand-made filter calls on a two-reference
  genome: reads just below and at the activation length (724, 725 bp)
  and long ones, seeds whose windows cross l_pac or a reference's end,
  seeds at the read's ends, seeds of 99 bp (a 199-wide window) and of 200
  or more (not re-scored), a seed whose best score is exactly min_hsp and
  one a point below it, Ns in the reads, invalid slots;
- ``fold_calls(rank_dtype)``: hand-made filter calls for the window
  bounds the kernel folds in, on a genome of five references (two of 1
  and 2 bases): reads at both activation lengths (min_chain_weight 0 and
  20), query windows of the kernel's column boundaries (qlen 1, 2, 199
  and either side of each group width), targets across l_pac and past
  reference ends with mid on either side, tlen 1, 2 and 199, an all-N
  read;
- ``random_calls(rank_dtype, seed)``: random reads and seeds on the
  fold genome (seeds near and far from the read's diagonal, lengths past
  199, invalid slots).

``chip_smoke.py``'s seed-SW phase and the seed-SW kernel's tests use it.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import inspect
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from bioseqdb_tpu_torch.align import pipeline
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.index import layout
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.kernels import build, seedsw
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels import seedsw_cuda as scu
from bioseqdb_tpu_torch.tools import shapes
from bioseqdb_tpu_torch.tools.chain_calls import _clone
from bioseqdb_tpu_torch.tools.extend_calls import _to
from bioseqdb_tpu_torch.utils.sim import simulate_genome

_SIG = inspect.signature(seedsw.seed_sw_filter)
_OPT = AlignOptions()
SCORING = dict(match_score=_OPT.match_score,
               mismatch_penalty=_OPT.mismatch_penalty, o_del=_OPT.o_del,
               e_del=_OPT.e_del, o_ins=_OPT.o_ins, e_ins=_OPT.e_ins)
# asymmetric gaps, so a swapped gap direction shows
ASYMMETRIC = dict(match_score=2, mismatch_penalty=3, o_del=5, e_del=1,
                  o_ins=3, e_ins=2)
# ASYMMETRIC times 64: a match score past 127 and a mismatch penalty past
# 128 do not fit the s16x2 body's profile bytes (csrc/seedsw.cu fits16),
# so the entry takes the s32 body
WIDE = {k: 64 * v for k, v in ASYMMETRIC.items()}
# (name, scoring, min_chain_weight) of every hand-made call
SCORINGS = (("default scores", SCORING, 0),
            ("asymmetric gaps, mcw 20", ASYMMETRIC, 20),
            ("scores past 16 bits (s32 body)", WIDE, 0))
ACTIVE_LEN = 725        # the first read length the filter re-scores
PAST_2_31 = 1 << 32     # the shift of ``FilterCall.shifted``
# instructions a DP cell needs at least on this card: two cells in the
# 16-bit halves of a register take the substitution score (one prmt of
# the query profile), E (two DPX add-maxes), hne (one add-max-relu), H
# (one max) and F (two add-maxes): 7 a pair, 3.5 a cell (the running best,
# folded every other column, not counted)
INSTR_PER_CELL = 3.5
# the first count, a cell in 32 bits: the substitution score (a
# compare-select pair, 2), diag (1), E (two add-maxes, 2), hne (a
# three-way max, 1), the opener term and its running max (an add-max, 1),
# F (1), H (1) and the best (1): 10
INSTR_PER_CELL_FIRST = 10


@dataclasses.dataclass
class FilterCall:
    """A ``seed_sw_filter`` call: ``args`` every parameter by name."""

    args: dict

    @classmethod
    def of(cls, *args, **kw) -> "FilterCall":
        bound = _SIG.bind(*args, **kw)
        return cls({k: _clone(v) for k, v in bound.arguments.items()})

    def to(self, device) -> "FilterCall":
        return FilterCall({k: _to(v, device) for k, v in self.args.items()})

    def lanes(self, idx) -> "FilterCall":
        """The call on the reads ``idx`` only (index tensor or slice)."""
        a = dict(self.args, codes=self.args["codes"][idx],
                 lens=self.args["lens"][idx])
        a["seeds"] = {k: v[idx] for k, v in a["seeds"].items()}
        return FilterCall(a)

    @property
    def shape(self) -> str:
        B, S = self.args["seeds"]["rbeg"].shape
        return f"B {B}, S {S}, W {self.args['codes'].shape[1]}"

    def run(self, plain: bool = False) -> dict:
        fn = seedsw.seed_sw_filter_plain if plain else seedsw.seed_sw_filter
        return fn(**self.args)

    def kernel_ms(self, calls: int = 20, reps: int = 5) -> float:
        """The whole call's device milliseconds on the card (``run``: the
        kernel's one launch): CUDA events around a CUDA graph of ``calls``
        calls, the median of ``reps`` replays (``shapes.graph_ms``)."""
        return shapes.graph_ms(self.run, calls, reps)

    def plain_ms(self) -> tuple[float, dict]:
        """The plain twin's milliseconds (CUDA events) and output."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        out = self.run(plain=True)
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]), out

    def _table(self) -> torch.Tensor:
        a = self.args
        return seedsw.activation_table(a["codes"].shape[1], a["match_score"],
                                       a["min_chain_weight"],
                                       a["codes"].device)

    def host(self, lib: ctypes.CDLL) -> dict:
        """The call on the host build ``lib`` of csrc/seedsw.cu (CPU
        tensors): the kernel's block, group and lane bodies, in turn;
        valid and score."""
        a = self.args
        (valid, score), args, _ = scu.seed_sw_filter_args(
            a["fm"], a["pac_rows"], a["codes"], a["lens"], a["seeds"],
            self._table(), **{k: a[k] for k in SCORING})
        rc = scu.bind(lib, "seed_sw_filter_host", stream=False)(*args)
        if rc != 0:
            raise RuntimeError(f"seed_sw_filter_host refused its arguments "
                               f"({rc})")
        return dict(valid=valid, score=score)

    def windows(self) -> dict:
        """The call's windows and need mask (``seed_sw_windows``)."""
        a = self.args
        return seedsw.seed_sw_windows(a["fm"], a["lens"], a["seeds"],
                                      a["match_score"], a["min_chain_weight"])

    def counts(self) -> dict:
        """What the whole filter's bound needs: the lanes that need the
        SW, their DP cells (tlen rows x qlen columns: a column past the
        query's end or the read's holds code 4, scores -1 against every
        base and so cannot raise the best score, though the plain version
        computes all 200), the bytes the function must read (each lane's
        seed: rbeg, qbeg, len and valid; each read's length; a needed
        lane's query codes inside the read and the text words under its
        target window) and write (valid and score a lane), INSTR_PER_CELL
        instructions a cell (``instr``) and the first count's
        INSTR_PER_CELL_FIRST (``instr_first``). The reference table's few
        rows are not counted."""
        win, W = self.windows(), self.args["codes"].shape[1]
        need = win["need"]
        rb, re = win["rb"][need].long(), win["re"][need].long()
        qb, qe = win["qb"][need].long(), win["qe"][need].long()
        tlen = (re - rb).clamp(0, scu.WIDTH)
        qlen = (torch.minimum(qe, torch.full_like(qe, W)) - qb).clamp(
            0, scu.WIDTH)
        words = torch.where(tlen > 0, ((rb + tlen - 1) >> 4) - (rb >> 4) + 1,
                            0)
        cells = int((tlen * qlen).sum())
        seeds = self.args["seeds"]
        N = seeds["rbeg"].numel()
        return dict(lanes=int(need.sum()), cells=cells,
                    read=(N * (seeds["rbeg"].element_size() + 9)
                          + 4 * self.args["lens"].numel()
                          + 4 * int(qlen.sum()) + 4 * int(words.sum())),
                    written=5 * N, instr=INSTR_PER_CELL * cells,
                    instr_first=INSTR_PER_CELL_FIRST * cells)

    def shifted(self) -> "FilterCall":
        """The call on an index PAST_2_31 bases longer on each strand, in
        int64: a reference of PAST_2_31 bases before the others, every
        seed's rbeg moved up by PAST_2_31 (a forward position and its
        reverse complement both move by it); every text position reads the
        table's last word (the index clamp) in the kernel and its twin, so
        the call tests the int64 window arithmetic and the reference
        search, not the codes."""
        a, fm = self.args, self.args["fm"]
        i64, d = torch.int64, PAST_2_31
        zero = torch.zeros(1, dtype=i64, device=fm.ref_offsets.device)
        fm = fm._replace(
            ref_offsets=torch.cat([zero, fm.ref_offsets.to(i64) + d]),
            ref_lens=torch.cat([zero + d, fm.ref_lens.to(i64)]),
            l_pac=fm.l_pac + d, seq_len=fm.seq_len + 2 * d)
        seeds = dict(a["seeds"], rbeg=a["seeds"]["rbeg"].to(i64) + d)
        return FilterCall(dict(a, fm=fm, seeds=seeds))


def max_abs_err(got, want) -> int:
    """The largest difference of the filters' ``valid`` and ``score``; 0:
    bit-equal, -1: a mismatched shape or dtype."""
    err = 0
    for a, b in ((got[k], want[k]) for k in ("valid", "score")):
        if a.shape != b.shape or a.dtype != b.dtype:
            return -1
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


@contextlib.contextmanager
def recording(calls: list):
    """Record every ``seed_sw_filter`` call ``align/pipeline.py`` makes in
    the block into ``calls``, then make it."""
    saved = pipeline.seed_sw_filter

    def rec(*args, **kw):
        calls.append(FilterCall.of(*args, **kw))
        return saved(*args, **kw)

    pipeline.seed_sw_filter = rec
    try:
        yield calls
    finally:
        pipeline.seed_sw_filter = saved


@contextlib.contextmanager
def plain_filter():
    """Within the block, ``align/pipeline.py`` filters with
    ``seed_sw_filter_plain`` (the eager scoring the port ran before the
    kernel) on any device."""
    saved = pipeline.seed_sw_filter
    pipeline.seed_sw_filter = seedsw.seed_sw_filter_plain
    try:
        yield
    finally:
        pipeline.seed_sw_filter = saved


def host_library(out_dir) -> ctypes.CDLL:
    """csrc/seedsw.cu built for the host with g++ (its host entry) in
    ``out_dir``, loaded; raises without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    so = Path(out_dir) / "libseedsw_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-o", str(so), str(build.CSRC / build.SOURCES["seedsw"])],
                   check=True)
    return ctypes.CDLL(str(so))


_COMP = {0: 3, 1: 2, 2: 1, 3: 0}


def edge_setup():
    """(index, genome codes (forward, 0..3), read codes int32 [B, W], lens
    int32 [B], seeds (rbeg int64, qbeg, len int32, valid bool [B, S]),
    kinds): the hand-made reads and seeds on a two-reference genome."""
    rng = np.random.default_rng(71)
    refs = [("a", simulate_genome(3_000, seed=71)),
            ("b", simulate_genome(2_500, seed=72))]
    idx = build_index(refs)
    g = np.asarray(idx.pac, np.int64) & 3
    l_pac = len(g)
    W, S = 1504, 16
    lens = [724, 725, 725, 1500, 1500, 900, 1500, 1500]
    kinds = ["below_active", "at_active", "min_hsp", "long", "strand",
             "ref_end", "n_rich", "random"]
    B = len(lens)
    codes = np.full((B, W), 4, np.int32)
    seeds = {k: np.zeros((B, S), np.int64) for k in ("rbeg", "qbeg", "len")}
    valid = np.zeros((B, S), bool)
    for b, L in enumerate(lens):
        x = int(rng.integers(0, l_pac - L)) if L < l_pac else 0
        codes[b, :L] = g[x: x + L]
        slots = []
        if kinds[b] == "min_hsp":
            # the best local score of these seeds' windows is exactly the
            # read's min_hsp (36 at 725 bp), then one below: an exact match
            # of that many bases in query windows that mismatch the text
            # everywhere else
            for q, n in ((150, 36), (450, 35)):
                codes[b, q - 60: q + n + 60] = [
                    _COMP[int(c)] for c in g[x + q - 60: x + q + n + 60]]
                codes[b, q: q + n] = g[x + q: x + q + n]
                slots.append((x + q, q, n))
        elif kinds[b] == "strand":
            # reference windows across l_pac from either side
            for k, (r, n) in enumerate(((l_pac - 60, 40), (l_pac - 10, 30),
                                        (l_pac + 5, 50), (l_pac - 100, 99))):
                slots.append((r, 100 * k + 50, n))
        elif kinds[b] == "ref_end":
            e = len(refs[0][1])   # a's end, b's start
            for k, (r, n) in enumerate(((e - 30, 40), (e - 120, 60),
                                        (e + 10, 30), (2 * l_pac - e - 20,
                                                       40),
                                        (0, 20), (2 * l_pac - 30, 25))):
                slots.append((r, 100 * k + 10, n))
        if kinds[b] == "n_rich":
            codes[b, rng.integers(0, L, 60)] = 4
        # seeds on the read's true diagonal: at the read's ends, 99 bp (a
        # 199-wide window), 200 bp (not re-scored), and random ones
        slots += [(x, 0, 30), (x + L - 25, L - 25, 25), (x + 300, 300, 99),
                  (x + 500, 500, 200)]
        while len(slots) < S - 2:
            q = int(rng.integers(0, L - 20))
            n = int(rng.integers(15, 120))
            r = (x + q + int(rng.integers(-3, 4)) if rng.random() < 0.7
                 else int(rng.integers(0, 2 * l_pac - n)))
            slots.append((r, q, n))
        for s, (r, q, n) in enumerate(slots[:S - 2]):
            seeds["rbeg"][b, s], seeds["qbeg"][b, s], seeds["len"][b, s] = (
                r, q, n)
            valid[b, s] = True
        # the last two slots: invalid, with a seed's values in them
        seeds["rbeg"][b, S - 2:] = x + 10
        seeds["len"][b, S - 2:] = 40
    out = dict(rbeg=torch.from_numpy(seeds["rbeg"]),
               qbeg=torch.from_numpy(seeds["qbeg"]).to(torch.int32),
               len=torch.from_numpy(seeds["len"]).to(torch.int32),
               valid=torch.from_numpy(valid))
    return (idx, g, torch.from_numpy(codes),
            torch.from_numpy(np.asarray(lens, np.int32)), out, kinds)


def edge_calls(rank_dtype: torch.dtype = torch.int32, device="cpu",
               setup=None) -> list[tuple[str, FilterCall]]:
    """(name, call): ``edge_setup``'s batch at each of ``SCORINGS``, ranks
    in ``rank_dtype``, on ``device``."""
    idx, _, codes, lens, seeds, _ = setup or edge_setup()
    fm = kfm.FMDevice.from_host(idx, "cpu", rank_dtype=rank_dtype)
    pac_rows = torch.from_numpy(layout.pack_doubled_rows(np.asarray(idx.pac)))
    seeds = dict(seeds, rbeg=seeds["rbeg"].to(rank_dtype))
    base = dict(fm=fm, pac_rows=pac_rows, codes=codes, lens=lens,
                seeds=seeds)
    return [(name, FilterCall(dict(base, **scores,
                                   min_chain_weight=mcw)).to(device))
            for name, scores, mcw in SCORINGS]


# fold_setup's reference lengths (two of one and two bases: windows of
# tlen 1 and 2), its reads' lengths (the activation at min_chain_weight 20
# starts at 440, at 0 at 725) and the query widths its edge seeds take:
# 1, 2, 199 and either side of each column count a group covers
# (csrc/seedsw.cu: 8 threads of 4, 7, ..., 25 columns)
FOLD_REFS = (1_500, 1, 2, 900, 1_200)
FOLD_LENS = (439, 440, 724, 725, 1_500, 1_500, 1_500)
FOLD_QLENS = (1, 2, 31, 32, 33, 55, 56, 57, 103, 104, 105, 127, 128, 129,
              175, 176, 177, 199)


def fold_setup():
    """(index, read codes int32 [B, W], lens int32 [B], seeds (rbeg int64,
    qbeg, len int32, valid bool [B, S])): hand-made seeds for the window
    bounds the kernel folds in, on a genome of FOLD_REFS: each read at
    FOLD_LENS (the sixth all N) holds seeds whose query windows are
    FOLD_QLENS wide (seeds ending past the read), whose targets cross
    l_pac with mid on either side, pass a reference's end with mid on
    either side (both strands), lie in the one- and two-base references
    (tlen 1, 2) or span 199 bases, and random ones on the read's
    diagonal."""
    rng = np.random.default_rng(75)
    refs = [(f"r{k}", simulate_genome(n, seed=75 + k))
            for k, n in enumerate(FOLD_REFS)]
    idx = build_index(refs)
    g = np.asarray(idx.pac, np.int64) & 3
    l_pac, seq_len = idx.l_pac, idx.seq_len
    off = [int(o) for o in idx.ref_offsets]
    end = [o + n for o, n in zip(off, FOLD_REFS)]
    W, S = 1504, 48
    B = len(FOLD_LENS)
    codes = np.full((B, W), 4, np.int32)
    seeds = {k: np.zeros((B, S), np.int64) for k in ("rbeg", "qbeg", "len")}
    valid = np.zeros((B, S), bool)
    rev = lambda x, n: seq_len - x - n   # a forward span's reverse start
    for b, L in enumerate(FOLD_LENS):
        x = int(rng.integers(0, max(1, l_pac - L)))
        n = min(L, l_pac - x)
        if b != 5:   # the all-N read keeps code 4
            codes[b, :n] = g[x: x + n]
        slots = [(x + 40, L + 50 - q, 99) for q in FOLD_QLENS]
        slots += [(l_pac - 20, 300, 30), (l_pac - 5, 340, 30),
                  (end[3] - 30, 400, 30), (end[3] - 10, 440, 30),
                  (rev(end[3] - 30, 30), 480, 30),
                  (rev(end[3] - 10, 30), 520, 30),
                  (off[1] - 20, 560, 40), (off[2] - 20, 600, 40),
                  (rev(off[1], 1) - 20, 640, 40), (x + 200, 200, 99)]
        while len(slots) < S - 1:
            q = int(rng.integers(0, L - 20))
            k = int(rng.integers(15, 120))
            slots.append((x + q + int(rng.integers(-3, 4)), q, k))
        for s_, (r, q, k) in enumerate(slots):
            seeds["rbeg"][b, s_], seeds["qbeg"][b, s_], seeds["len"][b, s_] = (
                r, q, k)
            valid[b, s_] = True
    out = dict(rbeg=torch.from_numpy(seeds["rbeg"]),
               qbeg=torch.from_numpy(seeds["qbeg"]).to(torch.int32),
               len=torch.from_numpy(seeds["len"]).to(torch.int32),
               valid=torch.from_numpy(valid))
    return (idx, torch.from_numpy(codes),
            torch.from_numpy(np.asarray(FOLD_LENS, np.int32)), out)


def fold_calls(rank_dtype: torch.dtype = torch.int32, device="cpu",
               setup=None, name: str = "fold"
               ) -> list[tuple[str, FilterCall]]:
    """(name, call): ``fold_setup``'s batch (or ``setup``'s (index,
    codes, lens, seeds)) at each of ``SCORINGS``, ranks in ``rank_dtype``,
    on ``device``."""
    idx, codes, lens, seeds = setup or fold_setup()
    fm = kfm.FMDevice.from_host(idx, "cpu", rank_dtype=rank_dtype)
    pac_rows = torch.from_numpy(layout.pack_doubled_rows(np.asarray(idx.pac)))
    seeds = dict(seeds, rbeg=seeds["rbeg"].to(rank_dtype))
    base = dict(fm=fm, pac_rows=pac_rows, codes=codes, lens=lens,
                seeds=seeds)
    return [(f"{name}, {what}", FilterCall(dict(
        base, **scores, min_chain_weight=mcw)).to(device))
            for what, scores, mcw in SCORINGS]


def random_calls(rank_dtype: torch.dtype, seed: int, device="cpu",
                 setup=None, B: int = 32, S: int = 64
                 ) -> list[tuple[str, FilterCall]]:
    """(name, call): ``B`` random reads on ``fold_setup``'s genome
    (lengths 300 to 1,500 at width 1,504, 0-3% substitutions, some Ns,
    either strand), ``S`` random seeds each (70% near the read's true
    diagonal, the others anywhere in the doubled text; lengths 10 to 220,
    query starts anywhere in the read; 90% valid), from ``seed``: at each
    of ``SCORINGS``."""
    idx = (setup or fold_setup())[0]
    rng = np.random.default_rng(seed)
    g = np.asarray(idx.pac, np.int64) & 3
    l_pac, seq_len, W = idx.l_pac, idx.seq_len, 1504
    lens = rng.integers(300, 1501, B)
    codes = np.full((B, W), 4, np.int32)
    x = rng.integers(0, l_pac - 1500, B)
    for b, L in enumerate(lens):
        r = g[x[b]: x[b] + L].astype(np.int32)
        sub = rng.random(L) < rng.choice([0.0, 0.01, 0.03])
        r[sub] = rng.integers(0, 4, int(sub.sum()))
        r[rng.random(L) < 0.002] = 4
        if rng.random() < 0.5:   # the reverse strand: its text position
            r = np.where(r < 4, 3 - r, 4)[::-1]
            x[b] = seq_len - x[b] - L
        codes[b, :L] = r
    qbeg = (rng.random((B, S)) * (lens[:, None] - 5)).astype(np.int64)
    slen = rng.integers(10, 221, (B, S))
    near = rng.random((B, S)) < 0.7
    rbeg = np.where(near, x[:, None] + qbeg + rng.integers(-4, 5, (B, S)),
                    rng.integers(0, seq_len - 220, (B, S)))
    seeds = dict(rbeg=torch.from_numpy(rbeg),
                 qbeg=torch.from_numpy(qbeg).to(torch.int32),
                 len=torch.from_numpy(slen).to(torch.int32),
                 valid=torch.from_numpy(rng.random((B, S)) < 0.9))
    return fold_calls(rank_dtype, device, setup=(
        idx, torch.from_numpy(codes),
        torch.from_numpy(lens.astype(np.int32)), seeds), name=f"random {seed}")
