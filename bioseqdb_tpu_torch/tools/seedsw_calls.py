"""The seed-SW kernel against its plain twin, at the shapes the pipeline
gives it.

- ``recording(calls)``: inside the block, every ``seed_sw_filter`` call
  of ``align/pipeline.py`` is recorded (its tensors cloned) as a
  ``FilterCall`` and then made as usual; ``plain_filter()``: inside the
  block the pipeline filters with the plain twin;
- ``FilterCall``: one ``seed_sw_filter`` call; ``run`` makes it with the
  kernel (CUDA tensors) or as ``seed_sw_filter_plain``, ``stage`` gives
  its scoring call;
- ``ScoreCall``: the scores of one call's windows (``seed_sw_windows``);
  ``run`` makes it on the kernel (``seedsw_cuda.seed_sw_cuda``) or the
  plain twin (``seed_sw_scores_plain``), ``host`` on a host build of
  ``csrc/seedsw.cu`` (``host_library``), ``kernel_ms`` times a launch in
  a CUDA graph, ``plain_ms`` the plain twin, ``counts`` gives what the
  bound needs (bytes read and written, the DP cells the needed lanes'
  windows span), ``shifted`` moves the windows past 2^31 (int64 ranks);
- ``edge_calls(rank_dtype)``: hand-made filter calls on a two-reference
  genome: reads just below and at the activation length (724, 725 bp)
  and long ones, seeds whose windows cross l_pac or a reference's end,
  seeds at the read's ends, seeds of 99 bp (a 199-wide window) and of 200
  or more (not re-scored), a seed whose best score is exactly min_hsp and
  one a point below it, Ns in the reads, invalid slots; at the default
  scores and at asymmetric gap penalties with a min_chain_weight;
- ``edge_score_calls(rank_dtype)``: hand-made windows for the kernel
  alone: tlen and qlen 0, 1, 2 and 199, query windows past the read's
  width, target windows outside the text (code 4), lanes not needed.

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
ACTIVE_LEN = 725        # the first read length the filter re-scores
PAST_2_31 = 1 << 32     # the shift of ``ScoreCall.shifted``
# instructions a DP cell needs at least: the substitution score (a
# compare-select pair, 2), diag (1), E (two add-maxes, 2), hne (a
# three-way max, 1), the opener term and its running max (an add-max, 1),
# F (1), H (1) and the best (1): 10
INSTR_PER_CELL = 10


@dataclasses.dataclass
class ScoreCall:
    """The scoring of one filter call: ``args`` of
    ``seedsw.seed_sw_scores_plain`` by name (pac_rows, seq_len, codes,
    win and the six scores)."""

    args: dict

    @property
    def shape(self) -> str:
        a = self.args
        B, W = a["codes"].shape
        win = a["win"]
        rdt = str(win["rb"].dtype).removeprefix("torch.")
        return (f"B {B}, W {W}, {win['need'].shape[0]} lanes, "
                f"{int(win['need'].sum())} needed, ranks {rdt}")

    def run(self, plain: bool = False) -> torch.Tensor:
        fn = seedsw.seed_sw_scores_plain if plain else scu.seed_sw_cuda
        return fn(**self.args)

    def host(self, lib: ctypes.CDLL) -> torch.Tensor:
        """The call on the host build ``lib`` of csrc/seedsw.cu (CPU
        tensors): the kernel's lane bodies, every lane in turn."""
        score, args, _ = scu.seed_sw_args(**self.args)
        rc = scu.bind(lib, "seed_sw_host", stream=False)(*args)
        if rc != 0:
            raise RuntimeError(f"seed_sw_host refused its arguments ({rc})")
        return score

    def kernel_ms(self, calls: int = 20, reps: int = 5) -> float:
        """The kernel's device milliseconds a launch: CUDA events around a
        CUDA graph of ``calls`` launches, the median of ``reps`` replays
        (``shapes.graph_ms``)."""
        return shapes.graph_ms(self.run, calls, reps)

    def plain_ms(self) -> tuple[float, torch.Tensor]:
        """The plain twin's milliseconds (CUDA events) and output."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        out = self.run(plain=True)
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]), out

    def counts(self) -> dict:
        """What the call's bound needs: the lanes that need the SW, their
        DP cells (tlen rows x qlen columns: a column past the query's end
        or the read's holds code 4, scores -1 against every base and so
        cannot raise the best score, though the plain version and the
        kernel compute all 200), the bytes the function must read (each
        lane's need flag; a needed lane's window bounds, its query codes
        inside the read and the text words under its target window) and
        write (a score a lane), and INSTR_PER_CELL instructions a cell."""
        a = self.args
        win, W = a["win"], a["codes"].shape[1]
        need = win["need"]
        rb, re = win["rb"][need].long(), win["re"][need].long()
        qb, qe = win["qb"][need].long(), win["qe"][need].long()
        tlen = (re - rb).clamp(0, scu.WIDTH)
        qlen = (torch.minimum(qe, torch.full_like(qe, W)) - qb).clamp(
            0, scu.WIDTH)
        words = torch.where(tlen > 0, ((rb + tlen - 1) >> 4) - (rb >> 4) + 1,
                            0)
        lanes = int(need.sum())
        cells = int((tlen * qlen).sum())
        rank = win["rb"].element_size()
        read = (need.numel() + lanes * (8 + 2 * rank)
                + 4 * int(qlen.sum()) + 4 * int(words.sum()))
        return dict(lanes=lanes, cells=cells, read=read,
                    written=4 * need.numel(), instr=INSTR_PER_CELL * cells)

    def shifted(self) -> "ScoreCall":
        """The call with the target windows and the text length moved up
        by PAST_2_31 in int64: every text position reads the table's last
        word (the index clamp) on both sides, so the call tests the int64
        window arithmetic, not the codes."""
        a = self.args
        up = lambda t: t.to(torch.int64) + PAST_2_31
        win = dict(a["win"], rb=up(a["win"]["rb"]), re=up(a["win"]["re"]))
        return ScoreCall(dict(a, win=win, seq_len=a["seq_len"] + PAST_2_31))


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

    def stage(self) -> ScoreCall:
        a = self.args
        win = seedsw.seed_sw_windows(a["fm"], a["lens"], a["seeds"],
                                     a["match_score"], a["min_chain_weight"])
        return ScoreCall(dict(
            pac_rows=a["pac_rows"], seq_len=a["fm"].seq_len,
            codes=a["codes"].to(torch.int32).contiguous(), win=win,
            **{k: a[k] for k in SCORING}))


def max_abs_err(got, want) -> int:
    """The largest difference of the filters' ``valid`` and ``score`` (or
    of two score tensors); 0: bit-equal, -1: a mismatched shape or
    dtype."""
    pairs = ([(got[k], want[k]) for k in ("valid", "score")]
             if isinstance(got, dict) else [(got, want)])
    err = 0
    for a, b in pairs:
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
    kinds, each read's forward origin): the hand-made reads and seeds on a
    two-reference genome."""
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
    xs = []
    for b, L in enumerate(lens):
        x = int(rng.integers(0, l_pac - L)) if L < l_pac else 0
        xs.append(x)
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
            torch.from_numpy(np.asarray(lens, np.int32)), out, kinds, xs)


def edge_calls(rank_dtype: torch.dtype = torch.int32, device="cpu",
               setup=None) -> list[tuple[str, FilterCall]]:
    """(name, call): ``edge_setup``'s batch at the default scores
    (min_chain_weight 0) and at ``ASYMMETRIC`` with min_chain_weight 20,
    ranks in ``rank_dtype``, on ``device``."""
    idx, _, codes, lens, seeds, _, _ = setup or edge_setup()
    fm = kfm.FMDevice.from_host(idx, "cpu", rank_dtype=rank_dtype)
    pac_rows = torch.from_numpy(layout.pack_doubled_rows(np.asarray(idx.pac)))
    seeds = dict(seeds, rbeg=seeds["rbeg"].to(rank_dtype))
    base = dict(fm=fm, pac_rows=pac_rows, codes=codes, lens=lens,
                seeds=seeds)
    return [(name, FilterCall(dict(base, **scores,
                                   min_chain_weight=mcw)).to(device))
            for name, scores, mcw in (("default scores", SCORING, 0),
                                      ("asymmetric gaps, mcw 20",
                                       ASYMMETRIC, 20))]


def edge_score_calls(rank_dtype: torch.dtype = torch.int32, device="cpu",
                     setup=None) -> list[tuple[str, ScoreCall]]:
    """(name, call): hand-made windows over ``edge_setup``'s reads for the
    kernel alone, at the default scores and at ``ASYMMETRIC``: every
    pairing of tlen and qlen in (0, 1, 2, 199) near the reads' true
    diagonals, query windows running past the batch width (code 4),
    target windows before the text's start and past its end (code 4),
    and lanes not needed."""
    idx, g, codes, lens, _, _, xs = setup or edge_setup()
    rng = np.random.default_rng(73)
    B, W = codes.shape
    seq_len = 2 * len(g)
    rows = []
    for t in (0, 1, 2, 199):
        for q in (0, 1, 2, 199):
            rows.append((int(rng.integers(0, 1200)), q, t, True))
    rows += [(W - 50, 120, 150, True), (W - 1, 80, 60, True),
             (100, 150, 190, True), (40, 199, 199, True)]
    rows += [(int(rng.integers(0, 1300)), int(rng.integers(1, 200)),
              int(rng.integers(1, 200)), bool(rng.random() < 0.8))
             for _ in range(40)]
    S = -(-len(rows) // B)
    rows += [(0, 0, 0, False)] * (B * S - len(rows))
    n = torch.arange(len(rows))
    qb = torch.tensor([r[0] for r in rows], dtype=torch.int32)
    qe = qb + torch.tensor([r[1] for r in rows], dtype=torch.int32)
    tl = torch.tensor([r[2] for r in rows], dtype=torch.int64)
    # targets on the read's diagonal (shifted back by up to 20 bases),
    # some before the text's start or past its end
    x = torch.tensor(xs, dtype=torch.int64)[n // S]
    rb = x + qb - torch.from_numpy(rng.integers(0, 21, len(rows)))
    rb = torch.where(n % 5 == 3, -tl // 2, rb)
    rb = torch.where(n % 7 == 4, seq_len - tl // 2, rb)
    need = torch.tensor([r[3] for r in rows])
    win = dict(qb=qb, qe=qe, rb=rb.to(rank_dtype), re=(rb + tl).to(rank_dtype),
               need=need)
    pac_rows = torch.from_numpy(layout.pack_doubled_rows(np.asarray(idx.pac)))
    return [(name, ScoreCall(dict(pac_rows=pac_rows.to(device),
                                  seq_len=seq_len,
                                  codes=codes.to(device),
                                  win={k: v.to(device) for k, v in
                                       win.items()},
                                  **scores)))
            for name, scores in (("windows, default scores", SCORING),
                                 ("windows, asymmetric gaps", ASYMMETRIC))]
