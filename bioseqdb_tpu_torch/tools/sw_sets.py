"""Inputs of the SW kernel (``csrc/sw_extend.cu``) for ``chip_smoke.py``
and ``tools/sw_profile.py``: the seeded case sets, the main path's
set-up, and a recorder of the SW launches the main path makes.

Case sets (``sw_sets``): small ones at narrow widths; ``synthetic``
(16,384 read-like pairs at the extension stage's widths, Wq 160, Wt
624); ``int16_edge`` (h0 + a * qlen from 200 below to 8 above the int16
limit, so the kernel's arithmetic must hold values past int16);
``wide_320`` (Wq 320) and ``retry_band`` (band 200, the band-doubling
retry); and the long-read widths, where the kernel keeps H and E in a
ring over the band: ``long_1500`` (4,096 read-like pairs up to 1,500
bases at the widths a batch of 1,500 bp reads launches, Wq 1,504 and Wt
1,968, band 100) and ``wide_2048`` (1,024 pairs up to 2,048 bases at Wq
2,048, Wt 2,512, band 200); and past the ring's shared memory, where
it takes its wide layout: ``wide_18000`` (16 pairs up to 18,000 bases,
the launch of a batch of 16 18 kb reads, band 100) and ``wide_25000``
(64 pairs up to 25,000 bases, band 200).
"""

from __future__ import annotations

import numpy as np
import torch

from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.cpu.ksw import fill_scmat
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import extend as extend_mod
from bioseqdb_tpu_torch.kernels.sw import FIELDS, sw_extend_batch
from bioseqdb_tpu_torch.kernels.sw_cuda import sw_extend_cuda
from bioseqdb_tpu_torch.tools.shapes import graph_ms
from bioseqdb_tpu_torch.utils.sim import simulate_genome, simulate_reads

# the main path: a 4.6 Mb simulated genome (E. coli scale) and batches of
# 16,384 150 bp single-end reads at 1% substitutions
GENOME_LEN = 4_600_000
BATCH = 16_384
READ_LEN = 150
SW_GAPS = dict(o_del=6, e_del=1, o_ins=6, e_ins=1)
# the extension stage's buffer widths for 150 bp reads: the read width W,
# and W + 4 * band + 64 (kernels/extend.py)
MAIN_WQ, MAIN_WT = 160, 624
INT16_MAX = 32767
SW_CALLS = 5        # launches in the CUDA graph that times one
# a long-read batch's widths: Wq = W (1,500 bp reads pack to 1,504) and
# Wt = W + 4 * band + 64
LONG_WQ, LONG_WT = 1504, 1968
WIDE_WQ, WIDE_WT = 2048, 2512
# past the ring layout's shared memory: sw_extend's wide layout (18 kb and
# 25 kb reads), lanes up to the full width each: {name: (lanes, Wq, Wt,
# band)}
WIDE_LAYOUT = {"wide_18000": (16, 18000, 18464, 100),
               "wide_25000": (64, 25000, 25464, 200)}


def sw_cases(rng, n, max_q, max_t, amb=False, indel=False):
    """Read-like (query, target, h0) triples: a query, and a target that
    starts with its mutated copy and runs on with random bases."""
    cases = []
    for _ in range(n):
        ql = int(rng.integers(1, max_q + 1))
        qq = rng.integers(0, 5 if amb else 4, ql)
        tt = qq.copy()
        if indel and tt.size > 8:
            p = int(rng.integers(2, tt.size - 4))
            k = int(rng.integers(1, 4))
            tt = (np.delete(tt, slice(p, p + k)) if rng.random() < 0.5
                  else np.insert(tt, p, rng.integers(0, 4, k)))
        m = rng.random(tt.size) < 0.05
        tt[m] = rng.integers(0, 5 if amb else 4, m.sum())
        tail = rng.integers(0, 4, int(rng.integers(0, max_t)))
        tt = np.concatenate([tt, tail])[:max_t]
        if rng.random() < 0.2:   # unrelated pair
            tt = rng.integers(0, 4, int(rng.integers(1, max_t + 1)))
        cases.append((qq, tt, int(rng.integers(0, 80))))
    return cases


def sw_inputs(cases, max_q, max_t, dev):
    B = len(cases)
    q = np.full((B, max_q), 4, np.int32)
    t = np.full((B, max_t), 4, np.int32)
    qlen, tlen, h0 = (np.zeros(B, np.int32) for _ in range(3))
    for i, (qq, tt, hh) in enumerate(cases):
        q[i, : len(qq)] = qq
        t[i, : len(tt)] = tt
        qlen[i], tlen[i], h0[i] = len(qq), len(tt), hh
    return [torch.from_numpy(x).to(dev) for x in (q, qlen, t, tlen, h0)]


def edge_cases(rng, n, a):
    """Read-like pairs whose h0 puts h0 + a * qlen from 200 below to 8
    above the int16 limit, in that order."""
    cases = [(qq, tt, INT16_MAX - a * len(qq) + int(rng.integers(-200, 9)))
             for qq, tt, _ in sw_cases(rng, n, 152, 616, indel=True)]
    return sorted(cases, key=lambda c: c[2] + a * len(c[0]))


def sw_sets(rng) -> list:
    """(name, cases, Wq, Wt, w, zdrop, end_bonus, a, b) of every case
    set, drawn from ``rng`` in this order, the sets of WIDE_LAYOUT last
    (their plain runs take seconds to a minute each)."""
    return [
        ("random", sw_cases(rng, 64, 50, 90), 64, 128, 100, 100, 5, 1, 4),
        ("narrow_band", sw_cases(rng, 64, 40, 60), 64, 128, 3, 100, 5, 1, 4),
        ("zdrop", sw_cases(rng, 64, 40, 60), 64, 128, 100, 5, 5, 1, 4),
        ("ambiguous_indels", sw_cases(rng, 64, 60, 90, amb=True, indel=True),
         64, 128, 100, 100, 5, 1, 4),
        ("ragged_11", sw_cases(rng, 11, 20, 30), 24, 32, 100, 100, 5, 2, 3),
        ("synthetic", sw_cases(rng, BATCH, 152, 616, indel=True), MAIN_WQ,
         MAIN_WT, 100, 100, 5, 1, 4),
        ("int16_edge", edge_cases(rng, 512, 1),
         MAIN_WQ, MAIN_WT, 100, 100, 5, 1, 4),
        ("wide_320", sw_cases(rng, 2048, 320, 616, indel=True), 320, 640,
         100, 100, 5, 1, 4),
        ("retry_band", sw_cases(rng, 2048, 152, 616, indel=True), MAIN_WQ,
         MAIN_WT, 200, 100, 5, 1, 4),
        ("long_1500", sw_cases(rng, 4096, 1500, LONG_WT, indel=True),
         LONG_WQ, LONG_WT, 100, 100, 5, 1, 4),
        ("wide_2048", sw_cases(rng, 1024, WIDE_WQ, WIDE_WT, indel=True),
         WIDE_WQ, WIDE_WT, 200, 100, 5, 1, 4),
        *((name, sw_cases(rng, n, wq, wt, indel=True), wq, wt, w, 100, 5,
           1, 4) for name, (n, wq, wt, w) in WIDE_LAYOUT.items()),
    ]


class SwCall:
    """One set of ``sw_extend`` inputs, runnable through the plain version
    or a launch function with ``sw_cuda.sw_extend_cuda``'s signature (the
    package's kernel by default)."""

    def __init__(self, q, qlen, t, tlen, w0, h0, kw):
        # the widest band is passed, so that a wide launch inside a CUDA
        # graph capture need not read it from w0
        kw = dict(kw)
        if kw.get("max_w") is None:
            kw["max_w"] = int(w0.max()) if len(w0) else 0
        self.args, self.kw = (q, qlen, t, tlen, w0, h0), kw
        self.mat = torch.from_numpy(fill_scmat(
            kw["match_score"], kw["mismatch_penalty"])).to(q.device)

    @classmethod
    def from_cases(cls, cases, wq, wt, w, zdrop, bonus, a, b, dev):
        q, qlen, t, tlen, h0 = sw_inputs(cases, wq, wt, dev)
        return cls(q, qlen, t, tlen, torch.full_like(qlen, w), h0,
                   dict(match_score=a, mismatch_penalty=b, end_bonus=bonus,
                        zdrop=zdrop, **SW_GAPS))

    def plain(self, count_cells=False):
        q, qlen, t, tlen, w0, h0 = self.args
        k = self.kw
        return sw_extend_batch(q, qlen, t, tlen, self.mat, k["o_del"],
                               k["e_del"], k["o_ins"], k["e_ins"], w0,
                               k["end_bonus"], k["zdrop"], h0, q.shape[1],
                               count_cells=count_cells)

    def kernel(self, launch=sw_extend_cuda):
        return launch(*self.args, **self.kw)

    def ms(self, launch=sw_extend_cuda) -> float:
        """Device milliseconds of one launch: a CUDA graph of SW_CALLS
        launches, so that the host's enqueue time does not count."""
        return graph_ms(lambda: self.kernel(launch), SW_CALLS)

    def subset(self, lanes: torch.Tensor) -> "SwCall":
        return SwCall(*(x[lanes].contiguous() for x in self.args), self.kw)

    def err(self, ref, launch=sw_extend_cuda) -> int:
        got = self.kernel(launch)
        torch.cuda.synchronize()
        return max(int((ref[f] - got[f]).abs().max()) for f in FIELDS)

    def shape(self) -> str:
        q, qlen, t, tlen = self.args[:4]
        active = int(((qlen > 0) & (tlen > 0)).sum())
        return (f"B={q.shape[0]} ({active} active) Wq={q.shape[1]} "
                f"Wt={t.shape[1]} w={int(self.args[4].max())}")


class recording:
    """Within the block, every call of the SW wrapper that
    ``kernels/extend.py`` makes also appends its inputs to ``calls`` as a
    ``SwCall``: a copy, or with ``copy=False`` the tensors themselves
    (for their shapes), every launch. A copy is made only of a launch
    whose gate is open: one that is closed (a dead round, or a side with
    no retry: it computes nothing) is counted in ``closed`` instead, and
    reading the gate waits on the card. In the block ``extend_all`` runs
    launch by launch (its gates; no CUDA graph, whose replays call no
    wrapper). A recorded call keeps no gate: its replays compute every
    lane."""

    def __init__(self, calls: list, copy: bool = True):
        self.calls, self.copy = calls, copy
        self.closed = 0

    def __enter__(self):
        self.real = real = extend_mod.sw_extend_cuda
        self.route = extend_mod._ROUTE
        if self.route in (None, "graph"):
            extend_mod._ROUTE = "gates"

        def rec(q, qlen, t, tlen, w0, h0, gate=None, **kw):
            if self.copy and gate is not None and int(gate) == 0:
                self.closed += 1
            else:
                self.calls.append(SwCall(*(x.clone() if self.copy else x
                                           for x in (q, qlen, t, tlen, w0,
                                                     h0)), kw))
            return real(q, qlen, t, tlen, w0, h0, gate=gate, **kw)

        extend_mod.sw_extend_cuda = rec
        return self

    def __exit__(self, *exc):
        extend_mod.sw_extend_cuda = self.real
        extend_mod._ROUTE = self.route


def main_path_setup(dev):
    """The main path's index (genome seed 1), ``Aligner`` on ``dev``, its
    two read batches (read seeds 100, the warm-up, and 101) with their
    simulations, and the genome."""
    genome = simulate_genome(GENOME_LEN, seed=1)
    idx = build_index([("sim", genome)])
    al = Aligner.build(idx, AlignOptions(), device=dev)
    sims = [simulate_reads(genome, BATCH, read_len=READ_LEN, sub_rate=0.01,
                           seed=100 + k) for k in range(2)]
    return idx, al, sims, [pack_reads(s.reads, s.names) for s in sims], genome
