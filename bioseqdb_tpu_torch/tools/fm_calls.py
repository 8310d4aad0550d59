"""The FM index's SA-walk and backward-search kernels against their plain
twins, at the shapes the pipeline gives them.

- ``recording(calls)``: inside the block, every ``sa_resolve`` and
  ``backward_search`` call (``kernels/fm.py``'s, wherever the pipeline
  makes it: ``resolve_seeds``, ``exact_align_step``) is recorded (its
  tensors cloned) as an ``FmCall`` and then made as usual;
- ``FmCall``: one call's kind and arguments; ``run`` makes it on the
  kernel (``fm.sa_resolve`` / ``fm.backward_search``) or the plain twin,
  ``host`` on the g++ build of ``csrc/fm.cu`` (CPU tensors),
  ``kernel_ms`` times a launch in a CUDA graph, ``plain_ms`` the plain
  twin, ``counts`` gives what the bound needs (the distinct table rows
  the lanes read, the bytes in and out, the steps);
- ``edge_setup``: a small index (two references, a repeat) and its
  edge ranks and reads: rank 0, the primary, ``seq_len``, the dummy
  rank 1, the rank one LF step before the primary, marked ranks (no
  step), ranks that need every step; empty, one- and two-base,
  full-width, all-ambiguous and no-match reads, an ambiguous base at
  either end, repeats, a base before the text's start, a length past
  the width; ``edge_calls`` the calls on them
  (with a lane mask; for the kernel and its twin also ranks off the
  table, an FM with many major checkpoints and one whose primary rank
  is unmarked), ``random_calls`` random ranks and reads from a seed,
  ``shifted`` an FM whose rank values lie past 2^31, ``synthetic_mems``
  seed intervals for ``resolve_seeds``;
- ``host_library``: ``csrc/fm.cu`` built for the host with g++.

``chip_smoke.py``'s FM-index phase and the FM kernels' tests use it.
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

from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels import fm_cuda
from bioseqdb_tpu_torch.tools import shapes
from bioseqdb_tpu_torch.utils.sim import simulate_genome, simulate_reads

OUTPUTS = dict(sa_resolve=("pos",), backward_search=("lo", "hi"))
_FNS = dict(sa_resolve=(kfm.sa_resolve, kfm.sa_resolve_plain),
            backward_search=(kfm.backward_search, kfm.backward_search_plain))
_SIG = {k: inspect.signature(v[0]) for k, v in _FNS.items()}
# instructions a step at least: sa_resolve's mark test, stored position,
# row index, code decode, the count over ~4.5 live words (XOR, shift-OR,
# mask, popcount, add each), the picks and the sum (~60); its slot at the
# end (~30); backward_search's two counts and their sums (~70)
SA_INSTR_STEP, SA_INSTR_SLOT, BS_INSTR_STEP = 60, 30, 70
EDGE_W = 120      # the edge reads' width
PAST_2_31 = 3 << 30   # ``shifted``'s offset of every rank value
_TABLES = dict(sa_resolve=("mark", "occ", "major", "cnt", "sa_major",
                           "sample"),
               backward_search=("occ", "major"))


def _clone(v):
    return v.clone() if isinstance(v, torch.Tensor) else v


@dataclasses.dataclass
class FmCall:
    """An ``sa_resolve`` or ``backward_search`` call: ``kind`` its name,
    ``args`` every parameter by name (defaults filled in)."""

    kind: str
    args: dict

    @classmethod
    def of(cls, kind: str, *args, **kw) -> "FmCall":
        bound = _SIG[kind].bind(*args, **kw)
        bound.apply_defaults()
        return cls(kind, {k: _clone(v) for k, v in bound.arguments.items()})

    def replace(self, **changes) -> "FmCall":
        return FmCall(self.kind, dict(self.args, **changes))

    @property
    def fm(self) -> kfm.FMDevice:
        return self.args["fm"]

    @property
    def lanes(self) -> int:
        a = self.args
        return (a["ranks"].numel() if self.kind == "sa_resolve"
                else a["codes"].shape[0])

    @property
    def shape(self) -> str:
        a = self.args
        rdt = str(self.fm.rank_dtype).removeprefix("torch.")
        if self.kind == "sa_resolve":
            m = a["mask"]
            walk = "" if m is None else f", {int(m.sum())} walking"
            return (f"{self.lanes} lanes{walk}, interval "
                    f"{a['sa_interval']}, ranks {rdt}")
        B, W = a["codes"].shape
        return f"B {B}, W {W}, ranks {rdt}"

    def run(self, plain: bool = False) -> dict:
        out = _FNS[self.kind][plain](**self.args)
        if self.kind == "sa_resolve":
            return dict(pos=out)
        return dict(lo=out[0], hi=out[1])

    def host(self, lib: ctypes.CDLL) -> dict:
        """The call on the host build ``lib`` of csrc/fm.cu (CPU tensors):
        the kernel's lane bodies, every lane in turn."""
        a, fm = self.args, self.fm
        if self.kind == "sa_resolve":
            r = a["ranks"].to(fm.rank_dtype)
            m = a["mask"]
            pos, args, _ = fm_cuda.sa_resolve_args(
                fm, r.reshape(-1).contiguous(), a["sa_interval"],
                None if m is None else m.reshape(-1).contiguous())
            out = dict(pos=pos.reshape(r.shape))
        else:
            (lo, hi), args, _ = fm_cuda.backward_search_args(
                fm, a["codes"].to(torch.int32).contiguous(),
                a["lens"].to(torch.int32).contiguous())
            out = dict(lo=lo, hi=hi)
        rc = fm_cuda.bind(lib, f"{self.kind}_host", stream=False)(*args)
        if rc != 0:
            raise RuntimeError(f"{self.kind}_host refused its arguments "
                               f"({rc})")
        return out

    def kernel_ms(self, calls: int = 20, reps: int = 5) -> float:
        """The kernel's device milliseconds a launch: CUDA events around
        a CUDA graph of ``calls`` launches, the median of ``reps``
        replays (``shapes.graph_ms``), so the host's enqueue does not
        count."""
        return shapes.graph_ms(self.run, calls, reps)

    def plain_ms(self) -> tuple[float, dict]:
        """The plain twin's milliseconds (CUDA events) and outputs."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        out = self.run(plain=True)
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]), out

    def touched(self) -> dict:
        """The plain twin's ``touched`` of this call, filled: a flag a
        row of each table the lanes read (and a spare last one), the
        steps that read a row and, for ``backward_search``, the columns
        read."""
        fm, dev = self.fm, self.fm.occ_rows.device
        rows = dict(mark=fm.sa_words, occ=fm.occ_rows, major=fm.occ_majors,
                    cnt=fm.sa_cnt, sa_major=fm.sa_majors,
                    sample=fm.sa_sample)
        t = {k: torch.zeros(rows[k].shape[0] + 1, dtype=torch.bool,
                            device=dev) for k in _TABLES[self.kind]}
        t["steps"] = torch.zeros(1, dtype=torch.int64, device=dev)
        if self.kind == "backward_search":
            t["columns"] = torch.zeros(1, dtype=torch.int64, device=dev)
        _FNS[self.kind][1](**self.args, touched=t)
        return t

    def counts(self) -> dict:
        """What the call's bound needs: the distinct rows of each table
        the lanes read (``touched``), their bytes, and the bytes in and
        out: the mask and each walking lane's rank read once and each
        position written once; each read's length and the codes of the
        columns its search takes read once and its (lo, hi) written
        once. ``instr``: the steps' and
        slots' instructions at least."""
        fm = self.fm
        t = self.touched()
        n = {k: int(v[:-1].sum()) for k, v in t.items() if v.dtype ==
             torch.bool}
        rb = fm.rank_dtype.itemsize
        table = {"mark": 4, "occ": 48, "major": 4 * rb, "cnt": 4,
                 "sa_major": rb, "sample": rb}
        n["table_bytes"] = sum(table[k] * n[k] for k in _TABLES[self.kind])
        n["steps"] = int(t["steps"])
        a = self.args
        if self.kind == "sa_resolve":
            m = a["mask"]
            walking = self.lanes if m is None else int(m.sum())
            n["io_bytes"] = (walking + self.lanes) * rb + (
                0 if m is None else self.lanes)
            n["instr"] = SA_INSTR_STEP * n["steps"] + SA_INSTR_SLOT * walking
        else:
            n["columns"] = int(t["columns"])
            n["io_bytes"] = (4 * (self.lanes + n["columns"])
                             + 2 * rb * self.lanes)
            n["instr"] = BS_INSTR_STEP * n["steps"]
        return n


def max_abs_err(got: dict, want: dict, kind: str) -> int:
    """The largest difference over ``kind``'s outputs (0: bit-equal; a
    mismatched shape or dtype counts as -1)."""
    err = 0
    for k in OUTPUTS[kind]:
        a, b = got[k], want[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            return -1
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


@contextlib.contextmanager
def recording(calls: list):
    """Record every ``sa_resolve`` and ``backward_search`` call made in
    the block (through ``kernels/fm.py``'s names, as ``resolve_seeds``
    and ``exact_align_step`` make them) into ``calls``, then make it."""
    saved = {k: getattr(kfm, k) for k in _FNS}

    def recorder(kind):
        def rec(*args, **kw):
            calls.append(FmCall.of(kind, *args, **kw))
            return saved[kind](*args, **kw)
        return rec

    for k in _FNS:
        setattr(kfm, k, recorder(k))
    try:
        yield calls
    finally:
        for k, fn in saved.items():
            setattr(kfm, k, fn)


def _revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGTN", "TGCAN"))


@dataclasses.dataclass
class EdgeSetup:
    """The edge index (of the references ``refs``) and its edge inputs
    (numpy): ``ranks`` int64 with ``rank_kinds``; ``codes`` int32 [B,
    EDGE_W], ``lens`` int32 [B] with ``read_kinds``; ``steps`` the LF
    steps each rank needs."""

    idx: object
    refs: list
    ranks: np.ndarray
    rank_kinds: list
    steps: np.ndarray
    codes: np.ndarray
    lens: np.ndarray
    read_kinds: list


def _codes(batch) -> tuple[np.ndarray, np.ndarray]:
    """(codes int32 [n, EDGE_W] padded with code 4, lens int32 [n]) of a
    packed batch's n reads."""
    w = min(EDGE_W, batch.codes.shape[1])
    codes = np.full((batch.n, EDGE_W), 4, np.int32)
    codes[:, :w] = batch.codes[: batch.n, :w]
    return codes, np.asarray(batch.lens[: batch.n], np.int32)


def edge_setup(seed: int = 61, sa_interval: int = 32) -> EdgeSetup:
    """A 24 kb reference holding a 300 bp repeat twice and a 4 kb one,
    indexed at ``sa_interval`` (bwa's 32, as a GRCh38-class index takes
    it: the walks up to 31 steps; a small index's adaptive interval is
    4); its edge ranks (every rank's walk found with the plain twin on
    the CPU) and edge reads."""
    rng = np.random.default_rng(seed)
    core = simulate_genome(20_000, seed=seed)
    rep = simulate_genome(300, seed=seed + 1)
    g = core[:8000] + rep + core[8000:15000] + rep + core[15000:]
    h = simulate_genome(4_000, seed=seed + 2)
    idx = build_index([("g", g), ("h", h)], sa_interval=sa_interval)
    fm = kfm.FMDevice.from_host(idx, "cpu")
    every = torch.arange(idx.seq_len + 1, dtype=torch.int32)
    pos = kfm.sa_resolve_plain(fm, every, idx.sa_interval).numpy()
    steps = pos % idx.sa_interval
    marked = np.flatnonzero(steps == 0)
    full = np.flatnonzero(steps == idx.sa_interval - 1)
    kinds = {"zero": [0], "primary": [idx.primary], "seq_len": [idx.seq_len],
             "dummy": [1],
             "before primary": np.flatnonzero(pos == 1).tolist(),
             "marked": rng.choice(marked, 12, replace=False).tolist(),
             "all steps": rng.choice(full, 12, replace=False).tolist(),
             "random": rng.integers(0, idx.seq_len + 1, 200).tolist()}
    ranks = np.array([r for v in kinds.values() for r in v], np.int64)
    rank_kinds = [k for k, v in kinds.items() for _ in v]

    sim = simulate_reads(g, 24, read_len=100, sub_rate=0.0, seed=seed + 3)
    p = g.find(rep)
    junk = "".join(rng.choice(list("ACGT"), 60))
    reads = {
        "empty": [""],
        "one base": list("ACGT"),
        "two bases": [a + b for a in "ACGT" for b in "ACGT"],
        # the text's first 49 bases lie at the primary rank alone: the
        # step before them counts at the primary (occ's j = r - (r >
        # primary) at its edge)
        "before the text": [a + g[:49] for a in "ACGT"],
        "full width": [g[3000:3000 + EDGE_W], _revcomp(g[9000:9000 + EDGE_W])],
        "all ambiguous": ["N" * 50],
        "ambiguous first": ["N" + g[5000:5079]],
        "ambiguous last": [g[5000:5079] + "N"],
        "no match": [junk],
        "repeat": [rep[40:140], rep[:EDGE_W], _revcomp(rep[100:200]),
                   rep[250:300] + core[8000:8030]],
        "two refs": [h[:90], (g + h)[len(g) - 40 : len(g) + 40]],
        "simulated": list(sim.reads),
    }
    batch = pack_reads([r for v in reads.values() for r in v],
                       [f"e{i}" for i in range(sum(map(len,
                                                       reads.values())))])
    codes, lens = _codes(batch)
    read_kinds = [k for k, v in reads.items() for _ in v]
    # a length past the width: the first steps reread the last column
    codes = np.concatenate([codes, codes[-1:]])
    lens = np.concatenate([lens, [EDGE_W + 7]]).astype(np.int32)
    read_kinds.append("length past W")
    return EdgeSetup(idx, [g, h], ranks, rank_kinds, steps[np.clip(
        ranks, 0, idx.seq_len)], codes, lens, read_kinds)


def synthetic_mems(es: EdgeSetup, B: int = 96, M: int = 16, seed: int = 5
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mems int64 [B, M, 5], n_mem int32 [B]): seed intervals (k, l, s,
    start, end) on the edge index, as ``resolve_seeds`` takes them:
    rank rows of 1-3, 4-40 and (a few) 400-900 occurrences (more than
    max_occ: sampled), position rows (l = 1), and a row count a read
    from 0 to M."""
    rng = np.random.default_rng(seed)
    n1 = es.idx.seq_len + 1
    u = rng.random((B, M))
    s = np.where(u < 0.75, rng.integers(1, 4, (B, M)),
                 np.where(u < 0.97, rng.integers(4, 41, (B, M)),
                          rng.integers(400, 901, (B, M))))
    k = rng.integers(0, n1 - 900, (B, M))
    posrow = rng.random((B, M)) < 0.3
    k = np.where(posrow, rng.integers(0, es.idx.seq_len - 200, (B, M)), k)
    s = np.where(posrow, 1, s)
    start = rng.integers(0, 120, (B, M))
    end = start + rng.integers(19, 31, (B, M))
    mems = np.stack([k, posrow.astype(np.int64), s, start, end], -1)
    return (torch.from_numpy(mems), torch.from_numpy(
        rng.integers(0, M + 1, B).astype(np.int32)))


def shifted(fm: kfm.FMDevice, by: int = PAST_2_31) -> kfm.FMDevice:
    """``fm`` with int64 ranks and every rank value (L2, the major
    checkpoints, the samples, the references) ``by`` larger: an index's
    values past 2^31 on a small table, for the kernel and its twin."""
    fm = fm._replace(**{k: getattr(fm, k).to(torch.int64) for k in (
        "L2", "occ_majors", "sa_majors", "sa_sample", "ref_offsets",
        "ref_lens")})
    return fm._replace(**{k: getattr(fm, k) + by for k in (
        "L2", "occ_majors", "sa_majors", "sa_sample")})


def edge_calls(es: EdgeSetup, fm: kfm.FMDevice, device="cpu") -> dict:
    """{name: call} on ``es``'s edge inputs with ``fm`` (either rank
    dtype, on ``device``): the ranks, the ranks under a lane mask (every
    third lane off), [B, 4] ranks as the exact step gives them, the
    reads; and inputs that only the kernel and its twin are held to (the
    JAX package's tests take the index's own ranks and tables): ranks
    off the table (negative, past ``seq_len``, past 2^31 with int64
    ranks), which both clamp alike; the ranks and reads on
    ``many_majors(fm)`` (the ranks also at SA interval 2: one LF step);
    the ranks with the primary rank's mark bit
    cleared (``unmarked_primary``: a walk through the primary rank)."""
    t = lambda a: torch.from_numpy(a).to(device)
    ranks = t(es.ranks).to(fm.rank_dtype)
    mask = torch.arange(ranks.numel(), device=device) % 3 != 1
    iv = es.idx.sa_interval
    off = [-1, -5000, es.idx.seq_len + 1, es.idx.seq_len + 977, 2 ** 31 - 1]
    if fm.rank_dtype == torch.int64:
        off += [2 ** 31 + 3, 5 << 32]
    mm = many_majors(fm)
    far = torch.tensor([(k << 22) + 12345 for k in range(MAJORS + 2)],
                       dtype=fm.rank_dtype, device=device)
    return {
        "ranks": FmCall.of("sa_resolve", fm, ranks, iv),
        "ranks masked": FmCall.of("sa_resolve", fm, ranks, iv, mask=mask),
        "ranks [B, 4]": FmCall.of("sa_resolve", fm, ranks[:200].reshape(
            50, 4), iv),
        "reads": FmCall.of("backward_search", fm, t(es.codes), t(es.lens)),
        "ranks off the table": FmCall.of(
            "sa_resolve", fm, torch.tensor(off, dtype=fm.rank_dtype,
                                           device=device), iv),
        "ranks, many majors": FmCall.of("sa_resolve", mm,
                                        torch.cat([ranks, far]), iv),
        # one step: the LF's major row shows in the slot it lands on
        "ranks, many majors, one step": FmCall.of(
            "sa_resolve", mm, torch.cat([ranks, far]), 2),
        "reads, many majors": FmCall.of("backward_search", mm, t(es.codes),
                                        t(es.lens)),
        "ranks, primary unmarked": FmCall.of(
            "sa_resolve", unmarked_primary(fm), ranks, iv),
    }


MAJORS = 16   # many_majors' major checkpoint rows


def many_majors(fm: kfm.FMDevice, n: int = MAJORS) -> kfm.FMDevice:
    """``fm`` with ``n`` major checkpoint rows of distinct values (Occ
    row k: row 0 plus k, 3k, 5k, 7k; SA row k: -97k, so that a slot past
    the first major still lies in the samples) and L2 moved up by 3 x
    2^22, so that ranks reach the rows past the first (a major spans
    2^22 ranks): the major lookups of a small index, for the kernel and
    its twin."""
    k = torch.arange(n, device=fm.L2.device, dtype=fm.rank_dtype)
    step = torch.tensor([1, 3, 5, 7], device=k.device, dtype=k.dtype)
    return fm._replace(occ_majors=fm.occ_majors[:1] + k[:, None] * step,
                       sa_majors=-97 * k, L2=fm.L2 + (3 << 22))


def unmarked_primary(fm: kfm.FMDevice) -> kfm.FMDevice:
    """``fm`` with the primary rank's mark bit cleared: a walk that
    reaches it takes the primary's LF (rank 0), as no real index
    does."""
    w = fm.sa_words.clone()
    i, b = fm.primary >> 5, fm.primary & 31
    v = int(w[i]) & 0xFFFFFFFF & ~(1 << b)
    w[i] = v - (1 << 32) if v >= 1 << 31 else v
    return fm._replace(sa_words=w)


def random_calls(es: EdgeSetup, fm: kfm.FMDevice, seed: int, device="cpu",
                 n_ranks: int = 4096, n_reads: int = 256) -> dict:
    """{name: call}: ``n_ranks`` random ranks in [0, seq_len] and
    ``n_reads`` random reads of the edge genome (lengths 0 to EDGE_W, 0-2%
    substitutions, some Ns, some reverse complements), from ``seed``."""
    rng = np.random.default_rng(seed)
    g = es.refs[0]
    reads = []
    for _ in range(n_reads):
        n = int(rng.integers(0, EDGE_W + 1))
        p = int(rng.integers(0, len(g) - n + 1))
        r = np.frombuffer(g[p : p + n].encode(), np.uint8).copy()
        sub = rng.random(n) < rng.choice([0.0, 0.0, 0.01, 0.02])
        r[sub] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4,
                                                               sub.sum())]
        if rng.random() < 0.05 and n:
            r[rng.integers(0, n)] = ord("N")
        s = r.tobytes().decode()
        reads.append(_revcomp(s) if rng.random() < 0.5 else s)
    codes, lens = _codes(pack_reads(reads, [f"q{i}" for i in
                                            range(n_reads)]))
    t = lambda a: torch.from_numpy(a).to(device)
    ranks = rng.integers(0, es.idx.seq_len + 1, n_ranks)
    return {
        f"random ranks {seed}": FmCall.of(
            "sa_resolve", fm, t(ranks).to(fm.rank_dtype), es.idx.sa_interval),
        f"random reads {seed}": FmCall.of(
            "backward_search", fm, t(codes), t(lens)),
    }


def host_library(out_dir) -> ctypes.CDLL:
    """csrc/fm.cu built for the host with g++ (its host entries) in
    ``out_dir``, loaded; raises without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    so = Path(out_dir) / "libfm_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-o", str(so), str(build.CSRC / build.SOURCES["fm"])],
                   check=True)
    return ctypes.CDLL(str(so))
