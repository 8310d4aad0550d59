"""The minimizer seeder's kernel against its plain twin, at the shapes the
pipeline gives it.

- ``recording(calls)``: inside the block, every ``collect_seeds_kmer``
  call of ``align/pipeline.py`` is recorded (its tensors cloned) as a
  ``KmerCall`` and then made as usual; ``plain_seeder()``: inside the
  block the pipeline seeds with the plain twin;
- ``KmerCall``: one call's arguments; ``run`` makes it on the kernel
  (``kmer.collect_seeds_kmer``: CUDA tensors) or the plain twin, ``host``
  on a host build of ``csrc/kmer.cu`` (``host_library``), ``kernel_ms``
  times a launch in a CUDA graph, ``plain_ms`` the plain twin, ``counts``
  gives what the bound needs (bytes read and written, instructions),
  ``lanes`` takes some reads of the call;
- ``edge_setup()``: a three-reference genome (a tandem repeat of a short
  unit, a 600 bp repeat in three copies, one diverged, and a 24-base
  segment repeated once) and its tables; ``edge_calls`` the calls on its
  edge reads at the pipeline's options and at caps that overflow: short
  and empty reads, all-N reads, Ns every few bases (the round-3 chase
  runs out of steps), reads that start before the text or cross the
  strand boundary (negative diagonals and diagonals at l_pac), reads
  across the repeats (occurrences >= 2, capped buckets, more distinct
  diagonals than dmax), W 150, 160, 161 and 320 (nmz 104 and dmax 40:
  more than 32 distinct diagonals a read), round 3 off;
- ``random_calls(seed)``: a random genome's table with random bucket
  words and entries (second row set, capped buckets, stray hits) and
  random reads at random caps.

``chip_smoke.py``'s kmer phase and the kmer kernel's tests use it.
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
from bioseqdb_tpu_torch.index import layout
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import build, kmer
from bioseqdb_tpu_torch.kernels import kmer_cuda as kcu
from bioseqdb_tpu_torch.tools import shapes
from bioseqdb_tpu_torch.tools.chain_calls import _clone
from bioseqdb_tpu_torch.utils.sim import simulate_genome, simulate_reads

OUTPUTS = kcu.OUTPUTS
_SIG = inspect.signature(kmer.collect_seeds_kmer)
MSL, SPLIT_LEN, SPLIT_W, MAX_INTV = 19, 28, 10, 20   # AlignOptions' defaults
# instructions the bound charges: a read position's k-mer roll, hash,
# minimizer run tests and round-1 / round-3 work (~30); a valid diagonal
# and position's text compare and top-2 merge (~8); a table entry's unpack
# and compare (~6)
POSITION_INSTR, REACH_INSTR, ENTRY_INSTR = 30, 8, 6


@dataclasses.dataclass
class KmerCall:
    """A ``collect_seeds_kmer`` call: ``args`` every parameter by name
    (defaults filled in)."""

    args: dict

    @classmethod
    def of(cls, *args, **kw) -> "KmerCall":
        bound = _SIG.bind(*args, **kw)
        bound.apply_defaults()
        return cls({k: _clone(v) for k, v in bound.arguments.items()})

    def replace(self, **changes) -> "KmerCall":
        return KmerCall(dict(self.args, **changes))

    def lanes(self, idx) -> "KmerCall":
        """The call on the reads ``idx`` only (index tensor or slice)."""
        return self.replace(codes=self.args["codes"][idx].contiguous(),
                            lens=self.args["lens"][idx].contiguous())

    def to(self, device) -> "KmerCall":
        return KmerCall({k: v.to(device) if isinstance(v, torch.Tensor)
                         else v for k, v in self.args.items()})

    @property
    def shape(self) -> str:
        a = self.args
        B, W = a["codes"].shape
        return (f"B {B}, W {W}, nmz {a['nmz']}, dmax {a['dmax']}, smax "
                f"{a['smax']}, M {a['max_mem']}, max_mem_intv "
                f"{a['max_mem_intv']}")

    def run(self, plain: bool = False) -> dict:
        fn = kmer.collect_seeds_kmer_plain if plain else kmer.collect_seeds_kmer
        return fn(**self.args)

    def host(self, lib: ctypes.CDLL) -> dict:
        """The call on the host build ``lib`` of csrc/kmer.cu (CPU
        tensors): the kernel's lane body, every read in turn."""
        a = dict(self.args)
        a["codes"] = a["codes"].to(torch.int32).contiguous()
        a["lens"] = a["lens"].to(torch.int32).contiguous()
        out, args, _ = kcu.kmer_seed_args(**a)
        rc = kcu.bind(lib, "kmer_seed_host", stream=False)(*args)
        if rc != 0:
            raise RuntimeError(f"kmer_seed_host refused its arguments ({rc})")
        return out

    def kernel_ms(self, calls: int = 20, reps: int = 5) -> float:
        """The kernel's device milliseconds a launch: CUDA events around a
        CUDA graph of ``calls`` launches, the median of ``reps`` replays
        (``shapes.graph_ms``), so the host's enqueue does not count."""
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

    def counts(self) -> dict:
        """What the call's bound needs, from the plain twin's first stages
        (``kmer.kmer_diagonals``) on its inputs: the bytes it must read
        (the codes and lens; a bucket word a valid minimizer; the entries
        of each uncapped bucket; the text words under each valid
        diagonal) and write (every output once), and the instructions
        (POSITION_INSTR a read position, REACH_INSTR a valid diagonal and
        position, ENTRY_INSTR a table entry)."""
        a = self.args
        B, W = a["codes"].shape
        i64 = torch.int64
        dg = kmer.kmer_diagonals(a["bmeta"], a["entries"],
                                 a["codes"].to(i64), a["lens"].to(torch.int32),
                                 a["bb"], a["smax"], a["dmax"], a["nmz"])
        mzok, diags, dvalid = dg["mzok"], dg["diags"].to(i64), dg["dvalid"]
        lo = diags.clamp(0, a["seq_len"])
        hi = (diags + W).clamp(0, a["seq_len"])
        words = torch.where(dvalid & (hi > lo),
                            ((hi - 1) >> 4) - (lo >> 4) + 1, 0)
        n = dict(lookups=int(mzok.sum()),
                 entries=int(torch.where(mzok & ~dg["capped"], dg["cnt"],
                                         0).sum()),
                 diags=int(dvalid.sum()), text_words=int(words.sum()))
        read = 4 * (B * W + B + n["lookups"] + n["entries"]
                    + n["text_words"])
        # every output: M-wide int32 seeds (four), n_mem and why, and the
        # two flags
        M = a["max_mem"]
        written = B * (4 * 4 * M + 4 + 4 + 2)
        instr = (POSITION_INSTR * B * W + REACH_INSTR * n["diags"] * W
                 + ENTRY_INSTR * n["entries"])
        return dict(n, read=read, written=written, instr=instr)


def max_abs_err(got: dict, want: dict) -> int:
    """The largest difference over the outputs (0: bit-equal; a
    mismatched shape or dtype counts as -1)."""
    err = 0
    for k in OUTPUTS:
        a, b = got[k], want[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            return -1
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


@contextlib.contextmanager
def recording(calls: list):
    """Record every ``collect_seeds_kmer`` call ``align/pipeline.py``
    makes in the block into ``calls``, then make it."""
    saved = pipeline.collect_seeds_kmer

    def rec(*args, **kw):
        calls.append(KmerCall.of(*args, **kw))
        return saved(*args, **kw)

    pipeline.collect_seeds_kmer = rec
    try:
        yield calls
    finally:
        pipeline.collect_seeds_kmer = saved


@contextlib.contextmanager
def plain_seeder():
    """Within the block, ``align/pipeline.py`` seeds with the plain twin
    ``collect_seeds_kmer_plain`` (the eager stages the port ran before
    the kernel) on any device."""
    saved = pipeline.collect_seeds_kmer
    pipeline.collect_seeds_kmer = kmer.collect_seeds_kmer_plain
    try:
        yield
    finally:
        pipeline.collect_seeds_kmer = saved


def host_library(out_dir) -> ctypes.CDLL:
    """csrc/kmer.cu built for the host with g++ (its host entry) in
    ``out_dir``, loaded; raises without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    so = Path(out_dir) / "libkmer_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-o", str(so), str(build.CSRC / build.SOURCES["kmer"])],
                   check=True)
    return ctypes.CDLL(str(so))


def _revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGTN", "TGCAN"))


def _mutate(s: str, rng, rate: float) -> str:
    return "".join("ACGT"[(("ACGT".index(c) + int(rng.integers(1, 4))) % 4)]
                   if rng.random() < rate else c for c in s)


def edge_genome() -> list[tuple[str, str]]:
    """Three references: ``a`` with a 600 bp repeat in three copies (one
    3% diverged) and a 24-base segment repeated once; ``b`` with a tandem
    repeat of a 7-base unit (capped buckets) and 14 copies of a 40-base
    unit (more distinct diagonals than dmax); ``c`` short."""
    rng = np.random.default_rng(51)
    core = simulate_genome(30_000, seed=51)
    core = core[:24_000] + core[9_000:9_024] + core[24_024:]
    rep = simulate_genome(600, seed=52)
    a = (core[:6_000] + rep + core[6_000:14_000] + _mutate(rep, rng, 0.03)
         + core[14_000:20_000] + rep + core[20_000:])
    b0 = simulate_genome(12_000, seed=53)
    unit7 = simulate_genome(7, seed=54)
    unit40 = simulate_genome(40, seed=55)
    b = b0[:4_000] + unit7 * 60 + b0[4_000:8_000] + unit40 * 14 + b0[8_000:]
    return [("a", a), ("b", b), ("c", simulate_genome(3_000, seed=56))]


def _edge_reads(refs) -> tuple[list[str], list[str]]:
    """(reads, kinds) on ``edge_genome``'s references."""
    rng = np.random.default_rng(57)
    a, b, c = (s for _, s in refs)
    text = a + b + c
    reads, kinds = [], []

    def add(kind, rs):
        reads.extend(rs)
        kinds.extend([kind] * len(rs))

    sim = simulate_reads(text, 24, read_len=150, sub_rate=0.02, seed=58)
    add("sim", sim.reads)
    add("sim_300", simulate_reads(text, 8, read_len=300, sub_rate=0.01,
                                  seed=59).reads)
    add("repeat", [a[6_000 - 50 + 90 * k: 6_000 + 250 + 90 * k]
                   for k in range(4)])
    seg = a.find(a[9_600:9_624], 20_000)   # the 24-base segment's copy
    add("short_repeat", [a[p - 62 - 4 * k: p + 88 - 4 * k]
                         for p in (9_600, seg) for k in range(2)])
    add("tandem7", [b[4_000 - 30 + 20 * k: 4_000 + 200 + 20 * k]
                    for k in range(3)])
    add("tandem40", [b[8_420 - 60 + 50 * k: 8_420 + 240 + 50 * k]
                     for k in range(3)])
    # a junk prefix then the text's first bases: negative diagonals
    add("text_start", ["".join("ACGT"[x] for x in rng.integers(0, 4, 20 + k))
                       + a[:180] for k in range(2)])
    # across the strand boundary: the forward text's last bases, then the
    # reverse strand's first
    add("strand", [c[-90 + 20 * k:] + _revcomp(c)[:120] for k in range(2)])
    add("ref_ends", [a[-100:] + b[:100], b[-80:] + c[:120]])
    add("all_n", ["N" * 150, "N" * 320])
    add("short", ["", a[100:110], a[200:218], a[300:319], a[400:425]])
    add("n_every_4", ["".join("N" if i % 4 == 3 else ch
                              for i, ch in enumerate(a[1_000:1_300]))])
    add("n_sparse", ["".join("N" if i in (40, 90, 91, 200) else ch
                             for i, ch in enumerate(b[1_000:1_280]))])
    add("random", ["".join("ACGT"[x] for x in rng.integers(0, 4, 150))
                   for _ in range(3)])
    # exact reads of 150 and 151 bp with the 24-base segment at read
    # position 50-52: the round-2 certificate's last repeat lands at, just
    # past and just before pivot - min_seed_len; at 75 its run of repeat
    # positions starts at the pivot itself
    add("certificate", [a[9_600 - s: 9_600 - s + n] for n in (150, 151)
                        for s in (50, 51, 52, 75)])
    # an N every 5 bases over the first 5m: the chase needs about m + 1
    # steps, around its budget of W // 20 + 18
    add("chase_budget", ["".join("N" if i % 5 == 4 and i < 5 * m else ch
                                 for i, ch in enumerate(a[2_000:2_150]))
                         for m in (24, 25, 26, 27)])
    return reads, kinds


def edge_setup():
    """(index, tables on the CPU (``layout.tables_from_host``), codes int32
    [B, 320], lens int32 [B], kinds) of the edge reads."""
    refs = edge_genome()
    idx = build_index(refs)
    reads, kinds = _edge_reads(refs)
    batch = pack_reads(reads, [f"e{i}" for i in range(len(reads))])
    codes = np.full((batch.codes.shape[0], kcu.MAX_WIDTH), 4, np.int32)
    codes[:, : batch.codes.shape[1]] = batch.codes
    lens = np.asarray(batch.lens, np.int32).copy()
    # two sim reads with lens cut below their bases: k-mers and the chase
    # stop at lens, the match reach does not
    lens[[1, 5]] = (97, 139)
    kinds[1] = kinds[5] = "lens_cut"
    kinds += ["padding"] * (len(lens) - len(kinds))   # pack_reads' rows
    tables = layout.to_device(layout.tables_from_host(idx), "cpu")
    return (idx, tables, torch.from_numpy(codes), torch.from_numpy(lens),
            kinds)


def call_on(tables: dict, seq_len: int, codes, lens, width: int = 320,
            **caps) -> KmerCall:
    """A call on ``tables`` at the pipeline's options for ``width``
    (``caps`` change them) on ``codes[:, :width]``."""
    meta = tables["kmer_meta"]
    nmz = caps.pop("nmz", layout.nmz_for(width))
    opts = dict(bb=meta.bb, min_seed_len=MSL, split_len=SPLIT_LEN,
                split_width=SPLIT_W, max_mem_intv=MAX_INTV,
                smax=layout.smax_for(MAX_INTV),
                dmax=layout.dmax_for(meta, nmz), nmz=nmz, max_mem=48)
    opts.update(caps)
    return KmerCall.of(tables["bmeta"], tables["entries"], tables["pac_rows"],
                       seq_len, codes[:, :width].contiguous(), lens, **opts)


# the edge calls: the pipeline's options at W 160 (the main path's width),
# W 150 and 161 (a warp's last chunk of positions part-full) and W 320
# (dmax and nmz at their caps: more distinct diagonals than a warp's
# lanes), round 3 off, and caps small enough to overflow the minimizer,
# diagonal and seed slots
EDGE_CAPS = {
    "W 160": dict(width=160, max_mem=16),
    "W 150": dict(width=150, max_mem=16),
    "W 161": dict(width=161, max_mem=16),
    "W 320, nmz 104, dmax 40": dict(width=320, nmz=104, dmax=40, max_mem=64),
    "round 3 off": dict(width=320, max_mem_intv=0, smax=14),
    "small caps": dict(width=320, nmz=40, dmax=8, max_mem=4, smax=6),
}


def edge_calls(device="cpu", setup=None) -> list[tuple[str, KmerCall]]:
    """(name, call) of each EDGE_CAPS entry on the edge reads, on
    ``device`` (``setup`` an ``edge_setup()`` to reuse)."""
    idx, tables, codes, lens, _ = setup or edge_setup()
    return [(name, call_on(tables, idx.seq_len, codes, lens,
                           **dict(caps)).to(device))
            for name, caps in EDGE_CAPS.items()]


def random_calls(seed: int, device="cpu", n_reads: int = 192
                 ) -> list[KmerCall]:
    """Calls at random caps on reads simulated from a random 20 kb genome
    (2% substitutions, some Ns, random lengths) and random reads: one on
    the genome's table with some bucket words replaced by random ones
    (random offsets, so the second row set and far rows; random counts,
    so capped buckets) and some entries by random words, one on a wholly
    random table of 2^24 buckets (4 low key bits: a hit in 16 entries, more
    distinct diagonals than dmax, two row sets that differ, entries past
    column 31 read as 0)."""
    rng = np.random.default_rng(seed)
    g = simulate_genome(20_000, seed=seed + 1000)
    idx = build_index([("r", g)])
    t = layout.tables_from_host(idx)
    bmeta, entries = t["bmeta"].copy(), t["entries"].copy()
    ne = t["kmer_meta"].n_entries
    hot = np.flatnonzero(bmeta & 15)
    pick = rng.choice(hot, len(hot) // 8, replace=False)
    bmeta[pick] = ((rng.integers(0, ne, len(pick)) << 4)
                   | rng.integers(0, 16, len(pick))).astype(np.int32)
    flat = entries.reshape(-1)
    where = rng.choice(flat.size, flat.size // 50, replace=False)
    flat[where] = rng.integers(-2 ** 31, 2 ** 31, where.size, dtype=np.int64
                               ).astype(np.int32)
    W = int(rng.choice([152, 160, 320]))
    sim = simulate_reads(g, n_reads, read_len=min(W, 150), sub_rate=0.02,
                         seed=seed + 2000)
    reads = []
    for r in sim.reads:
        r = r[: int(rng.integers(0, len(r) + 1))] if rng.random() < 0.2 else r
        r = list(r)
        for j in rng.integers(0, max(len(r), 1), int(rng.integers(0, 3))):
            if r:
                r[j] = "N"
        reads.append("".join(r))
    reads += ["".join("ACGT"[x] for x in rng.integers(0, 4, W))
              for _ in range(8)]
    batch = pack_reads(reads, [f"x{i}" for i in range(len(reads))])
    codes = np.full((batch.codes.shape[0], W), 4, np.int32)
    codes[:, : batch.codes.shape[1]] = batch.codes[:, :W]
    codes, lens = (torch.from_numpy(codes),
                   torch.from_numpy(np.asarray(batch.lens, np.int32)))
    bb, nrows0 = 24, 200
    low = 2 * layout.K - bb
    words = ((rng.integers(0, idx.seq_len, (2 * nrows0 + 1, 32)) << low)
             | rng.integers(0, 1 << low, (2 * nrows0 + 1, 32)))
    synthetic = dict(
        t, kmer_meta=t["kmer_meta"]._replace(bb=bb),
        bmeta=((rng.integers(0, 32 * nrows0, 1 << bb) << 4)
               | rng.integers(0, 16, 1 << bb)).astype(np.int32),
        entries=words.astype(np.uint32).view(np.int32))
    calls = []
    for tab, dmax in ((dict(t, bmeta=bmeta, entries=entries), [8, 16, 40]),
                      (synthetic, [8, 16])):
        caps = dict(width=W, nmz=int(rng.choice([24, 56, 104])),
                    dmax=int(rng.choice(dmax)),
                    smax=int(rng.integers(4, 15)),
                    max_mem=int(rng.choice([4, 16, 64])),
                    max_mem_intv=int(rng.choice([0, 20])))
        calls.append(call_on(layout.to_device(tab, "cpu"), idx.seq_len,
                             codes, lens, **caps).to(device))
    return calls
