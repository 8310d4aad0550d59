"""The FM seeding machine's kernel against its plain twin, at the shapes
the pipeline gives it.

- ``recording(calls)``: inside the block, every ``collect_seeds_device``
  call of ``align/pipeline.py`` is recorded (its tensors cloned) as a
  ``MachineCall`` and then made as usual;
- ``MachineCall``: one call's arguments; ``run`` makes it on the kernel
  (``collect_seeds_device``) or the plain twin (``collect_seeds_plain``),
  ``kernel_ms`` times the launch alone (CUDA events, fresh set-up state a
  launch), ``plain_ms`` the plain twin (and the table rows a kernel lane
  reads, for the bound); ``max_abs_err`` holds two runs' six outputs
  against each other;
- ``edge_case_reads`` / ``edge_case_codes`` / ``edge_case_setup``: a
  small genome with exact and diverged repeats, a batch of edge-case
  reads on it (simulated, repeat-spanning, ambiguous, junk, chimeric,
  short, empty, Ns in round-3 windows), packed, and its index;
  ``edge_call`` a machine call on it and ``edge_reseed_entry`` the kmer
  seeder's reseed entry for it;
- ``ragged_batch``: reads of every length from 0 to ``read_len`` on a
  genome, with Ns, junk, all-N and empty reads.

``chip_smoke.py``'s FM-machine phase and the seeding tests use it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect

import numpy as np
import torch

from bioseqdb_tpu_torch.align import pipeline
from bioseqdb_tpu_torch.index import layout
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import seed
from bioseqdb_tpu_torch.kernels.fm_seed_cuda import fm_seed_cuda
from bioseqdb_tpu_torch.kernels.kmer import collect_seeds_kmer
from bioseqdb_tpu_torch.utils.sim import simulate_genome, simulate_reads

FIELDS = ("mems", "n_mem", "overflow", "iters", "it_r1", "it_r2")
# the edge-case batch's options
MSL, SPLIT_LEN, SPLIT_W, MAX_INTV = 19, 28, 10, 20
EDGE_W = 152
_SIG = inspect.signature(seed.collect_seeds_device)


def _clone(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, dict):
        return {k: _clone(x) for k, x in v.items()}
    return v


@dataclasses.dataclass
class MachineCall:
    """A ``collect_seeds_device`` call: ``args`` every parameter by name
    (defaults filled in)."""

    args: dict

    @classmethod
    def of(cls, *args, **kw) -> "MachineCall":
        bound = _SIG.bind(*args, **kw)
        bound.apply_defaults()
        return cls({k: _clone(v) for k, v in bound.arguments.items()})

    def replace(self, **changes) -> "MachineCall":
        return MachineCall(dict(self.args, **changes))

    def lanes(self, idx) -> "MachineCall":
        """The call on the lanes ``idx`` only (index tensor or slice)."""
        a = dict(self.args, codes=self.args["codes"][idx],
                 lens=self.args["lens"][idx])
        if a["reseed_entry"] is not None:
            a["reseed_entry"] = {k: v[idx] for k, v in
                                 a["reseed_entry"].items()}
        return MachineCall(a)

    @property
    def shape(self) -> str:
        a = self.args
        B, W = a["codes"].shape
        J = a["jump"].depth if a["jump"] is not None else 0
        return (f"B {B}, W {W}, max_cand {a['max_cand']}, max_mem "
                f"{a['max_mem']}, max_iters {a['max_iters'] or 'default'}, "
                f"jump {J}, reseed entry {a['entry_reseed']}, ranks "
                f"{str(a['fm'].rank_dtype).removeprefix('torch.')}")

    def run(self, plain: bool = False) -> dict:
        fn = seed.collect_seeds_plain if plain else seed.collect_seeds_device
        return fn(**self.args)

    def kernel_ms(self, reps: int = 3) -> float:
        """The median over ``reps`` launches of the kernel alone (CUDA
        events), each on a fresh set-up state."""
        a = self.args
        times = []
        for _ in range(reps):
            st, J, kw = seed._prepare(**a)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            fm_seed_cuda(a["fm"], st, jump_table=a["jump"].table if J else None,
                         J=J, **kw)
            ev[1].record()
            torch.cuda.synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        return float(np.median(times))

    def plain_ms(self) -> tuple[float, dict, dict]:
        """The plain twin's milliseconds (CUDA events), outputs, and
        what a kernel lane reads: the distinct Occ, major and jump rows,
        and the steps that extend (``collect_seeds_plain``'s ``touched``,
        whose counting is timed with it: about ten ops a step of about
        200, with no host sync)."""
        touched = self.touched()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        out = seed.collect_seeds_plain(**self.args, touched=touched)
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]), out, counts(touched)

    def touched(self) -> dict:
        """An empty ``collect_seeds_plain`` ``touched`` for this call."""
        a = self.args
        fm, dev = a["fm"], a["codes"].device
        nb = lambda n: torch.zeros(n + 1, dtype=torch.bool, device=dev)
        return dict(occ=nb(fm.occ_rows.shape[0]),
                    major=nb(fm.occ_majors.shape[0]),
                    jump=nb(a["jump"].table.shape[0] if a["jump"] else 0),
                    steps=torch.zeros(1, dtype=torch.int64, device=dev))


def counts(touched: dict) -> dict:
    """The extending steps and the distinct rows of each table that a
    filled ``touched`` holds."""
    return dict(steps=int(touched["steps"]),
                **{k: int(v[:-1].sum()) for k, v in touched.items()
                   if k != "steps"})


def max_abs_err(got: dict, want: dict) -> int:
    """The largest difference over the six outputs (0: bit-equal; a
    mismatched shape or dtype counts as -1)."""
    err = 0
    for k in FIELDS:
        a, b = got[k], want[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            return -1
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


@contextlib.contextmanager
def recording(calls: list):
    """Record every ``collect_seeds_device`` call ``align/pipeline.py``
    makes in the block into ``calls``, then make it."""
    fn = pipeline.collect_seeds_device

    def rec(*args, **kw):
        calls.append(MachineCall.of(*args, **kw))
        return fn(*args, **kw)

    pipeline.collect_seeds_device = rec
    try:
        yield calls
    finally:
        pipeline.collect_seeds_device = fn


def _mutate(s: str, rng, rate: float) -> str:
    b = np.frombuffer(s.encode(), np.uint8).copy()
    m = rng.random(b.size) < rate
    b[m] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, m.sum())]
    return b.tobytes().decode()


def edge_case_reads() -> tuple[str, list[str], list[str]]:
    """(genome, reads, kinds): a 121 kb genome holding a 700 bp repeat
    (three copies, one diverged) and a 24-base repeat, and the edge-case
    reads on it; ``kinds`` names each read's kind."""
    rng = np.random.default_rng(31)
    core = simulate_genome(60_000, seed=31)
    # a 24-base segment repeated once: a round-2 reseed between the
    # round-3 checkpoints (the kmer seeder's needs_r2 lanes)
    core = core[:50000] + core[20000:20024] + core[50024:]
    rep = simulate_genome(700, seed=32)
    g = (core[:15000] + rep + core[15000:30000] + _mutate(rep, rng, 0.03)
         + core[30000:45000] + rep + core[45000:])
    sim = simulate_reads(g, 40, read_len=150, sub_rate=0.02, seed=33)
    reads = list(sim.reads)
    kinds = ["sim"] * len(reads)
    seg = g.find(core[20000:20024])
    for k in range(4):   # reads holding the short repeat mid-read
        p = g.find(core[20000:20024], seg + 1 if k % 2 else 0) - 62 - 4 * k
        reads.append(g[p : p + 150])
        kinds.append("short_repeat")
    for k in range(6):   # reads across the repeat copies
        p = 15000 - 40 + 250 * k
        reads.append(g[p : p + 150])
        kinds.append("repeat")
    for k in range(4):   # ambiguous bases
        r = list(reads[k])
        for j in rng.integers(0, 150, 3 + k):
            r[j] = "N"
        reads.append("".join(r))
        kinds.append("ambiguous")
    reads += ["".join("ACGT"[c] for c in rng.integers(0, 4, 150))
              for _ in range(3)]
    kinds += ["junk"] * 3
    reads += [g[5000:5075] + g[40000:40075], g[100:130], "ACGTN" * 30, ""]
    kinds += ["chimera", "short", "acgtn", "empty"]
    # Ns a few bases into round-3 windows: the depth-J jump must not
    # take a window that holds one
    r = list(sim.reads[5])
    for j in range(3, 150, 23):
        r[j] = "N"
    reads.append("".join(r))
    kinds.append("r3_window_n")
    return g, reads, kinds


def edge_case_codes(reads: list[str], width: int = EDGE_W
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(codes int32 [B, width], lens int32 [B]) of ``reads``, padded
    with code 4."""
    batch = pack_reads(reads, [f"r{i}" for i in range(len(reads))])
    codes = np.full((batch.codes.shape[0], width), 4, np.int32)
    n = min(width, batch.codes.shape[1])
    codes[:, :n] = batch.codes[:, :n]
    return codes, np.asarray(batch.lens, np.int32)


def edge_case_setup(width: int = EDGE_W):
    """(index, codes int32 [B, width], lens int32 [B], kinds) of
    ``edge_case_reads``."""
    g, reads, kinds = edge_case_reads()
    codes, lens = edge_case_codes(reads, width)
    return (build_index([("g", g)]), torch.from_numpy(codes),
            torch.from_numpy(lens), kinds)


def edge_call(fm, codes, lens, **kw) -> MachineCall:
    """A machine call on the edge-case batch with its options."""
    opts = dict(min_seed_len=MSL, split_len=SPLIT_LEN, split_width=SPLIT_W,
                max_mem_intv=MAX_INTV, max_cand=16, max_mem=16)
    return MachineCall.of(fm, codes, lens, **dict(opts, **kw))


def edge_reseed_entry(idx, codes: torch.Tensor, lens: torch.Tensor
                      ) -> dict:
    """The reseed entry of the edge-case batch, on ``codes``' device:
    the kmer seeder's round-1 mems, with its ``needs_r2`` lanes and every
    seventh lane active (more lanes through round 2 than the
    certificate)."""
    t = layout.to_device(layout.tables_from_host(idx), codes.device)
    meta = t["kmer_meta"]
    W = codes.shape[1]
    nmz = layout.nmz_for(W)
    ko = collect_seeds_kmer(
        t["bmeta"], t["entries"], t["pac_rows"], idx.seq_len, codes, lens,
        bb=meta.bb, min_seed_len=MSL, split_len=SPLIT_LEN,
        split_width=SPLIT_W, max_mem_intv=MAX_INTV,
        smax=layout.smax_for(MAX_INTV), dmax=layout.dmax_for(meta, nmz),
        nmz=nmz, max_mem=16)
    active = ko["needs_r2"].clone()
    active[::7] = True
    return dict(active=active, **{k: ko[k] for k in
                                  ("mem_s", "mem_b", "mem_e", "n_mem")})


def ragged_batch(genome: str, n: int, seed_: int, read_len: int = 150):
    """(codes int32 [n, W], lens int32 [n]): reads of uniform random
    lengths in [0, read_len] from ``genome`` at 1% substitutions; of
    them, a tenth carry 1-8 Ns, a twentieth are junk, and a few are all
    N or empty."""
    rng = np.random.default_rng(seed_)
    sim = simulate_reads(genome, n, read_len=read_len, sub_rate=0.01,
                         seed=seed_)
    reads = []
    for k, r in enumerate(sim.reads):
        r = r[: int(rng.integers(0, read_len + 1))]
        u = rng.random()
        if u < 0.1 and r:
            r = list(r)
            for j in rng.integers(0, len(r), int(rng.integers(1, 9))):
                r[j] = "N"
            r = "".join(r)
        elif u < 0.15:
            r = "".join("ACGT"[c] for c in rng.integers(0, 4, len(r)))
        elif u < 0.16:
            r = "N" * len(r)
        elif u < 0.17:
            r = ""
        reads.append(r)
    batch = pack_reads(reads, [f"g{i}" for i in range(n)])
    return (torch.from_numpy(np.asarray(batch.codes, np.int32)),
            torch.from_numpy(np.asarray(batch.lens, np.int32)))
