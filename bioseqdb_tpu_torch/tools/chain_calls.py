"""Chaining's kernels against their plain twins, at the shapes the
pipeline gives them.

- ``recording(calls)``: inside the block, every ``chain_seeds`` and
  ``filter_chains`` call of ``align/pipeline.py`` is recorded (its
  tensors cloned) as a ``ChainCall`` and then made as usual; ``pairs``
  pairs each ``chain_seeds`` call with the ``filter_chains`` call after it;
- ``ChainCall``: one call's kind and arguments; ``run`` makes it on the
  kernel (``chain.chain_seeds`` / ``chain.filter_chains``) or the plain
  twin, ``kernel_ms`` times a launch in a CUDA graph, ``plain_ms`` the
  plain twin, ``counts`` gives what the bound needs (bytes read and
  written, seed trips, live-chain scans, chain pairs);
  ``lanes`` takes some reads of the call;
- ``edge_seeds(rank_dtype)``: a hand-made seed set, made with numpy from
  a seed (reads that overflow the chain slots, contained seeds, a strand
  crossing at l_pac, equal chain positions and weights, all-invalid and
  one-seed reads, a drop chain ranked before a lighter sig chain whose
  slot comes first, positions past 2^31 with int64 ranks, and random
  reads of seed clusters); ``edge_calls`` the pair of calls on it;
- ``filter_calls(rank_dtype, C)``: a ``filter_chains`` call on hand-made
  chains at C chains (``FILTER_CASES`` and random reads; S 131, three
  passes of the kernel's 64 slots).

``chip_smoke.py``'s chain phase and the chaining tests use it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import types

import numpy as np
import torch

from bioseqdb_tpu_torch.align import pipeline
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.kernels import chain, chain_cuda
from bioseqdb_tpu_torch.tools import shapes

CHAIN_OUT = chain_cuda.CHAIN_FIELDS + ("n", "assign", "overflow")
FILTER_OUT = ("weight", "kept", "order", "beg", "end")
OUTPUTS = dict(chain_seeds=CHAIN_OUT, filter_chains=FILTER_OUT)
_FNS = dict(chain_seeds=(chain.chain_seeds, chain.chain_seeds_plain),
            filter_chains=(chain.filter_chains, chain.filter_chains_plain))
_SIG = {k: inspect.signature(v[0]) for k, v in _FNS.items()}
_OPT = AlignOptions()
# the pipeline's chaining options (AlignOptions' defaults)
CHAIN_OPTS = dict(bandwidth=_OPT.bandwidth, max_chain_gap=_OPT.max_chain_gap)
FILTER_OPTS = dict(mask_level=_OPT.mask_level,
                   chain_drop_ratio=_OPT.chain_drop_ratio,
                   min_chain_weight=_OPT.min_chain_weight,
                   min_seed_len=_OPT.min_seed_len,
                   max_chain_gap=_OPT.max_chain_gap)
PAST_2_31 = 3 << 30   # the int64 edge set's positions start here


def _clone(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, dict):
        return {k: _clone(x) for k, x in v.items()}
    return v


@dataclasses.dataclass
class ChainCall:
    """A ``chain_seeds`` or ``filter_chains`` call: ``kind`` its name,
    ``args`` every parameter by name."""

    kind: str
    args: dict

    @classmethod
    def of(cls, kind: str, *args, **kw) -> "ChainCall":
        bound = _SIG[kind].bind(*args, **kw)
        return cls(kind, {k: _clone(v) for k, v in bound.arguments.items()})

    def lanes(self, idx) -> "ChainCall":
        """The call on the reads ``idx`` only (index tensor or slice)."""
        a = dict(self.args)
        for k in ("seeds", "chains"):
            if k in a:
                a[k] = {n: v[idx] for n, v in a[k].items()}
        return ChainCall(self.kind, a)

    @property
    def seeds(self) -> dict:
        return self.args["seeds"]

    @property
    def dims(self) -> tuple[int, int, int]:
        """(B, S, C)."""
        B, S = self.seeds["rbeg"].shape
        C = (self.args["max_chains"] if self.kind == "chain_seeds"
             else self.args["chains"]["pos"].shape[1])
        return B, S, C

    @property
    def shape(self) -> str:
        B, S, C = self.dims
        rdt = str(self.seeds["rbeg"].dtype).removeprefix("torch.")
        return f"B {B}, S {S}, C {C}, ranks {rdt}"

    def run(self, plain: bool = False) -> dict:
        return _FNS[self.kind][plain](**self.args)

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

    def counts(self, out: dict) -> dict:
        """What the call's bound needs, from its outputs ``out``: the
        bytes it must read and write (each output once; each input once
        where the function needs it: for ``chain_seeds`` the valid mask
        of every slot and the seed fields of the valid slots, for
        ``filter_chains`` every assign and n, the seed fields of the
        assigned slots and the pos of each read's n live chains); for
        ``chain_seeds`` the valid seeds (``trips``), the live chains each
        valid seed's closest-chain test scans (``scans``) and the slots;
        for ``filter_chains`` the assigned seeds (``trips``), the pairs of
        live chains the shadow loop compares (``pairs``, a(a - 1) / 2 for
        a read's a live chains) and the chain slots."""
        s = self.seeds
        B, S, C = self.dims
        size = lambda t: t.element_size()
        nbytes = lambda ts: sum(t.numel() * size(t) for t in ts)
        seed_bytes = size(s["rbeg"]) + size(s["qbeg"]) + size(s["len"])
        written = nbytes(out[k] for k in OUTPUTS[self.kind])
        if self.kind == "chain_seeds":
            valid = s["valid"]
            trips = int(valid.sum())
            read = nbytes([valid]) + trips * (seed_bytes + size(s["rid"]))
            assign = out["assign"].long()
            # a seed opened a chain where its slot first appears in the row
            first = torch.full((B, C + 1), S, dtype=torch.long,
                               device=assign.device)
            at = torch.where(assign >= 0, assign, C)
            spos = torch.arange(S, device=assign.device).expand(B, S)
            first.scatter_reduce_(1, at, spos, "amin")
            opened = (assign >= 0) & (first.gather(1, at) == spos)
            live = torch.cumsum(opened.long(), 1) - opened.long()
            return dict(read=read, written=written, trips=trips,
                        scans=int(live[valid].sum()), slots=B * S)
        c = self.args["chains"]
        trips = int((c["assign"] >= 0).sum())
        read = (nbytes([c["assign"], c["n"]]) + trips * seed_bytes
                + int(c["n"].sum()) * size(c["pos"]))
        a = (out["weight"] >= 0).sum(1).long()
        return dict(read=read, written=written, trips=trips,
                    pairs=int((a * (a - 1) // 2).sum()), slots=B * C)


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


def pairs(calls: list) -> list[tuple[ChainCall, ChainCall]]:
    """The recorded calls as (chain_seeds, filter_chains) pairs, in the
    order they were made."""
    kinds = [c.kind for c in calls]
    if kinds != ["chain_seeds", "filter_chains"] * (len(calls) // 2):
        raise AssertionError(f"unpaired chain calls: {kinds}")
    return list(zip(calls[::2], calls[1::2]))


@contextlib.contextmanager
def recording(calls: list):
    """Record every ``chain_seeds`` and ``filter_chains`` call
    ``align/pipeline.py`` makes in the block into ``calls``, then make
    it."""
    saved = {k: getattr(pipeline, k) for k in _FNS}

    def recorder(kind):
        def rec(*args, **kw):
            calls.append(ChainCall.of(kind, *args, **kw))
            return saved[kind](*args, **kw)
        return rec

    for k in _FNS:
        setattr(pipeline, k, recorder(k))
    try:
        yield calls
    finally:
        for k, fn in saved.items():
            setattr(pipeline, k, fn)


def _rows(rng, l_pac: int, base: int, S: int) -> tuple[list, list]:
    """The edge set's reads: (kinds, seed lists of (rbeg, qbeg, len, rid)
    or None for an invalid slot)."""
    P = base + 5_000_000
    rows = {
        # S new chains far apart in shuffled order: more than C overflow
        "overflow": [(base + int(k) * 100_000, (7 * j) % 120, 20, 0)
                     for j, k in enumerate(rng.permutation(S))],
        # contained in query and reference (-2), a grow, contained again,
        # and one contained in the query only
        "contained": [(P, 0, 60, 0), (P + 10, 10, 20, 0),
                      (P + 70, 70, 30, 0), (P + 75, 75, 10, 0),
                      (P + 5_000, 20, 10, 0)],
        # colinear seeds across l_pac: the forward-strand chain cannot
        # take the reverse-strand seed; the reverse chain then grows
        "strand": [(l_pac - 60, 0, 30, 0), (l_pac, 60, 30, 0),
                   (l_pac + 40, 100, 30, 0), (l_pac - 61, 1, 20, 0)],
        # two chains at the same position; the next seed takes the first
        # slot among equals; an equal-weight pair at another position
        "equal_pos": [(P, 0, 30, 0), (P, 150, 30, 0), (P + 60, 60, 20, 0),
                      (P + 1_000, 200, 30, 0), (P - 900, 250, 30, 1)],
        # equal weights: pos decides the order, then the slot
        "equal_weight": [(P + 1_000, 0, 40, 0), (P, 50, 40, 0),
                         (P + 2_000, 100, 40, 0), (P + 2_000, 150, 40, 1)],
        "invalid": [None] * S,
        "one_seed": [None] * 5 + [(P, 17, 33, 0)],
        # the drop chain K1 (weight 100, slot 1) ranks before the sig
        # chain K2 (weight 50, slot 0); the short chain overlaps both and
        # is dropped by K1 alone: K2 must not take it as a shadow, and
        # K1 promotes it
        "drop_after_sig": [(P, 92, 50, 0), (P + 500_000, 0, 100, 0),
                           (P + 1_000_000, 85, 20, 0)],
        # the same with K2 overlapping K1: K2 is kept overlapped (2)
        "drop_after_sig_overlap": [(P, 20, 50, 0), (P + 500_000, 0, 100, 0),
                                   (P + 1_000_000, 40, 20, 0)],
    }
    kinds, seeds = list(rows), list(rows.values())
    for k in range(48):   # random reads of seed clusters
        kinds.append("random")
        seeds.append(_random_read(rng, l_pac, base, S, k))
    return kinds, seeds


def _random_read(rng, l_pac: int, base: int, S: int, k: int) -> list:
    """A read's seeds: clusters along diagonals (indels, rid 0/1, some at
    l_pac), noise seeds and invalid slots, sorted by query start in
    most reads."""
    out = []
    for _ in range(int(rng.integers(1, 6))):
        diag = (l_pac - 80 if rng.random() < 0.15
                else base + int(rng.integers(0, 30_000_000)))
        rid = int(rng.integers(0, 2))
        q = int(rng.integers(0, 40))
        for _ in range(int(rng.integers(1, 9))):
            ln = int(rng.integers(15, 45))
            jit = int(rng.choice([0, 0, 0, -3, 4, 150]))
            out.append((diag + q + jit, q, ln, rid))
            q += int(rng.integers(-10, ln + 30))
            q = max(q, 0)
    for _ in range(int(rng.integers(0, 6))):
        out.append((base + int(rng.integers(0, 30_000_000)),
                    int(rng.integers(0, 150)), int(rng.integers(15, 60)),
                    int(rng.integers(0, 2))))
    if k % 4:
        out.sort(key=lambda t: t[1])
    else:
        rng.shuffle(out)
    out = out[:S]
    for j in rng.integers(0, len(out) + 1, int(rng.integers(0, 4))):
        out.insert(int(j), None)
    return out[:S]


def edge_seeds(rank_dtype: torch.dtype = torch.int32, S: int = 64,
               seed: int = 11) -> tuple[int, dict, list[str]]:
    """(l_pac, seeds, kinds): the hand-made seed set on the CPU (rbeg in
    ``rank_dtype``; qbeg, len, rid int32; valid and overflow bool, all
    [B, S]; invalid slots hold random values), ``kinds`` naming each
    read. With int64 ranks every position lies past 2^31."""
    rng = np.random.default_rng(seed)
    base = PAST_2_31 if rank_dtype == torch.int64 else 1 << 20
    l_pac = base + 40_000_000
    kinds, rows = _rows(rng, l_pac, base, S)
    return l_pac, _tables(rng, rows, base, l_pac, S, rank_dtype), kinds


def _tables(rng, rows: list, base: int, l_pac: int, S: int,
            rank_dtype: torch.dtype) -> dict:
    """The seed tables of ``rows`` (a read's list of (rbeg, qbeg, len,
    rid) or None), their invalid slots random."""
    B = len(rows)
    rbeg = rng.integers(base, 2 * l_pac, (B, S), dtype=np.int64)
    qbeg = rng.integers(-5, 200, (B, S)).astype(np.int32)
    ln = rng.integers(-5, 60, (B, S)).astype(np.int32)
    rid = rng.integers(-1, 3, (B, S)).astype(np.int32)
    valid = np.zeros((B, S), bool)
    for b, row in enumerate(rows):
        for s, t in enumerate(row[:S]):
            if t is not None:
                rbeg[b, s], qbeg[b, s], ln[b, s], rid[b, s] = t
                valid[b, s] = True
    return dict(rbeg=torch.from_numpy(rbeg).to(rank_dtype),
                qbeg=torch.from_numpy(qbeg), len=torch.from_numpy(ln),
                rid=torch.from_numpy(rid), valid=torch.from_numpy(valid),
                overflow=torch.zeros(B, dtype=torch.bool))


# group_calls' cases: the chain table's spread over a group's lanes
GROUP_CASES = ("overflow at C", "contained on a later lane",
               "equal pos across lanes", "strand crossing on a later lane",
               "pos below NEG", "only chain below NEG")


def _group_rows(l_pac: int, base: int, C: int) -> dict:
    """{case: a read's seeds}: each read first opens C // 2 + 1 chains far
    apart (so the chains the case is about sit on later lanes of the
    group at every chains-a-lane), then the case."""
    far = [(base + 10_000_000 + 100_000 * j, 0, 20, 0)
           for j in range(C // 2 + 1)]
    P = base + 5_000_000
    Q = base + 20_000_000
    return {
        # C + 3 chains: the last three are refused (overflow, -1)
        "overflow at C": far + [(Q + 100_000 * j, 3 * j % 120, 20, 0)
                                for j in range(C + 3 - len(far))],
        # a chain, seeds contained in it (-2), a grow, contained again
        "contained on a later lane": far + [
            (P, 0, 60, 0), (P + 10, 10, 20, 0), (P + 70, 70, 30, 0),
            (P + 75, 75, 10, 0)],
        # chains at one position in far-apart slots (and, at two chains
        # a lane and more, in one lane's two): a seed takes the first
        "equal pos across lanes": far[:2] + [(P, 0, 30, 0)] + far[2:] + [
            (P, 150, 30, 0), (P, 151, 30, 0), (P + 60, 60, 20, 0)],
        # colinear seeds across l_pac after the far chains
        "strand crossing on a later lane": far + [
            (l_pac - 60, 0, 30, 0), (l_pac, 60, 30, 0),
            (l_pac + 40, 100, 30, 0), (l_pac - 61, 1, 20, 0)],
        # a chain whose pos lies below NEG: the search's best is below
        # NEG, so a seed past it opens a new chain
        "pos below NEG": far + [(-(1 << 30) - 500, 0, 30, 0),
                                (-(1 << 30) - 400, 100, 30, 0),
                                (P, 40, 30, 0)],
        # the same with no other chain: every candidate lies below NEG
        "only chain below NEG": [(-(1 << 30) - 500, 0, 30, 0),
                                 (-(1 << 30) - 400, 100, 30, 0),
                                 (P, 40, 30, 0)],
    }


def group_calls(rank_dtype: torch.dtype = torch.int32, C: int = 16,
                device="cpu") -> dict[str, ChainCall]:
    """{case (GROUP_CASES): a chain_seeds call of one read} at C chains,
    S 2 * C + 1 (one slot past a multiple of a group's 8); with int64 ranks
    every position lies past 2^31, but pos below NEG's negative ones."""
    rng = np.random.default_rng(C)
    base = PAST_2_31 if rank_dtype == torch.int64 else 1 << 20
    l_pac = base + 40_000_000
    S = 2 * C + 1
    fm = types.SimpleNamespace(l_pac=l_pac)
    out = {}
    for kind, row in _group_rows(l_pac, base, C).items():
        seeds = _tables(rng, [row], base, l_pac, S, rank_dtype)
        out[kind] = ChainCall("chain_seeds", dict(
            fm=fm, seeds={k: v.to(device) for k, v in seeds.items()},
            max_chains=C, **CHAIN_OPTS))
    return out


def edge_calls(rank_dtype: torch.dtype = torch.int32, S: int = 64,
               C: int = 16, device="cpu", seed: int = 11,
               **filter_opts) -> tuple[ChainCall, ChainCall, list[str]]:
    """(the chain_seeds call, the filter_chains call on its plain
    outputs, kinds) on ``edge_seeds``, on ``device``; ``filter_opts``
    change FILTER_OPTS."""
    l_pac, seeds, kinds = edge_seeds(rank_dtype, S, seed)
    seeds = {k: v.to(device) for k, v in seeds.items()}
    fm = types.SimpleNamespace(l_pac=l_pac)
    cs = ChainCall("chain_seeds", dict(fm=fm, seeds=seeds, max_chains=C,
                                       **CHAIN_OPTS))
    chains = cs.run(plain=True)
    fc = ChainCall("filter_chains", dict(chains=chains, seeds=seeds,
                                         **dict(FILTER_OPTS, **filter_opts)))
    return cs, fc, kinds


# filter_calls' hand-made reads; each read lists (chain, qbeg, len, rbeg
# offset) seeds in slot order and its chains' pos offsets
FILTER_CASES = ("n 0", "n C", "equal weight and pos", "ci past C - 1",
                "two promotions", "drop at the first kept chain")


def _filter_rows(C: int) -> dict:
    """{case: (n, seeds, pos)}: n the read's chains, seeds its (chain,
    qbeg, len, rbeg offset) in slot order, pos each chain's position
    offset (the chains from n on get junk)."""
    heavy = lambda c, q: [(c, q, 30, 1_000 * c + q),
                          (c, q + 30, 30, 1_000 * c + q + 30),
                          (c, q + 60, 30, 1_000 * c + q + 60)]
    n_c = []   # C chains: every fourth heavy (90), the others 20-40
    for c in range(C):
        q = (37 * c) % 150
        n_c += (heavy(c, q) if c % 4 == 0
                else [(c, q, 20 + 5 * (c % 5), 1_000 * c + q)])
    return {
        # seeds assigned to chains of a read with none: all dead
        "n 0": (0, [(0, 0, 30, 0), (1, 40, 30, 900), (0, 70, 30, 70)],
                [0, 900]),
        "n C": (C, n_c, [1_000 * c for c in range(C)]),
        # three chains at one pos with one weight (40), a fourth at a
        # higher pos with the same weight: the slot decides, then pos
        "equal weight and pos": (4, [(0, 0, 40, 0), (1, 50, 40, 50),
                                     (2, 100, 40, 100),
                                     (3, 150, 40, 5_000)],
                                 [0, 0, 0, 5_000]),
        # assign past C - 1 folds into chain C - 1
        "ci past C - 1": (C, [(C - 1, 0, 30, 0), (C, 20, 30, 20),
                              (C + 7, 60, 30, 60), (C - 2, 10, 25, 9_000)],
                          [9_000] * (C - 1) + [0]),
        # A (slot 2, 100) drops B (slot 0, 30) and D (slot 3, 80) drops
        # E (slot 1, 30): both kept chains promote a shadow in a slot
        # before their own
        "two promotions": (4, [(2, 0, 50, 0), (0, 10, 30, 10),
                               (2, 50, 50, 50), (3, 200, 40, 70_000),
                               (1, 210, 30, 70_010), (3, 240, 40, 70_040)],
                           [10, 70_010, 0, 70_000]),
        # the best (slot 0, 100) drops X (slot 2, 30) as the first kept
        # chain; Y (slot 1, 60) overlaps it undropped: kept 2
        "drop at the first kept chain": (
            3, [(0, 0, 50, 0), (1, 20, 60, 40_000), (2, 30, 30, 80_000),
                (0, 50, 50, 50)], [0, 40_000, 80_000]),
    }


def filter_calls(rank_dtype: torch.dtype = torch.int32, C: int = 16,
                 device="cpu", S: int = 131, seed: int = 13
                 ) -> tuple[ChainCall, list[str]]:
    """(a filter_chains call, kinds): the hand-made reads of
    FILTER_CASES at C chains, then random ones (n 0 to C, assign -2 to
    C + 1, overlapping query spans, equal pos), their seeds spread over
    S slots; with int64 ranks every position past 2^31."""
    rng = np.random.default_rng(seed + C)
    base = PAST_2_31 if rank_dtype == torch.int64 else 1 << 20
    rows = list(_filter_rows(C).values())
    kinds = list(FILTER_CASES)
    for _ in range(40):
        n = int(rng.integers(0, C + 1))
        k = int(rng.integers(0, min(S, 4 * C) + 1))
        seeds = [(int(rng.integers(-2, C + 2)), int(rng.integers(0, 300)),
                  int(rng.integers(15, 60)), int(rng.integers(0, 4_000)))
                 for _ in range(k)]
        pos = [int(rng.choice([0, 100, int(rng.integers(0, 4_000))]))
               for _ in range(C)]
        rows.append((n, seeds, pos))
        kinds.append("random")
    B = len(rows)
    assign = rng.integers(-2, 0, (B, S)).astype(np.int32)
    qbeg = rng.integers(-5, 200, (B, S)).astype(np.int32)
    ln = rng.integers(-5, 60, (B, S)).astype(np.int32)
    rbeg = rng.integers(base, base + 50_000_000, (B, S), dtype=np.int64)
    pos = rng.integers(base, base + 50_000_000, (B, C), dtype=np.int64)
    n = np.zeros(B, np.int32)
    for b, (nb, seeds, pb) in enumerate(rows):
        n[b] = nb
        slots = np.sort(rng.choice(S, len(seeds), replace=False))
        for s, (c, q, l_, r) in zip(slots, seeds):
            assign[b, s], qbeg[b, s], ln[b, s] = c, q, l_
            rbeg[b, s] = base + r
        pos[b, :nb] = base + np.asarray(pb[:nb], np.int64)
    t = lambda x, dt: torch.from_numpy(x).to(dt).to(device)
    chains = dict(n=t(n, torch.int32), assign=t(assign, torch.int32),
                  pos=t(pos, rank_dtype))
    seeds = dict(rbeg=t(rbeg, rank_dtype), qbeg=t(qbeg, torch.int32),
                 len=t(ln, torch.int32))
    return ChainCall("filter_chains", dict(chains=chains, seeds=seeds,
                                           **FILTER_OPTS)), kinds
