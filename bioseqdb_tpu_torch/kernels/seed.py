"""Batched SMEM seeding: the FM-index state machine.

The port of ``bioseqdb_tpu/kernels/seed.py`` ``collect_seeds_device``:
each read is a lane running the three seeding rounds of bwa's
mem_collect_intv (pivot / forward pass / backward pass / re-seed /
LAST-like pass); every step performs one FMD extension. The JAX
``while_loop``, compiled into one TPU program, has two counterparts:
- on the card, one launch of the hand-written kernel ``csrc/fm_seed.cu``
  (``kernels/fm_seed_cuda.py``): a quad of threads a read, each lane run
  from its first step to its end;
- the plain machine (``collect_seeds_plain``; the CPU path and the tests
  run it, and the kernel is held against it): eager torch ops, one
  batched step at a time, a Python loop that checks for live lanes
  every ``CHUNK`` steps and runs each chunk on the live lanes only.
Lanes are independent and a finished lane's step changes nothing, so
both give the same result. ``collect_seeds_device`` picks the kernel on
CUDA tensors and the plain machine on CPU tensors. On a sharded index
(``group``) every step's occ query is an owner sum, an ``all_reduce``
that no launch can hold: on CUDA tensors each step is then two launches
of ``csrc/fm_shard.cu`` (``kernels/fm_shard_cuda.py``) with the
``all_reduce`` between them, in the plain machine's own host loop
(``collect_seeds_sharded``); on CPU tensors the plain machine.

Dropped from the TPU version, with unchanged results: multi-candidate
columns (``kcand > 1``), quad rows and the fetch sharing itself. The
per-lane step budget ``max_iters`` still counts the extra step that
fetch sharing spends on a lane whose two rank positions fall in
different 1024-base octo rows, and the round-3 prefix jump (``R3Jump``)
takes one step as on the TPU, so ``iters`` and the overflow mask equal
the JAX machine's, with the jump or without it. On a sharded index the
JAX machine runs without fetch sharing or the jump, and so does the
port there (``group``).

The round-3 jump: a round-3 pivot whose depth-J window is clean and
inside the read starts its forward scan at depth J, its bi-interval read
from a table of every length-J pattern, in one step instead of J - 1
(``PH_R3J``). The TPU version appends that table to the Occ rows so the
step's one gather reaches it; here it is a tensor of its own.

Rank-valued state (the bi-interval, the candidate stacks, ``min_intv``
and the mems) holds the index's rank dtype, as the JAX machine's ``rdt``
state does; positions, counts and phases stay int32.

Returns the JAX layout: mems [B, M, 5] (k, l = 0, s, start, end) in the
rank dtype, n_mem, overflow, iters, it_r1, it_r2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from bioseqdb_tpu_torch.index.fmindex import MAJOR_BLOCKS, OCC_BLOCK
from bioseqdb_tpu_torch.index.layout import OCT_BLOCKS
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels import fm_shard_cuda as fsc
from bioseqdb_tpu_torch.kernels.fm_seed_cuda import fm_seed_cuda
from bioseqdb_tpu_torch.kernels.rows import pick_row, put_row

PH_PIVOT = 0   # choose the next pivot / round transition
PH_FWD = 1     # forward pass of smem1
PH_BWD = 2     # backward pass of smem1
PH_R3 = 3      # bwt_seed_strategy1 forward scan
PH_DONE = 4
PH_R3J = 5     # round-3 jump: the depth-J prefix interval from the table

RD_SMEM = 0    # round 1: SMEMs
RD_RESEED = 1  # round 2: re-seed long low-occ SMEMs
RD_LAST = 2    # round 3: LAST-like seeds

CHUNK = 32     # plain machine: steps between live-lane checks

JUMP_DEPTH = 8  # r3 jump table depth (4^J keys)
# The JAX package sizes its jump table by the TPU's gather tiers: the
# depth rules below are copied from it verbatim so that the port's
# machine picks the same depth, and so takes the same steps and
# overflows the same lanes, for a given index; they mean nothing for the
# card.
_FAST_TIER_BYTES = int(20 * (1 << 20))


class R3Jump(NamedTuple):
    """The round-3 jump table: ``table`` [4^depth, 3] (rank dtype) holds
    the bi-interval (k, l, s) of every length-``depth`` pattern, keyed by
    sum_t code[t] << 2t."""

    table: torch.Tensor
    depth: int


def jump_depth(n_block_rows: int, depth: int | None = None,
               rank_dtype: torch.dtype = torch.int32) -> int:
    """The jump depth the JAX package's ``build_r3_jump`` takes for an
    Occ table of ``n_block_rows`` blocks (its octo rows x 8): the largest
    depth whose table extension stays under the TPU's fast gather tier
    (any depth once the table is past it), or ``depth`` when given; 0
    (no jump) when the ranks are int32 and the extended table's would
    leave int32. Under int64 ranks the jump is always taken."""
    base = -(-n_block_rows // MAJOR_BLOCKS) * MAJOR_BLOCKS
    if depth is None:
        if n_block_rows * 48 >= _FAST_TIER_BYTES:
            depth = JUMP_DEPTH
        else:
            depth = next((d for d in (JUMP_DEPTH, 6)
                          if (base + 2 * (4 ** d)) * 48 <= _FAST_TIER_BYTES),
                         0)
    if (depth and rank_dtype == torch.int32
            and (base + 2 * 4 ** depth) * OCC_BLOCK + 2 >= 2**31):
        return 0
    return depth


def build_r3_jump(fm: kfm.FMDevice, depth: int | None = None
                  ) -> R3Jump | None:
    """The jump table of ``fm`` at ``jump_depth``'s depth (``depth``
    forces one); None when the depth is 0. Built a depth at a time: the
    4^t patterns of length t, each extended forward by all four codes at
    once, are the 4^(t+1) of length t + 1 (the code at t lands in key bits
    2t and 2t + 1)."""
    J = jump_depth(fm.blocks.shape[0] * OCT_BLOCKS, depth, fm.rank_dtype)
    if J == 0:
        return None
    c0 = torch.arange(4, device=fm.L2.device)
    k = fm.L2[c0] + 1
    l = fm.L2[3 - c0] + 1
    s = fm.L2[c0 + 1] - fm.L2[c0]
    for _ in range(1, J):
        # (4^t, 4) by (key, code) -> code-major: index code * 4^t + key
        k, l, s = (v.t().reshape(-1) for v in kfm.fmd_extend_fwd(fm, k, l, s))
    return R3Jump(torch.stack([k, l, s], 1).to(fm.rank_dtype).contiguous(),
                  J)


def _jump_keys(codes: torch.Tensor, J: int) -> torch.Tensor:
    """int32[B, W]: the jump key of the depth-J window at each column
    (sum_t codes[p + t] << 2t), or -1 when the window holds a code >= 4
    or runs past W."""
    B, W = codes.shape
    cpad = torch.nn.functional.pad(codes, (0, J), value=4)
    key = torch.zeros(B, W, dtype=torch.int64, device=codes.device)
    clean = torch.ones(B, W, dtype=torch.bool, device=codes.device)
    for t in range(J):
        c = cpad[:, t : t + W]
        clean &= c < 4
        key |= (c & 3) << (2 * t)
    return torch.where(clean, key, -1).to(torch.int32)


def _mark(seen: torch.Tensor, rows: torch.Tensor, keep: torch.Tensor
          ) -> None:
    """seen[rows[keep]] = True, with no host sync: the other lanes
    write the spare last row."""
    seen[torch.where(keep, rows, seen.shape[0] - 1)] = True


def _touch(fm: kfm.FMDevice, touched: dict, blk: torch.Tensor,
           fetch: torch.Tensor) -> None:
    """Count the lanes ``fetch`` that extend, and mark the Occ and major
    rows of their blocks (``blk``: both ranks of every lane; clamped as
    ``kfm.occ_rows_for`` clamps them) in ``touched``."""
    touched["steps"] += fetch.sum()
    blk, f2 = blk.long(), torch.cat([fetch, fetch])
    octo = (blk >> 3).clamp(0, fm.blocks.shape[0] - 1)
    _mark(touched["occ"], octo * 8 + (blk & 7), f2)
    _mark(touched["major"], (blk >> kfm.LOG2_MAJOR).clamp(
        0, fm.occ_majors.shape[0] - 1), f2)


def collect_seeds_device(
    fm: kfm.FMDevice,
    codes: torch.Tensor,   # int[B, W] 0..3 bases, >= 4 ambiguous/padding
    lens: torch.Tensor,    # int32[B]
    min_seed_len: int,
    split_len: int,
    split_width: int,
    max_mem_intv: int,
    max_cand: int = 24,
    max_mem: int = 48,
    max_iters: int = 0,
    entry_reseed: bool = False,
    reseed_entry: dict | None = None,
    jump: R3Jump | None = None,
    group=None,
) -> dict:
    """All three seeding rounds for a batch of reads (or, with
    ``entry_reseed``, round 2 alone from preloaded round-1/3 mems:
    ``reseed_entry`` holds mem_s/mem_b/mem_e/n_mem and the ``active``
    lanes). ``max_iters`` 0 means the default per-lane budget. ``jump``
    turns the round-3 jump on where it is exact: stepwise round 3 cannot
    stop before depth ``min_seed_len``, so only for J <= min_seed_len
    (and W > J).

    On CUDA tensors the machine is one launch of the hand-written kernel
    (``csrc/fm_seed.cu`` through ``fm_seed_cuda``: a quad of threads a
    read, each run from its first step to its end), which raises rather than fall
    back; on CPU tensors it is the plain machine
    (``collect_seeds_plain``), bit-equal to the kernel.

    With ``group`` (a sharded index, ``dist/shard_index.py``) the step's
    occ query is an owner sum over the group, and the machine is the JAX
    machine without fetch sharing: no split-row stall steps, the budget
    10 * W + 256, no jump. Every step's owner sum is an ``all_reduce``
    that no single launch can hold: on CUDA tensors each step is two
    launches of ``csrc/fm_shard.cu`` around it (``collect_seeds_sharded``),
    which raise rather than fall back; on CPU tensors the plain machine.
    Every rank of the group holds the same reads, so the live-lane
    compaction picks the same lanes on each."""
    if codes.device.type == "cuda" and group is not None:
        return collect_seeds_sharded(
            fm, codes, lens, min_seed_len, split_len, split_width,
            max_mem_intv, max_cand, max_mem, max_iters, entry_reseed,
            reseed_entry, group)
    kernel = codes.device.type == "cuda"
    return _collect(kernel, fm, codes, lens, min_seed_len, split_len,
                    split_width, max_mem_intv, max_cand, max_mem, max_iters,
                    entry_reseed, reseed_entry, jump, group)


def collect_seeds_sharded(
    fm: kfm.FMDevice, codes: torch.Tensor, lens: torch.Tensor,
    min_seed_len: int, split_len: int, split_width: int, max_mem_intv: int,
    max_cand: int = 24, max_mem: int = 48, max_iters: int = 0,
    entry_reseed: bool = False, reseed_entry: dict | None = None,
    group=None, entries: dict | None = None,
) -> dict:
    """``collect_seeds_device`` under an index group on the kernels of
    ``csrc/fm_shard.cu``: the plain machine's host loop (``_machine_loop``:
    the live lanes compacted every CHUNK steps), each step a query launch
    (the budget, the pivot and this rank's occ partials at a and a + s),
    the ``all_reduce`` of the plain machine's owner-sum buffer over
    ``group`` and an apply launch (the extension and the rest of the
    step). ``entries``: ``fm_shard_cuda.card_entries()`` (the default, on
    CUDA tensors) or ``host_entries(lib)``, a host build's, on CPU
    tensors. Bit-equal to ``collect_seeds_plain(..., group=group)``, with
    the same ``all_reduce`` calls and bytes."""
    if group is None:
        raise ValueError("collect_seeds_sharded: needs the index group")
    st, kw = _sharded_setup(fm, codes, lens, min_seed_len, split_len,
                            split_width, max_mem_intv, max_cand, max_mem,
                            max_iters, entry_reseed, reseed_entry, group)
    entries = entries or fsc.card_entries()
    shard = dist.get_rank(group)
    dev = codes.device
    chunk = {}    # a chunk's lanes: the kernels update them in place

    def step(sub):
        if chunk.get("sub") is not sub:
            buf, args = _chunk_args(fm, sub, shard, kw)
            chunk.update(sub=sub, B=sub["phase"].shape[0], buf=buf,
                         args=args)
        fsc.owner_sum_step(entries, "fm_shard", chunk["args"], chunk["B"],
                           dev, lambda: kfm._all_reduce(chunk["buf"], group))
        return sub

    return _result(_machine_loop(st, step))


def _sharded_setup(
    fm: kfm.FMDevice, codes: torch.Tensor, lens: torch.Tensor,
    min_seed_len: int, split_len: int, split_width: int, max_mem_intv: int,
    max_cand: int = 24, max_mem: int = 48, max_iters: int = 0,
    entry_reseed: bool = False, reseed_entry: dict | None = None,
    group=None,
) -> tuple[dict, dict]:
    """``collect_seeds_sharded``'s set-up: (the machine's state of every
    lane, ``fm_shard_cuda.machine_args``' keyword arguments)."""
    st, _, kw = _prepare(fm, codes, lens, min_seed_len, split_len,
                         split_width, max_mem_intv, max_cand, max_mem,
                         max_iters, entry_reseed, reseed_entry, None, group)
    return _machine_state(fm, st, max_cand), kw


def _chunk_args(fm: kfm.FMDevice, sub: dict, shard: int, kw: dict):
    """A chunk's owner-sum buffer (int32 [1, 2B, 4], the plain machine's)
    and the kernels' packed argument array for its lanes ``sub`` on rank
    ``shard``."""
    B = sub["phase"].shape[0]
    buf = torch.empty((1, 2 * B, 4), dtype=torch.int32,
                      device=sub["phase"].device)
    return buf, fsc.pack(fsc.machine_args(fm, sub, buf, shard, **kw))


def collect_seeds_plain(
    fm: kfm.FMDevice, codes: torch.Tensor, lens: torch.Tensor,
    min_seed_len: int, split_len: int, split_width: int, max_mem_intv: int,
    max_cand: int = 24, max_mem: int = 48, max_iters: int = 0,
    entry_reseed: bool = False, reseed_entry: dict | None = None,
    jump: R3Jump | None = None, group=None, touched: dict | None = None,
) -> dict:
    """``collect_seeds_device``'s plain twin, on any device: the machine
    as eager torch ops, one batched step at a time over the live lanes.
    The CPU path and the tests run it; on the card it is what the kernel
    is held against.

    ``touched`` (unsharded only; for a bound on the kernel's work): bool
    tensors ``occ``, ``major`` and ``jump``, each one row longer than
    its table (occ_rows, occ_majors, the jump table), in which the run
    sets the rows a kernel lane reads (the Occ and major rows of each
    step that extends, the jump row of each jump step; the spare last
    row is written and means nothing), and int64 ``steps`` [1], to which
    it adds the steps that extend (and, if it holds one, int64 ``bwd``
    [1]: the backward-pass steps among them)."""
    if touched is not None and group is not None:
        raise ValueError("touched: an unsharded machine only")
    return _collect(False, fm, codes, lens, min_seed_len, split_len,
                    split_width, max_mem_intv, max_cand, max_mem, max_iters,
                    entry_reseed, reseed_entry, jump, group, touched)


def _collect(kernel, fm, codes, lens, min_seed_len, split_len, split_width,
             max_mem_intv, max_cand, max_mem, max_iters, entry_reseed,
             reseed_entry, jump, group, touched=None) -> dict:
    st, J, kw = _prepare(fm, codes, lens, min_seed_len, split_len,
                         split_width, max_mem_intv, max_cand, max_mem,
                         max_iters, entry_reseed, reseed_entry, jump, group)
    if kernel:
        fm_seed_cuda(fm, st, jump_table=jump.table if J else None, J=J, **kw)
    else:
        st = _plain_machine(fm, st, J=J, jump=jump, group=group,
                            touched=touched, **kw)
    return _result(st)


def _result(st: dict) -> dict:
    """A finished machine state's outputs, in the JAX layout."""
    mems5 = torch.stack([st["mem_k"], torch.zeros_like(st["mem_k"]),
                         st["mem_s"], st["mem_b"], st["mem_e"]], 2)
    return dict(mems=mems5, n_mem=st["n_mem"], overflow=st["overflow"],
                iters=st["iters"], it_r1=st["it_r1"], it_r2=st["it_r2"])


def _prepare(fm, codes, lens, min_seed_len, split_len, split_width,
             max_mem_intv, max_cand, max_mem, max_iters, entry_reseed,
             reseed_entry, jump, group) -> tuple[dict, int, dict]:
    """(the set-up state, the jump depth the machine takes, both
    machines' keyword arguments) of a ``collect_seeds_device`` call. The
    state holds each lane's starting phase, round and mem count (with
    ``entry_reseed``, the preloaded mems), the codes (int32) and the
    outputs (mem_k/s/b/e, n_mem, iters, it_r1, it_r2, overflow), which
    the kernel writes in place."""
    B, W = codes.shape
    share = group is None       # the JAX machine shares fetches unsharded
    if max_iters <= 0:
        # the JAX machine's default under fetch sharing (its split-row
        # stalls are counted), and without it
        max_iters = (40 * W + 1024) // 3 if share else 10 * W + 256
    J = jump.depth if jump is not None and share else 0
    if not (J > 0 and min_seed_len >= J and W > J):
        J = 0
    M = max_mem
    dev = codes.device
    i32 = torch.int32
    rdt = fm.rank_dtype
    z = lambda *s: torch.zeros(*s, dtype=i32, device=dev)
    zr = lambda *s: torch.zeros(*s, dtype=rdt, device=dev)
    st = dict(
        phase=torch.where(lens > 0, PH_PIVOT, PH_DONE).to(i32),
        round=z(B),
        mem_k=zr(B, M), mem_s=zr(B, M), mem_b=zr(B, M), mem_e=zr(B, M),
        n_mem=z(B), n_mem_r1=z(B),
        iters=z(B), it_r1=z(B), it_r2=z(B),
        overflow=torch.zeros(B, dtype=torch.bool, device=dev),
        codes=codes.to(i32), lens=lens.to(i32),
    )
    if entry_reseed:
        pre = reseed_entry
        M0 = pre["mem_s"].shape[1]
        # copies: the kernel writes the mems and n_mem in place
        ld = lambda a: torch.nn.functional.pad(a.to(rdt, copy=True),
                                               (0, M - M0))
        st["mem_s"] = ld(pre["mem_s"])
        st["mem_b"] = ld(pre["mem_b"])
        st["mem_e"] = ld(pre["mem_e"])
        st["n_mem"] = pre["n_mem"].to(i32, copy=True)
        st["n_mem_r1"] = pre["n_mem"].to(i32)
        st["round"] = torch.full((B,), RD_RESEED, dtype=i32, device=dev)
        st["phase"] = torch.where(pre["active"] & (lens > 0),
                                  PH_PIVOT, PH_DONE).to(i32)
    return st, J, dict(min_seed_len=min_seed_len, split_len=split_len,
                       split_width=split_width, max_mem_intv=max_mem_intv,
                       max_cand=max_cand, max_iters=max_iters)


def _plain_machine(fm: kfm.FMDevice, st: dict, *, J: int,
                   jump: R3Jump | None, group, touched: dict | None,
                   min_seed_len: int, split_len: int, split_width: int,
                   max_mem_intv: int, max_cand: int, max_iters: int) -> dict:
    """The machine as eager torch ops from ``_prepare``'s state: a batched
    step over the live lanes, CHUNK steps between live-lane checks.
    Returns the final state."""
    B, W = st["codes"].shape
    P, M = max_cand, st["mem_k"].shape[1]
    i32 = torch.int32
    rdt = fm.rank_dtype
    share = group is None
    use_jump = J > 0
    primary = fm.primary
    L2 = fm.L2

    st = _machine_state(fm, st, P)
    st["codes"] = st["codes"].to(torch.int64)
    if use_jump:
        st["jkey"] = _jump_keys(st["codes"], J)
        st["jkey_pend"] = torch.zeros_like(st["x"])  # latched at the pivot

    def qat(s, pos):
        """Code at per-lane column ``pos`` (clamped): 0..3 base, >= 4
        ambiguous."""
        p = pos.long().clamp(0, W - 1)
        return torch.gather(s["codes"], 1, p[:, None])[:, 0]

    def set_intv(c):
        c = c.clamp(0, 3)
        k = L2[c] + 1
        l = L2[3 - c] + 1
        s = L2[c + 1] - L2[c]
        return torch.stack([k, l, s], -1).to(rdt)

    def push_row(buf, n, row, do):
        cap = buf.shape[1]
        ovf = do & (n >= cap)
        write = do & ~ovf
        buf = put_row(buf, torch.clamp(n, max=cap - 1), row, write)
        return buf, n + write.to(i32), ovf

    w_ = lambda c, a, b: torch.where(c, a, b)

    def pivot_step(st):
        st = dict(st)
        phase, rnd, L, x = st["phase"], st["round"], st["lens"], st["x"]
        qx = qat(st, x)
        at_pivot = phase == PH_PIVOT
        to_r2 = at_pivot & (rnd == RD_SMEM) & (x >= L)
        rnd = w_(to_r2, RD_RESEED, rnd)
        st["n_mem_r1"] = w_(to_r2, st["n_mem"], st["n_mem_r1"])
        r2i = w_(to_r2, 0, st["r2i"])
        st["it_r1"] = w_(to_r2, st["iters"], st["it_r1"])

        at_r2 = at_pivot & (rnd == RD_RESEED)
        r2ix = r2i.clamp(0, M - 1)
        r2_s = pick_row(st["mem_s"], r2ix)
        r2_b = pick_row(st["mem_b"], r2ix)
        r2_e = pick_row(st["mem_e"], r2ix)
        r2_eligible = ((r2_e - r2_b) >= split_len) & (r2_s <= split_width)
        r2_exhausted = at_r2 & (r2i >= st["n_mem_r1"])
        r2_skip = at_r2 & ~r2_exhausted & ~r2_eligible
        r2_go = at_r2 & ~r2_exhausted & r2_eligible
        r2i = w_(r2_skip, r2i + 1, r2i)

        to_r3 = r2_exhausted
        rnd = w_(to_r3, RD_LAST, rnd).to(i32)
        st["round"] = rnd
        x = w_(to_r3, 0, x)
        st["it_r2"] = w_(to_r3, st["iters"], st["it_r2"])
        at_r3p = at_pivot & (rnd == RD_LAST)
        r3_off = at_r3p & ((max_mem_intv <= 0) | (x >= L))
        st["phase"] = w_(r3_off, PH_DONE, st["phase"])

        p1 = at_pivot & (rnd == RD_SMEM) & (x < L)
        x = w_(p1 & (qx >= 4), x + 1, x)
        go1 = p1 & (qx < 4)
        go2 = r2_go
        x = w_(go2, (r2_b + r2_e) >> 1, x)
        st["min_intv"] = w_(go2, r2_s + 1, w_(go1, 1, st["min_intv"]))
        go = go1 | go2
        qpiv = qat(st, x)
        piv_amb2 = go2 & (qpiv >= 4)   # re-seed pivot on an N: skip it
        r2i = w_(piv_amb2, r2i + 1, r2i)
        go = go & ~piv_amb2
        st["ik"] = w_(go[:, None], set_intv(qpiv), st["ik"])
        st["ik_end"] = w_(go, x + 1, st["ik_end"])
        st["i"] = w_(go, x + 1, st["i"])
        st["n_cand"] = w_(go, 0, st["n_cand"])
        st["phase"] = w_(go, PH_FWD, st["phase"])

        p3 = at_r3p & ~r3_off & (max_mem_intv > 0)
        q3 = qat(st, x)
        amb3 = p3 & (q3 >= 4)
        x = w_(amb3, x + 1, x)
        go3 = p3 & ~amb3
        if use_jump:
            # start at depth J from the table when the window is clean
            # and inside the read
            jk3 = torch.gather(st["jkey"], 1, x.long().clamp(0, W - 1)[:, None]
                               )[:, 0]
            jump3 = go3 & (jk3 >= 0) & (x + J <= L)
            go3 = go3 & ~jump3
            st["phase"] = w_(jump3, PH_R3J, st["phase"])
            st["jkey_pend"] = w_(jump3, jk3.clamp(min=0), st["jkey_pend"])
        st["ik"] = w_(go3[:, None], set_intv(q3), st["ik"])
        st["i"] = w_(go3, x + 1, st["i"])
        st["phase"] = w_(go3, PH_R3, st["phase"]).to(i32)
        st["x"] = x.to(i32)
        st["r2i"] = r2i.to(i32)
        return st

    def body(st):
        dtypes = {k: v.dtype for k, v in st.items()}
        st = dict(st)
        over_budget = (st["phase"] != PH_DONE) & (st["iters"] >= max_iters)
        st["overflow"] = st["overflow"] | over_budget
        st["phase"] = w_(over_budget, PH_DONE, st["phase"])
        st["iters"] = st["iters"] + (st["phase"] != PH_DONE).to(i32)

        st = pivot_step(st)

        phase = st["phase"]
        L = st["lens"]
        x, i, j = st["x"], st["i"], st["j"]
        qi = qat(st, i)
        in_fwd = phase == PH_FWD
        in_bwd = phase == PH_BWD
        in_r3 = phase == PH_R3
        nB = phase.shape[0]

        j_eff = w_(st["rev1"], st["n_prev"] - 1 - j, j)
        bwd_iv = pick_row(st["prev"], j_eff.clamp(0, P - 1))     # (B, 3)
        src_k = w_(in_bwd, bwd_iv[:, 0], st["ik"][:, 0])
        src_s = w_(in_bwd, bwd_iv[:, 1], st["ik"][:, 2])
        src_l = w_(in_bwd, 0, st["ik"][:, 1])
        a = w_(in_bwd, src_k, src_l)
        b = w_(in_bwd, src_l, src_k)
        s_eff = src_s.clamp(min=0)

        # the JAX machine fetches one octo row per lane and stalls one
        # step when the pair (a, a + s) spans two rows: count that step
        qok = qi < 4
        posB = a + s_eff
        if share:
            consume = ((in_fwd & (i < L) & qok) | (in_bwd & (i >= 0) & qok)
                       | (in_r3 & (i < L) & qok))
            jA = a - (a > primary).to(rdt)
            jB = posB - (posB > primary).to(rdt)
            split = consume & ((jA >> 10) != (jB >> 10))
            over2 = split & (st["iters"] >= max_iters)
            st["overflow"] = st["overflow"] | over2
            st["phase"] = w_(over2, PH_DONE, st["phase"])
            st["iters"] = st["iters"] + (split & ~over2).to(i32)
            in_fwd = in_fwd & ~over2
            in_bwd = in_bwd & ~over2
            in_r3 = in_r3 & ~over2

        rows = kfm.occ_rows_for(fm, torch.cat([a, posB]), group)
        occ = kfm.occ4_from_row(fm, *rows, group=group)
        if touched is not None:
            _touch(fm, touched, rows[1], consume & ~over2)
            if "bwd" in touched:
                touched["bwd"] += (consume & in_bwd).sum()
        k4, l4, s4 = kfm.fmd_extend_from_occ(fm, a, b, s_eff, occ[:nB],
                                             occ[nB:])
        c_sel = w_(in_bwd, qi, 3 - qi).clamp(0, 3)[:, None]
        pk = lambda t: torch.gather(t, 1, c_sel)[:, 0]
        ok_k = pk(w_(in_bwd[:, None], k4, l4))
        ok_l = pk(w_(in_bwd[:, None], l4, k4))
        ok_s = pk(s4)

        new = dict(st)
        # ---- PH_R3J: one step, then the forward scan at depth J ----
        if use_jump:
            in_r3j = phase == PH_R3J
            if touched is not None:
                _mark(touched["jump"], st["jkey_pend"].long(), in_r3j)
            new["ik"] = w_(in_r3j[:, None],
                           jump.table[st["jkey_pend"].long()], new["ik"])
            new["i"] = w_(in_r3j, x + J, new["i"])
            new["phase"] = w_(in_r3j, PH_R3, new["phase"])
        # ---- PH_FWD ----
        fwd_end = in_fwd & (i >= L)
        fwd_amb = in_fwd & (i < L) & (qi >= 4)
        fwd_ext = in_fwd & (i < L) & qok
        ik_row = torch.stack([st["ik"][:, 0], st["ik"][:, 2], st["ik_end"]], 1)
        size_change = fwd_ext & (ok_s != st["ik"][:, 2])
        push_fwd = fwd_end | fwd_amb | size_change
        new["cand"], new["n_cand"], ovf1 = push_row(
            new["cand"], new["n_cand"], ik_row, push_fwd)
        new["overflow"] = st["overflow"] | ovf1
        drop_below = size_change & (ok_s < st["min_intv"])
        adv = fwd_ext & ~drop_below
        new["ik"] = w_(adv[:, None], torch.stack([ok_k, ok_l, ok_s], 1),
                       new["ik"])
        new["ik_end"] = w_(adv, i + 1, new["ik_end"])
        new["i"] = w_(adv, i + 1, new["i"])
        fwd_done = fwd_end | fwd_amb | drop_below
        new["prev"] = w_(fwd_done[:, None, None], new["cand"], st["prev"])
        new["n_prev"] = w_(fwd_done, new["n_cand"], st["n_prev"])
        new["rev1"] = w_(fwd_done, True, st["rev1"])
        lastc = (new["n_cand"] - 1).clamp(0, P - 1)
        new["ret"] = w_(fwd_done, pick_row(new["cand"][:, :, 2], lastc),
                        st["ret"])
        new["i"] = w_(fwd_done, x - 1, new["i"])
        new["j"] = w_(fwd_done, 0, st["j"])
        new["n_curr"] = w_(fwd_done, 0, st["n_curr"])
        new["last_start"] = w_(fwd_done, W + 1, st["last_start"])
        new["phase"] = w_(fwd_done, PH_BWD, new["phase"])

        # ---- PH_BWD (one candidate per step) ----
        bw_i = i
        c_ok = in_bwd & (bw_i >= 0) & qok
        n_curr_r = st["n_curr"]
        last_s_r = pick_row(st["curr"][:, :, 1],
                            (n_curr_r - 1).clamp(0, P - 1))
        fail = in_bwd & (~c_ok | (c_ok & (ok_s < st["min_intv"])))
        emit = fail & (n_curr_r == 0) & (bw_i + 1 < st["last_start"])
        emit = emit & ((bwd_iv[:, 2] - (bw_i + 1)) >= min_seed_len)
        last_start_r = w_(emit, bw_i + 1, st["last_start"])
        keep = in_bwd & c_ok & (ok_s >= st["min_intv"])
        push_t = keep & ((n_curr_r == 0) | (ok_s != last_s_r))
        ovf_bwd = push_t & (n_curr_r >= P)
        wr_c = push_t & (n_curr_r < P)
        curr_row = torch.stack([ok_k, ok_s, bwd_iv[:, 2]], 1)
        curr_buf = put_row(st["curr"], n_curr_r.clamp(max=P - 1), curr_row,
                           wr_c)
        n_curr_r = n_curr_r + wr_c.to(i32)

        # ---- PH_R3 (its emit shares the mems push) ----
        r3_end = in_r3 & (i >= L)
        r3_amb = in_r3 & (i < L) & (qi >= 4)
        r3_ext = in_r3 & (i < L) & qok
        hit = r3_ext & (ok_s < max_mem_intv) & ((i - x) >= min_seed_len)
        emit3 = hit & (ok_s > 0)
        push_any = emit | emit3
        pv = [w_(emit, bwd_iv[:, 0], ok_k), w_(emit, bwd_iv[:, 1], ok_s),
              w_(emit, bw_i + 1, x), w_(emit, bwd_iv[:, 2], i + 1)]
        nmm = new["n_mem"]
        ovf2 = push_any & (nmm >= M)
        wr = push_any & ~ovf2
        slot = nmm.clamp(max=M - 1)
        for name, v in zip(("mem_k", "mem_s", "mem_b", "mem_e"), pv):
            new[name] = put_row(new[name], slot, v, wr)
        new["n_mem"] = nmm + wr.to(i32)
        new["overflow"] = new["overflow"] | ovf2 | ovf_bwd
        new["last_start"] = w_(in_bwd, last_start_r, new["last_start"])
        new["curr"] = w_(in_bwd[:, None, None], curr_buf, new["curr"])
        new["n_curr"] = w_(in_bwd, n_curr_r, new["n_curr"])
        nj = j + 1
        dead = in_bwd & ((bw_i < 0) | (qi >= 4))
        row_done = in_bwd & ((nj >= st["n_prev"]) | dead)
        new["j"] = w_(in_bwd, w_(row_done, 0, nj), new["j"])
        bwd_finished = row_done & (new["n_curr"] == 0)
        cont2 = row_done & ~bwd_finished
        new["prev"] = w_(cont2[:, None, None], new["curr"], new["prev"])
        new["n_prev"] = w_(cont2, new["n_curr"], new["n_prev"])
        new["rev1"] = w_(cont2, False, new["rev1"])
        new["n_curr"] = w_(cont2, 0, new["n_curr"])
        new["i"] = w_(cont2, bw_i - 1, new["i"])
        new["phase"] = w_(bwd_finished, PH_PIVOT, new["phase"])
        rnd = st["round"]
        new["x"] = w_(bwd_finished & (rnd == RD_SMEM), st["ret"], new["x"])
        new["r2i"] = w_(bwd_finished & (rnd == RD_RESEED), st["r2i"] + 1,
                        new["r2i"])

        r3_stop = r3_end | r3_amb | hit
        new["x"] = w_(r3_stop & in_r3, w_(r3_end, L, i + 1), new["x"])
        new["phase"] = w_(r3_stop, PH_PIVOT, new["phase"])
        keep3 = r3_ext & ~hit
        new["ik"] = w_(keep3[:, None], torch.stack([ok_k, ok_l, ok_s], 1),
                       new["ik"])
        new["i"] = w_(keep3, i + 1, new["i"])
        return {k: (v.to(dtypes[k]) if v.dtype != dtypes[k] else v)
                for k, v in new.items()}

    return _machine_loop(st, body)


def _machine_state(fm: kfm.FMDevice, st: dict, P: int) -> dict:
    """``_prepare``'s state with the machine's working state added: the
    bi-interval, the candidate stacks of ``P`` rows and the pass
    state."""
    B, W = st["codes"].shape
    dev = st["codes"].device
    i32 = torch.int32
    rdt = fm.rank_dtype
    z = lambda *s: torch.zeros(*s, dtype=i32, device=dev)
    zr = lambda *s: torch.zeros(*s, dtype=rdt, device=dev)
    return dict(
        st, x=z(B), i=z(B),
        ik=zr(B, 3),                     # current bi-interval (k, l, s)
        ik_end=z(B),
        cand=zr(B, P, 3), n_cand=z(B),   # candidates (k, s, end)
        prev=zr(B, P, 3), n_prev=z(B),
        curr=zr(B, P, 3), n_curr=z(B),
        j=z(B), ret=z(B),
        rev1=torch.zeros(B, dtype=torch.bool, device=dev),
        min_intv=torch.ones(B, dtype=rdt, device=dev),
        r2i=z(B),
        last_start=torch.full((B,), W + 1, dtype=i32, device=dev),
    )


def _machine_loop(st: dict, step) -> dict:
    """Run the machine's steps to the end: the live lanes (by one
    ``nonzero``) every CHUNK steps, their state gathered, ``step`` (sub
    state -> sub state) taken CHUNK times, the state scattered back.
    Every rank of an index group holds the same reads and gets the same
    sums, so the compaction picks the same lanes on each. Returns the
    final state."""
    st = {k: v.clone() for k, v in st.items()}  # updated in place below
    while True:
        live, sub = _live(st)
        if live.numel() == 0:
            break
        for _ in range(CHUNK):
            sub = step(sub)
        for k, v in sub.items():
            st[k][live] = v
    return st


def _live(st: dict) -> tuple[torch.Tensor, dict]:
    """The lanes of ``st`` that are not done (one ``nonzero``) and their
    state gathered: a chunk of ``_machine_loop``."""
    live = torch.nonzero(st["phase"] != PH_DONE)[:, 0]
    return live, {k: v[live] for k, v in st.items()}
