"""Seed extension (bwa mem_chain2aln) on torch tensors.

The port of ``bioseqdb_tpu/kernels/extend.py`` ``extend_all``: seeds are
visited in the reference order (kept chains by descending weight, seeds
by descending score, ties to the later seed; the score is the seed-SW
filter's where it ran, else length x match); each is skipped when an
accumulated region covers it (with the overlap-rescue test) or extended
left and right by the banded SW, with bwa's band-doubling retry. The
per-read sequential loop becomes global rounds: every lane scans to its
next seed to extend, then one batched SW call a side serves all active
lanes.

The set-up and a round's four stages around the SW launches are each a
function with a plain twin (eager torch ops) here and a hand-written
CUDA kernel in ``csrc/extend.cu`` (``extend_cuda.py``):
- ``extend_setup``: the seeds' processing order (chains by the filter's
  order, seeds by score), the usable count and each chain's reference
  window (rmax), clipped at the strand boundary and the reference of its
  first seed;
- ``extend_scan``: the containment scan (every trip of every lane), the
  round's overflow and active lanes, and the SW sort keys of both sides;
- ``extend_windows``: both sides' query and target buffers, written in
  the SW lanes' sorted order (``perm``, a library argsort of the keys);
- ``extend_merge``: after the left SW, the left result and the right
  side's h0; after the right SW, the new region row, ``n_regs``,
  ``was_ext`` and the cursor; each reads the sorted SW results through
  the inverse permutation;
- ``extend_seedcov``: after the rounds, each region's seedcov.
On CUDA tensors each stage launches its kernel (and raises if it cannot);
on CPU tensors it runs the plain twin. The SW is ``sw_cuda.py``'s kernel
on the card and the plain ``sw.sw_extend_batch`` on the CPU.

The JAX program branches on the device (``lax.cond``) where a round has
no active lane and where a side has no retry. On the card the port keeps
both branches there and never waits on the card in a call: every round
runs its launches, and each launch takes a gate, a count on the card
(the scan's active reads of the round; a side's retries, a sum), at
which 0 the kernel skips its work (``extend_cuda.py``; a gated right
merge writes the state in place, so a skipped round leaves it as it
was). Issued one by one, a dead round would still cost the host its ~30
launches, so the call runs as a CUDA graph: captured at the first call
of its shapes and options (on a side stream; nothing runs then) and
replayed after, its inputs copied into the graph's own tensors and its
outputs copied out, so each call gets tensors of its own
(``GRAPH_CACHE`` graphs are kept, the least recently used dropped
first; calls on one stream). A replay adds the launches its capture
counted to ``build.LAUNCHES``. On the CPU, where reading a value costs
nothing, the host tests both branches; all orders give the same result.
``_ROUTE`` (None: the device and the group decide) forces one order for
tools that time one against another or record the stages' calls
(``tools/extend_calls.py`` ``route``).

Reference coordinates (the chains' windows, the regions' ``rb`` and
``re``) hold the seeds' rank dtype, int64 past 2^31 doubled bases, as
in the JAX version; the SW kernel still takes int32 codes, fetched from
the packed text by 64-bit positions.

Under a sharded index (``group``, ``dist/shard_index.py``) the targets
come from this rank's range of the per-base forward codes instead,
summed to their owner over the group (``fetch_doubled``), as in the JAX
version; a round's two windows share one owner sum, over the round's
lanes alone (one ``nonzero`` of the scan's active reads, the round's one
host read, which also serves its guard). No single launch holds that
sum, so on CUDA tensors ``extend_windows`` runs
``extend_windows_sharded``: a query launch (``windows_shard_query``:
this rank's codes at the windows' positions, 0 where it does not own
them), the ``all_reduce`` over the group, and ``extend_windows``' kernel
reading its targets from the sum; set-up, scan, merge and seedcov launch
their kernels as everywhere. Every rank must enter a round's window
fetch together, so there the host tests the branches, as on the CPU,
and nothing is captured: the ranks hold the same reads, so they take the
same branches.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.distributed as dist

from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels import extend_cuda as ecu
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels.extend_cuda import REG_FIELDS
from bioseqdb_tpu_torch.kernels.kmer import doubled_codes
from bioseqdb_tpu_torch.kernels.rows import pick_row, put_row
from bioseqdb_tpu_torch.kernels.sw import FIELDS, sw_extend_batch
from bioseqdb_tpu_torch.kernels.sw_cuda import sw_extend_cuda

SCAN_CHUNK = 8   # the plain scan's trips between live-lane checks
ROUTES = ("graph", "gates", "guards")
# the order of extend_all's rounds forced on every call (one of ROUTES),
# or None: a CUDA graph of the gated rounds on CUDA tensors, the host's
# guards on CPU tensors; under a group the host's guards always
_ROUTE: str | None = None
GRAPH_CACHE = 8   # extend_all's captured graphs kept at most
# the tables extend_all reads, copied into a graph's inputs
GRAPH_INPUTS = dict(seeds=("rbeg", "qbeg", "len", "valid", "score"),
                    chains=("assign", "f_rbeg", "rid"),
                    flt=("order", "kept"))


def window_doubled(pac_rows, seq_len: int, pos: torch.Tensor) -> torch.Tensor:
    """Codes of the doubled text at int positions ``pos``; positions
    outside [0, seq_len) read 4."""
    pos = pos.to(torch.int64)
    code = doubled_codes(pac_rows, pos)
    return torch.where((pos >= 0) & (pos < seq_len), code, 4).to(torch.int32)


def fetch_doubled(pac: torch.Tensor, l_pac: int, seq_len: int,
                  pos: torch.Tensor, group=None) -> torch.Tensor:
    """Codes of the doubled text at ``pos`` from the forward codes
    ``pac`` (1-D, 0..3); positions outside [0, seq_len) read 4. With
    ``group``, ``pac`` holds this rank's range of forward positions and
    each code is summed to its owner (``kernels/fm.py``)."""
    pos = pos.to(torch.int64)
    p = pos.clamp(0, seq_len - 1)
    fwd = p < l_pac
    base, mine = kfm._table_row(pac, torch.where(fwd, p, seq_len - 1 - p),
                                group)
    base = kfm._owner_sum(base, mine, group).to(torch.int32)
    code = torch.where(fwd, base, 3 - base)
    return torch.where((pos >= 0) & (pos < seq_len), code, 4).to(torch.int32)


def cal_max_gap(qlen, match_score, o_del, e_del, o_ins, e_ins, bandwidth):
    """bwa's cal_max_gap in float32, as the JAX version computes it: each
    quotient a true float32 division (the divisor a tensor on ``qlen``'s
    device: CUDA multiplies by the reciprocal of a Python-scalar divisor),
    truncated to int32."""
    f32 = lambda x: x.to(torch.float32)
    div = lambda x, e: f32(x) / torch.full((), float(e), dtype=torch.float32,
                                           device=qlen.device)
    l_del = (div(qlen * match_score - o_del, e_del) + 1.0).to(torch.int32)
    l_ins = (div(qlen * match_score - o_ins, e_ins) + 1.0).to(torch.int32)
    return torch.maximum(l_del, l_ins).clamp(min=1).clamp(max=bandwidth << 1)


def _gap(p: dict):
    return lambda x: cal_max_gap(x, p["match_score"], p["o_del"], p["e_del"],
                                 p["o_ins"], p["e_ins"], p["bandwidth"])


def _lanes(tab: dict, slot: torch.Tensor) -> tuple:
    """The seed at each lane's ``slot`` and its chain's window: (sq, sr,
    sl, c, r0, r1)."""
    c = pick_row(tab["cis"], slot)
    return (pick_row(tab["qbeg"], slot), pick_row(tab["rbeg"], slot),
            pick_row(tab["len"], slot), c, pick_row(tab["rmax0"], c),
            pick_row(tab["rmax1"], c))


def _sides(tab: dict, act: torch.Tensor, slot: torch.Tensor) -> tuple:
    """Both sides' (has [2, B], query length [2, B] int32, target length
    [2, B] in the rank dtype): left, the reversed query prefix against
    the reversed target before the seed; right, the suffixes after it."""
    sq, sr, sl, _, r0, r1 = _lanes(tab, slot)
    qn = torch.stack([sq, tab["lens"] - (sq + sl)])
    tn = torch.stack([sr - r0, r1 - (sr + sl)])
    return act[None, :] & (qn > 0), qn, tn


def extend_setup_plain(seeds: dict, chains: dict, flt: dict,
                       lens: torch.Tensor, refs: dict, p: dict) -> dict:
    """The set-up of the rounds: ``order`` (int32 [B, S], the slots in
    processing order: usable seeds by their chain's rank in the filter's
    order, then by score descending, ties to the later slot; the others
    after), ``n_usable`` (int32 [B]), ``cis`` (the seed's chain clamped
    into [0, C), int32 [B, S]), ``ok`` (valid and in a chain), and each
    chain's reference window ``rmax0`` / ``rmax1`` ([B, C] in the rank
    dtype): the span its seeds' extensions may reach, clipped to the
    strand and the reference (``refs``: offsets, lens, l_pac, seq_len)
    of its first seed."""
    B, S = seeds["rbeg"].shape
    C = chains["f_rbeg"].shape[1]
    dev = seeds["rbeg"].device
    rdt = seeds["rbeg"].dtype
    l_pac, seq_len = refs["l_pac"], refs["seq_len"]
    slen = seeds["len"]
    ci = chains["assign"]
    in_chain = ci >= 0
    cis = ci.clamp(0, C - 1)
    crank = torch.gather(torch.argsort(flt["order"], dim=1, stable=True), 1,
                         cis.long())
    ckept = torch.gather(flt["kept"], 1, cis.long()) > 0
    usable = in_chain & ckept & seeds["valid"]
    sidx = torch.arange(S, device=dev)[None, :]
    # seed score: len * match, unless the long-read seed-SW filter
    # (kernels/seedsw.py) re-scored it (bwa's s->score)
    sscore = seeds.get("score")
    if sscore is None:
        sscore = slen * p["match_score"]
    key = (crank * (1 << 19)
           + (4095 - sscore.clamp(0, 4095)) * (1 << 7)
           + (S - 1 - sidx))
    key = torch.where(usable, key, 0x7FFFFFF0)
    order = torch.argsort(key, dim=1, stable=True)

    # ---- per-chain rmax windows ----
    qbeg, rbeg = seeds["qbeg"], seeds["rbeg"]
    qlen_rem = lens[:, None] - qbeg - slen
    gap = _gap(p)
    big = torch.iinfo(rdt).max // 2
    b_all = torch.where(in_chain, rbeg - (qbeg + gap(qbeg)), big)
    e_all = torch.where(in_chain, rbeg + slen + qlen_rem + gap(qlen_rem), 0)
    rmax0 = torch.full((B, C), big, dtype=rdt, device=dev).scatter_reduce(
        1, cis.long(), b_all.to(rdt), "amin")
    rmax1 = torch.zeros(B, C, dtype=rdt, device=dev).scatter_reduce(
        1, cis.long(), e_all.to(rdt), "amax")
    rmax0 = rmax0.clamp(min=0)
    rmax1 = rmax1.clamp(max=seq_len)
    cfirst = chains["f_rbeg"]
    crosses = (rmax0 < l_pac) & (l_pac < rmax1)
    rmax1 = torch.where(crosses & (cfirst < l_pac), l_pac, rmax1)
    rmax0 = torch.where(crosses & (cfirst >= l_pac), l_pac, rmax0)
    # clip to the reference holding the first seed (bns_fetch_seq)
    crid = chains["rid"].long().clamp(0, refs["offsets"].shape[0] - 1)
    roff = refs["offsets"][crid]
    rlen_ref = refs["lens"][crid]
    mid_rev = cfirst >= l_pac
    rmax0 = torch.maximum(rmax0, torch.where(
        mid_rev, seq_len - (roff + rlen_ref), roff))
    rmax1 = torch.minimum(rmax1, torch.where(
        mid_rev, seq_len - roff, roff + rlen_ref))
    return dict(order=order.to(torch.int32),
                n_usable=usable.sum(1, dtype=torch.int32),
                cis=cis.to(torch.int32), ok=seeds["valid"] & in_chain,
                rmax0=rmax0, rmax1=rmax1)


def extend_scan_plain(tab: dict, st: dict, p: dict, count=None) -> dict:
    """The containment scan: each lane advances its cursor over ``order``
    past the seeds an accumulated region covers (and no overlap rescue
    claims) until it reaches a seed to extend or ``n_usable``. Returns
    the new ``cursor`` and ``overflow`` (int32 / bool [B]), the lane's
    ``slot`` (int32 [B]), ``act`` (bool [B]: a seed to extend and room
    for its region) and ``work`` (int32 [2, B]: the SW sort key of each
    side, rows until the band empties ~ min(tlen, qlen + band), -1 for
    an idle lane). ``count`` (one int32, or None) gets the active lanes
    added, as the kernel adds them."""
    order, n_usable = tab["order"], tab["n_usable"]
    qbeg, rbeg, slen, cis = tab["qbeg"], tab["rbeg"], tab["len"], tab["cis"]
    regs, n_regs, was_ext = st["regs"], st["n_regs"], st["was_ext"]
    lens = tab["lens"]
    B, S = order.shape
    R = regs["rb"].shape[1]
    rr = torch.arange(R, device=order.device)[None, :]
    gap = _gap(p)

    def body(cursor, decided):
        slot = pick_row(order, cursor.clamp(0, S - 1))
        active = (cursor < n_usable) & ~decided
        sq = pick_row(qbeg, slot)[:, None]
        sr = pick_row(rbeg, slot)[:, None]
        sl = pick_row(slen, slot)[:, None]
        inside = ((rr < n_regs[:, None])
                  & (sr >= regs["rb"]) & (sr + sl <= regs["re"])
                  & (sq >= regs["qb"]) & (sq + sl <= regs["qe"])
                  & ((sl - regs["seedlen0"]) <= (lens[:, None] // 10)))
        qd = sq - regs["qb"]
        rd = sr - regs["rb"]
        wlim = torch.minimum(gap(torch.minimum(qd, rd)), regs["w"])
        near1 = ((qd - rd) < wlim) & ((rd - qd) < wlim)
        qd2 = regs["qe"] - (sq + sl)
        rd2 = regs["re"] - (sr + sl)
        wlim2 = torch.minimum(gap(torch.minimum(qd2, rd2)), regs["w"])
        near2 = ((qd2 - rd2) < wlim2) & ((rd2 - qd2) < wlim2)
        covered = (inside & (near1 | near2)).any(1)
        # overlap rescue: an extended same-chain seed of similar length
        # on a different diagonal
        cand = was_ext & (cis == pick_row(cis, slot)[:, None]) & tab["valid"]
        c1 = ((sq <= qbeg) & ((sq + sl - qbeg) >= (sl >> 2))
              & ((qbeg - sq) != (rbeg - sr)))
        c2 = ((qbeg <= sq) & ((qbeg + slen - sq) >= (sl >> 2))
              & ((sq - qbeg) != (sr - rbeg)))
        simlen = slen >= (sl * 19 + 19) // 20
        need = (cand & simlen & (c1 | c2)).any(1)
        skip = active & covered & ~need
        cursor = torch.where(skip, cursor + 1, cursor)
        decided = decided | (active & ~skip) | (cursor >= n_usable)
        return cursor, decided

    cursor = st["cursor"]
    decided = torch.zeros(B, dtype=torch.bool, device=order.device)
    while not bool(decided.all()):
        for _ in range(SCAN_CHUNK):
            cursor, decided = body(cursor, decided)
    slot = pick_row(order, cursor.clamp(0, S - 1))
    todo = cursor < n_usable
    ovf_now = todo & (n_regs >= R)
    act = todo & ~ovf_now
    has, qn, tn = _sides(tab, act, slot)
    qn = torch.where(has, qn, 0).to(torch.int32)
    tn = torch.where(has, tn, 0).to(torch.int32)
    work = torch.where(qn > 0, torch.minimum(tn, qn + p["bandwidth"]), -1)
    if count is not None:
        count += act.sum(dtype=torch.int32)
    return dict(cursor=cursor, overflow=st["overflow"] | ovf_now, slot=slot,
                act=act, work=work.to(torch.int32))


def extend_windows_plain(tab: dict, fm, pac, scan: dict, perm: torch.Tensor,
                         p: dict, group=None, gate=None) -> dict:
    """Both sides' SW inputs for the round, in the sorted lane order
    ``perm`` (int64 [2, B]: row i of side k is lane perm[k, i]): ``qbuf``
    int32 [2, B, W] (left: the query prefix reversed; right: the suffix),
    ``tbuf`` int32 [2, B, W + 4 * band + 64] (left: the doubled text
    before the seed, reversed; right: after it), 4 past each length and
    in every row of a lane that has no side to extend; ``qn``, ``tn``
    int32 [2, B] (0 there), ``active`` bool [2, B], the left side's
    ``h0`` int32 [B] (seed length x match) and ``inv`` int32 [2, B]
    (lane b is row inv[k, b]). ``pac`` is the packed doubled text, or
    under ``group`` this rank's forward codes (owner-summed). Every output
    is computed whatever the ``gate`` (the kernel's skips the buffers at
    0, when no launch reads them). Under ``group`` the round's lanes are
    ``scan["sel"]`` where the caller gives them (``torch.nonzero`` of
    ``act``), else that ``nonzero``."""
    codes, lens = tab["codes"], tab["lens"]
    B, W = codes.shape
    T = W + 4 * p["bandwidth"] + 64
    dev = codes.device
    slot, act = scan["slot"], scan["act"]
    sq, sr, sl, _, _, _ = _lanes(tab, slot)
    has, qn, tn = _sides(tab, act, slot)
    wcols = torch.arange(W, device=dev)
    tcols = torch.arange(T, device=dev)
    qidx = torch.stack([sq[:, None] - 1 - wcols, (sq + sl)[:, None] + wcols])
    q = torch.gather(codes.expand(2, B, W), 2, qidx.clamp(0, W - 1).long())
    q = torch.where(has[:, :, None] & (wcols < qn[:, :, None]) & (qidx < W),
                    q, 4)
    pos = torch.stack([sr[:, None] - 1 - tcols, (sr + sl)[:, None] + tcols])
    if group is None:
        t = window_doubled(pac, fm.seq_len, pos)
    else:   # the lanes of the round only: the others' windows read 4
        sel = scan.get("sel")
        if sel is None:
            sel = torch.nonzero(act)[:, 0]
        t = torch.full((2, B, T), 4, dtype=torch.int32, device=dev)
        t[:, sel] = fetch_doubled(pac, fm.l_pac, fm.seq_len,
                                  pos[:, sel].reshape(-1), group
                                  ).reshape(2, -1, T)
    t = torch.where(has[:, :, None] & (tcols < tn[:, :, None]), t, 4)
    rows = lambda x: torch.gather(x, 1, perm[..., None].expand(x.shape))
    inv = torch.empty_like(perm).scatter_(
        1, perm, torch.arange(B, device=dev).expand(2, B))
    return dict(qbuf=rows(q.to(torch.int32)), tbuf=rows(t),
                qn=torch.gather(torch.where(has, qn, 0).to(torch.int32), 1,
                                perm),
                tn=torch.gather(torch.where(has, tn, 0).to(torch.int32), 1,
                                perm),
                active=torch.gather(has, 1, perm),
                h0=(sl * p["match_score"]).to(torch.int32)[perm[0]],
                inv=inv.to(torch.int32))


def _unsort(win: dict, k: int, r1: dict, r2: dict, retry, bw: int):
    """Side ``k``'s SW result and band by lane: the retry's where it
    retried (bwa keeps the wider band's result), read through the
    inverse permutation."""
    inv = win["inv"][k].long()
    res = {f: torch.where(retry, r2[f], r1[f])[inv] for f in FIELDS}
    return res, torch.where(retry, 2 * bw, bw).to(torch.int32)[inv]


def extend_merge_plain(side: int, tab: dict, st: dict, scan: dict,
                       win: dict, r1: dict, r2: dict, retry: torch.Tensor,
                       p: dict, left: dict | None = None, gate=None) -> dict:
    """Fold side ``side``'s SW results (``r1``, and ``r2`` where the
    sorted mask ``retry`` is set; dicts of int32 [B] in sorted order)
    into the lanes of the round. Left (0): the left result by lane,
    ``extend_cuda.LEFT_FIELDS`` (``rb`` in the rank dtype, the others
    int32 [B]), and ``h0``, the right side's h0 (and previous score) in
    its sorted order. Right (1, ``left`` the left merge's output): the
    new state, the region table with each active lane's region put at
    row ``n_regs`` (clamped to R - 1), ``n_regs``, ``was_ext`` and
    ``cursor``. The kernel's ``gate`` (and the in-place writes of a gated
    right merge) change nothing here: the outputs are new tensors, the
    same ones a gated round's state holds (its lanes are not active)."""
    bw = p["bandwidth"]
    slot, act = scan["slot"], scan["act"]
    sq, sr, sl, c, _, _ = _lanes(tab, slot)
    res, aw = _unsort(win, side, r1, r2, retry, bw)
    seed_sc = sl * p["match_score"]
    if side == 0:
        has = act & (sq > 0)
        local = ((res["gscore"] <= 0)
                 | (res["gscore"] <= res["score"] - p["pen_clip5"]))
        score = torch.where(has, res["score"], seed_sc)
        h0 = torch.empty_like(score).scatter_(0, win["inv"][1].long(), score)
        return dict(
            qb=torch.where(has & local, sq - res["qle"], 0),
            rb=torch.where(has, torch.where(local, sr - res["tle"],
                                            sr - res["gtle"]), sr),
            score=score,
            truesc=torch.where(has, torch.where(local, res["score"],
                                                res["gscore"]), seed_sc),
            aw=torch.where(has, aw, bw), h0=h0)
    lens = tab["lens"]
    qe0, re0 = sq + sl, sr + sl
    has = act & (lens - qe0 > 0)
    local = ((res["gscore"] <= 0)
             | (res["gscore"] <= res["score"] - p["pen_clip3"]))
    new = dict(
        rb=left["rb"], qb=left["qb"], seedlen0=sl, cchain=c,
        re=torch.where(has, torch.where(local, re0 + res["tle"],
                                        re0 + res["gtle"]), re0),
        qe=torch.where(has, torch.where(local, qe0 + res["qle"], lens), qe0),
        score=torch.where(has, res["score"], left["score"]),
        truesc=left["truesc"] + torch.where(
            has, torch.where(local, res["score"], res["gscore"])
            - left["score"], 0),
        w=torch.maximum(left["aw"], torch.where(has, aw, bw)),
        rid=pick_row(tab["crid"], c))
    n_regs = st["n_regs"]
    R = st["regs"]["rb"].shape[1]
    slot_r = n_regs.clamp(max=R - 1)
    regs = {k: put_row(st["regs"][k], slot_r, new[k], act)
            for k in REG_FIELDS}
    sidx = torch.arange(st["was_ext"].shape[1], device=act.device)[None, :]
    return dict(regs=regs, n_regs=n_regs + act.to(torch.int32),
                was_ext=st["was_ext"] | ((sidx == slot[:, None])
                                         & act[:, None]),
                cursor=torch.where(act, st["cursor"] + 1, st["cursor"]))


def extend_seedcov_plain(tab: dict, regs: dict) -> torch.Tensor:
    """seedcov int32 [B, R]: the lengths of the region's chain's seeds
    (valid, in a chain) fully inside the region, summed."""
    q3, r3, l3 = (tab[k][:, :, None] for k in ("qbeg", "rbeg", "len"))
    okc = tab["ok"][:, :, None] & (tab["cis"][:, :, None]
                                   == regs["cchain"][:, None, :])
    inside = (okc & (q3 >= regs["qb"][:, None]) & (q3 + l3 <= regs["qe"][:, None])
              & (r3 >= regs["rb"][:, None]) & (r3 + l3 <= regs["re"][:, None]))
    return torch.where(inside, l3, 0).sum(1, dtype=torch.int32)


def extend_setup(seeds: dict, chains: dict, flt: dict, lens: torch.Tensor,
                 refs: dict, p: dict) -> dict:
    """``extend_setup_plain``: the kernel on CUDA tensors, else the twin."""
    fn = (ecu.extend_setup_cuda if seeds["rbeg"].is_cuda
          else extend_setup_plain)
    return fn(seeds, chains, flt, lens, refs, p)


def extend_scan(tab: dict, st: dict, p: dict, count=None) -> dict:
    """``extend_scan_plain``: the kernel on CUDA tensors, else the twin."""
    fn = ecu.extend_scan_cuda if tab["order"].is_cuda else extend_scan_plain
    return fn(tab, st, p, count)


def extend_windows(tab: dict, fm, pac, scan: dict, perm: torch.Tensor,
                   p: dict, group=None, gate=None) -> dict:
    """``extend_windows_plain``: on CUDA tensors the kernel, or under a
    ``group`` ``extend_windows_sharded`` (the owner sum of an index
    mesh's targets is a collective no launch holds); on CPU tensors the
    twin."""
    if not tab["order"].is_cuda:
        return extend_windows_plain(tab, fm, pac, scan, perm, p, group)
    if group is not None:
        return extend_windows_sharded(tab, fm, pac, scan, perm, p, group)
    return ecu.extend_windows_cuda(tab, fm.seq_len, pac, scan, perm, p, gate)


def extend_windows_sharded(tab: dict, fm, pac: torch.Tensor, scan: dict,
                           perm: torch.Tensor, p: dict, group, run=None
                           ) -> dict:
    """``extend_windows_plain(..., group)`` on the kernels of
    ``csrc/extend.cu``: ``windows_shard_query`` over the round's lanes
    (``scan["sel"]``, else one ``nonzero`` of ``act``; this rank's
    forward codes ``pac`` at both windows' T columns where it owns them,
    into the twin's int8 [1, 2 n T] owner-sum buffer), the ``all_reduce``
    of that buffer over ``group`` (even of no lane, as the twin's), then
    ``extend_windows``' kernel in its summed-target mode. ``run``:
    ``extend_cuda.launch`` (the default, on CUDA tensors) or a host
    build's (``extend_cuda.host_launcher``). Bit-equal to the twin, with
    the same ``all_reduce`` calls and bytes."""
    run = run or ecu.launch
    sel = scan.get("sel")
    if sel is None:
        sel = torch.nonzero(scan["act"])[:, 0]
    q = run("windows_shard_query", "windows_shard_query",
            *ecu.windows_query_args(tab, fm, pac, sel.contiguous(),
                                    scan["slot"], p, dist.get_rank(group)))
    kfm._all_reduce(q["buf"], group)
    return run("extend_windows", "extend_windows",
               *ecu.windows_args(tab, fm.seq_len, None, scan, perm, p,
                                 sums=q["buf"], sel_of=q["sel_of"],
                                 l_pac=fm.l_pac))


def extend_merge(side: int, tab: dict, st: dict, scan: dict, win: dict,
                 r1: dict, r2: dict, retry: torch.Tensor, p: dict,
                 left: dict | None = None, gate=None) -> dict:
    """``extend_merge_plain``: the kernel on CUDA tensors, else the twin."""
    fn = ecu.extend_merge_cuda if tab["order"].is_cuda else extend_merge_plain
    return fn(side, tab, st, scan, win, r1, r2, retry, p, left, gate)


def extend_seedcov(tab: dict, regs: dict) -> torch.Tensor:
    """``extend_seedcov_plain``: the kernel on CUDA tensors, else the twin."""
    fn = (ecu.extend_seedcov_cuda if tab["order"].is_cuda
          else extend_seedcov_plain)
    return fn(tab, regs)


def extend_all(fm: kfm.FMDevice, pac_rows, codes, lens, seeds: dict,
               chains: dict, flt: dict, mat, match_score: int,
               mismatch_penalty: int, o_del: int, e_del: int, o_ins: int,
               e_ins: int, bandwidth: int, zdrop: int, pen_clip5: int,
               pen_clip3: int, max_rounds: int = 6, max_regs: int = 8,
               group=None) -> dict:
    """Run the extension stage. Returns the per-read region table
    (qb/qe/score/truesc/w/seedlen0/cchain/rid/seedcov int32[B, R], and
    rb/re [B, R] in the seeds' rank dtype) with n_regs and overflow.
    With ``group``, ``pac_rows`` is this rank's shard of the per-base
    forward codes (``FMSharded.pac``), not the packed doubled text. On
    CUDA tensors with no group the call is a CUDA graph of the gated
    rounds (the module's docstring); on CPU tensors and under a group the
    host guards the rounds. All give the same result."""
    opts = dict(match_score=match_score, mismatch_penalty=mismatch_penalty,
                o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
                bandwidth=bandwidth, zdrop=zdrop, pen_clip5=pen_clip5,
                pen_clip3=pen_clip3, max_rounds=max_rounds,
                max_regs=max_regs)
    route = _route(codes.is_cuda, group)
    if route == "graph" and codes.shape[0] > 0:
        return _graphed(fm, pac_rows, codes, lens, seeds, chains, flt, opts)
    return _rounds(fm, pac_rows, codes, lens, seeds, chains, flt, mat, opts,
                   group, guards=route == "guards")


def _route(cuda: bool, group) -> str:
    """How ``extend_all`` runs (one of ROUTES): under a group the host's
    guards (every rank enters each window fetch); else ``_ROUTE`` where
    set (a graph only on the card), a graph on the card and the guards
    on the CPU."""
    if _ROUTE is not None and _ROUTE not in ROUTES:
        raise ValueError(f"extend_all: no route {_ROUTE!r}")
    if group is not None or (not cuda and _ROUTE != "gates"):
        return "guards"
    return _ROUTE or "graph"


class _Graph:
    """``extend_all`` captured as a CUDA graph: its input tensors (the
    graph reads them), its outputs (it writes them) and the launches its
    capture counted (each replay makes them)."""

    def __init__(self, inputs: dict, run):
        dev = next(iter(inputs.values())).device
        self.inputs = {k: torch.empty_like(
            t, memory_format=torch.contiguous_format)
            for k, t in inputs.items()}
        self.load(inputs)
        self.graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        counted = dict(build.LAUNCHES)
        try:
            with torch.cuda.stream(side):
                self.graph.capture_begin()
                try:
                    self.outputs = run(self.inputs)
                finally:
                    self.graph.capture_end()
            # the capture launched nothing: its launches are the replays'
            self.launches = {k: n - counted[k]
                             for k, n in build.LAUNCHES.items()
                             if n != counted[k]}
        finally:
            build.LAUNCHES.update(counted)
        torch.cuda.current_stream(dev).wait_stream(side)

    def load(self, inputs: dict) -> None:
        for k, t in inputs.items():
            self.inputs[k].copy_(t)

    def replay(self, inputs: dict) -> dict:
        """The outputs for ``inputs``, copied out of the graph's."""
        self.load(inputs)
        self.graph.replay()
        for k, n in self.launches.items():
            build.LAUNCHES[k] += n
        copy = lambda o: ({k: copy(v) for k, v in o.items()}
                          if isinstance(o, dict) else o.clone())
        return copy(self.outputs)


_GRAPHS: "OrderedDict[tuple, _Graph]" = OrderedDict()


def _graphed(fm, pac_rows, codes, lens, seeds: dict, chains: dict,
             flt: dict, opts: dict) -> dict:
    """``extend_all`` (CUDA tensors, no group) through the CUDA graph of
    its shapes, tables and options, captured first if there is none."""
    tables = dict(seeds=seeds, chains=chains, flt=flt)
    inputs = dict(codes=codes, lens=lens, **{
        f"{g}.{k}": tables[g][k] for g, keys in GRAPH_INPUTS.items()
        for k in keys if k in tables[g]})
    refs = (pac_rows, fm.ref_offsets, fm.ref_lens)
    key = (codes.device,
           tuple((k, tuple(t.shape), t.dtype) for k, t in inputs.items()),
           tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in refs),
           fm.l_pac, fm.seq_len, tuple(opts.items()))
    g = _GRAPHS.pop(key, None)
    if g is None:
        def run(st: dict) -> dict:
            part = lambda name: {k: st[f"{name}.{k}"]
                                 for k in GRAPH_INPUTS[name]
                                 if f"{name}.{k}" in st}
            return _rounds(fm, pac_rows, st["codes"], st["lens"],
                           part("seeds"), part("chains"), part("flt"), None,
                           opts, None, guards=False)

        while len(_GRAPHS) >= GRAPH_CACHE:
            _GRAPHS.popitem(last=False)
        g = _Graph(inputs, run)
    _GRAPHS[key] = g
    return g.replay(inputs)


def _rounds(fm, pac_rows, codes, lens, seeds: dict, chains: dict, flt: dict,
            mat, opts: dict, group, guards: bool) -> dict:
    """``extend_all``'s work, launch by launch: with ``guards`` the host
    skips a round with no active read and a retry no lane takes (reading
    the device), else every launch runs under its gate on the device."""
    B, S = seeds["rbeg"].shape
    R = opts["max_regs"]
    dev = codes.device
    i32 = torch.int32
    rdt = seeds["rbeg"].dtype
    W = codes.shape[1]
    codes = codes.to(i32)
    lens = lens.to(i32)
    p = {k: opts[k] for k in ("match_score", "o_del", "e_del", "o_ins",
                              "e_ins", "bandwidth", "pen_clip5",
                              "pen_clip3")}
    bandwidth = opts["bandwidth"]
    refs = dict(offsets=fm.ref_offsets, lens=fm.ref_lens, l_pac=fm.l_pac,
                seq_len=fm.seq_len)
    tab = dict(extend_setup(seeds, chains, flt, lens, refs, p),
               qbeg=seeds["qbeg"].to(i32), rbeg=seeds["rbeg"],
               len=seeds["len"].to(i32), valid=seeds["valid"], lens=lens,
               codes=codes, crid=chains["rid"].to(i32))
    tab = {k: v.contiguous() for k, v in tab.items()}

    # ---- extension rounds ----
    zr = lambda v=0, dt=i32: torch.full((B, R), v, dtype=dt, device=dev)
    st = dict(regs=dict(rb=zr(0, rdt), re=zr(0, rdt), qb=zr(), qe=zr(),
                        score=zr(), truesc=zr(), w=zr(), seedlen0=zr(),
                        cchain=zr(-1), rid=zr(-1)),
              n_regs=torch.zeros(B, dtype=i32, device=dev),
              cursor=torch.zeros(B, dtype=i32, device=dev),
              was_ext=torch.zeros(B, S, dtype=torch.bool, device=dev),
              overflow=torch.zeros(B, dtype=torch.bool, device=dev))
    # each round's count of active reads, the gate of its launches
    counts = (None if guards
              else torch.zeros(opts["max_rounds"], dtype=i32, device=dev))
    # the bands of a side's SW launch and of its retry
    w1 = torch.full((B,), bandwidth, dtype=i32, device=dev)
    w2 = w1 * 2
    sw = {k: opts[k] for k in ("match_score", "mismatch_penalty", "o_del",
                               "e_del", "o_ins", "e_ins", "zdrop")}

    def sw_one(qbuf, qn, tbuf, tn, w, bonus, h0, max_w, gate):
        if qbuf.is_cuda:
            return sw_extend_cuda(qbuf, qn, tbuf, tn, w, h0, end_bonus=bonus,
                                  max_w=max_w, gate=gate, **sw)
        return sw_extend_batch(qbuf, qn, tbuf, tn, mat, sw["o_del"],
                               sw["e_del"], sw["o_ins"], sw["e_ins"], w,
                               bonus, sw["zdrop"], h0, W)

    def sw_side(win, k, h0, bonus, prev, gate):
        """Side ``k``'s ksw_extend on the sorted lanes, with bwa's band
        doubling: retry at twice the band iff the score moved and the max
        offset filled the band. Returns (r1, r2, retry); under the guards
        r2 = r1 when no lane retried, else the retry launch's gate is the
        count of retries (its results are read only where one retried)."""
        qbuf, tbuf, qn, tn = (win[f][k] for f in ("qbuf", "tbuf", "qn", "tn"))
        r1 = sw_one(qbuf, qn, tbuf, tn, w1, bonus, h0, bandwidth, gate)
        retry = (win["active"][k] & (r1["score"] != prev)
                 & (r1["max_off"] >= (bandwidth >> 1) + (bandwidth >> 2)))
        if guards and not bool(retry.any()):
            return r1, r1, retry
        retries = None if guards else retry.sum(dtype=i32)
        r2 = sw_one(qbuf, torch.where(retry, qn, 0).to(i32), tbuf, tn,
                    w2, bonus, h0, 2 * bandwidth, retries)
        return r1, r2, retry

    for rnd in range(opts["max_rounds"]):
        gate = None if counts is None else counts[rnd]
        scan = extend_scan(tab, st, p, count=gate)
        st.update(cursor=scan["cursor"], overflow=scan["overflow"])
        if group is not None:
            # the round's one host read: its lanes, which serve the guard
            # and the window fetch's owner sum
            scan = dict(scan, sel=torch.nonzero(scan["act"])[:, 0])
            if not scan["sel"].numel():
                continue
        elif guards and not bool(scan["act"].any()):
            continue
        perm = torch.argsort(-scan["work"], dim=1, stable=True)
        win = extend_windows(tab, fm, pac_rows, scan, perm, p, group,
                             gate=gate)
        left = extend_merge(
            0, tab, st, scan, win,
            *sw_side(win, 0, win["h0"], p["pen_clip5"], -1, gate), p,
            gate=gate)
        st.update(extend_merge(
            1, tab, st, scan, win,
            *sw_side(win, 1, left["h0"], p["pen_clip3"], left["h0"], gate),
            p, left, gate=gate))
    regs = dict(st["regs"], seedcov=extend_seedcov(tab, st["regs"]))
    return dict(regs=regs, n_regs=st["n_regs"],
                overflow=st["overflow"] | (st["cursor"] < tab["n_usable"]))
