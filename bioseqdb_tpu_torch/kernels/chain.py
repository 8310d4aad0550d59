"""Seed resolution, chaining and chain filtering on torch tensors.

The port of ``bioseqdb_tpu/kernels/chain.py`` (bwa's mem_chain +
mem_chain_flt): ``resolve_seeds`` sorts each read's seed intervals,
samples at most ``max_occ`` positions per interval and resolves them
through the sampled suffix array; ``chain_seeds`` grows chains with the
closest-chain test; ``filter_chains`` weighs chains and applies the
shadowing filter; ``l_rep_device`` is the repetitive-coverage length.
The per-seed and per-chain loops stay sequential in the seed or chain
index (their steps depend on each other). On CUDA tensors ``chain_seeds``
and ``filter_chains`` are one launch each of ``csrc/chain.cu``'s kernels
(``kernels/chain_cuda.py``: a thread a read runs every trip), which raise
rather than fall back; on CPU tensors they run their plain twins,
``chain_seeds_plain`` and ``filter_chains_plain``, the loops as eager
torch ops vectorized over reads, bit-equal to the kernels. ``resolve_seeds``
on CUDA tensors is two launches of ``csrc/resolve.cu``'s kernels
(``kernels/resolve_cuda.py``: a warp a read) around the SA walk's, and
on CPU tensors its plain twin ``resolve_seeds_plain``.
Reference positions (``rbeg``, a chain's ``pos``, ``f_rbeg`` and
``l_rbeg``, the filter's reference ends) hold the index's rank dtype,
int64 past 2^31 doubled bases, as in the JAX version; query positions,
lengths and weights stay int32.
"""

from __future__ import annotations

import torch

from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels.chain_cuda import (chain_seeds_cuda,
                                                   filter_chains_cuda)
from bioseqdb_tpu_torch.kernels.resolve_cuda import (resolve_expand_cuda,
                                                     resolve_finish_cuda)
from bioseqdb_tpu_torch.kernels.rows import pick_row, put_row, take

NEG = -(1 << 30)


def resolve_seeds(fm: kfm.FMDevice, mems: torch.Tensor, n_mem: torch.Tensor,
                  max_occ: int, max_seeds: int, sa_interval: int = 32,
                  compact_cap: int | None = 0, group=None) -> dict:
    """Expand seed intervals (mems [B, M, 5] = k, l, s, start, end, in
    the rank dtype) into located seeds, ordered by (start, end) then
    sampled rank; ``rbeg`` comes back in the rank dtype.

    A row whose l column is nonzero carries a doubled-text position in
    its k column (the kmer seeder's s == 1 rows) and skips the SA walk.
    Only the rank rows walk, at most ``(B * S) // 4`` of them (or
    ``compact_cap``) in slot order, as the JAX version's static buffer
    holds them; lanes past it overflow. ``compact_cap`` None walks every
    rank lane: the buffer is a TPU static-shape cap. ``group``: a sharded
    index's process group (``kernels/fm.py``), whose ranks hold the same
    seeds.

    On CUDA tensors without a group: one launch of ``csrc/resolve.cu``'s
    ``resolve_expand``, the SA walk (``csrc/fm.cu``'s ``sa_resolve``) of
    every rank lane under the expansion's mask, one cumsum of the reads'
    walking lanes where the cap may cut some, and one launch of
    ``resolve_finish``, which applies the cap; no host wait. Elsewhere
    the plain twin ``resolve_seeds_plain``: on CPU tensors, and under a
    group by an explicit branch: there the walk is an owner sum a step
    (``kernels/fm.py``), so it takes the lanes under the cap alone,
    compacted by eager ops that need the cap's mask before the walk,
    which the expansion kernel does not give. Both give the same dict."""
    if not mems.is_cuda or group is not None:
        return resolve_seeds_plain(fm, mems, n_mem, max_occ, max_seeds,
                                   sa_interval, compact_cap, group)
    B = mems.shape[0]
    S = max_seeds
    ex = resolve_expand_cuda(mems, n_mem, max_occ, S)
    pos = kfm.sa_resolve(fm, ex["ranks"], sa_interval, mask=ex["walk"])
    cap = walk_cap(B, S, compact_cap)
    ends = (torch.cumsum(ex["n_walk"], 0) if cap < B * S else None)
    return resolve_finish_cuda(fm, ex, pos, ends, cap)


def walk_cap(B: int, S: int, compact_cap: int | None) -> int:
    """The most rank lanes ``resolve_seeds`` walks, in slot order: the JAX
    version's compact buffer, (B * S) // 4 or ``compact_cap`` if smaller,
    every lane with ``compact_cap`` None or B * S <= 4096 (no buffer)."""
    if B * S <= 4096 or compact_cap is None:
        return B * S
    K = (B * S) // 4
    return min(K, compact_cap) if compact_cap > 0 else K


def resolve_seeds_plain(fm: kfm.FMDevice, mems: torch.Tensor,
                        n_mem: torch.Tensor, max_occ: int, max_seeds: int,
                        sa_interval: int = 32, compact_cap: int | None = 0,
                        group=None) -> dict:
    """``resolve_seeds``' plain twin, on any device: eager ops. Past the
    no-buffer size the walking lanes within the cap are compacted first
    (``torch.nonzero``), as the JAX version's buffer holds them, and only
    they walk."""
    B, M, _ = mems.shape
    S = max_seeds
    dev = mems.device
    i32 = torch.int32
    mm = torch.arange(M, device=dev)[None, :]
    live = mm < n_mem[:, None]
    key = mems[:, :, 3] * 4096 + mems[:, :, 4].clamp(max=4095)
    key = torch.where(live, key, 0x3FFFFFFF)
    order = torch.argsort(key, dim=1, stable=True)
    sm = torch.gather(mems, 1, order[:, :, None].expand(B, M, 5))
    live_s = torch.gather(live, 1, order)
    s_sz = sm[:, :, 2]
    step = torch.where(s_sz > max_occ, s_sz // max_occ, 1)
    cnt = torch.where(live_s, s_sz.clamp(max=max_occ), 0)
    off = (torch.cumsum(cnt, 1) - cnt).to(i32)          # exclusive offsets
    total = off[:, -1] + cnt[:, -1]
    overflow = total > S

    ss = torch.arange(S, device=dev, dtype=i32)[None, :]
    midx = ((off[:, :, None] <= ss[:, None, :]).sum(1) - 1).clamp(0, M - 1)
    valid = ss < total.clamp(max=S)[:, None]
    k0 = take(sm[:, :, 0], midx)
    start = take(sm[:, :, 3], midx)
    end = take(sm[:, :, 4], midx)
    isposrow = take(sm[:, :, 1], midx) > 0
    t = ss - take(off, midx)
    ranks = torch.where(valid & ~isposrow, k0 + t * take(step, midx), 1
                        ).to(fm.rank_dtype)

    if B * S > 4096:
        K = walk_cap(B, S, compact_cap)
        fvalid = (valid & ~isposrow).reshape(-1)
        cpos = torch.cumsum(fvalid.to(i32), 0) - 1
        walk = fvalid & (cpos < K)
        src = torch.nonzero(walk)[:, 0]
        pos = torch.zeros(B * S, dtype=fm.rank_dtype, device=dev)
        pos[src] = kfm.sa_resolve(fm, ranks.reshape(-1)[src], sa_interval,
                                  group)
        pos = pos.reshape(B, S)
        truncated = (fvalid & (cpos >= K)).reshape(B, S)
        valid = valid & ~truncated
        overflow = overflow | truncated.any(1)
    else:
        pos = kfm.sa_resolve(fm, ranks, sa_interval, group)
    pos = torch.where(isposrow, k0, pos)
    slen = end - start

    # bns_intv2rid: drop seeds bridging strand or reference boundaries
    bridge = (pos < fm.l_pac) & (pos + slen > fm.l_pac)
    fb, _ = kfm.depos(fm, pos, 1)
    fe, _ = kfm.depos(fm, pos + slen - 1, 1)
    rid_b = kfm.rid_of(fm, fb)
    rid_e = kfm.rid_of(fm, fe)
    ok = valid & ~bridge & (rid_b == rid_e)
    return dict(
        rbeg=torch.where(ok, pos, 0).to(fm.rank_dtype),
        qbeg=torch.where(ok, start, 0).to(i32),
        len=torch.where(ok, slen, 0).to(i32),
        rid=torch.where(ok, rid_b, -1).to(i32),
        valid=ok,
        overflow=overflow,
    )


def l_rep_device(mems: torch.Tensor, n_mem: torch.Tensor, max_occ: int
                 ) -> torch.Tensor:
    """Union length of the query spans of seed intervals with more than
    ``max_occ`` occurrences (mem_chain's l_rep)."""
    B, M, _ = mems.shape
    mm = torch.arange(M, device=mems.device)[None, :]
    valid = (mm < n_mem[:, None]) & (mems[:, :, 2] > max_occ)
    start = mems[:, :, 3]
    end = mems[:, :, 4]
    key = torch.where(valid, start * 8192 + end.clamp(max=8191), 0x7FFFFFFF)
    order = torch.argsort(key, dim=1, stable=True)
    ss = torch.gather(start, 1, order)
    ee = torch.gather(end, 1, order)
    vv = torch.gather(valid, 1, order)
    run = torch.cummax(torch.where(vv, ee, 0), 1).values
    prev = torch.nn.functional.pad(run[:, :-1], (1, 0), value=0)
    contrib = torch.where(vv, (ee - torch.maximum(ss, prev)).clamp(min=0), 0)
    return contrib.sum(1).to(torch.int32)


def chain_seeds(fm: kfm.FMDevice, seeds: dict, max_chains: int,
                bandwidth: int, max_chain_gap: int) -> dict:
    """Grow chains over located seeds (mem_chain's insertion loop);
    returns the chain tables and a seed -> chain assignment (-1 dropped,
    -2 contained). On CUDA tensors one launch of the hand-written kernel
    (``chain_cuda.chain_seeds_cuda``), on CPU tensors the plain twin
    ``chain_seeds_plain``; only ``fm.l_pac`` is read."""
    if seeds["rbeg"].device.type == "cuda":
        return chain_seeds_cuda(seeds, fm.l_pac, max_chains, bandwidth,
                                max_chain_gap)
    return chain_seeds_plain(fm, seeds, max_chains, bandwidth, max_chain_gap)


def chain_seeds_plain(fm: kfm.FMDevice, seeds: dict, max_chains: int,
                      bandwidth: int, max_chain_gap: int) -> dict:
    """``chain_seeds``' plain twin, on any device: a trip a seed slot,
    each a few dozen torch ops over every read."""
    B, S = seeds["rbeg"].shape
    C = max_chains
    dev = seeds["rbeg"].device
    i32 = torch.int32
    rdt = seeds["rbeg"].dtype
    zc = lambda v=0, dt=i32: torch.full((B, C), v, dtype=dt, device=dev)
    st = dict(pos=zc(0, rdt), rid=zc(-1), f_qbeg=zc(), f_rbeg=zc(0, rdt),
              l_qbeg=zc(), l_rbeg=zc(0, rdt), l_len=zc())
    n = torch.zeros(B, dtype=i32, device=dev)
    assign = torch.full((B, S), -1, dtype=i32, device=dev)
    overflow = torch.zeros(B, dtype=torch.bool, device=dev)
    slots = torch.arange(C, device=dev)[None, :]
    l_pac = fm.l_pac

    for s in range(S):
        rbeg = seeds["rbeg"][:, s]
        qbeg = seeds["qbeg"][:, s]
        slen = seeds["len"][:, s]
        srid = seeds["rid"][:, s]
        ok = seeds["valid"][:, s]
        active = slots < n[:, None]
        # closest chain: largest pos <= rbeg, first slot among equals
        val = torch.where(active & (st["pos"] <= rbeg[:, None]), st["pos"],
                          NEG)
        ci = torch.argmax(val, 1)
        found = pick_row(val, ci) > NEG
        g = {k: pick_row(v, ci) for k, v in st.items()}
        qend = g["l_qbeg"] + g["l_len"]
        rend = g["l_rbeg"] + g["l_len"]
        same_rid = srid == g["rid"]
        contained = ((qbeg >= g["f_qbeg"]) & (qbeg + slen <= qend)
                     & (rbeg >= g["f_rbeg"]) & (rbeg + slen <= rend))
        diff_strand = (((g["l_rbeg"] < l_pac) | (g["f_rbeg"] < l_pac))
                       & (rbeg >= l_pac))
        x = qbeg - g["l_qbeg"]
        y = rbeg - g["l_rbeg"]
        grow = ((y >= 0) & (x - y <= bandwidth) & (y - x <= bandwidth)
                & (x - g["l_len"] < max_chain_gap)
                & (y - g["l_len"] < max_chain_gap))
        merged_grow = ok & found & same_rid & ~contained & ~diff_strand & grow
        merged_cont = ok & found & same_rid & contained
        new_chain = ok & ~(merged_grow | merged_cont)

        st["l_qbeg"] = put_row(st["l_qbeg"], ci, qbeg, merged_grow)
        st["l_rbeg"] = put_row(st["l_rbeg"], ci, rbeg, merged_grow)
        st["l_len"] = put_row(st["l_len"], ci, slen, merged_grow)
        col = torch.where(merged_grow, ci.to(i32),
                          torch.where(merged_cont, -2, -1))

        ovf = new_chain & (n >= C)
        alloc = new_chain & ~ovf
        slot = n.clamp(max=C - 1)
        for name, v in (("pos", rbeg), ("rid", srid), ("f_qbeg", qbeg),
                        ("f_rbeg", rbeg), ("l_qbeg", qbeg), ("l_rbeg", rbeg),
                        ("l_len", slen)):
            st[name] = put_row(st[name], slot, v, alloc)
        assign[:, s] = torch.where(alloc, slot, col)
        n = n + alloc.to(i32)
        overflow = overflow | ovf
    return dict(st, n=n, assign=assign, overflow=overflow)


def filter_chains(chains: dict, seeds: dict, mask_level: float,
                  chain_drop_ratio: float, min_chain_weight: int,
                  min_seed_len: int, max_chain_gap: int) -> dict:
    """Chain weights + the shadowing filter (mem_chain_flt). Returns
    weight, kept (0 dropped / 1 promoted shadow / 2 overlapped / 3
    primary), order (weight-descending slots), beg, end: int32[B, C].
    On CUDA tensors one launch of the hand-written kernel
    (``chain_cuda.filter_chains_cuda``), on CPU tensors the plain twin
    ``filter_chains_plain``."""
    fn = (filter_chains_cuda if seeds["rbeg"].device.type == "cuda"
          else filter_chains_plain)
    return fn(chains, seeds, mask_level, chain_drop_ratio, min_chain_weight,
              min_seed_len, max_chain_gap)


def filter_chains_plain(chains: dict, seeds: dict, mask_level: float,
                        chain_drop_ratio: float, min_chain_weight: int,
                        min_seed_len: int, max_chain_gap: int) -> dict:
    """``filter_chains``' plain twin, on any device: the weight loop a
    trip a seed slot, the shadow and promotion loops a trip a chain, each
    trip torch ops over every read."""
    B, S = seeds["rbeg"].shape
    C = chains["pos"].shape[1]
    dev = seeds["rbeg"].device
    i32 = torch.int32
    zc = lambda v=0: torch.full((B, C), v, dtype=i32, device=dev)
    wq, endq, wr = zc(), zc(), zc()
    endr = torch.zeros(B, C, dtype=seeds["rbeg"].dtype, device=dev)
    beg, end = zc(1 << 29), zc()

    for s in range(S):
        ci = chains["assign"][:, s]
        isin = ci >= 0
        cis = ci.clamp(0, C - 1)
        qb = seeds["qbeg"][:, s]
        rb = seeds["rbeg"][:, s]
        ln = seeds["len"][:, s]

        def acc(w, e, b):
            wv = pick_row(w, cis)
            ev = pick_row(e, cis)
            add = torch.where(b >= ev, ln, (b + ln - ev).clamp(min=0))
            return (put_row(w, cis, wv + add, isin),
                    put_row(e, cis, torch.maximum(ev, b + ln), isin))

        wq, endq = acc(wq, endq, qb)
        wr, endr = acc(wr, endr, rb)
        beg = put_row(beg, cis, torch.minimum(pick_row(beg, cis), qb), isin)
        end = put_row(end, cis, torch.maximum(pick_row(end, cis), qb + ln), isin)

    slots = torch.arange(C, device=dev)[None, :]
    exists = slots < chains["n"][:, None]
    weight = torch.where(exists, torch.minimum(wq, wr), -1)
    alive = exists & (weight >= min_chain_weight)
    weight = torch.where(alive, weight, -1).to(i32)

    # weight-descending; ties by chain pos ascending
    pkey = torch.where(exists, chains["pos"], 0x7FFFFFFF)
    pos_rank = torch.argsort(torch.argsort(pkey, dim=1, stable=True), dim=1,
                             stable=True).to(i32)
    combined = weight * C + (C - 1 - pos_rank)
    order = torch.argsort(-combined, dim=1, stable=True)

    kept = zc()
    first = zc(-1)
    best = order[:, 0]
    kept = put_row(kept, best, 3, pick_row(alive, best))
    rank_of = torch.argsort(order, dim=1, stable=True).to(i32)

    for r in range(1, C):
        ci = order[:, r]
        ok = pick_row(alive, ci)
        bi = pick_row(beg, ci)
        ei = pick_row(end, ci)
        wi = pick_row(weight, ci)
        li = ei - bi
        considered = kept > 0
        b_max = torch.maximum(beg, bi[:, None])
        e_min = torch.minimum(end, ei[:, None])
        ovl = e_min > b_max
        min_l = torch.minimum(li[:, None], end - beg)
        sig = (considered & ovl & ((e_min - b_max) >= min_l * mask_level)
               & (min_l < max_chain_gap))
        dropc = sig & ((wi[:, None] < weight * chain_drop_ratio)
                       & ((weight - wi[:, None]) >= (min_seed_len * 2)))
        first_drop = torch.where(dropc, rank_of, 1 << 29).amin(1)
        sig_eff = sig & (rank_of <= first_drop[:, None])
        dropped = first_drop < (1 << 29)
        large = sig_eff.any(1)
        first = torch.where(ok[:, None] & sig_eff & (first < 0),
                            ci[:, None].to(i32), first)
        newk = torch.where(ok & ~dropped, torch.where(large, 2, 3), 0)
        kept = put_row(kept, ci, newk, ok & (pick_row(kept, ci) == 0))

    for c in range(C):   # promote shadows referenced by kept chains
        fi = first[:, c]
        do = (kept[:, c] > 0) & (fi >= 0)
        fis = fi.clamp(0, C - 1)
        kept = put_row(kept, fis, 1, do & (pick_row(kept, fis) == 0))
    return dict(weight=weight, kept=kept, order=order.to(i32), beg=beg,
                end=end)
