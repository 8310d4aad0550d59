"""Minimizer-table seeding (rounds 1 and 3 of BWA-MEM's seeding).

The port of ``bioseqdb_tpu/kernels/kmer.py`` ``collect_seeds_kmer``
(its module docstring has the derivation): select the read's (k=14,
w=6) minimizers, look them up in the genome minimizer table to get
candidate diagonals, take per-diagonal match reaches, and derive the
SMEMs (round 1) and the LAST-like seeds (round 3) from the top-2 reach
statistics. Round 2 is proven empty or flagged ``needs_r2`` for the FM
machine's reseed entry; anything the fast path cannot hold exact is
flagged ``overflow``.

On CUDA tensors ``collect_seeds_kmer`` is one launch of the
hand-written kernel (``kernels/kmer_cuda.py``: a warp a read runs the
whole program), which raises rather than falls back; on CPU tensors it
runs the plain twin ``collect_seeds_kmer_plain``, the stages as eager
torch ops vectorized over reads, bit-equal to the kernel. The TPU
version compares the read against the text as packed 2-bit words to
avoid element gathers; the plain twin gathers the text codes directly,
which gives the same match mask. The host table builders are in
``bioseqdb_tpu_torch/index/layout.py``.
"""

from __future__ import annotations

import torch

from bioseqdb_tpu_torch.index.layout import K, WIN
from bioseqdb_tpu_torch.kernels.fm import M32, u32
from bioseqdb_tpu_torch.kernels.kmer_cuda import kmer_seed_cuda

_BIG = 0x7FFFFFFF
_UMAX = M32


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32), without int64 overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64; bit-equal to
    the host ``layout._mix32``."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def select_minimizers(h: torch.Tensor, NW: int) -> torch.Tensor:
    """selected[b, j]: j is the leftmost argmin of some length-WIN window
    of k-mer starts (run-length form, equal to the brute sliding argmin)."""
    B, NP = h.shape
    dev = h.device
    pos = torch.arange(NP, device=dev)
    runl = torch.ones(B, NP, dtype=torch.bool, device=dev)
    runr = runl.clone()
    L = torch.zeros(B, NP, dtype=torch.int32, device=dev)
    R = torch.zeros_like(L)
    pad = torch.nn.functional.pad
    for u in range(1, WIN):
        left = pad(h[:, :-u], (u, 0), value=0)
        runl = runl & (left > h) & (pos >= u)
        L = L + runl.to(torch.int32)
        right = pad(h[:, u:], (0, u), value=_UMAX)
        runr = runr & (right >= h) & (pos < NP - u)
        R = R + runr.to(torch.int32)
    j = pos[None, :]
    s_lo = torch.maximum((j - WIN + 1).clamp(min=0), j - L)
    s_hi = torch.minimum(j.clamp(max=NW - 1), j + R - WIN + 1)
    return s_lo <= s_hi


def doubled_codes(pac_rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Codes 0..3 of the doubled text at int64 positions (clamped into
    the packed table; callers mask positions outside [0, seq_len))."""
    flat = pac_rows.reshape(-1)
    word = u32(flat[(pos >> 4).clamp(0, flat.shape[0] - 1)])
    return (word >> (2 * (15 - (pos & 15)))) & 3


def match_reach(pac_rows, seq_len: int, codes, amb, diags, dvalid):
    """reach[b, d, p] = first read position >= p whose base fails to
    match the doubled text on diagonal d (W if none). Invalid diagonals
    give reach == p."""
    W = codes.shape[1]
    pos = torch.arange(W, device=codes.device)
    tref = diags.to(torch.int64)[:, :, None] + pos                # (B, D, W)
    inb = (tref >= 0) & (tref < seq_len)
    match = (doubled_codes(pac_rows, tref) == codes[:, None, :])
    match = match & ~amb[:, None, :] & dvalid[:, :, None] & inb
    nz = torch.where(match, 0x7FFF, pos.to(torch.int32))
    reach = torch.cummin(nz.flip(2), 2).values.flip(2)
    return reach.clamp(max=W).to(torch.int32)


def too_short(W: int) -> bool:
    """A batch of width ``W`` holds no >= 19 bp seed (no minimizer window)."""
    return W - K + 1 < 1 or W - K - WIN + 2 < 1


def _empty(B: int, M: int, dev) -> dict:
    """``collect_seeds_kmer``'s result for a batch too narrow to seed."""
    zm = torch.zeros(B, M, dtype=torch.int32, device=dev)
    zb = torch.zeros(B, dtype=torch.bool, device=dev)
    return dict(mem_pos=zm, mem_s=zm.clone(), mem_b=zm.clone(),
                mem_e=zm.clone(), n_mem=torch.zeros(B, dtype=torch.int32,
                                                    device=dev),
                needs_r2=zb, overflow=zb.clone())


def collect_seeds_kmer(bmeta, entries, pac_rows, seq_len: int, codes, lens,
                       bb: int, min_seed_len: int, split_len: int,
                       split_width: int, max_mem_intv: int, smax: int = 12,
                       dmax: int = 24, nmz: int = 64, max_mem: int = 16
                       ) -> dict:
    """Rounds 1 and 3 of BWA-MEM seeding from the minimizer table (see
    ``collect_seeds_kmer_plain``). On CUDA tensors one launch of the
    hand-written kernel (``kmer_cuda.kmer_seed_cuda``), on CPU tensors
    the plain twin."""
    B, W = codes.shape
    if too_short(W):
        return _empty(B, max_mem, codes.device)
    kw = dict(bb=bb, min_seed_len=min_seed_len, split_len=split_len,
              split_width=split_width, max_mem_intv=max_mem_intv, smax=smax,
              dmax=dmax, nmz=nmz, max_mem=max_mem)
    if not codes.is_cuda:
        return collect_seeds_kmer_plain(bmeta, entries, pac_rows, seq_len,
                                        codes, lens, **kw)
    return kmer_seed_cuda(bmeta, entries, pac_rows, seq_len,
                          codes.to(torch.int32).contiguous(),
                          lens.to(torch.int32).contiguous(), **kw)


def kmer_diagonals(bmeta, entries, codes, lens, bb: int, smax: int,
                   dmax: int, nmz: int) -> dict:
    """The plain twin's first stages on ``codes`` (int64 [B, W], W >= 19)
    and ``lens`` (int32 [B]): the read's k-mers, their minimizers
    compacted to ``min(nmz, NP)`` slots, the table lookups and the
    ``min(dmax, nmz_c * smax)`` smallest distinct diagonals. Returns
    mz_overflow, capped, d_overflow, diags (int32, ascending, _BIG past
    the last), dvalid, and what the lookups touched: mzok (the valid
    minimizers), cnt (each one's bucket count) and hits (a read's
    candidate diagonals before the dedup)."""
    B, W = codes.shape
    dev = codes.device
    i32, i64 = torch.int32, torch.int64
    zb = torch.zeros(B, dtype=torch.bool, device=dev)
    NP = W - K + 1
    NW = NP - WIN + 1

    # ---- read k-mers + minimizer selection ----
    valid = codes < 4
    km = torch.zeros(B, NP, dtype=i64, device=dev)
    kvalid = torch.ones(B, NP, dtype=torch.bool, device=dev)
    for t in range(K):
        km = (km << 2) | (codes[:, t : t + NP] & 3)
        kvalid = kvalid & valid[:, t : t + NP]
    posP = torch.arange(NP, device=dev)
    kvalid = kvalid & (posP[None, :] + K <= lens[:, None])
    h = torch.where(kvalid, mix32(km), _UMAX)
    sel = select_minimizers(h, NW)

    # compact selected positions (+ keys / validity) to nmz slots
    skey = torch.where(sel, posP.to(i32)[None, :], _BIG)
    skey_s, order = torch.sort(skey, dim=1, stable=True)
    km_s = torch.gather(km, 1, order)
    kval_s = torch.gather(kvalid, 1, order)
    nmz_c = min(nmz, NP)
    mzpos = skey_s[:, :nmz_c]
    mzkey = km_s[:, :nmz_c]
    mzok = (mzpos < _BIG) & kval_s[:, :nmz_c]
    mz_overflow = (skey_s[:, nmz_c] < _BIG) if NP > nmz_c else zb

    # ---- table lookups: bucket meta + one entry row ----
    low_bits = 2 * K - bb
    bkt = torch.where(mzok, mzkey >> low_bits, 0)
    bm = bmeta[bkt]
    o0 = bm >> 4
    cnt = bm & 15
    capped = mzok & (cnt > smax)
    nrows0 = (entries.shape[0] - 1) // 2
    col0 = o0 & 31
    use1 = col0 > 32 - smax
    row = torch.where(use1, nrows0 + ((o0 - 16) >> 5), o0 >> 5)
    col = torch.where(use1, col0 - 16, col0)
    erows = entries[row.long().clamp(0, entries.shape[0] - 1)]   # (B, n, 32)
    tt = col.long()[:, :, None] + torch.arange(smax, device=dev)
    aligned = torch.gather(erows, 2, tt.clamp(max=31))
    aligned = torch.where(tt < 32, aligned, 0)
    ev = u32(aligned)
    e_pos = (ev >> low_bits).to(i32)
    e_low = ev & ((1 << low_bits) - 1)
    t_ok = torch.arange(smax, device=dev)[None, None, :] < cnt[:, :, None]
    lowq = mzkey & ((1 << low_bits) - 1)
    hit = (mzok & ~capped)[:, :, None] & t_ok & (e_low == lowq[:, :, None])
    diag_all = torch.where(hit, e_pos - mzpos[:, :, None], _BIG)

    # ---- dedup diagonals: successive masked minima ----
    flat = diag_all.reshape(B, nmz_c * smax)
    DC = min(dmax, flat.shape[1])
    cur = torch.full((B,), -(1 << 30), dtype=i32, device=dev)
    dlist = []
    for _ in range(DC):
        nxt = torch.where(flat > cur[:, None], flat, _BIG).amin(1)
        dlist.append(nxt)
        cur = torch.where(nxt < _BIG, nxt, cur)
    diags = torch.stack(dlist, 1)
    dvalid = diags < _BIG
    d_overflow = torch.where(flat > cur[:, None], flat, _BIG).amin(1) < _BIG
    return dict(mz_overflow=mz_overflow, capped=capped,
                d_overflow=d_overflow, diags=diags, dvalid=dvalid, mzok=mzok,
                cnt=cnt, hits=hit.sum((1, 2)))


def collect_seeds_kmer_plain(
    bmeta: torch.Tensor,      # int32[2^bb]
    entries: torch.Tensor,    # int32[nrows0 + nrows1, 32]
    pac_rows: torch.Tensor,   # packed doubled rows (layout.pack_doubled_rows)
    seq_len: int,             # doubled text length
    codes: torch.Tensor,      # int[B, W] 0..3 bases, >= 4 ambiguous/padding
    lens: torch.Tensor,       # int32[B]
    bb: int,
    min_seed_len: int,
    split_len: int,
    split_width: int,
    max_mem_intv: int,
    smax: int = 12,
    dmax: int = 24,
    nmz: int = 64,
    max_mem: int = 16,
) -> dict:
    """Rounds 1 and 3 of BWA-MEM seeding from the minimizer table.

    Returns dict with mem_pos (doubled-text position of each s == 1
    seed), mem_s / mem_b / mem_e (occurrence count, query span), all
    int32[B, M]; n_mem int32[B]; needs_r2 (run the FM reseed entry),
    overflow (fall back to the FM seeder) and why (fallback-cause bits)."""
    B, W = codes.shape
    dev = codes.device
    i32, i64 = torch.int32, torch.int64
    M = max_mem
    msl = min_seed_len
    codes = codes.to(i64)
    lens = lens.to(i32)
    zb = torch.zeros(B, dtype=torch.bool, device=dev)
    if too_short(W):  # reads too short for any >= 19 bp seed
        return _empty(B, M, dev)

    dg = kmer_diagonals(bmeta, entries, codes, lens, bb, smax, dmax, nmz)
    mz_overflow, capped, d_overflow = (dg["mz_overflow"], dg["capped"],
                                       dg["d_overflow"])
    diags, dvalid, DC = dg["diags"], dg["dvalid"], dg["diags"].shape[1]

    # ---- per-diagonal reach -> top-2 statistics over diagonals ----
    amb = codes >= 4
    posW = torch.arange(W, device=dev, dtype=i32)[None, :]
    R1 = torch.zeros(B, W, dtype=i32, device=dev)
    I1 = torch.zeros_like(R1)
    R2 = torch.zeros_like(R1)
    cnt_r3 = torch.zeros_like(R1)   # occ([x, x+msl+1)) per position
    CH = 8
    for c0 in range(0, DC, CH):
        reach = match_reach(pac_rows, seq_len, codes, amb,
                            diags[:, c0 : c0 + CH], dvalid[:, c0 : c0 + CH])
        m1c = reach.amax(1)
        a1c = reach.argmax(1).to(i32)           # first max
        oh = (torch.arange(reach.shape[1], device=dev)[None, :, None]
              == a1c[:, None, :])
        m2c = torch.where(oh, -1, reach).amax(1)
        take_new = m1c > R1
        R2 = torch.maximum(torch.minimum(R1, m1c), torch.maximum(R2, m2c))
        I1 = torch.where(take_new, a1c + c0, I1)
        R1 = torch.maximum(R1, m1c)
        cnt_r3 = cnt_r3 + (reach >= posW[:, None, :] + msl + 1).sum(1,
                                                                   dtype=i32)
    R1 = torch.maximum(R1, posW)    # no diagonal: empty reach
    R2 = torch.maximum(R2, posW)
    d1 = torch.gather(diags, 1, I1.long())     # argmax diagonal, (B, W)

    # ---- round 1: SMEMs = strict increases of E = R1 ----
    E = R1
    Eprev = torch.nn.functional.pad(E[:, :-1], (1, 0), value=-1)
    emit1 = (E > Eprev) & (E - posW >= msl)
    multi1 = emit1 & (R2 >= E)     # occurrence count >= 2: needs SA order
    slot1 = torch.cumsum(emit1.to(i32), 1) - 1
    n_r1 = emit1.sum(1, dtype=i32)
    dst = torch.where(emit1 & (slot1 < M), slot1, M).long()

    def put(v):
        out = torch.zeros(B, M + 1, dtype=i32, device=dev)
        out.scatter_(1, dst, v.to(i32).expand(B, W).contiguous())
        return out[:, :M]

    mem_b = put(posW)
    mem_e = put(E)
    mem_pos = put(d1 + posW)
    mem_s = put(torch.ones(1, W, dtype=i32, device=dev))
    r1_overflow = n_r1 > M

    # ---- round 2 certificate: an occ >= 2 window of length msl through
    # a reseed pivot? ----
    rep = R2 >= posW + msl
    last_rep = torch.cummax(torch.where(rep, posW, -1), 1).values
    mm = torch.arange(M, device=dev)[None, :]
    is_mem = mm < n_r1[:, None]
    trigger = is_mem & (mem_e - mem_b >= split_len) & (mem_s <= split_width)
    pivot = ((mem_b + mem_e) >> 1).clamp(0, W - 1)
    lr_at = torch.gather(last_rep, 1, pivot.long())
    needs_r2 = (trigger & (lr_at >= 0) & (lr_at > pivot - msl)).any(1)

    # ---- round 3: deterministic successor chase ----
    n_mem = n_r1
    r3_multi = zb
    r3_stuck = zb
    if max_mem_intv > 0:
        endr = posW >= lens[:, None]
        rcummin = lambda x: torch.cummin(x.flip(1), 1).values.flip(1)
        namb = rcummin(torch.where(amb | endr, posW, _BIG)).clamp(max=W)
        nvalid = rcummin(torch.where(~amb & ~endr, posW, _BIG)).clamp(max=W)
        stop_i = posW + msl
        clean = namb > stop_i          # no invalid base in [x, x+msl]
        succ_v = torch.where(clean, stop_i + 1, namb + 1)
        emit_v = clean & (cnt_r3 >= 1)
        spos = torch.where(emit_v, d1 + posW, 0)
        T = W // (msl + 1) + 18
        cur = nvalid[:, 0].clamp(max=W)
        n = n_mem
        ovf3 = zb
        m3 = zb
        at = lambda tab, ix: torch.gather(tab, 1, ix.long()[:, None])[:, 0]
        for _ in range(T):
            live = cur < W
            curc = cur.clamp(0, W - 1)
            em = live & at(emit_v, curc)
            s_here = at(cnt_r3, curc)
            p_here = at(spos, curc)
            m3 = m3 | (em & (s_here >= 2))
            wr = em & (n < M)
            ovf3 = ovf3 | (em & (n >= M))
            ohm = (mm == n.clamp(max=M - 1)[:, None]) & wr[:, None]
            mem_pos = torch.where(ohm, p_here[:, None], mem_pos)
            mem_s = torch.where(ohm, s_here[:, None], mem_s)
            mem_b = torch.where(ohm, curc[:, None], mem_b)
            mem_e = torch.where(ohm, (curc + msl + 1)[:, None], mem_e)
            n = n + wr.to(i32)
            nx = at(succ_v, curc)
            nxv = at(nvalid, nx.clamp(0, W - 1))
            cur = torch.where(live, torch.where(nx >= W, W, nxv), W)
        r3_stuck = cur < W             # chase budget exhausted
        r3_multi = m3
        n_mem = n
        r1_overflow = r1_overflow | ovf3

    capped_any = capped.any(1)
    multi1_any = multi1.any(1)
    overflow = (mz_overflow | capped_any | d_overflow | multi1_any
                | r1_overflow | r3_multi | r3_stuck)
    bits = (mz_overflow, capped_any, d_overflow, multi1_any, r1_overflow,
            r3_multi, r3_stuck)
    why = sum(b.to(i32) << k for k, b in enumerate(bits))
    return dict(
        mem_pos=mem_pos, mem_s=mem_s, mem_b=mem_b, mem_e=mem_e,
        n_mem=n_mem, needs_r2=needs_r2 & ~overflow, overflow=overflow,
        why=why,
    )
