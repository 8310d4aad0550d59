"""Batched banded affine-gap extension (bwa ksw_extend): plain PyTorch.

The port of ``bioseqdb_tpu/kernels/sw.py`` ``sw_extend_batch``. The DP
runs row by row over the target with the query axis vectorized; F is a
prefix max of ``t_ins + e_ins * j``; the adaptive band, Z-drop, argmax
tie-breaks and the global score follow the scalar kernel bit for bit.

This is the plain version of the hand-written CUDA kernel in
``sw_cuda.py``: the CPU path and the tests use it, and ``chip_smoke.py``
holds the kernel against it on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -(1 << 30)
FIELDS = ("score", "qle", "tle", "gtle", "gscore", "max_off")


def sw_extend_batch(
    query: torch.Tensor,    # int32[B, max_qlen] codes 0..4
    qlen: torch.Tensor,     # int32[B]
    target: torch.Tensor,   # int32[B, max_tlen] codes 0..4
    tlen: torch.Tensor,     # int32[B]
    mat: torch.Tensor,      # int32[5, 5]
    o_del: int, e_del: int, o_ins: int, e_ins: int,
    w0: torch.Tensor,       # int32[B] band width per lane
    end_bonus: int, zdrop: int,
    h0: torch.Tensor,       # int32[B] initial score per lane
    max_qlen: int,
    count_cells: bool = False,
) -> dict:
    """Batched ksw_extend. Returns dict of int32[B]: score, qle, tle,
    gtle, gscore, max_off; with ``count_cells`` also ``cells``, int64[B]:
    the DP cells each lane computed (its in-band columns summed over its
    rows), the work a kernel must do on these inputs; ``rows``, int64[B]:
    the target rows each lane ran; and ``max_value``, int32[B]: the
    largest H, E or F any of its cells held (h0 at least), the range a
    kernel's arithmetic must hold."""
    B = query.shape[0]
    dev = query.device
    i32 = torch.int32
    max_tlen = target.shape[1]
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    jj = torch.arange(max_qlen, device=dev, dtype=i32)[None, :]
    qlen = qlen.to(i32)
    h0 = h0.to(i32)
    w_ = torch.where

    max_sc = int(mat.max())
    f32 = lambda x: x.to(torch.float32)
    max_ins = (f32(qlen * max_sc + end_bonus - o_ins) / float(e_ins)
               + 1.0).to(i32)
    max_del = (f32(qlen * max_sc + end_bonus - o_del) / float(e_del)
               + 1.0).to(i32)
    w = torch.minimum(w0.to(i32), max_ins.clamp(min=1))
    w = torch.minimum(w, max_del.clamp(min=1))

    h_first = w_(jj == 0, h0[:, None], h0[:, None] - oe_ins - e_ins * (jj - 1))
    h = w_((h_first > 0) & (jj < qlen[:, None] + 1), h_first, 0).to(i32)
    e = torch.zeros(B, max_qlen, dtype=i32, device=dev)
    # query profile: prof[b, c, j] = mat[c, query[b, j]]
    prof = mat.to(i32)[:, query.long()].permute(1, 0, 2)        # (B, 5, Q)

    z = torch.zeros(B, dtype=i32, device=dev)
    i, beg, end = z.clone(), z.clone(), qlen.clone()
    mx, max_i, max_j, max_ie = h0.clone(), z - 1, z - 1, z - 1
    gscore, max_off = z - 1, z.clone()
    active = (tlen > 0) & (qlen > 0)
    rows = torch.arange(B, device=dev)
    cells = torch.zeros(B, dtype=torch.int64, device=dev)
    n_rows = torch.zeros(B, dtype=torch.int64, device=dev)
    max_value = h0.clone()

    while bool(active.any()):
        beg_r = torch.maximum(beg, i - w)
        end_r = torch.minimum(torch.minimum(end, i + w + 1), qlen)
        tbase = target[rows, i.clamp(max=max_tlen - 1).long()]
        srow = prof[rows, tbase.clamp(0, 4).long()]             # (B, Q)
        in_band = (jj >= beg_r[:, None]) & (jj < end_r[:, None])
        if count_cells:
            cells += w_(active, (end_r - beg_r).clamp(min=0), 0)
            n_rows += active
        h1_bound = w_(beg_r == 0,
                      (h0 - (o_del + e_del * (i + 1))).clamp(min=0), 0)

        M = w_(in_band & (h != 0), h + srow, 0)
        e_cur = w_(in_band, e, 0)
        t_ins = (M - oe_ins).clamp(min=0)
        run = torch.cummax(w_(in_band, t_ins + e_ins * jj, NEG_INF), 1).values
        g = run - e_ins * jj
        f = torch.nn.functional.pad(g[:, :-1], (1, 0), value=NEG_INF)
        f = f.clamp(min=0)
        hrow = w_(in_band, torch.maximum(torch.maximum(M, e_cur), f), 0)
        e_next = w_(in_band, torch.maximum(e_cur - e_del,
                                           (M - oe_del).clamp(min=0)), 0)

        if count_cells:
            held = torch.maximum(torch.maximum(hrow, e_next), f)
            held = w_(in_band & active[:, None], held, -1).amax(1)
            max_value = torch.maximum(max_value, held)

        # row max; argmax ties take the LARGEST j
        hmask = w_(in_band, hrow, -1)
        m_best = hmask.amax(1).clamp(min=0)
        mj = max_qlen - 1 - hmask.flip(1).argmax(1).to(i32)
        mj = w_(m_best > 0, mj, -1)

        endm1 = (end_r - 1).clamp(min=0).long()
        h_end = torch.gather(hrow, 1, endm1.clamp(max=max_qlen - 1)[:, None])
        h_end = w_(endm1 < max_qlen, h_end[:, 0], 0)
        h_endm1 = w_(end_r > beg_r, h_end, h1_bound)

        # rolling h holds H(i, j-1); column beg takes the boundary
        hshift = torch.nn.functional.pad(hrow[:, :-1], (1, 0), value=0)
        in_be = (jj >= beg_r[:, None]) & (jj <= end_r[:, None])
        new_h = w_(jj == beg_r[:, None], h1_bound[:, None], hshift)
        new_h = w_(in_be, new_h, 0)

        better_g = active & (end_r == qlen) & (gscore <= h_endm1)
        gscore = w_(better_g, h_endm1, gscore)
        max_ie = w_(better_g, i, max_ie)

        improved = m_best > mx
        di = i - max_i
        dj = mj - max_j
        zd1 = mx - m_best - (di - dj) * e_del > zdrop
        zd2 = mx - m_best - (dj - di) * e_ins > zdrop
        break_z = ~improved & (zdrop > 0) & w_(di > dj, zd1, zd2)
        new_max_off = w_(improved, torch.maximum(max_off, (mj - i).abs()),
                         max_off)

        # band shrink to live cells of the updated rows, over [beg, end]
        live = ((new_h != 0) | (e_next != 0)) & in_be
        any_live = live.any(1)
        first_live = live.to(i32).argmax(1).to(i32)
        last_live = max_qlen - 1 - live.flip(1).to(i32).argmax(1).to(i32)
        new_beg = w_(any_live, first_live, end_r)
        new_end = w_(any_live, torch.minimum(last_live + 2, qlen),
                     torch.minimum(beg_r + 1, qlen))
        terminated = (m_best == 0) | break_z | (i + 1 >= tlen)

        a2 = active[:, None]
        h = w_(a2, new_h, h)
        e = w_(a2, e_next, e)
        max_i = w_(active & improved, i, max_i)
        max_j = w_(active & improved, mj, max_j)
        mx = w_(active & improved, m_best, mx)
        max_off = w_(active, new_max_off, max_off)
        beg = w_(active, new_beg, beg)
        end = w_(active, new_end, end)
        i = w_(active, i + 1, i)
        active = active & ~terminated

    out = dict(score=mx, qle=max_j + 1, tle=max_i + 1, gtle=max_ie + 1,
               gscore=gscore, max_off=max_off)
    if count_cells:
        out.update(cells=cells, rows=n_rows, max_value=max_value)
    return out
