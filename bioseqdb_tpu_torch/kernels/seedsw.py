"""Windowed seed re-scoring of long reads (bwa mem_flt_chained_seeds) on
torch tensors.

The port of ``bioseqdb_tpu/kernels/seedsw.py``: for reads long enough
that chain weights stop being selective (~>= 720 bp at the defaults),
every short seed (< 200 bp) is re-scored with a local affine-gap
Smith-Waterman over a +-50-base window and dropped below the min-HSP
score. Each seed's window is one 200-wide lane; the DP is the lazy-F
prefix-max local SW. On CUDA tensors ``seed_sw_filter`` is one launch of
the hand-written kernel (``kernels/seedsw_cuda.py``): the windows, the
need mask, the SW of the lanes that need it and the filter's outputs,
with each read length's activation and min_hsp read from
``activation_table`` (this module's torch expression, made once on the
device); it raises rather than falls back. On CPU tensors it runs the
plain twin ``seed_sw_filter_plain``: the windows and need mask as eager
torch ops (``seed_sw_windows``), then ``seed_sw_scores_plain`` (the
window gathers and ``local_sw_batch``: 200 rows of plain torch ops over
all the seeds that need it at once). The JAX version's barrel-shift
window extract and one-hot picks become gathers.

Statically absent for short-read batches: ``possibly_active`` is False
whenever no read of the batch width can trigger the filter.
"""

from __future__ import annotations

import math

import torch

from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels.extend import window_doubled
from bioseqdb_tpu_torch.kernels.seedsw_cuda import seed_sw_filter_cuda

# the oracle's constants (cpu/oracle.py, bwa's macros)
MEM_SHORT_EXT = 50
MEM_SHORT_LEN = 200
MEM_HSP_COEF = 1.1
MEM_MINSC_COEF = 5.5
MEM_SEEDSW_COEF = 0.05

_W = MEM_SHORT_LEN  # window lane width (query and target segments < 200)


def possibly_active(min_chain_weight: int, max_read_len: int) -> bool:
    """Whether any read of width <= max_read_len can trigger the filter
    (the oracle's ``seed_sw_filter_active`` guard; both sides of the
    inequality are monotone in the length, so the batch width decides)."""
    l = max_read_len
    if l <= 0:
        return False
    min_l = (MEM_HSP_COEF * min_chain_weight if min_chain_weight
             else MEM_MINSC_COEF * math.log(l))
    return min_l <= MEM_SEEDSW_COEF * l


def local_sw_batch(q: torch.Tensor, t: torch.Tensor, tlen: torch.Tensor,
                   match_score: int, mismatch_penalty: int, o_del: int,
                   e_del: int, o_ins: int, e_ins: int) -> torch.Tensor:
    """Best local SW score of each lane, q and t int32[N, _W] codes: the
    vectorized form of the oracle's ``local_sw_score`` (lazy-F prefix-max
    rows). Codes >= 4 score -1 against everything, and padding can only
    lower a local alignment, so the query needs no mask; target rows at
    or past ``tlen`` leave a lane as it is."""
    N = q.shape[0]
    dev = q.device
    i32 = torch.int32
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    jj = torch.arange(_W, device=dev, dtype=i32)[None, :]
    NEG = -(1 << 28)
    H = torch.zeros(N, _W, dtype=i32, device=dev)
    E = torch.zeros(N, _W, dtype=i32, device=dev)
    best = torch.zeros(N, dtype=i32, device=dev)
    q_ok = q < 4
    sa = torch.tensor(match_score, dtype=i32, device=dev)
    sb = torch.tensor(-mismatch_penalty, dtype=i32, device=dev)
    rows = int(tlen.max()) if N else 0
    for i in range(rows):
        ti = t[:, i : i + 1]
        both = (ti < 4) & q_ok
        srow = torch.where(both, torch.where(ti == q, sa, sb), -1)
        diag = torch.nn.functional.pad(H[:, :-1], (1, 0)) + srow
        E = torch.maximum(E - e_del, H - oe_del)
        hne = torch.maximum(torch.maximum(diag, E), torch.zeros_like(E))
        opener = torch.cummax(hne - oe_ins + e_ins * jj, 1).values
        F = torch.nn.functional.pad(opener[:, :-1], (1, 0), value=NEG) \
            - e_ins * jj
        Hn = torch.maximum(hne, F)
        ok = (i < tlen)[:, None]
        H = torch.where(ok, Hn, H)
        E = torch.where(ok, E, 0)
        best = torch.maximum(best, torch.where(ok[:, 0], Hn.amax(1), 0))
    return best


def read_activation(lens, match_score: int, min_chain_weight: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(active bool, min_hsp int32) of reads of lengths ``lens`` (the
    oracle's seed_sw_filter_active and min-HSP score), float32 as in the
    JAX version."""
    f32 = torch.float32
    min_l_r = (torch.full(lens.shape, MEM_HSP_COEF * min_chain_weight,
                          dtype=f32, device=lens.device) if min_chain_weight
               else MEM_MINSC_COEF * torch.log(lens.clamp(min=1).to(f32)))
    active_r = (lens > 0) & (min_l_r <= MEM_SEEDSW_COEF * lens.to(f32))
    min_hsp_r = (match_score * min_l_r + 0.499).to(torch.int32)
    return active_r, min_hsp_r


# activation_table's tables by (device, W, match_score, min_chain_weight)
_TABLES: dict = {}


def activation_table(W: int, match_score: int, min_chain_weight: int,
                     device) -> torch.Tensor:
    """int32 [W + 1, 2]: ``read_activation`` of every read length 0..W
    (active, min_hsp), computed on ``device`` by the same torch expression
    as ``seed_sw_windows``' (so the kernel never takes a float log) and
    kept for later calls."""
    key = (str(torch.device(device)), W, match_score, min_chain_weight)
    if key not in _TABLES:
        lens = torch.arange(W + 1, dtype=torch.int32, device=device)
        active, min_hsp = read_activation(lens, match_score, min_chain_weight)
        _TABLES[key] = torch.stack([active.to(torch.int32), min_hsp],
                                   1).contiguous()
    return _TABLES[key]


def seed_sw_windows(fm: kfm.FMDevice, lens, seeds: dict, match_score: int,
                    min_chain_weight: int) -> dict:
    """Each seed lane's query window [qb, qe) (int32 [N]), reference window
    [rb, re) ([N], the rank dtype), ``need`` (bool [N]: the lanes the SW
    re-scores) and ``min_hsp`` (int32 [N]), N = B * S, as the oracle's
    mem_seed_sw and seed_sw_filter_active bound them."""
    B, S = seeds["rbeg"].shape
    N = B * S
    i32 = torch.int32
    dev = lens.device
    seq_len, l_pac = fm.seq_len, fm.l_pac
    slen = seeds["len"].reshape(N)
    qbeg = seeds["qbeg"].reshape(N)
    rbeg = seeds["rbeg"].reshape(N)
    valid = seeds["valid"].reshape(N)
    L = lens.to(i32).repeat_interleave(S)

    active_r, min_hsp_r = read_activation(lens, match_score, min_chain_weight)
    active = active_r.repeat_interleave(S)
    min_hsp = min_hsp_r.repeat_interleave(S)

    # window bounds (the oracle's mem_seed_sw)
    qb0, qe0 = qbeg, qbeg + slen
    rb0, re0 = rbeg, rbeg + slen
    mid = (rb0 + re0) >> 1
    qb = (qb0 - MEM_SHORT_EXT).clamp(min=0)
    qe = torch.minimum(qe0 + MEM_SHORT_EXT, L)
    rb = (rb0 - MEM_SHORT_EXT).clamp(min=0)
    re = (re0 + MEM_SHORT_EXT).clamp(max=seq_len)
    crosses = (rb < l_pac) & (l_pac < re)
    re = torch.where(crosses & (mid < l_pac), l_pac, re)
    rb = torch.where(crosses & (mid >= l_pac), l_pac, rb)
    # shrink to the reference holding mid, on its strand
    fwd = mid < l_pac
    rid = kfm.rid_of(fm, torch.where(fwd, mid, seq_len - 1 - mid)).long()
    rid = rid.clamp(0, fm.ref_offsets.shape[0] - 1)
    off = fm.ref_offsets[rid]
    end = off + fm.ref_lens[rid]
    rb = torch.where(fwd, torch.maximum(rb, off),
                     torch.maximum(rb, seq_len - end))
    re = torch.where(fwd, torch.minimum(re, end),
                     torch.minimum(re, seq_len - off))

    need = (active & valid & (slen < MEM_SHORT_LEN)
            & ((qe - qb) < MEM_SHORT_LEN) & ((re - rb) < MEM_SHORT_LEN)
            & (re > rb) & (qe > qb))
    return dict(qb=qb.to(i32), qe=qe.to(i32), rb=rb, re=re, need=need,
                min_hsp=min_hsp)


def seed_sw_scores_plain(pac_rows, seq_len: int, codes, win: dict,
                         match_score: int, mismatch_penalty: int, o_del: int,
                         e_del: int, o_ins: int, e_ins: int) -> torch.Tensor:
    """The best local SW score of each lane of ``win`` (``seed_sw_windows``)
    that needs it, 0 elsewhere (int32 [N]): the query window's codes of
    read lane // S against the doubled text's window, by
    ``local_sw_batch`` on the lanes that need it only."""
    qb, qe, rb, re, need = (win[k] for k in ("qb", "qe", "rb", "re", "need"))
    N = need.shape[0]
    B, W = codes.shape
    S = N // B if B else 1
    dev = codes.device
    lane = torch.nonzero(need)[:, 0]
    cols = torch.arange(_W, device=dev)[None, :]
    qcol = qb[lane].long()[:, None] + cols
    qseg = codes.reshape(-1)[(lane // S)[:, None] * W + qcol.clamp(max=W - 1)]
    qseg = torch.where((qcol < W) & (cols < (qe - qb)[lane][:, None]),
                       qseg, 4).to(torch.int32)
    tseg = window_doubled(pac_rows, seq_len, rb[lane].long()[:, None] + cols)
    score = torch.zeros(N, dtype=torch.int32, device=dev)
    score[lane] = local_sw_batch(qseg, tseg, (re - rb)[lane].to(torch.int32),
                                 match_score, mismatch_penalty, o_del, e_del,
                                 o_ins, e_ins)
    return score


def seed_sw_filter(fm: kfm.FMDevice, pac_rows, codes, lens, seeds: dict,
                   match_score: int, mismatch_penalty: int, o_del: int,
                   e_del: int, o_ins: int, e_ins: int,
                   min_chain_weight: int) -> dict:
    """Re-score the short seeds of long reads and drop the sub-HSP ones
    (see ``seed_sw_filter_plain``): on CUDA tensors one launch of the
    hand-written kernel (``seedsw_cuda.seed_sw_filter_cuda``; codes and
    lens int32, qbeg and len int32, rbeg in the rank dtype, each length
    at most the batch width), on CPU tensors the plain twin."""
    if not codes.is_cuda:
        return seed_sw_filter_plain(fm, pac_rows, codes, lens, seeds,
                                    match_score, mismatch_penalty, o_del,
                                    e_del, o_ins, e_ins, min_chain_weight)
    table = activation_table(codes.shape[1], match_score, min_chain_weight,
                             codes.device)
    valid, score = seed_sw_filter_cuda(
        fm, pac_rows, codes, lens, seeds, table, match_score,
        mismatch_penalty, o_del, e_del, o_ins, e_ins)
    return dict(seeds, valid=valid, score=score)


def seed_sw_filter_plain(fm: kfm.FMDevice, pac_rows, codes, lens,
                         seeds: dict, match_score: int, mismatch_penalty: int,
                         o_del: int, e_del: int, o_ins: int, e_ins: int,
                         min_chain_weight: int) -> dict:
    """Re-score the short seeds of long reads and drop the sub-HSP ones.

    Returns the seeds dict with ``valid`` pruned and a ``score`` column
    added (bwa's s->score: the SW score where checked, len * a
    otherwise), which ``extend_all`` orders seeds by. Reads below the
    length threshold keep every seed, scored len * a."""
    B, S = seeds["rbeg"].shape
    win = seed_sw_windows(fm, lens, seeds, match_score, min_chain_weight)
    score = seed_sw_scores_plain(pac_rows, fm.seq_len, codes, win,
                                 match_score, mismatch_penalty, o_del, e_del,
                                 o_ins, e_ins)
    need = win["need"]
    keep = ~need | (score >= win["min_hsp"])
    slen = seeds["len"].reshape(B * S)
    out = dict(seeds)
    out["valid"] = (seeds["valid"].reshape(B * S) & keep).reshape(B, S)
    out["score"] = torch.where(need, score, slen * match_score
                               ).reshape(B, S).to(torch.int32)
    return out
