"""Batched FM-index rank queries on torch tensors.

The port of ``bioseqdb_tpu/kernels/fm.py``. Rank values take the
index's rank dtype (``FMDevice.rank_dtype``): int32 below 2^31 doubled
bases, int64 from there (``layout.rank_dtype_for``), while the packed
tables stay int32 at any size. Every function here returns ranks in the
rank dtype, and the scalar fields (``primary``, ``l_pac``, ``seq_len``)
are Python ints, so rank tensors must already hold that dtype before
they meet them. The one-hot ``dense.py`` picks of
the TPU version become plain indexing and ``torch.gather``; 32-bit
unsigned word arithmetic runs in int64 masked to 32 bits (torch has no
uint32 shifts or popcount). Out-of-range row indices are clamped, as
XLA's gathers clamp them, so garbage lanes read what the JAX version
reads.

Sharded queries (``dist/shard_index.py``): every query takes ``group``,
a process group whose ranks each hold one row range of the packed tables
(``blocks``, ``sa_cnt``, ``sa_words``) and all of the small ones, where
the JAX version takes ``axis``. A rank reads a row only where it owns it
(``_table_row``: the global row less the shard's base, clamped to the
shard, with a ``mine`` mask), and the masked values are summed over the
group (``_owner_sum``: one ``all_reduce``), so each value is its
owner's. ``group=None`` is the single-device code. Every rank of a
group must make the same queries in the same order on the same shapes.
``COLLECTIVES`` counts the owner sums (calls, bytes; seconds when
``reset_collectives(timed=True)`` asks), as ``build.LAUNCHES`` counts
kernel launches.

The two device loops here, ``sa_resolve`` and ``backward_search``, are
one launch each of ``csrc/fm.cu``'s kernels on CUDA tensors without a
group (``kernels/fm_cuda.py``: a thread a lane runs every step), which
raise rather than fall back; on CPU tensors, and under a group, whose
every step is an owner sum, they run their plain twins
``sa_resolve_plain`` and ``backward_search_plain``, the loops as eager
ops, bit-equal to the kernels.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from bioseqdb_tpu_torch.index import layout
from bioseqdb_tpu_torch.index.fmindex import MAJOR_BLOCKS, OCC_BLOCK, FMIndex
from bioseqdb_tpu_torch.kernels.fm_cuda import (backward_search_cuda,
                                                sa_resolve_cuda)

LOG2_OCC_BLOCK = 7
LOG2_MAJOR = MAJOR_BLOCKS.bit_length() - 1
M32 = 0xFFFFFFFF

# mask of the first v bases of a packed big-endian word, v in [0, 16]
_MASK_TABLE = [((0x55555555 << (2 * (16 - v))) & M32) if v else 0
               for v in range(17)]


class FMDevice(NamedTuple):
    """FM-index tensors on one device (``bioseqdb_tpu`` FMDevice layout;
    the scalar fields as Python ints). "rank" is the rank dtype."""

    L2: torch.Tensor          # (5,) rank
    blocks: torch.Tensor      # (n_blocks/8, 128) int32 octo rows
    sa_sample: torch.Tensor   # (n_marked,) rank
    sa_cnt: torch.Tensor      # (nb,) int32
    sa_words: torch.Tensor    # (nb*4,) int32
    occ_majors: torch.Tensor  # (nm, 4) rank
    sa_majors: torch.Tensor   # (nm2,) rank
    ref_offsets: torch.Tensor  # (n_refs,) rank
    ref_lens: torch.Tensor    # (n_refs,) rank
    occ_rows: torch.Tensor    # (n_blocks, 12) int32: blocks[:, :96] as rows
    primary: int
    l_pac: int
    seq_len: int

    @classmethod
    def from_tables(cls, t: dict) -> "FMDevice":
        """From ``layout.to_device(layout.fm_tables(idx))`` (or
        ``tables_from_host``, which holds the same fields)."""
        scalars = ("primary", "l_pac", "seq_len")
        return cls(
            **{k: t[k] for k in layout.FM_FIELDS if k not in scalars},
            **{k: int(t[k]) for k in scalars},
            occ_rows=t["blocks"][:, :96].reshape(-1, 12).contiguous(),
        )

    @classmethod
    def from_host(cls, idx: FMIndex, device, rank_dtype=None
                  ) -> "FMDevice":
        """``idx``'s tables on ``device``, ranks in ``rank_dtype`` (None:
        int64 from 2^31 doubled bases, else int32; ``torch.int64``
        forces int64 on any index)."""
        return cls.from_tables(layout.to_device(
            layout.fm_tables(idx, rank_dtype), device))

    @property
    def rank_dtype(self) -> torch.dtype:
        return self.sa_sample.dtype


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> their uint32 value, in int64."""
    return x.to(torch.int64) & M32


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2^32)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & M32) >> 24


def _clamped(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with idx clamped into range (XLA gather semantics)."""
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def _local_row(idx: torch.Tensor, rows: int, group=None):
    """(row indices into a table of ``rows`` rows, clamped; mine). With
    ``group`` the table holds this rank's row range (equal row counts a
    shard): the index is the global row less the shard's base, and
    ``mine`` is False off the shard, where the caller's value must go
    through ``_owner_sum``. Without, ``mine`` is None."""
    idx = idx.long()
    if group is None:
        return idx.clamp(0, rows - 1), None
    local = idx - dist.get_rank(group) * rows
    return local.clamp(0, rows - 1), (local >= 0) & (local < rows)


def _table_row(table: torch.Tensor, idx: torch.Tensor, group=None):
    """(table[idx] clamped, mine) as ``_local_row`` gives them."""
    local, mine = _local_row(idx, table.shape[0], group)
    return table[local], mine


# owner sums made since ``reset_collectives``: the all_reduce calls, the
# bytes they sum and, when the reset asked for it, their seconds, each
# timed between two device synchronisations (a tool's clock; off, the
# counting costs two integer adds a call)
COLLECTIVES = dict(calls=0, bytes=0, seconds=0.0)
_timed = False


def reset_collectives(timed: bool = False) -> None:
    """Zero ``COLLECTIVES``; ``timed`` clocks every owner sum from here
    to the next reset."""
    global _timed
    COLLECTIVES.update(calls=0, bytes=0, seconds=0.0)
    _timed = timed


def _all_reduce(buf: torch.Tensor, group) -> None:
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += buf.numel() * buf.element_size()
    if not _timed:
        dist.all_reduce(buf, group=group)
        return
    if buf.is_cuda:
        torch.cuda.synchronize(buf.device)
    t0 = time.perf_counter()
    dist.all_reduce(buf, group=group)
    if buf.is_cuda:
        torch.cuda.synchronize(buf.device)
    COLLECTIVES["seconds"] += time.perf_counter() - t0


def _owner_sums(pairs, group=None) -> list[torch.Tensor]:
    """Each (value, mine) pair's value where this rank owns it, summed
    over ``group`` in ONE ``all_reduce`` (values of one shape, each
    returned in its own dtype): each value is its owner's. The values
    unchanged without a group."""
    if group is None:
        return [v for v, _ in pairs]
    dt = pairs[0][0].dtype
    for v, _ in pairs[1:]:
        dt = torch.promote_types(dt, v.dtype)
    parts = []
    for v, mine in pairs:
        while mine.ndim < v.ndim:
            mine = mine[..., None]
        parts.append(torch.where(mine, v.to(dt), 0))
    buf = torch.stack(parts)
    _all_reduce(buf, group)
    return [b.to(v.dtype) for b, (v, _) in zip(buf, pairs)]


def _owner_sum(val: torch.Tensor, mine, group=None) -> torch.Tensor:
    return _owner_sums([(val, mine)], group)[0]


def _block_row(fm: FMDevice, blk: torch.Tensor, group=None):
    """(the 12-int32 Occ block ``blk``, mine): octo row ``blk >> 3``
    (clamped; with ``group``, in this rank's shard), sub-block
    ``blk & 7``."""
    blk = blk.long()
    octo, mine = _local_row(blk >> 3, fm.blocks.shape[0], group)
    return fm.occ_rows[octo * 8 + (blk & 7)], mine


def _row_counts(row: torch.Tensor, c: torch.Tensor, r: torch.Tensor
                ) -> torch.Tensor:
    """Count of code ``c`` within the first ``r`` bases of block rows
    ``row`` (..., 12); c and r broadcast to row[..., 0]."""
    words = u32(row[..., 4:])                                  # (..., 8)
    pat = (c.to(torch.int64) * 0x55555555)[..., None]
    x = words ^ pat
    y = ~(x | (x >> 1)) & 0x55555555
    v = (r.to(torch.int64)[..., None]
         - 16 * torch.arange(8, device=row.device)).clamp(0, 16)
    mask = torch.tensor(_MASK_TABLE, dtype=torch.int64, device=row.device)[v]
    return popcount32(y & mask).sum(-1).to(torch.int32)


def _occ_major_rows(fm: FMDevice, blk: torch.Tensor) -> torch.Tensor:
    m = (blk.long() >> LOG2_MAJOR).clamp(0, fm.occ_majors.shape[0] - 1)
    return fm.occ_majors[m]                                     # (..., 4)


def occ_stored(fm: FMDevice, c: torch.Tensor, j: torch.Tensor, group=None
               ) -> torch.Tensor:
    """Count of code c in the stored BWT prefix [0, j). The major
    checkpoint depends on the global block alone: it stays outside the
    owner sum."""
    blk = j >> LOG2_OCC_BLOCK
    r = j & (OCC_BLOCK - 1)
    row, mine = _block_row(fm, blk, group)
    c = c.long()
    ckpt = torch.gather(row[..., :4], -1, c[..., None])[..., 0]
    major = torch.gather(_occ_major_rows(fm, blk), -1, c[..., None])[..., 0]
    return _owner_sum(ckpt + _row_counts(row, c, r), mine, group) + major


def occB(fm: FMDevice, c: torch.Tensor, r: torch.Tensor, group=None
         ) -> torch.Tensor:
    """Count of code c in the conceptual BWT prefix B[0, r) (skips $)."""
    return occ_stored(fm, c, r - (r > fm.primary).to(r.dtype), group)


def occ4_from_row(fm: FMDevice, row: torch.Tensor, blk: torch.Tensor,
                  off: torch.Tensor, mine=None, group=None) -> torch.Tensor:
    """occ4 at a stored position from its already-fetched Occ block row
    (blk = j >> 7, off = j & 127; ``mine`` from the fetch). Shape
    (..., 4)."""
    cs = torch.arange(4, device=row.device)
    cnt = _row_counts(row[..., None, :], cs, off[..., None])
    return (_owner_sum(row[..., :4] + cnt, mine, group)
            + _occ_major_rows(fm, blk))


def occ_rows_for(fm: FMDevice, r: torch.Tensor, group=None):
    """Fetch the Occ block rows holding the conceptual-prefix positions
    ``r`` in one gather; returns (row12, blk, off, mine) for
    ``occ4_from_row``."""
    j = r - (r > fm.primary).to(r.dtype)
    blk = j >> LOG2_OCC_BLOCK
    row, mine = _block_row(fm, blk, group)
    return row, blk, (j & (OCC_BLOCK - 1)).to(torch.int32), mine


def occ4B(fm: FMDevice, r: torch.Tensor, group=None) -> torch.Tensor:
    return occ4_from_row(fm, *occ_rows_for(fm, r, group), group=group)


def backward_ext(fm: FMDevice, lo, hi, c, group=None):
    """Extend pattern interval [lo, hi) by prepending code c."""
    C = fm.L2[c.long()] + 1
    both = occB(fm, torch.cat([c, c]), torch.cat([lo, hi]), group)
    n = lo.shape[0]
    return C + both[:n], C + both[n:]


def backward_search(fm: FMDevice, codes: torch.Tensor, lens: torch.Tensor,
                    group=None):
    """Exact-match intervals of a batch of reads: codes int32 [B, W]
    (0..3 bases, >= 4 ambiguous), lens int32 [B]. Returns (lo, hi) [B]
    in the rank dtype; the empty interval (0, 0) on no match, an
    ambiguous base or an empty read. On CUDA tensors without a group one
    launch of ``csrc/fm.cu``'s kernel (``fm_cuda``), which raises rather
    than fall back; on CPU tensors, and under a group (every step an
    owner sum, which no launch holds), the plain twin."""
    if codes.device.type != "cuda" or group is not None:
        return backward_search_plain(fm, codes, lens, group)
    return backward_search_cuda(fm, codes.to(torch.int32).contiguous(),
                                lens.to(torch.int32).contiguous())


def backward_search_plain(fm: FMDevice, codes: torch.Tensor,
                          lens: torch.Tensor, group=None,
                          touched: dict | None = None):
    """``backward_search``'s plain twin, on any device: W steps of eager
    ops, a column a step. ``touched`` (``tools/fm_calls.py``
    ``FmCall.touched``'s dict of per-row flags) gets the Occ and major rows the live steps read, and
    the steps and columns they take."""
    B, W = codes.shape
    lens = lens.to(torch.int32)
    lo = torch.zeros(B, dtype=fm.rank_dtype, device=codes.device)
    hi = torch.full((B,), fm.seq_len + 1, dtype=fm.rank_dtype,
                    device=codes.device)
    for t in range(W):
        # column lens-1-t (right to left); masked once t >= lens
        idx = (lens - 1 - t).clamp(0, W - 1).long()
        c = torch.gather(codes, 1, idx[:, None])[:, 0]
        live = t < lens
        active = live & (lo < hi) & (c < 4)
        if touched is not None:
            _touch_occ(fm, touched, torch.cat([lo, hi]),
                       torch.cat([active, active]))
            touched["steps"] += active.sum()
            touched["columns"] += (live & (lo < hi)).sum()
        nlo, nhi = backward_ext(fm, lo, hi, c.clamp(0, 3), group)
        bad = live & (c >= 4)       # an ambiguous base kills the match
        lo = torch.where(active, nlo, torch.where(bad, 1, lo))
        hi = torch.where(active, nhi, torch.where(bad, 1, hi))
    empty = (hi <= lo) | (lens == 0)
    return torch.where(empty, 0, lo), torch.where(empty, 0, hi)


def _touch_occ(fm: FMDevice, touched: dict, r: torch.Tensor,
               live: torch.Tensor) -> None:
    """Mark the Occ block rows and major rows that the occ queries at
    conceptual ranks ``r`` read, on the ``live`` lanes."""
    j = r - (r > fm.primary).to(r.dtype)
    blk = (j >> LOG2_OCC_BLOCK).long()
    octo, _ = _local_row(blk >> 3, fm.blocks.shape[0])
    _touch(touched["occ"], octo * 8 + (blk & 7), live)
    m = (blk >> LOG2_MAJOR).clamp(0, fm.occ_majors.shape[0] - 1)
    _touch(touched["major"], m, live)


def _touch(flags: torch.Tensor, rows: torch.Tensor, live: torch.Tensor
           ) -> None:
    """flags[rows[live]] = True, without a host wait: dead lanes mark the
    spare last flag."""
    flags[torch.where(live, rows, flags.shape[0] - 1)] = True


def fmd_extend_from_occ(fm: FMDevice, k, l, s, o1, o2):
    """FMD backward extension (bwa bwt_extend, is_back=1) from the occ4
    counts at ``k`` and ``k + s``; returns (k4, l4, s4) of (..., 4)."""
    cnt = o2 - o1
    k4 = (fm.L2[:4] + 1) + o1
    dollar = ((k <= fm.primary) & (fm.primary < k + s)).to(torch.int32)
    rc = cnt.flip(-1)
    suffix = (torch.cumsum(rc, -1) - rc).flip(-1).to(cnt.dtype)
    l4 = (l + dollar)[..., None] + suffix
    return k4.to(cnt.dtype), l4.to(cnt.dtype), cnt


def fmd_extend_back(fm: FMDevice, k, l, s, group=None):
    """FMD bi-interval backward extension for all 4 codes."""
    both = occ4B(fm, torch.cat([k.reshape(-1), (k + s).reshape(-1)]), group)
    n = k.numel()
    o1 = both[:n].reshape(k.shape + (4,))
    o2 = both[n:].reshape(k.shape + (4,))
    return fmd_extend_from_occ(fm, k, l, s, o1, o2)


def fmd_extend_fwd(fm: FMDevice, k, l, s, group=None):
    """FMD forward extension: bi-intervals of P+c for each code c."""
    k4, l4, s4 = fmd_extend_back(fm, l, k, s, group)
    return l4.flip(-1), k4.flip(-1), s4.flip(-1)


def _sa_mark_bit(fm: FMDevice, r: torch.Tensor, group=None):
    """(the mark bit of each rank as int64: whether it carries a sampled
    SA value, mine), before the owner sum."""
    w, mine = _table_row(fm.sa_words, r >> 5, group)
    return (u32(w) >> (r & 31).long()) & 1, mine


def _sa_slot(fm: FMDevice, r: torch.Tensor, group=None) -> torch.Tensor:
    """Number of marked ranks before each rank (its sa_sample slot). The
    popcount part and the count go through one owner sum; the major
    depends on the global row alone and stays outside it."""
    r5 = (r >> 7).long()
    widx = torch.arange(4, device=r.device)
    wraw, mine_w = _table_row(fm.sa_words, (r5 * 4)[..., None] + widx, group)
    cnt, mine_c = _table_row(fm.sa_cnt, r5, group)
    w = ((r >> 5) & 3).long()
    bits = (r & 31).long()
    nbits = torch.where(widx < w[..., None], 32,
                        torch.where(widx == w[..., None], bits[..., None], 0))
    mask = (1 << nbits) - 1            # int64: nbits = 32 is exact
    if mine_w is not None:
        mask = torch.where(mine_w, mask, 0)
    part = popcount32(u32(wraw) & mask).sum(-1).to(torch.int32)
    if group is not None:
        # the part is masked word by word above; the count by its row
        part, cnt = _owner_sums([(part, torch.ones_like(mine_c)),
                                 (cnt, mine_c)], group)
    major = _clamped(fm.sa_majors, r5 >> LOG2_MAJOR)
    return part + cnt + major


def _lf_value(fm: FMDevice, r: torch.Tensor, group=None):
    """(LF of each rank, mine), before the owner sum. The major
    checkpoint rides inside the sum: ``c`` is decoded from the row, a
    dummy on a rank that does not own it, so a major added after the
    sum would mix in every rank's own c (the JAX version's lf_step)."""
    j = r - (r > fm.primary).to(r.dtype)
    blk = j >> LOG2_OCC_BLOCK
    off = (j & (OCC_BLOCK - 1)).long()
    row, mine = _block_row(fm, blk, group)
    word = u32(torch.gather(row[..., 4:], -1, (off >> 4)[..., None])[..., 0])
    c = (word >> (2 * (15 - (off & 15)))) & 3
    ckpt = torch.gather(row[..., :4], -1, c[..., None])[..., 0]
    major = torch.gather(_occ_major_rows(fm, blk), -1, c[..., None])[..., 0]
    return fm.L2[c] + ckpt + _row_counts(row, c, off) + 1 + major, mine


def lf_step(fm: FMDevice, r: torch.Tensor, group=None) -> torch.Tensor:
    """One LF step: rank of the suffix at position SA[r] - 1."""
    lf = _owner_sum(*_lf_value(fm, r, group), group)
    return torch.where(r == fm.primary, 0, lf).to(r.dtype)


def sa_resolve(fm: FMDevice, ranks: torch.Tensor, sa_interval: int = 32,
               group=None, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Resolve conceptual ranks to doubled-text positions: at most
    ``sa_interval - 1`` LF steps to a marked rank. ``mask`` (bool, the
    ranks' shape): only its lanes walk, the others give 0. On CUDA
    tensors without a group one launch of ``csrc/fm.cu``'s kernel
    (``fm_cuda``), which raises rather than fall back; on CPU tensors,
    and under a group (every step an owner sum, which no launch holds),
    the plain twin."""
    r = ranks.to(fm.rank_dtype)
    if r.device.type != "cuda" or group is not None:
        return sa_resolve_plain(fm, r, sa_interval, group, mask)
    m = None if mask is None else mask.reshape(-1).contiguous()
    return sa_resolve_cuda(fm, r.reshape(-1).contiguous(), sa_interval,
                           m).reshape(r.shape)


def sa_resolve_plain(fm: FMDevice, ranks: torch.Tensor, sa_interval: int = 32,
                     group=None, mask: torch.Tensor | None = None,
                     touched: dict | None = None) -> torch.Tensor:
    """``sa_resolve``'s plain twin, on any device: ``sa_interval - 1``
    steps of eager ops over every lane. Under a group a step's mark test
    and LF share one owner sum. ``touched`` (``tools/fm_calls.py``
    ``FmCall.touched``'s dict of per-row flags) gets the rows the walking lanes read: a mark word
    each step, an Occ and a major row each step that moves, and the
    slot's mark words, count, major and sample at the end; and the
    steps."""
    r = ranks.to(fm.rank_dtype)
    steps = torch.zeros_like(r)
    if touched is not None:
        lanes = torch.ones_like(r, dtype=torch.bool) if mask is None else mask
        walk = lanes
    for _ in range(sa_interval - 1):
        bit, lf = _owner_sums([_sa_mark_bit(fm, r, group),
                               _lf_value(fm, r, group)], group)
        if touched is not None:
            moved = walk & ~bit.bool()
            _touch(touched["mark"], (r >> 5).long().clamp(
                0, fm.sa_words.shape[0] - 1), walk)
            _touch_occ(fm, touched, r, moved)
            touched["steps"] += moved.sum()
            walk = moved
        r = torch.where(bit.bool(), r,
                        torch.where(r == fm.primary, 0, lf).to(r.dtype))
        steps = torch.where(bit.bool(), steps, steps + 1)
    slot = _sa_slot(fm, r, group)
    if touched is not None:
        r5 = (r >> 7).long()
        widx = torch.arange(4, device=r.device)
        _touch(touched["mark"], (r5[..., None] * 4 + widx).clamp(
            0, fm.sa_words.shape[0] - 1), lanes[..., None].expand(
                *lanes.shape, 4))
        _touch(touched["cnt"], r5.clamp(0, fm.sa_cnt.shape[0] - 1), lanes)
        _touch(touched["sa_major"], (r5 >> LOG2_MAJOR).clamp(
            0, fm.sa_majors.shape[0] - 1), lanes)
        _touch(touched["sample"], slot.long().clamp(
            0, fm.sa_sample.shape[0] - 1), lanes)
    pos = _clamped(fm.sa_sample, slot) + steps
    return pos if mask is None else torch.where(mask, pos, 0)


def depos(fm: FMDevice, pos: torch.Tensor, length):
    """Doubled-text position -> (forward position, is_reverse)."""
    is_rev = pos >= fm.l_pac
    fwd = torch.where(is_rev, fm.seq_len - pos - length, pos)
    return fwd, is_rev


def rid_of(fm: FMDevice, fwd_pos: torch.Tensor) -> torch.Tensor:
    """Reference row index for forward positions."""
    v = fwd_pos.to(fm.ref_offsets.dtype).contiguous()
    return (torch.searchsorted(fm.ref_offsets, v, right=True)
            .to(torch.int32) - 1)

