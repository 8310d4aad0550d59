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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bioseqdb_tpu_torch.index import layout
from bioseqdb_tpu_torch.index.fmindex import MAJOR_BLOCKS, OCC_BLOCK, FMIndex

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


def _block_row(fm: FMDevice, blk: torch.Tensor) -> torch.Tensor:
    """The 12-int32 Occ block ``blk``: octo row ``blk >> 3`` (clamped),
    sub-block ``blk & 7``."""
    blk = blk.long()
    nrow = fm.blocks.shape[0]
    return fm.occ_rows[(blk >> 3).clamp(0, nrow - 1) * 8 + (blk & 7)]


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


def occ_stored(fm: FMDevice, c: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Count of code c in the stored BWT prefix [0, j)."""
    blk = j >> LOG2_OCC_BLOCK
    r = j & (OCC_BLOCK - 1)
    row = _block_row(fm, blk)
    c = c.long()
    ckpt = torch.gather(row[..., :4], -1, c[..., None])[..., 0]
    major = torch.gather(_occ_major_rows(fm, blk), -1, c[..., None])[..., 0]
    return ckpt + _row_counts(row, c, r) + major


def occB(fm: FMDevice, c: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Count of code c in the conceptual BWT prefix B[0, r) (skips $)."""
    return occ_stored(fm, c, r - (r > fm.primary).to(r.dtype))


def occ4_from_row(fm: FMDevice, row: torch.Tensor, blk: torch.Tensor,
                  off: torch.Tensor) -> torch.Tensor:
    """occ4 at a stored position from its already-fetched Occ block row
    (blk = j >> 7, off = j & 127). Shape (..., 4)."""
    cs = torch.arange(4, device=row.device)
    cnt = _row_counts(row[..., None, :], cs, off[..., None])
    return row[..., :4] + cnt + _occ_major_rows(fm, blk)


def occ_rows_for(fm: FMDevice, r: torch.Tensor):
    """Fetch the Occ block rows holding the conceptual-prefix positions
    ``r`` in one gather; returns (row12, blk, off) for ``occ4_from_row``."""
    j = r - (r > fm.primary).to(r.dtype)
    blk = j >> LOG2_OCC_BLOCK
    return _block_row(fm, blk), blk, (j & (OCC_BLOCK - 1)).to(torch.int32)


def occ4B(fm: FMDevice, r: torch.Tensor) -> torch.Tensor:
    return occ4_from_row(fm, *occ_rows_for(fm, r))


def backward_ext(fm: FMDevice, lo, hi, c):
    """Extend pattern interval [lo, hi) by prepending code c."""
    C = fm.L2[c.long()] + 1
    both = occB(fm, torch.cat([c, c]), torch.cat([lo, hi]))
    n = lo.shape[0]
    return C + both[:n], C + both[n:]


def backward_search(fm: FMDevice, codes: torch.Tensor, lens: torch.Tensor):
    """Exact-match intervals of a batch of reads: codes int32 [B, W]
    (0..3 bases, >= 4 ambiguous), lens int32 [B]. Returns (lo, hi) [B]
    in the rank dtype; the empty interval (0, 0) on no match, an
    ambiguous base or an empty read."""
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
        nlo, nhi = backward_ext(fm, lo, hi, c.clamp(0, 3))
        bad = live & (c >= 4)       # an ambiguous base kills the match
        lo = torch.where(active, nlo, torch.where(bad, 1, lo))
        hi = torch.where(active, nhi, torch.where(bad, 1, hi))
    empty = (hi <= lo) | (lens == 0)
    return torch.where(empty, 0, lo), torch.where(empty, 0, hi)


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


def fmd_extend_back(fm: FMDevice, k, l, s):
    """FMD bi-interval backward extension for all 4 codes."""
    both = occ4B(fm, torch.cat([k.reshape(-1), (k + s).reshape(-1)]))
    n = k.numel()
    o1 = both[:n].reshape(k.shape + (4,))
    o2 = both[n:].reshape(k.shape + (4,))
    return fmd_extend_from_occ(fm, k, l, s, o1, o2)


def fmd_extend_fwd(fm: FMDevice, k, l, s):
    """FMD forward extension: bi-intervals of P+c for each code c."""
    k4, l4, s4 = fmd_extend_back(fm, l, k, s)
    return l4.flip(-1), k4.flip(-1), s4.flip(-1)


def _sa_marked(fm: FMDevice, r: torch.Tensor) -> torch.Tensor:
    """Whether ranks carry a sampled SA value."""
    word = u32(_clamped(fm.sa_words, r >> 5))
    return ((word >> (r & 31).long()) & 1).bool()


def _sa_slot(fm: FMDevice, r: torch.Tensor) -> torch.Tensor:
    """Number of marked ranks before each rank (its sa_sample slot)."""
    r5 = (r >> 7).long()
    widx = torch.arange(4, device=r.device)
    words = u32(_clamped(fm.sa_words, (r5 * 4)[..., None] + widx))
    cnt = _clamped(fm.sa_cnt, r5)
    w = ((r >> 5) & 3).long()
    bits = (r & 31).long()
    nbits = torch.where(widx < w[..., None], 32,
                        torch.where(widx == w[..., None], bits[..., None], 0))
    mask = (1 << nbits) - 1            # int64: nbits = 32 is exact
    part = popcount32(words & mask).sum(-1).to(torch.int32)
    major = _clamped(fm.sa_majors, r5 >> LOG2_MAJOR)
    return part + cnt + major


def lf_step(fm: FMDevice, r: torch.Tensor) -> torch.Tensor:
    """One LF step: rank of the suffix at position SA[r] - 1."""
    j = r - (r > fm.primary).to(r.dtype)
    blk = j >> LOG2_OCC_BLOCK
    off = (j & (OCC_BLOCK - 1)).long()
    row = _block_row(fm, blk)
    word = u32(torch.gather(row[..., 4:], -1, (off >> 4)[..., None])[..., 0])
    c = (word >> (2 * (15 - (off & 15)))) & 3
    ckpt = torch.gather(row[..., :4], -1, c[..., None])[..., 0]
    major = torch.gather(_occ_major_rows(fm, blk), -1, c[..., None])[..., 0]
    lf = fm.L2[c] + ckpt + _row_counts(row, c, off) + 1 + major
    return torch.where(r == fm.primary, 0, lf).to(r.dtype)


def sa_resolve(fm: FMDevice, ranks: torch.Tensor, sa_interval: int = 32
               ) -> torch.Tensor:
    """Resolve conceptual ranks to doubled-text positions: at most
    ``sa_interval - 1`` LF steps to a marked rank."""
    r = ranks.to(fm.rank_dtype)
    steps = torch.zeros_like(r)
    for _ in range(sa_interval - 1):
        done = _sa_marked(fm, r)
        r = torch.where(done, r, lf_step(fm, r))
        steps = torch.where(done, steps, steps + 1)
    return _clamped(fm.sa_sample, _sa_slot(fm, r)) + steps


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

