"""Host-side device-table layouts, jax-free.

Copies of the JAX package's host layout builders (``kernels/fm.py``
``pack_oct``, ``kernels/extend.py`` ``pack_doubled_rows`` and the host
half of ``kernels/kmer.py``), kept byte-for-byte equal to them by
``tests/test_torch_layout.py``. The port imports nothing of the JAX
package, and those JAX modules import jax besides.

``tables_from_host`` returns every device table of an index as numpy
arrays (``fm_tables`` the FM fields alone, their ranks int32 below 2^31
doubled bases and int64 from there, or as forced); ``to_device`` moves
them onto a torch device, dtypes unchanged. Together they are the port's
counterpart of ``FMDevice.from_host`` + the ``Aligner.build`` table
uploads.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from bioseqdb_tpu_torch.index.fmindex import FMIndex

# ---- FM octo rows (kernels/fm.py pack_oct) ---------------------------------

OCT_BLOCKS = 8   # Occ blocks per device row
OCT_COLS = 128   # int32 per device row: 96 Occ + 32 SA-mark words


def pack_oct(blocks: np.ndarray, sa_bits: np.ndarray | None = None
             ) -> np.ndarray:
    """Host (n_blocks, 12) Occ table -> octo layout (n/8, 128): cols
    0:96 hold 8 Occ blocks, cols 96:128 the 8 blocks' SA-mark words."""
    blocks = np.asarray(blocks)
    n = blocks.shape[0]
    if sa_bits is not None:
        n = max(n, np.asarray(sa_bits).shape[0])
    n8 = -(-n // OCT_BLOCKS) * OCT_BLOCKS
    out = np.zeros((n8 // OCT_BLOCKS, OCT_COLS), np.int32)
    bb = np.zeros((n8, 12), np.int32)
    bb[: blocks.shape[0]] = blocks
    out[:, :96] = bb.reshape(-1, 96)
    if sa_bits is not None:
        mm = np.zeros((n8, 4), np.int32)
        mm[: sa_bits.shape[0]] = np.asarray(sa_bits)[:, 1:]
        out[:, 96:] = mm.reshape(-1, 32)
    return out


# ---- packed doubled text (kernels/extend.py pack_doubled_rows) -------------

ROW_BASES = 2048  # bases per packed row: 128 int32 words


def pack_doubled_rows(pac: np.ndarray) -> np.ndarray:
    """Doubled text (forward + reverse complement) packed 2-bit, 16
    bases per int32 word (big-endian within the word), ROW_BASES bases
    per row, plus one zero row. Streams in chunks to bound host temps."""
    pac = np.asarray(pac)
    n_f = len(pac)
    n = 2 * n_f
    nrows = (n + ROW_BASES - 1) // ROW_BASES + 1
    out = np.zeros((nrows, ROW_BASES // 16), np.int32)
    shifts = (15 - np.arange(16, dtype=np.uint32)) * 2
    chunk_rows = max(1, (64 << 20) // ROW_BASES)

    def codes_at(lo, hi):  # doubled-text codes on [lo, hi)
        c = np.empty(hi - lo, np.uint32)
        nf_cut = min(max(n_f - lo, 0), hi - lo)
        if nf_cut > 0:
            c[:nf_cut] = pac[lo : lo + nf_cut]
        if nf_cut < hi - lo:
            rlo, rhi = max(lo, n_f) - n_f, hi - n_f
            c[nf_cut:] = 3 - pac[n_f - 1 - rlo : n_f - 1 - rhi if rhi < n_f
                                 else None : -1]
        return c & 3

    for r0 in range(0, nrows, chunk_rows):
        r1 = min(r0 + chunk_rows, nrows)
        lo, hi = r0 * ROW_BASES, min(r1 * ROW_BASES, n)
        if lo >= n:
            break
        flat = np.zeros((r1 - r0) * ROW_BASES, np.uint32)
        flat[: hi - lo] = codes_at(lo, hi)
        words = (flat.reshape(-1, 16) << shifts).sum(axis=1, dtype=np.uint32)
        out[r0:r1] = words.view(np.int32).reshape(r1 - r0, ROW_BASES // 16)
    return out


# ---- minimizer table (host half of kernels/kmer.py) ------------------------

K = 14          # k-mer length
WIN = 6         # minimizer window: k-mer starts per window
GUARANTEE = K + WIN - 1  # = 19: minimum exactly-findable match length


def _mix32(h: np.ndarray) -> np.ndarray:
    """murmur3 finalizer on uint32 arrays (the device twin is
    kernels/kmer.py ``mix32``; both must agree bit for bit)."""
    u = h.dtype.type
    h = h ^ (h >> u(16))
    h = h * u(0x85EBCA6B)
    h = h ^ (h >> u(13))
    h = h * u(0xC2B2AE35)
    h = h ^ (h >> u(16))
    return h


class KmerMeta(typing.NamedTuple):
    """Table shape info."""

    bb: int          # bucket bits (bucket id = key >> (2K - bb))
    n_entries: int
    nrows0: int      # rows in the unshifted half of ``entries``


def _host_minimizer_positions(codes: np.ndarray):
    """Selected (k=14, w=6) minimizer positions of a code array (0..3),
    brute sliding-window leftmost argmin; returns (positions, k-mers)."""
    n = len(codes)
    empty = (np.zeros(0, np.int64), np.zeros(0, np.uint32))
    if n < K:
        return empty
    km = np.zeros(n - K + 1, np.uint32)
    for t in range(K):
        km = (km << np.uint32(2)) | codes[t : n - K + 1 + t].astype(np.uint32)
    h = _mix32(km)
    nwin = len(h) - WIN + 1
    if nwin <= 0:
        return empty
    sel = np.zeros(len(h), bool)
    chunk = 1 << 22
    for lo in range(0, nwin, chunk):
        hi = min(lo + chunk, nwin)
        wins = np.lib.stride_tricks.sliding_window_view(
            h[lo : hi + WIN - 1], WIN)
        arg = np.argmin(wins, axis=1)  # leftmost minimum
        sel[lo + np.arange(hi - lo) + arg] = True
    return np.flatnonzero(sel).astype(np.int64), km


def build_kmer_table(pac: np.ndarray) -> tuple[dict, KmerMeta]:
    """Genome minimizer table over the doubled text: ``bmeta`` int32
    [2^bb] = (bucket offset << 4) | min(count, 15), and ``entries``
    int32 rows of 32 packed (pos << low_bits) | low_key entries, stored
    twice (plain and shifted by 16) so any <= 16 consecutive entries sit
    in one row of one copy."""
    pac = np.asarray(pac, np.uint8) & 3
    n_f = len(pac)
    codes = np.empty(2 * n_f, np.uint8)
    codes[:n_f] = pac
    codes[n_f:] = 3 - pac[::-1]
    sel_pos, km = _host_minimizer_positions(codes)
    keys = km[sel_pos]
    order = np.argsort(keys, kind="stable")  # pos ascending within a key
    keys_s = keys[order].astype(np.uint32)
    pos_s = sel_pos[order]
    ne = len(pos_s)
    if 2 * n_f >= (1 << 31):
        raise ValueError("kmer table requires int32 positions")
    if ne >= (1 << 27):
        raise ValueError("bmeta packs offsets into 27 bits")
    bits_pos = max(int(2 * n_f - 1).bit_length(), 1)
    bb_pack = bits_pos + 2 * K - 32  # low_bits <= 32 - bits_pos
    bb = 2 * K
    if ne > 0:
        bb = int(np.ceil(np.log2(max(ne / 1.25, 2))))
    bb = max(14, bb, bb_pack)
    bb = min(bb, 26, 2 * K)
    if bb < bb_pack:
        raise ValueError("doubled text too large for packed entries")
    low_bits = 2 * K - bb
    bucket = (keys_s >> np.uint32(low_bits)).astype(np.int64)
    cnts = np.bincount(bucket, minlength=1 << bb)
    off = np.zeros(1 << bb, np.int64)
    np.cumsum(cnts[:-1], out=off[1:])
    bmeta = ((off << 4) | np.minimum(cnts, 15)).astype(np.int32)
    low = keys_s.astype(np.uint32) & np.uint32((1 << low_bits) - 1)
    packed = ((pos_s.astype(np.uint32) << np.uint32(low_bits)) | low
              ).view(np.int32)
    nrows0 = ne // 32 + 1
    flat = np.full(nrows0 * 32, -1, np.int32)
    flat[:ne] = packed
    e0 = flat.reshape(nrows0, 32)
    flat1 = np.full((nrows0 + 1) * 32, -1, np.int32)
    flat1[: nrows0 * 32 - 16] = flat[16:]
    e1 = flat1.reshape(nrows0 + 1, 32)
    return (
        dict(bmeta=bmeta, entries=np.concatenate([e0, e1])),
        KmerMeta(bb=bb, n_entries=ne, nrows0=nrows0),
    )


def kmer_eligible(idx, options) -> bool:
    """Can the kmer seeder hold exact parity for (index, options)?
    int32 doubled-text positions, min_seed_len >= 19, and split_len >
    min_seed_len + 1 (round-3 seeds never qualify as reseed parents)."""
    msl = int(options.min_seed_len)
    split_len = int(msl * options.reseed_factor + 0.499)
    return (
        int(idx.seq_len) < (1 << 31)
        and msl >= GUARANTEE
        and split_len > msl + 1
    )


def smax_for(max_mem_intv: int) -> int:
    """Occurrence-scan cap: below max_mem_intv (round 3 then stops at
    its first eligible check), <= 14 (the bucket count saturates at
    15), and a window of that many entries fits one table row."""
    if max_mem_intv <= 0:
        return 14
    return min(14, max_mem_intv - 1)


def dmax_for(meta: KmerMeta, nmz: int = 48) -> int:
    """Diagonal-slot budget: expected chance hits plus a 6-sigma margin,
    rounded up to the 8-diagonal chunk."""
    lam = nmz * meta.n_entries / float(4 ** K)
    d = int(lam + max(6.0 * lam ** 0.5, 5.0) + 2.0)
    return min(40, max(8, -(-d // 8) * 8))


def nmz_for(width: int) -> int:
    """Minimizer-slot budget per read (~2/(WIN+1) of the k-mer starts,
    with headroom)."""
    NP = max(width - K + 1, 1)
    return max(56, -(-int(0.33 * NP) // 8) * 8)


def kmer_table_arrays(idx: FMIndex) -> tuple[dict, KmerMeta]:
    """``build_kmer_table(idx.pac)``, cached in memory on the index
    object (the port's own cache; the port's ``FMIndex`` carries no
    ``kmer_table_arrays``)."""
    cached = getattr(idx, "_torch_kmer_cache", None)
    if cached is None:
        cached = build_kmer_table(np.asarray(idx.pac))
        object.__setattr__(idx, "_torch_kmer_cache", cached)
    return cached


# ---- every device table of an index ----------------------------------------

FM_FIELDS = ("L2", "primary", "blocks", "sa_sample", "sa_cnt", "sa_words",
             "occ_majors", "sa_majors", "ref_offsets", "ref_lens", "l_pac",
             "seq_len")


def rank_dtype_for(idx: FMIndex, rank_dtype=None) -> torch.dtype:
    """The rank dtype of ``idx``'s device tables: ``rank_dtype`` when
    given (torch.int32 or torch.int64), else int64 from 2^31 - 1 doubled
    bases up (the conceptual BWT's n + 1 ranks no longer fit int32) and
    int32 below, as the JAX package's ``FMDevice.from_host`` picks."""
    if rank_dtype is None:
        return torch.int64 if idx.seq_len + 1 >= 2**31 else torch.int32
    if rank_dtype not in (torch.int32, torch.int64):
        raise ValueError(f"rank_dtype {rank_dtype} is not torch.int32 or "
                         "torch.int64")
    return rank_dtype


def fm_tables(idx: FMIndex, rank_dtype=None) -> dict:
    """The FM fields of ``idx`` as numpy arrays (``FMDevice`` layout).

    The rank-valued fields (``L2``, ``primary``, ``sa_sample``, the major
    checkpoints, the reference offsets and lengths, ``l_pac`` and
    ``seq_len``) take ``rank_dtype_for(idx, rank_dtype)``; the packed
    tables (``blocks``, ``sa_cnt``, ``sa_words``) stay int32 at any size,
    their counts relative to the major checkpoints."""
    rdt = {torch.int32: np.int32,
           torch.int64: np.int64}[rank_dtype_for(idx, rank_dtype)]
    rk = lambda x: np.asarray(x).astype(rdt)
    i32 = lambda x: np.asarray(x).astype(np.int32)
    sa_bits = np.ascontiguousarray(np.asarray(idx.sa_bits))
    return dict(
        L2=rk(idx.L2),
        primary=rk(idx.primary),
        blocks=pack_oct(idx.blocks, sa_bits),
        sa_sample=rk(idx.sa_sample),
        sa_cnt=i32(sa_bits[:, 0]),
        sa_words=i32(sa_bits[:, 1:].reshape(-1)),
        occ_majors=rk(idx.occ_majors),
        sa_majors=rk(idx.sa_majors),
        ref_offsets=rk(idx.ref_offsets),
        ref_lens=rk(idx.ref_lens),
        l_pac=rk(idx.l_pac),
        seq_len=rk(idx.seq_len),
    )


def tables_from_host(idx: FMIndex, kmer: bool = True) -> dict:
    """Every device table of ``idx`` as numpy arrays: the FM fields
    (``fm_tables``, ranks in the dtype it chooses by the index's size),
    ``pac_rows`` (packed doubled text) and, with ``kmer``, the minimizer
    table (``bmeta``, ``entries``, ``kmer_meta``)."""
    t = fm_tables(idx)
    t["pac_rows"] = pack_doubled_rows(np.asarray(idx.pac))
    if kmer:
        host, meta = kmer_table_arrays(idx)
        t.update(bmeta=host["bmeta"], entries=host["entries"], kmer_meta=meta)
    return t


def to_device(tables: dict, device) -> dict:
    """Tensors on ``device`` for every array of ``tables`` (other
    entries, such as ``kmer_meta``, pass through)."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                if isinstance(v, np.ndarray) else v)
            for k, v in tables.items()}
