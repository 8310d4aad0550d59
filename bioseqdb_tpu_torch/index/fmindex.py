"""FM-index over the doubled (forward + reverse-complement) reference.

TPU-native replacement for libbwa's ``bwt_t``/``bntseq_t`` machinery
(reference: bioseqdb/bwa.cpp:20-53 pac2bwt, :107-128 build — SA-IS BWT,
Occ checkpointing via bwt_bwtupdate_core, sampled SA via bwt_cal_sa(32)).
Instead of bwa's byte-stream BWT with interleaved checkpoints, the index
is a set of flat arrays laid out for TPU gathers:

- ``blocks`` int32[n_blocks, 12]: per 128 bases of the stored BWT, four
  exclusive Occ checkpoint counts followed by eight packed words
  (16 bases/word, big-endian within the word). One row gather (48 B)
  serves a complete Occ query — the "occurrence-table checkpointing"
  layout of the north star.
- ``sa_sample`` + ``sa_bits``: *position-sampled* suffix array. bwa
  samples by rank (bwt_cal_sa), which leaves LF walks unbounded; here
  ranks whose SA value ≡ 0 (mod interval) are marked in a bit-rank
  structure instead, so every resolution walk terminates in at most
  ``interval - 1`` LF steps — a fixed trip count for the device loop.
  ``sa_bits`` int32[nb, 5] holds, per 128 ranks, an exclusive popcount
  checkpoint + 4 mark words; ``sa_sample`` holds the SA values of
  marked ranks in rank order.
- annotations: per-reference offset/length tables replacing
  ``bntann1_t`` (without the ref-id-as-``char*`` hack of bwa.cpp:89,
  and with correct hole-offset rebasing — the reference's is buggy,
  bwa.cpp:100-104).

Rank/interval conventions (explicit, property-tested in
tests/test_fmindex.py):

- ``S`` is the doubled code text of length ``n = 2 * l_pac``; the
  conceptual BWT ``B`` ranges over ranks ``0..n`` (n+1 rows) of the
  suffix array of ``S`` + sentinel; ``B[primary] = $``; the stored BWT
  drops that row.
- intervals are half-open rank ranges ``[lo, hi)`` within ``[0, n+1)``;
  the empty pattern has ``[0, n+1)``.
- bi-intervals for the FMD (bwa's ``bwtintv_t``) are ``(k, l, s)``:
  ``k`` = lo of the pattern interval, ``l`` = lo of the
  reverse-complement pattern interval, ``s`` = size.

This module is the host/reference implementation (numpy, scalar-clear);
the batched device path lives in kernels/fm.py and must match it
bit-for-bit.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from bioseqdb_tpu_torch.index.native.build import suffix_array

OCC_BLOCK = 128          # bases covered per checkpoint block
MAJOR_BLOCKS = 1 << 15   # minor-checkpoint span: 2^15 blocks = 4.2M bases,
                         # keeping minor counts within int32 at any scale
WORDS_PER_BLOCK = OCC_BLOCK // 16
BLOCK_COLS = 4 + WORDS_PER_BLOCK
SA_INTERVAL = 32


@dataclass
class FMIndex:
    l_pac: int                 # forward text length (bases)
    seq_len: int               # doubled length n = 2 * l_pac
    primary: int               # conceptual rank of the suffix at position 0
    L2: np.ndarray             # int64[5] exclusive cumulative symbol counts of S
    blocks: np.ndarray         # int32[n_blocks, 12] interleaved Occ + packed BWT
    sa_sample: np.ndarray      # int32[n_marked] SA values of marked ranks, rank order
    sa_bits: np.ndarray        # int32[nb, 5] mark bit-rank blocks (ckpt + 4 words)
    pac: np.ndarray            # uint8[l_pac] forward 2-bit codes (with hole filler)
    # major checkpoints (int64): blocks/sa_bits minor counts are relative
    # to these every MAJOR_BLOCKS rows, so the int32 block layout holds
    # beyond 2^31 bases. All-zero single rows for small indexes.
    occ_majors: np.ndarray = field(default_factory=lambda: np.zeros((1, 4), np.int64))
    sa_majors: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))
    sa_interval: int = SA_INTERVAL
    # reference annotations (bntann1_t replacement)
    ref_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    ref_names: list[str] = field(default_factory=list)
    ref_offsets: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    ref_lens: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # ALT-contig flags (bwa's bntann1_t.is_alt role): hits on ALT
    # references never shadow primary-reference hits
    ref_is_alt: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))
    # ambiguity holes in concatenated forward coordinates (bntamb1_t replacement)
    hole_offsets: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    hole_lens: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    hole_chars: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))

    # -- derived ----------------------------------------------------------

    @property
    def n_refs(self) -> int:
        return len(self.ref_names)

    @property
    def C(self) -> np.ndarray:
        """Rank of the first suffix starting with each symbol (sentinel
        occupies rank 0, hence the +1)."""
        return self.L2 + 1

    # -- scalar reference queries (numpy ground truth) --------------------

    def occ_stored(self, c: int, j) -> int:
        """Count of code ``c`` in the stored BWT prefix ``[0, j)``."""
        j = int(j)
        b, r = divmod(j, OCC_BLOCK)
        row = self.blocks[b]
        count = (int(row[c]) & 0xFFFFFFFF) + int(
            self.occ_majors[min(b // MAJOR_BLOCKS, len(self.occ_majors) - 1), c]
        )
        words = np.asarray(row[4:]).view(np.uint32)
        full, rem = divmod(r, 16)
        pat = np.uint32(int(c) * 0x55555555)
        for w in range(full):
            x = np.uint32(words[w]) ^ pat
            y = ~(x | (x >> np.uint32(1))) & np.uint32(0x55555555)
            count += int(bin(int(y)).count("1"))
        if rem:
            x = np.uint32(words[full]) ^ pat
            y = ~(x | (x >> np.uint32(1))) & np.uint32(0x55555555)
            mask = np.uint32((0x55555555 << (2 * (16 - rem))) & 0xFFFFFFFF)
            count += int(bin(int(y & mask)).count("1"))
        return count

    def occB(self, c: int, r) -> int:
        """Count of code ``c`` in the conceptual BWT prefix ``B[0, r)``
        (skipping the sentinel row at ``primary``)."""
        r = int(r)
        return self.occ_stored(c, r - (1 if r > self.primary else 0))

    def stored_code(self, i: int) -> int:
        """Code at stored-BWT position i."""
        b, r = divmod(int(i), OCC_BLOCK)
        w, o = divmod(r, 16)
        word = int(self.blocks[b, 4 + w]) & 0xFFFFFFFF
        return (word >> (2 * (15 - o))) & 3

    def backward_ext(self, lo: int, hi: int, c: int) -> tuple[int, int]:
        """Extend pattern interval [lo, hi) by prepending code c."""
        C = int(self.C[c])
        return C + self.occB(c, lo), C + self.occB(c, hi)

    def backward_search(self, codes) -> tuple[int, int]:
        """Exact-match interval of a code string (empty interval if absent)."""
        lo, hi = 0, self.seq_len + 1
        for c in reversed(list(codes)):
            if c >= 4:
                return 0, 0
            lo, hi = self.backward_ext(lo, hi, int(c))
            if lo >= hi:
                return 0, 0
        return lo, hi

    def fmd_extend(self, k: int, l: int, s: int, is_back: bool):
        """FMD bi-interval extension (bwa bwt_extend semantics).

        Returns arrays (k4, l4, s4) over the 4 codes: extending the
        pattern by code c at the front (is_back=True) or the back
        (is_back=False) of the pattern.
        """
        if not is_back:
            # forward extension == backward extension on the rc interval
            k4, l4, s4 = self.fmd_extend(l, k, s, True)
            # result for appending c at the back = rc-extension by comp(c)
            return l4[::-1].copy(), k4[::-1].copy(), s4[::-1].copy()
        cnt = np.empty(4, np.int64)
        lo = np.empty(4, np.int64)
        for c in range(4):
            o1 = self.occB(c, k)
            o2 = self.occB(c, k + s)
            lo[c] = self.C[c] + o1
            cnt[c] = o2 - o1
        has_dollar = 1 if (k <= self.primary < k + s) else 0
        l4 = np.empty(4, np.int64)
        l4[3] = l + has_dollar
        l4[2] = l4[3] + cnt[3]
        l4[1] = l4[2] + cnt[2]
        l4[0] = l4[1] + cnt[1]
        return lo, l4, cnt

    def inv_psi(self, r: int) -> int:
        """LF step: rank of the suffix at position SA[r] - 1."""
        if r == self.primary:
            return 0
        j = r - (1 if r > self.primary else 0)
        c = self.stored_code(j)
        return int(self.C[c]) + self.occB(c, r + 1) - 1

    def sa_marked(self, r: int) -> bool:
        """Whether rank r carries a sampled SA value (SA[r] % interval == 0)."""
        word = int(self.sa_bits[r >> 7, 1 + ((r >> 5) & 3)])
        return bool((word >> (r & 31)) & 1)

    def sa_slot(self, r: int) -> int:
        """Number of marked ranks before rank r (its sa_sample slot)."""
        row = self.sa_bits[r >> 7]
        cnt = (int(row[0]) & 0xFFFFFFFF) + int(
            self.sa_majors[min((r >> 7) // MAJOR_BLOCKS, len(self.sa_majors) - 1)]
        )
        w = (r >> 5) & 3
        for i in range(w):
            cnt += bin(int(row[1 + i]) & 0xFFFFFFFF).count("1")
        cnt += bin((int(row[1 + w]) & 0xFFFFFFFF) & ((1 << (r & 31)) - 1)).count("1")
        return cnt

    def sa_at(self, r: int) -> int:
        """Resolve the SA value of conceptual rank r via the sampled SA.

        Position sampling guarantees at most ``sa_interval - 1`` LF
        steps: each step decrements the SA value by one, and every rank
        whose SA value ≡ 0 (mod interval) is marked — including the
        primary rank (SA = 0), so walks never wrap past the sentinel.
        """
        steps = 0
        r = int(r)
        while not self.sa_marked(r):
            r = self.inv_psi(r)
            steps += 1
        return int(self.sa_sample[self.sa_slot(r)]) + steps

    def isa_sample_array(self) -> np.ndarray:
        """Sampled inverse suffix array: ``isa[m // sa_interval]`` = the
        conceptual rank of the suffix at position ``m`` for every
        position multiple of ``sa_interval`` in ``[0, seq_len]``.

        Derived (and cached) from the existing mark structures rather
        than stored: the marked ranks in rank order are the set bits of
        ``sa_bits``, and ``sa_sample`` holds their positions — the ISA
        is the inverse of that pairing, so one streaming bit-unpack +
        one scatter rebuilds it from any saved index (no format bump).
        Powers the seeding fast-forward's rank-from-position queries
        (kernels/fm.py isa_walk)."""
        cached = getattr(self, "_isa_cache", None)
        if cached is not None:
            return cached
        v = self.sa_interval
        n_slots = self.seq_len // v + 1
        isa = np.zeros(n_slots, dtype=self.sa_sample.dtype)
        total = self.seq_len + 1  # conceptual ranks 0..seq_len
        CH_ROWS = 1 << 20  # 128 ranks per sa_bits row
        cursor = 0  # marked ranks consumed so far (= sa_sample cursor)
        for b0 in range(0, self.sa_bits.shape[0], CH_ROWS):
            words = self.sa_bits[b0 : b0 + CH_ROWS, 1:].astype(np.uint32)
            bits = (
                (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
            ).astype(bool)
            flat = bits.reshape(-1)  # rank-major within the chunk
            ranks = np.flatnonzero(flat) + b0 * 128
            ranks = ranks[ranks < total]
            pos = self.sa_sample[cursor : cursor + ranks.shape[0]]
            isa[np.asarray(pos) // v] = ranks.astype(isa.dtype)
            cursor += ranks.shape[0]
        assert cursor == len(self.sa_sample)
        object.__setattr__(self, "_isa_cache", isa)
        return isa

    def packed_doubled_rows(self, pack_fn) -> np.ndarray:
        """The extend-stage packed doubled-text rows (pack_fn =
        kernels.extend.pack_doubled_rows), cached in memory and — for
        indexes loaded from disk — on disk next to the index arrays:
        repacking 6.2 G doubled bases costs ~9 single-threaded host
        minutes per GRCh38 Aligner.build, the mmap load costs seconds."""
        cached = getattr(self, "_pacrows_cache", None)
        if cached is not None:
            return cached
        path = getattr(self, "_load_path", None)
        fpath = os.path.join(path, "pac_rows.npy") if path else None
        if fpath and os.path.exists(fpath):
            rows = np.load(fpath, mmap_mode="r")
        else:
            rows = pack_fn(np.asarray(self.pac))
            if fpath:
                try:
                    np.save(fpath, rows)
                except OSError:
                    pass  # read-only index dir: keep the in-memory copy
        object.__setattr__(self, "_pacrows_cache", rows)
        return rows

    # -- coordinate mapping ----------------------------------------------

    def depos(self, pos: int, length: int) -> tuple[int, bool]:
        """Map a doubled-text position of a length-``length`` match to a
        forward-strand position + strand flag (bwa bns_depos analogue)."""
        if pos < self.l_pac:
            return pos, False
        return self.seq_len - pos - length, True

    def rid_of(self, fwd_pos: int) -> int:
        """Reference row index containing a forward position."""
        return int(np.searchsorted(self.ref_offsets, fwd_pos, side="right")) - 1

    def extract_subseq(self, fwd_begin: int, fwd_end: int) -> str:
        """Decode [begin, end) of the concatenated forward text, holes
        re-overlaid (reference: extract_reference_subseq, bwa.cpp:55-68)."""
        from bioseqdb_tpu_torch.seq.codec import CHAR_OF

        out = CHAR_OF[self.pac[fwd_begin:fwd_end]].copy()
        left = np.maximum(self.hole_offsets, fwd_begin)
        right = np.minimum(self.hole_offsets + self.hole_lens, fwd_end)
        for lo, hi, ch in zip(left, right, self.hole_chars):
            if lo < hi:
                out[lo - fwd_begin : hi - fwd_begin] = ch
        return out.tobytes().decode("ascii")

    # -- serialization ----------------------------------------------------

    def save(self, path: str) -> None:
        """Write as a directory of .npy arrays + a JSON manifest; arrays
        are mmap-able at load (SURVEY.md §5 checkpoint/resume: the index
        is a first-class serialized artifact, fixing the reference's
        rebuild-per-call design, extension.cpp:326,359)."""
        os.makedirs(path, exist_ok=True)
        arrays = dict(
            L2=self.L2, blocks=self.blocks, sa_sample=self.sa_sample,
            sa_bits=self.sa_bits, occ_majors=self.occ_majors,
            sa_majors=self.sa_majors,
            pac=self.pac, ref_ids=self.ref_ids, ref_offsets=self.ref_offsets,
            ref_lens=self.ref_lens, ref_is_alt=self.ref_is_alt,
            hole_offsets=self.hole_offsets,
            hole_lens=self.hole_lens, hole_chars=self.hole_chars,
        )
        for name, arr in arrays.items():
            np.save(os.path.join(path, name + ".npy"), arr)
        meta = dict(
            format_version=2, l_pac=self.l_pac, seq_len=self.seq_len,
            primary=self.primary, sa_interval=self.sa_interval,
            ref_names=self.ref_names,
        )
        with open(os.path.join(path, "meta.json"), "w") as fh:
            json.dump(meta, fh)

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "FMIndex":
        with open(os.path.join(path, "meta.json")) as fh:
            meta = json.load(fh)
        version = meta.get("format_version")
        if version != 2:  # v2 added the major checkpoint tables
            raise ValueError(
                f"unsupported index format_version {version!r} at {path}; "
                "rebuild the index with this version of bioseqdb-tpu"
            )
        mode = "r" if mmap else None
        ld = lambda name: np.load(os.path.join(path, name + ".npy"), mmap_mode=mode)
        out = cls(
            l_pac=meta["l_pac"], seq_len=meta["seq_len"],
            primary=meta["primary"], sa_interval=meta["sa_interval"],
            ref_names=list(meta["ref_names"]),
            L2=np.asarray(ld("L2")), blocks=ld("blocks"),
            sa_sample=ld("sa_sample"), sa_bits=ld("sa_bits"),
            occ_majors=ld("occ_majors"), sa_majors=ld("sa_majors"),
            pac=ld("pac"), ref_ids=ld("ref_ids"),
            ref_offsets=ld("ref_offsets"), ref_lens=ld("ref_lens"),
            ref_is_alt=ld("ref_is_alt"),
            hole_offsets=ld("hole_offsets"), hole_lens=ld("hole_lens"),
            hole_chars=ld("hole_chars"),
        )
        # remember where we came from: packed_doubled_rows caches its
        # (expensive at GRCh38 scale) derived table next to the arrays
        object.__setattr__(out, "_load_path", path)
        return out


# Chunk size for streaming table construction, in blocks. A multiple of
# MAJOR_BLOCKS so every major checkpoint is computed within its own
# chunk; big builds (GRCh38-scale: 6.2 G doubled bases) must never
# materialize O(n) 64-bit temporaries — the naive whole-array packing
# peaked >60 GB of temps and OOM'd a 125 GB host.
_PACK_CHUNK_BLOCKS = 32 * MAJOR_BLOCKS


def _pack_mark_bits(mark: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Bit-rank blocks over the rank-mark bitvector: per 128 ranks, an
    exclusive popcount checkpoint + 4 words (LSB-first bit order).
    Checkpoints are stored relative to int64 major checkpoints every
    MAJOR_BLOCKS rows; returns (bits, majors). Streams in chunks."""
    m = mark.shape[0]
    nb = (m + 127) // 128
    out = np.empty((nb, 5), dtype=np.int32)
    majors = np.empty(-(-nb // MAJOR_BLOCKS), dtype=np.int64)
    weights = (1 << np.arange(32, dtype=np.uint64))
    run = np.int64(0)
    for b0 in range(0, nb, _PACK_CHUNK_BLOCKS):
        b1 = min(b0 + _PACK_CHUNK_BLOCKS, nb)
        seg = np.zeros((b1 - b0) * 128, dtype=bool)
        src = mark[b0 * 128 : min(b1 * 128, m)]
        seg[: src.shape[0]] = src
        bits = seg.reshape(b1 - b0, 4, 32)
        words = (bits.astype(np.uint64) * weights[None, None, :]).sum(axis=2)
        counts = bits.sum(axis=(1, 2))
        ckpt = np.empty(b1 - b0, dtype=np.int64)
        ckpt[0] = run
        np.cumsum(counts[:-1], out=ckpt[1:])
        ckpt[1:] += run
        run += counts.sum()
        mj = majors[b0 // MAJOR_BLOCKS : -(-b1 // MAJOR_BLOCKS)]
        mj[:] = ckpt[::MAJOR_BLOCKS]
        rel = ckpt - np.repeat(mj, MAJOR_BLOCKS)[: b1 - b0]
        out[b0:b1, 0] = rel.astype(np.uint32).view(np.int32)
        out[b0:b1, 1:] = words.astype(np.uint32).view(np.int32).reshape(-1, 4)
    return out, majors


def _pack_blocks(stored: np.ndarray) -> np.ndarray:
    """Interleave Occ checkpoints + packed words for the stored BWT.
    Streams in chunks (no O(n) 64-bit temporaries)."""
    n = stored.shape[0]
    n_blocks = n // OCC_BLOCK + 1
    out = np.empty((n_blocks, BLOCK_COLS), dtype=np.int32)
    majors = np.empty((-(-n_blocks // MAJOR_BLOCKS), 4), dtype=np.int64)
    shifts = (2 * (15 - np.arange(16, dtype=np.uint64))).astype(np.uint64)
    run = np.zeros(4, dtype=np.int64)
    for b0 in range(0, n_blocks, _PACK_CHUNK_BLOCKS):
        b1 = min(b0 + _PACK_CHUNK_BLOCKS, n_blocks)
        nbc = b1 - b0
        seg = np.zeros(nbc * OCC_BLOCK, dtype=np.uint8)
        src = stored[b0 * OCC_BLOCK : min(b1 * OCC_BLOCK, n)]
        seg[: src.shape[0]] = src
        by_block = seg.reshape(nbc, OCC_BLOCK)
        # per-block symbol counts -> exclusive cumulative checkpoints.
        # padding bases (code 0) beyond n sit in the final block only,
        # after every checkpoint, so plain counting stays correct.
        counts = np.empty((nbc, 4), dtype=np.int64)
        for c in range(4):
            counts[:, c] = (by_block == c).sum(axis=1)
        ckpt = np.empty((nbc, 4), dtype=np.int64)
        ckpt[0] = run
        np.cumsum(counts[:-1], axis=0, out=ckpt[1:])
        ckpt[1:] += run
        run += counts.sum(axis=0)
        # int64 major checkpoints every MAJOR_BLOCKS rows keep the
        # per-block minor counts within int32 at any text size
        mj = majors[b0 // MAJOR_BLOCKS : -(-b1 // MAJOR_BLOCKS)]
        mj[:] = ckpt[::MAJOR_BLOCKS]
        rel = ckpt - np.repeat(mj, MAJOR_BLOCKS, axis=0)[:nbc]
        # pack 16 bases/word, big-endian within word
        grp = by_block.reshape(nbc, WORDS_PER_BLOCK, 16).astype(np.uint64)
        words = (grp << shifts[None, None, :]).sum(axis=2).astype(np.uint32)
        out[b0:b1, :4] = rel.astype(np.uint32).view(np.int32)
        out[b0:b1, 4:] = words.view(np.int32)
    return out, majors


def build_fmindex_from_codes(
    pac: np.ndarray,
    ref_ids=None,
    ref_names=None,
    ref_offsets=None,
    ref_lens=None,
    ref_is_alt=None,
    hole_offsets=None,
    hole_lens=None,
    hole_chars=None,
    sa_interval: int = SA_INTERVAL,
) -> FMIndex:
    """Build the index from concatenated forward 2-bit codes.

    Mirrors BwaIndex::build (bwa.cpp:107-128): doubles the text with its
    reverse complement, computes the suffix array (native SA-IS), then
    derives stored BWT, interleaved Occ blocks, and the sampled SA.
    """
    pac = np.ascontiguousarray(pac, dtype=np.uint8)
    L = int(pac.shape[0])
    n = 2 * L
    # beyond 2^31 doubled bases the host path (build, serialization, the
    # oracle aligner) is fully supported via the int64 major checkpoints;
    # the DEVICE pipeline still requires int32 ranks (ROADMAP.md item 1)
    S = np.concatenate([pac, (3 - pac)[::-1]])
    sa = suffix_array(S)  # n+1 entries, sa[0] = n
    # One streaming pass over sa builds the stored BWT (B minus the
    # sentinel row), the rank-mark bitvector, the sampled SA, and finds
    # the primary — whole-array expressions here each materialize an
    # O(n) int64 temporary (several x 50 GB at GRCh38 scale).
    CH = 1 << 27
    stored = np.empty(n, dtype=np.uint8)
    mark = np.empty(n + 1, dtype=bool)
    sample_dt = np.int32 if n < 2**31 else np.int64
    samples = []
    primary = -1
    cursor = 0
    for c0 in range(0, n + 1, CH):
        v = sa[c0 : c0 + CH]
        mk_c = (v % sa_interval) == 0
        mark[c0 : c0 + CH] = mk_c
        samples.append(v[mk_c].astype(sample_dt))
        z = np.flatnonzero(v == 0)
        if z.size:
            primary = c0 + int(z[0])
        pos = v[v > 0]
        pos -= 1
        stored[cursor : cursor + pos.shape[0]] = S[pos]
        cursor += pos.shape[0]
    assert cursor == n and primary >= 0
    sa_sample = np.concatenate(samples)
    del samples, sa
    L2 = np.zeros(5, dtype=np.int64)
    L2[1:] = np.cumsum(np.bincount(S, minlength=4)[:4])
    del S
    blocks, occ_majors = _pack_blocks(stored)
    del stored
    sa_bits, sa_majors = _pack_mark_bits(mark)
    del mark
    mk = lambda x, dt: np.asarray(x if x is not None else [], dtype=dt)
    n_refs_known = ref_names is not None
    return FMIndex(
        l_pac=L, seq_len=n, primary=primary, L2=L2, blocks=blocks,
        sa_sample=sa_sample, sa_bits=sa_bits, occ_majors=occ_majors,
        sa_majors=sa_majors, pac=pac, sa_interval=sa_interval,
        ref_ids=mk(ref_ids, np.int64),
        ref_names=list(ref_names) if n_refs_known else ["0"],
        ref_offsets=mk(ref_offsets if ref_offsets is not None else [0], np.int64),
        ref_lens=mk(ref_lens if ref_lens is not None else [L], np.int64),
        ref_is_alt=np.asarray(
            ref_is_alt if ref_is_alt is not None else [False], dtype=bool
        ),
        hole_offsets=mk(hole_offsets, np.int64),
        hole_lens=mk(hole_lens, np.int64),
        hole_chars=mk(hole_chars, np.uint8),
    )
