"""2-bit nucleotide sequence codec — TPU-native NUCLSEQ replacement.

Replaces the reference's Postgres NUCLSEQ varlena datatype
(reference: bioseqdb/sequence.{h,cpp}; FFI wrappers extension.cpp:46-150)
with a numpy-backed value type designed to feed JAX/TPU arrays:

- the working representation is a dense ``uint8`` array of 2-bit codes
  (A=0, C=1, G=2, T=3) — directly usable as a device array — rather than
  a byte-packed varlena;
- IUPAC-ambiguous runs ("holes") are tracked as three parallel arrays
  ``(offset, len, symbol)`` (replacing the reference's ``bntamb1_t``
  records, sequence.h:13-26);
- hole positions and tail padding carry a deterministic pseudo-random
  2-bit filler from the same LCG family the reference uses
  (``std::minstd_rand`` seeded ``holes_num ^ len``, sequence.cpp:214-215),
  so ordering/equality semantics and index contents are reproducible;
- all ops (complement / reverse / occurrences / content / compare) are
  vectorized numpy, mirroring sequence.cpp:85-183 semantics.

Known reference defects intentionally NOT replicated (SURVEY.md §7):
- ``reverse()`` mis-places multi-base holes (sequence.cpp:150 sets
  ``offset = len - hole.offset - 1`` instead of ``len - offset - hole.len``,
  which writes out of bounds for hole runs longer than 1). We reverse
  correctly; single-base holes (the only memory-safe reference case)
  behave identically.
"""

from __future__ import annotations

import numpy as np

# Charset accepted by the reference type input (sequence.h:16).
ALLOWED_NUCLEOTIDES = "ACGTNWSMKRYBDHV"

# ASCII -> code lookup. A/C/G/T = 0..3, other allowed IUPAC letters get
# stable codes >= 4 (only "is ambiguous" matters algorithmically; the code
# also indexes COMPLEMENT_CODE). Everything else = 255 (invalid).
_INVALID = 255
CODE_OF = np.full(256, _INVALID, dtype=np.uint8)
for _i, _c in enumerate(ALLOWED_NUCLEOTIDES):
    CODE_OF[ord(_c)] = _i
CHAR_OF = np.frombuffer(ALLOWED_NUCLEOTIDES.encode(), dtype=np.uint8)

# Complement map over the full allowed alphabet (sequence.cpp:9-29).
_COMPLEMENT_STR = {
    "A": "T", "C": "G", "G": "C", "T": "A", "N": "N", "W": "W", "S": "S",
    "M": "K", "K": "M", "R": "Y", "Y": "R", "B": "V", "D": "H", "H": "D",
    "V": "B",
}
COMPLEMENT_CODE = np.array(
    [ALLOWED_NUCLEOTIDES.index(_COMPLEMENT_STR[c]) for c in ALLOWED_NUCLEOTIDES],
    dtype=np.uint8,
)

# Reference length cap (extension.cpp:50-51) — a Postgres varlena limit.
# Only enforced by the `nuclseq_in` parity wrapper; the engine itself is
# int64-clean.
NUCLSEQ_MAX_LEN = (2**31 - 1) // 4

_MINSTD_M = 2147483647  # 2^31 - 1
_MINSTD_G = 48271  # std::minstd_rand multiplier


def minstd_stream(seed: int, n: int) -> np.ndarray:
    """First ``n`` outputs of ``std::minstd_rand(seed)`` as uint32.

    Matches the filler RNG of the reference (sequence.cpp:214). Computed
    with O(log n) vectorized doubling: x_i = seed * g^i mod M.
    """
    seed = int(seed) % _MINSTD_M
    if seed == 0:
        seed = 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint32)
    vals = np.array([(seed * _MINSTD_G) % _MINSTD_M], dtype=np.uint64)
    g_pow = np.uint64(_MINSTD_G)  # g^len(vals) mod M
    while len(vals) < n:
        ext = (vals * g_pow) % np.uint64(_MINSTD_M)
        vals = np.concatenate([vals, ext])
        g_pow = (g_pow * g_pow) % np.uint64(_MINSTD_M)
    return vals[:n].astype(np.uint32)


def _display_char(byte: int) -> str:
    # Non-ASCII bytes render as U+FFFD in the reference's error output
    # (Postgres message encoding), which test/run.py asserts on.
    return chr(byte) if byte < 0x80 else "�"


class Sequence:
    """An immutable nucleotide sequence over the IUPAC alphabet.

    Attributes
    ----------
    codes : np.uint8[length]
        2-bit codes (0..3). Ambiguous positions hold the deterministic
        LCG filler (reference parity: sequence.cpp:232).
    hole_offsets, hole_lens : np.int64 arrays
        Run-length encoded ambiguous runs, like ``bntamb1_t``.
    hole_codes : np.uint8 array
        Alphabet code (>= 4) of each run's symbol.
    """

    __slots__ = ("codes", "hole_offsets", "hole_lens", "hole_codes")

    def __init__(self, codes, hole_offsets, hole_lens, hole_codes):
        self.codes = np.ascontiguousarray(codes, dtype=np.uint8)
        self.hole_offsets = np.ascontiguousarray(hole_offsets, dtype=np.int64)
        self.hole_lens = np.ascontiguousarray(hole_lens, dtype=np.int64)
        self.hole_codes = np.ascontiguousarray(hole_codes, dtype=np.uint8)

    # -- construction -----------------------------------------------------

    @classmethod
    def from_text(cls, text) -> "Sequence":
        """Parse from str/bytes, validating against ``ALLOWED_NUCLEOTIDES``.

        Error message parity with the reference input function
        (extension.cpp:53-58): lowercase, unknown letters, punctuation and
        non-ASCII bytes all raise
        ``ValueError("invalid nucleotide in nuclseq_in: '<c>'")``.
        """
        if isinstance(text, str):
            raw = text.encode("utf-8", errors="surrogateescape")
        else:
            raw = bytes(text)
        arr = np.frombuffer(raw, dtype=np.uint8)
        codes = CODE_OF[arr]
        bad = codes == _INVALID
        if bad.any():
            c = _display_char(int(arr[np.argmax(bad)]))
            raise ValueError(f"invalid nucleotide in nuclseq_in: '{c}'")
        return cls.from_codes(codes)

    @classmethod
    def from_codes(cls, codes: np.ndarray) -> "Sequence":
        """Build from an array of alphabet codes (0..14), computing holes
        and overwriting ambiguous positions with the LCG filler."""
        codes = np.asarray(codes, dtype=np.uint8)
        n = codes.shape[0]
        amb = codes >= 4
        amb_pos = np.flatnonzero(amb)
        if amb_pos.size:
            # run starts: non-contiguous position or symbol change
            # (reference: a new hole when prev char differs, sequence.cpp:46-57)
            prev_contig = np.empty(amb_pos.size, dtype=bool)
            prev_contig[0] = False
            prev_contig[1:] = (amb_pos[1:] == amb_pos[:-1] + 1) & (
                codes[amb_pos[1:]] == codes[amb_pos[:-1]]
            )
            starts = np.flatnonzero(~prev_contig)
            hole_offsets = amb_pos[starts].astype(np.int64)
            bounds = np.append(starts, amb_pos.size)
            hole_lens = np.diff(bounds).astype(np.int64)
            hole_codes = codes[hole_offsets]
        else:
            hole_offsets = np.zeros(0, dtype=np.int64)
            hole_lens = np.zeros(0, dtype=np.int64)
            hole_codes = np.zeros(0, dtype=np.uint8)

        out = codes.copy()
        if amb_pos.size:
            seed = len(hole_offsets) ^ n
            filler = minstd_stream(seed, amb_pos.size) & 3
            out[amb_pos] = filler.astype(np.uint8)
        return cls(out, hole_offsets, hole_lens, hole_codes)

    # -- conversion -------------------------------------------------------

    def __len__(self) -> int:
        return int(self.codes.shape[0])

    @property
    def holes_num(self) -> int:
        return int(self.hole_offsets.shape[0])

    def hole_mask(self) -> np.ndarray:
        """Boolean mask of ambiguous positions."""
        mask = np.zeros(len(self), dtype=bool)
        for off, ln in zip(self.hole_offsets, self.hole_lens):
            mask[off : off + ln] = True
        return mask

    def symbol_codes(self) -> np.ndarray:
        """Full alphabet codes (0..14): 2-bit codes with holes re-expanded."""
        out = self.codes.copy()
        for off, ln, hc in zip(self.hole_offsets, self.hole_lens, self.hole_codes):
            out[off : off + ln] = hc
        return out

    def to_text(self) -> str:
        """Decode to str (reference: inplace_to_text, sequence.cpp:71-81)."""
        return CHAR_OF[self.symbol_codes()].tobytes().decode("ascii")

    def packed(self, pad: str = "lcg") -> np.ndarray:
        """2-bit packed bytes, 4 bases/byte, base i at bits ``(~i & 3) << 1``
        (big-endian within byte, reference sequence.h:55-61).

        ``pad``: filler for the 0-3 tail positions of the last byte —
        ``"lcg"`` continues the construction RNG stream past the hole
        positions (reference sequence.cpp:241-242), ``"zero"`` zero-fills.
        """
        n = len(self)
        padded_n = (n + 3) & ~3
        buf = np.zeros(padded_n, dtype=np.uint8)
        buf[:n] = self.codes
        npad = padded_n - n
        if npad and pad == "lcg":
            n_holes_pos = int(self.hole_lens.sum())
            seed = self.holes_num ^ n
            stream = minstd_stream(seed, n_holes_pos + npad) & 3
            buf[n:] = stream[n_holes_pos:].astype(np.uint8)
        shifts = np.array([6, 4, 2, 0], dtype=np.uint8)
        return (
            (buf.reshape(-1, 4) << shifts[None, :]).astype(np.uint8).sum(axis=1, dtype=np.uint8)
        )

    # -- scalar ops (reference parity) ------------------------------------

    def occurrences(self, symbol: str) -> int:
        """Count of ``symbol`` (reference: sequence.cpp:85-107). For 2-bit
        symbols, counts only non-hole positions; for ambiguous symbols,
        sums matching hole runs."""
        code = CODE_OF[ord(symbol)]
        if code == _INVALID:
            return 0
        if code >= 4:
            return int(self.hole_lens[self.hole_codes == code].sum())
        mask = ~self.hole_mask()
        return int(np.count_nonzero(self.codes[mask] == code))

    def content(self, needle: str) -> float | None:
        """Fraction of ``needle`` (reference: extension.cpp:124-138).
        None on an empty sequence; raises on an invalid needle."""
        if len(needle) != 1 or CODE_OF[ord(needle[0]) if needle else 0] == _INVALID:
            raise ValueError(f"invalid nucleotide in nuclseq_content: '{needle}'")
        if len(self) == 0:
            return None
        return self.occurrences(needle) / len(self)

    def complement(self) -> "Sequence":
        """Base complement (reference: sequence.cpp:109-130): 2-bit codes
        map c -> 3 - c outside holes; hole filler bits are preserved;
        hole symbols map through the IUPAC complement table."""
        out = self.codes.copy()
        mask = ~self.hole_mask()
        out[mask] = 3 - out[mask]
        return Sequence(
            out,
            self.hole_offsets.copy(),
            self.hole_lens.copy(),
            COMPLEMENT_CODE[self.hole_codes],
        )

    def reverse(self) -> "Sequence":
        """Reversed sequence. Implemented as decode-reverse-reencode so hole
        geometry is correct (the reference's in-place version is defective
        for multi-base holes, see module docstring); the filler RNG seed
        (holes_num ^ len) is unchanged by reversal, matching the
        reference's re-randomization intent (sequence.cpp:139,153)."""
        return Sequence.from_codes(self.symbol_codes()[::-1])

    # -- ordering ---------------------------------------------------------

    def compare(self, other: "Sequence") -> int:
        """Lexicographic compare on 2-bit codes then length
        (reference: sequence.cpp:168-183). Note: ambiguous positions
        compare by their deterministic filler codes — replicated as-is."""
        a, b = self.codes, other.codes
        m = min(a.shape[0], b.shape[0])
        neq = np.flatnonzero(a[:m] != b[:m])
        if neq.size:
            i = neq[0]
            return -1 if a[i] < b[i] else 1
        if a.shape[0] < b.shape[0]:
            return -1
        if a.shape[0] == b.shape[0]:
            return 0
        return 1

    def __eq__(self, other):
        if not isinstance(other, Sequence):
            return NotImplemented
        return self.compare(other) == 0

    def __ne__(self, other):
        if not isinstance(other, Sequence):
            return NotImplemented
        return self.compare(other) != 0

    def __lt__(self, other):
        return self.compare(other) < 0

    def __le__(self, other):
        return self.compare(other) <= 0

    def __gt__(self, other):
        return self.compare(other) > 0

    def __ge__(self, other):
        return self.compare(other) >= 0

    def __hash__(self):
        # reference: hash opclass reuses hashvarlena over the packed bytes
        # (bioseqdb--0.0.0.sql:128-138); equal sequences have equal packed
        # bits thanks to the deterministic filler.
        return hash((len(self), self.packed().tobytes()))

    def __repr__(self):
        t = self.to_text()
        if len(t) > 60:
            t = t[:57] + "..."
        return f"Sequence({t!r}, len={len(self)}, holes={self.holes_num})"


# -- reference-compatible wrappers ---------------------------------------


def nuclseq_in(text) -> Sequence:
    """Strict parity wrapper for the reference type-input function
    (extension.cpp:46-61), including its length cap."""
    if isinstance(text, str):
        n = len(text.encode("utf-8", errors="surrogateescape"))
    else:
        n = len(text)
    if n > NUCLSEQ_MAX_LEN:
        raise ValueError("provided sequence is too long")
    return Sequence.from_text(text)


def nuclseq_out(seq: Sequence) -> str:
    return seq.to_text()


def nuclseq_len(seq: Sequence) -> int:
    return len(seq)


def nuclseq_content(seq: Sequence, needle: str) -> float | None:
    return seq.content(needle)


def nuclseq_complement(seq: Sequence) -> Sequence:
    return seq.complement()


def nuclseq_reverse(seq: Sequence) -> Sequence:
    return seq.reverse()


def nuclseq_cmp(a: Sequence, b: Sequence) -> int:
    return a.compare(b)
