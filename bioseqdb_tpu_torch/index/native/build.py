"""Compile-on-demand loader for the native SA-IS library.

The one genuinely host-native piece of the framework, mirroring where
the reference is native (libbwa's is_bwt, bwa.cpp:47). Compiled with g++
on first use and cached next to the source, keyed by a source hash so
edits invalidate the cache. Loaded with ctypes (no pybind11 in the
environment).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, f) for f in ("sais.cpp", "ksw.cpp", "finalize1.cpp")]
_lib = None


def _lib_path() -> str:
    h = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(_DIR, f"libsais_torch.{h.hexdigest()[:16]}.so")


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = _lib_path()
    if not os.path.exists(path):
        tmp = path + f".tmp.{os.getpid()}"
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-fopenmp",
             "-o", tmp, *_SRCS],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, path)  # atomic under concurrent builders
    lib = ctypes.CDLL(path)
    lib.sais_u8_i32.restype = ctypes.c_int
    lib.sais_u8_i32.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.sais_u8_i64.restype = ctypes.c_int
    lib.sais_u8_i64.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.ksw_global_c.restype = ctypes.c_int32
    lib.ksw_global_c.argtypes = [
        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.reg2aln1_batch_c.restype = None
    lib.reg2aln1_batch_c.argtypes = [
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ] + [ctypes.POINTER(ctypes.c_int32)] * 6 + [
        ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int64,
    ] + [ctypes.POINTER(ctypes.c_int32)] * 6
    lib.finalize_fast2_c.restype = None
    lib.finalize_fast2_c.argtypes = [
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
    ] + [ctypes.POINTER(ctypes.c_int64)] * 4 + [
        ctypes.POINTER(ctypes.c_int32)
    ] * 2 + [
        ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int64,
    ] + [ctypes.POINTER(ctypes.c_int32)] * 5 + [
        ctypes.POINTER(ctypes.c_int64),
    ] + [ctypes.POINTER(ctypes.c_int32)] * 3
    lib.ksw_local_c.restype = ctypes.c_int32
    lib.ksw_local_c.argtypes = [
        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ] + [ctypes.POINTER(ctypes.c_int32)] * 5
    _lib = lib
    return lib


_U8P = ctypes.POINTER(ctypes.c_uint8)


def ksw_global_native(query, target, mat, o_del, e_del, o_ins, e_ins, w):
    """Native banded global alignment; returns (score, [(len, op)]).
    Same semantics as cpu.ksw.ksw_global (the Python reference)."""
    lib = get_lib()
    q = np.ascontiguousarray(query, dtype=np.uint8)
    t = np.ascontiguousarray(target, dtype=np.uint8)
    m = np.ascontiguousarray(mat, dtype=np.int8)
    cap = q.shape[0] + t.shape[0] + 2
    cig = np.empty(cap, dtype=np.uint32)
    n = ctypes.c_int32(0)
    score = lib.ksw_global_c(
        q.shape[0], q.ctypes.data_as(_U8P),
        t.shape[0], t.ctypes.data_as(_U8P),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        int(o_del), int(e_del), int(o_ins), int(e_ins), int(w),
        cig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), cap,
        ctypes.byref(n),
    )
    ops = "MID"
    return int(score), [(int(c) >> 4, ops[int(c) & 0xF]) for c in cig[: n.value]]


_I32P = ctypes.POINTER(ctypes.c_int32)


def reg2aln1_batch(qq, rr, Lq, Lt, truesc, w_reg, clip5, clip3, mat,
                   o_del, e_del, o_ins, e_ins, a, bw):
    """Batched single-region reg2aln tail (native, OpenMP over rows).

    ``qq``/``rr``: (n, Wq)/(n, Wt) uint8 oriented query/target windows.
    Returns (cigars, mds, nm, lead_d, ref_consumed, status) where the
    strings are Python str lists and status!=0 rows must fall back to
    the per-read path.
    """
    lib = get_lib()
    n = qq.shape[0]
    qq = np.ascontiguousarray(qq, dtype=np.uint8)
    rr = np.ascontiguousarray(rr, dtype=np.uint8)
    m = np.ascontiguousarray(mat, dtype=np.int8)
    ints = [np.ascontiguousarray(x, dtype=np.int32)
            for x in (Lq, Lt, truesc, w_reg, clip5, clip3)]
    stride = 8 * (qq.shape[1] + rr.shape[1]) + 128
    text = np.empty(n * stride, dtype=np.uint8)
    outs = [np.zeros(n, dtype=np.int32) for _ in range(6)]
    lib.reg2aln1_batch_c(
        n,
        qq.ctypes.data_as(_U8P), qq.strides[0],
        rr.ctypes.data_as(_U8P), rr.strides[0],
        *[x.ctypes.data_as(_I32P) for x in ints],
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        int(o_del), int(e_del), int(o_ins), int(e_ins), int(a), int(bw),
        text.ctypes.data_as(ctypes.c_char_p), stride,
        *[o.ctypes.data_as(_I32P) for o in outs],
    )
    cig_len, md_len, nm, lead_d, ref_consumed, status = outs
    blob = text.tobytes()
    cl, ml = cig_len.tolist(), md_len.tolist()
    cigars, mds = [], []
    for i in range(n):
        off = i * stride
        cigars.append(blob[off : off + cl[i]].decode("ascii"))
        mds.append(blob[off + cl[i] : off + cl[i] + ml[i]].decode("ascii"))
    return cigars, mds, nm, lead_d, ref_consumed, status


_I64P = ctypes.POINTER(ctypes.c_int64)


def finalize_fast2(sel, codes, lens, pac, l_pac, seq_len,
                   qb, qe, rb, re, truesc, w_reg, mat,
                   o_del, e_del, o_ins, e_ins, a, bw):
    """Fused single-region finalize over selected rows (native, OpenMP).

    Extracts oriented windows from ``codes``/``pac`` in C (what
    fast_fields did in numpy), runs the reg2aln tail, and returns
    compact per-selection arrays:
      (text, stride, cig_len, md_len, nm, lead_d, ref_consumed,
       pos, clip5, clip3, status)
    ``text`` holds CIGAR then MD bytes at ``k * stride`` for selection
    slot k. status!=0 rows must fall back to the per-read path.
    """
    lib = get_lib()
    sel = np.ascontiguousarray(sel, dtype=np.int32)
    n = sel.shape[0]
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    pac = np.ascontiguousarray(pac, dtype=np.uint8)
    i64s = [np.ascontiguousarray(x, dtype=np.int64) for x in (qb, qe, rb, re)]
    i32s = [np.ascontiguousarray(x, dtype=np.int32) for x in (truesc, w_reg)]
    m = np.ascontiguousarray(mat, dtype=np.int8)
    if n:
        wq = int((i64s[1][sel] - i64s[0][sel]).max())
        wt = int((i64s[3][sel] - i64s[2][sel]).max())
    else:
        wq = wt = 1
    stride = 8 * (wq + wt) + 128
    text = np.empty(n * stride, dtype=np.uint8)
    outs32a = [np.zeros(n, dtype=np.int32) for _ in range(5)]
    pos = np.zeros(n, dtype=np.int64)
    outs32b = [np.zeros(n, dtype=np.int32) for _ in range(3)]
    lib.finalize_fast2_c(
        n, sel.ctypes.data_as(_I32P),
        codes.ctypes.data_as(_U8P), codes.strides[0],
        lens.ctypes.data_as(_I32P),
        pac.ctypes.data_as(_U8P), int(l_pac), int(seq_len),
        *[x.ctypes.data_as(_I64P) for x in i64s],
        *[x.ctypes.data_as(_I32P) for x in i32s],
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        int(o_del), int(e_del), int(o_ins), int(e_ins), int(a), int(bw),
        text.ctypes.data_as(ctypes.c_char_p), stride,
        *[o.ctypes.data_as(_I32P) for o in outs32a],
        pos.ctypes.data_as(_I64P),
        *[o.ctypes.data_as(_I32P) for o in outs32b],
    )
    cig_len, md_len, nm, lead_d, ref_consumed = outs32a
    clip5, clip3, status = outs32b
    return (text, stride, cig_len, md_len, nm, lead_d, ref_consumed,
            pos, clip5, clip3, status)


def ksw_local_native(query, target, mat, o_del, e_del, o_ins, e_ins):
    """Native local SW (ksw_align2 role). Returns
    (score, qb, qe_excl, tb, te_excl, score2)."""
    lib = get_lib()
    q = np.ascontiguousarray(query, dtype=np.uint8)
    t = np.ascontiguousarray(target, dtype=np.uint8)
    m = np.ascontiguousarray(mat, dtype=np.int8)
    outs = [ctypes.c_int32(0) for _ in range(5)]
    score = lib.ksw_local_c(
        q.shape[0], q.ctypes.data_as(_U8P),
        t.shape[0], t.ctypes.data_as(_U8P),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        int(o_del), int(e_del), int(o_ins), int(e_ins),
        *[ctypes.byref(o) for o in outs],
    )
    qb, qe, tb, te, s2 = (o.value for o in outs)
    return int(score), qb, qe + 1, tb, te + 1, s2


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of a uint8 array with an implicit appended sentinel.

    Returns SA with ``n + 1`` entries; ``SA[0] == n`` is the sentinel row.
    int32 result when it fits (n + 1 < 2**31), else int64.
    """
    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = text.shape[0]
    lib = get_lib()
    if n + 1 < 2**31:
        sa = np.empty(n + 1, dtype=np.int32)
        rc = lib.sais_u8_i32(
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n,
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    else:
        sa = np.empty(n + 1, dtype=np.int64)
        rc = lib.sais_u8_i64(
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n,
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
    if rc != 0:
        raise RuntimeError(f"sais failed with code {rc}")
    return sa
