"""Wrapper of the hand-written CUDA seed-SW kernel (csrc/seedsw.cu).

The Hopper counterpart of the JAX package's ``seed_sw_filter``
(``bioseqdb_tpu/kernels/seedsw.py``), its window bounds and its
``_local_sw_batch``: one launch of ``seed_sw_filter`` computes every seed
lane's windows and need test, scores the lanes that need it (a group of
8 threads two lanes, compacted and sorted by size within a block) and
writes the filter's ``valid`` and ``score``, reading the query window
from the read codes and the reference window from the packed doubled text
itself. The plain version is ``seedsw.seed_sw_filter_plain``;
``seedsw.seed_sw_filter`` calls ``seed_sw_filter_cuda`` on CUDA tensors.
It launches on PyTorch's current stream, allocates only its outputs, and
does not synchronise. Nothing falls back to the plain version.

``seed_sw_filter_args`` checks the tensors, allocates the outputs on
their device and gives the C entry point's arguments without the stream:
the launch entry (``seed_sw_filter_launch``) takes them and the stream; a
build of the source without nvcc has a host entry
(``seed_sw_filter_host``) that takes them alone.
"""

from __future__ import annotations

import ctypes

import torch

from bioseqdb_tpu_torch.kernels import build

WIDTH = 200   # csrc/seedsw.cu kWidth (seedsw._W)


def bind(lib: ctypes.CDLL, name: str, stream: bool = True):
    """``lib``'s entry ``name`` (``seed_sw_filter_launch`` or
    ``seed_sw_filter_host``) with its argument types: a pointer for every
    tensor (and the stream, if ``stream``), long long for the rank size,
    sizes and scores."""
    fn = getattr(lib, name)
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = [ll] + [vp] * 12 + [ll] * 13 + [vp] * stream
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple
           ) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"seed_sw: {name} must be a contiguous {dtype} "
                         f"tensor of shape {shape}, not {t.dtype} "
                         f"{tuple(t.shape)}")


def seed_sw_filter_args(fm, pac_rows, codes, lens, seeds: dict,
                        table: torch.Tensor, match_score: int,
                        mismatch_penalty: int, o_del: int, e_del: int,
                        o_ins: int, e_ins: int
                        ) -> tuple[tuple, list, list]:
    """((valid, score), allocated [B, S]; the entry's arguments; every
    tensor the launch touches) of ``seed_sw_filter`` on pac_rows int32
    (the packed doubled text), codes int32 [B, W], lens int32 [B] (each
    at most W), the seeds (rbeg [B, S] in ``fm``'s rank dtype, qbeg and
    len int32, valid bool) and ``table`` (``seedsw.activation_table``:
    int32 [W + 1, 2])."""
    if codes.dtype != torch.int32 or codes.dim() != 2 \
            or not codes.is_contiguous():
        raise ValueError(f"seed_sw: codes must be a contiguous int32 [B, W] "
                         f"tensor, not {codes.dtype} {tuple(codes.shape)}")
    B, W = codes.shape
    _check("pac_rows", pac_rows, torch.int32, tuple(pac_rows.shape))
    if pac_rows.numel() == 0:
        raise ValueError("seed_sw: pac_rows is empty")
    rdt = fm.rank_dtype
    if rdt not in (torch.int32, torch.int64):
        raise ValueError(f"seed_sw: rank dtype {rdt}")
    if seeds["rbeg"].dim() != 2 or seeds["rbeg"].shape[0] != B:
        raise ValueError(f"seed_sw: seeds must be [B, S] with B {B}")
    S = seeds["rbeg"].shape[1]
    for k, dt in (("rbeg", rdt), ("qbeg", torch.int32), ("len", torch.int32),
                  ("valid", torch.bool)):
        _check(k, seeds[k], dt, (B, S))
    _check("lens", lens, torch.int32, (B,))
    _check("table", table, torch.int32, (W + 1, 2))
    n_refs = fm.ref_offsets.shape[0]
    if n_refs < 1:
        raise ValueError("seed_sw: no references")
    _check("ref_offsets", fm.ref_offsets, rdt, (n_refs,))
    _check("ref_lens", fm.ref_lens, rdt, (n_refs,))
    dev = codes.device
    valid = torch.empty(B, S, dtype=torch.bool, device=dev)
    score = torch.empty(B, S, dtype=torch.int32, device=dev)
    ins = [codes, lens, pac_rows, seeds["rbeg"], seeds["qbeg"], seeds["len"],
           seeds["valid"], fm.ref_offsets, fm.ref_lens, table]
    args = ([rdt.itemsize] + [t.data_ptr() for t in ins + [valid, score]]
            + [pac_rows.numel(), fm.seq_len, fm.l_pac, n_refs, B * S, S, W,
               match_score, mismatch_penalty, o_del, e_del, o_ins, e_ins])
    return (valid, score), args, ins + [valid, score]


def seed_sw_filter_cuda(fm, pac_rows, codes, lens, seeds: dict,
                        table: torch.Tensor, match_score: int,
                        mismatch_penalty: int, o_del: int, e_del: int,
                        o_ins: int, e_ins: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``seedsw.seed_sw_filter_plain``'s valid and score ([B, S]) on the
    card in one launch."""
    out, args, tensors = seed_sw_filter_args(
        fm, pac_rows, codes, lens, seeds, table, match_score,
        mismatch_penalty, o_del, e_del, o_ins, e_ins)
    if out[0].numel() == 0:   # no lanes
        return out
    dev = codes.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("seed_sw takes CUDA tensors on one device")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = bind(build.library("seedsw"), "seed_sw_filter_launch")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"seed_sw_filter kernel launch failed: CUDA "
                           f"error {rc}")
    build.LAUNCHES["seed_sw"] += 1
    return out
