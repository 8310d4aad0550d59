"""Wrapper of the hand-written CUDA banded-SW kernel (csrc/sw_extend.cu).

The Hopper counterpart of ``bioseqdb_tpu/kernels/sw_pallas.py``
``sw_extend_batch_pallas``: same arguments and the same dict of six
int32[B] results. Scoring is the match/mismatch form (the plain version
``sw.sw_extend_batch`` with ``fill_scmat(match, mismatch)`` computes the
same thing). It launches on PyTorch's current stream, allocates only the
output, and does not synchronise.
"""

from __future__ import annotations

import ctypes

import torch

from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels.sw import FIELDS

MAX_QLEN = 320   # query width the kernel's column split supports


def _fn():
    fn = build.library("sw_extend").sw_extend_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def sw_extend_cuda(query, qlen, target, tlen, w0, h0, *,
                   match_score: int, mismatch_penalty: int,
                   o_del: int, e_del: int, o_ins: int, e_ins: int,
                   end_bonus: int, zdrop: int) -> dict:
    """Batched ksw_extend on the card. query int32[B, Wq] (codes 0..4,
    Wq <= 320), target int32[B, Wt], qlen/tlen/w0/h0 int32[B], all
    contiguous CUDA tensors on one device."""
    dev = query.device
    if dev.type != "cuda":
        raise ValueError("sw_extend_cuda takes CUDA tensors")
    B, WQ = query.shape
    vecs = (qlen, tlen, w0, h0)
    for t in (query, target, *vecs):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("sw_extend_cuda takes contiguous int32 tensors "
                             "on one CUDA device")
    if target.dim() != 2 or target.shape[0] != B or any(
            v.shape != (B,) for v in vecs):
        raise ValueError("sw_extend_cuda: inconsistent shapes")
    if WQ > MAX_QLEN:
        raise ValueError(f"sw_extend_cuda: query width {WQ} > {MAX_QLEN}")
    out = torch.empty(6, B, dtype=torch.int32, device=dev)
    if B:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn()(query.data_ptr(), qlen.data_ptr(), target.data_ptr(),
                   tlen.data_ptr(), w0.data_ptr(), h0.data_ptr(),
                   out.data_ptr(), B, WQ, int(target.shape[1]),
                   match_score, mismatch_penalty, o_del, e_del, o_ins, e_ins,
                   end_bonus, zdrop, stream)
        if rc != 0:
            raise RuntimeError(f"sw_extend kernel launch failed: CUDA error "
                               f"{rc}")
        build.LAUNCHES["sw_extend"] += 1
    return dict(zip(FIELDS, out))
