"""Wrapper of the hand-written CUDA banded-SW kernel (csrc/sw_extend.cu).

The Hopper counterpart of ``bioseqdb_tpu/kernels/sw_pallas.py``
``sw_extend_batch_pallas``: same arguments and the same dict of six
int32[B] results. Scoring is the match/mismatch form (the plain version
``sw.sw_extend_batch`` with ``fill_scmat(match, mismatch)`` computes the
same thing). It launches on PyTorch's current stream, allocates only the
output, and does not synchronise (unless a wide launch is not told its
widest band, ``max_w``). A launch may take a gate, a device int32 count
(the extension stage's active reads of a round, or a side's retries):
when it reads 0 the kernel returns at once and writes nothing, so the
host need not read the count to skip the launch.

Any query width runs on the card, in one of three layouts
(``csrc/sw_extend.cu``): up to 320 (every short-read launch) a lane
keeps every column of H and E in shared memory; wider queries (long
reads) keep them in a ring over the band, sized by ``max_w``, with one
byte of query code a column beside it; where a block of that passes the
card's shared memory (Wq above 12,468 at bands up to 100, 10,420 at
200 on an H100), the wide layout keeps only the ring there and reads
the codes from ``query`` in device memory, so no width is refused. A
launch that still fails raises (RuntimeError). Nothing falls back to the
plain version or to the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels.sw import FIELDS

FULL_MAX_QLEN = 320  # widest query of the every-column layout
LAYOUTS = ("every column", "ring", "wide")  # csrc/sw_extend.cu Layout


def _fn():
    fn = build.library("sw_extend").sw_extend_gated_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def sw_extend_cuda(query, qlen, target, tlen, w0, h0, *,
                   match_score: int, mismatch_penalty: int,
                   o_del: int, e_del: int, o_ins: int, e_ins: int,
                   end_bonus: int, zdrop: int, max_w: int | None = None,
                   gate: torch.Tensor | None = None) -> dict:
    """Batched ksw_extend on the card. query int32[B, Wq] (codes 0..4),
    target int32[B, Wt], qlen/tlen/w0/h0 int32[B], all contiguous CUDA
    tensors on one device. ``max_w`` must bound every lane's w0; a launch
    wider than FULL_MAX_QLEN sizes its band ring by it, and reads it from
    w0 (a device synchronisation, so not inside a CUDA graph capture) when
    it is None. ``gate``: an int32 tensor of one element on the device;
    when it holds 0 the launch writes nothing (its outputs are
    undefined)."""
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
    if gate is not None and (gate.device != dev or gate.dtype != torch.int32
                             or gate.numel() != 1):
        raise ValueError("sw_extend_cuda: gate must be one int32 on the "
                         "inputs' device")
    if max_w is None:
        max_w = int(w0.max()) if B and WQ > FULL_MAX_QLEN else 0
    out = torch.empty(6, B, dtype=torch.int32, device=dev)
    if B:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn()(query.data_ptr(), qlen.data_ptr(), target.data_ptr(),
                   tlen.data_ptr(), w0.data_ptr(), h0.data_ptr(),
                   out.data_ptr(), B, WQ, int(target.shape[1]),
                   match_score, mismatch_penalty, o_del, e_del, o_ins, e_ins,
                   end_bonus, zdrop, max(int(max_w), 0),
                   None if gate is None else gate.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"sw_extend kernel launch failed: CUDA error "
                               f"{rc} (Wq {WQ}, max_w {max_w})")
        build.LAUNCHES["sw_extend"] += 1
    return dict(zip(FIELDS, out))


def blocks_per_sm(query_width: int, max_w: int = 200) -> int:
    """Blocks of the kernel (128 threads each) resident on one SM of the
    current card at this query width and widest band: its occupancy, for
    reports."""
    fn = build.library("sw_extend").sw_extend_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    n = fn(query_width, max_w)
    if n < 0:
        raise RuntimeError("sw_extend occupancy query failed")
    return n


def layout(query_width: int, max_w: int = 200) -> str:
    """The layout (``LAYOUTS``) a launch at this query width and widest
    band takes on the current card."""
    fn = build.library("sw_extend").sw_extend_layout
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return LAYOUTS[fn(query_width, max_w)]
