"""Wrapper of the hand-written CUDA seed-SW kernel (csrc/seedsw.cu).

The Hopper counterpart of the JAX package's ``_local_sw_batch``
(``bioseqdb_tpu/kernels/seedsw.py``): one launch scores every seed lane
that needs it, a warp a lane, reading the query window from the read
codes and the reference window from the packed doubled text itself. The
plain version is ``seedsw.seed_sw_scores_plain``; ``seedsw.seed_sw_filter``
calls this on CUDA tensors. It launches on PyTorch's current stream,
allocates only its output, and does not synchronise (no host wait: the
lanes that do not need the SW return at once). Nothing falls back to
the plain version.

``seed_sw_args`` checks the tensors, allocates the output on their
device and gives the C entry point's arguments without the stream: the
launch entry (``seed_sw_launch``) takes them and the stream; a build of
the source without nvcc has a host entry (``seed_sw_host``) that takes
them alone.
"""

from __future__ import annotations

import ctypes

import torch

from bioseqdb_tpu_torch.kernels import build

WIDTH = 200   # csrc/seedsw.cu kWidth (seedsw._W)


def bind(lib: ctypes.CDLL, name: str, stream: bool = True):
    """``lib``'s entry ``name`` with its argument types: a pointer for
    every tensor (and the stream, if ``stream``), long long for the rank
    size, sizes and scores."""
    fn = getattr(lib, name)
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = [ll] + [vp] * 8 + [ll] * 11 + [vp] * stream
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple
           ) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"seed_sw: {name} must be a contiguous {dtype} "
                         f"tensor of shape {shape}, not {t.dtype} "
                         f"{tuple(t.shape)}")


def seed_sw_args(pac_rows, seq_len: int, codes, win: dict, match_score: int,
                 mismatch_penalty: int, o_del: int, e_del: int, o_ins: int,
                 e_ins: int) -> tuple[torch.Tensor, list, list]:
    """(the output, allocated; the entry's arguments; every tensor the
    launch touches) of ``seed_sw`` on pac_rows int32 (the packed doubled
    text), codes int32 [B, W] and the windows ``win``
    (``seedsw.seed_sw_windows``: qb, qe int32 [N]; rb, re [N] in the rank
    dtype; need bool [N]; N a multiple of B)."""
    if codes.dtype != torch.int32 or codes.dim() != 2 \
            or not codes.is_contiguous():
        raise ValueError(f"seed_sw: codes must be a contiguous int32 [B, W] "
                         f"tensor, not {codes.dtype} {tuple(codes.shape)}")
    _check("pac_rows", pac_rows, torch.int32, tuple(pac_rows.shape))
    if pac_rows.numel() == 0:
        raise ValueError("seed_sw: pac_rows is empty")
    rb = win["rb"]
    if rb.dim() != 1 or rb.dtype not in (torch.int32, torch.int64):
        raise ValueError("seed_sw: rb must be int32 or int64 [N]")
    N = rb.shape[0]
    B, W = codes.shape
    if B == 0 or N % B:
        raise ValueError(f"seed_sw: {N} lanes are not a multiple of {B} "
                         f"reads")
    for k in ("qb", "qe", "rb", "re", "need"):
        _check(k, win[k], rb.dtype if k in ("rb", "re") else
               torch.bool if k == "need" else torch.int32, (N,))
    score = torch.empty(N, dtype=torch.int32, device=codes.device)
    ins = [codes, pac_rows] + [win[k] for k in ("qb", "qe", "rb", "re",
                                                "need")]
    args = ([rb.element_size()] + [t.data_ptr() for t in ins + [score]]
            + [pac_rows.numel(), seq_len, N, N // B, W, match_score,
               mismatch_penalty, o_del, e_del, o_ins, e_ins])
    return score, args, ins + [score]


def seed_sw_cuda(pac_rows, seq_len: int, codes, win: dict, match_score: int,
                 mismatch_penalty: int, o_del: int, e_del: int, o_ins: int,
                 e_ins: int) -> torch.Tensor:
    """``seedsw.seed_sw_scores_plain`` on the card in one launch: int32
    [N], each needed lane's best local SW score, 0 elsewhere."""
    N = win["rb"].shape[0]
    if codes.shape[0] == 0 and N == 0:   # no reads
        return torch.empty(0, dtype=torch.int32, device=codes.device)
    score, args, tensors = seed_sw_args(pac_rows, seq_len, codes, win,
                                        match_score, mismatch_penalty, o_del,
                                        e_del, o_ins, e_ins)
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("seed_sw takes CUDA tensors on one device")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = bind(build.library("seedsw"), "seed_sw_launch")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"seed_sw kernel launch failed: CUDA error {rc}")
    build.LAUNCHES["seed_sw"] += 1
    return score
