"""Wrappers of the hand-written CUDA FM-index kernels (csrc/fm.cu).

The Hopper counterparts of the JAX package's ``sa_resolve`` and
``backward_search`` loops (``bioseqdb_tpu/kernels/fm.py``): one launch of
``sa_resolve`` walks every rank lane to its sampled suffix-array row, one
launch of ``backward_search`` runs every read's backward search, a thread
a lane. The plain versions are ``fm.sa_resolve_plain`` and
``fm.backward_search_plain``; ``fm.sa_resolve`` and ``fm.backward_search``
call these on CUDA tensors. They launch on PyTorch's current stream,
allocate only their outputs, and do not synchronise. Nothing falls back
to the plain versions.

``sa_resolve_args`` and ``backward_search_args`` check the tensors,
allocate the outputs on their device and give the C entry points'
arguments without the stream: the launch entries (``*_launch``) take
them and the stream; a build of the source without nvcc has host
entries (``*_host``) that take them alone.
"""

from __future__ import annotations

import ctypes

import torch

from bioseqdb_tpu_torch.kernels import build


def bind(lib: ctypes.CDLL, name: str, stream: bool = True):
    """``lib``'s entry ``name`` with its argument types: a pointer for
    every tensor (and the stream, if ``stream``), long long for sizes and
    scalars."""
    fn = getattr(lib, name)
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    if name.startswith("sa_resolve"):
        types = ([ll] + [vp] * 4 + [ll, vp, ll, vp, vp, ll, vp, ll, vp, ll,
                                    vp] + [ll] * 4)
    else:
        types = [ll] + [vp] * 5 + [ll, vp, ll, vp] + [ll] * 4
    fn.argtypes = types + [vp] * stream
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple
           ) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"fm kernels: {name} must be a contiguous {dtype} "
                         f"tensor of shape {shape}, not {t.dtype} "
                         f"{tuple(t.shape)}")


def _occ_tables(fm) -> list:
    """Checks ``fm``'s Occ tables; their part of the entries' arguments."""
    rdt = fm.rank_dtype
    if rdt not in (torch.int32, torch.int64):
        raise ValueError(f"fm kernels: rank dtype {rdt}")
    n_octo = fm.blocks.shape[0]
    _check("occ_rows", fm.occ_rows, torch.int32, (n_octo * 8, 12))
    _check("occ_majors", fm.occ_majors, rdt, (fm.occ_majors.shape[0], 4))
    _check("L2", fm.L2, rdt, (5,))
    if n_octo < 1 or fm.occ_majors.shape[0] < 1:
        raise ValueError("fm kernels: empty Occ tables")
    if fm.occ_rows.data_ptr() % 16:
        raise ValueError("fm kernels: occ_rows must be 16-byte aligned")
    return [fm.occ_rows.data_ptr(), n_octo, fm.occ_majors.data_ptr(),
            fm.occ_majors.shape[0], fm.L2.data_ptr()]


def sa_resolve_args(fm, ranks: torch.Tensor, sa_interval: int,
                    mask: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, list, list]:
    """(pos, allocated; the entry's arguments; every tensor the launch
    touches) of ``sa_resolve`` on ``ranks`` (1-D, in ``fm``'s rank
    dtype) and ``mask`` (bool, ranks' shape, or None: every lane
    walks)."""
    rdt = fm.rank_dtype
    if ranks.dim() != 1:
        raise ValueError("fm kernels: ranks must be 1-D")
    n = ranks.shape[0]
    _check("ranks", ranks, rdt, (n,))
    if mask is not None:
        _check("mask", mask, torch.bool, (n,))
    tables = {"sa_words": (fm.sa_words, torch.int32),
              "sa_cnt": (fm.sa_cnt, torch.int32),
              "sa_majors": (fm.sa_majors, rdt),
              "sa_sample": (fm.sa_sample, rdt)}
    for name, (t, dt) in tables.items():
        if t.dim() != 1 or t.shape[0] < 1:
            raise ValueError(f"fm kernels: {name} must be a non-empty 1-D "
                             "table")
        _check(name, t, dt, (t.shape[0],))
    occ = _occ_tables(fm)
    pos = torch.empty(n, dtype=rdt, device=ranks.device)
    args = [rdt.itemsize, ranks.data_ptr(),
            None if mask is None else mask.data_ptr(), pos.data_ptr(), *occ]
    for t, _ in tables.values():
        args += [t.data_ptr(), t.shape[0]]
    args += [fm.primary, n, max(sa_interval - 1, 0)]
    tensors = [ranks, pos, fm.occ_rows, fm.occ_majors, fm.L2,
               *(t for t, _ in tables.values())]
    if mask is not None:
        tensors.append(mask)
    return pos, args, tensors


def backward_search_args(fm, codes: torch.Tensor, lens: torch.Tensor
                         ) -> tuple[tuple, list, list]:
    """((lo, hi), allocated; the entry's arguments; every tensor the
    launch touches) of ``backward_search`` on ``codes`` int32 [B, W] and
    ``lens`` int32 [B]."""
    if codes.dim() != 2:
        raise ValueError("fm kernels: codes must be [B, W]")
    B, W = codes.shape
    _check("codes", codes, torch.int32, (B, W))
    _check("lens", lens, torch.int32, (B,))
    occ = _occ_tables(fm)
    lo, hi = (torch.empty(B, dtype=fm.rank_dtype, device=codes.device)
              for _ in range(2))
    args = [fm.rank_dtype.itemsize, codes.data_ptr(), lens.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), *occ, fm.primary, fm.seq_len, B, W]
    return (lo, hi), args, [codes, lens, lo, hi, fm.occ_rows,
                            fm.occ_majors, fm.L2]


def launch(name: str, out, args: list, tensors: list):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("fm kernels take CUDA tensors on one device")
    if tensors[0].shape[0] == 0:   # no lanes
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = bind(build.library("fm"), f"{name}_launch")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    build.LAUNCHES[name] += 1
    return out


def sa_resolve_cuda(fm, ranks: torch.Tensor, sa_interval: int,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """``fm.sa_resolve_plain`` on the card in one launch: the doubled-text
    positions of ``ranks`` (1-D, rank dtype), 0 where ``mask`` is
    False."""
    return launch("sa_resolve", *sa_resolve_args(fm, ranks, sa_interval,
                                                  mask))


def backward_search_cuda(fm, codes: torch.Tensor, lens: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``fm.backward_search_plain`` on the card in one launch: (lo, hi)
    [B] in the rank dtype."""
    return launch("backward_search", *backward_search_args(fm, codes, lens))
