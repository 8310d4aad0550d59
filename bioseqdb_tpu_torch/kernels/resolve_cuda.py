"""Wrappers of the hand-written CUDA kernels of seed resolution
(csrc/resolve.cu).

The Hopper counterparts of the JAX package's ``resolve_seeds``
(``bioseqdb_tpu/kernels/chain.py``) around its SA walk: one launch of
``resolve_expand`` sorts each read's seed intervals and expands them into
its seed slots (the walk's ranks and mask, each read's count of walking
lanes), ``fm.sa_resolve`` walks, and one launch of ``resolve_finish``
applies the compaction cap and the bridge and reference tests and writes
``resolve_seeds``' dict; a warp a read each. The plain version is
``chain.resolve_seeds_plain``; ``chain.resolve_seeds`` calls these on
CUDA tensors, and ``chain.resolve_seeds_sharded`` under an index group
(around the sharded walk). They launch on PyTorch's current stream,
allocate only their outputs, and do not synchronise. Nothing falls back
to the plain version.

A read's intervals live in shared memory (M is 16 to 142 on the port's
1,500 bp paths), or, where they do not fit a block's ``SMEM_BYTES`` (M
past 1,536 with int32 ranks, 877 with int64: reads of about 24 kb and
13 kb on the FM seeder's M = W // 16 + 48), in a scratch buffer of
``expand_bytes(M)`` bytes a read that ``expand_args`` allocates on the
device. No read length is refused.

``expand_args`` and ``finish_args`` check the tensors, allocate the
outputs on their device and give the entry's argument array: the rank
dtype's size in bytes, the pointers, then the sizes, in the order
``EXPAND_ARGS`` and ``FINISH_ARGS`` name them. The launch entries
(``resolve_*_launch``) take the array, its length and the stream; a
build of the source without nvcc has host entries (``resolve_*_host``)
that take the array and its length.
"""

from __future__ import annotations

import torch

from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels.extend_cuda import array, bind, pack_args

SMEM_BYTES = 49152   # csrc/resolve.cu kSmem
EXPAND_ARGS = ("mems", "n_mem", "ranks", "start", "slen", "walk", "posrow",
               "n_walk", "over", "scratch")
FINISH_ARGS = ("ranks", "start", "slen", "walk", "posrow", "n_walk", "over",
               "pos", "ends", "ref_offsets", "rbeg", "qbeg", "len", "rid",
               "valid", "overflow")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple
           ) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"resolve kernels: {name} must be a contiguous "
                         f"{dtype} tensor of shape {shape}, not {t.dtype} "
                         f"{tuple(t.shape)}")


def expand_bytes(M: int, rank_dtype: torch.dtype) -> int:
    """A read's bytes of ``resolve_expand``'s interval tables (csrc/
    resolve.cu ``expand_bytes``): six rank values and two int32 an
    interval, rounded up to 16."""
    return (M * (6 * rank_dtype.itemsize + 8) + 15) // 16 * 16


def expand_args(mems: torch.Tensor, n_mem: torch.Tensor, max_occ: int,
                max_seeds: int) -> tuple[dict, list, list]:
    """(outputs, allocated; the entry's arguments; every tensor the launch
    touches) of ``resolve_expand`` on ``mems`` [B, M, 5] (k, l, s, start,
    end in the rank dtype) and ``n_mem`` int32 [B]: ``ranks``, ``start``,
    ``slen`` [B, S] in the rank dtype, ``walk`` and ``posrow`` bool [B,
    S], ``n_walk`` int32 [B] and ``over`` bool [B]; past ``SMEM_BYTES``
    a read, the scratch of the reads' interval tables too."""
    if mems.dim() != 3 or mems.shape[2] != 5 or mems.dtype not in (
            torch.int32, torch.int64):
        raise ValueError("resolve kernels: mems must be int32 or int64 "
                         "[B, M, 5]")
    B, M, _ = mems.shape
    S = max_seeds
    rdt = mems.dtype
    if not (M >= 1 and S >= 1 and max_occ >= 1):
        raise ValueError(f"resolve kernels: M {M}, S {S} or max_occ "
                         f"{max_occ} below 1")
    _check("mems", mems, rdt, (B, M, 5))
    _check("n_mem", n_mem, torch.int32, (B,))
    dev = mems.device
    new = lambda dt, *shape: torch.empty(shape, dtype=dt, device=dev)
    out = dict(ranks=new(rdt, B, S), start=new(rdt, B, S),
               slen=new(rdt, B, S), walk=new(torch.bool, B, S),
               posrow=new(torch.bool, B, S), n_walk=new(torch.int32, B),
               over=new(torch.bool, B))
    per_read = expand_bytes(M, rdt)
    scratch = (new(torch.uint8, B * per_read) if per_read > SMEM_BYTES
               else None)
    args, tensors = pack_args(rdt, dict(out, mems=mems, n_mem=n_mem,
                                        scratch=scratch),
                              EXPAND_ARGS, [B, M, S, max_occ])
    return out, args, tensors


def finish_args(fm, ex: dict, pos: torch.Tensor, ends: torch.Tensor | None,
                cap: int) -> tuple[dict, list, list]:
    """(outputs, arguments, tensors) of ``resolve_finish`` on
    ``resolve_expand``'s outputs ``ex``, the walked positions ``pos`` [B,
    S] and ``ends`` (int64 [B], the batch's running count of walking lanes
    through each read, or None: no lane is past the cap ``cap``), on
    ``fm``'s reference table: ``resolve_seeds``' dict."""
    ranks = ex["ranks"]
    if ranks.dim() != 2:
        raise ValueError("resolve kernels: ranks must be [B, S]")
    B, S = ranks.shape
    rdt = ranks.dtype
    if rdt != fm.rank_dtype:
        raise ValueError(f"resolve kernels: ranks {rdt}, index "
                         f"{fm.rank_dtype}")
    for k, dt, shape in (("ranks", rdt, (B, S)), ("start", rdt, (B, S)),
                         ("slen", rdt, (B, S)), ("walk", torch.bool, (B, S)),
                         ("posrow", torch.bool, (B, S)),
                         ("n_walk", torch.int32, (B,)),
                         ("over", torch.bool, (B,))):
        _check(k, ex[k], dt, shape)
    _check("pos", pos, rdt, (B, S))
    if ends is not None:
        _check("ends", ends, torch.int64, (B,))
    offs = fm.ref_offsets
    if offs.dim() != 1 or offs.shape[0] < 1:
        raise ValueError("resolve kernels: no reference offsets")
    _check("ref_offsets", offs, rdt, (offs.shape[0],))
    dev = ranks.device
    new = lambda dt, *shape: torch.empty(shape, dtype=dt, device=dev)
    out = dict(rbeg=new(rdt, B, S), qbeg=new(torch.int32, B, S),
               len=new(torch.int32, B, S), rid=new(torch.int32, B, S),
               valid=new(torch.bool, B, S), overflow=new(torch.bool, B))
    named = dict(ex, pos=pos, ends=ends, ref_offsets=offs, **out)
    args, tensors = pack_args(rdt, named, FINISH_ARGS,
                              [B, S, offs.shape[0], cap, fm.l_pac,
                               fm.seq_len])
    return out, args, tensors


def launch(kernel: str, out, args: list, tensors: list):
    """Launch ``kernel`` of csrc/resolve.cu on the tensors' device and
    count it."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("resolve kernels take CUDA tensors on one device")
    if tensors[0].numel() == 0:   # no reads
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = bind(build.library("resolve"), f"{kernel}_launch")(
        array(args), len(args), stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    build.LAUNCHES[kernel] += 1
    return out


def host_launcher(lib):
    """``launch`` on ``lib``, a host build of csrc/resolve.cu
    (``tools/resolve_calls.py`` ``host_library``): the kernel's ``_host``
    entry on CPU tensors, nothing counted."""
    def run(kernel: str, out, args: list, tensors: list):
        if any(t.device.type != "cpu" for t in tensors):
            raise ValueError("the host build takes CPU tensors")
        if tensors[0].numel() == 0:
            return out
        rc = bind(lib, f"{kernel}_host", stream=False)(array(args),
                                                      len(args))
        if rc != 0:
            raise RuntimeError(f"{kernel}_host refused its arguments ({rc})")
        return out
    return run


def resolve_expand_cuda(mems: torch.Tensor, n_mem: torch.Tensor,
                        max_occ: int, max_seeds: int) -> dict:
    """``resolve_seeds_plain`` up to the walk, on the card in one launch."""
    return launch("resolve_expand", *expand_args(mems, n_mem, max_occ,
                                                 max_seeds))


def resolve_finish_cuda(fm, ex: dict, pos: torch.Tensor,
                        ends: torch.Tensor | None, cap: int) -> dict:
    """``resolve_seeds_plain`` from the walk on, on the card in one
    launch."""
    return launch("resolve_finish", *finish_args(fm, ex, pos, ends, cap))
