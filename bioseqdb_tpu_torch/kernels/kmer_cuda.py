"""Wrapper of the hand-written CUDA minimizer seeder (csrc/kmer.cu).

The Hopper counterpart of the JAX package's ``collect_seeds_kmer``
(``bioseqdb_tpu/kernels/kmer.py``): one launch runs every read's
k-mers, minimizers, table lookups, diagonal dedup, reaches, round 1,
the round-2 certificate and the round-3 chase, a warp a read. The
plain version is ``kmer.collect_seeds_kmer_plain``;
``kmer.collect_seeds_kmer`` calls this on CUDA tensors. It launches on
PyTorch's current stream, allocates only its outputs, and does not
synchronise.

The per-read state is in shared memory sized by the call, but the
kernel keeps static limits (a lane owns at most ``MAX_WIDTH / 32``
positions; the diagonal list holds ``MAX_DMAX + 1``), so a batch wider
than ``MAX_WIDTH`` or caps above ``MAX_NMZ``, ``MAX_DMAX``, ``MAX_SMAX``
or ``MAX_MEM`` are refused (ValueError): the pipeline's kmer seeder takes
W <= 320 (wider batches take the FM seeder), nmz <=
``layout.nmz_for(320)``, dmax <= 40, smax <= 14. Nothing falls back to
the plain version.

``kmer_seed_args`` checks the tensors, allocates the outputs on their
device and gives the C entry point's arguments without the stream: the
launch entry (``kmer_seed_launch``) takes them and the stream; a build
of the source without nvcc has a host entry (``kmer_seed_host``) that
takes them alone.
"""

from __future__ import annotations

import ctypes

import torch

from bioseqdb_tpu_torch.index.layout import K, WIN
from bioseqdb_tpu_torch.kernels import build

MAX_WIDTH = 320   # csrc/kmer.cu kMaxWidth (pipeline.KMER_MAX_WIDTH)
MAX_NMZ = 104     # kMaxNmz (layout.nmz_for(320))
MAX_DMAX = 40     # kMaxDmax (layout.dmax_for's cap)
MAX_SMAX = 14     # kMaxSmax (layout.smax_for's cap)
MAX_MEM = 64      # kMaxMem
BB_RANGE = (14, 26)   # layout.build_kmer_table's bucket bits
OUTPUTS = ("mem_pos", "mem_s", "mem_b", "mem_e", "n_mem", "needs_r2",
           "overflow", "why")


def bind(lib: ctypes.CDLL, name: str, stream: bool = True):
    """``lib``'s entry ``name`` with its argument types: a pointer for
    every tensor (and the stream, if ``stream``), long long for sizes
    and options."""
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong] * 14
                   + [ctypes.c_void_p] * stream)
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, dim: int) -> None:
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"kmer_seed: {name} must be a contiguous {dtype} "
                         f"tensor of {dim} dimensions, not {t.dtype} "
                         f"{tuple(t.shape)}")


def _cap(name: str, v: int, lo: int, hi: int) -> None:
    if not lo <= v <= hi:
        raise ValueError(f"kmer_seed: {name} {v} outside [{lo}, {hi}]")


def kmer_seed_args(bmeta, entries, pac_rows, seq_len: int, codes, lens,
                   bb: int, min_seed_len: int, split_len: int,
                   split_width: int, max_mem_intv: int, smax: int, dmax: int,
                   nmz: int, max_mem: int) -> tuple[dict, list, list]:
    """(the outputs, allocated; the entry's arguments; every tensor the
    launch touches) of ``kmer_seed`` on bmeta int32 [2^bb], entries int32
    [2 nrows0 + 1, 32], pac_rows int32 (the packed doubled text), codes
    int32 [B, W] and lens int32 [B]."""
    _check("bmeta", bmeta, torch.int32, 1)
    _check("entries", entries, torch.int32, 2)
    _check("pac_rows", pac_rows, torch.int32, 2)
    _check("codes", codes, torch.int32, 2)
    _check("lens", lens, torch.int32, 1)
    B, W = codes.shape
    if lens.shape[0] != B:
        raise ValueError(f"kmer_seed: lens has {lens.shape[0]} reads, codes "
                         f"{B}")
    _cap("bb", bb, *BB_RANGE)
    if bmeta.shape[0] != 1 << bb:
        raise ValueError(f"kmer_seed: bmeta has {bmeta.shape[0]} buckets, "
                         f"not 2^{bb}")
    if entries.shape[1] != 32 or entries.shape[0] % 2 != 1:
        raise ValueError(f"kmer_seed: entries must be [2 nrows0 + 1, 32], "
                         f"not {tuple(entries.shape)}")
    _cap("width", W, K + WIN - 1, MAX_WIDTH)
    _cap("nmz", nmz, 1, MAX_NMZ)
    _cap("dmax", dmax, 1, MAX_DMAX)
    _cap("smax", smax, 1, MAX_SMAX)
    _cap("max_mem", max_mem, 1, MAX_MEM)
    if min_seed_len < 1:
        raise ValueError(f"kmer_seed: min_seed_len {min_seed_len} < 1")
    if pac_rows.numel() == 0:
        raise ValueError("kmer_seed: pac_rows is empty")
    dev = codes.device
    new = lambda dt, *shape: torch.empty(shape, dtype=dt, device=dev)
    out = {k: new(torch.int32, B, max_mem) for k in OUTPUTS[:4]}
    out.update(n_mem=new(torch.int32, B), needs_r2=new(torch.bool, B),
               overflow=new(torch.bool, B), why=new(torch.int32, B))
    ins = [bmeta, entries, pac_rows, codes, lens]
    outs = [out[k] for k in OUTPUTS]
    args = ([t.data_ptr() for t in ins + outs]
            + [entries.shape[0], pac_rows.numel(), seq_len, B, W, bb,
               min_seed_len, split_len, split_width, max_mem_intv, smax,
               dmax, nmz, max_mem])
    return out, args, ins + outs


def kmer_seed_cuda(bmeta, entries, pac_rows, seq_len: int, codes, lens,
                   bb: int, min_seed_len: int, split_len: int,
                   split_width: int, max_mem_intv: int, smax: int = 12,
                   dmax: int = 24, nmz: int = 64, max_mem: int = 16) -> dict:
    """``kmer.collect_seeds_kmer_plain`` on the card in one launch:
    mem_pos, mem_s, mem_b, mem_e int32 [B, M], n_mem int32 [B],
    needs_r2 and overflow bool [B], why int32 [B]."""
    out, args, tensors = kmer_seed_args(
        bmeta, entries, pac_rows, seq_len, codes, lens, bb, min_seed_len,
        split_len, split_width, max_mem_intv, smax, dmax, nmz, max_mem)
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("kmer_seed takes CUDA tensors on one device")
    if codes.shape[0] == 0:   # no reads
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = bind(build.library("kmer"), "kmer_seed_launch")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"kmer_seed kernel launch failed: CUDA error {rc}")
    build.LAUNCHES["kmer_seed"] += 1
    return out
