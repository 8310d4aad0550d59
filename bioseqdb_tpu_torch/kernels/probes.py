"""Gather and launch probes: wrappers of ``csrc/probes.cu`` and their
plain PyTorch versions.

The Hopper counterparts of the Pallas kernels in
``tools/microbench_pallas_gather.py`` (``gather_kernel``, ``nop_kernel``)
and ``tools/microbench_mosaic_seed.py`` (``make_a``/``b``/``c``/``a2``/
``d``/``e``). They measure the pieces the seeding state machine is made
of: a batched row gather, a dependent chain of row gathers inside one
kernel, and one launch.

- ``gather_rows_cuda(tab, idx)``: ``out[b] = tab[idx[b]]`` on a dense
  int32 (N, C) table, C a multiple of 4; indices are clamped to [0, N).
- ``gather_chain_cuda(tab, idx, steps, mask, rows, floor, smem, salt)``:
  per lane, ``steps`` dependent steps ``j <- (j * 48271 + r + 11) & mask``
  from ``j = idx & mask``; ``r = tab[j, 0]`` (``rows=1``),
  ``tab[j, 0] + tab[(j * 40503 + 7) & mask, 0]`` (``rows=2``), or, with
  no load, the loop floor of ``make_d`` (``floor="d"``: ``r = 7`` in every
  lane) or of ``make_e`` (``floor="e"``: ``r = 0`` in lane 0, and every
  other lane returns its start index). ``mask`` is 2^k - 1 below N. With
  ``smem`` the kernel first copies the reachable column 0 into shared
  memory (at most 227 KB). A ``salt`` adds ``s * salt`` at step ``s``
  (0, the default, is the TPU tool's step): the tool's step is one fixed
  random mapping, so each lane soon circles a short cycle and lanes
  merge, and the rows it reads stay in cache; salted, every step reads a
  new random row, as the FM walk does (``FRESH_SALT``).
- ``add_one_cuda(x)``: ``x + 1``.

Each ``*_cuda`` wrapper takes contiguous int32 CUDA tensors, raises on
anything else, launches on PyTorch's current stream, allocates only its
output and adds one to ``build.LAUNCHES[name]``. The ``*_plain``
functions compute the same thing with PyTorch operations on any device;
the tests and ``chip_smoke.py`` hold the kernels against them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bioseqdb_tpu_torch.kernels import build

MAX_SMEM = 232_448  # bytes of shared memory one block can use on Hopper
GATHER_A, GATHER_A2 = 48271, 40503
FLOOR_R = {"d": 7, "e": 0}  # r of make_d's and make_e's step
FRESH_SALT = 0x61C88647  # odd, below 2^31 (2^32 / golden ratio, negated)


# C entry points: (pointer arguments, int arguments), then the stream
_ARGS = {"gather_rows": (3, 3), "gather_chain": (3, 8), "add_one": (2, 1)}


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(build.library("probes"), f"{name}_launch")
    n_ptr, n_int = _ARGS[name]
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_types(name: str, *tensors) -> None:
    for t in tensors:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}_cuda takes contiguous int32 tensors")


def _cuda_device(name: str, *tensors) -> torch.device:
    """The one CUDA device all ``tensors`` lie on; raises otherwise (a
    CPU tensor never falls back to the plain version here)."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}_cuda takes tensors on one CUDA device")
    return dev


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    build.LAUNCHES[name] += 1


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ---- gather_rows -----------------------------------------------------------

def gather_rows_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return tab[idx.long().clamp(0, tab.shape[0] - 1)]


def gather_rows_cuda(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _check_types("gather_rows", tab, idx)
    if tab.dim() != 2 or idx.dim() != 1 or tab.shape[1] % 4:
        raise ValueError("gather_rows_cuda takes tab (N, C) with C % 4 == 0 "
                         "and idx (B,)")
    N, C = tab.shape
    if N == 0 or tab.data_ptr() % 16:
        raise ValueError("gather_rows_cuda needs a non-empty, 16-byte "
                         "aligned table")
    dev = _cuda_device("gather_rows", tab, idx)
    B = idx.shape[0]
    out = torch.empty(B, C, dtype=torch.int32, device=dev)
    if B and C:
        _launched("gather_rows", _fn("gather_rows")(
            tab.data_ptr(), idx.data_ptr(), out.data_ptr(), B, N, C,
            _stream(dev)))
    return out


# ---- gather_chain ----------------------------------------------------------

def chain_mask(n_rows: int) -> int:
    """The largest 2^k - 1 below ``n_rows``: the chain reaches rows
    [0, mask]."""
    return (1 << (n_rows.bit_length() - 1)) - 1


def gather_chain_plain(tab: torch.Tensor, idx: torch.Tensor, steps: int,
                       mask: int, rows: int = 1, floor: str | None = None,
                       smem: bool = False, salt: int = 0,
                       seen: torch.Tensor | None = None) -> torch.Tensor:
    """The chain with PyTorch operations; ``smem`` (where the kernel keeps
    the table) does not change the result and is ignored. ``seen``, a
    bool tensor of ``mask + 1`` entries, gets every row the chain reads
    set."""
    start = idx.long()
    j = start[:1] & mask if floor == "e" else start & mask
    for s in range(steps):
        if floor is None:
            r = tab[j, 0].long()
            if seen is not None:
                seen[j] = True
            if rows == 2:
                j2 = (j * GATHER_A2 + 7) & mask
                r = r + tab[j2, 0].long()
                if seen is not None:
                    seen[j2] = True
        else:
            r = FLOOR_R[floor]
        j = (j * GATHER_A + r + 11 + s * salt) & mask
    if floor == "e":
        j = torch.cat([j, start[1:]])
    return j.to(torch.int32)


def gather_chain_cuda(tab: torch.Tensor, idx: torch.Tensor, steps: int,
                      mask: int, rows: int = 1, floor: str | None = None,
                      smem: bool = False, salt: int = 0) -> torch.Tensor:
    _check_types("gather_chain", tab, idx)
    if tab.dim() != 2 or idx.dim() != 1 or tab.shape[1] < 1:
        raise ValueError("gather_chain_cuda takes tab (N, C) and idx (B,)")
    if rows not in (1, 2) or steps < 0:
        raise ValueError("gather_chain_cuda: rows is 1 or 2, steps >= 0")
    if floor not in (None, "d", "e") or (
            floor and (rows != 1 or smem or salt)):
        raise ValueError("gather_chain_cuda: floor is None, 'd' or 'e', and "
                         "a floor reads no table (rows 1, no smem, no salt)")
    if not 0 <= salt < 2**31 or (salt and smem):
        raise ValueError("gather_chain_cuda: salt in [0, 2^31), and only "
                         "on a table read from L2 or device memory")
    if mask < 0 or mask & (mask + 1) or mask >= tab.shape[0]:
        raise ValueError("gather_chain_cuda: mask must be 2^k - 1 below the "
                         "table's row count")
    if smem and (mask + 1) * 4 > MAX_SMEM:
        raise ValueError(f"gather_chain_cuda: {mask + 1} rows do not fit in "
                         "shared memory")
    dev = _cuda_device("gather_chain", tab, idx)
    lanes = idx.shape[0]
    out = torch.empty(lanes, dtype=torch.int32, device=dev)
    if lanes:
        _launched("gather_chain", _fn("gather_chain")(
            tab.data_ptr(), idx.data_ptr(), out.data_ptr(), lanes,
            tab.shape[1], mask, steps, rows, (None, "d", "e").index(floor),
            int(smem), salt,
            _stream(dev)))
    return out


# ---- add_one ---------------------------------------------------------------

def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1


def add_one_cuda(x: torch.Tensor) -> torch.Tensor:
    _check_types("add_one", x)
    dev = _cuda_device("add_one", x)
    out = torch.empty_like(x)
    if x.numel():
        _launched("add_one", _fn("add_one")(
            x.data_ptr(), out.data_ptr(), x.numel(), _stream(dev)))
    return out
