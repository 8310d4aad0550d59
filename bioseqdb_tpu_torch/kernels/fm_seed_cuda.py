"""Wrapper of the hand-written CUDA FM seeding machine (csrc/fm_seed.cu).

The Hopper counterpart of the JAX package's ``collect_seeds_device``
``while_loop`` (``bioseqdb_tpu/kernels/seed.py``): one launch runs every
lane of ``kernels/seed.py``'s set-up state from its first step to its
end, a thread a read, and writes the mems, n_mem, iters, it_r1, it_r2
and overflow into that state's tensors in place. The plain version is
``seed.collect_seeds_plain``; ``seed.collect_seeds_device`` calls this
on CUDA tensors. It launches on PyTorch's current stream, allocates
nothing, and does not synchronise. The kernel computes the round-3 jump
keys from the codes itself.

The candidate stacks are per-thread arrays of ``MAX_CAND`` rows, so a
``max_cand`` above it is refused (ValueError): the port's paths take 16,
24 or 32. Nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from bioseqdb_tpu_torch.kernels import build

MAX_CAND = 32   # csrc/fm_seed.cu kMaxCand
_STATE_I32 = ("lens", "phase", "round", "n_mem", "n_mem_r1", "iters",
              "it_r1", "it_r2")
_MEMS = ("mem_k", "mem_s", "mem_b", "mem_e")


def _fn():
    fn = build.library("fm_seed").fm_seed_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple
           ) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"fm_seed_cuda: {name} must be a contiguous {dtype} "
                         f"tensor of shape {shape}, not {t.dtype} "
                         f"{tuple(t.shape)}")


def fm_seed_cuda(fm, st: dict, *, jump_table: torch.Tensor | None, J: int,
                 min_seed_len: int, split_len: int, split_width: int,
                 max_mem_intv: int, max_cand: int, max_iters: int) -> None:
    """Run the FM machine on the card for every lane of ``st``
    (``seed._prepare``'s state: codes int32 [B, W], lens, phase, round,
    n_mem, n_mem_r1, iters, it_r1, it_r2 int32 [B], overflow bool [B],
    mem_k/s/b/e [B, M] in ``fm``'s rank dtype) in one launch, writing
    its outputs in place. ``J`` is the jump depth the machine takes (0:
    none), ``jump_table`` its [4^J, 3] table."""
    codes = st["codes"]
    if codes.dim() != 2:
        raise ValueError("fm_seed_cuda: codes must be [B, W]")
    B, W = codes.shape
    M = st["mem_k"].shape[1] if st["mem_k"].dim() == 2 else -1
    rdt = fm.rank_dtype
    _check("codes", codes, torch.int32, (B, W))
    for name in _STATE_I32:
        _check(name, st[name], torch.int32, (B,))
    _check("overflow", st["overflow"], torch.bool, (B,))
    for name in _MEMS:
        _check(name, st[name], rdt, (B, M))
    _check("occ_rows", fm.occ_rows, torch.int32,
           (fm.blocks.shape[0] * 8, 12))
    _check("occ_majors", fm.occ_majors, rdt, (fm.occ_majors.shape[0], 4))
    _check("L2", fm.L2, rdt, (5,))
    if J:
        _check("jump_table", jump_table, rdt, (4 ** J, 3))
    if not 1 <= max_cand <= MAX_CAND:
        raise ValueError(f"fm_seed_cuda: max_cand {max_cand} outside "
                         f"[1, {MAX_CAND}]")
    if M < 1 or W < 1:
        raise ValueError("fm_seed_cuda: needs max_mem >= 1 and W >= 1")
    dev = codes.device
    tensors = [codes, fm.occ_rows, fm.occ_majors, fm.L2,
               *(st[n] for n in _STATE_I32 + _MEMS + ("overflow",))]
    if J:
        tensors.append(jump_table)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("fm_seed_cuda takes CUDA tensors on one device")
    if fm.occ_rows.data_ptr() % 16:
        raise ValueError("fm_seed_cuda: occ_rows must be 16-byte aligned")
    if B == 0:
        return
    ptr = lambda name: st[name].data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _fn()(
        8 if rdt == torch.int64 else 4, codes.data_ptr(), ptr("lens"),
        ptr("phase"), ptr("round"), ptr("n_mem_r1"), fm.occ_rows.data_ptr(),
        fm.blocks.shape[0],
        fm.occ_majors.data_ptr(), fm.occ_majors.shape[0], fm.L2.data_ptr(),
        fm.primary, jump_table.data_ptr() if J else None,
        *(ptr(n) for n in _MEMS), ptr("n_mem"), ptr("iters"), ptr("it_r1"),
        ptr("it_r2"), ptr("overflow"), B, W, M, max_cand, J, max_iters,
        min_seed_len, split_len, split_width, max_mem_intv, stream)
    if rc != 0:
        raise RuntimeError(f"fm_seed kernel launch failed: CUDA error {rc} "
                           f"(B {B}, W {W}, M {M}, P {max_cand})")
    build.LAUNCHES["fm_seed"] += 1
