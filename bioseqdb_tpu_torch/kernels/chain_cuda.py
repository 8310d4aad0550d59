"""Wrappers of the hand-written CUDA chaining kernels (csrc/chain.cu).

The Hopper counterparts of the JAX package's ``chain_seeds`` and
``filter_chains`` loops (``bioseqdb_tpu/kernels/chain.py``): one launch of
``chain_seeds`` runs mem_chain's insertion loop over every seed slot of
every read, one launch of ``filter_chains`` mem_chain_flt's weight,
shadow and promotion loops, a thread a read. The plain versions are
``chain.chain_seeds_plain`` and ``chain.filter_chains_plain``;
``chain.chain_seeds`` and ``chain.filter_chains`` call these on CUDA
tensors. They launch on PyTorch's current stream, allocate only their
outputs, and do not synchronise.

The chain state is per-thread arrays of ``MAX_CHAINS`` slots, so a
``max_chains`` above it is refused (ValueError): the port's paths take
16, 32 or 64. Nothing falls back to the plain versions.

``chain_seeds_args`` and ``filter_chains_args`` check the tensors,
allocate the outputs on their device and give the C entry points'
arguments without the stream: the launch entries (``*_launch``) take
them and the stream; a build of the source without nvcc has host
entries (``*_host``) that take them alone.
"""

from __future__ import annotations

import ctypes

import torch

from bioseqdb_tpu_torch.kernels import build

MAX_CHAINS = 64   # csrc/chain.cu kMaxChains
CHAIN_FIELDS = ("pos", "rid", "f_qbeg", "f_rbeg", "l_qbeg", "l_rbeg",
                "l_len")
_RANK = ("pos", "f_rbeg", "l_rbeg")


def bind(lib: ctypes.CDLL, name: str, stream: bool = True):
    """``lib``'s entry ``name`` with its argument types: a pointer for
    every tensor (and the stream, if ``stream``), long long for sizes
    and options, double for the filter's two ratios."""
    fn = getattr(lib, name)
    ll, vp, dbl = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_double
    if name.startswith("chain_seeds"):
        types = [ll] + [vp] * 15 + [ll] * 6
    else:
        types = [ll] + [vp] * 11 + [dbl] * 2 + [ll] * 6
    fn.argtypes = types + [vp] * stream
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple
           ) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"chain kernels: {name} must be a contiguous "
                         f"{dtype} tensor of shape {shape}, not {t.dtype} "
                         f"{tuple(t.shape)}")


def _seeds(seeds: dict, keys: tuple) -> tuple[int, int, torch.dtype]:
    """(B, S, rank dtype) of ``seeds``, whose ``keys`` are checked."""
    rbeg = seeds["rbeg"]
    if rbeg.dim() != 2 or rbeg.dtype not in (torch.int32, torch.int64):
        raise ValueError("chain kernels: rbeg must be int32 or int64 [B, S]")
    B, S = rbeg.shape
    for k in keys:
        _check(k, seeds[k], rbeg.dtype if k == "rbeg" else
               torch.bool if k == "valid" else torch.int32, (B, S))
    return B, S, rbeg.dtype


def _on_card(tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("chain kernels take CUDA tensors on one device")


def _chains(C: int) -> None:
    if not 1 <= C <= MAX_CHAINS:
        raise ValueError(f"chain kernels: max_chains {C} outside "
                         f"[1, {MAX_CHAINS}]")


def chain_seeds_args(seeds: dict, l_pac: int, max_chains: int,
                     bandwidth: int, max_chain_gap: int
                     ) -> tuple[dict, list, list]:
    """(the outputs, allocated; the entry's arguments; every tensor the
    launch touches) of ``chain_seeds`` on ``seeds`` (rbeg [B, S] in the
    rank dtype, qbeg, len, rid int32 [B, S], valid bool [B, S])."""
    B, S, rdt = _seeds(seeds, ("rbeg", "qbeg", "len", "rid", "valid"))
    C = max_chains
    _chains(C)
    info = torch.iinfo(rdt)
    if not info.min <= l_pac <= info.max:
        raise ValueError(f"chain kernels: l_pac {l_pac} outside {rdt}")
    dev = seeds["rbeg"].device
    new = lambda dt, *shape: torch.empty(shape, dtype=dt, device=dev)
    out = {k: new(rdt if k in _RANK else torch.int32, B, C)
           for k in CHAIN_FIELDS}
    out.update(n=new(torch.int32, B), assign=new(torch.int32, B, S),
               overflow=new(torch.bool, B))
    ins = [seeds[k] for k in ("rbeg", "qbeg", "len", "rid", "valid")]
    outs = list(out.values())
    args = ([rdt.itemsize] + [t.data_ptr() for t in ins + outs]
            + [l_pac, B, S, C, bandwidth, max_chain_gap])
    return out, args, ins + outs


def filter_chains_args(chains: dict, seeds: dict, mask_level: float,
                       chain_drop_ratio: float, min_chain_weight: int,
                       min_seed_len: int, max_chain_gap: int
                       ) -> tuple[dict, list, list]:
    """(the outputs, allocated; the entry's arguments; every tensor the
    launch touches) of ``filter_chains`` on ``chains`` (``chain_seeds``'
    n int32 [B], assign int32 [B, S], pos [B, C] in the rank dtype) and
    ``seeds`` (rbeg, qbeg, len)."""
    B, S, rdt = _seeds(seeds, ("rbeg", "qbeg", "len"))
    pos = chains["pos"]
    C = pos.shape[1] if pos.dim() == 2 else -1
    _chains(C)
    _check("pos", pos, rdt, (B, C))
    _check("n", chains["n"], torch.int32, (B,))
    _check("assign", chains["assign"], torch.int32, (B, S))
    dev = pos.device
    out = {k: torch.empty(B, C, dtype=torch.int32, device=dev)
           for k in ("weight", "kept", "order", "beg", "end")}
    ins = [chains["assign"], chains["n"], pos, seeds["rbeg"], seeds["qbeg"],
           seeds["len"]]
    outs = list(out.values())
    args = ([rdt.itemsize] + [t.data_ptr() for t in ins + outs]
            + [float(mask_level), float(chain_drop_ratio), min_chain_weight,
               min_seed_len, max_chain_gap, B, S, C])
    return out, args, ins + outs


def launch(name: str, out: dict, args: list, tensors: list) -> dict:
    _on_card(tensors)
    if tensors[0].shape[0] == 0:   # no reads
        return out
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    rc = bind(build.library("chain"), f"{name}_launch")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    build.LAUNCHES[name] += 1
    return out


def chain_seeds_cuda(seeds: dict, l_pac: int, max_chains: int,
                     bandwidth: int, max_chain_gap: int) -> dict:
    """``chain.chain_seeds_plain`` on the card in one launch: the chain
    tables [B, C] (pos, f_rbeg, l_rbeg in the rank dtype; rid, f_qbeg,
    l_qbeg, l_len int32), n int32 [B], assign int32 [B, S], overflow
    bool [B]."""
    return launch("chain_seeds", *chain_seeds_args(
        seeds, l_pac, max_chains, bandwidth, max_chain_gap))


def filter_chains_cuda(chains: dict, seeds: dict, mask_level: float,
                       chain_drop_ratio: float, min_chain_weight: int,
                       min_seed_len: int, max_chain_gap: int) -> dict:
    """``chain.filter_chains_plain`` on the card in one launch: weight,
    kept, order, beg, end int32 [B, C]."""
    return launch("filter_chains", *filter_chains_args(
        chains, seeds, mask_level, chain_drop_ratio, min_chain_weight,
        min_seed_len, max_chain_gap))
