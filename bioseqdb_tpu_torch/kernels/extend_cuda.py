"""Wrappers of the hand-written CUDA kernels of the extension stage
(csrc/extend.cu).

The Hopper counterparts of the loops around the SW kernel in the JAX
package's ``extend_all`` (``bioseqdb_tpu/kernels/extend.py``): one launch
of ``extend_setup`` computes the seed processing order and the chains'
windows (a warp a read, both stable argsorts as counting ranks), one
of ``extend_scan`` runs every trip of a round's containment scan, one of
``extend_windows`` writes both sides' SW buffers in the sorted lane order,
``extend_merge`` (two entries, one a side) folds a side's SW results into
the lanes, and ``extend_seedcov`` sums each region's seeds. The scan runs
a warp a read (32 cursors a pass, the first that stops taken by a
ballot), the right merge a group of 8 threads a read (its region-table
and was_ext copies coalesced), the windows a warp a sorted row, and the
left merge and seedcov a thread a read. The plain versions are
``extend.extend_setup_plain``, ``extend_scan_plain``,
``extend_windows_plain``, ``extend_merge_plain`` and
``extend_seedcov_plain``, with the same arguments and outputs;
``kernels/extend.py`` calls these on CUDA tensors. They launch on
PyTorch's current stream, allocate only their outputs, and do not
synchronise.

The rounds' guards stay on the card: the scan adds its active reads to
``count`` (an int32 on the device), and the windows and merges take such
a count as ``gate``: at 0 the windows write only their small outputs
(no SW buffer) and the merges write nothing. A gated right merge writes
the new state into the old one's tensors (only the new row, the slot's
was_ext, n_regs and the cursor), so a round whose gate is closed leaves
the state as it was; without a gate it writes new tensors.

A read's regions live in ``MAX_REGS`` slots (the scan's in shared
memory, seedcov's in per-thread arrays), so a region table wider than
that is refused (ValueError): the port's paths take 8, or 16 in the fat
retry. Seeds (S) and chains (C) stream from device memory, but in the
set-up, which holds a read's in shared memory (the port's paths take S
64 and C 16, 128 and 32 in the fat retry, 189 and 32 on 1,500 bp reads;
S grows with the read, W // 12 + 64), or where they do not fit a block's
``SETUP_SMEM`` (S past 3,056 with int32 ranks at C 32, 2,037 with int64)
in a scratch buffer of ``setup_bytes(S, C)`` bytes a read that
``setup_args`` allocates on the device: no read length is refused.
Nothing falls back to the plain versions.

Each ``*_args`` function checks the tensors, allocates the outputs on
their device and gives the entry's argument array: the rank dtype's size
in bytes, then the pointers, then the sizes and options, in the order
its list names them. The launch entries (``extend_*_launch``) take the
array, its length and the stream; a build of the source without nvcc has
host entries (``extend_*_host``) that take the array and its length.
"""

from __future__ import annotations

import ctypes

import torch

from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels.sw import FIELDS

MAX_REGS = 16   # csrc/extend.cu kMaxRegs
SETUP_SMEM = 49152   # csrc/extend.cu kSetupSmem
# the region table's fields, in the order the kernels take them
REG_FIELDS = ("rb", "re", "qb", "qe", "score", "truesc", "w", "seedlen0",
              "cchain", "rid")
# the left merge's outputs that the right merge reads
LEFT_FIELDS = ("qb", "rb", "score", "truesc", "aw")
OPTS = ("match_score", "o_del", "e_del", "o_ins", "e_ins", "bandwidth")
_SEEDS = ("rbeg", "qbeg", "len", "cis")
# the entries' pointer lists (after the rank size), inputs then outputs
SCAN_ARGS = (("order", "n_usable") + _SEEDS
             + ("valid", "lens", "rmax0", "rmax1", "rb", "re", "qb", "qe",
                "w", "seedlen0", "n_regs", "was_ext", "cursor", "overflow")
             + ("cursor_out", "overflow_out", "slot", "act", "work", "count"))
WINDOWS_ARGS = (("perm", "slot", "act") + _SEEDS
                + ("lens", "rmax0", "rmax1", "codes", "pac")
                + ("qbuf", "tbuf", "qn", "tn", "active", "h0", "inv", "gate"))
MERGE_ARGS = (("inv", "retry") + tuple(f"r1.{f}" for f in FIELDS)
              + tuple(f"r2.{f}" for f in FIELDS) + ("slot", "act") + _SEEDS
              + ("lens",) + tuple(f"left.{f}" for f in LEFT_FIELDS))
MERGE_LEFT_ARGS = MERGE_ARGS + ("h0", "gate")
MERGE_RIGHT_ARGS = (MERGE_ARGS + ("crid",)
                    + tuple(f"regs.{f}" for f in REG_FIELDS)
                    + ("n_regs", "was_ext", "cursor")
                    + tuple(f"out.{f}" for f in REG_FIELDS)
                    + ("out.n_regs", "out.was_ext", "out.cursor", "gate"))
SEEDCOV_ARGS = _SEEDS + ("ok", "rb", "re", "qb", "qe", "cchain", "seedcov")
SETUP_ARGS = (("rbeg", "qbeg", "len", "valid", "score", "assign", "forder",
               "kept", "f_rbeg", "crid", "lens", "ref_offsets", "ref_lens")
              + ("order", "n_usable", "cis", "ok", "rmax0", "rmax1",
                 "scratch"))
# the set-up's outputs beside the seed tables it passes on
SETUP_FIELDS = ("order", "n_usable", "cis", "ok", "rmax0", "rmax1")
_RANK = ("rbeg", "rmax0", "rmax1", "rb", "re")


def bind(lib: ctypes.CDLL, name: str, stream: bool = True):
    """``lib``'s entry ``name`` with its argument types: the array, its
    length (and the stream, if ``stream``)."""
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong]
                   + [ctypes.c_void_p] * stream)
    fn.restype = ctypes.c_int
    return fn


def array(args: list):
    """``args`` as the entries' C array of 64-bit integers."""
    return (ctypes.c_longlong * len(args))(*args)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple
           ) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"extend kernels: {name} must be a contiguous "
                         f"{dtype} tensor of shape {shape}, not {t.dtype} "
                         f"{tuple(t.shape)}")


def _tables(tab: dict, keys: tuple) -> tuple[int, int, int, torch.dtype]:
    """(B, S, C, rank dtype) of the seed tables ``tab``, whose ``keys``
    are checked: order, qbeg, len, cis int32 [B, S], rbeg [B, S] in the
    rank dtype, valid and ok bool [B, S], n_usable and lens int32 [B],
    rmax0 and rmax1 [B, C] in the rank dtype, crid int32 [B, C], codes
    int32 [B, W]."""
    rbeg = tab["rbeg"]
    if rbeg.dim() != 2 or rbeg.dtype not in (torch.int32, torch.int64):
        raise ValueError("extend kernels: rbeg must be int32 or int64 [B, S]")
    B, S = rbeg.shape
    C = tab["rmax0"].shape[1] if tab["rmax0"].dim() == 2 else -1
    if S < 1 or C < 1:
        raise ValueError(f"extend kernels: S {S} and C {C} must be >= 1")
    rdt = rbeg.dtype
    shapes = dict(n_usable=(B,), lens=(B,), rmax0=(B, C), rmax1=(B, C),
                  crid=(B, C), codes=(B, tab["codes"].shape[-1]))
    for k in keys:
        dt = (rdt if k in _RANK else torch.bool if k in ("valid", "ok")
              else torch.int32)
        _check(k, tab[k], dt, shapes.get(k, (B, S)))
    return B, S, C, rdt


def _regs(regs: dict, keys, B: int, rdt: torch.dtype, prefix: str = ""
          ) -> int:
    """R of the region table ``regs`` ([B, R]: rb, re in the rank dtype,
    the others int32), whose ``keys`` are checked; R must be in [1,
    MAX_REGS]."""
    R = regs["rb"].shape[1] if regs["rb"].dim() == 2 else -1
    if not 1 <= R <= MAX_REGS:
        raise ValueError(f"extend kernels: {R} regions a read outside "
                         f"[1, {MAX_REGS}]")
    for k in keys:
        _check(prefix + k, regs[k], rdt if k in _RANK else torch.int32,
               (B, R))
    return R


def pack_args(rdt: torch.dtype, named: dict, order: tuple, sizes: list
          ) -> tuple[list, list]:
    """(the entry's argument array: the rank size, the pointers of
    ``named``'s tensors in ``order`` (0 for a None or missing one),
    ``sizes``; those tensors)."""
    tensors = [named.get(k) for k in order]
    return ([rdt.itemsize] + [0 if t is None else t.data_ptr()
                              for t in tensors]
            + [int(v) for v in sizes]), [t for t in tensors if t is not None]


def _count(name: str, t: torch.Tensor | None, device) -> None:
    """A gate or count: None, or one int32 on ``device``."""
    if t is not None and (t.dtype != torch.int32 or t.numel() != 1
                          or t.device != device):
        raise ValueError(f"extend kernels: {name} must be one int32 on the "
                         "tables' device")


def _flat(prefix: str, d: dict, keys) -> dict:
    return {f"{prefix}.{k}": d[k] for k in keys}


def scan_args(tab: dict, st: dict, p: dict, count=None
              ) -> tuple[dict, list, list]:
    """(the outputs, allocated; the entry's arguments; every tensor the
    launch touches) of ``extend_scan`` (``extend_scan_plain``'s);
    ``count`` (one int32 on the device, or None) gets the round's active
    reads added."""
    B, S, C, rdt = _tables(tab, ("order", "n_usable", "rbeg", "qbeg", "len",
                                 "cis", "valid", "lens", "rmax0", "rmax1"))
    regs = st["regs"]
    R = _regs(regs, ("rb", "re", "qb", "qe", "w", "seedlen0"), B, rdt)
    for k, dt, shape in (("n_regs", torch.int32, (B,)),
                         ("was_ext", torch.bool, (B, S)),
                         ("cursor", torch.int32, (B,)),
                         ("overflow", torch.bool, (B,))):
        _check(k, st[k], dt, shape)
    dev = tab["rbeg"].device
    _count("count", count, dev)
    new = lambda dt, *shape: torch.empty(shape, dtype=dt, device=dev)
    out = dict(cursor=new(torch.int32, B), overflow=new(torch.bool, B),
               slot=new(torch.int32, B), act=new(torch.bool, B),
               work=new(torch.int32, 2, B))
    named = dict(tab, **regs, n_regs=st["n_regs"], was_ext=st["was_ext"],
                 cursor=st["cursor"], overflow=st["overflow"],
                 cursor_out=out["cursor"], overflow_out=out["overflow"],
                 slot=out["slot"], act=out["act"], work=out["work"],
                 count=count)
    args, tensors = pack_args(rdt, named, SCAN_ARGS,
                              [B, S, C, R] + [p[k] for k in OPTS])
    return out, args, tensors


def windows_args(tab: dict, seq_len: int, pac: torch.Tensor, scan: dict,
                 perm: torch.Tensor, p: dict, gate=None
                 ) -> tuple[dict, list, list]:
    """(outputs, arguments, tensors) of ``extend_windows`` on the packed
    doubled text ``pac`` (int32, 16 bases a word) of ``seq_len`` bases and
    the sorted order ``perm`` (int64 [2, B]); at a ``gate`` of 0 the SW
    buffers are not written."""
    B, S, C, rdt = _tables(tab, ("rbeg", "qbeg", "len", "cis", "lens",
                                 "rmax0", "rmax1", "codes"))
    W = tab["codes"].shape[1]
    T = W + 4 * p["bandwidth"] + 64
    if pac.dtype != torch.int32 or not pac.is_contiguous() or not pac.numel():
        raise ValueError("extend kernels: pac must be a contiguous int32 "
                         "table of the packed doubled text")
    if not 0 <= seq_len <= torch.iinfo(rdt).max:
        raise ValueError(f"extend kernels: seq_len {seq_len} outside {rdt}")
    _check("perm", perm, torch.int64, (2, B))
    _check("slot", scan["slot"], torch.int32, (B,))
    _check("act", scan["act"], torch.bool, (B,))
    dev = tab["rbeg"].device
    _count("gate", gate, dev)
    new = lambda dt, *shape: torch.empty(shape, dtype=dt, device=dev)
    out = dict(qbuf=new(torch.int32, 2, B, W), tbuf=new(torch.int32, 2, B, T),
               qn=new(torch.int32, 2, B), tn=new(torch.int32, 2, B),
               active=new(torch.bool, 2, B), h0=new(torch.int32, B),
               inv=new(torch.int32, 2, B))
    named = dict(tab, perm=perm, slot=scan["slot"], act=scan["act"], pac=pac,
                 gate=gate, **out)
    args, tensors = pack_args(rdt, named, WINDOWS_ARGS,
                              [B, S, C, W, T, pac.numel(), seq_len,
                               p["match_score"]])
    return out, args, tensors


def merge_args(side: int, tab: dict, st: dict, scan: dict, win: dict,
               r1: dict, r2: dict, retry: torch.Tensor, p: dict,
               left: dict | None = None, gate=None
               ) -> tuple[dict, list, list]:
    """(outputs, arguments, tensors) of ``extend_merge`` after side
    ``side``'s SW (0: left, its outputs LEFT_FIELDS and h0; 1: right,
    ``left`` the left merge's outputs, its output the new state: with a
    ``gate``, written into ``st``'s tensors, which it returns). At a
    ``gate`` of 0 nothing is written."""
    B, S, C, rdt = _tables(tab, ("rbeg", "qbeg", "len", "cis", "lens")
                           + (("crid",) if side else ()))
    regs = st["regs"]
    R = _regs(regs, REG_FIELDS, B, rdt)
    named = dict(tab, inv=win["inv"], retry=retry, slot=scan["slot"],
                 act=scan["act"], **_flat("r1", r1, FIELDS),
                 **_flat("r2", r2, FIELDS))
    for k, dt, shape in (("inv", torch.int32, (2, B)),
                         ("retry", torch.bool, (B,)),
                         ("slot", torch.int32, (B,)),
                         ("act", torch.bool, (B,)),
                         *((f"r{i}.{f}", torch.int32, (B,))
                           for i in (1, 2) for f in FIELDS)):
        _check(k, named[k], dt, shape)
    dev = tab["rbeg"].device
    _count("gate", gate, dev)
    named["gate"] = gate
    new = lambda dt, *shape: torch.empty(shape, dtype=dt, device=dev)
    lane = lambda f: rdt if f == "rb" else torch.int32
    if side == 0:
        out = {f: new(lane(f), B) for f in LEFT_FIELDS}
        out["h0"] = new(torch.int32, B)
        named.update(_flat("left", out, LEFT_FIELDS), h0=out["h0"])
        order = MERGE_LEFT_ARGS
    else:
        for f in LEFT_FIELDS:
            _check(f"left.{f}", left[f], lane(f), (B,))
        for k, dt, shape in (("n_regs", torch.int32, (B,)),
                             ("was_ext", torch.bool, (B, S)),
                             ("cursor", torch.int32, (B,))):
            _check(k, st[k], dt, shape)
        if gate is not None:
            out = dict(regs=dict(regs), n_regs=st["n_regs"],
                       was_ext=st["was_ext"], cursor=st["cursor"])
        else:
            out = dict(regs={k: torch.empty_like(regs[k])
                             for k in REG_FIELDS},
                       n_regs=new(torch.int32, B),
                       was_ext=new(torch.bool, B, S),
                       cursor=new(torch.int32, B))
        named.update(_flat("left", left, LEFT_FIELDS),
                     **_flat("regs", regs, REG_FIELDS),
                     **_flat("out", out["regs"], REG_FIELDS),
                     **_flat("out", out, ("n_regs", "was_ext", "cursor")),
                     n_regs=st["n_regs"], was_ext=st["was_ext"],
                     cursor=st["cursor"])
        order = MERGE_RIGHT_ARGS
    pen = p["pen_clip5"] if side == 0 else p["pen_clip3"]
    args, tensors = pack_args(rdt, named, order,
                              [B, S, C, R, p["match_score"], p["bandwidth"],
                               pen])
    return out, args, tensors


def setup_bytes(S: int, C: int, rank_dtype: torch.dtype) -> int:
    """A read's bytes of ``extend_setup``'s tables (csrc/extend.cu
    ``setup_bytes``): two rank values and two int32 a seed, two int32 a
    chain, rounded up to 16."""
    return (2 * S * rank_dtype.itemsize + 8 * S + 8 * C + 15) // 16 * 16


def setup_args(seeds: dict, chains: dict, flt: dict, lens: torch.Tensor,
               refs: dict, p: dict) -> tuple[dict, list, list]:
    """(outputs, arguments, tensors) of ``extend_setup``
    (``extend.extend_setup_plain``'s) on the seed tables ``seeds`` (rbeg
    [B, S] in the rank dtype; qbeg, len int32 [B, S]; valid bool [B, S];
    score int32 [B, S] or absent), the chains' ``assign`` int32 [B, S],
    ``f_rbeg`` [B, C] in the rank dtype and ``rid`` int32 [B, C], the
    filter's ``order`` and ``kept`` int32 [B, C], the reads' ``lens`` and
    the references ``refs`` (offsets and lens in the rank dtype, l_pac,
    seq_len)."""
    rbeg = seeds["rbeg"]
    if rbeg.dim() != 2 or rbeg.dtype not in (torch.int32, torch.int64):
        raise ValueError("extend kernels: rbeg must be int32 or int64 [B, S]")
    B, S = rbeg.shape
    rdt = rbeg.dtype
    C = chains["f_rbeg"].shape[1] if chains["f_rbeg"].dim() == 2 else -1
    if S < 1 or C < 1:
        raise ValueError(f"extend kernels: S {S} and C {C} must be >= 1")
    n_refs = refs["offsets"].shape[0]
    named = dict(rbeg=rbeg, qbeg=seeds["qbeg"], len=seeds["len"],
                 valid=seeds["valid"], score=seeds.get("score"),
                 assign=chains["assign"], forder=flt["order"],
                 kept=flt["kept"], f_rbeg=chains["f_rbeg"],
                 crid=chains["rid"], lens=lens, ref_offsets=refs["offsets"],
                 ref_lens=refs["lens"])
    for k, dt, shape in (("rbeg", rdt, (B, S)), ("qbeg", torch.int32, (B, S)),
                         ("len", torch.int32, (B, S)),
                         ("valid", torch.bool, (B, S)),
                         ("assign", torch.int32, (B, S)),
                         ("forder", torch.int32, (B, C)),
                         ("kept", torch.int32, (B, C)),
                         ("f_rbeg", rdt, (B, C)),
                         ("crid", torch.int32, (B, C)),
                         ("lens", torch.int32, (B,)),
                         ("ref_offsets", rdt, (n_refs,)),
                         ("ref_lens", rdt, (n_refs,))):
        _check(k, named[k], dt, shape)
    if named["score"] is not None:
        _check("score", named["score"], torch.int32, (B, S))
    if n_refs < 1:
        raise ValueError("extend kernels: no reference")
    info = torch.iinfo(rdt)
    for k in ("l_pac", "seq_len"):
        if not 0 <= refs[k] <= info.max:
            raise ValueError(f"extend kernels: {k} {refs[k]} outside {rdt}")
    dev = rbeg.device
    new = lambda dt, *shape: torch.empty(shape, dtype=dt, device=dev)
    out = dict(order=new(torch.int32, B, S), n_usable=new(torch.int32, B),
               cis=new(torch.int32, B, S), ok=new(torch.bool, B, S),
               rmax0=new(rdt, B, C), rmax1=new(rdt, B, C))
    per_read = setup_bytes(S, C, rdt)
    scratch = (new(torch.uint8, B * per_read) if per_read > SETUP_SMEM
               else None)
    args, tensors = pack_args(rdt, dict(named, scratch=scratch, **out),
                              SETUP_ARGS,
                              [B, S, C, n_refs, refs["l_pac"],
                               refs["seq_len"]] + [p[k] for k in OPTS])
    return out, args, tensors


def seedcov_args(tab: dict, regs: dict) -> tuple[torch.Tensor, list, list]:
    """(output, arguments, tensors) of ``extend_seedcov``."""
    B, S, _, rdt = _tables(tab, ("rbeg", "qbeg", "len", "cis", "ok"))
    R = _regs(regs, ("rb", "re", "qb", "qe", "cchain"), B, rdt)
    out = torch.empty(B, R, dtype=torch.int32, device=tab["rbeg"].device)
    args, tensors = pack_args(rdt, dict(tab, **regs, seedcov=out),
                              SEEDCOV_ARGS, [B, S, R])
    return out, args, tensors


def launch(kernel: str, entry: str, out, args: list, tensors: list):
    """Launch ``entry`` of csrc/extend.cu on the tensors' device and count
    it under ``kernel``."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("extend kernels take CUDA tensors on one device")
    if tensors[0].numel() == 0:   # no reads: the first tensor is empty
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = bind(build.library("extend"), f"{entry}_launch")(
        array(args), len(args), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    build.LAUNCHES[kernel] += 1
    return out


def extend_setup_cuda(seeds: dict, chains: dict, flt: dict,
                      lens: torch.Tensor, refs: dict, p: dict) -> dict:
    """``extend.extend_setup_plain`` on the card in one launch."""
    return launch("extend_setup", "extend_setup",
                  *setup_args(seeds, chains, flt, lens, refs, p))


def extend_scan_cuda(tab: dict, st: dict, p: dict, count=None) -> dict:
    """``extend.extend_scan_plain`` on the card in one launch."""
    return launch("extend_scan", "extend_scan",
                  *scan_args(tab, st, p, count))


def extend_windows_cuda(tab: dict, seq_len: int, pac: torch.Tensor,
                        scan: dict, perm: torch.Tensor, p: dict,
                        gate=None) -> dict:
    """``extend.extend_windows_plain`` (no group) on the card in one
    launch."""
    return launch("extend_windows", "extend_windows",
                  *windows_args(tab, seq_len, pac, scan, perm, p, gate))


def extend_merge_cuda(side: int, tab: dict, st: dict, scan: dict, win: dict,
                      r1: dict, r2: dict, retry: torch.Tensor, p: dict,
                      left: dict | None = None, gate=None) -> dict:
    """``extend.extend_merge_plain`` on the card in one launch."""
    entry = "extend_merge_left" if side == 0 else "extend_merge_right"
    return launch("extend_merge", entry, *merge_args(
        side, tab, st, scan, win, r1, r2, retry, p, left, gate))


def extend_seedcov_cuda(tab: dict, regs: dict) -> torch.Tensor:
    """``extend.extend_seedcov_plain`` on the card in one launch."""
    return launch("extend_seedcov", "extend_seedcov",
                  *seedcov_args(tab, regs))
