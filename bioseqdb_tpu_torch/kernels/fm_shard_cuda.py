"""Wrappers of the index mesh's hand-written CUDA kernels (csrc/fm_shard.cu).

The Hopper counterparts of the JAX package's three loops under a shard
axis: ``collect_seeds_device(..., shard_axis=)``
(``bioseqdb_tpu/kernels/seed.py``, its owner sums at :736-743),
``sa_resolve(..., shard_axis=)`` (``bioseqdb_tpu/kernels/fm.py``) and
``backward_search_sharded`` (``bioseqdb_tpu/dist/shard_index.py:155``).
Each step of any is a query launch (this rank's partials of the values
the step sums, into the buffer ``kernels/fm.py`` ``_owner_sums`` would
stack), one ``all_reduce`` over the index group, and an apply launch (the
step's update from the sums). The loops around them are
``kernels/seed.py`` ``collect_seeds_sharded``, ``kernels/fm.py``
``sa_walk_sharded`` and ``search_sharded``; their plain twins are
``collect_seeds_plain``, ``sa_resolve_plain`` and
``backward_search_plain`` under the group.

Every entry takes one int64 array, which ``machine_args`` / ``sa_args``
/ ``bs_args`` build from the state and the tables (and check) and
``pack`` packs, and
refuses one of the wrong length. ``card_entries()`` launches them on
PyTorch's current stream (each adds one to ``build.LAUNCHES``; nothing
is allocated and nothing synchronises), and raises on a failed build or
launch: nothing falls back to the plain twins. ``host_entries(lib)``
runs the same lane bodies from a g++ build of the source (``*_host``),
for the tests on a machine without a card.
"""

from __future__ import annotations

import ctypes

import torch

from bioseqdb_tpu_torch.kernels import build

# the FM machine's and the SA walk's entries (an index mesh's step), then
# the backward search's
ENTRIES = ("fm_shard_query", "fm_shard_apply", "sa_shard_query",
           "sa_shard_apply")
SEARCH_ENTRIES = ("bs_shard_query", "bs_shard_apply")
# the machine's state tensors in the entries' order (kernels/seed.py
# _machine_state): kind "i" int32 [B], "b" bool [B], "r" rank [B], and
# the wider ones by their trailing shape
MACHINE_STATE = (
    ("codes", "codes"), ("lens", "i"), ("phase", "i"), ("round", "i"),
    ("x", "i"), ("i", "i"), ("j", "i"), ("ik", "ik"), ("ik_end", "i"),
    ("cand", "stack"), ("n_cand", "i"), ("prev", "stack"), ("n_prev", "i"),
    ("curr", "stack"), ("n_curr", "i"), ("ret", "i"), ("rev1", "b"),
    ("min_intv", "r"), ("r2i", "i"), ("last_start", "i"), ("mem_k", "mem"),
    ("mem_s", "mem"), ("mem_b", "mem"), ("mem_e", "mem"), ("n_mem", "i"),
    ("n_mem_r1", "i"), ("iters", "i"), ("it_r1", "i"), ("it_r2", "i"),
    ("overflow", "b"))
MACHINE_ARGS = 18 + len(MACHINE_STATE)   # csrc/fm_shard.cu kMachineArgs
SA_ARGS = 23                             # csrc/fm_shard.cu kSaArgs
BS_ARGS = 16                             # csrc/fm_shard.cu kBsArgs
BS_STEP = 3     # bs_args' step index, which the search's loop rewrites


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple
           ) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"fm_shard kernels: {name} must be a contiguous "
                         f"{dtype} tensor of shape {shape}, not {t.dtype} "
                         f"{tuple(t.shape)}")


def _tables(fm) -> None:
    rdt = fm.rank_dtype
    if rdt not in (torch.int32, torch.int64):
        raise ValueError(f"fm_shard kernels: rank dtype {rdt}")
    _check("occ_rows", fm.occ_rows, torch.int32, (fm.blocks.shape[0] * 8, 12))
    _check("occ_majors", fm.occ_majors, rdt, (fm.occ_majors.shape[0], 4))
    _check("L2", fm.L2, rdt, (5,))
    if fm.blocks.shape[0] < 1 or fm.occ_majors.shape[0] < 1:
        raise ValueError("fm_shard kernels: empty Occ tables")
    if fm.occ_rows.data_ptr() % 16:
        raise ValueError("fm_shard kernels: occ_rows must be 16-byte aligned")


def machine_args(fm, st: dict, buf: torch.Tensor, shard: int, *,
                 min_seed_len: int, split_len: int, split_width: int,
                 max_mem_intv: int, max_cand: int, max_iters: int
                 ) -> list[int]:
    """The machine entries' argument array for the lanes of ``st`` (the
    state ``kernels/seed.py`` ``_machine_state`` makes, every tensor
    contiguous, codes int32) with ``buf`` int32 [1, 2B, 4], the owner
    sum's buffer, on rank ``shard`` of the index group."""
    B, W = st["codes"].shape
    P, M = max_cand, st["mem_k"].shape[-1]
    rdt = fm.rank_dtype
    _tables(fm)
    shapes = dict(codes=((B, W), torch.int32), i=((B,), torch.int32),
                  b=((B,), torch.bool), r=((B,), rdt),
                  ik=((B, 3), rdt), stack=((B, P, 3), rdt),
                  mem=((B, M), rdt))
    for name, kind in MACHINE_STATE:
        _check(name, st[name], shapes[kind][1], shapes[kind][0])
    _check("buf", buf, torch.int32, (1, 2 * B, 4))
    if W < 1 or M < 1 or P < 1:
        raise ValueError("fm_shard kernels: needs W, max_mem and max_cand "
                         ">= 1")
    return [rdt.itemsize, B, W, M, P, fm.blocks.shape[0], shard,
            fm.occ_majors.shape[0], fm.primary, max_iters, min_seed_len,
            split_len, split_width, max_mem_intv, fm.occ_rows.data_ptr(),
            fm.occ_majors.data_ptr(), fm.L2.data_ptr(), buf.data_ptr(),
            *(st[name].data_ptr() for name, _ in MACHINE_STATE)]


def sa_args(fm, r: torch.Tensor, steps: torch.Tensor, buf: torch.Tensor,
            mode: int, shard: int, mask: torch.Tensor | None = None,
            pos: torch.Tensor | None = None) -> list[int]:
    """The walk entries' argument array: ``r`` and ``steps`` (1-D, rank
    dtype; the apply updates them in place), ``buf`` (mode 0, an LF step:
    int64 [2, n]; mode 1, the slot: int32 [2, n]), on rank ``shard``;
    ``mask`` (bool [n] or None) and ``pos`` (rank [n], out) for the
    slot's apply."""
    rdt = fm.rank_dtype
    n = r.shape[0] if r.dim() == 1 else -1
    _tables(fm)
    _check("ranks", r, rdt, (n,))
    _check("steps", steps, rdt, (n,))
    _check("buf", buf, (torch.int64, torch.int32)[mode], (2, n))
    for name, t, dt in (("sa_words", fm.sa_words, torch.int32),
                        ("sa_cnt", fm.sa_cnt, torch.int32),
                        ("sa_majors", fm.sa_majors, rdt),
                        ("sa_sample", fm.sa_sample, rdt)):
        if t.dim() != 1 or t.shape[0] < 1:
            raise ValueError(f"fm_shard kernels: {name} must be a non-empty "
                             "1-D table")
        _check(name, t, dt, (t.shape[0],))
    if mask is not None:
        _check("mask", mask, torch.bool, (n,))
    if pos is not None:
        _check("pos", pos, rdt, (n,))
    return [rdt.itemsize, n, mode, shard, fm.blocks.shape[0],
            fm.occ_majors.shape[0], fm.sa_words.shape[0], fm.sa_cnt.shape[0],
            fm.sa_majors.shape[0], fm.sa_sample.shape[0], fm.primary,
            fm.occ_rows.data_ptr(), fm.occ_majors.data_ptr(),
            fm.L2.data_ptr(), fm.sa_words.data_ptr(), fm.sa_cnt.data_ptr(),
            fm.sa_majors.data_ptr(), fm.sa_sample.data_ptr(), r.data_ptr(),
            steps.data_ptr(), buf.data_ptr(),
            0 if mask is None else mask.data_ptr(),
            0 if pos is None else pos.data_ptr()]


def bs_args(fm, codes: torch.Tensor, lens: torch.Tensor, lo: torch.Tensor,
            hi: torch.Tensor, buf: torch.Tensor, shard: int) -> list[int]:
    """The search entries' argument array at step 0 (``BS_STEP`` holds
    the step): ``codes`` int32 [B, W] (W >= 1), ``lens`` int32 [B], the
    intervals ``lo`` and ``hi`` (rank dtype [B]; the apply updates them in
    place) and ``buf`` int32 [1, 2B], the owner sum's buffer, on rank
    ``shard``."""
    rdt = fm.rank_dtype
    B, W = codes.shape if codes.dim() == 2 else (-1, -1)
    _tables(fm)
    _check("codes", codes, torch.int32, (B, W))
    _check("lens", lens, torch.int32, (B,))
    _check("lo", lo, rdt, (B,))
    _check("hi", hi, rdt, (B,))
    _check("buf", buf, torch.int32, (1, 2 * B))
    if W < 1:
        raise ValueError("fm_shard kernels: the search needs W >= 1")
    return [rdt.itemsize, B, W, 0, shard, fm.blocks.shape[0],
            fm.occ_majors.shape[0], fm.primary, fm.occ_rows.data_ptr(),
            fm.occ_majors.data_ptr(), fm.L2.data_ptr(), codes.data_ptr(),
            lens.data_ptr(), lo.data_ptr(), hi.data_ptr(), buf.data_ptr()]


def bind(lib: ctypes.CDLL, name: str, stream: bool = True):
    """``lib``'s entry ``name`` with its argument types: the array, its
    length (and the stream, if ``stream``)."""
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong]
                   + [ctypes.c_void_p] * stream)
    fn.restype = ctypes.c_int
    return fn


def pack(args: list[int]):
    """An argument array as the entries take it (a loop packs its array
    once and passes it to every launch of the step's lanes)."""
    return (ctypes.c_longlong * len(args))(*args)


def card_entries() -> dict:
    """{entry name: call(packed args, lanes, device)}: each call launches
    the entry's kernel on the current stream of ``device`` and counts it;
    a call with no lanes launches nothing. Raises on a failed build or
    launch."""
    def entry(name):
        bound = []

        def call(args, lanes: int, device) -> None:
            if device.type != "cuda":
                raise ValueError("fm_shard kernels take CUDA tensors")
            if lanes == 0:
                return
            if not bound:
                bound.append(bind(build.library("fm_shard"),
                                  f"{name}_launch"))
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = bound[0](args, len(args), stream)
            if rc != 0:
                raise RuntimeError(f"{name} kernel launch failed: CUDA "
                                   f"error {rc} ({lanes} lanes)")
            build.LAUNCHES[name] += 1
        return call
    return {name: entry(name) for name in ENTRIES + SEARCH_ENTRIES}


def host_entries(lib: ctypes.CDLL) -> dict:
    """The same calls on ``lib``, a host build of ``csrc/fm_shard.cu``
    (``tools/shard_calls.py`` ``host_library``), on CPU tensors."""
    def entry(name):
        fn = bind(lib, f"{name}_host", stream=False)

        def call(args, lanes: int, device) -> None:
            if device.type != "cpu":
                raise ValueError("the host build takes CPU tensors")
            rc = fn(args, len(args))
            if rc != 0:
                raise RuntimeError(f"{name}_host refused its arguments")
        return call
    return {name: entry(name) for name in ENTRIES + SEARCH_ENTRIES}


def owner_sum_step(entries: dict, kernel: str, args, lanes: int,
                   device, reduce) -> None:
    """One step of a sharded loop on ``args`` (``pack``ed): ``kernel``'s
    query launch (``{kernel}_query``), ``reduce()`` (the all_reduce of its
    buffer) and its apply launch (``{kernel}_apply``)."""
    entries[f"{kernel}_query"](args, lanes, device)
    reduce()
    entries[f"{kernel}_apply"](args, lanes, device)
