"""The BWT-interval-sharded FM-index and the device pipeline over it.

The port of ``bioseqdb_tpu/dist/shard_index.py``. A reference larger
than one device's memory (BASELINE configs 4-5) splits its three
position- or rank-indexed tables by row range across the ``index`` axis
of a mesh (``dist/mesh.py``): the Occ ``blocks`` (octo rows, a shard a
multiple of 8 blocks), the SA-mark bit ranks (``sa_cnt``, ``sa_words``)
and the forward codes ``pac``; the small arrays (C counts, sampled SA,
major checkpoints, reference offsets) are whole on every rank. Each rank
answers every query against its own rows (rows it does not own count
zero) and one ``all_reduce`` over the index group sums each value to its
owner's (``kernels/fm.py`` ``group``). The tables never move. On the
card every such loop runs each step as a query launch, that
``all_reduce`` and an apply launch: the FM machine, the SA walk and the
backward search on ``csrc/fm_shard.cu`` (``kernels/seed.py``
``collect_seeds_sharded``, ``kernels/fm.py`` ``sa_walk_sharded`` and
``search_sharded``), the extension windows' fetch on ``csrc/extend.cu``
(``kernels/extend.py`` ``extend_windows_sharded``); the seeds' expansion
and finish launch ``csrc/resolve.cu`` around the sharded walk
(``kernels/chain.py`` ``resolve_seeds_sharded``).

``full_align_step_sharded`` runs the whole device pipeline (seeding,
seed resolution, chaining, the chain filter, extension) over a ``data``
x ``index`` mesh: rows split along ``data``, tables along ``index``;
only the FM and ``pac`` lookups cross ranks. Ranks are int32 below 2^31
doubled bases and int64 from there (``layout.rank_dtype_for``); the
packed tables stay int32 at any size.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bioseqdb_tpu_torch.align.pipeline import to_host
from bioseqdb_tpu_torch.dist import mesh as dmesh
from bioseqdb_tpu_torch.index import layout
from bioseqdb_tpu_torch.index.fmindex import FMIndex
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels.chain import (chain_seeds, filter_chains,
                                              l_rep_device, resolve_seeds)
from bioseqdb_tpu_torch.kernels.extend import extend_all
from bioseqdb_tpu_torch.kernels.seed import collect_seeds_device

REPLICATED = ("L2", "primary", "sa_sample", "occ_majors", "sa_majors",
              "ref_offsets", "ref_lens", "l_pac", "seq_len")
# the JAX full_align_step_sharded's seed and chain caps
MAX_SEEDS, MAX_CHAINS = 64, 16


class FMSharded(NamedTuple):
    """This rank's part of a sharded index: ``fm`` holds its shard of
    ``blocks`` (octo rows; the SA-mark columns stay zero, sharded walks
    read ``sa_cnt`` / ``sa_words``), ``sa_cnt`` and ``sa_words`` and the
    whole of the small arrays; ``pac`` its shard of the forward codes
    (int8). Every shard of a table has the same row count."""

    fm: kfm.FMDevice
    pac: torch.Tensor


def _shard(arr: np.ndarray, n_sh: int, s: int, align: int = 1
           ) -> np.ndarray:
    """Rows of shard ``s`` of ``n_sh`` (zero rows past the end): each
    shard ceil(rows / n_sh) rows rounded up to ``align`` (the JAX
    ``split``)."""
    rows = arr.shape[0]
    rps = ((rows + n_sh - 1) // n_sh + align - 1) & ~(align - 1)
    out = np.zeros((rps,) + arr.shape[1:], arr.dtype)
    part = arr[s * rps : (s + 1) * rps]
    out[: part.shape[0]] = part
    return out


def shard_tables(idx: FMIndex, n_sh: int, s: int, rank_dtype=None) -> dict:
    """Shard ``s`` of ``n_sh`` of ``idx``'s tables as numpy arrays: the
    sharded ``blocks`` (octo rows), ``sa_cnt``, ``sa_words`` and ``pac``,
    and the replicated fields with ranks in ``rank_dtype_for``'s
    dtype."""
    rdt = {torch.int32: np.int32,
           torch.int64: np.int64}[layout.rank_dtype_for(idx, rank_dtype)]
    t = {k: np.asarray(getattr(idx, k)).astype(rdt) for k in REPLICATED}
    sa = _shard(np.asarray(idx.sa_bits), n_sh, s)
    t.update(
        blocks=layout.pack_oct(_shard(np.asarray(idx.blocks), n_sh, s,
                                      layout.OCT_BLOCKS)),
        sa_cnt=np.ascontiguousarray(sa[:, 0]).astype(np.int32),
        sa_words=np.ascontiguousarray(sa[:, 1:]).reshape(-1).astype(
            np.int32),
        pac=_shard(np.asarray(idx.pac), n_sh, s).astype(np.int8),
    )
    return t


def shard_index(idx: FMIndex, mesh, device, rank_dtype=None) -> FMSharded:
    """This rank's shard of ``idx`` across the ``index`` axis of
    ``mesh``, on ``device``; ranks int64 from 2^31 doubled bases, else
    int32, or ``rank_dtype``."""
    t = layout.to_device(
        shard_tables(idx, dmesh.axis_size(mesh, "index"),
                     dmesh.axis_rank(mesh, "index"), rank_dtype), device)
    pac = t.pop("pac")
    return FMSharded(fm=kfm.FMDevice.from_tables(t), pac=pac)


def backward_search_sharded(fms: FMSharded, codes: torch.Tensor,
                            lens: torch.Tensor, mesh):
    """Exact-match intervals with the Occ table sharded by BWT interval;
    every rank of the index group gives the same reads and gets the
    same intervals: on CUDA tensors ``csrc/fm_shard.cu``'s search (a
    query, the all_reduce and an apply a step), on CPU tensors the plain
    twin."""
    return kfm.backward_search(fms.fm, codes, lens,
                               group=mesh.get_group("index"))


def sa_resolve_sharded(fms: FMSharded, ranks: torch.Tensor, mesh,
                       sa_interval: int = 32) -> torch.Tensor:
    """Position-sampled SA resolution with sharded rank tables: on CUDA
    tensors ``csrc/fm_shard.cu``'s walk (a query, the all_reduce and an
    apply a step), on CPU tensors the plain twin."""
    return kfm.sa_resolve(fms.fm, ranks, sa_interval,
                          group=mesh.get_group("index"))


def full_align_step_sharded(
    fms: FMSharded, codes: torch.Tensor, lens: torch.Tensor, mat, mesh, opt,
    n_refs: int, sa_interval: int = 32, keep_mems: bool = False,
    max_cand: int = 0,
) -> dict:
    """The device pipeline over a ``data`` x ``index`` mesh. ``codes`` /
    ``lens`` are the global batch (rows a multiple of the data size) on
    this rank's device; the rank runs its rows along ``data`` (all of
    them without a data axis) against its shard of the tables, and every
    rank returns the global result as a host dict, gathered over
    ``data``: the dense regions (no ``cchain``), n_regs, overflow and
    l_rep (+ mems with ``keep_mems``), as the JAX function returns them.
    The JAX caps: ``MAX_SEEDS``, ``MAX_CHAINS``, ``max_cand`` 16 and
    ``max_mem`` 16 up to 200 bases wide, else ``max_cand`` only when
    given; the FM seeder without fetch sharing or the round-3 jump (on
    the card ``csrc/fm_shard.cu``'s query and apply a step), and no
    seed-SW filter."""
    group = mesh.get_group("index")
    fm = fms.fm
    rows = dmesh.local_rows(codes.shape[0], mesh)
    codes = codes[rows].to(torch.int32)
    lens = lens[rows].to(torch.int32)
    split_len = int(opt.min_seed_len * opt.reseed_factor + 0.499)
    max_occ = opt.resolve_max_occ(n_refs)
    if codes.shape[1] <= 200:
        caps = dict(max_cand=max_cand or 16, max_mem=16)
    else:
        caps = dict(max_cand=max_cand) if max_cand else {}
    mems = collect_seeds_device(
        fm, codes, lens, min_seed_len=opt.min_seed_len, split_len=split_len,
        split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
        group=group, **caps)
    # every rank lane walks, as on the port's FM seeder (the JAX buffer
    # of (B * S) // 4 lanes is a TPU static-shape cap)
    seeds = resolve_seeds(fm, mems["mems"], mems["n_mem"], max_occ=max_occ,
                          max_seeds=MAX_SEEDS, sa_interval=sa_interval,
                          compact_cap=None, group=group)
    chains = chain_seeds(fm, seeds, max_chains=MAX_CHAINS,
                         bandwidth=opt.bandwidth,
                         max_chain_gap=opt.max_chain_gap)
    flt = filter_chains(chains, seeds, mask_level=opt.mask_level,
                        chain_drop_ratio=opt.chain_drop_ratio,
                        min_chain_weight=opt.min_chain_weight,
                        min_seed_len=opt.min_seed_len,
                        max_chain_gap=opt.max_chain_gap)
    ext = extend_all(
        fm, fms.pac, codes, lens, seeds, chains, flt, mat,
        match_score=opt.match_score, mismatch_penalty=opt.mismatch_penalty,
        o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins,
        bandwidth=opt.bandwidth, zdrop=opt.zdrop, pen_clip5=opt.pen_clip5,
        pen_clip3=opt.pen_clip3, group=group)
    regs = dict(ext["regs"])
    regs.pop("cchain")  # extend-internal; the host never reads it
    out = dict(regs=regs, n_regs=ext["n_regs"],
               overflow=(mems["overflow"] | seeds["overflow"]
                         | chains["overflow"] | ext["overflow"]),
               l_rep=l_rep_device(mems["mems"], mems["n_mem"], max_occ))
    if keep_mems:
        out["mems"] = mems["mems"]
        out["n_mem"] = mems["n_mem"]
    return dmesh.gather_host(to_host(out), mesh)
