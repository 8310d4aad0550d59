"""The alignment pipeline on a torch device: exact mode, and the
single-end and paired-end full pipeline.

The port of ``bioseqdb_tpu/align/pipeline.py``. ``mode="exact"``:
``exact_align_step`` runs backward search, SA resolution and the
coordinate rebase of a read batch on the device, and ``align_batch``
turns its hits into records (full-length exact matches only; MAPQ 60 or
0, as in the JAX package). ``mode="full"``: ``Aligner.build`` uploads
the index tables and picks the seeder as the JAX package does (the kmer
seeder where the index and options allow it and ``BST_SEEDER`` is
``auto`` or ``kmer``, else the FM state machine with its round-3 jump
table), ``device_regions`` runs one read batch
through seeding -> seed resolution -> chaining -> chain filter (->
the seed-SW filter of long reads) -> extension on the device and
returns the same host dict as the JAX ``Aligner.device_regions`` (the
row-packed region wire format plus n_regs, overflow and l_rep), so the
port's copies of the JAX package's host code (``absorb_overflow``'s
unpack, finalize, SAM) run on it unchanged. ``absorb_overflow`` re-runs
overflow rows with fat caps on the FM seeder. Paired-end:
``device_regions_pair`` runs both mates as one 2B-row step,
``absorb_overflow_pair`` retries both mates' overflow rows in one fat
step, and ``align_pairs`` / ``align_pairs_columns`` finalize through
``align/paired.py`` (insert-size statistics, pairing, mate rescue on the
host).

Batches wider than 320 bases take the FM seeder, as in the JAX package.
Indexes of 2^31 or more doubled bases run with int64 ranks, which
``layout.fm_tables`` chooses by the index's size: the FM seeder (the
kmer table holds int32 positions), the jump table at any depth and a
candidate stack of 24 (``_step_kwargs``), and int64 reference
coordinates through chaining, extension and the wire dict.

Meshes (``dist/``): ``Aligner.build(..., mesh=)`` takes a
``torch.distributed`` device mesh, one process per rank, each given the
same batches. A ``data`` axis splits a batch's rows (padded to a
multiple of its size with code 4 and length 0) across ranks, each with
the whole index on its own device (full and exact mode); an ``index``
axis splits the FM tables by row range (``dist/shard_index.py``: full
mode, the FM seeder). Every rank returns the global result, gathered
over ``data``, as dense host tables (no pack cap); there is no fat retry
under a mesh, as in the JAX package: overflowed rows go to the host
oracle in finalize, and a pair batch takes two steps, one a mate.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.result import Hit, ReadResult
from bioseqdb_tpu_torch.cpu.ksw import fill_scmat
from bioseqdb_tpu_torch.index import layout
from bioseqdb_tpu_torch.index.fmindex import FMIndex
from bioseqdb_tpu_torch.io.batch import ReadBatch, pack_reads
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels.chain import (chain_seeds, filter_chains,
                                              l_rep_device, resolve_seeds)
from bioseqdb_tpu_torch.kernels.extend import extend_all
from bioseqdb_tpu_torch.kernels.kmer import collect_seeds_kmer
from bioseqdb_tpu_torch.kernels.seed import (R3Jump, build_r3_jump,
                                             collect_seeds_device)
from bioseqdb_tpu_torch.kernels.seedsw import possibly_active, seed_sw_filter

KMER_MAX_WIDTH = 320  # wider batches take the FM seeder (JAX pipeline.py:133)
SEEDERS = ("auto", "kmer", "fm")
MODES = ("full", "exact")

# fields bounded by the read width / scoring config: int16 on the wire
_NARROW_FIELDS = ("qb", "qe", "score", "truesc", "w", "seedlen0", "seedcov")


def exact_align_step(fm: kfm.FMDevice, codes: torch.Tensor,
                     lens: torch.Tensor, max_hits: int,
                     sa_interval: int = 32) -> dict:
    """Exact-match alignment of one read batch on the device.

    codes: [B, W] (uint8 on the wire, cast here), lens: int32 [B].
    Returns the host dict of per-read hit arrays of width ``max_hits``:
    the interval size ``n_hits``, and ``valid``, ``rid``, ``pos`` (0-based
    within the reference) and ``rev``."""
    codes = codes.to(torch.int32)
    lens = lens.to(torch.int32)
    lo, hi = kfm.backward_search(fm, codes, lens)
    n_hits = hi - lo
    h = torch.arange(max_hits, dtype=torch.int32, device=codes.device)[None, :]
    valid = h < n_hits.clamp(max=max_hits)[:, None]
    ranks = torch.where(valid, lo[:, None] + h, 1)   # 1: a safe dummy rank
    pos = kfm.sa_resolve(fm, ranks, sa_interval)
    fwd, rev = kfm.depos(fm, pos, lens[:, None])
    rid = kfm.rid_of(fm, fwd)
    ref_off = fm.ref_offsets[rid.long()]
    ref_len = fm.ref_lens[rid.long()]
    # drop hits bridging two concatenated references (bwa drops these too)
    inside = (fwd >= ref_off) & (fwd + lens[:, None] <= ref_off + ref_len)
    return to_host(dict(n_hits=n_hits, valid=valid & inside, rid=rid,
                        pos=fwd - ref_off, rev=rev))


def full_align_step(
    fm: kfm.FMDevice, pac_rows, codes, lens, mat,
    min_seed_len: int, split_len: int, split_width: int, max_mem_intv: int,
    max_occ: int, max_seeds: int, max_chains: int,
    match_score: int, mismatch_penalty: int,
    o_del: int, e_del: int, o_ins: int, e_ins: int,
    bandwidth: int, zdrop: int, pen_clip5: int, pen_clip3: int,
    min_chain_weight: int, max_chain_gap: int,
    mask_level: float, chain_drop_ratio: float,
    sa_interval: int = 32, keep_mems: bool = False,
    max_cand: int = 0, max_mem: int = 0, max_iters: int = 0,
    max_regs: int = 0, kmer: dict | None = None, jump: R3Jump | None = None,
) -> dict:
    """One batch through the device pipeline. ``kmer`` (bmeta, entries,
    kmer_meta) selects the kmer seeder for batches up to KMER_MAX_WIDTH
    wide; otherwise the FM state machine runs, with the round-3 ``jump``
    table when given. Returns regions + n_regs + overflow + l_rep (+ mems
    with keep_mems)."""
    W = codes.shape[1]
    if W <= 200:
        caps = dict(max_cand=max_cand or 16, max_mem=max_mem or 16)
    else:
        caps = dict(max_cand=max_cand) if max_cand else {}
        if W >= 768:
            # long reads carry more seeds: round 3 alone emits about one
            # per min_seed_len span of unique sequence
            caps["max_mem"] = W // 16 + 48
        if max_mem:
            caps["max_mem"] = max_mem
    if W > KMER_MAX_WIDTH:
        kmer = None
    if kmer is not None:
        meta = kmer["kmer_meta"]
        M_k = caps.get("max_mem") or 48
        M_tot = M_k + 8
        nmz = layout.nmz_for(W)
        ko = collect_seeds_kmer(
            kmer["bmeta"], kmer["entries"], pac_rows, fm.seq_len, codes,
            lens, bb=meta.bb, min_seed_len=min_seed_len, split_len=split_len,
            split_width=split_width, max_mem_intv=max_mem_intv,
            smax=layout.smax_for(max_mem_intv),
            dmax=layout.dmax_for(meta, nmz), nmz=nmz, max_mem=M_k)
        r2m = collect_seeds_device(
            fm, codes, lens, min_seed_len=min_seed_len, split_len=split_len,
            split_width=split_width, max_mem_intv=0,  # round 2 only
            max_cand=caps.get("max_cand") or max_cand or 24, max_mem=M_tot,
            max_iters=max_iters, entry_reseed=True,
            reseed_entry=dict(mem_s=ko["mem_s"], mem_b=ko["mem_b"],
                              mem_e=ko["mem_e"], n_mem=ko["n_mem"],
                              active=ko["needs_r2"]))
        # rows [0, n_kmer) are the kmer mems: k column = POSITION, l = 1
        # flags a position row (chain.resolve_seeds); rows beyond carry
        # round-2 rank intervals. Both join the rank dtype.
        m5 = r2m["mems"]
        isk = (torch.arange(M_tot, device=codes.device)[None, :]
               < ko["n_mem"][:, None])
        posk = torch.nn.functional.pad(ko["mem_pos"].to(m5.dtype),
                                       (0, M_tot - M_k))
        mems = dict(
            mems=torch.stack([torch.where(isk, posk, m5[:, :, 0]),
                              isk.to(m5.dtype), m5[:, :, 2], m5[:, :, 3],
                              m5[:, :, 4]], 2),
            n_mem=r2m["n_mem"], overflow=ko["overflow"] | r2m["overflow"])
    else:
        mems = collect_seeds_device(
            fm, codes, lens, min_seed_len=min_seed_len, split_len=split_len,
            split_width=split_width, max_mem_intv=max_mem_intv,
            max_cand=caps.get("max_cand", 24), max_mem=caps.get("max_mem", 48),
            max_iters=max_iters, jump=jump)
    # the kmer path walks the JAX package's 4,096 rank lanes at most; the
    # FM seeder's seeds are all rank rows, and long reads fill ~40% of the
    # seed slots, past the JAX buffer's (B * S) // 4 (a third of a batch
    # of 1,500 bp reads overflowed there), so they all walk
    seeds = resolve_seeds(fm, mems["mems"], mems["n_mem"], max_occ=max_occ,
                          max_seeds=max_seeds, sa_interval=sa_interval,
                          compact_cap=(4096 if kmer is not None else None))
    chains = chain_seeds(fm, seeds, max_chains=max_chains,
                         bandwidth=bandwidth, max_chain_gap=max_chain_gap)
    flt = filter_chains(chains, seeds, mask_level=mask_level,
                        chain_drop_ratio=chain_drop_ratio,
                        min_chain_weight=min_chain_weight,
                        min_seed_len=min_seed_len, max_chain_gap=max_chain_gap)
    if possibly_active(min_chain_weight, W):
        # long reads: re-score short seeds by local SW, drop sub-HSP ones
        seeds = seed_sw_filter(
            fm, pac_rows, codes, lens, seeds, match_score=match_score,
            mismatch_penalty=mismatch_penalty, o_del=o_del, e_del=e_del,
            o_ins=o_ins, e_ins=e_ins, min_chain_weight=min_chain_weight)
    ext = extend_all(
        fm, pac_rows, codes, lens, seeds, chains, flt, mat,
        match_score=match_score, mismatch_penalty=mismatch_penalty,
        o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
        bandwidth=bandwidth, zdrop=zdrop, pen_clip5=pen_clip5,
        pen_clip3=pen_clip3, **(dict(max_regs=max_regs) if max_regs else {}))
    overflow = (mems["overflow"] | seeds["overflow"] | chains["overflow"]
                | ext["overflow"])
    regs = dict(ext["regs"])
    regs.pop("cchain")  # extend-internal; the host never reads it
    out = dict(regs=regs, n_regs=ext["n_regs"], overflow=overflow,
               l_rep=l_rep_device(mems["mems"], mems["n_mem"], max_occ))
    if keep_mems:
        out["mems"] = mems["mems"]
        out["n_mem"] = mems["n_mem"]
    return out


def pack_codes_2bit(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host wire packing of read codes: 2-bit base codes (4 per byte)
    plus an ambiguity bitmap (8 per byte). The width pads to a multiple
    of 8 with code 4. Unpacked on the device by ``unpack_codes``."""
    codes = np.asarray(codes, np.uint8)
    B, W = codes.shape
    Wp = -(-W // 8) * 8
    if Wp != W:
        codes = np.concatenate(
            [codes, np.full((B, Wp - W), 4, np.uint8)], axis=1)
    nm = codes >= 4
    c2 = np.where(nm, 0, codes).reshape(B, Wp // 4, 4)
    u2 = ((c2 << (2 * np.arange(4, dtype=np.uint8))).sum(
        axis=2, dtype=np.uint32)).astype(np.uint8)
    nmb = np.packbits(nm, axis=1, bitorder="little")
    return u2, nmb


def unpack_codes(u2: torch.Tensor, nm: torch.Tensor) -> torch.Tensor:
    """Device inverse of ``pack_codes_2bit``: (B, W/4) 2-bit words and
    the (B, W/8) ambiguity bitmap -> (B, W) int32 codes 0..4."""
    B, Wq = u2.shape
    dev = u2.device
    u2 = u2.to(torch.int32)
    c = ((u2[:, :, None] >> (2 * torch.arange(4, device=dev))) & 3
         ).reshape(B, Wq * 4)
    m = ((nm.to(torch.int32)[:, :, None] >> torch.arange(8, device=dev)) & 1
         ).reshape(B, -1)[:, : Wq * 4]
    return torch.where(m == 1, 4, c).to(torch.int32)


def pack_out(out: dict, cap: int, narrow: bool) -> dict:
    """Row-compact the (B, R) region tables: read i's n_regs live rows
    go to flat (cap,) arrays at off[i] = exclusive cumsum of counts;
    rows past ``cap`` are dropped and the host detects them
    (finalize.maybe_unpack). Narrow fields ship as int16."""
    regs = out["regs"]
    B, R = regs["qb"].shape
    dev = regs["qb"].device
    nr = out["n_regs"].clamp(max=R)
    off = (torch.cumsum(nr, 0) - nr).to(torch.int32)
    r_i = torch.arange(R, device=dev)[None, :]
    dst = off[:, None] + r_i
    # rows past the cap land in the dropped slot ``cap``
    dst = torch.where((r_i < nr[:, None]) & (dst < cap), dst, cap
                      ).reshape(-1).long()
    packed = {}
    for k, a in regs.items():
        dt = torch.int16 if (narrow and k in _NARROW_FIELDS) else a.dtype
        flat = torch.zeros(cap + 1, dtype=dt, device=dev)
        flat[dst] = a.reshape(-1).to(dt)
        packed[k] = flat[:cap]
    return dict(out, regs=packed, off=off)


def to_host(tree):
    """numpy copy of a (nested dict of) tensor(s)."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.cpu().numpy()


@dataclass
class Aligner:
    """An index bound to options and a torch device, ready to align read
    batches (the port of the JAX ``Aligner``)."""

    index: FMIndex
    options: AlignOptions
    device: torch.device
    fm: kfm.FMDevice
    pac_rows: torch.Tensor | None  # packed doubled text; None in exact mode
    kmer: dict | None        # the kmer seeder's tables; None: FM seeder
    jump: R3Jump | None      # the FM machine's round-3 jump table
    mode: str = "full"
    mesh: object = None      # a DeviceMesh of ``data`` and/or ``index``
    fms: object = None       # FMSharded when the mesh has an index axis

    @classmethod
    def build(cls, index: FMIndex, options: AlignOptions | None = None,
              device="cuda", seeder: str | None = None,
              mode: str = "full", mesh=None) -> "Aligner":
        """Upload ``index``'s tables to ``device``. A CUDA device without
        a card raises; nothing falls back to the CPU.

        ``mode`` is ``full`` (the BWA-MEM pipeline) or ``exact`` (the
        exact-match path, which uploads the FM tables alone: no packed
        text, kmer table or jump table).

        ``seeder`` (default: the ``BST_SEEDER`` variable, else ``auto``)
        picks the main seeder as the JAX package does: ``auto`` or
        ``kmer`` take the kmer seeder when it can hold exact parity for
        the index and options (``layout.kmer_eligible``, and an
        occurrence-scan cap of at least 1), ``fm`` and every other case
        the FM state machine, with no kmer table built. The round-3 jump
        table is built either way: the FM machine runs in the fat
        overflow retry and on batches wider than KMER_MAX_WIDTH.

        The ranks take the dtype ``layout.fm_tables`` chooses by the
        index's size (``self.fm.rank_dtype``: int64 from 2^31 doubled
        bases); there is no argument to force it, as in the JAX package.

        ``mesh`` (``dist.mesh.make_mesh``, every rank calling with its own
        ``device``, of the mesh's device type): with only a ``data``
        axis each rank builds the tables above; with an ``index`` axis
        it builds its shard of the FM tables (``shard_index``) instead,
        full mode only (else ``ValueError``), FM-seeded, with no kmer or
        jump table.
        """
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} is not one of {MODES}")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Aligner.build(device='cuda'): no CUDA device")
        opts = options or AlignOptions()
        if mesh is not None:
            if mesh.device_type != device.type:
                raise ValueError(f"a {mesh.device_type} mesh with device "
                                 f"{device}")
            if "index" in (mesh.mesh_dim_names or ()):
                if mode != "full":
                    raise ValueError("index-sharded meshes support "
                                     "mode='full'")
                from bioseqdb_tpu_torch.dist.shard_index import shard_index

                return cls(index=index, options=opts, device=device,
                           fm=None, pac_rows=None, kmer=None, jump=None,
                           mode=mode, mesh=mesh,
                           fms=shard_index(index, mesh, device))
        if mode == "exact":
            return cls(index=index, options=opts, device=device,
                       fm=kfm.FMDevice.from_host(index, device),
                       pac_rows=None, kmer=None, jump=None, mode=mode,
                       mesh=mesh)
        want = seeder or os.environ.get("BST_SEEDER", "auto")
        if want not in SEEDERS:
            raise ValueError(f"seeder {want!r} is not one of {SEEDERS}")
        use_kmer = (want in ("auto", "kmer")
                    and layout.kmer_eligible(index, opts)
                    and layout.smax_for(opts.max_mem_intv) >= 1)
        t = layout.to_device(layout.tables_from_host(index, kmer=use_kmer),
                             device)
        fm = kfm.FMDevice.from_tables(t)
        kmer = (dict(bmeta=t["bmeta"], entries=t["entries"],
                     kmer_meta=t["kmer_meta"]) if use_kmer else None)
        return cls(index=index, options=opts, device=device, fm=fm,
                   pac_rows=t["pac_rows"], kmer=kmer, jump=build_r3_jump(fm),
                   mesh=mesh)

    def _mat(self) -> torch.Tensor:
        opt = self.options
        return torch.from_numpy(
            fill_scmat(opt.match_score, opt.mismatch_penalty)).to(self.device)

    def _step_kwargs(self, W: int, keep_mems: bool = False):
        """The device-step kwargs for a batch of width ``W``; returns
        (kwargs, narrow)."""
        opt = self.options
        split_len = int(opt.min_seed_len * opt.reseed_factor + 0.499)
        narrow = (W * max(int(opt.match_score), 1) < 30000
                  and int(opt.bandwidth) * 16 < 30000 and W < 30000)
        common = dict(
            min_seed_len=opt.min_seed_len, split_len=split_len,
            split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
            max_occ=opt.resolve_max_occ(self.index.n_refs),
            max_seeds=64 if W <= 512 else W // 12 + 64,
            max_chains=16 if W <= 512 else 32,
            match_score=opt.match_score, mismatch_penalty=opt.mismatch_penalty,
            o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins,
            bandwidth=opt.bandwidth, zdrop=opt.zdrop,
            pen_clip5=opt.pen_clip5, pen_clip3=opt.pen_clip3,
            min_chain_weight=opt.min_chain_weight,
            max_chain_gap=opt.max_chain_gap,
            mask_level=opt.mask_level, chain_drop_ratio=opt.chain_drop_ratio,
            sa_interval=self.index.sa_interval, keep_mems=keep_mems,
            kmer=self.kmer, jump=self.jump, max_cand=self._max_cand(),
        )
        return common, narrow

    def _max_cand(self) -> int:
        """The FM machine's candidate stack, which grows with log4 of the
        genome: 24 past 2^31 doubled bases (JAX pipeline.py:611), else
        0, the seeder's default."""
        return 24 if self.index.seq_len >= (1 << 31) else 0

    def _wire_step(self, codes: np.ndarray, lens: np.ndarray,
                   keep_mems: bool = False) -> tuple[dict, bool]:
        """Upload a batch in the 2-bit wire form, unpack it on the device
        and run one device step at the packed width; returns the device
        out dict and the step's ``narrow``."""
        if self.mode != "full":
            raise ValueError(f"the full pipeline's device step (and "
                             f"paired-end alignment) requires mode='full', "
                             f"not {self.mode!r}")
        u2, nmb = pack_codes_2bit(codes)
        codes = unpack_codes(torch.from_numpy(u2).to(self.device),
                             torch.from_numpy(nmb).to(self.device))
        common, narrow = self._step_kwargs(codes.shape[1], keep_mems)
        out = full_align_step(
            self.fm, self.pac_rows, codes,
            torch.from_numpy(np.asarray(lens, np.int32)).to(self.device),
            self._mat(), **common)
        return out, narrow

    def device_regions(self, batch: ReadBatch, keep_mems: bool = False
                       ) -> dict:
        """Run the device pipeline on one batch (no host finalize);
        returns the host dict of the JAX ``Aligner.device_regions``:
        packed regions + n_regs + overflow + l_rep, or with ``keep_mems``
        the dense regions plus the seed-interval tables. Under a mesh,
        the dense regions of the batch padded to the data size."""
        if self.mesh is not None:
            return self._mesh_regions(batch, keep_mems)
        out, narrow = self._wire_step(np.asarray(batch.codes, np.uint8),
                                      batch.lens, keep_mems)
        if not keep_mems:
            out = pack_out(out, (5 * batch.n_padded) // 4, narrow)
        return to_host(out)

    def _mesh_regions(self, batch: ReadBatch, keep_mems: bool) -> dict:
        """``device_regions`` under the mesh: this rank's rows (all rows
        along an index axis without data) through its step, the dense
        host tables gathered over ``data``."""
        from bioseqdb_tpu_torch.dist import mesh as dmesh

        codes, lens = dmesh.pad_rows(np.asarray(batch.codes, np.uint8),
                                     np.asarray(batch.lens, np.int32),
                                     self.mesh)
        if self.fms is not None:
            from bioseqdb_tpu_torch.dist.shard_index import (
                full_align_step_sharded)

            return full_align_step_sharded(
                self.fms, torch.from_numpy(codes).to(self.device),
                torch.from_numpy(lens).to(self.device), self._mat(),
                self.mesh, self.options, self.index.n_refs,
                sa_interval=self.index.sa_interval, keep_mems=keep_mems,
                max_cand=self._max_cand())
        rows = dmesh.local_rows(codes.shape[0], self.mesh)
        out, _ = self._wire_step(codes[rows], lens[rows], keep_mems)
        return dmesh.gather_host(to_host(out), self.mesh)

    def device_regions_pair(self, batch1: ReadBatch, batch2: ReadBatch
                            ) -> tuple[dict, dict]:
        """Run both mates of a pair batch through ONE device step: the
        mates concatenate row-wise as [mates1; mates2] (padded to a common
        width with code 4), the step runs once over the 2B rows, and each
        half packs on its own. Returns (out1, out2), each shaped exactly
        like a ``device_regions`` result. One step, not two, because the
        step's caps are batch-global (``resolve_seeds`` compacts rank
        lanes over the whole batch), as in the JAX package's fused pair
        step. Under a mesh, two ``device_regions`` steps (the JAX
        package's rule)."""
        if self.mesh is not None:
            return self.device_regions(batch1), self.device_regions(batch2)
        c1 = np.asarray(batch1.codes, np.uint8)
        c2 = np.asarray(batch2.codes, np.uint8)
        B = c1.shape[0]
        if c2.shape[0] != B:
            raise ValueError(f"mate batches of {B} and {c2.shape[0]} rows")
        W = max(c1.shape[1], c2.shape[1])
        codes = np.full((2 * B, W), 4, np.uint8)
        codes[:B, : c1.shape[1]] = c1
        codes[B:, : c2.shape[1]] = c2
        out, narrow = self._wire_step(
            codes, np.concatenate([batch1.lens, batch2.lens]))

        def half(lo):
            h = {k: ({kk: vv[lo : lo + B] for kk, vv in v.items()}
                     if isinstance(v, dict) else v[lo : lo + B])
                 for k, v in out.items()}
            return to_host(pack_out(h, (5 * B) // 4, narrow))

        return half(0), half(B)

    # overflow-retry row buckets (the JAX package's compiled-program
    # buckets; kept so both retry the same rows)
    RETRY_BUCKETS = (64, 256, 1024)

    def _fat_retry(self, codes_sel: np.ndarray, lens_sel: np.ndarray) -> dict:
        """One fat-cap FM-seeder run over the selected overflow rows
        (padded to a RETRY_BUCKETS row bucket); returns the host dict."""
        k, W = codes_sel.shape
        bucket = next(b for b in self.RETRY_BUCKETS if b >= k)
        codes = np.full((bucket, W), 4, np.uint8)
        codes[:k] = codes_sel
        lens = np.zeros(bucket, np.int32)
        lens[:k] = lens_sel
        common, _ = self._step_kwargs(W)
        common.update(
            max_cand=32, max_mem=32,
            max_seeds=max(2 * common["max_seeds"], 128),
            max_chains=2 * common["max_chains"],
            max_iters=3 * (10 * W + 256), max_regs=16,
            # the retried rows are the ones the kmer fast path could not
            # hold exact: run the FM seeder
            kmer=None,
        )
        out = full_align_step(
            self.fm, self.pac_rows,
            torch.from_numpy(codes).to(self.device, torch.int32),
            torch.from_numpy(lens).to(self.device), self._mat(), **common)
        return to_host(out)

    @staticmethod
    def _splice_retry(out: dict, ovf: np.ndarray, r: dict, base: int) -> dict:
        """Write retry rows r[base : base + len(ovf)] back into the dense
        out tables (growing R when the retry has more region slots)."""
        k = ovf.size
        R_old = next(iter(out["regs"].values())).shape[1]
        R_new = next(iter(r["regs"].values())).shape[1]
        regs = {}
        for key, a in out["regs"].items():
            a = np.asarray(a)
            if R_new > R_old:
                a = np.concatenate(
                    [a, np.zeros((a.shape[0], R_new - R_old), a.dtype)],
                    axis=1)
            else:
                a = a.copy()
            a[ovf] = np.asarray(r["regs"][key])[base : base + k].astype(a.dtype)
            regs[key] = a
        out = dict(out, regs=regs)
        for key in ("n_regs", "overflow", "l_rep"):
            if out.get(key) is not None:
                col = np.asarray(out[key]).copy()
                col[ovf] = np.asarray(r[key])[base : base + k]
                out[key] = col
        return out

    def absorb_overflow(self, batch: ReadBatch, out: dict) -> dict:
        """Re-run overflow rows on the device with fat caps before the
        host oracle sees them; returns the unpacked out dict with the
        retried rows spliced in (unchanged when nothing overflowed or
        more rows overflowed than the largest bucket, or under a mesh:
        its overflowed rows go to the host oracle)."""
        from bioseqdb_tpu_torch.align.finalize import maybe_unpack

        if "mems" in out or self.mesh is not None:
            return out
        out = maybe_unpack(out)
        n = len(batch.names)
        ovf = np.flatnonzero(np.asarray(out["overflow"])[:n])
        if ovf.size == 0 or ovf.size > self.RETRY_BUCKETS[-1]:
            return out
        r = self._fat_retry(np.asarray(batch.codes, np.uint8)[ovf],
                            np.asarray(batch.lens, np.int32)[ovf])
        return self._splice_retry(out, ovf, r, 0)

    def absorb_overflow_pair(self, batch1: ReadBatch, out1: dict,
                             batch2: ReadBatch, out2: dict
                             ) -> tuple[dict, dict]:
        """``absorb_overflow`` for a pair batch: both mates' overflow rows
        go through ONE fat retry (its row bucket chosen by their total),
        and are spliced back into each mate's unpacked tables."""
        from bioseqdb_tpu_torch.align.finalize import maybe_unpack

        if "mems" in out1 or "mems" in out2 or self.mesh is not None:
            return out1, out2
        out1, out2 = maybe_unpack(out1), maybe_unpack(out2)
        o1 = np.flatnonzero(np.asarray(out1["overflow"])[: batch1.n])
        o2 = np.flatnonzero(np.asarray(out2["overflow"])[: batch2.n])
        total = o1.size + o2.size
        if total == 0 or total > self.RETRY_BUCKETS[-1]:
            return out1, out2
        c1 = np.asarray(batch1.codes, np.uint8)[o1]
        c2 = np.asarray(batch2.codes, np.uint8)[o2]
        # the width of the mates that overflowed (the JAX package's rule)
        W = max(c1.shape[1] if o1.size else 0, c2.shape[1] if o2.size else 0)
        codes = np.full((total, W), 4, np.uint8)
        for lo, c in ((0, c1), (o1.size, c2)):
            if len(c):
                codes[lo : lo + len(c), : c.shape[1]] = c
        r = self._fat_retry(codes, np.concatenate(
            [np.asarray(batch1.lens, np.int32)[o1],
             np.asarray(batch2.lens, np.int32)[o2]]))
        if o1.size:
            out1 = self._splice_retry(out1, o1, r, 0)
        if o2.size:
            out2 = self._splice_retry(out2, o2, r, o1.size)
        return out1, out2

    def align_batch(self, batch: ReadBatch, max_hits: int | None = None,
                    with_query_ids: bool = True) -> list[ReadResult]:
        """Align a packed batch; per-read results.

        mode="full": BWA-MEM semantics (``max_hits`` is not used).
        mode="exact": full-length exact matches only, up to ``max_hits``
        a read (default min(max_occ, 64)); reads with any mismatch, indel
        or clip come back unmapped. The records are field-complete for
        what they report (CIGAR, NM, MD, AS by construction; MAPQ and XS
        as the bwa formula's outcome for a full-length exact match, see
        ``_to_results``), except that a unique exact hit has XS 0 even
        where full mode would report an inexact sub-optimal score."""
        from bioseqdb_tpu_torch.align.finalize import finalize_batch

        if self.mode == "exact":
            if max_hits is None:
                max_hits = min(
                    self.options.resolve_max_occ(self.index.n_refs), 64)
            codes = np.asarray(batch.codes, np.uint8)
            lens = np.asarray(batch.lens, np.int32)
            if self.mesh is not None:
                from bioseqdb_tpu_torch.dist import mesh as dmesh

                codes, lens = dmesh.pad_rows(codes, lens, self.mesh)
                rows = dmesh.local_rows(codes.shape[0], self.mesh)
                codes, lens = codes[rows], lens[rows]
            out = exact_align_step(
                self.fm, torch.from_numpy(codes).to(self.device),
                torch.from_numpy(lens).to(self.device),
                max_hits, sa_interval=self.index.sa_interval)
            if self.mesh is not None:
                out = dmesh.gather_host(out, self.mesh)
            return self._to_results(batch, out, with_query_ids)
        out = self.absorb_overflow(batch, self.device_regions(batch))
        return finalize_batch(self.index, self.options, batch, out,
                              with_query_ids)

    def _pair_outs(self, batch1: ReadBatch, batch2: ReadBatch):
        out1, out2 = self.device_regions_pair(batch1, batch2)
        return self.absorb_overflow_pair(batch1, out1, batch2, out2)

    def align_pairs(self, batch1: ReadBatch, batch2: ReadBatch
                    ) -> list[tuple[ReadResult, ReadResult]]:
        """Paired-end alignment of two row-aligned batches (the two ends
        of the same templates): one (ReadResult, ReadResult) a template,
        with PE flags and mate fields attached (``align/paired.py``)."""
        from bioseqdb_tpu_torch.align.paired import finalize_pairs

        out1, out2 = self._pair_outs(batch1, batch2)
        return finalize_pairs(self.index, self.options, batch1, out1,
                              batch2, out2)

    def align_pairs_columns(self, batch1: ReadBatch, batch2: ReadBatch):
        """Columnar paired-end alignment: (AlignColumns, AlignColumns)
        with the PE columns attached, equal to ``align_pairs``; render
        with ``sam.emit.emit_sam_pair_columns``."""
        from bioseqdb_tpu_torch.align.paired import finalize_pairs_columns

        out1, out2 = self._pair_outs(batch1, batch2)
        return finalize_pairs_columns(self.index, self.options, batch1,
                                      out1, batch2, out2)

    def _to_results(self, batch: ReadBatch, out: dict,
                    with_query_ids: bool) -> list[ReadResult]:
        """Exact mode's records from ``exact_align_step``'s host dict."""
        idx = self.index
        results: list[ReadResult] = []
        m = int(self.options.match_score)
        for i, name in enumerate(batch.names):
            L = int(batch.lens[i])
            hits: list[Hit] = []
            n_hits = int(out["n_hits"][i])
            for j_rank, j in enumerate(np.flatnonzero(out["valid"][i])):
                rid = int(out["rid"][i, j])
                begin = int(out["pos"][i, j])
                primary = j_rank == 0
                hits.append(Hit(
                    ref_id=int(idx.ref_ids[rid]) if len(idx.ref_ids) else rid,
                    ref_name=idx.ref_names[rid],
                    ref_begin=begin,
                    ref_end=begin + L,
                    query_id=i if with_query_ids else None,
                    query_name=name,
                    query_begin=0,
                    query_end=L,
                    is_primary=primary,
                    is_secondary=not primary,
                    is_reverse=bool(out["rev"][i, j]),
                    cigar=f"{L}M",
                    score=m * L,
                    # the bwa MAPQ formula's outcome for a full-length exact
                    # match: unique -> clips to 60 (any L >= ~25 bp);
                    # repeated -> sub == score -> 0 (mem_approx_mapq_se)
                    mapq=(60 if n_hits == 1 else 0) if primary else 0,
                    nm=0,
                    md=str(L),
                    # XS as in full mode: an equal-score repeat's score, 0
                    # when unique, on the primary record only
                    sub=(m * L if n_hits > 1 else 0) if primary else -1,
                    rid=rid,
                ))
            results.append(ReadResult(query_name=name, hits=hits))
        return results


def _as_batch(reads) -> ReadBatch:
    return reads if isinstance(reads, ReadBatch) else pack_reads(list(reads))


def align(reads, index: FMIndex, options: AlignOptions | None = None,
          max_hits: int | None = None, device="cuda") -> list[ReadResult]:
    """One-shot: align sequences (or a ReadBatch) against an index in
    full mode (``max_hits`` is passed on to ``align_batch``)."""
    return Aligner.build(index, options, device=device).align_batch(
        _as_batch(reads), max_hits=max_hits)


def align_pairs(reads1, reads2, index: FMIndex,
                options: AlignOptions | None = None, device="cuda"
                ) -> list[tuple[ReadResult, ReadResult]]:
    """One-shot paired-end alignment: the two ends' sequences (or
    ReadBatches), row-aligned, against an index."""
    return Aligner.build(index, options, device=device).align_pairs(
        _as_batch(reads1), _as_batch(reads2))


def align_pairs_columns(reads1, reads2, index: FMIndex,
                        options: AlignOptions | None = None, device="cuda"):
    """One-shot columnar paired-end alignment
    (``Aligner.align_pairs_columns``)."""
    return Aligner.build(index, options, device=device).align_pairs_columns(
        _as_batch(reads1), _as_batch(reads2))
