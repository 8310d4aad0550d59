"""The slice as a whole: port == JAX package == host oracle.

One read batch goes through the port's ``Aligner`` (torch on the CPU,
plain kernels) and the JAX ``Aligner``: the dense ``device_regions``
tables after ``maybe_unpack``, then ``absorb_overflow`` (the fat-cap FM
retry), ``finalize_columns`` and the SAM text. The reads include repeat
reads that overflow the kmer fast path, so the retry runs on both sides.
Both retries seed with the FM machine and its round-3 jump table, and
the port's machine takes the JAX machine's steps, so the retried tables
and overflow masks are compared whole. Reads off their simulated origin
are checked against the host oracle. The port's side runs on its own host code (read batch,
finalize, SAM, oracle) and on the JAX index carried over with
``fmindex_from_jax``."""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from bioseqdb_tpu.align.columns import finalize_columns as jfinalize_columns
from bioseqdb_tpu.align.finalize import maybe_unpack as jmaybe_unpack
from bioseqdb_tpu.align.options import AlignOptions as JAlignOptions
from bioseqdb_tpu.align.pipeline import Aligner as JAligner
from bioseqdb_tpu.index.builder import build_index
from bioseqdb_tpu.io.batch import pack_reads as jpack_reads
from bioseqdb_tpu.sam.emit import emit_sam_columns as jemit_sam_columns
from bioseqdb_tpu.utils.sim import simulate_genome, simulate_reads
from bioseqdb_tpu_torch.align.columns import finalize_columns
from bioseqdb_tpu_torch.align.finalize import maybe_unpack
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner, align
from bioseqdb_tpu_torch.cpu import oracle as O
from bioseqdb_tpu_torch.index.convert import fmindex_from_jax
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.sam.emit import emit_sam_columns


@pytest.fixture(scope="module")
def run():
    core = simulate_genome(120_000, seed=61)
    rep = simulate_genome(600, seed=62)
    g = core[:30000] + rep + core[30000:70000] + rep + core[70000:]
    idx = build_index([("chrA", g), ("chrB", simulate_genome(20_000, seed=63))])
    sim = simulate_reads(g, 112, read_len=150, sub_rate=0.01, seed=64)
    reads = list(sim.reads)
    reads += [g[30000 + 70 * k : 30150 + 70 * k] for k in range(6)]  # repeats
    reads += [g[5000:5070] + g[90000:90080], "N" * 150,
              g[44000:44060] + "NNN" + g[44063:44150]]
    names = [f"r{i}" for i in range(len(reads))]
    jbatch = jpack_reads(reads, names)
    jal = JAligner.build(idx, JAlignOptions(), mode="full")
    j_out = jax.device_get(jal.device_regions(jbatch))
    j_abs = jal.absorb_overflow(jbatch, j_out)
    jc = jfinalize_columns(idx, jal.options, jbatch, j_abs)

    tidx, opt = fmindex_from_jax(idx), AlignOptions()
    batch = pack_reads(reads, names)
    tal = Aligner.build(tidx, opt, device="cpu")
    t_out = tal.device_regions(batch)
    t_abs = tal.absorb_overflow(batch, t_out)
    tc = finalize_columns(tidx, opt, batch, t_abs)
    cols = dict(jax=(jc, jemit_sam_columns(jc, idx, jbatch, header=False)),
                torch=(tc, emit_sam_columns(tc, tidx, batch, header=False)))
    return dict(idx=tidx, opt=opt, g=g, sim=sim, batch=batch, reads=reads,
                out=(j_out, t_out), abs=(j_abs, t_abs), cols=cols, tal=tal)


def test_device_regions_wire_format_equal(run):
    j_out, t_out = run["out"]
    assert set(t_out) == set(j_out)
    assert set(t_out["regs"]) == set(j_out["regs"])
    for k in ("n_regs", "overflow", "l_rep", "off"):
        a, b = np.asarray(j_out[k]), t_out[k]
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k, v in j_out["regs"].items():
        a, b = np.asarray(v), t_out["regs"][k]
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    # repeat reads overflow the kmer fast path: the retry has work
    assert np.asarray(j_out["overflow"]).sum() >= 3


def test_dense_regions_equal(run):
    j, t = jmaybe_unpack(run["out"][0]), maybe_unpack(run["out"][1])
    for k in ("n_regs", "overflow", "l_rep"):
        assert np.array_equal(np.asarray(j[k]), t[k]), k
    for k, v in j["regs"].items():
        assert np.array_equal(np.asarray(v), t["regs"][k]), k


def test_absorb_overflow_equal(run):
    j, t = run["abs"]
    n = run["batch"].n
    for k in ("n_regs", "overflow", "l_rep"):
        assert np.array_equal(np.asarray(j[k]), t[k]), k
    for k, v in j["regs"].items():
        assert np.array_equal(np.asarray(v), t["regs"][k]), k
    # the retry resolved the kmer fallbacks on both sides
    assert t["overflow"][:n].sum() < np.asarray(
        run["out"][1]["overflow"])[:n].sum()


def test_records_and_sam_equal(run):
    (cj, sam_j), (ct, sam_t) = run["cols"]["jax"], run["cols"]["torch"]
    assert sam_t == sam_j
    for f in ("mapped", "pos", "rid", "mapq", "nm", "score", "sub", "is_rev",
              "qb", "qe", "cig_len", "md_len"):
        assert np.array_equal(getattr(cj, f), getattr(ct, f)), f


def test_off_truth_reads_equal_oracle(run):
    ct, _ = run["cols"]["torch"]
    sim, batch, idx, opt = run["sim"], run["batch"], run["idx"], run["opt"]
    n = len(sim.positions)
    at_truth = (ct.mapped[:n] & (ct.pos[:n] == sim.positions)
                & (ct.is_rev[:n] == sim.strands.astype(bool)))
    assert at_truth.mean() > 0.95
    check = list(np.flatnonzero(~at_truth)) + list(range(n, batch.n))
    for i in check:
        q = np.asarray(batch.codes)[i, : batch.lens[i]].astype(np.uint8)
        regs = O.align_read(idx, opt, q, rand_id=int(i),
                            min_score=opt.min_score, all_hits=True)
        prim = next((a for a in regs if not a.flag & 0x100), None)
        if prim is None:
            assert not ct.mapped[i], i
        else:
            assert (bool(ct.mapped[i]), int(ct.pos[i]), bool(ct.is_rev[i]),
                    int(ct.score[i])) == (True, prim.pos, bool(prim.is_rev),
                                          prim.score), i


def test_align_entry_point(run):
    got = align(run["reads"][:8], run["idx"], run["opt"], device="cpu")
    want = run["tal"].align_batch(pack_reads(run["reads"][:8]))
    assert [[(h.ref_begin, h.cigar, h.score) for h in r.hits] for r in got] \
        == [[(h.ref_begin, h.cigar, h.score) for h in r.hits] for r in want]
    assert got[0].hits and got[0].hits[0].cigar


def test_unsupported_inputs_raise(run):
    """What the port still refuses: indexes of 2^31 or more doubled bases
    (int64 ranks), and a CUDA device without a card. Options the kmer
    seeder cannot take and reads over 320 bases no longer raise
    (tests/test_torch_fmseed.py, tests/test_torch_longread.py)."""
    idx = run["idx"]
    big = dataclasses.replace(idx, seq_len=(1 << 31) - 1)
    with pytest.raises(NotImplementedError):
        Aligner.build(big, AlignOptions(), device="cpu")
    assert Aligner.build(idx, AlignOptions(min_seed_len=15),
                         device="cpu").kmer is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Aligner.build(idx, AlignOptions(), device="cuda")
