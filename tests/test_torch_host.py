"""The port's copies of the JAX package's host modules equal the
originals, exactly: the index the port builds (and the one
``fmindex_from_jax`` carries over, and the one ``FMIndex.load`` reads
from a JAX-saved directory), the read simulator, FASTA and read-batch
packing, the host oracle's records, and, given one ``out`` dict,
``finalize_columns``, ``finalize_batch`` and the SAM text."""

import copy
import dataclasses

import numpy as np
import pytest

from bioseqdb_tpu.align import columns as jcolumns
from bioseqdb_tpu.align import finalize as jfinalize
from bioseqdb_tpu.align.options import AlignOptions as JAlignOptions
from bioseqdb_tpu.cpu import oracle as joracle
from bioseqdb_tpu.index import builder as jbuilder
from bioseqdb_tpu.index.fmindex import FMIndex as JFMIndex
from bioseqdb_tpu.io import batch as jbatch
from bioseqdb_tpu.io import fasta as jfasta
from bioseqdb_tpu.sam import emit as jemit
from bioseqdb_tpu.utils import sim as jsim
from bioseqdb_tpu_torch.align import columns as tcolumns
from bioseqdb_tpu_torch.align import finalize as tfinalize
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.cpu import oracle as toracle
from bioseqdb_tpu_torch.index import builder as tbuilder
from bioseqdb_tpu_torch.index.convert import fmindex_from_jax
from bioseqdb_tpu_torch.index.fmindex import FMIndex
from bioseqdb_tpu_torch.io import batch as tbatch
from bioseqdb_tpu_torch.io import fasta as tfasta
from bioseqdb_tpu_torch.sam import emit as temit
from bioseqdb_tpu_torch.utils import sim as tsim

FIELDS = [f.name for f in dataclasses.fields(JFMIndex)]


def _refs(case):
    if case == "plain":
        return [("chr1", jsim.simulate_genome(40_000, seed=11))], None
    # ambiguity holes, an IUPAC base and an ALT contig
    g1 = jsim.simulate_genome(30_000, seed=12, n_frac=0.002)
    g2 = jsim.simulate_genome(9_000, seed=13)
    g2 = g2[:4000] + "R" + g2[4001:]
    return [("chrA", g1), ("chrB", g2), ("chrB_alt", g2[:3000])], ["chrB_alt"]


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def _assert_index_equal(j, t):
    assert isinstance(t, FMIndex)
    for f in FIELDS:
        assert _equal(getattr(j, f), getattr(t, f)), f


@pytest.fixture(scope="module", params=["plain", "holes_alt"])
def indexes(request):
    refs, alt = _refs(request.param)
    return (jbuilder.build_index(refs, alt_names=alt),
            tbuilder.build_index(refs, alt_names=alt))


def test_build_index_equals_jax(indexes):
    _assert_index_equal(*indexes)


def test_fmindex_from_jax_equals_jax(indexes):
    j, _ = indexes
    _assert_index_equal(j, fmindex_from_jax(j))


def test_load_reads_jax_saved_index(indexes, tmp_path):
    j, _ = indexes
    j.save(str(tmp_path / "idx"))
    _assert_index_equal(j, FMIndex.load(str(tmp_path / "idx")))


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_sim_equals_jax(seed):
    g = jsim.simulate_genome(20_000, seed=seed, n_frac=0.001)
    assert tsim.simulate_genome(20_000, seed=seed, n_frac=0.001) == g
    js = jsim.simulate_reads(g, 40, read_len=120, sub_rate=0.02, seed=seed)
    ts = tsim.simulate_reads(g, 40, read_len=120, sub_rate=0.02, seed=seed)
    for f in dataclasses.fields(js):
        assert _equal(getattr(js, f.name), getattr(ts, f.name)), f.name
    jp = jsim.simulate_pairs(g, 10, seed=seed)
    tp = tsim.simulate_pairs(g, 10, seed=seed)
    assert _dump(jp) == _dump(tp)


def _dump(x):
    """A plain nested form of dataclasses, tuples, lists and arrays, so
    objects of the two packages compare."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,
                {f.name: _dump(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _dump(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_dump(v) for v in x]
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tolist())
    return x


def test_fasta_and_pack_reads_equal_jax(tmp_path):
    recs = [(f"r{i} d{i}", s) for i, s in enumerate(
        ["ACGTNACGT", "GGGCCCAAATTT" * 9, "N" * 5, "acgtRYKM"])]
    fa, fq = str(tmp_path / "a.fa"), str(tmp_path / "a.fq")
    jfasta.write_fasta(fa, recs)
    tfasta.write_fastq(fq, list(tfasta.read_fasta(fa)))
    for path in (fa, fq):
        jr, tr = list(jfasta.read_seqs(path)), list(tfasta.read_seqs(path))
        assert _dump(jr) == _dump(tr) and len(tr) == len(recs)
    seqs = [r.sequence for r in jr]
    jb = jbatch.pack_reads(seqs, [r.name for r in jr])
    tb = tbatch.pack_reads(seqs, [r.name for r in tr])
    assert _dump(jb) == _dump(tb)
    assert _equal(jbatch.revcomp_codes(jb.codes, jb.lens),
                  tbatch.revcomp_codes(tb.codes, tb.lens))


@pytest.fixture(scope="module")
def reads():
    g = jsim.simulate_genome(60_000, seed=21)
    sim = jsim.simulate_reads(g, 16, read_len=150, sub_rate=0.02, seed=22)
    rd = list(sim.reads) + [g[1000:1060] + g[30000:30090],   # chimeric
                            g[5000:5070] + "NNNN" + g[5074:5150],
                            "N" * 150, g[40000:40100]]
    refs = [("g", g)]
    return dict(reads=rd, names=[f"q{i}" for i in range(len(rd))],
                jidx=jbuilder.build_index(refs),
                tidx=tbuilder.build_index(refs))


def test_oracle_align_read_equals_jax(reads):
    jopt, topt = JAlignOptions(), AlignOptions()
    jb = jbatch.pack_reads(reads["reads"], reads["names"])
    n_hits = 0
    for i in range(jb.n):
        q = jb.codes[i, : jb.lens[i]].astype(np.uint8)
        ja = joracle.align_read(reads["jidx"], jopt, q, rand_id=i)
        ta = toracle.align_read(reads["tidx"], topt, q, rand_id=i)
        assert [(a.pos, a.is_rev, a.score, a.cigar, a.flag, a.mapq, a.NM,
                 a.MD) for a in ja] == [(a.pos, a.is_rev, a.score, a.cigar,
                                         a.flag, a.mapq, a.NM, a.MD)
                                        for a in ta], i
        n_hits += len(ta)
    assert n_hits >= jb.n - 1


@pytest.fixture(scope="module")
def finalized(reads):
    tidx, jidx = reads["tidx"], reads["jidx"]
    topt, jopt = AlignOptions(), JAlignOptions()
    tb = tbatch.pack_reads(reads["reads"], reads["names"])
    jb = jbatch.pack_reads(reads["reads"], reads["names"])
    al = Aligner.build(tidx, topt, device="cpu")
    out = al.absorb_overflow(tb, al.device_regions(tb))
    side = dict(
        jax=(jidx, jopt, jb, jcolumns, jfinalize, jemit),
        torch=(tidx, topt, tb, tcolumns, tfinalize, temit))
    res = {}
    for name, (idx, opt, b, C, F, E) in side.items():
        cols = C.finalize_columns(idx, opt, b, copy.deepcopy(out))
        recs = F.finalize_batch(idx, opt, b, copy.deepcopy(out))
        res[name] = dict(
            cols=cols, recs=recs,
            sam_cols=E.emit_sam_columns(cols, idx, b, header=True),
            sam=E.emit_sam(recs, idx, reads["reads"]))
    return res


def _dump_cols(c):
    """AlignColumns without its text blob, whose bytes past the rows'
    CIGAR/MD text are never written; the text goes in row by row."""
    name, fields = _dump(c)
    fields.pop("text")
    return name, fields, [(c.cigar(i), c.md(i)) for i in range(c.n)]


@pytest.mark.parametrize("what", ["cols", "recs", "sam_cols", "sam"])
def test_finalize_and_sam_equal_jax(finalized, what):
    j, t = finalized["jax"][what], finalized["torch"][what]
    if what == "cols":
        assert _dump_cols(j) == _dump_cols(t)
        assert j.mapped.sum() >= j.n - 2 and j.extra
    else:
        assert _dump(j) == _dump(t)

