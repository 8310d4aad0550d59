"""The port's copies of the JAX package's host modules equal the
originals, exactly: the index the port builds (and the one
``fmindex_from_jax`` carries over, and the one ``FMIndex.load`` reads
from a JAX-saved directory), the read simulator, FASTA and read-batch
packing, the host oracle's records, given one ``out`` dict,
``finalize_columns``, ``finalize_batch`` and the SAM text, given one
pair of ``out`` dicts, ``finalize_pairs``, ``finalize_pairs_columns``
and the PE SAM text, and the insert-size statistics."""

import copy
import dataclasses

import numpy as np
import pytest

from bioseqdb_tpu.align import columns as jcolumns
from bioseqdb_tpu.align import finalize as jfinalize
from bioseqdb_tpu.align import paired as jpaired
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
from bioseqdb_tpu_torch.align import paired as tpaired
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
    return dict(g=g, reads=rd, names=[f"q{i}" for i in range(len(rd))],
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


@pytest.fixture(scope="module")
def pairs_finalized(reads):
    """One pair batch's device ``out`` dicts (the port's fused step on the
    CPU), finalized by both packages' PE finalizers. The batch holds a
    mate mutated at every 12th base, which only mate rescue places, and
    an all-N mate."""
    sr1, sr2, _ = jsim.simulate_pairs(reads["g"], 24, read_len=100,
                                      insert_mean=300, insert_std=30,
                                      sub_rate=0.01, seed=23)
    reads2 = list(sr2.reads)
    bad = list(reads2[5])
    for k in range(0, 100, 12):
        bad[k] = {"A": "C", "C": "G", "G": "T", "T": "A"}[bad[k]]
    reads2[5], reads2[9] = "".join(bad), "N" * 100
    names = sr1.names
    tb, jb = ((P.pack_reads(sr1.reads, names), P.pack_reads(reads2, names))
              for P in (tbatch, jbatch))
    al = Aligner.build(reads["tidx"], AlignOptions(), device="cpu")
    o1, o2 = al.device_regions_pair(*tb)
    out = al.absorb_overflow_pair(tb[0], o1, tb[1], o2)
    side = dict(jax=(reads["jidx"], JAlignOptions(), jb, jpaired, jemit),
                torch=(reads["tidx"], AlignOptions(), tb, tpaired, temit))
    res = {}
    for name, (idx, opt, b, P, E) in side.items():
        args = (idx, opt, b[0], copy.deepcopy(out[0]), b[1],
                copy.deepcopy(out[1]))
        cols = P.finalize_pairs_columns(*args)
        res[name] = dict(
            cols=cols, pairs=P.finalize_pairs(*args),
            sam=E.emit_sam_pair_columns(*cols, idx, *b, header=True))
    return res


@pytest.mark.parametrize("what", ["cols", "pairs", "sam"])
def test_finalize_pairs_equal_jax(pairs_finalized, what):
    j, t = pairs_finalized["jax"][what], pairs_finalized["torch"][what]
    if what == "cols":
        assert [_dump_cols(c) for c in j] == [_dump_cols(c) for c in t]
        assert j[0].fast.any() and j[1].extra
    else:
        assert _dump(j) == _dump(t)
    if what == "pairs":     # the mutated mate was rescued into a proper pair
        assert t[5][1].mapped and t[5][1].pe.flag_extra & 0x2
        assert not t[9][1].mapped


def test_pestat_and_infer_dir_equal_jax():
    rng = np.random.default_rng(24)
    l_pac = 50_000
    n = 64
    rb1 = rng.integers(0, l_pac - 1000, n)
    # mostly FR pairs (the mate on the reverse strand), the rest anywhere
    fr = 2 * l_pac - (rb1 + rng.normal(300, 30, n).astype(np.int64))
    rb2 = np.where(rng.random(n) < 0.8, fr, rng.integers(0, 2 * l_pac, n))
    s1, s2 = rng.integers(0, 160, n), rng.integers(0, 160, n)
    for min_score in (AlignOptions().min_score, 10):
        opt_j = JAlignOptions(min_score=min_score)
        opt_t = AlignOptions(min_score=min_score)
        j = jpaired.pestat_arrays(rb1, rb2, s1, s2, opt_j, l_pac)
        t = tpaired.pestat_arrays(rb1, rb2, s1, s2, opt_t, l_pac)
        assert _dump(j) == _dump(t)
        assert any(not st.failed for st in t)
    for a, b in zip(rb1.tolist(), rb2.tolist()):
        assert jpaired.infer_dir(l_pac, a, b) == tpaired.infer_dir(l_pac, a, b)

