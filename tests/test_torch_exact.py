"""Exact mode of the port equals the JAX package's, exactly, on the CPU:
``backward_search``'s intervals (reads with Ns, empty reads, absent
reads, reads across two references), ``exact_align_step``'s host dict
whole at ``max_hits`` 4 and 64, and ``Aligner.build(mode="exact")``'s
records and SAM text (a unique read set, a repeat, two references)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioseqdb_tpu.align import pipeline as jpipe
from bioseqdb_tpu.align.options import AlignOptions as JAlignOptions
from bioseqdb_tpu.index.builder import build_index as jbuild_index
from bioseqdb_tpu.io.batch import pack_reads as jpack_reads
from bioseqdb_tpu.kernels import fm as jfm
from bioseqdb_tpu.sam.emit import emit_sam as jemit_sam
from bioseqdb_tpu_torch.align import pipeline as tpipe
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import fm as tfm
from bioseqdb_tpu_torch.sam.emit import emit_sam
from bioseqdb_tpu_torch.utils.sim import simulate_genome, simulate_reads


def _revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGTN", "TGCAN"))


def _case(name):
    """(refs, reads) of a case: refs as build_index takes them."""
    if name == "lambda":
        g = simulate_genome(48_000, seed=1)
        sim = simulate_reads(g, 40, read_len=100, seed=2)
        rng = np.random.default_rng(3)
        reads = list(sim.reads) + [
            "ACGTN" + g[:50],                       # an N kills the match
            g[1000:1040] + "N" + g[1041:1100],
            "",                                     # an empty read
            "".join(rng.choice(list("ACGT"), 90)),  # absent (almost surely)
            _revcomp(g[2000:2120]), g[-60:], g[:33],
        ]
        return [("lambda", g)], reads
    if name == "repeat":
        core = simulate_genome(3000, seed=3)
        rep = simulate_genome(200, seed=4)
        g = core[:1000] + rep + core[1000:2000] + rep + core[2000:]
        return [("rep", g)], [rep[50:130], rep[:200], core[10:90],
                              _revcomp(rep[20:120]),
                              rep[150:200] + core[1000:1030]]
    a = simulate_genome(500, seed=5)
    b = simulate_genome(500, seed=6)
    return ([(11, "chrA", a), (22, "chrB", b)],
            [b[100:180], (a + b)[460:540], (a + b)[480:520], a[420:500],
             b[:80], _revcomp((a + b)[470:530]), a[:500]])


@pytest.fixture(scope="module", params=["lambda", "repeat", "two_refs"])
def case(request):
    refs, reads = _case(request.param)
    jidx, tidx = jbuild_index(refs), build_index(refs)
    names = [f"r{i}" for i in range(len(reads))]
    return dict(jidx=jidx, tidx=tidx, reads=reads,
                jbatch=jpack_reads(reads, names),
                tbatch=pack_reads(reads, names),
                jfm=jfm.FMDevice.from_host(jidx),
                tfm=tfm.FMDevice.from_host(tidx, "cpu"))


def test_backward_search_equals_jax(case):
    b = case["jbatch"]
    lo, hi = jax.device_get(jfm.backward_search(
        case["jfm"], jnp.asarray(b.codes, jnp.int32), jnp.asarray(b.lens)))
    tlo, thi = tfm.backward_search(
        case["tfm"], torch.from_numpy(b.codes.astype(np.int32)),
        torch.from_numpy(b.lens))
    assert np.array_equal(tlo.numpy(), lo) and np.array_equal(thi.numpy(), hi)
    assert tlo.dtype == thi.dtype == torch.int32
    n = (hi - lo)[: b.n]
    assert (n >= 1).any()
    dead = [i for i, r in enumerate(case["reads"]) if not r or "N" in r]
    assert (n[dead] == 0).all() and (lo[dead] == 0).all()


@pytest.mark.parametrize("max_hits", [4, 64])
def test_exact_align_step_equals_jax(case, max_hits):
    b = case["jbatch"]
    sa = case["jidx"].sa_interval
    want = jax.device_get(jpipe.exact_align_step(
        case["jfm"], jnp.asarray(b.codes), jnp.asarray(b.lens), max_hits,
        sa_interval=sa))
    got = tpipe.exact_align_step(
        case["tfm"], torch.from_numpy(case["tbatch"].codes),
        torch.from_numpy(case["tbatch"].lens), max_hits, sa_interval=sa)
    assert set(got) == set(want) == {"n_hits", "valid", "rid", "pos", "rev"}
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_exact_records_and_sam_equal_jax(case):
    want = jpipe.Aligner.build(case["jidx"], JAlignOptions(),
                               mode="exact").align_batch(case["jbatch"])
    al = tpipe.Aligner.build(case["tidx"], AlignOptions(), device="cpu",
                             mode="exact")
    got = al.align_batch(case["tbatch"])
    assert ([dataclasses.asdict(r) for r in got]
            == [dataclasses.asdict(r) for r in want])
    assert any(len(r.hits) for r in got)
    reads = case["reads"]
    assert (emit_sam(got, case["tidx"], reads, header=True)
            == jemit_sam(want, case["jidx"], reads, header=True))
    # max_hits and query ids reach the records as in JAX
    want1 = jpipe.Aligner.build(case["jidx"], JAlignOptions(), mode="exact"
                                ).align_batch(case["jbatch"], max_hits=1,
                                              with_query_ids=False)
    got1 = al.align_batch(case["tbatch"], max_hits=1, with_query_ids=False)
    assert ([dataclasses.asdict(r) for r in got1]
            == [dataclasses.asdict(r) for r in want1])


def test_exact_repeat_fields():
    """``test_exact_mode_field_complete``'s repeat: the primary has MAPQ 0
    and XS the repeat's score, the secondary no XS."""
    core = simulate_genome(3000, seed=3)
    rep = simulate_genome(200, seed=4)
    g = core[:1000] + rep + core[1000:2000] + rep + core[2000:]
    al = tpipe.Aligner.build(build_index([("rep", g)]), AlignOptions(),
                             device="cpu", mode="exact")
    res = al.align_batch(pack_reads([rep[50:130]], ["rep"]))[0]
    assert len(res.hits) >= 2
    h0, h1 = res.hits[:2]
    assert (h0.mapq, h0.sub, h0.nm, h0.md, h0.cigar) == (0, 80, 0, "80", "80M")
    assert (h1.sub, h1.mapq, h1.is_secondary) == (-1, 0, True)
    assert sorted(h.ref_begin for h in res.hits[:2]) == [1050, 2250]


def test_exact_mode_build_and_pairs():
    g = simulate_genome(5000, seed=9)
    idx = build_index([("g", g)])
    al = tpipe.Aligner.build(idx, AlignOptions(), device="cpu", mode="exact")
    # the FM tables alone: no packed text, kmer table or jump table
    assert (al.pac_rows, al.kmer, al.jump) == (None, None, None)
    b = pack_reads([g[100:200]], ["a"])
    for fn in (al.align_pairs, al.align_pairs_columns):
        with pytest.raises(ValueError):
            fn(b, b)
    with pytest.raises(ValueError):
        al.device_regions(b)
    with pytest.raises(ValueError):
        tpipe.Aligner.build(idx, AlignOptions(), device="cpu", mode="fast")
