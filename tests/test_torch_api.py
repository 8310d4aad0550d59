"""The port's search API equals the JAX package's, exactly, on the CPU:
``search`` and ``multi_search`` return equal ``SearchResult`` lists on
``tests/test_api.py``'s cases (one query, a ``Sequence``, several
queries, ambiguity holes laid back over ``ref_subseq``, the reverse
strand, no hits, a prebuilt ``FMIndex`` or ``Aligner``, an exact-mode
``Aligner``). Every query is 65-96 bases long, so the JAX package
compiles its full pipeline for one batch shape."""

import dataclasses

import numpy as np
import pytest

from bioseqdb_tpu import api as japi
from bioseqdb_tpu.align.options import AlignOptions as JAlignOptions
from bioseqdb_tpu.align.pipeline import Aligner as JAligner
from bioseqdb_tpu.index.builder import build_index as jbuild_index
from bioseqdb_tpu.seq.codec import Sequence as JSequence
from bioseqdb_tpu_torch import api
from bioseqdb_tpu_torch.align.options import AlignOptions, bwa_opts
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.seq.codec import Sequence
from bioseqdb_tpu_torch.utils.sim import simulate_genome


def _rc(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


@pytest.fixture(scope="module")
def refs():
    a = simulate_genome(3000, seed=51)
    b = simulate_genome(2000, seed=52)
    g = simulate_genome(2000, seed=53)
    holed = g[:800] + "NNNN" + g[800:]
    rows = [(100, "chrA", a), (200, "chrB", b), (1, "r", holed)]
    return a, b, g, rows


def _rows(results):
    return [dataclasses.asdict(r) for r in results]


def _queries(a, b, g):
    """(name, single query or list of queries) of the compared cases."""
    return [
        ("single", a[500:580]),
        ("multi", [a[0:80], b[0:80], a[1000:1080], _rc(b[300:390])]),
        ("holes", g[760:840]),
        ("reverse", _rc(a[300:380])),
        # random bases: no seed of 19 matches (an all-N query overflows the
        # kmer seeder, and the JAX package's overflow retry would compile)
        ("no_hits", "".join(np.random.default_rng(54).choice(list("ACGT"),
                                                             80))),
    ]


@pytest.mark.parametrize("name", ["single", "multi", "holes", "reverse",
                                  "no_hits"])
def test_search_equals_jax(refs, name):
    a, b, g, rows = refs
    q = dict(_queries(a, b, g))[name]
    if isinstance(q, list):
        want = japi.multi_search(q, rows)
        got = api.multi_search(q, rows, device="cpu")
        assert sorted({r.query_id for r in got}) == [0, 1, 2, 3]
    else:
        want = japi.search(q, rows)
        got = api.search(q, rows, device="cpu")
        assert all(r.query_id is None for r in got)
    assert _rows(got) == _rows(want)
    if name == "single":
        h = got[0]
        assert (h.ref_id, h.ref_name, h.ref_match_start, h.ref_match_end,
                h.cigar, h.score) == (100, "chrA", 500, 580, "80M", 80)
        assert h.ref_subseq == h.query_subseq == a[500:580]
    if name == "holes":
        assert "NNNN" in got[0].ref_subseq
    if name == "reverse":
        assert got[0].is_reverse and got[0].ref_subseq == a[300:380]
    if name == "no_hits":
        assert got == []


def test_search_sequence_and_prebuilt_equal_jax(refs):
    a, b, g, rows = refs
    want = japi.search(JSequence.from_text(b[100:170]), rows)
    got = api.search(Sequence.from_text(b[100:170]), rows, device="cpu")
    assert _rows(got) == _rows(want) and got[0].ref_id == 200
    jidx, tidx = jbuild_index(rows), build_index(rows)
    want = japi.search(a[600:680], jidx)
    assert _rows(api.search(a[600:680], tidx, device="cpu")) == _rows(want)
    al = Aligner.build(tidx, AlignOptions(), device="cpu")
    got = api.search(a[600:680], al, device="cuda")  # device: unused here
    assert _rows(got) == _rows(want) and got[0].ref_match_start == 600
    # an exact-mode Aligner answers through the exact path
    qs = [a[0:80], _rc(a[900:980]), b[5:90], a[10:40] + "T" + a[41:90]]
    want = japi.multi_search(qs, JAligner.build(jidx, JAlignOptions(),
                                                mode="exact"))
    got = api.multi_search(qs, Aligner.build(tidx, AlignOptions(),
                                             device="cpu", mode="exact"))
    assert _rows(got) == _rows(want)
    assert [r.query_id for r in got] == [0, 1, 2]


def test_search_with_options_and_ns():
    a = simulate_genome(3000, seed=51)
    idx = build_index([(100, "chrA", a)])
    hits = api.search(a[600:700], idx, bwa_opts(min_seed_len=25),
                      device="cpu")
    assert hits[0].ref_match_start == 600 and hits[0].cigar == "100M"
    assert api.search("N" * 60, idx, device="cpu") == []
