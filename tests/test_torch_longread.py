"""Reads over 320 bases: port == JAX package == host oracle.

``tests/test_longread.py``'s cases on its 120 kb genome (seed 51): two
reads each of its 1,200 bp reads at 1% substitutions (read seed 52), its
2,000 bp exact reads (53), and its 1,500 bp / 150 bp mix (54, 55), in
one batch (2,016 wide, so one JAX compile serves them all). The batch
goes through the port's ``Aligner`` (torch on the CPU, plain kernels)
and the JAX ``Aligner``, both built with their default seeder: batches
wider than 320 bases leave the kmer seeder for the FM state machine
(with its round-3 jump) on both sides, and the seed-SW filter runs
before extension. The ``device_regions`` wire dicts must be equal whole,
and every read's records must equal the host oracle's. The seed-SW
filter (``kernels/seedsw.py``) is held to the JAX function on the seeds
the port's step gave it, a few of them moved off their locus so that
the filter drops them, and its static gate to the oracle's. Integer
programs: tolerance 0 (the filter's float32 thresholds are computed as
the JAX version computes them)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bioseqdb_tpu.align.options import AlignOptions as JAlignOptions
from bioseqdb_tpu.align.pipeline import Aligner as JAligner
from bioseqdb_tpu.cpu import oracle as JO
from bioseqdb_tpu.index.builder import build_index
from bioseqdb_tpu.io.batch import pack_reads as jpack_reads
from bioseqdb_tpu.kernels import fm as jfm
from bioseqdb_tpu.kernels import seedsw as jseedsw
from bioseqdb_tpu.utils.sim import simulate_genome, simulate_reads
from bioseqdb_tpu_torch.align import pipeline
from bioseqdb_tpu_torch.align.finalize import finalize_batch
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.cpu import oracle as O
from bioseqdb_tpu_torch.cpu.ksw import cigar_to_string
from bioseqdb_tpu_torch.index import layout
from bioseqdb_tpu_torch.index.convert import fmindex_from_jax
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import seedsw

LUT = np.zeros(256, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    LUT[_c] = _i
LUT[ord("N")] = 4
SW_KW = ("match_score", "mismatch_penalty", "o_del", "e_del", "o_ins",
         "e_ins", "min_chain_weight")


def _reads(g):
    """Two reads of each of test_longread.py's simulations."""
    out = []
    for n, L, sub, seed in ((6, 1200, 0.01, 52), (4, 2000, 0.0, 53),
                            (3, 1500, 0.01, 54), (3, 150, 0.01, 55)):
        out += list(simulate_reads(g, n, read_len=L, sub_rate=sub,
                                   seed=seed).reads)[:2]
    return out


@pytest.fixture(scope="module")
def run():
    g = simulate_genome(120_000, seed=51)
    idx = build_index([("ref", g)])
    reads = _reads(g)
    names = [f"r{i}" for i in range(len(reads))]
    jal = JAligner.build(idx, JAlignOptions(), mode="full")
    j_out = jax.device_get(jal.device_regions(jpack_reads(reads, names)))
    tidx = fmindex_from_jax(idx)
    tal = Aligner.build(tidx, AlignOptions(), device="cpu")
    batch = pack_reads(reads, names)
    # keep the seed-SW filter's inputs of the port's step
    seen, real = {}, pipeline.seed_sw_filter

    def kept(fm, pac_rows, codes, lens, seeds, **kw):
        seen.update(codes=codes, lens=lens, seeds=seeds, kw=kw)
        return real(fm, pac_rows, codes, lens, seeds, **kw)

    pipeline.seed_sw_filter = kept
    try:
        t_out = tal.device_regions(batch)
    finally:
        pipeline.seed_sw_filter = real
    return dict(idx=idx, tidx=tidx, tal=tal, reads=reads, batch=batch,
                out=(j_out, t_out), filter_inputs=seen)


def test_filter_gate_matches_oracle():
    opt = AlignOptions()
    for L in (100, 300, 719, 720, 899, 1200, 3000):
        want = O.seed_sw_filter_active(opt, L)
        assert seedsw.possibly_active(opt.min_chain_weight, L) == want, L
        assert want == JO.seed_sw_filter_active(JAlignOptions(), L), L
        assert jseedsw.possibly_active(opt.min_chain_weight, L) == want, L


def test_device_regions_equal_jax(run):
    j, t = run["out"]
    n = run["batch"].n
    assert run["batch"].width >= 2000
    assert set(t) == set(j) and set(t["regs"]) == set(j["regs"])
    for k in ("n_regs", "overflow", "l_rep", "off"):
        a, b = np.asarray(j[k]), t[k]
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k, v in j["regs"].items():
        a, b = np.asarray(v), t["regs"][k]
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    # the long reads stay on the device path
    assert not np.asarray(j["overflow"])[:n].any()
    assert (np.asarray(t["n_regs"])[:n] > 0).all()


def test_records_equal_oracle(run):
    idx, opt, tal = run["tidx"], AlignOptions(), run["tal"]
    batch = run["batch"]
    out = tal.absorb_overflow(batch, run["out"][1])
    results = finalize_batch(idx, opt, batch, out, True)
    for i, r in enumerate(run["reads"]):
        q = LUT[np.frombuffer(r.encode(), np.uint8)]
        want = O.align_read(idx, opt, q, rand_id=i, min_score=opt.min_score,
                            all_hits=True)
        w = [(a.pos, a.is_rev, cigar_to_string(a.cigar), a.score, a.mapq,
              a.NM, bool(a.flag & 0x100)) for a in want]
        got = [(h.ref_begin, h.is_reverse, h.cigar, h.score, h.mapq, h.nm,
                h.is_secondary) for h in results[i].hits]
        assert got == w, (i, got, w)


def test_seed_sw_filter_equal_jax(run):
    """Stage parity on the seeds the port's step handed the filter: the
    pruned ``valid`` and the ``score`` column equal the JAX function's.
    Five short seeds of the first read are moved 7,919 bases along the
    reference, so their windows no longer align and both drop them."""
    inp, idx = run["filter_inputs"], run["idx"]
    seeds = {k: v.clone() for k, v in inp["seeds"].items()}
    short = torch.nonzero(seeds["valid"][0] & (seeds["len"][0] < 90))[:5, 0]
    assert len(short) == 5
    seeds["rbeg"][0, short] += 7919
    kw = {k: inp["kw"][k] for k in SW_KW}
    got = seedsw.seed_sw_filter(run["tal"].fm, run["tal"].pac_rows,
                                inp["codes"], inp["lens"], seeds, **kw)
    jfilter = jax.jit(jseedsw.seed_sw_filter, static_argnames=SW_KW)
    want = jax.device_get(jfilter(
        jfm.FMDevice.from_host(idx),
        jnp.asarray(layout.pack_doubled_rows(np.asarray(idx.pac))),
        jnp.asarray(inp["codes"].numpy()), jnp.asarray(inp["lens"].numpy()),
        {k: jnp.asarray(v.numpy()) for k, v in seeds.items()}, **kw))
    for k in ("valid", "score"):
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k
    # long reads' short seeds re-scored; the 150 bp reads' left alone
    lens = inp["lens"]
    rescored = seeds["valid"] & (got["score"] != seeds["len"] * kw["match_score"])
    assert rescored[lens > 1000].sum() > 10 and not rescored[lens < 300].any()
    assert not got["valid"][0, short].any()
