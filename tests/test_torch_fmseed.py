"""The FM seeder as the main seeder: port == JAX package, exactly.

The JAX ``Aligner`` built under ``BST_SEEDER=fm`` (as
``tests/test_kmer_seed.py`` sets it) and the port's ``Aligner`` built
the same way run one batch of 150 bp reads through the FM state machine
with its round-3 jump table: simulated reads, reads inside an exact
600 bp repeat and a tandem repeat, low-complexity and all-N reads and a
chimera, so some rows overflow the step's caps and the fat retry has
work. The ``device_regions`` wire dicts must be equal whole (overflow
masks included: the port's machine takes the JAX machine's steps), then
the tables after ``absorb_overflow``, the records and the SAM text. A
second configuration, ``min_seed_len=15``, is one the kmer seeder
cannot take: the port chooses the FM seeder instead of failing, and its
records equal the host oracle's. Integer programs: tolerance 0."""

import os

import jax
import numpy as np
import pytest

from bioseqdb_tpu.align.columns import finalize_columns as jfinalize_columns
from bioseqdb_tpu.align.options import AlignOptions as JAlignOptions
from bioseqdb_tpu.align.pipeline import Aligner as JAligner
from bioseqdb_tpu.index.builder import build_index
from bioseqdb_tpu.io.batch import pack_reads as jpack_reads
from bioseqdb_tpu.sam.emit import emit_sam_columns as jemit_sam_columns
from bioseqdb_tpu.utils.sim import simulate_genome, simulate_reads
from bioseqdb_tpu_torch.align.columns import finalize_columns
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.cpu import oracle as O
from bioseqdb_tpu_torch.index.convert import fmindex_from_jax
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.sam.emit import emit_sam_columns
from bioseqdb_tpu_torch.tools import long_leg


def _with_fm_env(build):
    os.environ["BST_SEEDER"] = "fm"
    try:
        return build()
    finally:
        del os.environ["BST_SEEDER"]


@pytest.fixture(scope="module")
def run():
    core = simulate_genome(120_000, seed=61)
    rep = simulate_genome(600, seed=62)
    tandem = "ACGTTGCAT" * 60
    g = (core[:30000] + rep + core[30000:70000] + rep + core[70000:90000]
         + tandem + core[90000:])
    idx = build_index([("chrA", g), ("chrB", simulate_genome(20_000, seed=63))])
    sim = simulate_reads(g, 64, read_len=150, sub_rate=0.01, seed=64)
    reads = list(sim.reads)
    reads += [g[30000 + 70 * k : 30150 + 70 * k] for k in range(4)]
    p = g.find(tandem)
    reads += [g[p + 40 * k : p + 150 + 40 * k] for k in range(4)]
    reads += ["AC" * 75, "A" * 150, "ACGTN" * 30,
              g[5000:5070] + g[90000:90080], "N" * 150]
    names = [f"r{i}" for i in range(len(reads))]
    jbatch, batch = jpack_reads(reads, names), pack_reads(reads, names)
    tidx = fmindex_from_jax(idx)
    jal = _with_fm_env(lambda: JAligner.build(idx, JAlignOptions(),
                                              mode="full"))
    tal = _with_fm_env(lambda: Aligner.build(tidx, AlignOptions(),
                                             device="cpu"))
    j_out = jax.device_get(jal.device_regions(jbatch))
    t_out = tal.device_regions(batch)
    j_abs = jal.absorb_overflow(jbatch, j_out)
    t_abs = tal.absorb_overflow(batch, t_out)
    jc = jfinalize_columns(idx, jal.options, jbatch, j_abs)
    tc = finalize_columns(tidx, tal.options, batch, t_abs)
    return dict(idx=tidx, reads=reads, batch=batch, jal=jal, tal=tal,
                out=(j_out, t_out), abs=(j_abs, t_abs), cols=(jc, tc),
                sam=(jemit_sam_columns(jc, idx, jbatch, header=False),
                     emit_sam_columns(tc, tidx, batch, header=False)))


def test_seeder_choice(run):
    idx = run["idx"]
    assert run["tal"].kmer is None and run["jal"].kmer_meta is None
    assert run["tal"].jump.depth == 8
    assert Aligner.build(idx, AlignOptions(), device="cpu",
                         seeder="fm").kmer is None
    assert Aligner.build(idx, AlignOptions(), device="cpu").kmer is not None
    # chosen, not raised: an occurrence-scan cap the kmer seeder cannot use
    assert Aligner.build(idx, AlignOptions(max_mem_intv=1),
                         device="cpu").kmer is None
    with pytest.raises(ValueError):
        Aligner.build(idx, AlignOptions(), device="cpu", seeder="minimizer")


def test_wire_dict_equal_jax(run):
    j, t = run["out"]
    assert set(t) == set(j) and set(t["regs"]) == set(j["regs"])
    for k in ("n_regs", "overflow", "l_rep", "off"):
        a, b = np.asarray(j[k]), t[k]
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k, v in j["regs"].items():
        a, b = np.asarray(v), t["regs"][k]
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    # some rows overflow: the retry has work
    assert np.asarray(j["overflow"])[: run["batch"].n].sum() >= 3


def test_absorb_overflow_equal_jax(run):
    j, t = run["abs"]
    for k in ("n_regs", "overflow", "l_rep"):
        assert np.array_equal(np.asarray(j[k]), t[k]), k
    for k, v in j["regs"].items():
        assert np.array_equal(np.asarray(v), t["regs"][k]), k


def test_records_and_sam_equal_jax(run):
    (cj, ct), (sam_j, sam_t) = run["cols"], run["sam"]
    assert sam_t == sam_j
    for f in ("mapped", "pos", "rid", "mapq", "nm", "score", "sub", "is_rev",
              "qb", "qe", "cig_len", "md_len"):
        assert np.array_equal(getattr(cj, f), getattr(ct, f)), f
    assert ct.mapped.sum() >= 60


def test_kmer_ineligible_options_take_fm(run):
    """min_seed_len 15 is below the kmer seeder's guarantee: the port
    builds the FM seeder (no kmer table) and its records equal the host
    oracle's (primary position, strand and score) on a few reads."""
    idx, opt = run["idx"], AlignOptions(min_seed_len=15)
    al = Aligner.build(idx, opt, device="cpu")
    assert al.kmer is None and al.jump.depth == 8
    reads = run["reads"][:10] + run["reads"][-5:]
    res = al.align_batch(pack_reads(reads))
    for i, r in enumerate(reads):
        q = np.frombuffer(r.encode(), np.uint8)
        q = np.select([q == ord(c) for c in "ACGT"], range(4), 4)
        want = O.align_read(idx, opt, q.astype(np.uint8), rand_id=i,
                            min_score=opt.min_score, all_hits=True)
        prim = next((a for a in want if not a.flag & 0x100), None)
        hit = res[i].hits[0] if res[i].hits else None
        if prim is None:
            assert hit is None, i
        else:
            assert (hit.ref_begin, hit.is_reverse, hit.score) == (
                prim.pos, bool(prim.is_rev), prim.score), i


def test_leg_functions_on_the_cpu(run):
    """The card legs' batch run, stage clock and host check, on the CPU:
    the clock sees the FM machine (its slowest lane's steps) and every
    stage, reads at truth are counted, and the host oracle agrees on every
    read counted off truth (two are moved off it by shifting their
    recorded origin)."""
    g = simulate_genome(120_000, seed=61)
    sim, batch = long_leg.simulate(g[:30000], 8, seed=65, read_len=150)
    with long_leg.stage_clock() as clock:
        res = long_leg.run_batch(run["tal"], batch)
    assert set(res["seconds"]) == set(long_leg.STAGES)
    split = clock.split()
    assert split["fm_machine_steps"] > 100 and split["fm_s_per_step"] > 0
    assert {"collect_seeds_device", "resolve_seeds", "chain_seeds",
            "filter_chains", "extend_all"} <= set(split)
    got = long_leg.check(run["tal"], sim, batch, res["cols"])
    assert got["truth"] >= 7 and got["ne_oracle"] == 0
    sim.positions[:2] += 1
    moved = long_leg.check(run["tal"], sim, batch, res["cols"])
    assert moved["off_truth"] == got["off_truth"] + 2
    assert moved["ne_oracle"] == 0
