"""The paired-end slice: port == JAX package, exactly.

One batch of FR pairs (150 bp, inserts 400 +- 40, 1% substitutions) goes
through the port's ``Aligner`` (torch on the CPU, plain kernels) and the
JAX ``Aligner``: the fused two-mate step ``device_regions_pair``, the
pair overflow retry ``absorb_overflow_pair``, and the PE finalize (rows
of records with ``PEInfo``, and the columns with their SAM text). The
mates' batches have different widths (R1 packed at 150, R2 at 152), and
every fourth R2 is trimmed to 120 bp. Besides the simulated pairs: a
split R1 (two far loci), a mate mutated at every 12th base that only
mate rescue can place, an all-N mate, and pairs inside a repeat that
overflow the kmer fast path, so the retry has rows from both mates.

Both pair retries seed with the FM machine and its round-3 jump table,
and the port's machine takes the JAX machine's steps, so the retried
tables and overflow masks are compared whole; the records and SAM text
must be equal everywhere. Integer programs: tolerance 0."""

import dataclasses

import jax
import numpy as np
import pytest

from bioseqdb_tpu.align.finalize import maybe_unpack as jmaybe_unpack
from bioseqdb_tpu.align.options import AlignOptions as JAlignOptions
from bioseqdb_tpu.align.paired import finalize_pairs as jfinalize_pairs
from bioseqdb_tpu.align.paired import \
    finalize_pairs_columns as jfinalize_pairs_columns
from bioseqdb_tpu.align.pipeline import Aligner as JAligner
from bioseqdb_tpu.index.builder import build_index
from bioseqdb_tpu.io.batch import pack_reads as jpack_reads
from bioseqdb_tpu.sam.emit import emit_sam_pair_columns as jemit_pair_columns
from bioseqdb_tpu.utils.sim import simulate_genome, simulate_pairs
from bioseqdb_tpu_torch.align.finalize import maybe_unpack
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.index.convert import fmindex_from_jax
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.sam.emit import emit_sam_pair_columns, emit_sam_pairs
from bioseqdb_tpu_torch.tools import pe_leg

N_SIM = 48
SPLIT, RESCUE, ALL_N = N_SIM, N_SIM + 1, N_SIM + 2   # the special pairs
INSERT = 400


def _rc(s: str) -> str:
    return s.translate(str.maketrans("ACGTN", "TGCAN"))[::-1]


def _reads():
    core = simulate_genome(130_000, seed=81)
    rep = simulate_genome(600, seed=82)
    g = core[:30000] + rep + core[30000:80000] + rep + core[80000:]
    refs = [("chrA", g), ("chrB", simulate_genome(20_000, seed=83))]
    sr1, sr2, _ = simulate_pairs(g, N_SIM, read_len=150, insert_mean=INSERT,
                                 insert_std=40, sub_rate=0.01, seed=84)
    reads1, reads2 = list(sr1.reads), list(sr2.reads)
    for i in range(0, N_SIM, 4):
        reads2[i] = reads2[i][:120]
    mate = lambda p: _rc(g[p + INSERT - 150 : p + INSERT])
    # a split R1: its two halves from far loci; its mate pairs with the first
    reads1.append(g[5000:5075] + g[90000:90075])
    reads2.append(mate(5000))
    # a mate mutated at every 12th base: no seed of 19 bp survives, local
    # SW inside the insert window still places it
    bad = list(mate(60000))
    for k in range(0, 150, 12):
        bad[k] = {"A": "C", "C": "G", "G": "T", "T": "A"}[bad[k]]
    reads1.append(g[60000:60150])
    reads2.append("".join(bad))
    reads1.append(g[100000:100150])
    reads2.append("N" * 150)
    for k in range(4):            # both mates inside the repeat
        reads1.append(g[30000 + 60 * k : 30150 + 60 * k])
        reads2.append(_rc(g[30200 + 60 * k : 30350 + 60 * k]))
    names = [f"p{i}" for i in range(len(reads1))]
    return refs, reads1, reads2, names, 60000 + INSERT - 150


@pytest.fixture(scope="module")
def run():
    refs, reads1, reads2, names, rescue_pos = _reads()
    idx = build_index(refs)
    jb = (jpack_reads(reads1, names, pad_width_to=1),
          jpack_reads(reads2, names, pad_width_to=8))
    jal = JAligner.build(idx, JAlignOptions(), mode="full")
    j_out = jax.device_get(jal.device_regions_pair(*jb))
    j_abs = jal.absorb_overflow_pair(jb[0], j_out[0], jb[1], j_out[1])
    j_args = (idx, jal.options, jb[0], j_abs[0], jb[1], j_abs[1])
    j_cols = jfinalize_pairs_columns(*j_args)
    j_pairs = jfinalize_pairs(*j_args)

    tidx, opt = fmindex_from_jax(idx), AlignOptions()
    tb = (pack_reads(reads1, names, pad_width_to=1),
          pack_reads(reads2, names, pad_width_to=8))
    tal = Aligner.build(tidx, opt, device="cpu")
    # keep what the entry point's two device stages returned
    seen = {}
    step, absorb = tal.device_regions_pair, tal.absorb_overflow_pair

    def step_kept(*a):
        seen["out"] = step(*a)
        return seen["out"]

    def absorb_kept(*a):
        seen["abs"] = absorb(*a)
        return seen["abs"]

    tal.device_regions_pair, tal.absorb_overflow_pair = step_kept, absorb_kept
    t_cols = tal.align_pairs_columns(*tb)
    del tal.device_regions_pair, tal.absorb_overflow_pair
    t_pairs = tal.align_pairs(*tb)
    sam = dict(
        jax=jemit_pair_columns(*j_cols, idx, *jb, header=False),
        torch=emit_sam_pair_columns(*t_cols, tidx, *tb, header=False))
    return dict(g=refs[0][1], idx=tidx, tal=tal, batches=tb,
                reads=(reads1, reads2), rescue_pos=rescue_pos,
                out=(j_out, seen["out"]), abs=(j_abs, seen["abs"]),
                cols=(j_cols, t_cols), pairs=(j_pairs, t_pairs), sam=sam)


def test_mates_have_different_widths(run):
    b1, b2 = run["batches"]
    assert b1.width == 150 and b2.width == 152
    assert min(b2.lens[: b2.n]) == 120


@pytest.mark.parametrize("mate", [0, 1])
def test_fused_wire_dicts_equal_jax(run, mate):
    j, t = run["out"][0][mate], run["out"][1][mate]
    n = run["batches"][mate].n
    assert set(t) == set(j) and set(t["regs"]) == set(j["regs"])
    for k in ("n_regs", "overflow", "l_rep", "off"):
        a, b = np.asarray(j[k]), t[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
    for k, v in j["regs"].items():
        a, b = np.asarray(v), t["regs"][k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
    ovf = np.asarray(j["overflow"])
    assert np.array_equal(ovf, t["overflow"])
    # the repeat pairs overflow the kmer fast path
    assert ovf[:n].sum() >= 2
    keep = ~ovf
    jd, td = jmaybe_unpack(j), maybe_unpack(t)
    for k in ("n_regs", "l_rep"):
        assert np.array_equal(np.asarray(jd[k])[keep], td[k][keep]), k
    for k, v in jd["regs"].items():
        assert np.array_equal(np.asarray(v)[keep], td["regs"][k][keep]), k


@pytest.mark.parametrize("mate", [0, 1])
def test_absorb_overflow_pair_equal_jax(run, mate):
    j, t = run["abs"][0][mate], run["abs"][1][mate]
    n = run["batches"][mate].n
    for k in ("n_regs", "overflow", "l_rep"):
        assert np.array_equal(np.asarray(j[k]), t[k]), k
    for k, v in j["regs"].items():
        assert np.array_equal(np.asarray(v), t["regs"][k]), k
    # the one fat retry resolved overflow rows of this mate
    assert t["overflow"][:n].sum() < np.asarray(
        run["out"][1][mate]["overflow"])[:n].sum()


_PE_COLUMNS = ("pe_flag", "pnext", "tlen", "rnext_rid", "mapq", "pos",
               "is_rev", "mapped", "rid", "nm", "score", "sub", "qb", "qe",
               "ref_end", "fast", "cig_len", "md_len")


@pytest.mark.parametrize("mate", [0, 1])
def test_pair_columns_equal_jax(run, mate):
    cj, ct = run["cols"][0][mate], run["cols"][1][mate]
    assert cj.n == ct.n
    for f in _PE_COLUMNS:
        a, b = getattr(cj, f), getattr(ct, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert [(cj.cigar(i), cj.md(i)) for i in range(cj.n)] \
        == [(ct.cigar(i), ct.md(i)) for i in range(ct.n)]
    assert sorted(cj.extra) == sorted(ct.extra)
    assert cj.fast.any() and cj.extra          # both finalize paths ran


def test_pair_sam_equal_jax(run):
    assert run["sam"]["torch"] == run["sam"]["jax"]
    assert run["sam"]["torch"].count("\n") >= 2 * len(run["reads"][0])


def test_align_pairs_equal_jax(run):
    # asdict recurses into every hit and into the PEInfo of the end and
    # of each supplementary hit
    j_pairs, t_pairs = run["pairs"]
    assert len(t_pairs) == len(j_pairs) == len(run["reads"][0])
    for (j1, j2), (t1, t2) in zip(j_pairs, t_pairs):
        assert dataclasses.asdict(t1) == dataclasses.asdict(j1)
        assert dataclasses.asdict(t2) == dataclasses.asdict(j2)
    proper = sum(bool(t1.pe.flag_extra & 0x2) for t1, _ in t_pairs)
    assert proper >= 40


def test_mate_rescue(run):
    res1, res2 = run["pairs"][1][RESCUE]
    assert res1.mapped and res2.mapped
    assert abs(res2.primary.ref_begin - run["rescue_pos"]) <= 6
    assert res2.primary.is_reverse
    assert res2.pe.flag_extra & 0x2
    _, res_n = run["pairs"][1][ALL_N]
    assert not res_n.mapped


def test_split_r1_supplementary(run):
    res1, _ = run["pairs"][1][SPLIT]
    prims = [h for h in res1.hits if not h.is_secondary]
    assert len(prims) == 2 and prims[1].is_supplementary
    assert prims[1].pe is not None
    reads1, reads2 = run["reads"]
    sam = emit_sam_pairs(run["pairs"][1], run["idx"], reads1, reads2,
                         header=False)
    lines = [l.split("\t") for l in sam.splitlines()
             if l.startswith(f"p{SPLIT}\t")]
    supp = [l for l in lines if int(l[1]) & 0x800]
    assert len(lines) == 3 and len(supp) == 1
    assert int(supp[0][1]) & 0x41 == 0x41       # paired, first in pair
    assert any(t.startswith("SA:Z:") for t in supp[0][11:])


def test_fused_step_equals_separate_steps(run):
    tal, (b1, b2) = run["tal"], run["batches"]
    for fused, sep in zip(run["out"][1], (tal.device_regions(b1),
                                          tal.device_regions(b2))):
        assert set(fused) == set(sep)
        for k in ("n_regs", "overflow", "l_rep", "off"):
            assert np.array_equal(fused[k], sep[k]), k
        for k, v in sep["regs"].items():
            assert fused["regs"][k].dtype == v.dtype
            assert np.array_equal(fused["regs"][k], v), k


def test_mate_batches_of_unequal_rows_raise(run):
    tal, (b1, _) = run["tal"], run["batches"]
    with pytest.raises(ValueError):
        tal.device_regions_pair(b1, pack_reads(run["reads"][1][:9]))


def test_pe_leg_checks_against_the_host(run):
    """The card leg's batch run and its checks, on the CPU: truth counts,
    and the host's slow PE path agrees on every pair counted off truth
    (three pairs are moved off it by shifting their recorded origin)."""
    pb = pe_leg.simulate(run["g"], 24, seed=85)
    res = pe_leg.run_batch(run["tal"], pb)
    assert set(res["seconds"]) == set(pe_leg.STAGES)
    got = pe_leg.check(run["tal"], pb, res)
    assert got["r1_truth"] >= 22 and got["r2_truth"] >= 22
    assert got["proper"] >= 22 and got["pe_ne_oracle"] == 0
    for k in range(3):
        pb.sims[k % 2].positions[k] += 1
    moved = pe_leg.check(run["tal"], pb, res)
    assert moved["off_truth_pairs"] == got["off_truth_pairs"] + 3
    assert moved["pe_ne_oracle"] == 0
