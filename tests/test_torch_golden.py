"""The port's SAM text equals the golden fixtures (``tests/golden/*.sam``)
byte for byte: ``tools/regen_golden.py``'s three cases (two-reference
exact-match reads, mutated reads with Ns, mutated pairs), rebuilt with
the port's own modules on the CPU. Imports nothing of the JAX package."""

import difflib
import os

import numpy as np
import pytest

from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.sam.emit import emit_sam, emit_sam_pairs
from bioseqdb_tpu_torch.utils.sim import (simulate_genome, simulate_pairs,
                                          simulate_reads)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _assert_golden(name: str, got: str):
    with open(os.path.join(GOLDEN_DIR, name)) as fh:
        want = fh.read()
    if got != want:
        diff = "\n".join(difflib.unified_diff(
            want.splitlines(), got.splitlines(), fromfile=f"golden/{name}",
            tofile="port", lineterm="", n=1))
        raise AssertionError(f"the port's SAM differs from golden {name}:\n"
                             f"{diff[:4000]}")


@pytest.fixture(scope="module")
def mutated():
    """The ``se_mutated`` / ``pe_mutated`` index and its ``Aligner``."""
    g = simulate_genome(120_000, seed=111)
    idx = build_index([("ecoli_t", g)])
    return g, idx, Aligner.build(idx, AlignOptions(), device="cpu")


def test_golden_se_exact():
    g1 = simulate_genome(48_000, seed=101)
    g2 = simulate_genome(21_000, seed=102)
    idx = build_index([("lambda_a", g1), ("lambda_b", g2)])
    sim = simulate_reads(g1, 48, read_len=100, sub_rate=0.0, seed=103)
    res = Aligner.build(idx, AlignOptions(), device="cpu").align_batch(
        pack_reads(sim.reads, sim.names))
    _assert_golden("se_exact.sam", emit_sam(
        res, idx, list(sim.reads), program_args="golden se_exact"))


def test_golden_se_mutated(mutated):
    g, idx, al = mutated
    sim = simulate_reads(g, 64, read_len=150, sub_rate=0.03, seed=112)
    rng = np.random.default_rng(113)
    reads = ["".join("N" if rng.random() < 0.01 else c for c in r)
             for r in sim.reads]
    res = al.align_batch(pack_reads(reads, sim.names))
    _assert_golden("se_mutated.sam", emit_sam(
        res, idx, reads, program_args="golden se_mutated"))


def test_golden_pe_mutated(mutated):
    g, idx, al = mutated
    sr1, sr2, _ = simulate_pairs(g, 32, read_len=100, insert_mean=300.0,
                                 insert_std=30.0, sub_rate=0.02, seed=114)
    pairs = al.align_pairs(pack_reads(sr1.reads, sr1.names),
                           pack_reads(sr2.reads, sr2.names))
    _assert_golden("pe_mutated.sam", emit_sam_pairs(
        pairs, idx, list(sr1.reads), list(sr2.reads),
        program_args="golden pe_mutated"))
