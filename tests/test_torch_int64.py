"""int64 ranks: the port equals the JAX package under x64, exactly.

Indexes of 2^31 or more doubled bases take int64 ranks. Both packages
can be made to take them on a small index: the JAX side builds
``FMDevice.from_host(idx, rank_dtype=jnp.int64)`` under
``jax.enable_x64()`` (as ``tests/test_full_pipeline.py`` does), the port
``FMDevice.from_host(idx, "cpu", rank_dtype=torch.int64)``, and each
``Aligner`` gets that FMDevice (with its round-3 jump table) in place of
the int32 one. On a 48.6 kb genome with 16 reads (simulated reads, reads
inside an exact repeat, Ns and junk), the FM queries, the FM machine with
the jump, the full device step (FM- and kmer-seeded) and exact mode's
records must equal the JAX package's element for element, and the int32
port's values. The auto choice (int64 from 2^31 doubled bases, the jump
at any depth under int64, a candidate stack of 24 past 2^31) is checked
on a stand-in index whose ``seq_len`` is set past 2^31, with no tables
uploaded. Integer programs: tolerance 0."""

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioseqdb_tpu.align.options import AlignOptions as JAlignOptions
from bioseqdb_tpu.align.pipeline import Aligner as JAligner
from bioseqdb_tpu.index.builder import build_index
from bioseqdb_tpu.io.batch import pack_reads as jpack_reads
from bioseqdb_tpu.kernels import fm as jfm
from bioseqdb_tpu.kernels import seed as jseed
from bioseqdb_tpu.utils.sim import simulate_genome, simulate_reads
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.index import layout
from bioseqdb_tpu_torch.index.convert import fmindex_from_jax
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import fm as tfm
from bioseqdb_tpu_torch.kernels import seed as tseed

I64 = torch.int64
SEED_KW = dict(min_seed_len=19, split_len=28, split_width=10, max_mem_intv=20,
               max_cand=16, max_mem=16)


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def run():
    """Both packages' int64 results, computed once: the JAX side inside
    one ``enable_x64`` block."""
    core = simulate_genome(40_000, seed=71)
    rep = simulate_genome(300, seed=72)
    g = core[:15000] + rep + core[15000:30000] + rep + core[30000:]
    idx = build_index([("chrA", g), ("chrB", simulate_genome(8_000, seed=73))])
    tidx = fmindex_from_jax(idx)
    sim = simulate_reads(g, 12, read_len=150, sub_rate=0.02, seed=74)
    p = g.find(rep)
    reads = list(sim.reads) + [
        g[p + 100 : p + 250], g[p - 50 : p + 100],        # the exact repeat
        sim.reads[0][:60] + "N" + sim.reads[0][61:],
        "".join(np.random.default_rng(75).choice(list("ACGT"), 150)),
    ]
    names = [f"r{i}" for i in range(len(reads))]
    jbatch, batch = jpack_reads(reads, names), pack_reads(reads, names)
    rng = np.random.default_rng(76)
    ranks = rng.integers(0, idx.seq_len + 1, 256)
    ranks[:3] = [0, idx.primary, idx.seq_len]
    codes = np.asarray(batch.codes, np.int32)
    lens = np.asarray(batch.lens, np.int32)
    jal, jout = {}, {}
    with jax.enable_x64():
        fm64 = jfm.FMDevice.from_host(idx, rank_dtype=jnp.int64)
        jr = jnp.asarray(ranks, jnp.int64)
        jq = dict(bs=jfm.backward_search(fm64, jnp.asarray(codes),
                                         jnp.asarray(lens)),
                  sa=jax.jit(jfm.sa_resolve, static_argnums=2)(
                      fm64, jr, idx.sa_interval),
                  lf=jax.jit(jfm.lf_step)(fm64, jr))
        fmx, table = jseed.build_seed_table(fm64, idx)
        # the static arguments of the FM-seeded step's own call, so the
        # step below reuses this compiled machine
        jseeds = jseed.collect_seeds_device(
            fmx, jnp.asarray(codes), jnp.asarray(lens),
            jump_base=table.jump_base, jump_depth=table.jump_depth,
            sa_interval=idx.sa_interval, kcand=1, **SEED_KW)
        for seeder in ("fm", "kmer"):
            # stage by stage (the JAX package's BST_NO_ONEJIT): both
            # seeders' steps share the later stages' compiled programs
            with _env(BST_SEEDER=seeder, BST_NO_ONEJIT="1"):
                al = JAligner.build(idx, JAlignOptions(), mode="full")
                jal[seeder] = dataclasses.replace(al, fm=fmx, table=table)
                jout[seeder] = jax.device_get(
                    jal[seeder].device_regions(jbatch))
        jex = dataclasses.replace(
            JAligner.build(idx, JAlignOptions(), mode="exact"), fm=fm64
        ).align_batch(jbatch)
        jq, jseeds = jax.device_get((jq, jseeds))
    return dict(idx=idx, tidx=tidx, batch=batch, codes=codes, lens=lens,
                ranks=ranks, jq=jq, jseeds=jseeds, jump_depth=table.jump_depth,
                jout=jout, jex=jex, jal=jal,
                fm64=tfm.FMDevice.from_host(tidx, "cpu", rank_dtype=I64),
                fm32=tfm.FMDevice.from_host(tidx, "cpu"))


def _eq(want, got, dtype=I64):
    assert got.dtype == dtype
    assert np.array_equal(np.asarray(want), got.numpy())


def test_fm_tables_int64(run):
    fm64, fm32 = run["fm64"], run["fm32"]
    assert fm64.rank_dtype == I64 and fm32.rank_dtype == torch.int32
    for f in ("L2", "sa_sample", "occ_majors", "sa_majors", "ref_offsets",
              "ref_lens"):
        assert getattr(fm64, f).dtype == I64, f
        assert torch.equal(getattr(fm64, f), getattr(fm32, f).to(I64)), f
    for f in ("blocks", "sa_cnt", "sa_words", "occ_rows"):   # stay int32
        assert torch.equal(getattr(fm64, f), getattr(fm32, f)), f
    with pytest.raises(ValueError):
        layout.fm_tables(run["tidx"], torch.int16)


def test_fm_queries_equal_jax(run):
    fm64, jq = run["fm64"], run["jq"]
    r = torch.from_numpy(run["ranks"])
    lo, hi = tfm.backward_search(fm64, torch.from_numpy(run["codes"]),
                                 torch.from_numpy(run["lens"]))
    _eq(jq["bs"][0], lo)
    _eq(jq["bs"][1], hi)
    assert (hi - lo).gt(0).sum() >= 3    # the exact reads
    sa = tfm.sa_resolve(fm64, r, run["idx"].sa_interval)
    _eq(jq["sa"], sa)
    _eq(jq["lf"], tfm.lf_step(fm64, r))
    # and the int32 port's values
    assert torch.equal(sa, tfm.sa_resolve(run["fm32"], r.to(torch.int32),
                                          run["idx"].sa_interval).to(I64))


def test_seed_machine_with_jump_equal_jax(run):
    fm64 = run["fm64"]
    jump = tseed.build_r3_jump(fm64)
    assert jump.table.dtype == I64
    assert jump.depth == run["jump_depth"] == 8
    got = tseed.collect_seeds_device(
        fm64, torch.from_numpy(run["codes"]), torch.from_numpy(run["lens"]),
        jump=jump, **SEED_KW)
    want = run["jseeds"]
    assert got["mems"].dtype == I64 and want["mems"].dtype == np.int64
    for k in ("mems", "n_mem", "overflow", "iters", "it_r1", "it_r2"):
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k
    assert (got["n_mem"] > 0).sum() >= 12


@pytest.mark.parametrize("seeder", ["fm", "kmer"])
def test_full_align_step_equal_jax(run, seeder):
    fm64 = run["fm64"]
    al = Aligner.build(run["tidx"], AlignOptions(), device="cpu",
                       seeder=seeder)
    al64 = dataclasses.replace(al, fm=fm64, jump=tseed.build_r3_jump(fm64))
    assert (al.kmer is not None) == (seeder == "kmer")
    assert run["jal"][seeder].fm.rank_dtype == jnp.int64
    got, want = al64.device_regions(run["batch"]), run["jout"][seeder]
    assert set(got) == set(want) and set(got["regs"]) == set(want["regs"])
    assert got["regs"]["rb"].dtype == got["regs"]["re"].dtype == np.int64
    for k in ("n_regs", "overflow", "l_rep", "off"):
        a, b = np.asarray(want[k]), got[k]
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k, v in want["regs"].items():
        a, b = np.asarray(v), got["regs"][k]
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    # the int32 step's regions, the same values
    got32 = al.device_regions(run["batch"])
    for k, v in got32["regs"].items():
        assert np.array_equal(v, got["regs"][k]), k
    assert np.array_equal(got32["n_regs"], got["n_regs"])
    assert (got["n_regs"][: run["batch"].n] > 0).sum() >= 13


def test_exact_records_equal_jax(run):
    al = Aligner.build(run["tidx"], AlignOptions(), device="cpu",
                       mode="exact")
    got = dataclasses.replace(al, fm=run["fm64"]).align_batch(run["batch"])
    want = run["jex"]
    assert ([dataclasses.asdict(r) for r in got]
            == [dataclasses.asdict(r) for r in want])
    assert ([dataclasses.asdict(r) for r in got]
            == [dataclasses.asdict(r) for r in al.align_batch(run["batch"])])
    assert sum(len(r.hits) > 0 for r in got) >= 2


def _jax_gate(n_blocks: int, rank_dtype) -> int:
    """The JAX package's ``build_r3_jump`` depth rules for ``n_blocks``
    Occ blocks, called piecewise (its own functions, without tables)."""
    base = -(-n_blocks // jfm.MAJOR_BLOCKS) * jfm.MAJOR_BLOCKS
    d = jseed._pick_jump_depth(n_blocks, base)
    if (d and rank_dtype == jnp.int32
            and (base + 2 * 4 ** d) * jfm.OCC_BLOCK + 2 >= 2**31):
        return 0
    return d


def test_auto_choice_past_2_31(run):
    """A stand-in index with ``seq_len`` past 2^31: int64 chosen by
    itself, the jump taken, and a candidate stack of 24, as the JAX
    package decides; none at 2^31 - 2."""
    tidx = run["tidx"]
    for seq_len, rdt, cand in (((1 << 31) - 2, torch.int32, 0),
                               ((1 << 31) - 1, I64, 0),
                               (2_200_000_000, I64, 24)):
        big = dataclasses.replace(tidx, seq_len=seq_len)
        assert layout.rank_dtype_for(big) == rdt
        t = layout.fm_tables(big)
        assert t["sa_sample"].dtype == t["seq_len"].dtype == np.dtype(
            {torch.int32: np.int32, I64: np.int64}[rdt])
        assert t["blocks"].dtype == np.int32
        al = Aligner(index=big, options=AlignOptions(),
                     device=torch.device("cpu"), fm=None, pac_rows=None,
                     kmer=None, jump=None)
        jbig = dataclasses.replace(run["idx"], seq_len=seq_len)
        jal = JAligner(index=jbig, options=JAlignOptions(), fm=None)
        assert al._step_kwargs(152)[0]["max_cand"] == cand
        assert jal._step_kwargs(152)[0]["max_cand"] == cand
    # the jump gate: a 2.2 G doubled-base Occ table (the by-hand leg's),
    # and one where the jump rows would pass 2^31 under int32
    for n in (2_200_000_000 // 128 + 1, (2**31 - 8_000_000) // 128):
        n8 = -(-n // 8) * 8
        for tdt, jdt in ((torch.int32, jnp.int32), (I64, jnp.int64)):
            assert tseed.jump_depth(n8, rank_dtype=tdt) == _jax_gate(n8, jdt)
        assert tseed.jump_depth(n8, rank_dtype=torch.int32) == 0
        assert tseed.jump_depth(n8, rank_dtype=I64) == 8
