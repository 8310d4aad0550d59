"""Seed resolution, chaining, chain filter and l_rep: the port equals the
JAX kernels exactly, stage by stage, on the same inputs.

Inputs are the port's own seeding outputs (pinned to JAX by
test_torch_seed.py): FM-machine rank intervals, and the kmer path's
mixed position/rank rows. Each stage gets the JAX output of the stage
before it, so a difference points at one stage."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bioseqdb_tpu.align.options import AlignOptions
from bioseqdb_tpu.index.builder import build_index
from bioseqdb_tpu.io.batch import pack_reads
from bioseqdb_tpu.kernels import chain as jch
from bioseqdb_tpu.kernels import fm as jfm
from bioseqdb_tpu.utils.sim import simulate_genome, simulate_reads
from bioseqdb_tpu_torch.align.pipeline import Aligner, full_align_step, unpack_codes, pack_codes_2bit
from bioseqdb_tpu_torch.kernels import chain as tch
from bioseqdb_tpu_torch.kernels.seed import collect_seeds_device

OPT = AlignOptions()


def _edit(s, rng):
    """An indel or a clip: delete, insert or replace a run of bases."""
    p = int(rng.integers(20, len(s) - 30))
    k = int(rng.integers(1, 12))
    ins = "".join("ACGT"[c] for c in rng.integers(0, 4, k))
    return [s[:p] + s[p + k :], s[:p] + ins + s[p:], s[:p] + ins + s[p + k :]
            ][int(rng.integers(0, 3))][:150]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(41)
    core = simulate_genome(50_000, seed=41)
    rep = simulate_genome(500, seed=42)
    g = core[:12000] + rep + core[12000:30000] + rep + core[30000:]
    idx = build_index([("g", g), ("h", simulate_genome(6_000, seed=43))])
    sim = simulate_reads(g, 60, read_len=150, sub_rate=0.02, seed=44)
    reads = list(sim.reads[:48]) + [_edit(r, rng) for r in sim.reads[48:]]
    reads += [g[12000 + 60 * k : 12150 + 60 * k] for k in range(6)]
    reads += [g[7000:7075] + g[40000:40075], g[30050:30130] + "N" * 4
              + g[100:166]]
    batch = pack_reads(reads, [f"r{i}" for i in range(len(reads))])
    al = Aligner.build(idx, OPT, device="cpu")
    u2, nmb = pack_codes_2bit(batch.codes)
    codes = unpack_codes(torch.from_numpy(u2), torch.from_numpy(nmb))
    lens = torch.from_numpy(np.asarray(batch.lens, np.int32))
    common, _ = al._step_kwargs(codes.shape[1], keep_mems=True)
    kout = full_align_step(al.fm, al.pac_rows, codes, lens, al._mat(), **common)
    fout = collect_seeds_device(al.fm, codes, lens, min_seed_len=19,
                                split_len=28, split_width=10, max_mem_intv=20,
                                max_cand=16, max_mem=16)
    mems = dict(kmer=(kout["mems"], kout["n_mem"]),
                fm=(fout["mems"], fout["n_mem"]))
    return idx, jfm.FMDevice.from_host(idx), al.fm, mems


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _eq(ref, got, keys=None):
    for k in keys or ref:
        assert np.array_equal(np.asarray(ref[k]), got[k].numpy()), k


@pytest.mark.parametrize("src,max_occ,cap", [
    ("kmer", 500, 4096), ("fm", 500, 64), ("fm", 500, 0), ("fm", 2, 0)])
def test_resolve_chain_filter_equal(setup, src, max_occ, cap):
    idx, jf, tf, mems = setup
    m, n = mems[src]
    jm, jn = jnp.asarray(m.numpy()), jnp.asarray(n.numpy())
    seeds_j = _np(jax.device_get(jch.resolve_seeds(
        jf, jm, jn, max_occ=max_occ, max_seeds=64, sa_interval=idx.sa_interval,
        compact_cap=cap)))
    seeds_t = tch.resolve_seeds(tf, m, n, max_occ=max_occ, max_seeds=64,
                                sa_interval=idx.sa_interval, compact_cap=cap)
    if cap == 64:
        # the compaction cap bites. The JAX scatter gives the last kept
        # lane's slot to the last valid lane, so its position reads 0
        # there; only overflowing reads hold truncated lanes, so compare
        # the rest of the reads and the overflow mask
        ovf = seeds_j["overflow"]
        assert ovf.any() and np.array_equal(ovf, seeds_t["overflow"].numpy())
        for k, v in seeds_j.items():
            assert np.array_equal(v[~ovf], seeds_t[k].numpy()[~ovf]), k
        seeds_j = {k: seeds_t[k].numpy() for k in seeds_j}
    _eq(seeds_j, seeds_t)
    to_t = lambda d: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    ckw = dict(max_chains=16, bandwidth=OPT.bandwidth,
               max_chain_gap=OPT.max_chain_gap)
    chains_j = _np(jax.device_get(jch.chain_seeds(
        jf, {k: jnp.asarray(v) for k, v in seeds_j.items()}, **ckw)))
    chains_t = tch.chain_seeds(tf, to_t(seeds_j), **ckw)
    _eq(chains_j, chains_t)
    fkw = dict(mask_level=OPT.mask_level, chain_drop_ratio=OPT.chain_drop_ratio,
               min_chain_weight=OPT.min_chain_weight,
               min_seed_len=OPT.min_seed_len, max_chain_gap=OPT.max_chain_gap)
    flt_j = _np(jax.device_get(jch.filter_chains(
        {k: jnp.asarray(v) for k, v in chains_j.items()},
        {k: jnp.asarray(v) for k, v in seeds_j.items()}, **fkw)))
    flt_t = tch.filter_chains(to_t(chains_j), to_t(seeds_j), **fkw)
    _eq(flt_j, flt_t)
    if cap != 64:
        assert (chains_j["n"] > 1).any()
    if src == "fm" and cap == 0:   # repeat reads: overlapped chains kept
        assert (flt_j["kept"] == 2).any()


@pytest.mark.parametrize("max_occ", [1, 500])
def test_l_rep_equal(setup, max_occ):
    _, _, _, mems = setup
    for m, n in mems.values():
        ref = np.asarray(jch.l_rep_device(jnp.asarray(m.numpy()),
                                          jnp.asarray(n.numpy()), max_occ))
        assert np.array_equal(ref, tch.l_rep_device(m, n, max_occ).numpy())
