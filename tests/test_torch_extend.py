"""Seed extension: the port's ``extend_all`` region tables equal the JAX
``extend_all`` exactly, from the same seeds, chains and chain filter.
On the CPU the port runs its stages' plain twins (``extend_scan_plain``,
``extend_windows_plain``, ``extend_merge_plain``,
``extend_seedcov_plain``; the CUDA kernels of ``csrc/extend.cu`` are
held to them in ``tests/test_torch_extend_machine.py``).

Reads carry substitutions, indels and clips, repeats and chimeras; a
narrow band forces bwa's band-doubling retries, a small region cap
forces overflow, and the fat retry's 16 regions a read run too."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bioseqdb_tpu.align.options import AlignOptions
from bioseqdb_tpu.cpu.ksw import fill_scmat
from bioseqdb_tpu.index.builder import build_index
from bioseqdb_tpu.io.batch import pack_reads
from bioseqdb_tpu.kernels import fm as jfm
from bioseqdb_tpu.kernels.extend import extend_all as jext
from bioseqdb_tpu.utils.sim import simulate_genome, simulate_reads
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.kernels import chain as tch
from bioseqdb_tpu_torch.kernels.extend import extend_all as text
from bioseqdb_tpu_torch.kernels.seed import collect_seeds_device


def _indel(s, rng):
    p = int(rng.integers(30, 110))
    k = int(rng.integers(2, 14))
    ins = "".join("ACGT"[c] for c in rng.integers(0, 4, k))
    return (s[:p] + s[p + k :]) if rng.random() < 0.5 else (s[:p] + ins + s[p:])


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(51)
    core = simulate_genome(40_000, seed=51)
    rep = simulate_genome(400, seed=52)
    g = core[:9000] + rep + core[9000:25000] + rep + core[25000:]
    idx = build_index([("g", g), ("h", simulate_genome(5_000, seed=53))])
    sim = simulate_reads(g, 40, read_len=160, sub_rate=0.015, seed=54)
    reads = [r[:150] for r in sim.reads[:24]]
    reads += [_indel(r, rng)[:150] for r in sim.reads[24:]]
    reads += [g[9000 + 50 * k : 9150 + 50 * k] for k in range(4)]
    reads += [g[2000:2080] + g[30000:30070], "ACGT" * 10 + g[15000:15110],
              g[idx.l_pac - 2000 - 100 :][:150]]
    batch = pack_reads(reads, [f"r{i}" for i in range(len(reads))])
    codes = np.asarray(batch.codes, np.int32)
    lens = np.asarray(batch.lens, np.int32)
    al = Aligner.build(idx, AlignOptions(), device="cpu")
    t_codes, t_lens = torch.from_numpy(codes), torch.from_numpy(lens)
    m = collect_seeds_device(al.fm, t_codes, t_lens, min_seed_len=19,
                             split_len=28, split_width=10, max_mem_intv=20,
                             max_cand=16, max_mem=16)
    seeds = tch.resolve_seeds(al.fm, m["mems"], m["n_mem"], max_occ=500,
                              max_seeds=64)
    chains = tch.chain_seeds(al.fm, seeds, max_chains=16, bandwidth=100,
                             max_chain_gap=10000)
    flt = tch.filter_chains(chains, seeds, mask_level=0.5,
                            chain_drop_ratio=0.5, min_chain_weight=0,
                            min_seed_len=19, max_chain_gap=10000)
    return idx, al, t_codes, t_lens, seeds, chains, flt


@pytest.mark.parametrize("bandwidth,max_regs",
                         [(100, 8), (8, 8), (100, 1), (100, 16), (8, 2)])
def test_extend_all_equal(setup, bandwidth, max_regs):
    idx, al, codes, lens, seeds, chains, flt = setup
    opt = AlignOptions(bandwidth=bandwidth)
    kw = dict(match_score=opt.match_score,
              mismatch_penalty=opt.mismatch_penalty, o_del=opt.o_del,
              e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins,
              bandwidth=bandwidth, zdrop=opt.zdrop, pen_clip5=opt.pen_clip5,
              pen_clip3=opt.pen_clip3, max_regs=max_regs)
    mat = fill_scmat(opt.match_score, opt.mismatch_penalty)
    J = lambda d: {k: jnp.asarray(v.numpy()) for k, v in d.items()}
    ref = jax.device_get(jext(
        jfm.FMDevice.from_host(idx), jnp.asarray(al.pac_rows.numpy()),
        jnp.asarray(codes.numpy()), jnp.asarray(lens.numpy()), J(seeds),
        J(chains), J(flt), jnp.asarray(mat), **kw))
    got = text(al.fm, al.pac_rows, codes, lens, seeds, chains, flt,
               torch.from_numpy(mat), **kw)
    for k in ("n_regs", "overflow"):
        assert np.array_equal(np.asarray(ref[k]), got[k].numpy()), k
    for k, v in ref["regs"].items():
        assert np.array_equal(np.asarray(v), got["regs"][k].numpy()), k
    if max_regs == 1:
        assert ref["overflow"].any()
    if bandwidth == 8:   # band-doubling retries widened some regions
        assert (np.asarray(ref["regs"]["w"]) == 16).any()
