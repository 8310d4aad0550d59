"""Seeding: the port's kmer seeder and FM state machine equal the JAX
kernels exactly, on reads that exercise every round and fallback.

The genome carries exact and diverged repeats (round-2 reseeds, capped
buckets, multi-occurrence seeds); the reads mix simulated reads,
ambiguous bases, junk, chimeras and short reads. Both FM-machine entries
are compared field by field, ``iters`` included: the port counts the
JAX machine's fetch-sharing stalls and takes its round-3 jump in one
step as the JAX machine does (on a ``build_seed_table``-extended index,
at the auto-picked depth 8 and a forced depth 6), so the overflow masks
agree too (a small ``max_iters`` forces budget overflows)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bioseqdb_tpu.index.builder import build_index
from bioseqdb_tpu.io.batch import pack_reads
from bioseqdb_tpu.kernels import fm as jfm
from bioseqdb_tpu.kernels import kmer as jkm
from bioseqdb_tpu.kernels import seed as jseed
from bioseqdb_tpu.kernels.seed import collect_seeds_device as jseeds
from bioseqdb_tpu.utils.sim import simulate_genome, simulate_reads
from bioseqdb_tpu_torch.index import layout
from bioseqdb_tpu_torch.kernels import fm as tfm
from bioseqdb_tpu_torch.kernels.kmer import collect_seeds_kmer
from bioseqdb_tpu_torch.kernels import seed as tseed
from bioseqdb_tpu_torch.kernels.seed import collect_seeds_device as tseeds

MSL, SPLIT_LEN, SPLIT_W, MAX_INTV = 19, 28, 10, 20
W = 152


def _mutate(s, rng, rate):
    b = np.frombuffer(s.encode(), np.uint8).copy()
    m = rng.random(b.size) < rate
    b[m] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, m.sum())]
    return b.tobytes().decode()


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(31)
    core = simulate_genome(60_000, seed=31)
    # a 24-base segment repeated once: a round-2 reseed between the
    # round-3 checkpoints (the kmer seeder's needs_r2 lanes)
    core = core[:50000] + core[20000:20024] + core[50024:]
    rep = simulate_genome(700, seed=32)
    g = (core[:15000] + rep + core[15000:30000] + _mutate(rep, rng, 0.03)
         + core[30000:45000] + rep + core[45000:])
    idx = build_index([("g", g)])
    sim = simulate_reads(g, 40, read_len=150, sub_rate=0.02, seed=33)
    reads = list(sim.reads)
    seg = g.find(core[20000:20024])
    for k in range(4):   # reads holding the short repeat mid-read
        p = g.find(core[20000:20024], seg + 1 if k % 2 else 0) - 62 - 4 * k
        reads.append(g[p : p + 150])
    for k in range(6):   # reads across the repeat copies
        p = 15000 - 40 + 250 * k
        reads.append(g[p : p + 150])
    for k in range(4):   # ambiguous bases
        r = list(reads[k])
        for j in rng.integers(0, 150, 3 + k):
            r[j] = "N"
        reads.append("".join(r))
    reads += ["".join("ACGT"[c] for c in rng.integers(0, 4, 150))
              for _ in range(3)]                                  # junk
    reads += [g[5000:5075] + g[40000:40075], g[100:130], "ACGTN" * 30]
    # Ns a few bases into round-3 windows: the depth-J jump must not
    # take a window that holds one
    r = list(sim.reads[5])
    for j in range(3, 150, 23):
        r[j] = "N"
    reads.append("".join(r))
    batch = pack_reads(reads, [f"r{i}" for i in range(len(reads))])
    codes = np.full((batch.codes.shape[0], W), 4, np.int32)
    n = min(W, batch.codes.shape[1])
    codes[:, :n] = batch.codes[:, :n]
    lens = np.asarray(batch.lens, np.int32)
    return idx, codes, lens


def _kmer_both(idx, codes, lens):
    t = layout.tables_from_host(idx)
    meta = t["kmer_meta"]
    nmz = layout.nmz_for(W)
    kw = dict(bb=meta.bb, min_seed_len=MSL, split_len=SPLIT_LEN,
              split_width=SPLIT_W, max_mem_intv=MAX_INTV,
              smax=layout.smax_for(MAX_INTV), dmax=layout.dmax_for(meta, nmz),
              nmz=nmz, max_mem=16)
    kt = jkm.KmerTable(bmeta=jnp.asarray(t["bmeta"]),
                       entries=jnp.asarray(t["entries"]))
    ref = jax.device_get(jkm.collect_seeds_kmer(
        kt, jnp.asarray(t["pac_rows"]), idx.seq_len, jnp.asarray(codes),
        jnp.asarray(lens), **kw))
    got = collect_seeds_kmer(
        torch.from_numpy(t["bmeta"]), torch.from_numpy(t["entries"]),
        torch.from_numpy(t["pac_rows"]), idx.seq_len, torch.from_numpy(codes),
        torch.from_numpy(lens), **kw)
    return ref, got


def test_kmer_seeder_equal(setup):
    idx, codes, lens = setup
    ref, got = _kmer_both(idx, codes, lens)
    for k in ("mem_pos", "mem_s", "mem_b", "mem_e", "n_mem", "needs_r2",
              "overflow", "why"):
        assert np.array_equal(np.asarray(ref[k]), got[k].numpy()), k
    # the case mix reaches the fast path, the reseed leg and a fallback
    assert ref["needs_r2"].any() and ref["overflow"].any()
    assert (~ref["overflow"]).sum() > 30


@pytest.mark.parametrize("max_iters", [0, 300])
def test_fm_machine_full_equal(setup, max_iters):
    idx, codes, lens = setup
    kw = dict(min_seed_len=MSL, split_len=SPLIT_LEN, split_width=SPLIT_W,
              max_mem_intv=MAX_INTV, max_cand=16, max_mem=16,
              max_iters=max_iters)
    ref = jax.device_get(jseeds(jfm.FMDevice.from_host(idx), jnp.asarray(codes),
                                jnp.asarray(lens), **kw))
    got = tseeds(tfm.FMDevice.from_host(idx, "cpu"), torch.from_numpy(codes),
                 torch.from_numpy(lens), **kw)
    for k in ("mems", "n_mem", "overflow", "iters", "it_r1", "it_r2"):
        assert np.array_equal(np.asarray(ref[k]), got[k].numpy()), k
    if max_iters:
        assert ref["overflow"].sum() > 5   # the budget really bit


def test_fm_machine_reseed_entry_equal(setup):
    idx, codes, lens = setup
    ref_k, _ = _kmer_both(idx, codes, lens)
    pre = {k: ref_k[k] for k in ("mem_s", "mem_b", "mem_e", "n_mem")}
    active = np.asarray(ref_k["needs_r2"]).copy()
    active[::7] = True    # more lanes through round 2 than the certificate
    kw = dict(min_seed_len=MSL, split_len=SPLIT_LEN, split_width=SPLIT_W,
              max_mem_intv=0, max_cand=16, max_mem=24, entry_reseed=True)
    ref = jax.device_get(jseeds(
        jfm.FMDevice.from_host(idx), jnp.asarray(codes), jnp.asarray(lens),
        reseed_entry=dict(active=jnp.asarray(active),
                          **{k: jnp.asarray(v) for k, v in pre.items()}),
        **kw))
    got = tseeds(
        tfm.FMDevice.from_host(idx, "cpu"), torch.from_numpy(codes),
        torch.from_numpy(lens),
        reseed_entry=dict(active=torch.from_numpy(active),
                          **{k: torch.from_numpy(np.array(v))
                             for k, v in pre.items()}),
        **kw)
    for k in ("mems", "n_mem", "overflow", "iters", "it_r1", "it_r2"):
        assert np.array_equal(np.asarray(ref[k]), got[k].numpy()), k
    assert (np.asarray(ref["n_mem"]) > np.asarray(pre["n_mem"])).any()


_FIELDS = ("mems", "n_mem", "overflow", "iters", "it_r1", "it_r2")
# (depth, max_iters) runs, each one JAX compile of the machine: the
# auto-picked depth at the default budget, a forced depth 6 under a budget
# small enough to overflow lanes on both sides
_JUMP_RUNS = {None: (0,), 6: (300,)}


@pytest.fixture(scope="module")
def jax_jump(setup):
    """The JAX machine on a ``build_seed_table``-extended index, by
    (depth, max_iters): depth None is the auto-picked one (8 here)."""
    idx, codes, lens = setup
    runs = {}
    for depth in (None, 6):
        fm2, table = jseed.build_seed_table(jfm.FMDevice.from_host(idx), idx,
                                            depth=depth)
        for max_iters in _JUMP_RUNS[depth]:
            runs[depth, max_iters] = jax.device_get(jseeds(
                fm2, jnp.asarray(codes), jnp.asarray(lens),
                jump_base=table.jump_base, jump_depth=table.jump_depth,
                min_seed_len=MSL, split_len=SPLIT_LEN, split_width=SPLIT_W,
                max_mem_intv=MAX_INTV, max_cand=16, max_mem=16,
                max_iters=max_iters))
        runs[depth] = table
    return runs


@pytest.mark.parametrize("depth,max_iters",
                         [(d, m) for d, ms in _JUMP_RUNS.items() for m in ms])
def test_fm_machine_jump_equal(setup, jax_jump, depth, max_iters):
    idx, codes, lens = setup
    ref = jax_jump[depth, max_iters]
    fm = tfm.FMDevice.from_host(idx, "cpu")
    jump = tseed.build_r3_jump(fm, depth)
    assert jump.depth == jax_jump[depth].jump_depth == (depth or 8)
    kw = dict(min_seed_len=MSL, split_len=SPLIT_LEN, split_width=SPLIT_W,
              max_mem_intv=MAX_INTV, max_cand=16, max_mem=16,
              max_iters=max_iters)
    got = tseeds(fm, torch.from_numpy(codes), torch.from_numpy(lens),
                 jump=jump, **kw)
    for k in _FIELDS:
        assert np.array_equal(np.asarray(ref[k]), got[k].numpy()), k
    if max_iters:
        assert ref["overflow"].sum() > 5   # the budget really bit
    else:   # the jump took steps off round 3
        plain = tseeds(fm, torch.from_numpy(codes), torch.from_numpy(lens),
                       **kw)
        assert (got["iters"] <= plain["iters"]).all()
        assert (got["iters"] < plain["iters"]).sum() > 20


@pytest.mark.parametrize("depth", [8, 6])
def test_jump_table_equals_jax(setup, depth):
    """The port's (k, l, s) table equals the JAX package's synthetic jump
    rows, decoded (row A holds k and l as 30-bit halves, row B - row A
    holds s)."""
    idx = setup[0]
    rows = np.asarray(jseed._r3_jump_rows(jfm.FMDevice.from_host(idx), depth),
                      np.int64).reshape(-1, 2, 12)
    a, b = rows[:, 0], rows[:, 1]
    want = np.stack([a[:, 0] + (a[:, 1] << 30), a[:, 2] + (a[:, 3] << 30),
                     (b[:, 0] - a[:, 0]) + ((b[:, 1] - a[:, 1]) << 30)], 1)
    got = tseed.build_r3_jump(tfm.FMDevice.from_host(idx, "cpu"), depth)
    assert np.array_equal(got.table.numpy(), want)


def _jax_depth(n_blocks: int) -> int:
    """The depth the JAX package's build_r3_jump picks for an int32-rank
    Occ table of ``n_blocks`` blocks (its own rules, called piecewise)."""
    base = -(-n_blocks // jfm.MAJOR_BLOCKS) * jfm.MAJOR_BLOCKS
    d = jseed._pick_jump_depth(n_blocks, base)
    if d and (base + 2 * 4 ** d) * jfm.OCC_BLOCK + 2 >= 2**31:
        return 0
    return d


def test_jump_depth_equals_jax(setup):
    idx = setup[0]
    assert (tseed.build_r3_jump(tfm.FMDevice.from_host(idx, "cpu")).depth
            == jseed.build_r3_jump(jfm.FMDevice.from_host(idx))[2] == 8)
    # the 4.6 Mb main path's block count (9.2 M doubled bases), and the
    # counts where the rules move: depth 6, no jump, 8 past the fast tier,
    # and the int32 rank limit
    main = -(-(2 * 4_600_000 + 1) // 128 // 8) * 8
    for n in (main, 300_000, 430_000, 500_000, (2**31 - 8_000_000) // 128):
        assert tseed.jump_depth(n) == _jax_depth(n), n
    assert [tseed.jump_depth(n) for n in (main, 300_000, 430_000)] == [8, 6, 0]
