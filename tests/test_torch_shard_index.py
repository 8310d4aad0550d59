"""The port's BWT-interval-sharded index equals the JAX package's.

The JAX side runs on the conftest's virtual CPU devices, as
``tests/test_shard_index.py`` runs it; the port side in gloo ranks on
the CPU, spawned through ``dist/launch.py`` (one spawn a world size for
the module: 2, 3 and 4 ranks, run while the JAX side computes), whose
children import the port alone. On a 30 kb genome (seed 81):

- each rank's ``blocks`` / ``sa_cnt`` / ``sa_words`` / ``pac`` shard
  equals the JAX ``FMSharded``'s slice, at 2 and 3 (uneven) shards;
- ``backward_search_sharded`` and ``sa_resolve_sharded`` at 2 and 3
  index ranks equal JAX's and the unsharded port's, and the same with
  int64 ranks forced, against JAX under x64;
- the major checkpoints inside the owner sum: a 2.6 Mb + 0.5 Mb genome,
  whose second major row is nonzero, 64 ranks through
  ``sa_resolve_sharded`` at 2 ranks, each equal to ``idx.sa_at``;
- ``full_align_step_sharded`` at ``index`` 2 and at ``data`` 2 x
  ``index`` 2 (16 reads x 120 bp): regions, ``n_regs`` and overflow
  equal to the JAX function's (run once, on a ``data`` 2 x ``index`` 2
  mesh: its results do not depend on the mesh), the port's overflow a
  subset of JAX's (the port's seed resolution walks every rank lane, the
  JAX buffer holds (B * S) // 4) and the regions compared on rows that
  overflowed in neither; the final records through ``finalize_columns``
  equal.

Integer programs: exact equality, tolerance 0.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from bioseqdb_tpu.align.options import AlignOptions as JAlignOptions
from bioseqdb_tpu.cpu.ksw import fill_scmat
from bioseqdb_tpu.dist import shard_index as jsh
from bioseqdb_tpu.index.builder import build_index
from bioseqdb_tpu.io.batch import pack_reads as jpack_reads
from bioseqdb_tpu.utils.sim import simulate_genome, simulate_reads
from bioseqdb_tpu_torch.align.columns import finalize_columns
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.dist.shard_index import shard_tables
from bioseqdb_tpu_torch.index.builder import build_index as tbuild_index
from bioseqdb_tpu_torch.index.convert import fmindex_from_jax
from bioseqdb_tpu_torch.index.fmindex import MAJOR_BLOCKS, OCC_BLOCK
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import fm as tfm
from bioseqdb_tpu_torch.tools.dist_leg import rows_differ, spawn_tasks
from bioseqdb_tpu_torch.utils.sim import simulate_genome as tsim_genome

FIELDS = ("rb", "re", "qb", "qe", "score", "truesc", "w", "seedlen0", "rid",
          "seedcov")


def _mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


@pytest.fixture(scope="module")
def run():
    g = simulate_genome(30_000, seed=81)
    idx = build_index([("ref", g)])
    tidx = fmindex_from_jax(idx)
    sim = simulate_reads(g, 32, read_len=90, sub_rate=0.02, seed=2)
    batch = pack_reads(sim.reads, sim.names)
    codes = np.asarray(batch.codes, np.int32)
    lens = np.asarray(batch.lens, np.int32)
    ranks = np.random.default_rng(3).integers(1, idx.seq_len + 1, 512)
    ranks[:2] = [idx.primary, idx.seq_len]
    # the nonzero-majors genome: 2+ major rows (tests/test_shard_index.py)
    n_fwd = (MAJOR_BLOCKS * OCC_BLOCK) // 2 + 500_000
    midx = tbuild_index([("maj", tsim_genome(n_fwd, seed=77))])
    mranks = np.random.default_rng(9).integers(0, midx.seq_len + 1, size=64)
    # the full step's reads: 16 x 120 bp, padded to the mesh's rows
    fsim = simulate_reads(g, 16, read_len=120, sub_rate=0.03, seed=9)
    fbatch = pack_reads(fsim.reads, fsim.names, pad_reads_to=4)
    jbatch = jpack_reads(fsim.reads, fsim.names, pad_reads_to=4)

    q = lambda rdt: dict(idx=tidx, codes=codes, lens=lens, ranks=ranks,
                         rank_dtype=rdt, sa_interval=idx.sa_interval)
    job = dict(kind="regions", batch=fbatch)
    cell = lambda shape, names: dict(cell=(shape, names), idx=tidx,
                                     jobs=[job])
    spawns = {
        2: [dict(queries=q(None)), dict(queries=q(torch.int64)),
            dict(queries=dict(idx=midx, ranks=mranks,
                              sa_interval=midx.sa_interval)),
            cell((2,), ("index",))],
        3: [dict(queries=q(None)), dict(queries=q(torch.int64))],
        4: [cell((2, 2), ("data", "index"))]}
    # the ranks run while this process computes the JAX side
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ranks_done = pool.submit(lambda: {n: spawn_tasks(t, n, "cpu")[0]
                                      for n, t in spawns.items()})

    jq = {}
    mat = jnp.asarray(fill_scmat(1, 4).astype(np.int32))
    jcodes = jnp.asarray(jbatch.codes, jnp.int32)
    jlens = jnp.asarray(jbatch.lens, jnp.int32)
    for n in (2, 3):
        mesh = _mesh((n,), ("index",))
        fms = jsh.shard_index(idx, mesh)
        jq[n] = dict(fms=jax.device_get(fms), bs=jax.device_get(
            jsh.backward_search_sharded(fms, jnp.asarray(codes),
                                        jnp.asarray(lens), mesh)),
                     pos=np.asarray(jsh.sa_resolve_sharded(
                         fms, jnp.asarray(ranks, jnp.int32), mesh,
                         sa_interval=idx.sa_interval)))
        with jax.enable_x64():
            fms64 = jsh.shard_index(idx, mesh, rank_dtype=jnp.int64)
            jq[n]["bs64"] = jax.device_get(jsh.backward_search_sharded(
                fms64, jnp.asarray(codes), jnp.asarray(lens), mesh))
            jq[n]["pos64"] = np.asarray(jsh.sa_resolve_sharded(
                fms64, jnp.asarray(ranks, jnp.int64), mesh,
                sa_interval=idx.sa_interval))
    # one JAX step (its compile is the fixture's largest cost): its
    # results do not depend on the mesh (tests/test_shard_index.py)
    mesh = _mesh((2, 2), ("data", "index"))
    jstep = jax.device_get(jsh.full_align_step_sharded(
        jsh.shard_index(idx, mesh), jcodes, jlens, mat, mesh,
        JAlignOptions(), idx.n_refs, data_axis="data"))
    # the unsharded port
    fm = tfm.FMDevice.from_host(tidx, "cpu")
    ulo, uhi = tfm.backward_search(fm, torch.from_numpy(codes),
                                   torch.from_numpy(lens))
    upos = tfm.sa_resolve(fm, torch.from_numpy(ranks), idx.sa_interval)
    port = ranks_done.result()
    pool.shutdown()
    return dict(idx=idx, tidx=tidx, midx=midx, mranks=mranks, port=port,
                jq=jq, jstep=jstep, fbatch=fbatch,
                unsharded=(ulo.numpy(), uhi.numpy(), upos.numpy()))


def test_children_import_the_port_alone(run):
    assert all(not r["forbidden"] for rs in run["port"].values() for r in rs)


@pytest.mark.parametrize("n", [2, 3])
def test_shard_layout_equals_jax(run, n):
    fms = run["jq"][n]["fms"]
    for s, r in enumerate(run["port"][n]):
        got = r["tasks"][0]
        assert np.array_equal(got["tables"]["blocks"], fms.blocks[s])
        assert np.array_equal(got["tables"]["sa_cnt"], fms.sa_cnt[s])
        assert np.array_equal(got["tables"]["sa_words"], fms.sa_words[s])
        assert np.array_equal(got["pac"], fms.pac[s])
        host = shard_tables(run["tidx"], n, s)
        assert np.array_equal(host["blocks"], got["tables"]["blocks"])


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("int64", [False, True])
def test_sharded_queries_equal_jax_and_unsharded(run, n, int64):
    jq = run["jq"][n]
    lo_j, hi_j = jq["bs64" if int64 else "bs"]
    pos_j = jq["pos64" if int64 else "pos"]
    ulo, uhi, upos = run["unsharded"]
    for r in run["port"][n]:
        got = r["tasks"][1 if int64 else 0]
        assert got["rank_dtype"] == ("torch.int64" if int64 else "torch.int32")
        for want in ((lo_j, hi_j, pos_j), (ulo, uhi, upos)):
            assert np.array_equal(got["lo"], want[0])
            assert np.array_equal(got["hi"], want[1])
            assert np.array_equal(got["pos"], want[2])


def test_sharded_resolve_nonzero_majors(run):
    midx = run["midx"]
    assert midx.occ_majors.shape[0] >= 2 and midx.occ_majors[1:].any()
    for r in run["port"][2]:
        pos = r["tasks"][2]["pos"]
        assert [int(p) for p in pos] == [midx.sa_at(int(x))
                                         for x in run["mranks"]]


@pytest.mark.parametrize("world", [2, 4])
def test_full_step_sharded_equals_jax(run, world):
    task = 3 if world == 2 else 0
    got = run["port"][world][0]["tasks"][task]["jobs"][0]["out"]
    want = run["jstep"]
    B = run["fbatch"].n_padded
    assert got["n_regs"].shape == (B,)
    g_ovf = np.asarray(got["overflow"])
    w_ovf = np.asarray(want["overflow"])
    assert not (g_ovf & ~w_ovf).any()
    both = ~g_ovf & ~w_ovf
    assert both.sum() >= B - 2
    for f in FIELDS:
        assert np.array_equal(got["regs"][f][both], want["regs"][f][both]), f
    assert np.array_equal(got["n_regs"][both], want["n_regs"][both])
    assert np.array_equal(got["l_rep"], want["l_rep"])
    opt = AlignOptions()
    b = run["fbatch"]
    cols_g = finalize_columns(run["tidx"], opt, b, got)
    cols_w = finalize_columns(run["tidx"], opt, b, dict(
        regs={k: np.asarray(v) for k, v in want["regs"].items()},
        **{k: np.asarray(want[k]) for k in ("n_regs", "overflow", "l_rep")}))
    assert rows_differ(cols_g, cols_w, np.arange(b.n)) == []
