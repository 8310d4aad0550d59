"""The index mesh's FM machine and SA walk on the kernels of
``csrc/fm_shard.cu``, on the CPU (the kernels themselves run only on the
card: ``tests/test_torch_dist_cuda.py``).

The source's lane bodies, compiled for the host with g++ (its ``*_host``
entries), run through the same host loops as on the card
(``seed.collect_seeds_sharded``, ``fm.sa_walk_sharded``: a query, the
``all_reduce`` and an apply a step) in gloo ranks spawned through
``dist/launch.py`` (``tools/shard_calls.py`` ``pair_rank``; one spawn a
world size, both while the JAX side computes; the children import the
port alone), at ``index`` 2 with int32 ranks and ``index`` 3 (uneven
shards) with int64 ranks. On the 30 kb genome of seed 81 and a contig
that repeats its first 400 bases (``shard_calls.edge_refs``), indexed
at SA interval 32:

- each machine call equals ``collect_seeds_plain(..., group=)`` on all
  six outputs, with equal ``COLLECTIVES`` calls and bytes: 45 reads of
  120 bp at the full step's caps (an N-sprinkled, an empty, an all-N and
  a junk read, reads across the repeat's end on both strands, whose
  backward rows hold two long candidates, and across the text's end,
  whose forward intervals start at the primary rank:
  ``shard_calls.edge_batches``) and 8 reads at W 250 (past the 200-base caps:
  a 120 bp read, an N run, a junk and an empty read), both at ``index``
  2, and the 120 bp batch under a 300-step budget that runs out mid-row
  (lanes overflow with their backward pass open) at both world sizes. A
  gloo all_reduce on the CPU costs ~2 ms at 2 ranks and ~5 ms at 3, one
  a step of either route, so ``index`` 3 takes the short call alone;
- the walk equals ``sa_resolve_plain`` under the group, unmasked, under
  a lane mask and with the primary rank's mark bit cleared (its LF step,
  to rank 0), on ranks that take all 31 steps, the primary, rank 0 and
  ``seq_len``;
- the 120 bp call's mems equal the JAX sharded machine's: JAX
  ``collect_seeds_device(..., shard_axis="index")`` at the full step's
  caps under ``shard_map`` on an ``index`` 2 mesh of the conftest's
  virtual CPU devices, as ``full_align_step_sharded`` calls it (the
  machine alone: the whole step's compile takes ~25 s on the CPU,
  ``tests/test_torch_shard_index.py`` runs it);
- on CPU tensors under a group ``collect_seeds_device`` and
  ``sa_resolve`` take the plain twins, and no rank builds or loads a
  kernel library;
- the source's phase and round constants equal ``kernels/seed.py``'s,
  and its argument counts the wrapper's.

Skipped without g++. Integer programs: tolerance 0. The plain twins run
on one intra-op thread (``dist/launch.py`` sets it in every rank).
"""

import concurrent.futures
import re
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from bioseqdb_tpu.dist import shard_index as jsh
from bioseqdb_tpu.index.builder import build_index
from bioseqdb_tpu.kernels.seed import collect_seeds_device as jcollect
from bioseqdb_tpu.utils.sim import simulate_genome
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.dist import launch
from bioseqdb_tpu_torch.index.convert import fmindex_from_jax
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels import fm_shard_cuda as fsc
from bioseqdb_tpu_torch.kernels import seed
from bioseqdb_tpu_torch.tools import shard_calls as sc

# world size: (rank dtype, machine calls)
WORLDS = {2: (torch.int32, ("short", "wide", "budget300")),
          3: (torch.int64, ("budget300",))}
WALKS = ("unmasked", "masked", "unmarked_primary")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels' bodies for the host")
    lib = sc.host_library(tmp_path_factory.mktemp("fm_shard_host"))
    refs = sc.edge_refs(simulate_genome(30_000, seed=81))
    idx = build_index(refs, sa_interval=32)
    tidx = fmindex_from_jax(idx)
    short, wide = sc.edge_batches(refs)
    opt = AlignOptions()
    calls = dict(short=sc.machine_call(short, opt),
                 budget300=sc.machine_call(short, opt, max_iters=300),
                 wide=sc.machine_call(wide, opt))
    rng = np.random.default_rng(3)
    ranks = rng.integers(0, idx.seq_len + 1, 512)
    ranks[:4] = [idx.primary, 0, idx.seq_len, 1]
    mask = rng.random(512) < 0.5
    walks = [dict(ranks=torch.from_numpy(ranks), sa_interval=32),
             dict(ranks=torch.from_numpy(ranks), sa_interval=32,
                  mask=torch.from_numpy(mask)),
             dict(ranks=torch.from_numpy(ranks), sa_interval=32,
                  unmarked_primary=True)]
    # the ranks run while this process computes the JAX side
    pool = concurrent.futures.ThreadPoolExecutor(len(WORLDS))
    spawns = {n: pool.submit(launch.spawn, sc.pair_rank, n, "gloo",
                             ("cpu", str(lib), tidx, [calls[c] for c in cs],
                              walks, (dt,)), 600.0)
              for n, (dt, cs) in WORLDS.items()}
    mesh = Mesh(np.array(jax.devices()[:2]), ("index",))
    kw = calls["short"]["kw"]

    def inner(fms, codes, lens):   # full_align_step_sharded's machine
        m = jcollect(jsh._local_fm(fms), codes, lens, shard_axis="index",
                     **kw)
        return m["mems"], m["n_mem"]

    jmems, jn_mem = jax.device_get(jax.shard_map(
        inner, mesh=mesh, in_specs=jsh._in_specs(mesh, "index", None, 2),
        out_specs=(P(), P()), check_vma=False)(
            jsh.shard_index(idx, mesh), jnp.asarray(short.codes, jnp.int32),
            jnp.asarray(short.lens, jnp.int32)))
    res = {n: f.result() for n, f in spawns.items()}
    pool.shutdown()
    return dict(res=res, jax=dict(mems=jmems, n_mem=jn_mem), idx=idx,
                ranks=ranks, mask=mask)


def _pairs(run, world, what):
    for r in run["res"][world]:
        (d,) = r["dtypes"]
        assert d["rank_dtype"] == str(WORLDS[world][0])
        yield r["rank"], (dict(zip(WORLDS[world][1], d[what]))
                          if what == "machine" else d[what])


def test_children_import_the_port_alone(run):
    assert all(not r["forbidden"] for rs in run["res"].values() for r in rs)


@pytest.mark.parametrize("world, call", [(n, c) for n, (_, cs)
                                         in WORLDS.items() for c in cs])
def test_machine_equals_plain_twin(run, world, call):
    for rank, pairs in _pairs(run, world, "machine"):
        k, p = pairs[call]["kernel"], pairs[call]["plain"]
        for name in sc.MACHINE_OUTPUTS:
            assert np.array_equal(k["out"][name], p["out"][name]), (rank,
                                                                    name)
        assert k["collectives"]["calls"] == p["collectives"]["calls"] > 0
        assert k["collectives"]["bytes"] == p["collectives"]["bytes"]


@pytest.mark.parametrize("world", list(WORLDS))
def test_budget_runs_out_mid_row(run, world):
    for _, pairs in _pairs(run, world, "machine"):
        out = pairs["budget300"]["plain"]["out"]
        assert out["overflow"].any() and out["iters"].max() == 300
        if "short" in pairs:
            # a budget-only overflow: the unbudgeted run kept those lanes
            free = pairs["short"]["plain"]["out"]
            assert (out["overflow"] & ~free["overflow"]).any()


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("walk", range(len(WALKS)), ids=WALKS)
def test_walk_equals_plain_twin(run, world, walk):
    for rank, pairs in _pairs(run, world, "walks"):
        k, p = pairs[walk]["kernel"], pairs[walk]["plain"]
        assert np.array_equal(k["out"]["pos"], p["out"]["pos"]), rank
        assert k["collectives"] == p["collectives"]
        assert k["collectives"]["calls"] == 32


def test_walk_positions_are_the_index_s(run):
    idx, ranks, mask = run["idx"], run["ranks"], run["mask"]
    for world in WORLDS:
        for _, pairs in _pairs(run, world, "walks"):
            pos = pairs[0]["kernel"]["out"]["pos"]
            want = [idx.sa_at(int(x)) for x in ranks[:64]]
            assert [int(v) for v in pos[:64]] == want
            masked = pairs[1]["kernel"]["out"]["pos"]
            assert np.array_equal(masked, np.where(mask, pos, 0))
            # the primary (lane 0) walks on where its mark is cleared
            assert pairs[2]["kernel"]["out"]["pos"][0] != pos[0]


def test_machine_mems_equal_jax_sharded_machine(run):
    got = run["res"][2][0]["dtypes"][0]["machine"][0]["kernel"]["out"]
    assert WORLDS[2][1][0] == "short"
    want = run["jax"]
    assert np.array_equal(got["n_mem"], np.asarray(want["n_mem"]))
    assert np.array_equal(got["mems"], np.asarray(want["mems"]))


def test_cpu_tensors_take_the_plain_twins(run):
    for rs in run["res"].values():
        for r in rs:
            assert r["dispatch"] and r["built"] == 0


def test_kernel_constants_equal_the_modules():
    src = (build.CSRC / build.SOURCES["fm_shard"]).read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr (?:int|long long) (\w+) = (\d+);", src)}
    names = [n for n in dir(seed) if re.fullmatch(r"(PH|RD)_[A-Z0-9]+", n)]
    for n in names:
        if n != "PH_R3J":          # no jump on a sharded index
            assert consts[n] == getattr(seed, n), n
    assert "PH_R3J" not in consts
    assert consts["kMachineArgs"] == fsc.MACHINE_ARGS
    assert consts["kSaArgs"] == fsc.SA_ARGS
    for k in fsc.ENTRIES:
        assert k in build.SHARD_KERNELS and k in build.PATH_KERNELS
        assert k in build.LAUNCHES and k not in build.STEP_KERNELS
