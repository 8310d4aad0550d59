"""Data-parallel and index-sharded ``Aligner``s of the port equal the
single-device port.

Two gloo ranks on the CPU, spawned once for the module through
``dist/launch.py`` (children import the port alone), run a 30 kb genome
(seed 81, the JAX ``tests/test_shard_index.py`` genome):

- on a ``data`` 2 mesh: ``align_batch`` in full mode (the kmer seeder)
  on 15 reads, an odd count packed without row padding, so the mesh pads
  a row; exact mode on the same reads; ``align_pairs`` of 6 pairs (two
  steps, one a mate, and no retry under a mesh);
- on an ``index`` 2 mesh: ``align_batch`` (FM-seeded, sharded tables).

Each must equal the single-device port's records field for field
(integer programs: exact equality). The mesh rules that need no ranks
(exact mode on an index axis, a mesh of another device type) raise
``ValueError``; a collective that one rank never joins fails at the
launcher's deadline instead of hanging.
"""

import dataclasses
import time
import types

import pytest
import torch

from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.dist import launch
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.tools.dist_leg import rank_stall, spawn_tasks
from bioseqdb_tpu_torch.utils.sim import (simulate_genome, simulate_pairs,
                                          simulate_reads)


def _records(res):
    return [dataclasses.asdict(r) for r in res]


@pytest.fixture(scope="module")
def run():
    g = simulate_genome(30_000, seed=81)
    idx = build_index([("ref", g)])
    sim = simulate_reads(g, 15, read_len=120, sub_rate=0.03, seed=31)
    batch = pack_reads(sim.reads, sim.names, pad_reads_to=1)
    r1, r2, _ = simulate_pairs(g, 6, read_len=100, insert_std=30, seed=32)
    pairs = (pack_reads(r1.reads, r1.names), pack_reads(r2.reads, r2.names))
    data = [dict(kind="align", batch=batch),
            dict(kind="align", batch=batch, mode="exact"),
            dict(kind="pairs", batch=pairs)]
    res, backend = spawn_tasks(
        [dict(cell=((2,), ("data",)), idx=idx, jobs=data),
         dict(cell=((2,), ("index",)), idx=idx,
              jobs=[dict(kind="align", batch=batch)])], 2, "cpu")
    single = dict(
        full=Aligner.build(idx, device="cpu").align_batch(batch),
        exact=Aligner.build(idx, device="cpu", mode="exact").align_batch(
            batch),
        pairs=Aligner.build(idx, device="cpu").align_pairs(*pairs),
        fm=Aligner.build(idx, device="cpu", seeder="fm").align_batch(batch))
    return dict(idx=idx, batch=batch, res=res, backend=backend,
                single=single)


def test_ranks_ran_gloo_without_jax(run):
    assert run["backend"] == "gloo"
    assert [r["rank"] for r in run["res"]] == [0, 1]
    assert all(not r["forbidden"] for r in run["res"])


@pytest.mark.parametrize("job,want", [(0, "full"), (1, "exact")])
def test_data_parallel_align_batch_equals_single_device(run, job, want):
    got = run["res"][0]["tasks"][0]["jobs"][job]["results"]
    assert len(got) == run["batch"].n == 15
    assert _records(got) == _records(run["single"][want])


def test_data_parallel_pairs_equal_single_device(run):
    got = run["res"][0]["tasks"][0]["jobs"][2]["results"]
    want = run["single"]["pairs"]
    assert len(got) == 6
    for (a1, a2), (b1, b2) in zip(got, want):
        assert dataclasses.asdict(a1) == dataclasses.asdict(b1)
        assert dataclasses.asdict(a2) == dataclasses.asdict(b2)


def test_index_sharded_align_batch_equals_single_device(run):
    got = run["res"][0]["tasks"][1]["jobs"][0]["results"]
    assert _records(got) == _records(run["single"]["fm"])


def test_mesh_rules_without_ranks(run):
    index_mesh = types.SimpleNamespace(mesh_dim_names=("index",),
                                       device_type="cpu")
    with pytest.raises(ValueError, match="mode='full'"):
        Aligner.build(run["idx"], device="cpu", mode="exact",
                      mesh=index_mesh)
    cuda_mesh = types.SimpleNamespace(mesh_dim_names=("data",),
                                      device_type="cuda")
    with pytest.raises(ValueError, match="mesh with device"):
        Aligner.build(run["idx"], device="cpu", mesh=cuda_mesh)


def test_a_stalled_collective_fails_at_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="ran past"):
        launch.spawn(rank_stall, 2, "gloo", args=(1, 120.0), timeout_s=8.0)
    assert time.monotonic() - t0 < 60
    assert launch.cuda_backend(2) == ("nccl" if torch.cuda.device_count() >= 2
                                      else "gloo")
