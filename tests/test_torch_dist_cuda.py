"""Meshes on the card: two ranks on ``cuda`` (``gloo`` when the host has
fewer GPUs than ranks, else ``nccl``: ``launch.cuda_backend``), spawned
through ``dist/launch.py``. An index-sharded step (``index`` 2) gives
the single-device port's regions on the card, and a data-parallel
batch (``data`` 2) its records; both launch the CUDA SW kernel in every
rank. At ``index`` 2 the shard kernels of ``csrc/fm_shard.cu`` (the FM
machine's and the SA walk's query and apply) equal their plain twins
under the group bit for bit, with equal all_reduce calls and bytes, at
int32 and int64 ranks (``tools/shard_calls.py`` ``pair_rank``: the
CPU tests' 120 bp, 250 bp and 300-step-budget calls, a walk unmasked,
masked and through an unmarked primary). So do, at ``index`` 2 and both
rank dtypes, the window fetch (``windows_shard_query``, the all_reduce,
``extend_windows`` reading the sums), ``resolve_seeds`` (its two kernels
around the sharded walk) and the backward search (``bs_shard_query`` /
``bs_shard_apply`` a step) on every call of a recorded index-mesh step
and on ``shard_calls.search_batch`` (``shard_calls.route_rank``): each
route launches its kernels, no plain twin runs under the group on the
card, and with the sources made unbuildable each route raises.
Skips without a CUDA device.
Imports no jax, so it runs on a card machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dist_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.dist import launch
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.tools import shard_calls as sc
from bioseqdb_tpu_torch.tools.dist_leg import spawn_tasks
from bioseqdb_tpu_torch.utils.sim import simulate_genome, simulate_reads

pytestmark = pytest.mark.cuda


def test_meshes_on_the_card_equal_single_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    build.build()               # in the parent, before the ranks start
    g = simulate_genome(80_000, seed=91)
    idx = build_index([("g", g)])
    sim = simulate_reads(g, 256, read_len=150, sub_rate=0.02, seed=92)
    batch = pack_reads(sim.reads, sim.names)
    res, backend = spawn_tasks(
        [dict(cell=((2,), ("index",)), idx=idx,
              jobs=[dict(kind="regions", batch=batch)]),
         dict(cell=((2,), ("data",)), idx=idx,
              jobs=[dict(kind="align", batch=batch)])], 2, "cuda")
    assert backend == ("nccl" if torch.cuda.device_count() >= 2 else "gloo")
    sharded, dp = (res[0]["tasks"][k]["jobs"][0] for k in (0, 1))
    for r in res:
        assert all(t["jobs"][0]["sw_extend"] > 0 for t in r["tasks"])
    fm = Aligner.build(idx, AlignOptions(), device="cuda", seeder="fm")
    want = fm.device_regions(batch, keep_mems=True)   # dense regions
    got = sharded["out"]
    both = ~got["overflow"] & ~want["overflow"]
    assert both[: batch.n].sum() >= batch.n - 4
    for k, v in want["regs"].items():
        assert np.array_equal(got["regs"][k][both], v[both]), k
    single = Aligner.build(idx, AlignOptions(), device="cuda")
    assert ([dataclasses.asdict(r) for r in dp["results"]]
            == [dataclasses.asdict(r) for r in single.align_batch(batch)])


def test_index_mesh_shard_kernels_equal_plain_twins():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    build.build(["fm_shard"])   # in the parent, before the ranks start
    refs = sc.edge_refs(simulate_genome(30_000, seed=81))
    idx = build_index(refs, sa_interval=32)
    short, wide = sc.edge_batches(refs)
    opt = AlignOptions()
    calls = [sc.machine_call(short, opt), sc.machine_call(wide, opt),
             sc.machine_call(short, opt, max_iters=300)]
    rng = np.random.default_rng(3)
    ranks = torch.from_numpy(rng.integers(0, idx.seq_len + 1, 4096))
    mask = torch.from_numpy(rng.random(4096) < 0.5)
    ranks[:2] = torch.tensor([idx.primary, 0])
    walks = [dict(ranks=ranks, sa_interval=32),
             dict(ranks=ranks, sa_interval=32, mask=mask),
             dict(ranks=ranks, sa_interval=32, unmarked_primary=True)]
    res = launch.spawn(sc.pair_rank, 2, launch.cuda_backend(2),
                       args=("cuda", None, idx, calls, walks,
                             (torch.int32, torch.int64)), timeout_s=900)
    for r in res:
        assert not r["forbidden"]
        assert all(v > 0 for v in r["launches"].values()), r["launches"]
        for d in r["dtypes"]:
            for pair in d["machine"] + d["walks"]:
                assert sc.pair_equal(pair) and sc.max_abs_err(pair) == 0


def test_index_mesh_routes_equal_plain_twins(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    build.build()               # in the parent, before the ranks start
    refs = sc.edge_refs(simulate_genome(30_000, seed=81))
    idx = build_index(refs, sa_interval=32)
    short, wide = sc.edge_batches(refs)
    res = launch.spawn(
        sc.route_rank, 2, launch.cuda_backend(2),
        args=("cuda", None, idx, [short, wide, sc.strand_batch(refs)],
              sc.search_batch(refs, short), (torch.int32, torch.int64),
              str(tmp_path)), timeout_s=900)
    for r in res:
        assert not r["forbidden"]
        for d in r["dtypes"]:
            assert not any(d["twins"].values()), d["twins"]
            assert all(d["launches"][k] > 0 for k in sc.ROUTE_KERNELS), (
                d["launches"])
            assert d["reach"]["strand"] > 0 and d["reach"]["text_end"] > 0
            for pair in d["windows"] + d["resolve"] + [d["search"]]:
                assert sc.pair_equal(pair) and sc.max_abs_err(pair) == 0
        broken = r["dtypes"][0]["broken"]
        assert set(broken) == {"windows", "resolve", "search"}
        assert all(msg and "nvcc failed" in msg for msg in broken.values()), (
            broken)
