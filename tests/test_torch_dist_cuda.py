"""Meshes on the card: two ranks on ``cuda`` (``gloo`` when the host has
fewer GPUs than ranks, else ``nccl``: ``launch.cuda_backend``), spawned
through ``dist/launch.py``. An index-sharded step (``index`` 2) gives
the single-device port's regions on the card, and a data-parallel
batch (``data`` 2) its records; both launch the CUDA SW kernel in every
rank. Skips without a CUDA device. Imports no jax, so it runs on a card
machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dist_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import build
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
