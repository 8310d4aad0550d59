"""int64 ranks on the card: a forced-int64 FM-seeded device step (which
launches the CUDA SW kernel) gives the int32 step's regions on the card
and the CPU plain path's, with ``rb`` int64. Skips without a CUDA device.
Imports no jax, so it runs on a card machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_int64_cuda.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels import seed as kseed
from bioseqdb_tpu_torch.utils.sim import simulate_genome, simulate_reads

pytestmark = pytest.mark.cuda


def _int64(al: Aligner) -> Aligner:
    """``al`` with its FM tables rebuilt with int64 ranks forced."""
    fm = kfm.FMDevice.from_host(al.index, al.device, rank_dtype=torch.int64)
    return dataclasses.replace(al, fm=fm, jump=kseed.build_r3_jump(fm))


@pytest.mark.parametrize("seeder", ["fm", "kmer"])
def test_int64_step_cuda_equal_int32_and_cpu(seeder):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = simulate_genome(80_000, seed=91)
    idx = build_index([("g", g)])
    sim = simulate_reads(g, 256, read_len=150, sub_rate=0.02, seed=92)
    batch = pack_reads(sim.reads, sim.names)
    out = {}
    for dev in ("cuda", "cpu"):
        al = Aligner.build(idx, AlignOptions(), device=dev, seeder=seeder)
        al64 = _int64(al)
        assert al64.fm.rank_dtype == torch.int64
        n0 = build.LAUNCHES["sw_extend"]
        out[dev, 64] = al64.device_regions(batch)
        launched = build.LAUNCHES["sw_extend"] - n0
        assert (launched > 0) == (dev == "cuda")
        out[dev, 32] = al.device_regions(batch)
    want = out["cuda", 64]
    assert want["regs"]["rb"].dtype == want["regs"]["re"].dtype == np.int64
    for key in (("cuda", 32), ("cpu", 64), ("cpu", 32)):
        got = out[key]
        for k in ("n_regs", "overflow", "l_rep", "off"):
            assert np.array_equal(got[k], want[k]), (key, k)
        for k, v in want["regs"].items():
            assert np.array_equal(got["regs"][k], v), (key, k)
    assert (want["n_regs"][: batch.n] > 0).sum() >= 250
