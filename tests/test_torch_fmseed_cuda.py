"""The hand-written CUDA FM seeding machine (csrc/fm_seed.cu) equals its
plain twin on the card, all six outputs exactly: on the edge-case batch
of ``tools/fm_machine.py`` over a small index with repeats, with int32
and int64 ranks, the round-3 jump on (depth 8 and 6) and off, the
default budget and a 300-step one, from the reseed entry and at the fat
retry's caps; each ``collect_seeds_device`` call on CUDA tensors is one
launch. Skips without a CUDA device. Imports no jax, so it runs on a
card machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fmseed_cuda.py``."""

import pytest
import torch

from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels import seed
from bioseqdb_tpu_torch.tools import fm_machine as fmm

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    idx, codes, lens, _ = fmm.edge_case_setup()
    return idx, codes.cuda(), lens.cuda()


def _check(call: fmm.MachineCall) -> dict:
    n0 = build.LAUNCHES["fm_seed"]
    got = call.run()
    torch.cuda.synchronize()
    assert build.LAUNCHES["fm_seed"] == n0 + 1
    want = call.run(plain=True)
    assert fmm.max_abs_err(got, want) == 0
    return got


@pytest.mark.parametrize("rank_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("depth,max_iters",
                         [(0, 0), (8, 0), (6, 300), (0, 300)])
def test_kernel_equals_plain(setup, rank_dtype, depth, max_iters):
    idx, codes, lens = setup
    fm = kfm.FMDevice.from_host(idx, "cuda", rank_dtype=rank_dtype)
    jump = seed.build_r3_jump(fm, depth) if depth else None
    got = _check(fmm.edge_call(fm, codes, lens, jump=jump,
                               max_iters=max_iters))
    if max_iters:
        assert got["overflow"].sum() > 5   # the budget really bit


@pytest.mark.parametrize("rank_dtype", [torch.int32, torch.int64])
def test_kernel_equals_plain_reseed_and_fat_caps(setup, rank_dtype):
    idx, codes, lens = setup
    fm = kfm.FMDevice.from_host(idx, "cuda", rank_dtype=rank_dtype)
    entry = fmm.edge_reseed_entry(idx, codes, lens)
    got = _check(fmm.edge_call(fm, codes, lens, max_mem_intv=0, max_mem=24,
                               entry_reseed=True, reseed_entry=entry))
    assert (got["n_mem"] > entry["n_mem"]).any()
    W = codes.shape[1]
    _check(fmm.edge_call(fm, codes, lens, jump=seed.build_r3_jump(fm),
                         max_cand=32, max_mem=32,
                         max_iters=3 * (10 * W + 256)))
