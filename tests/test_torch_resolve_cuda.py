"""The hand-written CUDA kernels of seed resolution (csrc/resolve.cu)
equal the plain twin on the card, every output exactly:
``resolve_seeds`` through ``resolve_expand``, the SA walk and
``resolve_finish`` against ``resolve_seeds_plain`` on
``tools/resolve_calls.py``'s edge set (the cap flooded at 4,096 and at
(B x S) // 4, position rows, sampling past max_occ, more seeds than
slots, bridges, B x S <= 4,096) and random intervals, int32, int64 and
past 2^31; a call launches each kernel once and waits on the host
nowhere (``torch.cuda.set_sync_debug_mode("error")``); a device step on
the card launches both. Skips without a CUDA device. Imports no jax, so
it runs on a card machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_resolve_cuda.py``."""

import pytest
import torch

from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.tools import fm_calls as fc
from bioseqdb_tpu_torch.tools import resolve_calls as rc
from bioseqdb_tpu_torch.utils.sim import simulate_reads

pytestmark = pytest.mark.cuda
RANKS = {"int32": torch.int32, "int64": torch.int64}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def es():
    _card()
    return fc.edge_setup()


def _check(call: rc.ResolveCall) -> dict:
    call.run()   # builds the library
    torch.cuda.synchronize()
    n0 = {k: build.LAUNCHES[k] for k in build.RESOLVE_KERNELS}
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = call.run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(build.LAUNCHES[k] == n0[k] + 1 for k in n0)
    assert rc.max_abs_err(got, call.run(plain=True)) == 0
    return got


@pytest.mark.parametrize("rank", list(RANKS))
def test_kernels_equal_plain_on_edge_and_random_sets(es, rank):
    fm = kfm.FMDevice.from_host(es.idx, "cuda", rank_dtype=RANKS[rank])
    calls = rc.edge_calls(es, fm, device="cuda")
    for seed in (1, 2, 3):
        calls.update(rc.random_calls(es, fm, seed, device="cuda"))
    if rank == "int64":
        calls.update({f"{n}, past 2^31": c.shifted()
                      for n, c in list(calls.items())})
    for name, call in calls.items():
        got = _check(call)
        if name.endswith("past 2^31"):
            assert int(got["rbeg"].max()) >= 2 ** 31, name


def test_device_step_launches_both(es):
    sim = simulate_reads(es.refs[0], 256, read_len=150, sub_rate=0.01,
                         seed=66)
    batch = pack_reads(sim.reads, sim.names)
    calls = []
    build.reset_launches()
    with rc.recording(calls):
        out = Aligner.build(es.idx, AlignOptions(),
                            device="cuda").device_regions(batch)
    for k in build.RESOLVE_KERNELS:
        assert build.LAUNCHES[k] == len(calls) >= 1, k
    want = Aligner.build(es.idx, AlignOptions(),
                         device="cpu").device_regions(batch)
    for k in ("n_regs", "overflow", "l_rep", "off"):
        assert (out[k] == want[k]).all(), k
    for call in calls:
        assert rc.max_abs_err(call.run(), call.run(plain=True)) == 0
