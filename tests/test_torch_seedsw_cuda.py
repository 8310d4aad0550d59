"""The hand-written CUDA seed-SW kernel (csrc/seedsw.cu) equals its plain
twin on the card: ``seed_sw_filter`` (valid and score) on
``tools/seedsw_calls.py``'s edge filter calls and the kernel's scores on
its hand-made windows, int32 and int64 ranks (int64 also past 2^31), and
on a simulated long-read batch's recorded call; each call on CUDA
tensors is one launch; and a long-read device step on the card launches
it (a short-read one does not). Skips without a CUDA device. Imports no
jax, so it runs on a card machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_seedsw_cuda.py``."""

import pytest
import torch

from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.tools import seedsw_calls as sc
from bioseqdb_tpu_torch.utils.sim import simulate_genome, simulate_reads

pytestmark = pytest.mark.cuda
DTYPES = {"int32": torch.int32, "int64": torch.int64}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _check(call) -> None:
    n0 = build.LAUNCHES["seed_sw"]
    got = call.run()
    torch.cuda.synchronize()
    assert build.LAUNCHES["seed_sw"] == n0 + 1
    assert sc.max_abs_err(got, call.run(plain=True)) == 0


@pytest.fixture(scope="module")
def recorded():
    """A simulated batch's seed_sw_filter call on the card (64 reads of
    1,500 bp at 1% substitutions on a 200 kb genome) with the launches of
    its device step, and the launches of a 150 bp batch's step."""
    _card()
    g = simulate_genome(200_000, seed=94)
    al = Aligner.build(build_index([("g", g)]), AlignOptions(), device="cuda")
    sim = simulate_reads(g, 64, read_len=1_500, sub_rate=0.01, seed=95)
    calls = []
    build.reset_launches()
    with sc.recording(calls):
        al.device_regions(pack_reads(sim.reads, sim.names))
    long_ = dict(build.LAUNCHES)
    short = simulate_reads(g, 256, read_len=150, sub_rate=0.01, seed=96)
    build.reset_launches()
    al.device_regions(pack_reads(short.reads, short.names))
    return calls[0], long_, dict(build.LAUNCHES)


def test_long_read_step_launches_the_kernel(recorded):
    _, long_, short = recorded
    assert long_["seed_sw"] == 1 and long_["kmer_seed"] == 0
    assert short["seed_sw"] == 0 and short["kmer_seed"] == 1


def test_kernel_equals_plain_on_a_recorded_batch(recorded):
    call = recorded[0]
    _check(call)
    _check(call.stage())
    assert call.stage().counts()["lanes"] > 1_000


@pytest.mark.parametrize("rank_dtype", list(DTYPES))
def test_kernel_equals_plain_on_edge_filter_calls(rank_dtype):
    _card()
    for _, call in sc.edge_calls(DTYPES[rank_dtype], "cuda"):
        _check(call)
        _check(call.stage())


@pytest.mark.parametrize("rank_dtype", list(DTYPES))
def test_kernel_equals_plain_on_edge_windows(rank_dtype):
    _card()
    for _, call in sc.edge_score_calls(DTYPES[rank_dtype], "cuda"):
        _check(call)
        if rank_dtype == "int64":
            _check(call.shifted())
