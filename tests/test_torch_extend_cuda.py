"""The hand-written CUDA kernels of the extension stage (csrc/extend.cu)
equal their plain twins on the card, every output exactly: each stage call
(``extend_scan``, ``extend_windows``, ``extend_merge`` both sides,
``extend_seedcov``) of a simulated batch's ``extend_all`` call, of
``tools/extend_calls.py``'s edge set with its fat retry at int32 and
int64 ranks (and past 2^31), and of its random stage inputs; each call
on CUDA tensors is one launch; ``extend_all`` with the kernels equals it
with the plain twins and waits on the card less often; and a device step
on the card launches all four. Skips without a CUDA device. Imports no
jax, so it runs on a card machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_extend_cuda.py``."""

import pytest
import torch

from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.tools import extend_calls as ec
from bioseqdb_tpu_torch.utils.sim import simulate_genome, simulate_reads

pytestmark = pytest.mark.cuda
DTYPES = {"int32": torch.int32, "int64": torch.int64}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _check(stage: ec.StageCall) -> None:
    n0 = build.LAUNCHES[stage.kind]
    got = stage.run()
    torch.cuda.synchronize()
    assert build.LAUNCHES[stage.kind] == n0 + 1, stage.name
    assert ec.max_abs_err(got, stage.run(plain=True)) == 0, stage.name


@pytest.fixture(scope="module")
def recorded():
    """A simulated batch's extend_all call on the card (kmer seeder, 512
    reads at 2% substitutions and 16 chimeric ones on an 80 kb genome
    holding a 600 bp repeat twice), with the launches of its device
    step."""
    _card()
    core = simulate_genome(80_000, seed=81)
    rep = simulate_genome(600, seed=83)
    g = core[:30_000] + rep + core[30_000:60_000] + rep + core[60_000:]
    sim = simulate_reads(g, 512, read_len=150, sub_rate=0.02, seed=82)
    reads = list(sim.reads) + [g[1_000 * k : 1_000 * k + 75]
                               + g[50_000 + 900 * k : 50_075 + 900 * k]
                               for k in range(16)]
    al = Aligner.build(build_index([("g", g)]), AlignOptions(), device="cuda")
    calls = []
    build.reset_launches()
    with ec.recording(calls):
        al.device_regions(pack_reads(reads, [f"r{i}" for i in
                                             range(len(reads))]))
    return calls[0], dict(build.LAUNCHES)


def test_device_step_launches_every_kernel(recorded):
    _, launches = recorded
    for k in build.EXTEND_KERNELS:
        assert launches[k] >= 1, k
    assert launches["extend_merge"] % 2 == 0
    assert launches["extend_seedcov"] == 1


def test_kernels_equal_plain_on_a_recorded_batch(recorded):
    call, _ = recorded
    out, stages = call.stages()
    assert {s.kind for s in stages} == set(build.EXTEND_KERNELS)
    for s in stages:
        _check(s)
    assert ec.max_abs_err(out, call.run(plain=True)) == 0


def test_the_kernels_wait_on_the_card_less(recorded):
    call, _ = recorded
    kernel, plain = call.syncs(), call.syncs(plain=True)
    # at most the JAX program's branches: a round's any(act), a side's
    # any(retry)
    assert kernel <= 3 * call.args["max_rounds"] < plain


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_equal_plain_on_the_edge_set(dtype):
    _card()
    calls, _ = ec.edge_calls(DTYPES[dtype], device="cuda", retry=True)
    for name, call in calls:
        out, stages = call.stages()
        if dtype == "int64":
            stages += [s.shifted() for s in stages
                       if s.kind != "extend_windows"]
        for s in stages:
            _check(s)
        assert ec.max_abs_err(out, call.run(plain=True)) == 0, name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_kernels_equal_plain_on_random_inputs(dtype, seed):
    _card()
    calls = ec.random_calls(DTYPES[dtype], seed=seed, device="cuda")
    if dtype == "int64":
        calls += [s.shifted() for s in calls if s.kind != "extend_windows"]
    for s in calls:
        _check(s)
