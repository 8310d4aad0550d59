"""The hand-written CUDA kernels of the extension stage (csrc/extend.cu)
equal their plain twins on the card, every output exactly: each stage call
(``extend_setup``, ``extend_scan``, ``extend_windows``, ``extend_merge``
both sides, ``extend_seedcov``) of a simulated batch's ``extend_all`` call, of
``tools/extend_calls.py``'s edge set with its fat retry at int32 and
int64 ranks (and past 2^31), of its random stage inputs and of its lane
cases (the scan's and the merge's thread-layout boundaries), and the
set-up on ``extend_calls.setup_calls`` (S up to 3,128, C up to 256: past
a block's shared memory, a scratch in device memory); each call on CUDA
tensors is one launch; ``extend_all`` with the kernels equals it with
the plain twins and never waits on the card (its rounds' and retries'
guards are gates on the device), also on a call whose every round is
dead; its CUDA graph, captured at a shape's first call and replayed
after, equals the launches issued one by one, counts the launches each
replay makes and gives each call tensors of its own; and a device step
on the card launches all five. Skips without a CUDA device. Imports no
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
    # the JAX program's branches (a round's any(act), a side's any(retry))
    # are gates on the card: no wait at all
    assert kernel == 0 < plain
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = call.run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ec.max_abs_err(out, call.run(plain=True)) == 0


def test_dead_rounds_leave_the_state(recorded):
    call, _ = recorded
    dead = call.dead
    out = dead.run()
    assert ec.max_abs_err(out, dead.run(plain=True)) == 0
    assert int(out["n_regs"].sum()) == 0
    with ec.ungated():
        assert ec.max_abs_err(call.run(), call.run(plain=True)) == 0


def test_graph_replays_equal_the_launches(recorded):
    call, _ = recorded
    with ec.route("gates"):
        n0 = dict(build.LAUNCHES)
        want = call.run()
        gated = {k: build.LAUNCHES[k] - n0[k] for k in n0}
    outs = []
    for _ in range(3):   # the capture (if no earlier call made it), replays
        n0 = dict(build.LAUNCHES)
        outs.append(call.run())
        assert {k: build.LAUNCHES[k] - n0[k] for k in n0} == gated
    for out in outs:
        assert ec.max_abs_err(out, want) == 0
    outs[0]["n_regs"].fill_(-1)   # each call's tensors are its own
    assert ec.max_abs_err(outs[1], want) == 0
    dead = call.dead.run()   # the same graph, other inputs
    assert int(dead["n_regs"].sum()) == 0
    assert ec.max_abs_err(call.run(), want) == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_setup_equals_plain_on_setup_calls(dtype):
    _card()
    for name, s in ec.setup_calls(DTYPES[dtype], device="cuda").items():
        _check(s)
        if dtype == "int64":
            _check(s.shifted())


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


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_equal_plain_on_lane_cases(dtype):
    _card()
    for name, (calls, want) in ec.lane_cases(DTYPES[dtype],
                                             device="cuda").items():
        if dtype == "int64":
            calls = calls + [s.shifted() for s in calls
                             if s.kind != "extend_windows"]
        for s in calls:
            _check(s)
        if want is not None:
            got = calls[0].run()["cursor"].long().cpu()
            assert torch.equal(got, want), name
