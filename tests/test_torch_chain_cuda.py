"""The hand-written CUDA chaining kernels (csrc/chain.cu) equal their plain
twins on the card, every output exactly: ``chain_seeds`` and
``filter_chains`` on ``tools/chain_calls.py``'s edge seeds and on a
simulated batch's recorded seeds (repeat and chimeric reads included),
with int32 and int64 ranks, at C 16, 32 and 64 and S 64, 128, 189 and
378; ``filter_chains`` on ``chain_calls.filter_calls`` (C 8, 16, 32 and
64: no chain, C chains, equal weights at equal pos, assign past C - 1,
two promotions, a drop by the first kept chain, random reads); each call
on CUDA tensors is one launch; and a device step on the card launches
both. Skips without a
CUDA device. Imports no jax, so it runs on a card machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_chain_cuda.py``."""

import pytest
import torch

from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.tools import chain_calls as cc
from bioseqdb_tpu_torch.utils.sim import simulate_genome, simulate_reads

pytestmark = pytest.mark.cuda
ALT = dict(mask_level=0.3, chain_drop_ratio=0.7, min_chain_weight=25)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _check(call: cc.ChainCall) -> dict:
    n0 = build.LAUNCHES[call.kind]
    got = call.run()
    torch.cuda.synchronize()
    assert build.LAUNCHES[call.kind] == n0 + 1
    assert cc.max_abs_err(got, call.run(plain=True), call.kind) == 0
    return got


@pytest.fixture(scope="module")
def recorded():
    """A simulated batch's chain_seeds call on the card (kmer seeder, 256
    reads at 2% substitutions and 16 chimeric ones on an 80 kb genome
    holding a 600 bp repeat twice), with both kernels launched in its
    device step."""
    _card()
    core = simulate_genome(80_000, seed=91)
    rep = simulate_genome(600, seed=93)
    g = core[:30_000] + rep + core[30_000:60_000] + rep + core[60_000:]
    sim = simulate_reads(g, 256, read_len=150, sub_rate=0.02, seed=92)
    reads = list(sim.reads) + [g[1_000 * k : 1_000 * k + 75]
                               + g[50_000 + 900 * k : 50_075 + 900 * k]
                               for k in range(16)]
    al = Aligner.build(build_index([("g", g)]), AlignOptions(), device="cuda")
    calls = []
    build.reset_launches()
    with cc.recording(calls):
        al.device_regions(pack_reads(reads, [f"r{i}" for i in
                                             range(len(reads))]))
    return cc.pairs(calls)[0][0], dict(build.LAUNCHES)


def test_device_step_launches_both_kernels(recorded):
    _, launches = recorded
    assert launches["chain_seeds"] >= 1 and launches["filter_chains"] >= 1
    assert launches["sw_extend"] >= 1


@pytest.mark.parametrize("rank_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("S", [64, 128, 189, 378])
@pytest.mark.parametrize("C", [16, 32, 64])
def test_kernels_equal_plain_on_edge_seeds(rank_dtype, S, C):
    _card()
    cs, fc, _ = cc.edge_calls(rank_dtype, S=S, C=C, device="cuda")
    chains = _check(cs)
    assert chains["overflow"].any() == (S > C)
    for opts in ({}, ALT):
        _check(cc.ChainCall("filter_chains",
                            dict(fc.args, chains=chains, **opts)))


def _ranks(call: cc.ChainCall, rank_dtype) -> cc.ChainCall:
    seeds = dict(call.seeds, rbeg=call.seeds["rbeg"].to(rank_dtype))
    return cc.ChainCall("chain_seeds", dict(call.args, seeds=seeds))


@pytest.mark.parametrize("rank_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("C", [16, 32, 64])
def test_kernels_equal_plain_on_a_simulated_batch(recorded, rank_dtype, C):
    call = _ranks(recorded[0], rank_dtype)
    cs = cc.ChainCall("chain_seeds", dict(call.args, max_chains=C))
    chains = _check(cs)
    assert (chains["n"] > 1).any()
    fc = cc.ChainCall("filter_chains", dict(chains=chains, seeds=cs.seeds,
                                            **cc.FILTER_OPTS))
    _check(fc)


@pytest.mark.parametrize("rank_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("C", [8, 16, 32, 64])
def test_filter_kernel_equals_plain_on_filter_calls(rank_dtype, C):
    _card()
    call, _ = cc.filter_calls(rank_dtype, C, device="cuda")
    for opts in ({}, ALT):
        _check(cc.ChainCall("filter_chains", dict(call.args, **opts)))
