"""The hand-written CUDA FM-index kernels (csrc/fm.cu) equal their plain
twins on the card, every output exactly: ``sa_resolve`` and
``backward_search`` on ``tools/fm_calls.py``'s edge sets (masked lanes,
ranks off the table), random inputs and an FM whose rank values lie past
2^31, with int32 and int64 ranks; each call on CUDA tensors is one
launch. ``resolve_seeds`` on the kernel's path waits on the host nowhere
(``torch.cuda.set_sync_debug_mode("error")``) and equals the CPU's
compacting route at every ``compact_cap``; a device step on the card
launches ``sa_resolve``, and an exact-mode batch both kernels, with the
CPU path's records. Skips without a CUDA device. Imports no jax, so it
runs on a card machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fm_cuda.py``."""

import dataclasses

import pytest
import torch

from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels import chain as kch
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.tools import fm_calls as fc
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


def _check(call: fc.FmCall) -> dict:
    n0 = build.LAUNCHES[call.kind]
    got = call.run()
    torch.cuda.synchronize()
    assert build.LAUNCHES[call.kind] == n0 + 1
    assert fc.max_abs_err(got, call.run(plain=True), call.kind) == 0
    return got


@pytest.mark.parametrize("rank", list(RANKS))
def test_kernels_equal_plain_on_edge_and_random_sets(es, rank):
    fm = kfm.FMDevice.from_host(es.idx, "cuda", rank_dtype=RANKS[rank])
    calls = fc.edge_calls(es, fm, device="cuda")
    for seed in (1, 2, 3):
        calls.update(fc.random_calls(es, fm, seed, device="cuda"))
    for name, call in calls.items():
        got = _check(call)
        if name == "ranks masked":
            assert (got["pos"][~call.args["mask"]] == 0).all()


def test_kernels_equal_plain_past_2_31(es):
    fm = fc.shifted(kfm.FMDevice.from_host(es.idx, "cuda",
                                           rank_dtype=torch.int64))
    for name, call in fc.edge_calls(es, fm, device="cuda").items():
        got = _check(call)
        key = "pos" if call.kind == "sa_resolve" else "hi"
        assert int(got[key].max()) >= 2 ** 31, name


@pytest.mark.parametrize("rank", list(RANKS))
@pytest.mark.parametrize("cap", [0, 4096, None, 64])
def test_resolve_seeds_waits_nowhere_and_equals_the_cpu(es, rank, cap):
    mems, n_mem = fc.synthetic_mems(es)
    rdt = RANKS[rank]
    args = dict(max_occ=500, max_seeds=64, sa_interval=es.idx.sa_interval,
                compact_cap=cap)
    want = kch.resolve_seeds(kfm.FMDevice.from_host(es.idx, "cpu",
                                                    rank_dtype=rdt),
                             mems.to(rdt), n_mem, **args)
    fm = kfm.FMDevice.from_host(es.idx, "cuda", rank_dtype=rdt)
    cm, cn = mems.to("cuda", rdt), n_mem.cuda()
    kch.resolve_seeds(fm, cm, cn, **args)   # builds the library
    torch.cuda.synchronize()
    n0 = build.LAUNCHES["sa_resolve"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kch.resolve_seeds(fm, cm, cn, **args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert build.LAUNCHES["sa_resolve"] == n0 + 1
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k].cpu(), v), k


@pytest.fixture(scope="module")
def batch(es):
    sim = simulate_reads(es.refs[0], 256, read_len=150, sub_rate=0.0,
                         seed=65)
    return pack_reads(sim.reads, sim.names)


def test_device_step_launches_sa_resolve(es, batch):
    build.reset_launches()
    out = Aligner.build(es.idx, AlignOptions(),
                        device="cuda").device_regions(batch)
    assert build.LAUNCHES["sa_resolve"] >= 1
    assert build.LAUNCHES["backward_search"] == 0
    want = Aligner.build(es.idx, AlignOptions(),
                         device="cpu").device_regions(batch)
    for k in ("n_regs", "overflow", "l_rep", "off"):
        assert (out[k] == want[k]).all(), k


@pytest.mark.parametrize("rank", list(RANKS))
def test_exact_batch_launches_both_and_equals_the_cpu(es, batch, rank):
    rdt = RANKS[rank]
    res = {}
    for dev in ("cuda", "cpu"):
        al = Aligner.build(es.idx, AlignOptions(), device=dev, mode="exact")
        al = dataclasses.replace(al, fm=kfm.FMDevice.from_host(
            es.idx, dev, rank_dtype=rdt))
        build.reset_launches()
        res[dev] = al.align_batch(batch)
        launched = {k: build.LAUNCHES[k] for k in build.EXACT_KERNELS}
        assert all((n > 0) == (dev == "cuda") for n in launched.values())
    assert ([dataclasses.asdict(r) for r in res["cuda"]]
            == [dataclasses.asdict(r) for r in res["cpu"]])
    assert sum(len(r.hits) for r in res["cuda"]) >= 250
