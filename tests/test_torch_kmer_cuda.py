"""The hand-written CUDA minimizer seeder (csrc/kmer.cu) equals its plain
twin on the card, every output exactly: ``collect_seeds_kmer`` on
``tools/kmer_calls.py``'s edge calls (every fallback bit, needs_r2, round
3 off, W 320 at nmz 104 and dmax 40), its random calls and a simulated
batch's recorded call; each call on CUDA tensors is one launch; and a
device step on the card launches it, with int32 and int64 ranks (the
seeder itself holds no rank). Skips without a CUDA device. Imports no
jax, so it runs on a card machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kmer_cuda.py``."""

import dataclasses

import pytest
import torch

from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels.seed import build_r3_jump
from bioseqdb_tpu_torch.tools import kmer_calls as kc
from bioseqdb_tpu_torch.utils.sim import simulate_genome, simulate_reads

pytestmark = pytest.mark.cuda
DTYPES = {"int32": torch.int32, "int64": torch.int64}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _check(call: kc.KmerCall) -> dict:
    n0 = build.LAUNCHES["kmer_seed"]
    got = call.run()
    torch.cuda.synchronize()
    assert build.LAUNCHES["kmer_seed"] == n0 + 1
    assert kc.max_abs_err(got, call.run(plain=True)) == 0
    return got


@pytest.fixture(scope="module", params=list(DTYPES))
def recorded(request):
    """A simulated batch's collect_seeds_kmer call on the card (512 reads
    at 2% substitutions and 16 chimeric ones on an 80 kb genome holding a
    600 bp repeat twice), with the launches of its device step; the
    Aligner's FMDevice in the rank dtype of the param."""
    _card()
    core = simulate_genome(80_000, seed=84)
    rep = simulate_genome(600, seed=85)
    g = core[:30_000] + rep + core[30_000:60_000] + rep + core[60_000:]
    sim = simulate_reads(g, 512, read_len=150, sub_rate=0.02, seed=86)
    reads = list(sim.reads) + [g[1_000 * k: 1_000 * k + 75]
                               + g[50_000 + 900 * k: 50_075 + 900 * k]
                               for k in range(16)]
    idx = build_index([("g", g)])
    al = Aligner.build(idx, AlignOptions(), device="cuda", seeder="kmer")
    if request.param == "int64":
        fm = kfm.FMDevice.from_host(idx, "cuda", rank_dtype=torch.int64)
        al = dataclasses.replace(al, fm=fm, jump=build_r3_jump(fm))
    calls = []
    build.reset_launches()
    with kc.recording(calls):
        al.device_regions(pack_reads(reads, [f"r{i}" for i in
                                             range(len(reads))]))
    return calls[0], dict(build.LAUNCHES)


def test_device_step_launches_the_kernel(recorded):
    call, launches = recorded
    assert launches["kmer_seed"] == 1 and launches["seed_sw"] == 0
    assert launches["sw_extend"] >= 1 and call.args["codes"].is_cuda


def test_kernel_equals_plain_on_a_recorded_batch(recorded):
    out = _check(recorded[0])
    assert (out["n_mem"] > 0).sum() > 400


@pytest.mark.parametrize("name", list(kc.EDGE_CAPS))
def test_kernel_equals_plain_on_edge_calls(name):
    _card()
    call = dict(kc.edge_calls("cuda"))[name]
    _check(call)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_kernel_equals_plain_on_random_calls(seed):
    _card()
    for call in kc.random_calls(seed, "cuda"):
        _check(call)
