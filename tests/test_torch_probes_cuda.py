"""The probe kernels (csrc/probes.cu) equal their plain PyTorch versions
on the card, exactly, and count their launches. Skips without a CUDA
device. Imports no jax, so it runs on a card machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_probes_cuda.py``."""

import pytest
import torch

from bioseqdb_tpu_torch.kernels import build, probes
from bioseqdb_tpu_torch.tools import microbench_gather, microbench_seed

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _table(dev, n, c, lanes, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    tab = torch.randint(0, 1 << 20, (n, c), generator=g, dtype=torch.int32,
                        device=dev)
    idx = torch.randint(0, n, (lanes,), generator=g, dtype=torch.int32,
                        device=dev)
    return tab, idx


@pytest.mark.parametrize("n,c,lanes", [(20480, 16, 8192), (71_875, 12, 999),
                                       (37, 4, 5), (1000, 128, 1)])
def test_gather_rows(dev, n, c, lanes):
    tab, idx = _table(dev, n, c, lanes)
    idx[0] = -3          # clamped, as the plain version clamps
    n0 = build.LAUNCHES["gather_rows"]
    got = probes.gather_rows_cuda(tab, idx)
    torch.cuda.synchronize()
    assert build.LAUNCHES["gather_rows"] == n0 + 1
    assert torch.equal(got, probes.gather_rows_plain(tab, idx))


# every variant a table can run (shared memory only where it fits)
CHAIN_CASES = [(v, n, c, lanes, steps)
               for n, c, lanes, steps in [(16384, 128, 128, 300),
                                          (71_875, 12, 1000, 50),
                                          (300, 12, 130, 0)]
               for v in microbench_seed.variants_for(probes.chain_mask(n))]


@pytest.mark.parametrize("variant,n,c,lanes,steps", CHAIN_CASES)
def test_gather_chain(dev, variant, n, c, lanes, steps):
    kw = microbench_seed.VARIANTS[variant]
    mask = probes.chain_mask(n)
    tab, idx = _table(dev, n, c, lanes, seed=steps)
    n0 = build.LAUNCHES["gather_chain"]
    got = probes.gather_chain_cuda(tab, idx, steps, mask, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES["gather_chain"] == n0 + 1
    assert torch.equal(got, probes.gather_chain_plain(tab, idx, steps, mask,
                                                      **kw))


def test_gather_chain_of_100(dev):
    tab, idx = _table(dev, 20480, 16, 4096)
    assert torch.equal(
        microbench_gather.gather_chain(probes.gather_rows_cuda, tab, idx),
        microbench_gather.gather_chain(probes.gather_rows_plain, tab, idx))


def test_add_one_eager_and_graph(dev):
    x = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    n0 = build.LAUNCHES["add_one"]
    assert torch.equal(probes.add_one_cuda(x), x + 1)
    assert build.LAUNCHES["add_one"] == n0 + 1
    probes.add_one_cuda(x)  # load the library outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = microbench_gather.launch_chain(probes.add_one_cuda, x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, x + microbench_gather.CHAIN)
