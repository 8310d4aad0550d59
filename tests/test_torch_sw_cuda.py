"""The hand-written CUDA SW kernel equals its plain PyTorch version on
the card (all six outputs, exactly), and the port's pipeline gives the
same host dict on the card as on the CPU. Skips without a CUDA device.
Imports no jax, so it runs on a card machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sw_cuda.py``."""

import numpy as np
import pytest
import torch

from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.cpu.ksw import fill_scmat
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels.sw import FIELDS, sw_extend_batch
from bioseqdb_tpu_torch.kernels.sw_cuda import sw_extend_cuda
from bioseqdb_tpu_torch.utils.sim import simulate_genome, simulate_reads

pytestmark = pytest.mark.cuda


def _pack(cases, max_qlen, max_tlen):
    B = len(cases)
    q = np.full((B, max_qlen), 4, np.int32)
    t = np.full((B, max_tlen), 4, np.int32)
    qlen, tlen, h0 = (np.zeros(B, np.int32) for _ in range(3))
    for i, (qq, tt, hh) in enumerate(cases):
        q[i, : len(qq)] = qq
        t[i, : len(tt)] = tt
        qlen[i], tlen[i], h0[i] = len(qq), len(tt), hh
    return q, qlen, t, tlen, h0


def _cases(seed, n, max_q, max_t, codes=4, related=0.6, indel=False):
    """The test_sw_pallas.py generators: random pairs, a share of them
    a mutated copy (with an indel when asked); ``codes=5`` adds
    ambiguous bases."""
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n):
        ql = int(rng.integers(1, max_q))
        tl = int(rng.integers(1, max_t))
        qq = rng.integers(0, codes, ql)
        tt = rng.integers(0, codes, tl)
        if rng.random() < related and tl >= ql:
            tt[:ql] = qq
            for _ in range(int(rng.integers(0, 4))):
                tt[int(rng.integers(0, ql))] = rng.integers(0, codes)
            if indel and ql > 8:
                p = int(rng.integers(2, ql - 4))
                tt = np.delete(tt, slice(p, p + 3))
        cases.append((qq, tt, int(rng.integers(1, 60))))
    return cases


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _both(dev, cases, w=100, end_bonus=5, zdrop=100, max_qlen=64,
          max_tlen=128, a=1, b=4):
    q, qlen, t, tlen, h0 = (torch.from_numpy(x).to(dev)
                            for x in _pack(cases, max_qlen, max_tlen))
    B = q.shape[0]
    w0 = torch.full((B,), w, dtype=torch.int32, device=dev)
    mat = torch.from_numpy(fill_scmat(a, b)).to(dev)
    ref = sw_extend_batch(q, qlen, t, tlen, mat, 6, 1, 6, 1, w0, end_bonus,
                          zdrop, h0, max_qlen)
    n0 = build.LAUNCHES["sw_extend"]
    got = sw_extend_cuda(q, qlen, t, tlen, w0, h0, match_score=a,
                         mismatch_penalty=b, o_del=6, e_del=1, o_ins=6,
                         e_ins=1, end_bonus=end_bonus, zdrop=zdrop)
    torch.cuda.synchronize()
    assert build.LAUNCHES["sw_extend"] == n0 + 1
    for f in FIELDS:
        assert torch.equal(ref[f], got[f]), f


@pytest.mark.parametrize("kind", ["random", "narrow", "zdrop", "ambiguous",
                                  "ragged"])
def test_kernel_equals_plain(dev, kind):
    cases = dict(
        random=_cases(1, 24, 50, 90), narrow=_cases(2, 16, 40, 60, related=0),
        zdrop=_cases(2, 16, 40, 60, related=0),
        ambiguous=_cases(3, 16, 30, 60, codes=5, indel=True),
        ragged=_cases(4, 11, 20, 30))[kind]
    kw = dict(narrow=dict(w=3), zdrop=dict(zdrop=5)).get(kind, {})
    _both(dev, cases, **kw)


@pytest.mark.parametrize("a,b,w", [(1, 4, 100), (2, 3, 7)])
def test_kernel_main_path_width(dev, a, b, w):
    rng = np.random.default_rng(a + w)
    cases = []
    for _ in range(2048):
        ql = int(rng.integers(0, 153))
        qq = rng.integers(0, 5, ql)
        tt = np.concatenate([qq, rng.integers(0, 4, int(rng.integers(0, 400)))])
        m = rng.random(tt.size) < 0.03
        tt[m] = rng.integers(0, 4, m.sum())
        cases.append((qq, tt[:616], int(rng.integers(0, 160))))
    _both(dev, cases, w=w, max_qlen=152, max_tlen=616, a=a, b=b)


def test_kernel_rejects_bad_inputs(dev):
    q = torch.zeros(4, 8, dtype=torch.int64, device=dev)
    v = torch.zeros(4, dtype=torch.int32, device=dev)
    kw = dict(match_score=1, mismatch_penalty=4, o_del=6, e_del=1, o_ins=6,
              e_ins=1, end_bonus=5, zdrop=100)
    with pytest.raises(ValueError):
        sw_extend_cuda(q, v, q.int(), v, v, v, **kw)
    with pytest.raises(ValueError):
        sw_extend_cuda(q.int().cpu(), v.cpu(), q.int().cpu(), v.cpu(),
                       v.cpu(), v.cpu(), **kw)


def test_pipeline_cuda_equals_cpu(dev):
    g = simulate_genome(80_000, seed=71)
    idx = build_index([("g", g)])
    sim = simulate_reads(g, 200, read_len=150, sub_rate=0.01, seed=72)
    batch = pack_reads(sim.reads, sim.names)
    n0 = build.LAUNCHES["sw_extend"]
    on_card = Aligner.build(idx, AlignOptions(), device=dev).device_regions(batch)
    assert build.LAUNCHES["sw_extend"] > n0
    on_cpu = Aligner.build(idx, AlignOptions(), device="cpu").device_regions(batch)
    for k in ("n_regs", "overflow", "l_rep", "off"):
        assert np.array_equal(on_card[k], on_cpu[k]), k
    for k, v in on_cpu["regs"].items():
        assert np.array_equal(on_card["regs"][k], v), k
