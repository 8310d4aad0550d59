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


def _read_like(rng, n, max_q, max_t):
    """Read-like pairs: a query and its mutated copy running on into
    random bases, h0 in [0, 160)."""
    cases = []
    for _ in range(n):
        qq = rng.integers(0, 5, int(rng.integers(1, max_q + 1)))
        tt = np.concatenate([qq, rng.integers(0, 4, int(rng.integers(0, max_t)))])
        m = rng.random(tt.size) < 0.03
        tt[m] = rng.integers(0, 4, m.sum())
        cases.append((qq, tt[:max_t], int(rng.integers(0, 160))))
    return cases


@pytest.mark.parametrize("a,b", [(1, 4), (2, 3)])
def test_kernel_int16_boundary(dev, a, b):
    """h0 + a * qlen from 200 below to 8 above the int16 limit, lanes in
    that order: the kernel's int32 arithmetic holds values past int16
    alike in whole warps and in one that mixes both sides."""
    rng = np.random.default_rng(31 + a)
    cases = [(qq, tt, 32767 - a * len(qq) + int(rng.integers(-200, 9)))
             for qq, tt, _ in _read_like(rng, 256, 152, 400)]
    cases.sort(key=lambda c: c[2] + a * len(c[0]))
    _both(dev, cases, max_qlen=160, max_tlen=400, a=a, b=b)


def test_kernel_wide_query(dev):
    """The widest query the kernel takes (Wq = 320)."""
    _both(dev, _read_like(np.random.default_rng(32), 512, 320, 640),
          max_qlen=320, max_tlen=640)


@pytest.mark.parametrize("wq,w,n", [
    pytest.param(321, 200, 256, id="321"),
    pytest.param(1504, 200, 256, id="1504"),
    pytest.param(2048, 200, 256, id="2048"),
    # past the ring layout's shared memory (12,468 at w 100, 10,420 at
    # 200): the wide layout, its query codes read from device memory
    *(pytest.param(wq, w, 24, id=f"{wq}-w{w}")
      for wq in (12469, 18000, 25000) for w in (100, 200))])
def test_kernel_long_query(dev, wq, w, n):
    """Query widths past 320 (long reads): H and E in a ring over the
    band, at the main band (w = 100) and the band-doubling retry's (w =
    200), with a lane at the full width, lanes up to it and lanes much
    shorter than it."""
    rng = np.random.default_rng(wq + w)
    wt = wq + 4 * 100 + 64
    cases = _read_like(rng, n, wq, wt)
    qq = rng.integers(0, 4, wq)
    cases[0] = (qq, np.concatenate([qq, rng.integers(0, 4, wt - wq)]), 30)
    _both(dev, cases, w=w, max_qlen=wq, max_tlen=wt)


def test_kernel_query_past_65535(dev):
    """Wq 70,000 with a short target: the wide layout's live columns are
    two 32-bit reductions, not 16-bit halves, so no width cap remains."""
    rng = np.random.default_rng(70)
    wq, wt = 70000, 96
    cases = []
    for k in range(16):
        qq = rng.integers(0, 4, wq - 1000 * k)
        tt = qq[:wt].copy()
        tt[rng.random(wt) < 0.05] = rng.integers(0, 4)
        cases.append((qq, tt, int(rng.integers(1, 60))))
    _both(dev, cases, w=200, max_qlen=wq, max_tlen=wt)


def test_kernel_retry_band(dev):
    """The band-doubling retry's band (w = 200) at the main path's
    widths."""
    _both(dev, _read_like(np.random.default_rng(33), 1024, 152, 624),
          w=200, max_qlen=160, max_tlen=624)


def test_kernel_few_active_lanes(dev):
    """A few active lanes among 16,384, as the retry launch has them:
    the idle lanes (qlen 0) must leave their outputs as the plain version
    does."""
    rng = np.random.default_rng(34)
    cases = [(np.zeros(0, np.int64), rng.integers(0, 4, 9), 30)] * 16384
    for k, c in zip(rng.choice(16384, 5, replace=False),
                    _read_like(rng, 5, 152, 624)):
        cases[int(k)] = c
    _both(dev, cases, max_qlen=160, max_tlen=624)


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
