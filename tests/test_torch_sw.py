"""Banded SW extension: the port's plain ``sw_extend_batch`` equals the
JAX ``sw_extend_batch`` exactly (all six outputs), on the case
generators of test_sw_pallas.py plus a random sweep, and equals the
Pallas kernel (interpret mode) on one small case set."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from bioseqdb_tpu.cpu.ksw import fill_scmat
from bioseqdb_tpu.kernels.sw import sw_extend_batch as jsw
from bioseqdb_tpu.kernels.sw_pallas import sw_extend_batch_pallas
from bioseqdb_tpu_torch.kernels.sw import FIELDS, sw_extend_batch as tsw


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


def run_both(cases, w=100, end_bonus=5, zdrop=100, max_qlen=64, max_tlen=128,
             a=1, b=4, gaps=(6, 1, 6, 1), pallas=False):
    q, qlen, t, tlen, h0 = _pack(cases, max_qlen, max_tlen)
    B = len(cases)
    mat = fill_scmat(a, b).astype(np.int32)
    ref = jsw(jnp.asarray(q), jnp.asarray(qlen), jnp.asarray(t),
              jnp.asarray(tlen), jnp.asarray(mat), *gaps,
              jnp.full(B, w, jnp.int32), end_bonus, zdrop, jnp.asarray(h0),
              max_qlen)
    got = tsw(torch.from_numpy(q), torch.from_numpy(qlen), torch.from_numpy(t),
              torch.from_numpy(tlen), torch.from_numpy(mat), *gaps,
              torch.full((B,), w, dtype=torch.int32), end_bonus, zdrop,
              torch.from_numpy(h0), max_qlen)
    for f in FIELDS:
        assert np.array_equal(np.asarray(ref[f]), got[f].numpy()), f
    if pallas:
        pls = sw_extend_batch_pallas(
            jnp.asarray(q), jnp.asarray(qlen), jnp.asarray(t),
            jnp.asarray(tlen), jnp.full(B, w, jnp.int32), jnp.asarray(h0),
            match_score=a, mismatch_penalty=b, o_del=gaps[0], e_del=gaps[1],
            o_ins=gaps[2], e_ins=gaps[3], end_bonus=end_bonus, zdrop=zdrop,
            max_qlen=max_qlen, block_lanes=8, interpret=True)
        for f in FIELDS:
            assert np.array_equal(np.asarray(pls[f]), got[f].numpy()), f


def random_pairs(seed, n=24):
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n):
        ql = int(rng.integers(1, 50))
        tl = int(rng.integers(1, 90))
        qq = rng.integers(0, 4, ql)
        tt = rng.integers(0, 4, tl)
        if rng.random() < 0.6 and tl >= ql:
            tt[:ql] = qq
            for _ in range(int(rng.integers(0, 4))):
                tt[int(rng.integers(0, ql))] = rng.integers(0, 4)
        cases.append((qq, tt, int(rng.integers(1, 60))))
    return cases


def narrow_cases(seed=2):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 4, int(rng.integers(5, 40))),
             rng.integers(0, 4, int(rng.integers(5, 60))),
             int(rng.integers(10, 50))) for _ in range(16)]


def ambiguous_indel_cases(seed=3):
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(8):
        ql, tl = int(rng.integers(5, 30)), int(rng.integers(5, 40))
        cases.append((rng.integers(0, 5, ql), rng.integers(0, 5, tl),
                      int(rng.integers(10, 40))))
    for _ in range(8):
        tl = int(rng.integers(30, 60))
        tt = rng.integers(0, 4, tl)
        p = int(rng.integers(5, tl - 8))
        cases.append((np.concatenate([tt[:p], tt[p + 3 :]]), tt,
                      int(rng.integers(20, 60))))
    return cases


def test_random_pairs():
    run_both(random_pairs(1))


@pytest.mark.parametrize("kw", [dict(w=3), dict(zdrop=5), dict(zdrop=0)])
def test_narrow_band_and_zdrop(kw):
    run_both(narrow_cases(), **kw)


def test_ambiguous_and_indels():
    run_both(ambiguous_indel_cases())


def test_ragged_lane_count():
    rng = np.random.default_rng(4)
    run_both([(rng.integers(0, 4, 20), rng.integers(0, 4, 30), 25)
              for _ in range(11)])


@pytest.mark.parametrize("seed", range(4))
def test_random_sweep(seed):
    """Read-like pairs (a query and its mutated, indel-carrying target)
    at main-path widths, scoring and band options varied."""
    rng = np.random.default_rng(100 + seed)
    cases = []
    for _ in range(32):
        ql = int(rng.integers(0, 152))
        qq = rng.integers(0, 4, ql)
        tt = qq.copy()
        for _ in range(int(rng.integers(0, 6))):
            if tt.size > 4:
                p = int(rng.integers(0, tt.size))
                k = int(rng.integers(1, 5))
                tt = (np.delete(tt, slice(p, p + k)) if rng.random() < 0.5
                      else np.insert(tt, p, rng.integers(0, 4, k)))
        m = rng.random(tt.size) < 0.05
        tt[m] = rng.integers(0, 5, m.sum())
        tt = np.concatenate([tt, rng.integers(0, 4, int(rng.integers(0, 80)))])
        cases.append((qq, tt[:300], int(rng.integers(0, 160))))
    a, b = [(1, 4), (2, 3), (1, 1)][seed % 3]
    run_both(cases, w=[100, 16, 5, 33][seed], zdrop=[100, 30, 0, 7][seed],
             end_bonus=[5, 0, 3, 5][seed], max_qlen=152, max_tlen=300,
             a=a, b=b, gaps=[(6, 1, 6, 1), (5, 2, 4, 1)][seed % 2])


def test_pallas_interpret_agrees():
    run_both(random_pairs(5, n=12), pallas=True)


@pytest.mark.parametrize("w", [100, 2])
def test_count_cells(w):
    """``count_cells`` leaves the six outputs as they are and counts each
    lane's in-band cells: on identical sequences with a large h0 every
    band cell stays live and no row ends early, so row i counts
    min(qlen, i + w + 1) - max(0, i - w); a lane with nothing to align
    counts 0."""
    rng = np.random.default_rng(9)
    same = [rng.integers(0, 4, n) for n in (1, 7, 20, 33)]
    cases = [(s, s.copy(), 80) for s in same] + random_pairs(6, n=8)
    cases.append((np.zeros(0, np.int64), rng.integers(0, 4, 9), 30))
    q, qlen, t, tlen, h0 = (torch.from_numpy(x)
                            for x in _pack(cases, 64, 128))
    mat = torch.from_numpy(fill_scmat(1, 4).astype(np.int32))
    args = (q, qlen, t, tlen, mat, 6, 1, 6, 1,
            torch.full((len(cases),), w, dtype=torch.int32), 5, 100, h0, 64)
    plain, counted = tsw(*args), tsw(*args, count_cells=True)
    for f in FIELDS:
        assert torch.equal(plain[f], counted[f]), f
    cells = counted["cells"].numpy()
    for k, s in enumerate(same):
        n = len(s)
        assert cells[k] == sum(min(n, i + w + 1) - max(0, i - w)
                               for i in range(n)), k
    assert cells[-1] == 0
    assert (cells <= qlen.numpy().astype(np.int64) * tlen.numpy()).all()
