"""FM-index rank queries: the port equals the JAX kernels exactly.

Random ranks go through ``bioseqdb_tpu.kernels.fm`` (jnp on the CPU)
and ``bioseqdb_tpu_torch.kernels.fm`` (torch on the CPU): occ4, LF
steps, SA resolution, bi-interval extensions, position/strand and
reference lookups."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from bioseqdb_tpu.index.builder import build_index
from bioseqdb_tpu.kernels import fm as jfm
from bioseqdb_tpu.utils.sim import simulate_genome
from bioseqdb_tpu_torch.kernels import fm as tfm


@pytest.fixture(scope="module")
def fms():
    refs = [(f"r{i}", simulate_genome(n, seed=20 + i))
            for i, n in enumerate((40_000, 7_000, 15_000))]
    idx = build_index(refs)
    return idx, jfm.FMDevice.from_host(idx), tfm.FMDevice.from_host(idx, "cpu")


def _ranks(idx, n, seed):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, idx.seq_len + 2, n).astype(np.int32)
    r[:4] = [0, idx.primary, idx.primary + 1, idx.seq_len + 1]
    return r


def _eq(a, b):
    assert np.array_equal(np.asarray(a), b.numpy()), (np.asarray(a), b)


def test_occ4_and_occB(fms):
    idx, jf, tf = fms
    r = _ranks(idx, 3000, 1)
    _eq(jfm.occ4B(jf, jnp.asarray(r)), tfm.occ4B(tf, torch.from_numpy(r)))
    c = np.random.default_rng(2).integers(0, 4, r.size).astype(np.int32)
    _eq(jfm.occB(jf, jnp.asarray(c), jnp.asarray(r)),
        tfm.occB(tf, torch.from_numpy(c), torch.from_numpy(r)))


def test_lf_step_and_sa_resolve(fms):
    idx, jf, tf = fms
    r = _ranks(idx, 2000, 3)
    r = np.clip(r, 0, idx.seq_len)
    _eq(jfm.lf_step(jf, jnp.asarray(r)), tfm.lf_step(tf, torch.from_numpy(r)))
    got = tfm.sa_resolve(tf, torch.from_numpy(r), idx.sa_interval)
    _eq(jfm.sa_resolve(jf, jnp.asarray(r), idx.sa_interval), got)
    # and against the host index's scalar reference
    assert [idx.sa_at(int(x)) for x in r[:50]] == got[:50].tolist()


def test_bi_interval_extensions(fms):
    idx, jf, tf = fms
    rng = np.random.default_rng(4)
    k = rng.integers(0, idx.seq_len, 1500).astype(np.int32)
    s = rng.integers(0, 300, 1500).astype(np.int32)
    s = np.minimum(s, idx.seq_len + 1 - k)
    l = rng.integers(0, idx.seq_len, 1500).astype(np.int32)
    J = [jnp.asarray(x) for x in (k, l, s)]
    T = [torch.from_numpy(x) for x in (k, l, s)]
    for jf_fn, tf_fn in ((jfm.fmd_extend_back, tfm.fmd_extend_back),
                         (jfm.fmd_extend_fwd, tfm.fmd_extend_fwd)):
        for a, b in zip(jf_fn(jf, *J), tf_fn(tf, *T)):
            _eq(a, b)
    lo, hi = np.minimum(k, l), np.maximum(k, l)
    c = rng.integers(0, 4, k.size).astype(np.int32)
    for a, b in zip(jfm.backward_ext(jf, jnp.asarray(lo), jnp.asarray(hi),
                                     jnp.asarray(c)),
                    tfm.backward_ext(tf, torch.from_numpy(lo),
                                     torch.from_numpy(hi),
                                     torch.from_numpy(c))):
        _eq(a, b)


def test_depos_and_rid_of(fms):
    idx, jf, tf = fms
    rng = np.random.default_rng(5)
    pos = rng.integers(0, idx.seq_len, 4000).astype(np.int32)
    ln = rng.integers(1, 200, 4000).astype(np.int32)
    jfwd, jrev = jfm.depos(jf, jnp.asarray(pos), jnp.asarray(ln))
    tfwd, trev = tfm.depos(tf, torch.from_numpy(pos), torch.from_numpy(ln))
    _eq(jfwd, tfwd)
    _eq(jrev, trev)
    fwd = np.clip(np.asarray(jfwd), 0, idx.l_pac - 1)
    _eq(jfm.rid_of(jf, jnp.asarray(fwd)), tfm.rid_of(tf, torch.from_numpy(fwd)))
