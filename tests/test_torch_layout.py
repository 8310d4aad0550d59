"""The port's device tables equal the JAX package's, byte for byte.

``bioseqdb_tpu_torch.index.layout`` carries jax-free copies of the JAX
host layout builders; this pins them to the originals: every
``FMDevice.from_host`` field, the packed doubled text and the minimizer
table (bmeta, entries, KmerMeta), plus the kmer sizing helpers and the
device hash."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from bioseqdb_tpu.align.options import AlignOptions
from bioseqdb_tpu.index.builder import build_index
from bioseqdb_tpu.kernels import fm as jfm
from bioseqdb_tpu.kernels import kmer as jkm
from bioseqdb_tpu.kernels.extend import pack_doubled_rows
from bioseqdb_tpu.utils.sim import simulate_genome
from bioseqdb_tpu_torch.index import layout
from bioseqdb_tpu_torch.kernels import kmer as tkm


@pytest.fixture(scope="module")
def idx():
    g1 = simulate_genome(70_000, seed=11)
    g2 = simulate_genome(9_000, seed=12)
    rep = g1[1000:1600]
    return build_index([("a", g1 + rep), ("b", rep + g2)])


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_fm_tables_equal_fmdevice(idx):
    t = layout.tables_from_host(idx, kmer=False)
    ref = jfm.FMDevice.from_host(idx)
    for f in layout.FM_FIELDS:
        assert _same(t[f], ref._asdict()[f]), f


def test_pac_rows_and_kmer_table_equal(idx):
    t = layout.tables_from_host(idx)
    assert _same(t["pac_rows"], pack_doubled_rows(idx.pac))
    host, meta = jkm.build_kmer_table(idx.pac)
    assert _same(t["bmeta"], host["bmeta"])
    assert _same(t["entries"], host["entries"])
    assert tuple(t["kmer_meta"]) == tuple(meta)
    # the port's cache returns the same table without the JAX package
    assert layout.kmer_table_arrays(idx)[0]["bmeta"] is t["bmeta"]


@pytest.mark.parametrize("n", [13, 1000, 4097])
def test_pack_oct_and_doubled_rows_random(n):
    rng = np.random.default_rng(n)
    blocks = rng.integers(-2**31, 2**31, (n, 12), dtype=np.int64).astype(np.int32)
    bits = rng.integers(-2**31, 2**31, (n + 3, 5), dtype=np.int64).astype(np.int32)
    assert _same(layout.pack_oct(blocks, bits), jfm.pack_oct(blocks, bits))
    assert _same(layout.pack_oct(blocks), jfm.pack_oct(blocks))
    pac = rng.integers(0, 4, n * 3, dtype=np.uint8)
    assert _same(layout.pack_doubled_rows(pac), pack_doubled_rows(pac))


def test_kmer_helpers_equal(idx):
    _, meta = layout.kmer_table_arrays(idx)
    for w in (20, 152, 320):
        assert layout.nmz_for(w) == jkm.nmz_for(w)
        for nmz in (48, layout.nmz_for(w)):
            assert layout.dmax_for(meta, nmz) == jkm.dmax_for(meta, nmz)
    for v in (0, 5, 20, 30):
        assert layout.smax_for(v) == jkm.smax_for(v)
    for opt in (AlignOptions(), AlignOptions(min_seed_len=15),
                AlignOptions(reseed_factor=1.0)):
        assert layout.kmer_eligible(idx, opt) == jkm.kmer_eligible(idx, opt)


def test_device_hash_and_minimizers_equal_host():
    rng = np.random.default_rng(3)
    h = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    dev = tkm.mix32(torch.from_numpy(h.astype(np.int64))).numpy()
    assert np.array_equal(dev.astype(np.uint32), layout._mix32(h))
    assert np.array_equal(layout._mix32(h), np.asarray(jkm._mix32(jnp.asarray(h))))
    codes = rng.integers(0, 4, 400, dtype=np.uint8)
    pos, km = layout._host_minimizer_positions(codes)
    jpos, jkmer = jkm._host_minimizer_positions(codes)
    assert np.array_equal(pos, jpos) and np.array_equal(km, jkmer)
    hh = torch.from_numpy(layout._mix32(km).astype(np.int64))[None, :]
    sel = tkm.select_minimizers(hh, hh.shape[1] - layout.WIN + 1)[0].numpy()
    assert np.array_equal(np.flatnonzero(sel), pos)
