"""The probe kernels' plain versions equal the TPU tools' own numpy
checks (tools/microbench_pallas_gather.py:77-79 and :87,
tools/microbench_mosaic_seed.py:73-78 and the formulas of ``make_a2``,
``make_d`` and ``make_e``), at small sizes, exactly; and the CUDA wrappers
refuse CPU tensors, other dtypes and bad shapes before they launch
anything."""

import numpy as np
import pytest
import torch

from bioseqdb_tpu_torch.kernels import build, probes
from bioseqdb_tpu_torch.tools import microbench_gather, microbench_seed


def _table(seed, n, c, lanes):
    rng = np.random.default_rng(seed)
    tab = rng.integers(0, 1 << 20, (n, c)).astype(np.int32)
    idx = rng.integers(0, n, lanes).astype(np.int32)
    return tab, idx


def _mosaic_ref(tab, idx, steps, mask, variant, salt=0):
    """The chain as microbench_mosaic_seed.py computes it (int64 numpy):
    its check for make_a, and the make_a2 / make_d / make_e step formulas;
    a salt adds s * salt at step s (the port's fresh-row variant)."""
    if variant == "e":  # lane 0 chained, lanes 1.. passed through
        v = np.int64(idx[0])
        for _ in range(steps):
            v = (v * 48271 + 11) & mask
        return np.concatenate([[v], idx[1:]]).astype(np.int32)
    j = idx.astype(np.int64) & mask
    for s in range(steps):
        if variant == "a":
            r0 = tab[j, 0]
        elif variant == "a2":
            j2 = (j * 40503 + 7) & mask
            r0 = tab[j, 0].astype(np.int64) + tab[j2, 0]
        else:  # "d": the loop floor, no load
            r0 = 7
        j = (j * 48271 + r0 + 11 + s * salt) & mask
    return j.astype(np.int32)


@pytest.mark.parametrize("n,c,lanes", [(64, 16, 24), (300, 12, 17),
                                       (20480, 16, 8)])
def test_gather_rows_plain_equals_tool_check(n, c, lanes):
    tab, idx = _table(n + c, n, c, lanes)
    got = probes.gather_rows_plain(torch.from_numpy(tab),
                                   torch.from_numpy(idx))
    assert np.array_equal(got.numpy(), tab[idx])


def test_gather_rows_plain_clamps_like_the_kernel():
    tab, _ = _table(3, 40, 8, 1)
    idx = np.array([-5, 0, 39, 40, 1000], np.int32)
    got = probes.gather_rows_plain(torch.from_numpy(tab),
                                   torch.from_numpy(idx))
    assert np.array_equal(got.numpy(), tab[np.clip(idx, 0, 39)])


def test_gather_chain_of_100_equals_tool_formula():
    n = 500
    tab, idx = _table(4, n, 16, 32)
    got = microbench_gather.gather_chain(
        probes.gather_rows_plain, torch.from_numpy(tab), torch.from_numpy(idx))
    ref = idx.astype(np.int64)
    for _ in range(microbench_gather.CHAIN):
        ref = (ref * 48271 + tab[ref][:, 0] + 11) % n
    assert np.array_equal(got.numpy(), ref.astype(np.int32))


@pytest.mark.parametrize("variant,rows,floor", [("a", 1, None),
                                                ("a2", 2, None),
                                                ("d", 1, "d"),
                                                ("e", 1, "e")])
@pytest.mark.parametrize("n,c,lanes,steps", [(256, 128, 16, 40),
                                             (1000, 12, 33, 25)])
def test_gather_chain_plain_equals_tool(variant, rows, floor, n, c, lanes,
                                        steps):
    tab, idx = _table(n + steps, n, c, lanes)
    mask = probes.chain_mask(n)
    got = probes.gather_chain_plain(torch.from_numpy(tab),
                                    torch.from_numpy(idx), steps, mask,
                                    rows=rows, floor=floor)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          _mosaic_ref(tab, idx, steps, mask, variant))


@pytest.mark.parametrize("variant,rows", [("a", 1), ("a2", 2)])
def test_gather_chain_plain_fresh(variant, rows):
    n, steps = 4096, 60
    tab, idx = _table(7, n, 12, 40)
    mask = probes.chain_mask(n)
    got = probes.gather_chain_plain(torch.from_numpy(tab),
                                    torch.from_numpy(idx), steps, mask,
                                    rows=rows, salt=probes.FRESH_SALT)
    assert np.array_equal(got.numpy(), _mosaic_ref(
        tab, idx, steps, mask, variant, salt=probes.FRESH_SALT))


@pytest.mark.parametrize("rows,floor", [(1, None), (2, None), (1, "d"),
                                        (1, "e")])
def test_gather_chain_plain_marks_rows_read(rows, floor):
    n, steps = 1000, 9
    tab, idx = _table(11, n, 12, 20)
    mask = probes.chain_mask(n)
    seen = torch.zeros(mask + 1, dtype=torch.bool)
    probes.gather_chain_plain(torch.from_numpy(tab), torch.from_numpy(idx),
                              steps, mask, rows=rows, floor=floor, seen=seen)
    want = np.zeros(mask + 1, bool)
    j = idx.astype(np.int64) & mask
    for _ in range(steps if floor is None else 0):
        want[j] = True
        r = tab[j, 0].astype(np.int64)
        if rows == 2:
            j2 = (j * 40503 + 7) & mask
            want[j2] = True
            r = r + tab[j2, 0]
        j = (j * 48271 + r + 11) & mask
    assert np.array_equal(seen.numpy(), want)


@pytest.mark.parametrize("n,mask", [(16384, 16383), (20480, 16383),
                                    (71_875, 65535),
                                    (48_437_500, (1 << 25) - 1), (1, 0)])
def test_chain_mask(n, mask):
    assert probes.chain_mask(n) == mask


def test_seed_variants_fit_shared_memory():
    assert set(microbench_seed.variants_for(16383)) == set(
        microbench_seed.VARIANTS)
    assert "1 row smem" not in microbench_seed.variants_for(65535)


def test_add_one_chain_plain():
    x = torch.from_numpy(np.arange(8 * 128, dtype=np.int32).reshape(8, 128))
    got = microbench_gather.launch_chain(probes.add_one_plain, x)
    assert torch.equal(got, x + microbench_gather.CHAIN)


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


@pytest.mark.parametrize("call,match", [
    (lambda: probes.gather_rows_cuda(_i32(8, 4), _i32(3)), "CUDA device"),
    (lambda: probes.gather_rows_cuda(_i32(8, 4).long(), _i32(3)), "int32"),
    (lambda: probes.gather_rows_cuda(_i32(4, 8).t(), _i32(3)), "int32"),
    (lambda: probes.gather_rows_cuda(_i32(8, 6), _i32(3)), "C % 4"),
    (lambda: probes.gather_rows_cuda(_i32(8), _i32(3)), "C % 4"),
    (lambda: probes.gather_rows_cuda(_i32(0, 4), _i32(3)), "non-empty"),
    (lambda: probes.gather_chain_cuda(_i32(8, 4), _i32(3), 5, 7),
     "CUDA device"),
    (lambda: probes.gather_chain_cuda(_i32(8, 4), _i32(3).float(), 5, 7),
     "int32"),
    (lambda: probes.gather_chain_cuda(_i32(8, 4), _i32(3, 1), 5, 7),
     "idx"),
    (lambda: probes.gather_chain_cuda(_i32(8, 4), _i32(3), 5, 7, rows=3),
     "rows"),
    (lambda: probes.gather_chain_cuda(_i32(8, 4), _i32(3), 5, 5), "mask"),
    (lambda: probes.gather_chain_cuda(_i32(8, 4), _i32(3), 5, 15), "mask"),
    (lambda: probes.gather_chain_cuda(_i32(1 << 17, 1), _i32(3), 5,
                                      (1 << 16) - 1, smem=True),
     "shared memory"),
    (lambda: probes.gather_chain_cuda(_i32(8, 4), _i32(3), 5, 7, smem=True,
                                      salt=3), "salt"),
    (lambda: probes.gather_chain_cuda(_i32(8, 4), _i32(3), 5, 7, floor="d",
                                      salt=3), "floor"),
    (lambda: probes.gather_chain_cuda(_i32(8, 4), _i32(3), 5, 7, floor="e",
                                      rows=2), "floor"),
    (lambda: probes.gather_chain_cuda(_i32(8, 4), _i32(3), 5, 7, floor="e",
                                      smem=True), "floor"),
    (lambda: probes.gather_chain_cuda(_i32(8, 4), _i32(3), 5, 7, floor="x"),
     "floor"),
    (lambda: probes.gather_chain_cuda(_i32(8, 4), _i32(3), 5, 7,
                                      salt=2**31), "salt"),
    (lambda: probes.add_one_cuda(_i32(8, 128)), "CUDA device"),
    (lambda: probes.add_one_cuda(_i32(8, 128).float()), "int32"),
])
def test_wrappers_reject(call, match):
    before = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        call()
    assert build.LAUNCHES == before
