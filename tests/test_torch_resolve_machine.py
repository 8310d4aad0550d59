"""Seed resolution split into CUDA kernels around the SA walk
(csrc/resolve.cu: ``resolve_expand``, ``resolve_finish``) and its plain
twin, on the CPU (the kernels themselves run only on the card:
``tests/test_torch_resolve_cuda.py``).

- The edge set (``tools/resolve_calls.py`` ``edge_calls``, on an index at
  SA interval 32) holds the cases it was made for: the compaction cap
  flooded at ``compact_cap`` 4,096 and at (B x S) // 4, position rows
  mixed with rank rows, intervals sampled past ``max_occ``, reads whose
  intervals hold more than S seeds, seeds bridging l_pac and reference
  ends, B x S <= 4,096, and the M and S of 8 kb, 18 kb and 25 kb reads
  and of the 18 kb fat retry (the intervals of a read past a block's
  shared memory: a scratch in device memory).
- JAX parity: ``resolve_seeds_plain`` equals the JAX package's
  ``resolve_seeds`` on the edge set (int32), every read where the JAX
  compaction buffer has no quirk: where a cap cuts, the JAX scatter gives
  the last kept lane's slot to the last valid lane, so there the overflow
  mask and the reads that neither overflow nor hold that lane are
  compared.
- The kernels' lane bodies, compiled for the host with g++ (the source's
  host entries, the walk plain between them), equal the plain twin on
  the edge set and random intervals, int32, int64 and past 2^31.
- Dispatch: on CPU tensors ``resolve_seeds`` runs the plain twin and
  never builds or loads a library. The wrappers refuse CPU tensors,
  wrong dtypes and shapes and an empty M (ValueError) before they touch
  one, and take any M (a scratch past a block's shared memory); the host
  entries refuse an argument array of the wrong length. The constants of
  ``csrc/resolve.cu`` equal the module's.
The plain twin runs on one intra-op thread. Integer programs: tolerance
0."""

import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioseqdb_tpu.index.builder import build_index as jbuild_index
from bioseqdb_tpu.kernels import chain as jch
from bioseqdb_tpu.kernels import fm as jfm
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels import chain as kch
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels import resolve_cuda as rcu
from bioseqdb_tpu_torch.kernels.extend_cuda import array, bind
from bioseqdb_tpu_torch.tools import fm_calls as fc
from bioseqdb_tpu_torch.tools import resolve_calls as rc

RANKS = {"int32": torch.int32, "int64": torch.int64}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the plain twin's tensors are small, so one
    thread runs them faster than many, and far faster when test workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def es():
    return fc.edge_setup()


@pytest.fixture(scope="module")
def edge(es):
    return {r: rc.edge_calls(es, kfm.FMDevice.from_host(es.idx, "cpu",
                                                        rank_dtype=dt))
            for r, dt in RANKS.items()}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the lane bodies for the host")
    return rc.host_library(tmp_path_factory.mktemp("resolve_host"))


def _walking(c: rc.ResolveCall) -> int:
    """The rank lanes ``c`` would walk with no cap (the plain twin's
    compacted walk, counted)."""
    n = [0]
    walk = kfm.sa_resolve

    def counting(fm, ranks, *args, **kw):
        n[0] += ranks.numel() if kw.get("mask") is None else int(
            kw["mask"].sum())
        return walk(fm, ranks, *args, **kw)

    kfm.sa_resolve = counting
    try:
        kch.resolve_seeds_plain(**dict(c.args, compact_cap=None))
    finally:
        kfm.sa_resolve = walk
    return n[0]


def test_edge_set_holds_its_cases(edge):
    calls = edge["int32"]
    out = {n: c.run(plain=True) for n, c in calls.items()}
    for name in ("cap 4096 flooded", "cap (B x S) // 4 flooded", "cap 64"):
        c = calls[name]
        assert _walking(c) > c.cap, name
        assert out[name]["overflow"].any(), name
    assert calls["cap 4096 flooded"].cap == 4096
    B, _, S = calls["cap (B x S) // 4 flooded"].dims
    assert calls["cap (B x S) // 4 flooded"].cap == (B * S) // 4 < 4096
    B, _, S = calls["B x S <= 4096"].dims
    assert B * S <= 4096
    for name, c in calls.items():
        mems = c.args["mems"]
        live = (torch.arange(mems.shape[1])[None, :]
                < c.args["n_mem"][:, None])
        pos = live & (mems[:, :, 1] > 0)
        if name != "position rows only":
            assert pos.any() and (live & ~pos).any(), name
    mems = calls["max_occ 2"].args["mems"]
    assert (mems[:, :, 2] > 2).any()
    # more seeds than slots ("no cap" overflows only so); position rows
    # across l_pac and across the second reference's start, either strand
    c = calls["no cap"]
    assert out["no cap"]["overflow"].any()
    m = c.args["mems"]
    live = torch.arange(m.shape[1])[None, :] < c.args["n_mem"][:, None]
    k, n = m[:, :, 0], m[:, :, 4] - m[:, :, 3]
    rows = live & (m[:, :, 1] > 0)
    fm = c.fm
    h = int(fm.ref_offsets[1])
    for at in (fm.l_pac, h, fm.seq_len - h):
        assert (rows & (k < at) & (k + n > at)).any(), at


def _jax_fm(es):
    jidx = jbuild_index([("g", es.refs[0]), ("h", es.refs[1])],
                        sa_interval=es.idx.sa_interval)
    assert np.array_equal(jidx.sa_sample, es.idx.sa_sample)
    return jfm.FMDevice.from_host(jidx, rank_dtype=jnp.int32)


def _quirk_read(host_lib, c: rc.ResolveCall) -> int | None:
    """The read that holds the cap's last kept rank lane (compact
    position cap - 1), where the cap cuts: the JAX scatter writes that
    lane's slot from the batch's last walking lane (ROADMAP queue 3), so
    the read keeps a wrong seed there even when it does not overflow."""
    ex, args, _ = rcu.expand_args(*c._expand_inputs())
    assert bind(host_lib, "resolve_expand_host", stream=False)(
        array(args), len(args)) == 0
    walk = ex["walk"].reshape(-1)
    if int(walk.sum()) <= c.cap:
        return None
    lane = int(torch.nonzero(walk)[c.cap - 1])
    return lane // c.dims[2]


def test_plain_twin_equals_jax_on_the_edge_set(host_lib, es, edge):
    jf = _jax_fm(es)
    for name, c in edge["int32"].items():
        a = c.args
        if a["compact_cap"] is None:   # the JAX version always has a cap
            continue
        want = jch.resolve_seeds(
            jf, jnp.asarray(a["mems"].numpy()),
            jnp.asarray(a["n_mem"].numpy()),
            max_occ=a["max_occ"], max_seeds=a["max_seeds"],
            sa_interval=a["sa_interval"], compact_cap=a["compact_cap"])
        want = {k: np.asarray(v) for k, v in want.items()}
        got = {k: v.numpy() for k, v in c.run(plain=True).items()}
        ovf = want["overflow"]
        assert np.array_equal(ovf, got["overflow"]), name
        keep = ~ovf
        quirk = _quirk_read(host_lib, c)
        if quirk is None:   # nothing cut: every read
            keep[:] = True
        else:
            keep[quirk] = False
        for k in want:
            assert np.array_equal(want[k][keep], got[k][keep]), (name, k)


@pytest.mark.parametrize("rank", list(RANKS))
def test_host_build_equals_plain(host_lib, es, edge, rank):
    calls = dict(edge[rank])
    fm = kfm.FMDevice.from_host(es.idx, "cpu", rank_dtype=RANKS[rank])
    for seed in (1, 2):
        calls.update(rc.random_calls(es, fm, seed))
    if rank == "int64":
        calls.update({f"{n}, past 2^31": c.shifted()
                      for n, c in list(calls.items())})
    for name, c in calls.items():
        want = c.run(plain=True)
        assert rc.max_abs_err(c.host(host_lib), want) == 0, name
        if name.endswith("past 2^31"):
            assert int(want["rbeg"].max()) >= 2 ** 31, name


def test_cpu_dispatch_runs_the_plain_twin(edge, monkeypatch):
    def no_library(name):
        raise AssertionError(f"library {name} loaded on the CPU")

    monkeypatch.setattr(build, "library", no_library)
    n0 = {k: build.LAUNCHES[k] for k in build.RESOLVE_KERNELS}
    c = edge["int32"]["cap 4096 flooded"]
    assert rc.max_abs_err(c.run(), c.run(plain=True)) == 0
    assert all(build.LAUNCHES[k] == v for k, v in n0.items())


def test_wrappers_refuse_bad_inputs(edge, monkeypatch):
    monkeypatch.setattr(build, "library", None)   # never reached
    c = edge["int32"]["cap 64"]
    mems, n_mem, max_occ, S = c._expand_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        rcu.resolve_expand_cuda(mems, n_mem, max_occ, S)
    with pytest.raises(ValueError, match="n_mem"):
        rcu.resolve_expand_cuda(mems, n_mem.long(), max_occ, S)
    with pytest.raises(ValueError, match="mems"):
        rcu.resolve_expand_cuda(mems.float(), n_mem, max_occ, S)
    with pytest.raises(ValueError, match="M 0"):
        rcu.resolve_expand_cuda(torch.zeros(4, 0, 5, dtype=torch.int32),
                                torch.zeros(4, dtype=torch.int32), max_occ, S)
    # any M: past a block's shared memory a scratch, a read's row each
    for M, rdt, scratch in ((1536, torch.int32, False),
                            (1537, torch.int32, True),
                            (877, torch.int64, False),
                            (878, torch.int64, True)):
        _, args, tensors = rcu.expand_args(
            torch.zeros(4, M, 5, dtype=rdt),
            torch.zeros(4, dtype=torch.int32), max_occ, S)
        assert (args[len(rcu.EXPAND_ARGS)] != 0) == scratch, (M, rdt)
        if scratch:
            assert tensors[-1].numel() == 4 * rcu.expand_bytes(M, rdt)
        with pytest.raises(ValueError, match="CUDA"):
            rcu.resolve_expand_cuda(torch.zeros(4, M, 5, dtype=rdt),
                                    torch.zeros(4, dtype=torch.int32),
                                    max_occ, S)
    with pytest.raises(ValueError, match="max_occ 0"):
        rcu.resolve_expand_cuda(mems, n_mem, 0, S)
    ex, _, _ = rcu.expand_args(mems, n_mem, max_occ, S)
    pos = torch.zeros_like(ex["ranks"])
    with pytest.raises(ValueError, match="CUDA"):
        rcu.resolve_finish_cuda(c.fm, ex, pos, None, c.cap)
    with pytest.raises(ValueError, match="pos"):
        rcu.resolve_finish_cuda(c.fm, ex, pos[:, :-1], None, c.cap)
    with pytest.raises(ValueError, match="ends"):
        rcu.resolve_finish_cuda(c.fm, ex, pos, torch.zeros(
            pos.shape[0], dtype=torch.int32), c.cap)
    with pytest.raises(ValueError, match="index"):
        rcu.resolve_finish_cuda(c.fm, dict(ex, ranks=ex["ranks"].long()),
                                pos, None, c.cap)


def test_host_entries_refuse_a_wrong_argument_count(host_lib, edge):
    c = edge["int32"]["cap 64"]
    ex, args, _ = rcu.expand_args(*c._expand_inputs())
    pos = torch.zeros_like(ex["ranks"])
    _, fargs, _ = rcu.finish_args(c.fm, ex, pos, None, c.cap)
    for entry, a in (("resolve_expand", args), ("resolve_finish", fargs)):
        fn = bind(host_lib, f"{entry}_host", stream=False)
        assert fn(array(a[:-1]), len(a) - 1) == 1, entry
        assert fn(array(a + [0]), len(a) + 1) == 1, entry
        assert fn(array(a), len(a)) == 0, entry


def test_kernel_constants_equal_the_module():
    src = (build.CSRC / build.SOURCES["resolve"]).read_text()
    consts = {k: int(v, 0) for k, v in re.findall(
        r"constexpr (?:int|long long) (\w+) = (-?\w+);", src)}
    assert consts["kSmem"] == rcu.SMEM_BYTES
    for k in build.RESOLVE_KERNELS:
        assert f"LANE_ENTRY({k})" in src
        assert k in build.KERNELS and k in build.STEP_KERNELS
        assert k in build.LAUNCHES
