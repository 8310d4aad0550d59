"""The FM index's SA walk and backward search split into CUDA kernels
(csrc/fm.cu) and their plain twins, on the CPU (the kernels themselves
run only on the card: ``tests/test_torch_fm_cuda.py``).

- JAX parity: ``sa_resolve_plain`` and ``backward_search_plain`` equal
  the JAX package's ``sa_resolve`` and ``backward_search`` on
  ``tools/fm_calls.py``'s edge sets and random inputs (an index at bwa's
  SA interval of 32: rank 0, the primary, ``seq_len``, the dummy rank 1,
  marked ranks, ranks that need all 31 steps; empty, one-base,
  full-width, all-ambiguous and no-match reads, an ambiguous base at
  either end, repeats, a length past the width), int32 and int64 (under
  x64); the edge sets hold the cases they were made for.
- ``resolve_seeds``: the masked route (the kernels' on the card: every
  rank lane walks under a mask and the cap applies after the walk; here
  the host build of ``csrc/resolve.cu`` around the plain walk) equals
  the plain twin's compacting route at ``compact_cap`` 0, 4096, None and
  a cap that truncates, the whole dict (``overflow`` included), on
  synthetic seed intervals and on a recorded pipeline call; skipped
  without g++.
- The kernels' lane bodies, compiled for the host with g++ (the source's
  host entries), equal the plain twins on the edge sets (masked, off the
  table, many major checkpoints, an unmarked primary rank, past 2^31),
  random inputs and the calls a pipeline batch (full
  and exact mode) recorded; skipped without g++.
- Lane independence, the premise of a thread a lane.
- Dispatch: on CPU tensors ``sa_resolve``, ``backward_search`` and
  ``resolve_seeds`` run the plain twins and never build or load a
  library. The wrappers refuse CPU tensors and wrong dtypes
  (ValueError) before they touch one. The constants of ``csrc/fm.cu``
  and ``csrc/occ.cuh`` equal the Python modules'.
The plain twins run on one intra-op thread. Integer programs: tolerance
0."""

import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioseqdb_tpu.index.builder import build_index as jbuild_index
from bioseqdb_tpu.kernels import fm as jfm
from bioseqdb_tpu_torch.align import pipeline as tpipe
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels import chain as tch
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels import fm_cuda
from bioseqdb_tpu_torch.tools import fm_calls as fc
from bioseqdb_tpu_torch.tools import resolve_calls as rc
from bioseqdb_tpu_torch.utils.sim import simulate_reads

RANKS = {"int32": torch.int32, "int64": torch.int64}
CAPS = {"0": 0, "4096": 4096, "None": None, "64": 64}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the plain twins' tensors are small, so one
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
def fms(es):
    return {r: kfm.FMDevice.from_host(es.idx, "cpu", rank_dtype=dt)
            for r, dt in RANKS.items()}


@pytest.fixture(scope="module")
def recorded(es):
    """A pipeline batch on the edge index (SA interval 32), on the CPU:
    80 simulated 150 bp reads at 2% substitutions and 8 repeat reads
    through the kmer seeder's ``device_regions`` (80 x 64 seed slots:
    ``resolve_seeds``' compacting branch), then exact mode's
    ``align_batch``; every ``sa_resolve`` and ``backward_search`` call
    recorded, and the ``resolve_seeds`` calls' arguments."""
    g = es.refs[0]
    sim = simulate_reads(g, 80, read_len=150, sub_rate=0.02, seed=64)
    p = g.find(g[8000:8300])
    reads = list(sim.reads) + [g[p + 20 * k : p + 20 * k + 150]
                               for k in range(8)]
    batch = pack_reads(reads, [f"r{i}" for i in range(len(reads))])
    calls, resolves = [], []
    orig = tpipe.resolve_seeds

    def rec(*args, **kw):
        resolves.append((args, kw))
        return orig(*args, **kw)

    tpipe.resolve_seeds = rec
    try:
        with fc.recording(calls):
            Aligner = tpipe.Aligner
            Aligner.build(es.idx, AlignOptions(),
                          device="cpu").device_regions(batch)
            Aligner.build(es.idx, AlignOptions(), device="cpu",
                          mode="exact").align_batch(batch)
    finally:
        tpipe.resolve_seeds = orig
    return calls, resolves


def _jax_fm(es, rank):
    jidx = jbuild_index([("g", es.refs[0]), ("h", es.refs[1])],
                        sa_interval=es.idx.sa_interval)
    assert np.array_equal(jidx.sa_sample, es.idx.sa_sample)
    return jfm.FMDevice.from_host(
        jidx, rank_dtype=jnp.int64 if rank == "int64" else jnp.int32)


@pytest.mark.parametrize("rank", list(RANKS))
def test_plain_twins_equal_jax_on_edge_sets(es, fms, rank):
    fm = fms[rank]
    rnd = fc.random_calls(es, fm, 1)
    ranks = torch.cat([torch.from_numpy(es.ranks).to(fm.rank_dtype),
                       rnd["random ranks 1"].args["ranks"]])
    rb = rnd["random reads 1"].args
    codes = torch.cat([torch.from_numpy(es.codes), rb["codes"]])
    lens = torch.cat([torch.from_numpy(es.lens), rb["lens"]])
    pos = kfm.sa_resolve_plain(fm, ranks, es.idx.sa_interval)
    lo, hi = kfm.backward_search_plain(fm, codes, lens)
    with jax.enable_x64(rank == "int64"):
        jf = _jax_fm(es, rank)
        jpos = jax.jit(jfm.sa_resolve, static_argnums=2)(
            jf, jnp.asarray(ranks.numpy()), es.idx.sa_interval)
        jlo, jhi = jfm.backward_search(jf, jnp.asarray(codes.numpy()),
                                       jnp.asarray(lens.numpy()))
        jpos, jlo, jhi = jax.device_get((jpos, jlo, jhi))
    for want, got in ((jpos, pos), (jlo, lo), (jhi, hi)):
        assert got.dtype == fm.rank_dtype
        assert np.array_equal(np.asarray(want), got.numpy())
    # and the host index's scalar walk
    assert [es.idx.sa_at(int(r)) for r in es.ranks] == pos[
        : len(es.ranks)].tolist()


def test_edge_sets_hold_their_cases(es, fms):
    fm = fms["int32"]
    kind = np.array(es.rank_kinds)
    assert es.idx.sa_interval == 32
    assert (es.steps[kind == "marked"] == 0).all()
    assert (es.steps[kind == "all steps"] == 31).all()
    for k, steps in (("marked", 0), ("all steps", 31 * 12)):
        sel = torch.from_numpy(es.ranks[kind == k]).to(torch.int32)
        call = fc.FmCall.of("sa_resolve", fm, sel, es.idx.sa_interval)
        assert call.counts()["steps"] == steps, k
    assert {0, es.idx.primary, es.idx.seq_len, 1} <= set(es.ranks.tolist())
    lo, hi = kfm.backward_search_plain(fm, torch.from_numpy(es.codes),
                                       torch.from_numpy(es.lens))
    n = (hi - lo).numpy()
    rk = np.array(es.read_kinds)
    for k in ("empty", "all ambiguous", "ambiguous first", "ambiguous last",
              "no match"):
        assert (n[rk == k] == 0).all() and (lo.numpy()[rk == k] == 0).all()
    assert (n[rk == "repeat"] >= 2).any()
    assert (n[rk == "full width"] >= 1).all()
    assert (es.lens[rk == "full width"] == fc.EDGE_W).all()
    assert (es.lens[rk == "length past W"] > fc.EDGE_W).all()
    assert (n[rk == "simulated"] >= 1).all()
    assert (n[rk == "one base"] > 1000).all()


@pytest.fixture(scope="module")
def resolve_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the lane bodies for the host")
    return rc.host_library(tmp_path_factory.mktemp("resolve_host"))


def _resolve_both(resolve_lib, *args, **kw):
    """resolve_seeds through the masked route (the resolve kernels' lane
    bodies around the plain walk under their mask) and the compacting
    one (the plain twin)."""
    want = tch.resolve_seeds(*args, **kw)
    got = rc.ResolveCall.of(*args, **kw).host(resolve_lib)
    return got, want


@pytest.mark.parametrize("rank", list(RANKS))
@pytest.mark.parametrize("cap", list(CAPS))
def test_resolve_seeds_masked_route_equals_compacting(es, fms, resolve_lib,
                                                     rank, cap):
    fm = fms[rank]
    mems, n_mem = fc.synthetic_mems(es)
    got, want = _resolve_both(resolve_lib, fm, mems.to(fm.rank_dtype), n_mem,
                              max_occ=500, max_seeds=64,
                              sa_interval=es.idx.sa_interval,
                              compact_cap=CAPS[cap])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    full = tch.resolve_seeds(fm, mems.to(fm.rank_dtype), n_mem, 500, 64,
                             es.idx.sa_interval, compact_cap=None)
    assert full["valid"].sum() > 2000
    # the small caps truncate lanes that the uncapped walk keeps
    assert (want["overflow"].sum() > full["overflow"].sum()) == (cap != "None")


def test_resolve_seeds_masked_route_on_a_recorded_call(recorded,
                                                       resolve_lib):
    _, resolves = recorded
    assert resolves
    for args, kw in resolves:
        B, S = args[1].shape[0], kw["max_seeds"]
        assert B * S > 4096
        for cap in CAPS.values():
            got, want = _resolve_both(resolve_lib, *args,
                                      **dict(kw, compact_cap=cap))
            for k in want:
                assert torch.equal(got[k], want[k]), (cap, k)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    try:
        return fc.host_library(tmp_path_factory.mktemp("fm_host"))
    except RuntimeError as e:
        pytest.skip(f"needs g++ to build the lane bodies for the host: {e}")


def _host_cases(es, fms, rank):
    fm = fms[rank]
    calls = fc.edge_calls(es, fm)
    for seed in (1, 2):
        calls.update(fc.random_calls(es, fm, seed))
    if rank == "int64":
        calls.update({f"past 2^31 {k}": c for k, c in fc.edge_calls(
            es, fc.shifted(fm)).items()})
    return calls


@pytest.mark.parametrize("rank", list(RANKS))
def test_host_build_equals_plain(host_lib, es, fms, rank):
    for name, call in _host_cases(es, fms, rank).items():
        want = call.run(plain=True)
        got = call.host(host_lib)
        assert fc.max_abs_err(got, want, call.kind) == 0, name
        if name.startswith("past 2^31"):
            key = "pos" if call.kind == "sa_resolve" else "hi"
            assert int(want[key].max()) >= 2 ** 31, name


def test_host_build_equals_plain_on_a_recorded_batch(host_lib, recorded):
    calls, _ = recorded
    kinds = [c.kind for c in calls]
    assert "backward_search" in kinds and kinds.count("sa_resolve") >= 2
    for call in calls:
        for rank in RANKS.values():
            c = call.replace(fm=call.fm._replace(**{
                k: getattr(call.fm, k).to(rank) for k in (
                    "L2", "occ_majors", "sa_majors", "sa_sample",
                    "ref_offsets", "ref_lens")}))
            assert fc.max_abs_err(c.host(host_lib), c.run(plain=True),
                                  c.kind) == 0, (c.kind, c.shape)


@pytest.mark.parametrize("rank", list(RANKS))
def test_lanes_are_independent(es, fms, rank):
    fm = fms[rank]
    for call in fc.random_calls(es, fm, 3, n_ranks=512, n_reads=64).values():
        whole = call.run(plain=True)
        key = "ranks" if call.kind == "sa_resolve" else "codes"
        n = call.args[key].shape[0]
        rev = torch.arange(n - 1, -1, -1)
        a = dict(call.args, **{key: call.args[key][rev]})
        if call.kind == "backward_search":
            a["lens"] = call.args["lens"][rev]
        back = fc.FmCall(call.kind, a).run(plain=True)
        for k, v in whole.items():
            assert torch.equal(back[k][rev], v)


def test_cpu_dispatch_runs_the_plain_twins(es, fms, recorded, monkeypatch):
    def no_library(name):
        raise AssertionError(f"library {name} loaded on the CPU")

    monkeypatch.setattr(build, "library", no_library)
    n0 = dict(build.LAUNCHES)
    for call in fc.edge_calls(es, fms["int32"]).values():
        assert fc.max_abs_err(call.run(), call.run(plain=True),
                              call.kind) == 0
    for args, kw in recorded[1]:
        tch.resolve_seeds(*args, **kw)
    assert build.LAUNCHES == n0


def _edge(es, fms):
    calls = fc.edge_calls(es, fms["int32"])
    return calls["ranks masked"].args, calls["reads"].args


@pytest.mark.parametrize("field,dtype", [
    ("ranks", torch.int64), ("ranks", torch.int16), ("mask", torch.uint8),
    ("codes", torch.int64), ("codes", torch.uint8), ("lens", torch.int64)])
def test_wrappers_refuse_wrong_dtypes(es, fms, monkeypatch, field, dtype):
    monkeypatch.setattr(build, "library", None)   # never reached
    sa, bs = _edge(es, fms)
    fm = fms["int32"]
    with pytest.raises(ValueError, match=field):
        if field in ("ranks", "mask"):
            a = dict(sa, **{field: sa[field].to(dtype)})
            fm_cuda.sa_resolve_cuda(fm, a["ranks"], 32, a["mask"])
        else:
            a = dict(bs, **{field: bs[field].to(dtype)})
            fm_cuda.backward_search_cuda(fm, a["codes"], a["lens"])


def test_wrappers_refuse_cpu_tensors_and_odd_shapes(es, fms, monkeypatch):
    monkeypatch.setattr(build, "library", None)   # never reached
    sa, bs = _edge(es, fms)
    fm = fms["int32"]
    with pytest.raises(ValueError, match="CUDA"):
        fm_cuda.sa_resolve_cuda(fm, sa["ranks"], 32, sa["mask"])
    with pytest.raises(ValueError, match="CUDA"):
        fm_cuda.backward_search_cuda(fm, bs["codes"], bs["lens"])
    with pytest.raises(ValueError, match="1-D"):
        fm_cuda.sa_resolve_cuda(fm, sa["ranks"][None, :], 32)
    with pytest.raises(ValueError, match="mask"):
        fm_cuda.sa_resolve_cuda(fm, sa["ranks"], 32, sa["mask"][:-1])
    with pytest.raises(ValueError, match="lens"):
        fm_cuda.backward_search_cuda(fm, bs["codes"], bs["lens"][:-1])
    with pytest.raises(ValueError, match="sa_sample"):
        fm_cuda.sa_resolve_cuda(fm._replace(sa_sample=fm.sa_sample[:0]),
                                sa["ranks"], 32)
    with pytest.raises(ValueError, match="L2"):
        fm_cuda.sa_resolve_cuda(fm._replace(L2=fm.L2.long()), sa["ranks"],
                                32)
    with pytest.raises(ValueError, match="occ_majors"):
        fm_cuda.backward_search_cuda(fm._replace(
            occ_majors=fm.occ_majors.long()), bs["codes"], bs["lens"])


def test_kernel_constants_equal_the_modules():
    src = (build.CSRC / build.SOURCES["fm"]).read_text()
    assert '#include "occ.cuh"' in src
    occ = (build.CSRC / "occ.cuh").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src + occ)}
    assert consts["kLog2OccBlock"] == kfm.LOG2_OCC_BLOCK
    assert consts["kLog2Major"] == kfm.LOG2_MAJOR
    assert set(build.EXACT_KERNELS) == {"sa_resolve", "backward_search"}
    for k in build.EXACT_KERNELS:
        assert f"LANE_ENTRY({k})" in src
        assert k in build.KERNELS and k in build.LAUNCHES
        assert k in build.PATH_KERNELS
    assert "sa_resolve" in build.STEP_KERNELS
    assert "backward_search" not in build.STEP_KERNELS
