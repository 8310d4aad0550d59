"""The seed-SW filter's CUDA kernel (csrc/seedsw.cu) and its plain twin, on
the CPU (the kernel itself runs only on the card:
``tests/test_torch_seedsw_cuda.py``).

- The kernel's lane bodies, compiled for the host with g++ (the source's
  host entry runs the warp's 32 threads in turn), equal the plain twin
  score for score: on ``tools/seedsw_calls.py``'s edge filter calls
  (default scores; asymmetric gaps with a min_chain_weight) and its
  hand-made windows (tlen and qlen 0, 1, 2, 199; windows outside the
  read and the text), int32 and int64 ranks, int64 also past 2^31, and
  on a recorded long-read batch; skipped without g++.
- Lane independence: the filter on the reads in reverse order, as two
  halves and read by read equals the whole batch's run read for read,
  with the twin and with the host build.
- JAX parity: on the edge filter calls, int32 and int64 ranks, the plain
  filter equals the JAX package's ``seed_sw_filter`` (valid and score).
- Dispatch: on CPU tensors ``seed_sw_filter`` runs the twin and never
  builds or loads a kernel library.
- The wrapper refuses wrong dtypes, shapes, layouts and devices
  (ValueError) before it touches a library.
- The constants of ``csrc/seedsw.cu`` equal the Python modules'.
Integer programs: tolerance 0."""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioseqdb_tpu.kernels import fm as jfm
from bioseqdb_tpu.kernels import seedsw as jsw
from bioseqdb_tpu_torch.align import pipeline
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import build, seedsw
from bioseqdb_tpu_torch.kernels import seedsw_cuda as scu
from bioseqdb_tpu_torch.tools import seedsw_calls as sc
from bioseqdb_tpu_torch.utils.sim import simulate_genome, simulate_reads

DTYPES = [torch.int32, torch.int64]
SW_KW = ("match_score", "mismatch_penalty", "o_del", "e_del", "o_ins",
         "e_ins", "min_chain_weight")


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
def setup():
    return sc.edge_setup()


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    try:
        return sc.host_library(tmp_path_factory.mktemp("seedsw_host"))
    except RuntimeError as e:
        pytest.skip(f"needs g++ to build the lane bodies for the host: {e}")


@pytest.fixture(scope="module")
def recorded():
    """The seed_sw_filter call of a CPU batch of long reads on a 20 kb
    genome: four 740 bp reads at 1% substitutions and one of 730 bp."""
    g = simulate_genome(20_000, seed=91)
    reads = list(simulate_reads(g, 4, read_len=740, sub_rate=0.01,
                                seed=92).reads) + [g[1_000:1_730]]
    al = Aligner.build(build_index([("g", g)]), AlignOptions(), device="cpu")
    calls = []
    with sc.recording(calls):
        al.device_regions(pack_reads(reads, [f"r{i}" for i in
                                             range(len(reads))]))
    assert len(calls) == 1
    return calls[0]


def _filter_calls(setup, rdt):
    return sc.edge_calls(rdt, setup=setup)


@pytest.mark.parametrize("rank_dtype", DTYPES)
def test_host_build_equals_plain_on_edge_filter_calls(host_lib, setup,
                                                      rank_dtype):
    for name, call in _filter_calls(setup, rank_dtype):
        st = call.stage()
        want = st.run(plain=True)
        assert sc.max_abs_err(st.host(host_lib), want) == 0, name
        assert (want > 0).sum() > 40, name


@pytest.mark.parametrize("rank_dtype,shift", [(torch.int32, False),
                                              (torch.int64, False),
                                              (torch.int64, True)])
def test_host_build_equals_plain_on_edge_windows(host_lib, setup, rank_dtype,
                                                 shift):
    for name, call in sc.edge_score_calls(rank_dtype, setup=setup):
        if shift:
            call = call.shifted()
            assert int(call.args["win"]["rb"].min()) >= 2 ** 31
        want = call.run(plain=True)
        assert sc.max_abs_err(call.host(host_lib), want) == 0, name
        if not shift:
            assert int(want.max()) >= 150, name   # a full 199-wide window


def test_host_build_equals_plain_on_a_recorded_batch(host_lib, recorded):
    st = recorded.stage()
    want = st.run(plain=True)
    assert sc.max_abs_err(st.host(host_lib), want) == 0
    assert st.counts()["lanes"] > 100


def test_edge_calls_reach_every_case(setup):
    idx, g, codes, lens, seeds, kinds, _ = setup
    (_, call), (_, asym) = _filter_calls(setup, torch.int32)
    out, win = call.run(plain=True), call.stage().args["win"]
    S = seeds["rbeg"].shape[1]
    need = win["need"].reshape(-1, S)
    row = {k: kinds.index(k) for k in kinds}
    # only reads at or above the activation length are re-scored
    assert not need[row["below_active"]].any() and need[row["at_active"]].any()
    assert int(lens[row["at_active"]]) == sc.ACTIVE_LEN
    # the min_hsp read: a score exactly at min_hsp keeps its seed, one
    # below drops it
    r = row["min_hsp"]
    assert out["score"][r, :2].tolist() == [36, 35]
    assert out["valid"][r, :2].tolist() == [True, False]
    # windows clipped at l_pac from either side, and at reference ends
    l_pac = idx.l_pac
    rb, re = win["rb"].reshape(-1, S), win["re"].reshape(-1, S)
    strand = need[row["strand"]]
    assert ((re[row["strand"]] == l_pac) & strand).any()
    assert ((rb[row["strand"]] == l_pac) & strand).any()
    ref_end = need[row["ref_end"]]
    a_end = len(g) - 2_500
    assert ((re[row["ref_end"]] == a_end) & ref_end).any()
    assert ((rb[row["ref_end"]] == a_end) & ref_end).any()
    # a 199-wide query window, and 200 bp seeds left alone
    assert ((win["qe"] - win["qb"]) == 199)[win["need"]].any()
    long_seed = seeds["valid"] & (seeds["len"] >= 200)
    assert long_seed.any() and not need[long_seed].any()
    assert (out["valid"] != seeds["valid"]).any()
    assert asym.args["min_chain_weight"] > 0


def _lanes_run(call: sc.FilterCall, run) -> None:
    whole = run(call)
    B = call.args["codes"].shape[0]
    rev = torch.arange(B - 1, -1, -1)
    got = run(call.lanes(rev))
    assert sc.max_abs_err({k: got[k][rev] for k in ("valid", "score")},
                          whole) == 0
    halves = [run(call.lanes(slice(0, B // 2))),
              run(call.lanes(slice(B // 2, B)))]
    assert sc.max_abs_err({k: torch.cat([h[k] for h in halves])
                           for k in ("valid", "score")}, whole) == 0
    for b in range(B):
        one = run(call.lanes(slice(b, b + 1)))
        assert sc.max_abs_err(one, {k: whole[k][b: b + 1]
                                    for k in ("valid", "score")}) == 0, b


@pytest.mark.parametrize("case", ["edge", "recorded"])
def test_lanes_are_independent(host_lib, setup, recorded, case):
    call = recorded if case == "recorded" else _filter_calls(
        setup, torch.int32)[0][1]

    def host(c):
        st = c.stage()
        score = st.host(host_lib)
        win = st.args["win"]
        B, S = c.args["seeds"]["rbeg"].shape
        keep = ~win["need"] | (score >= win["min_hsp"])
        slen = c.args["seeds"]["len"].reshape(-1)
        return dict(valid=(c.args["seeds"]["valid"].reshape(-1) & keep
                           ).reshape(B, S),
                    score=torch.where(win["need"], score,
                                      slen * c.args["match_score"]
                                      ).reshape(B, S).to(torch.int32))

    _lanes_run(call, lambda c: c.run(plain=True))
    _lanes_run(call, host)


@pytest.mark.parametrize("rank_dtype", DTYPES)
def test_plain_filter_equals_jax_on_edge_calls(setup, rank_dtype):
    idx = setup[0]
    jf = jax.jit(jsw.seed_sw_filter, static_argnames=SW_KW)
    with jax.enable_x64(rank_dtype == torch.int64):
        jfmd = jfm.FMDevice.from_host(idx)
        for name, call in _filter_calls(setup, rank_dtype):
            a = call.args
            js = {k: jnp.asarray(v.numpy()) for k, v in a["seeds"].items()}
            assert js["rbeg"].dtype == (jnp.int64 if rank_dtype == torch.int64
                                        else jnp.int32)
            want = jax.device_get(jf(
                jfmd, jnp.asarray(a["pac_rows"].numpy()),
                jnp.asarray(a["codes"].numpy()),
                jnp.asarray(a["lens"].numpy()), js,
                **{k: a[k] for k in SW_KW}))
            got = call.run(plain=True)
            for k in ("valid", "score"):
                assert np.array_equal(np.asarray(want[k]), got[k].numpy()), (
                    name, k)


def test_cpu_dispatch_runs_the_plain_twin(setup, recorded, monkeypatch):
    def no_library(name):
        raise AssertionError(f"library {name} loaded on the CPU")

    monkeypatch.setattr(build, "library", no_library)
    n0 = build.LAUNCHES["seed_sw"]
    for call in (recorded, _filter_calls(setup, torch.int64)[1][1]):
        assert sc.max_abs_err(call.run(), call.run(plain=True)) == 0
    assert pipeline.seed_sw_filter is seedsw.seed_sw_filter
    assert build.LAUNCHES["seed_sw"] == n0


@pytest.mark.parametrize("field,value,match", [
    ("codes", lambda a: a["codes"].to(torch.int64), "codes"),
    ("codes", lambda a: a["codes"].t().contiguous().t(), "codes"),
    ("pac_rows", lambda a: a["pac_rows"].to(torch.int64), "pac_rows"),
    ("qb", lambda a: a["win"]["qb"].to(torch.int64), "qb"),
    ("re", lambda a: a["win"]["re"].to(torch.int64), "re"),
    ("need", lambda a: a["win"]["need"].to(torch.int32), "need"),
    ("rb", lambda a: a["win"]["rb"].to(torch.int16), "rb"),
    ("qe", lambda a: a["win"]["qe"][:-1], "qe"),
    ("codes", lambda a: a["codes"][:3], "multiple"),
])
def test_wrapper_refuses(monkeypatch, setup, field, value, match):
    monkeypatch.setattr(build, "library", None)   # never reached
    st = _filter_calls(setup, torch.int32)[0][1].stage()
    a = dict(st.args, win=dict(st.args["win"]))
    v = value(a)
    if field in ("codes", "pac_rows"):
        a[field] = v
    else:
        a["win"][field] = v
    with pytest.raises(ValueError, match=match):
        scu.seed_sw_cuda(**a)


def test_wrapper_refuses_cpu_tensors(monkeypatch, setup):
    monkeypatch.setattr(build, "library", None)   # never reached
    st = _filter_calls(setup, torch.int32)[0][1].stage()
    with pytest.raises(ValueError, match="CUDA"):
        scu.seed_sw_cuda(**st.args)


def test_kernel_constants_equal_the_modules():
    src = (build.CSRC / build.SOURCES["seedsw"]).read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert int(consts["kWidth"]) == scu.WIDTH == seedsw._W == 200
    assert int(consts["kWarp"]) * int(consts["kCols"]) >= scu.WIDTH
    assert consts["kNeg"] == "-(1 << 28)"
    assert "NEG = -(1 << 28)" in inspect.getsource(seedsw.local_sw_batch)
    assert "seed_sw" in build.KERNELS and "seed_sw" in build.STEP_KERNELS
    assert "LANE_ENTRY(seed_sw)" in src
