"""The seed-SW filter's CUDA kernel (csrc/seedsw.cu) and its plain twin, on
the CPU (the kernel itself runs only on the card:
``tests/test_torch_seedsw_cuda.py``).

- The whole filter's host build (``seed_sw_filter_host``: the window
  bounds, need test, SW and outputs of one launch, the warp's groups and
  a group's threads run in turn with the exchanges the shuffles make)
  equals ``seed_sw_filter_plain`` (valid and score) at each scoring of
  ``tools/seedsw_calls.py``'s ``SCORINGS`` (the defaults and asymmetric
  gaps with a min_chain_weight take the s16x2 body, ``WIDE`` the s32
  body): on the edge calls (activation length, min_hsp, windows at l_pac
  and reference ends, Ns), the fold calls (``fold_calls``: five
  references, two of 1 and 2 bases, reads at both activation lengths,
  min_chain_weight 0 and 20, query widths at the kernel's column
  boundaries, qlen 1, 2 and 199, tlen 1, 2 and 199, targets across l_pac
  and past reference ends with mid on either side, an all-N read) and
  random calls, int32 and int64 ranks and int64 past 2^31, and on a
  recorded long-read batch; skipped without g++. The activation table
  equals the windows' per-read values at every length; the edge and fold
  calls reach their cases.
- Lane independence: the filter on the reads in reverse order, as two
  halves and read by read equals the whole batch's run read for read,
  with the twin and with the host build.
- JAX parity: on the edge and the fold calls, int32 and int64 ranks, the
  plain filter equals the JAX package's ``seed_sw_filter`` (valid and
  score), so the host build is held to it through the twin.
- Dispatch: on CPU tensors ``seed_sw_filter`` runs the twin and never
  builds or loads a kernel library.
- The wrapper refuses wrong dtypes, shapes, layouts, rank tables and
  devices (ValueError) before it touches a library.
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


def _host_equals_plain(host_lib, calls, shift: bool = False) -> None:
    assert len(calls) == len(sc.SCORINGS)
    for name, call in calls:
        if shift:
            call = call.shifted()
            assert int(call.args["seeds"]["rbeg"].min()) >= 2 ** 31
        want = call.run(plain=True)
        assert sc.max_abs_err(call.host(host_lib), want) == 0, name


@pytest.mark.parametrize("rank_dtype", DTYPES)
def test_host_build_equals_plain_on_edge_filter_calls(host_lib, setup,
                                                      rank_dtype):
    calls = _filter_calls(setup, rank_dtype)
    _host_equals_plain(host_lib, calls)
    for name, call in calls:
        assert int(call.windows()["need"].sum()) > 40, name


@pytest.fixture(scope="module")
def fold():
    return sc.fold_setup()


@pytest.mark.parametrize("rank_dtype,shift", [(torch.int32, False),
                                              (torch.int64, False),
                                              (torch.int64, True)])
def test_host_build_equals_plain_on_edge_windows(host_lib, fold, rank_dtype,
                                                 shift):
    calls = sc.fold_calls(rank_dtype, setup=fold)
    _host_equals_plain(host_lib, calls, shift)
    if not shift:   # a full 199-wide window, scored
        assert int(calls[0][1].run(plain=True)["score"].max()) >= 150


@pytest.mark.parametrize("rank_dtype,shift", [(torch.int32, False),
                                              (torch.int64, False),
                                              (torch.int64, True)])
def test_filter_host_build_equals_plain(host_lib, fold, rank_dtype, shift):
    _host_equals_plain(host_lib, sc.random_calls(rank_dtype, 1, setup=fold,
                                                 B=16), shift)


def test_host_build_equals_plain_on_a_recorded_batch(host_lib, recorded):
    want = recorded.run(plain=True)
    assert sc.max_abs_err(recorded.host(host_lib), want) == 0
    assert recorded.counts()["lanes"] > 100


def test_filter_host_build_equals_plain_on_a_recorded_batch(host_lib,
                                                            recorded):
    for _, scores, mcw in sc.SCORINGS[1:]:
        call = sc.FilterCall(dict(recorded.args, **scores,
                                  min_chain_weight=mcw))
        want = call.run(plain=True)
        assert sc.max_abs_err(call.host(host_lib), want) == 0, scores


def test_activation_table_equals_the_windows(setup):
    idx, codes = setup[0], setup[2]
    W = codes.shape[1]
    lens = torch.arange(W + 1, dtype=torch.int32)
    for (_, call) in sc.edge_calls(torch.int32, setup=setup):
        a = call.args
        table = seedsw.activation_table(W, a["match_score"],
                                        a["min_chain_weight"], "cpu")
        seeds = {k: v[:1].expand(W + 1, -1).contiguous()
                 for k, v in a["seeds"].items()}
        win = seedsw.seed_sw_windows(a["fm"], lens, seeds, a["match_score"],
                                     a["min_chain_weight"])
        S = seeds["rbeg"].shape[1]
        assert torch.equal(table[:, 1], win["min_hsp"][::S])
        active = table[:, 0].bool()
        assert not active[0] and active[-1]
        assert seedsw.activation_table(W, a["match_score"],
                                       a["min_chain_weight"], "cpu") is table


def test_fold_calls_reach_every_case(fold):
    idx, codes, lens, seeds = fold
    (_, c0), (_, c20), (_, wide) = sc.fold_calls(torch.int32, setup=fold)
    S = seeds["rbeg"].shape[1]
    row = {L: k for k, L in enumerate(sc.FOLD_LENS)}
    for call, below, at in ((c0, 724, 725), (c20, 439, 440)):
        need = call.windows()["need"].reshape(-1, S)
        assert not need[row[below]].any() and need[row[at]].any()
        assert call.args["min_chain_weight"] == (20 if below == 439 else 0)
    assert wide.args["match_score"] == 64 * c20.args["match_score"] > 127
    win = c0.windows()
    need = win["need"]
    qlen, tlen = (win["qe"] - win["qb"])[need], (win["re"] - win["rb"])[need]
    assert set(sc.FOLD_QLENS) <= set(qlen.tolist())
    assert {1, 2, 199} <= set(tlen.tolist())
    l_pac = idx.l_pac
    assert ((win["re"] == l_pac) & need).any()
    assert ((win["rb"] == l_pac) & need).any()
    ends = {int(o + n) for o, n in zip(idx.ref_offsets, idx.ref_lens)}
    rev_ends = {idx.seq_len - e for e in ends}
    assert any(int(r) in ends for r in win["re"][need])
    assert any(int(r) in ends for r in win["rb"][need])
    assert any(int(r) in rev_ends for r in win["re"][need])
    n_read = 5 * S
    assert need[n_read: n_read + S].any()      # the all-N read
    assert (codes[5] == 4).all()


def test_edge_calls_reach_every_case(setup):
    idx, g, codes, lens, seeds, kinds = setup
    (_, call), (_, asym), _ = _filter_calls(setup, torch.int32)
    out, win = call.run(plain=True), call.windows()
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

    _lanes_run(call, lambda c: c.run(plain=True))
    _lanes_run(call, lambda c: c.host(host_lib))


def _plain_equals_jax(idx, calls, rank_dtype) -> None:
    jf = jax.jit(jsw.seed_sw_filter, static_argnames=SW_KW)
    with jax.enable_x64(rank_dtype == torch.int64):
        jfmd = jfm.FMDevice.from_host(idx)
        for name, call in calls:
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


@pytest.mark.parametrize("rank_dtype", DTYPES)
def test_plain_filter_equals_jax_on_edge_calls(setup, rank_dtype):
    _plain_equals_jax(setup[0], _filter_calls(setup, rank_dtype), rank_dtype)


@pytest.mark.parametrize("rank_dtype", DTYPES)
def test_plain_filter_equals_jax_on_fold_calls(fold, rank_dtype):
    _plain_equals_jax(fold[0], sc.fold_calls(rank_dtype, setup=fold),
                      rank_dtype)


def test_cpu_dispatch_runs_the_plain_twin(setup, recorded, monkeypatch):
    def no_library(name):
        raise AssertionError(f"library {name} loaded on the CPU")

    monkeypatch.setattr(build, "library", no_library)
    n0 = build.LAUNCHES["seed_sw"]
    for call in (recorded, _filter_calls(setup, torch.int64)[1][1]):
        assert sc.max_abs_err(call.run(), call.run(plain=True)) == 0
    assert pipeline.seed_sw_filter is seedsw.seed_sw_filter
    assert build.LAUNCHES["seed_sw"] == n0


def _i64(t):
    return t.to(torch.int64)


# (what to change, how, the refusal's words): a change of the wrapper's
# arguments (fm, pac_rows, codes, lens, seeds, table)
REFUSALS = {
    "codes int64": ("codes", lambda a: _i64(a["codes"]), "codes"),
    "codes strided": ("codes", lambda a: a["codes"].t().contiguous().t(),
                      "codes"),
    "pac_rows int64": ("pac_rows", lambda a: _i64(a["pac_rows"]),
                       "pac_rows"),
    "pac_rows empty": ("pac_rows", lambda a: a["pac_rows"][:0], "empty"),
    "lens int64": ("lens", lambda a: _i64(a["lens"]), "lens"),
    "lens short": ("lens", lambda a: a["lens"][:-1], "lens"),
    "rbeg int64": ("rbeg", lambda a: _i64(a["seeds"]["rbeg"]), "rbeg"),
    "rbeg 1-d": ("rbeg", lambda a: a["seeds"]["rbeg"].reshape(-1),
                 "seeds must be"),
    "qbeg int64": ("qbeg", lambda a: _i64(a["seeds"]["qbeg"]), "qbeg"),
    "len int64": ("len", lambda a: _i64(a["seeds"]["len"]), "len"),
    "valid int32": ("valid", lambda a: a["seeds"]["valid"].to(torch.int32),
                    "valid"),
    "table short": ("table", lambda a: a["table"][:-1], "table"),
    "table int64": ("table", lambda a: _i64(a["table"]), "table"),
    "ref_offsets int64": ("fm", lambda a: a["fm"]._replace(
        ref_offsets=_i64(a["fm"].ref_offsets)), "ref_offsets"),
    "ref_lens short": ("fm", lambda a: a["fm"]._replace(
        ref_lens=a["fm"].ref_lens[:-1]), "ref_lens"),
    "no references": ("fm", lambda a: a["fm"]._replace(
        ref_offsets=a["fm"].ref_offsets[:0]), "no references"),
    "rank dtype int16": ("fm", lambda a: a["fm"]._replace(
        sa_sample=a["fm"].sa_sample.to(torch.int16)), "rank dtype"),
}


def _wrapper_args(setup) -> dict:
    call = _filter_calls(setup, torch.int32)[0][1]
    a = call.args
    return dict(fm=a["fm"], pac_rows=a["pac_rows"], codes=a["codes"],
                lens=a["lens"], seeds=dict(a["seeds"]), table=call._table(),
                **{k: a[k] for k in sc.SCORING})


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrapper_refuses(monkeypatch, setup, case):
    monkeypatch.setattr(build, "library", None)   # never reached
    field, value, match = REFUSALS[case]
    a = _wrapper_args(setup)
    v = value(a)
    if field in a["seeds"]:
        a["seeds"][field] = v
    else:
        a[field] = v
    with pytest.raises(ValueError, match=match):
        scu.seed_sw_filter_cuda(**a)


def test_wrapper_refuses_cpu_tensors(monkeypatch, setup):
    monkeypatch.setattr(build, "library", None)   # never reached
    with pytest.raises(ValueError, match="CUDA"):
        scu.seed_sw_filter_cuda(**_wrapper_args(setup))


def test_kernel_constants_equal_the_modules():
    src = (build.CSRC / build.SOURCES["seedsw"]).read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert int(consts["kWidth"]) == scu.WIDTH == seedsw._W == 200
    assert int(consts["kShortExt"]) == seedsw.MEM_SHORT_EXT
    # the widths a group's threads cover, bucket by bucket: FOLD_QLENS
    # holds both sides of those it names
    G, nb = int(consts["kGroup"]), int(consts["kBuckets"])
    assert consts["kMaxCols"] == "(kWidth + kGroup - 1) / kGroup"
    assert "return (kMaxCols * (b + 1) + kBuckets - 1) / kBuckets;" in src
    cols = -(-scu.WIDTH // G)
    widths = {G * -(-cols * (b + 1) // nb) for b in range(nb)}
    mids = {q for q in sc.FOLD_QLENS
            if q - 1 in sc.FOLD_QLENS and q + 1 in sc.FOLD_QLENS}
    assert len(mids) >= 5 and mids <= widths and max(widths) >= scu.WIDTH
    assert max(sc.FOLD_QLENS) == scu.WIDTH - 1
    # the scorings' bodies: WIDE fails fits16 on its match score
    assert "p.a >= 0 && p.a <= 127 && p.mis >= 0 && p.mis <= 128" in src
    assert sc.WIDE["match_score"] > 127 and all(
        s["match_score"] <= 127 and s["mismatch_penalty"] <= 128
        for s in (sc.SCORING, sc.ASYMMETRIC))
    assert consts["kNeg"] == "-(1 << 28)"
    assert "NEG = -(1 << 28)" in inspect.getsource(seedsw.local_sw_batch)
    assert "seed_sw" in build.KERNELS and "seed_sw" in build.STEP_KERNELS
    assert "LANE_ENTRY(seed_sw_filter)" in src
