"""The minimizer seeder's CUDA kernel (csrc/kmer.cu) and its plain twin, on
the CPU (the kernel itself runs only on the card:
``tests/test_torch_kmer_cuda.py``).

- The kernel's lane body, compiled for the host with g++ (the source's
  host entry), equals the plain twin on every output: on
  ``tools/kmer_calls.py``'s edge calls (every fallback bit, needs_r2,
  round 3 off, W 320 at nmz 104 and dmax 40, tandem repeats), its random
  calls (random bucket words and entries) and a recorded pipeline batch;
  skipped without g++. Its top-2 merge takes the diagonals one at a time
  where the twin merges chunks of 8: equal on tie-heavy tandem reads.
- Lane independence, the premise of one thread a read: the twin and the
  host build on the reads in reverse order, as two halves and read by
  read equal the whole batch's run read for read.
- JAX parity: on every edge call the twin equals the JAX package's
  ``collect_seeds_kmer``.
- Dispatch: on CPU tensors ``collect_seeds_kmer`` runs the twin and never
  builds or loads a kernel library.
- The wrapper refuses wrong dtypes, shapes, layouts, devices and caps
  (ValueError) before it touches a library.
- The constants of ``csrc/kmer.cu`` equal the Python modules'.
Integer programs: tolerance 0."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioseqdb_tpu.kernels import kmer as jkm
from bioseqdb_tpu_torch.align import pipeline
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.index import layout
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import build, kmer
from bioseqdb_tpu_torch.kernels import kmer_cuda as kcu
from bioseqdb_tpu_torch.tools import kmer_calls as kc
from bioseqdb_tpu_torch.utils.sim import simulate_genome, simulate_reads

EDGE = list(kc.EDGE_CAPS)
KW = ("bb", "min_seed_len", "split_len", "split_width", "max_mem_intv",
      "smax", "dmax", "nmz", "max_mem")


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
def edge():
    setup = kc.edge_setup()
    return setup, dict(kc.edge_calls(setup=setup))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    try:
        return kc.host_library(tmp_path_factory.mktemp("kmer_host"))
    except RuntimeError as e:
        pytest.skip(f"needs g++ to build the lane body for the host: {e}")


@pytest.fixture(scope="module")
def recorded():
    """The collect_seeds_kmer call of a CPU batch (kmer seeder) on a 40 kb
    genome with a repeat: simulated reads at 2% substitutions and some
    that span the repeat's copies."""
    core = simulate_genome(40_000, seed=81)
    rep = simulate_genome(400, seed=82)
    g = core[:15_000] + rep + core[15_000:30_000] + rep + core[30_000:]
    sim = simulate_reads(g, 56, read_len=150, sub_rate=0.02, seed=83)
    reads = list(sim.reads) + [g[15_000 - 60 + 40 * k: 15_090 + 40 * k]
                               for k in range(8)]
    calls = []
    al = Aligner.build(build_index([("g", g)]), AlignOptions(), device="cpu",
                       seeder="kmer")
    with kc.recording(calls):
        al.device_regions(pack_reads(reads, [f"r{i}" for i in
                                             range(len(reads))]))
    assert len(calls) == 1
    return calls[0]


def _equal(got: dict, want: dict) -> None:
    assert kc.max_abs_err(got, want) == 0, [
        k for k in kc.OUTPUTS if not torch.equal(got[k], want[k])]


@pytest.mark.parametrize("name", EDGE)
def test_host_build_equals_plain_on_edge_calls(host_lib, edge, name):
    call = edge[1][name]
    _equal(call.host(host_lib), call.run(plain=True))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_host_build_equals_plain_on_random_calls(host_lib, seed):
    for call in kc.random_calls(seed):
        _equal(call.host(host_lib), call.run(plain=True))


def test_host_build_equals_plain_on_a_recorded_batch(host_lib, recorded):
    want = recorded.run(plain=True)
    _equal(recorded.host(host_lib), want)
    assert (want["n_mem"] > 0).sum() > 40 and want["overflow"].any()


def test_top2_merge_one_at_a_time_on_ties(host_lib, edge):
    """Tandem reads give many diagonals of equal reach (five chunks of the
    twin's merge at dmax 40): the kernel's one-at-a-time merge equals it."""
    (_, _, _, _, kinds), calls = edge
    rows = torch.tensor([k == "tandem40" for k in kinds])
    call = calls["W 320, nmz 104, dmax 40"].lanes(rows.nonzero()[:, 0])
    want = call.run(plain=True)
    _equal(call.host(host_lib), want)
    # more than a chunk of the twin's merge a read
    assert call.counts()["diags"] > 8 * int(rows.sum())
    assert (want["mem_s"] >= 8).any()       # ties: 8+ occurrences


@pytest.mark.parametrize("case", ["W 160", "recorded"])
def test_lanes_are_independent(host_lib, edge, recorded, case):
    call = recorded if case == "recorded" else edge[1][case]
    B = call.args["codes"].shape[0]
    for run in (lambda c: c.run(plain=True), lambda c: c.host(host_lib)):
        whole = run(call)
        rev = torch.arange(B - 1, -1, -1)
        got = run(call.lanes(rev))
        _equal({k: v[rev] for k, v in got.items()}, whole)
        halves = [run(call.lanes(slice(0, B // 2))),
                  run(call.lanes(slice(B // 2, B)))]
        _equal({k: torch.cat([h[k] for h in halves]) for k in kc.OUTPUTS},
               whole)
        for b in range(0, B, max(1, B // 10)):
            one = run(call.lanes(slice(b, b + 1)))
            _equal(one, {k: v[b: b + 1] for k, v in whole.items()})


def test_edge_calls_reach_every_case(edge):
    (_, _, _, _, kinds), calls = edge
    kinds = np.array(kinds)
    bits = {}
    for name, call in calls.items():
        out = call.run(plain=True)
        why = out["why"]
        bits[name] = [int(((why >> k) & 1).sum()) for k in range(7)]
        assert torch.equal(out["overflow"], why != 0)
        assert not (out["needs_r2"] & out["overflow"]).any()
    # every fallback bit, needs_r2 and the round-3 chase's budget at W 160
    w160 = calls["W 160"].run(plain=True)
    assert all(bits["W 160"][k] > 0 for k in (0, 1, 2, 3, 5, 6))
    assert bits["small caps"][4] > 0 and w160["needs_r2"].any()
    assert w160["needs_r2"][torch.from_numpy(kinds == "certificate")].any()
    assert bits["round 3 off"][5] == bits["round 3 off"][6] == 0
    # all-N reads and reads shorter than min_seed_len: no seed
    lens = calls["W 160"].args["lens"]
    none = torch.from_numpy(kinds == "all_n") | (lens < kc.MSL)
    assert (w160["n_mem"][none] == 0).all() and none.sum() >= 6
    # negative diagonals near the text's start
    start = torch.from_numpy(kinds == "text_start")
    assert ((w160["mem_pos"][start] < 20) & (w160["mem_b"][start] >= 20)
            ).any()
    # the warp's shapes: reads with no valid diagonal (D = 0) beside ones
    # with more candidate diagonals than the warp has lanes; chases that
    # use their whole budget T at W 150 and 161 too
    for name in ("W 150", "W 161", "W 320, nmz 104, dmax 40"):
        a = calls[name].args
        dg = kmer.kmer_diagonals(a["bmeta"], a["entries"],
                                 a["codes"].long(), a["lens"], a["bb"],
                                 a["smax"], a["dmax"], a["nmz"])
        D = dg["dvalid"].sum(1)
        assert ((D == 0) & (a["lens"] >= kc.MSL)).any(), name
        if name.startswith("W 320"):
            assert (dg["hits"] > 32).any() and (D > 8).any()
        else:
            assert bits[name][6] > 0, name


def _jax(call: kc.KmerCall) -> dict:
    a = call.args
    kt = jkm.KmerTable(bmeta=jnp.asarray(a["bmeta"].numpy()),
                       entries=jnp.asarray(a["entries"].numpy()))
    return jax.device_get(jkm.collect_seeds_kmer(
        kt, jnp.asarray(a["pac_rows"].numpy()), a["seq_len"],
        jnp.asarray(a["codes"].numpy()), jnp.asarray(a["lens"].numpy()),
        **{k: a[k] for k in KW}))


@pytest.mark.parametrize("name", EDGE)
def test_plain_twin_equals_jax_on_edge_calls(edge, name):
    """Every edge cap set: the kernel's static caps and the small caps
    that reach r1_overflow included."""
    call = edge[1][name]
    want, got = _jax(call), call.run(plain=True)
    for k in kc.OUTPUTS:
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k


def test_cpu_dispatch_runs_the_plain_twin(edge, recorded, monkeypatch):
    def no_library(name):
        raise AssertionError(f"library {name} loaded on the CPU")

    monkeypatch.setattr(build, "library", no_library)
    n0 = build.LAUNCHES["kmer_seed"]
    for call in (recorded, edge[1]["W 160"]):
        _equal(call.run(), call.run(plain=True))
    # too narrow for a minimizer window: the shared early return
    narrow = recorded.replace(codes=recorded.args["codes"][:, :18])
    assert not narrow.run()["n_mem"].any()
    assert pipeline.collect_seeds_kmer is kmer.collect_seeds_kmer
    assert build.LAUNCHES["kmer_seed"] == n0


def _args(call: kc.KmerCall, **changes) -> dict:
    a = dict(call.args, **changes)
    a["codes"] = a["codes"].to(torch.int32)
    return a


@pytest.mark.parametrize("field,value,match", [
    ("codes", lambda a: a["codes"].to(torch.int64), "codes"),
    ("codes", lambda a: a["codes"].t().contiguous().t(), "codes"),
    ("lens", lambda a: a["lens"].to(torch.int64), "lens"),
    ("lens", lambda a: a["lens"][:-1], "lens"),
    ("bmeta", lambda a: a["bmeta"][:-1], "bmeta"),
    ("entries", lambda a: a["entries"][:-1], "entries"),
    ("pac_rows", lambda a: a["pac_rows"].to(torch.int64), "pac_rows"),
    ("codes", lambda a: torch.full((4, kcu.MAX_WIDTH + 8), 4,
                                   dtype=torch.int32), "width"),
    ("nmz", lambda a: kcu.MAX_NMZ + 1, "nmz"),
    ("dmax", lambda a: kcu.MAX_DMAX + 1, "dmax"),
    ("smax", lambda a: kcu.MAX_SMAX + 1, "smax"),
    ("smax", lambda a: 0, "smax"),
    ("max_mem", lambda a: kcu.MAX_MEM + 1, "max_mem"),
    ("bb", lambda a: 13, "bb"),
])
def test_wrapper_refuses(monkeypatch, recorded, field, value, match):
    monkeypatch.setattr(build, "library", None)   # never reached
    a = _args(recorded)
    a[field] = value(a)
    if field == "codes" and a["codes"].shape[0] != a["lens"].shape[0]:
        a["lens"] = torch.full((a["codes"].shape[0],), 100,
                               dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        kcu.kmer_seed_cuda(**a)


def test_wrapper_refuses_cpu_tensors(monkeypatch, recorded):
    monkeypatch.setattr(build, "library", None)   # never reached
    with pytest.raises(ValueError, match="CUDA"):
        kcu.kmer_seed_cuda(**_args(recorded))


def test_kernel_constants_equal_the_modules():
    src = (build.CSRC / build.SOURCES["kmer"]).read_text()
    consts = {k: int(v, 0) for k, v in re.findall(
        r"constexpr (?:int|uint32_t) (\w+) = (-?\w+?)u?;", src)}
    assert consts["kK"] == layout.K == 14 and consts["kWin"] == layout.WIN
    assert consts["kMaxWidth"] == kcu.MAX_WIDTH == pipeline.KMER_MAX_WIDTH
    assert consts["kMaxNmz"] == kcu.MAX_NMZ == layout.nmz_for(320)
    assert consts["kMaxDmax"] == kcu.MAX_DMAX == 40
    assert layout.dmax_for(layout.KmerMeta(26, 1 << 30, 1), 104) == 40
    assert consts["kMaxSmax"] == kcu.MAX_SMAX == layout.smax_for(0)
    assert consts["kMaxMem"] == kcu.MAX_MEM
    assert consts["kBig"] == kmer._BIG and consts["kUMax"] == kmer._UMAX
    assert "kmer_seed" in build.KERNELS and "kmer_seed" in build.STEP_KERNELS
    assert "LANE_ENTRY(kmer_seed)" in src
