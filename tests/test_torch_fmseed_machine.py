"""The FM seeding machine's split into a CUDA kernel and its plain twin,
on the CPU (the kernel itself runs only on the card:
``tests/test_torch_fmseed_cuda.py``).

- The kernel's body, compiled for the host with g++ (the source's host
  entry: every read through an emulated quad), equals the plain twin on
  all six outputs, at int32 and int64 ranks, on ``tools/fm_machine.py``'s
  edge calls: the round-3 jump, the reseed entry, a 300-step budget, a
  budget that runs out in the middle of a backward row (the row's
  extensions fetched ahead and left unread), one candidate row (P 1:
  the two-buffer stacks at their edge) and the fat retry's 32; skipped
  without g++. The plain twin runs on one intra-op thread.
- Lane independence, the premise of the kernel's one thread a read: the
  plain machine on the edge-case batch run in reverse lane order, as two
  halves and lane by lane (an ambiguous, a junk, a short and an
  r3-window-N read) equals the whole batch's run lane for lane, with the
  round-3 jump, from the reseed entry and under a 300-step budget.
- Dispatch: on CPU tensors ``collect_seeds_device`` runs the plain
  machine and never builds or loads a kernel library.
- The wrapper refuses CPU tensors, wrong dtypes and stacks past its cap
  (ValueError) before it touches a library.
- The plain twin's row counts for the kernel's bound (``touched``).
- The phase, round and table constants of ``csrc/fm_seed.cu`` equal the
  Python modules'.
Integer programs: tolerance 0."""

import re

import pytest
import torch

from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels import fm_seed_cuda as fsc
from bioseqdb_tpu_torch.kernels import seed
from bioseqdb_tpu_torch.tools import fm_machine as fmm


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
def setup():
    idx, codes, lens, kinds = fmm.edge_case_setup()
    fm = kfm.FMDevice.from_host(idx, "cpu")
    entry = fmm.edge_reseed_entry(idx, codes, lens)
    calls = {
        "jump": fmm.edge_call(fm, codes, lens, jump=seed.build_r3_jump(fm)),
        "reseed": fmm.edge_call(fm, codes, lens, max_mem_intv=0, max_mem=24,
                                entry_reseed=True, reseed_entry=entry),
        "budget300": fmm.edge_call(fm, codes, lens, max_iters=300),
    }
    edge = {r: fmm.edge_calls(idx, kfm.FMDevice.from_host(idx, "cpu",
                                                          rank_dtype=dt),
                              codes, lens)
            for r, dt in RANKS.items()}
    return dict(fm=fm, kinds=kinds, calls=calls, edge=edge)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    try:
        return fmm.host_library(tmp_path_factory.mktemp("fm_host"))
    except RuntimeError as e:
        pytest.skip(f"needs g++ to build the kernel's body for the host: {e}")


@pytest.mark.parametrize("rank", list(RANKS))
@pytest.mark.parametrize("name", fmm.EDGE_NAMES)
def test_host_build_equals_plain_on_edge_calls(host_lib, setup, rank, name):
    call = setup["edge"][rank][name]
    want = call.run(plain=True)
    assert fmm.max_abs_err(call.host(host_lib), want) == 0
    if name == "P 1":   # every lane that pushes twice overflows
        assert want["overflow"].sum() > 20


def test_edge_calls_cut_backward_rows_and_reach_the_caps(setup):
    """The mid-row budget stops lanes with a backward row part-way done
    (j > 0 at the end); P 32 and P 1 hold the stacks' two ends."""
    call = setup["edge"]["int32"]["budget mid-row"]
    a = call.args
    st, J, kw = seed._prepare(**a)
    st = seed._plain_machine(a["fm"], st, J=J, jump=a["jump"], group=None,
                             touched=None, **kw)
    assert ((st["j"] > 0) & st["overflow"]).sum() >= 5
    assert kw["max_iters"] == fmm.MID_ROW_BUDGET
    for name, P in (("P 1", 1), ("P 32", fsc.MAX_CAND)):
        assert setup["edge"]["int64"][name].args["max_cand"] == P


def _rows(out: dict, idx) -> dict:
    return {k: out[k][idx] for k in fmm.FIELDS}


def _cat(parts: list[dict]) -> dict:
    return {k: torch.cat([p[k] for p in parts]) for k in fmm.FIELDS}


@pytest.mark.parametrize("case", ["jump", "reseed", "budget300"])
def test_lanes_are_independent(setup, case):
    call = setup["calls"][case]
    whole = call.run()
    B = call.args["codes"].shape[0]
    if case == "jump":
        assert whole["n_mem"].sum() > 0
    if case == "reseed":   # round 2 ran and added mems
        assert (whole["n_mem"] > call.args["reseed_entry"]["n_mem"]).any()
    if case == "budget300":
        assert whole["overflow"].sum() > 5   # the budget really bit
    rev = torch.arange(B - 1, -1, -1)
    assert fmm.max_abs_err(_rows(call.lanes(rev).run(), rev), whole) == 0
    half = B // 2
    halves = _cat([call.lanes(slice(0, half)).run(),
                   call.lanes(slice(half, B)).run()])
    assert fmm.max_abs_err(halves, whole) == 0
    kinds = setup["kinds"]
    for kind in ("ambiguous", "junk", "short", "r3_window_n"):
        k = kinds.index(kind)
        one = call.lanes(slice(k, k + 1)).run()
        assert fmm.max_abs_err(one, _rows(whole, slice(k, k + 1))) == 0, kind


def test_plain_twin_counts_the_rows_lanes_read(setup):
    """``touched`` (the kernel's bound): counting changes no output; the
    marks are per lane (two halves' union is the whole's); split-row
    stall and pivot-only steps fetch nothing; an index mesh refuses it."""
    call = setup["calls"]["jump"]
    t = call.touched()
    out = seed.collect_seeds_plain(**call.args, touched=t)
    assert fmm.max_abs_err(out, call.run(plain=True)) == 0
    B = call.args["codes"].shape[0]
    parts = [call.lanes(slice(0, B // 2)), call.lanes(slice(B // 2, B))]
    union = {k: torch.zeros_like(v) for k, v in t.items()}
    for part in parts:
        tp = part.touched()
        seed.collect_seeds_plain(**part.args, touched=tp)
        for k in union:
            union[k] = union[k] + tp[k] if k == "steps" else union[k] | tp[k]
    assert fmm.counts(union) == fmm.counts(t)
    for k in ("occ", "major", "jump"):
        assert torch.equal(union[k][:-1], t[k][:-1]), k
    n = fmm.counts(t)
    assert 0 < n["steps"] < int(out["iters"].sum())
    assert 0 < n["occ"] <= min(2 * n["steps"], setup["fm"].occ_rows.shape[0])
    assert n["major"] >= 1 and n["jump"] >= 1
    with pytest.raises(ValueError, match="unsharded"):
        seed.collect_seeds_plain(**dict(call.args, group=object()),
                                 touched=t)


def test_cpu_dispatch_runs_the_plain_machine(setup, monkeypatch):
    def no_library(name):
        raise AssertionError(f"library {name} loaded on the CPU")

    monkeypatch.setattr(build, "library", no_library)
    n0 = build.LAUNCHES["fm_seed"]
    call = setup["calls"]["reseed"]
    got = call.run()
    assert fmm.max_abs_err(got, call.run(plain=True)) == 0
    assert build.LAUNCHES["fm_seed"] == n0


def _state(setup, case="jump", **changes):
    a = setup["calls"][case].args
    st, J, kw = seed._prepare(**a)
    st.update(changes)
    return a, st, J, kw


def _launch(a, st, J, kw):
    fsc.fm_seed_cuda(a["fm"], st, jump_table=a["jump"].table if J else None,
                     J=J, **kw)


@pytest.mark.parametrize("field,dtype", [
    ("lens", torch.int64), ("phase", torch.int64), ("mem_k", torch.int64),
    ("overflow", torch.int32), ("codes", torch.int64)])
def test_wrapper_refuses_wrong_dtypes(setup, monkeypatch, field, dtype):
    monkeypatch.setattr(build, "library", None)   # never reached
    a, st, J, kw = _state(setup)
    st[field] = st[field].to(dtype)
    with pytest.raises(ValueError, match=field):
        _launch(a, st, J, kw)


def test_wrapper_refuses_cpu_tensors_and_big_stacks(setup, monkeypatch):
    monkeypatch.setattr(build, "library", None)   # never reached
    a, st, J, kw = _state(setup)
    assert J == 8
    with pytest.raises(ValueError, match="CUDA"):
        _launch(a, st, J, kw)
    with pytest.raises(ValueError, match="max_cand"):
        _launch(a, st, J, dict(kw, max_cand=fsc.MAX_CAND + 1))


def test_kernel_constants_equal_the_modules():
    # the Occ table's constants live in the header the source shares
    # with csrc/fm.cu
    src = (build.CSRC / build.SOURCES["fm_seed"]).read_text()
    assert '#include "occ.cuh"' in src
    src += (build.CSRC / "occ.cuh").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (\w+) = (\d+);", src)}
    names = [n for n in dir(seed) if re.fullmatch(r"(PH|RD)_[A-Z0-9]+", n)]
    assert len(names) == 9
    for n in names:
        assert consts[n] == getattr(seed, n), n
    assert consts["kLog2OccBlock"] == kfm.LOG2_OCC_BLOCK
    assert consts["kLog2Major"] == kfm.LOG2_MAJOR
    assert consts["kMaxCand"] == fsc.MAX_CAND
    assert 1 << consts["kLog2FetchRow"] == 8 * (1 << kfm.LOG2_OCC_BLOCK)
    assert "fm_seed" in build.KERNELS and "fm_seed" in build.LAUNCHES
