"""The extension stage's split into CUDA kernels (csrc/extend.cu) and their
plain twins, on the CPU (the kernels themselves run only on the card:
``tests/test_torch_extend_cuda.py``; JAX parity of the split twins:
``tests/test_torch_extend.py``).

- The edge set (``tools/extend_calls.py`` ``edge_calls``) holds every
  case it was made for: covered seeds skipped, the overlap rescue, band
  doubling at bandwidth 8, overflow at max_regs 1, windows clipped at the
  strand boundary and at reference ends; at int32 and int64 ranks.
- Lane independence, the premise of one thread (or warp) a read:
  ``extend_all`` on the plain twins, in reverse read order, as two
  halves and read by read, equals the whole batch's run read for read.
- Dispatch: on CPU tensors ``extend_all`` runs the plain twins and never
  builds or loads a kernel library.
- The wrappers refuse CPU tensors, wrong dtypes, non-contiguous tensors
  and more than 16 regions a read (ValueError) before they touch a
  library.
- The constants of ``csrc/extend.cu`` equal the Python modules'.
- The kernels' lane bodies, compiled for the host with g++ (the source's
  host entries), equal the plain twins on every stage call of the edge
  set (int32, int64, and int64 past 2^31), of a recorded batch with its
  fat retry (S 128, R 16), and on random stage inputs; the host entries
  refuse an argument array of the wrong length. Skipped without g++.
Integer programs: tolerance 0."""

import shutil

import pytest
import torch

from bioseqdb_tpu_torch.kernels import build, extend
from bioseqdb_tpu_torch.kernels import extend_cuda as ecu
from bioseqdb_tpu_torch.tools import extend_calls as ec

DTYPES = {"int32": torch.int32, "int64": torch.int64}


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
    return {name: ec.edge_calls(dt)[0] for name, dt in DTYPES.items()}


@pytest.fixture(scope="module")
def recorded():
    """The edge batch's device step and the fat retry of its overflowed
    rows (int32 ranks)."""
    calls = dict(ec.edge_calls(torch.int32, retry=True)[0])
    return [calls["default"], calls["fat retry 1"]]


@pytest.mark.parametrize("dtype", DTYPES)
def test_edge_set_holds_its_cases(edge, dtype):
    calls = dict(edge[dtype])
    n = {name: ec.census(call) for name, call in calls.items()}
    for name, got in n.items():
        assert got["skips"] > 0 and got["rescued"] > 0, (name, got)
        assert got["strand"] > 0 and got["ref_end"] > 0, (name, got)
    assert n["default"]["overflow"] == 0 < n["max_regs 1"]["overflow"]
    assert n["band 8"]["retries"] > 0
    out = calls["band 8"].run()
    assert (out["regs"]["w"] == 16).any()
    assert calls["default"].args["seeds"]["rbeg"].dtype == DTYPES[dtype]


def _rows(out: dict, idx) -> dict:
    return {k: _rows(v, idx) if isinstance(v, dict) else v[idx]
            for k, v in out.items()}


def _cat(parts: list) -> dict:
    return {k: _cat([p[k] for p in parts]) if isinstance(v, dict)
            else torch.cat([p[k] for p in parts])
            for k, v in parts[0].items()}


@pytest.mark.parametrize("case", ["edge band 8", "recorded fat retry"])
def test_lanes_are_independent(edge, recorded, case):
    call = (recorded[1] if case == "recorded fat retry"
            else dict(edge["int32"])["band 8"])
    whole = call.run()
    B = call.dims[0]
    rev = torch.arange(B - 1, -1, -1)
    assert ec.max_abs_err(_rows(call.lanes(rev).run(), rev), whole) == 0
    half = B // 2
    halves = _cat([call.lanes(slice(0, half)).run(),
                   call.lanes(slice(half, B)).run()])
    assert ec.max_abs_err(halves, whole) == 0
    for b in range(0, B, max(1, B // 4)):
        one = call.lanes(slice(b, b + 1)).run()
        assert ec.max_abs_err(one, _rows(whole, slice(b, b + 1))) == 0, b


def test_cpu_dispatch_runs_the_plain_twins(edge, monkeypatch):
    def no_library(name):
        raise AssertionError(f"library {name} loaded on the CPU")

    monkeypatch.setattr(build, "library", no_library)
    n0 = {k: build.LAUNCHES[k] for k in build.EXTEND_KERNELS}
    call = dict(edge["int32"])["band 8"]
    out, stages = call.stages()
    assert {s.kind for s in stages} == set(build.EXTEND_KERNELS)
    assert ec.max_abs_err(out, call.run(plain=True)) == 0
    assert all(build.LAUNCHES[k] == v for k, v in n0.items())


@pytest.fixture(scope="module")
def stages(edge):
    """One stage call of each kind (both merge sides) from the edge set's
    band-8 call, int32 ranks."""
    _, calls = dict(edge["int32"])["band 8"].stages()
    first = {}
    for s in calls:
        first.setdefault(s.name, s)
    return first


def _with(call: ec.StageCall, path: str, t) -> ec.StageCall:
    """``call`` with the tensor at ``path`` (argument index, then keys)
    replaced by ``t(old)``."""
    args = list(call.args)
    i, *keys = path
    if not keys:
        args[i] = t(args[i])
        return ec.StageCall(call.kind, tuple(args))
    d = dict(args[i])
    args[i] = d
    for k in keys[:-1]:
        d[k] = dict(d[k])
        d = d[k]
    d[keys[-1]] = t(d[keys[-1]])
    return ec.StageCall(call.kind, tuple(args))


REFUSED = [
    ("extend_scan", (0, "rbeg"), torch.float32, "rbeg"),
    ("extend_scan", (0, "order"), torch.int64, "order"),
    ("extend_scan", (0, "valid"), torch.int32, "valid"),
    ("extend_scan", (1, "regs", "w"), torch.int64, "w"),
    ("extend_scan", (1, "n_regs"), torch.int64, "n_regs"),
    ("extend_windows", (4,), torch.int32, "perm"),
    ("extend_windows", (0, "codes"), torch.uint8, "codes"),
    ("extend_windows", (2,), torch.int64, "pac"),
    ("extend_merge left", (7,), torch.int32, "retry"),
    ("extend_merge left", (5, "score"), torch.int64, "r1.score"),
    ("extend_merge right", (9, "rb"), torch.float64, "left.rb"),
    ("extend_merge right", (2, "was_ext"), torch.int32, "was_ext"),
    ("extend_seedcov", (0, "ok"), torch.int32, "ok"),
    ("extend_seedcov", (1, "cchain"), torch.int64, "cchain"),
]


@pytest.mark.parametrize("name,path,dtype,match", REFUSED)
def test_wrappers_refuse_wrong_dtypes(stages, monkeypatch, name, path, dtype,
                                      match):
    monkeypatch.setattr(build, "library", None)   # never reached
    call = _with(stages[name], path, lambda t: t.to(dtype))
    with pytest.raises(ValueError, match=match):
        call.run()


def test_wrappers_refuse_cpu_tensors_wide_tables_and_strides(stages,
                                                             monkeypatch):
    monkeypatch.setattr(build, "library", None)   # never reached
    for s in stages.values():
        with pytest.raises(ValueError, match="CUDA"):
            s.run()
    wide = lambda regs: {k: v.repeat(1, 3) for k, v in regs.items()}
    with pytest.raises(ValueError, match="regions a read"):
        _with(stages["extend_seedcov"], (1,), wide).run()
    with pytest.raises(ValueError, match="regions a read"):
        _with(stages["extend_scan"], (1, "regs"), wide).run()
    with pytest.raises(ValueError, match="contiguous"):
        _with(stages["extend_scan"], (0, "qbeg"),
              lambda t: t.t().contiguous().t()).run()


def test_kernel_constants_equal_the_modules():
    import re

    src = (build.CSRC / build.SOURCES["extend"]).read_text()
    consts = {k: int(v, 0) for k, v in re.findall(
        r"constexpr (?:int|long long) (\w+) = (-?\w+);", src)}
    assert consts["kMaxRegs"] == ecu.MAX_REGS == 16
    assert consts["kNoCode"] == 4 and consts["kFields"] == 6
    for k in ("extend_scan", "extend_windows", "extend_merge_left",
              "extend_merge_right", "extend_seedcov"):
        assert f"LANE_ENTRY({k})" in src
    for k in build.EXTEND_KERNELS:
        assert k in build.KERNELS and k in build.STEP_KERNELS
        assert k in build.LAUNCHES


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the lane bodies for the host")
    return ec.host_library(tmp_path_factory.mktemp("extend_host"))


def _host_equals_plain(lib, calls) -> dict:
    """Each stage call on the host build against its plain twin; returns
    the calls checked by name."""
    seen = {}
    for s in calls:
        assert ec.max_abs_err(s.host(lib), s.run(plain=True)) == 0, s.name
        seen[s.name] = seen.get(s.name, 0) + 1
    return seen


@pytest.mark.parametrize("dtype", DTYPES)
def test_host_build_equals_plain_on_the_edge_set(host_lib, edge, dtype):
    for name, call in edge[dtype]:
        _, calls = call.stages()
        if dtype == "int64":   # and every reference coordinate past 2^31
            calls += [s.shifted() for s in calls
                      if s.kind != "extend_windows"]
        seen = _host_equals_plain(host_lib, calls)
        assert set(seen) == {"extend_scan", "extend_windows",
                             "extend_merge left", "extend_merge right",
                             "extend_seedcov"}, name


def test_host_build_equals_plain_on_a_recorded_batch(host_lib, recorded):
    for call in recorded:
        out, calls = call.stages()
        _host_equals_plain(host_lib, calls)
        assert ec.max_abs_err(out, call.run(plain=True)) == 0
    assert recorded[1].dims[1:] == (128, 16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [5, 6])
def test_host_build_equals_plain_on_random_inputs(host_lib, dtype, seed):
    calls = ec.random_calls(DTYPES[dtype], seed=seed)
    if dtype == "int64":
        calls += [s.shifted() for s in calls if s.kind != "extend_windows"]
    _host_equals_plain(host_lib, calls)


def test_host_entries_refuse_a_wrong_argument_count(host_lib, stages):
    for s in stages.values():
        _, args, _ = s.kernel_args()
        entry = s.entry
        fn = ecu.bind(host_lib, f"{entry}_host", stream=False)
        assert fn(ecu.array(args[:-1]), len(args) - 1) == 1, entry
        assert fn(ecu.array(args + [0]), len(args) + 1) == 1, entry
        assert fn(ecu.array(args), len(args)) == 0, entry
