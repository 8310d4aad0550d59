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
- The lane cases (``extend_calls.lane_cases``) hold what they were made
  for: the scan's first stop on lanes 0, 1, 31, 32, 33, 63 and 64 of a
  pass, bare and rescued; n_usable off a multiple of 32; every slot
  extended; no live regions and 16; seedcov's
  (``extend_calls.seedcov_cases``) S one off each group size and chunk,
  Rg 1, 8, 9 and 16, reads with no ok slot, seeds on every region edge,
  two chains interleaved and an int32 sum that wraps.
- The kernels' lane bodies, compiled for the host with g++ (the source's
  host entries), equal the plain twins on every stage call of the edge
  set (int32, int64, and int64 past 2^31), of a recorded batch with its
  fat retry (S 128, R 16), on random stage inputs and on the lane cases
  (the right merge at R 1 and 16 and at S 40 and 70, and seedcov's
  cases, too); the host
  entries refuse an argument array of the wrong length. Skipped without
  g++.
- The set-up (``extend_setup``): its host entry equals
  ``extend_setup_plain`` at S 64, 128, 189 and 1,536 and C 16, 32 and
  256, and at the S and C of 8 kb and 18 kb reads and the 18 kb fat
  retry (730, 1,564 and 3,128; the last past a block's shared memory:
  its scratch in device memory) (``extend_calls.setup_calls``: ties in
  the keys and the filter's order, unusable seeds, chains across l_pac,
  windows clipped at reference ends), int32, int64 and past 2^31; the
  wrapper takes any S and C (a scratch past its shared memory) and
  refuses wrong dtypes and CPU tensors.
- The set-up's sorts (``extend_calls.setup_edge_calls``): its host
  entry equals the twin with no usable seed, one a read and every seed
  usable; at S 45 (off a multiple of 32), 189, 1,564 and 4,200 (the
  scratch) and C 16, 32 and 64; with usable keys that tie but for the
  slot (S 200); with half the seeds outside any chain; and at chain
  ranks up to 4,094 (C 4,095), whose keys come within 2^19 of the
  unusable seeds' (int32, int64 and past 2^31).
- The rounds without host waits: ``extend_all`` with every round and
  retry run under its gate (``extend_calls.route("gates")``, what the
  card's CUDA graph captures) equals the guarded order on the edge set,
  whose rounds go dead and whose sides mostly take no retry, and on a
  call with no usable seed; on the host build, a gate of 0 leaves the
  merges' outputs unwritten and the windows' small outputs equal to the
  twin's, the scan adds its active reads to its count, and the gated
  right merge (in place) equals it ungated (out of place); the route
  (a CUDA graph on the card, the guards on the CPU and under a group,
  ``extend_calls.route`` forcing one) follows the device and group.
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
    assert consts["kSetupSmem"] == ecu.SETUP_SMEM
    for k in ("extend_setup", "extend_scan", "extend_windows",
              "extend_merge_left", "extend_merge_right", "extend_seedcov"):
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
        assert set(seen) == {"extend_setup", "extend_scan", "extend_windows",
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


@pytest.fixture(scope="module")
def lanes():
    return {name: ec.lane_cases(dt) for name, dt in DTYPES.items()}


@pytest.mark.parametrize("case", ec.LANE_CASES[:5])
def test_lane_cases_hold_their_cases(lanes, case):
    (call,), want = lanes["int32"][case]
    tab, st, p = call.args
    got = call.run(plain=True)
    assert torch.equal(got["cursor"].long(), want)
    stopped = got["cursor"] < tab["n_usable"]
    lane = (got["cursor"] - st["cursor"])[stopped]
    bare = extend.extend_scan_plain(
        tab, dict(st, was_ext=torch.zeros_like(st["was_ext"])), p)
    rescued = bare["cursor"] != got["cursor"]
    if case == "scan with no live regions":
        assert (st["n_regs"] == 0).all() and (lane == 0).all()
        return
    assert rescued.any()
    if case == "scan n_usable off 32":
        ran = ~stopped & (st["cursor"] < tab["n_usable"])
        assert ran.any() and (tab["n_usable"][ran] % 32 != 0).all()
        return
    for k in (0, 31, 32):
        assert (lane == k).any() and (lane[rescued[stopped]] == k).any(), k
    if case == "scan with every slot extended":
        assert st["was_ext"].all() and tab["order"].shape[1] > 64
    if case == "scan with 16 live regions":
        assert (st["n_regs"] == 16).all()


@pytest.mark.parametrize("case", ec.SEEDCOV_CASES)
def test_seedcov_cases_hold_their_cases(lanes, case):
    calls, _ = lanes["int32"][case]
    for c in calls:
        tab, regs = c.args
        B, S = tab["ok"].shape
        out = c.run(plain=True)
        n_ok = tab["ok"].sum(1)
        assert (out[n_ok == 0] == 0).all()
        if case == "seedcov no ok slot":
            assert (n_ok == 0).any() and (n_ok > 0).any()
        elif case == "seedcov seeds on every region edge":
            # each region holds 3 of its 9 edge seeds: 20 + 19 + 19
            assert (out[:, :4] == 58).all()
        elif case == "seedcov two chains interleaved":
            assert (tab["cis"][:, :2] == torch.tensor([0, 1])).all()
            assert (out > 0).all()
        elif case == "seedcov int32 sum wraps":
            want = n_ok.long() * ec.WRAP_LEN
            assert (want > 2 ** 32).any()
            assert torch.equal(out[:, 0].long(),
                               (want + 2 ** 31) % 2 ** 32 - 2 ** 31)
        else:
            assert (out > 0).any()
    dims = [(c.args[0]["ok"].shape[1], c.args[1]["rb"].shape[1])
            for c in calls]
    if case == "seedcov S about a group":
        assert [S for S, _ in dims] == list(ec.SEEDCOV_S["group"])
    elif case == "seedcov S about a chunk":
        assert [S for S, _ in dims] == list(ec.SEEDCOV_S["chunk"])
    elif case == "seedcov Rg 1, 8, 9, 16":
        assert [R for _, R in dims] == [1, 8, 9, 16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ec.LANE_CASES)
def test_host_build_equals_plain_on_lane_cases(host_lib, lanes, case,
                                               dtype):
    calls, want = lanes[dtype][case]
    if dtype == "int64":
        calls = calls + [s.shifted() for s in calls
                         if s.kind != "extend_windows"]
    _host_equals_plain(host_lib, calls)
    if want is not None:
        assert torch.equal(calls[0].host(host_lib)["cursor"].long(), want)


# ---- the set-up ----

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ec.SETUP_CASES)
def test_setup_host_build_equals_plain(host_lib, dtype, case):
    call = ec.setup_calls(DTYPES[dtype])[case]
    calls = [call] + ([call.shifted()] if dtype == "int64" else [])
    _host_equals_plain(host_lib, calls)
    tab = call.run(plain=True)
    seeds, chains = call.args[0], call.args[1]
    # what the set makes: usable and unusable seeds, ties in the filter's
    # order, windows clipped at l_pac and at reference ends
    assert 0 < int(tab["n_usable"].sum()) < tab["order"].numel()
    flt_order = call.args[2]["order"]
    assert (flt_order[:, :, None] == flt_order[:, None, :]).sum() > (
        flt_order.numel())
    refs = call.args[4]
    ends = {refs["l_pac"]} | {int(o + n) for o, n in zip(refs["offsets"],
                                                         refs["lens"])}
    hit = lambda t: sum(int((t == e).sum()) for e in ends)
    assert hit(tab["rmax0"]) > 0 and hit(tab["rmax1"]) > 0
    assert ((chains["assign"] < 0) & seeds["valid"]).any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ec.SETUP_EDGE_CASES)
def test_setup_sort_edges_host_build_equals_plain(host_lib, dtype, case):
    call = ec.setup_edge_calls(DTYPES[dtype])[case]
    calls = [call] + ([call.shifted()] if dtype == "int64" else [])
    _host_equals_plain(host_lib, calls)
    seeds, chains, flt = call.args[:3]
    B, S = seeds["valid"].shape
    C = flt["order"].shape[1]
    n_usable = call.run(plain=True)["n_usable"]
    # what each case was made for
    want = {"no usable seed": lambda: (n_usable == 0).all(),
            "one usable seed a read": lambda: (n_usable == 1).all(),
            "every seed usable": lambda: (n_usable == S).all(),
            "S 45, C 16": lambda: S % 32 != 0,
            "S 189, C 64": lambda: (S, C) == (189, 64),
            "S 1564, C 32": lambda: (S, C) == (1564, 32),
            "tied keys past S 128": lambda: S > 128 and (n_usable == S).all(),
            "seeds outside any chain": lambda: (
                (chains["assign"] < 0) & seeds["valid"]).sum() > B * S // 3,
            "S 128, C 64": lambda: C == 64,
            "chain ranks up to 4,094 (C 4,095)": lambda: C == 4095 and (
                chains["assign"] >= 4000).any() and (n_usable == S).all(),
            "S 4200 (scratch)": lambda: ecu.setup_bytes(
                S, C, DTYPES[dtype]) > ecu.SETUP_SMEM}[case]
    assert want(), case


def test_setup_wrapper_refuses_wide_reads(monkeypatch):
    """Wide reads are not refused: past a block's shared memory the
    set-up takes a scratch in device memory. Wrong dtypes, CPU tensors
    and a C and S whose usable seeds' sort keys would reach the unusable
    seeds' 0x7FFFFFF0 are."""
    monkeypatch.setattr(build, "library", None)   # never reached
    call = ec.setup_calls(torch.int32)["S 64, C 16"]
    seeds, chains, flt, lens, refs, p = call.args
    wide = lambda d, keys, n: dict(d, **{k: d[k].repeat(1, n) for k in keys})
    for n_s, n_c, scratch in ((25, 1, False), (100, 1, True), (1, 17, False),
                              (1, 255, True), (1, 256, True)):
        ws = wide(seeds, ("rbeg", "qbeg", "len", "valid"), n_s)
        wc = wide(wide(chains, ("assign",), n_s), ("f_rbeg", "rid"), n_c)
        wf = wide(flt, ("order", "kept"), n_c)
        S, C = 64 * n_s, 16 * n_c
        _, args, tensors = ecu.setup_args(ws, wc, wf, lens, refs, p)
        per_read = ecu.setup_bytes(S, C, torch.int32)
        assert (per_read > ecu.SETUP_SMEM) == scratch, (S, C)
        assert len(tensors) == len(ecu.SETUP_ARGS) - (not scratch) - 1
        if scratch:   # a read's row of it each
            assert tensors[-1].numel() == lens.shape[0] * per_read
        with pytest.raises(ValueError, match="CUDA"):
            ecu.extend_setup_cuda(ws, wc, wf, lens, refs, p)
    # C 4,096 is taken at S 64 (its largest key 0x7FFFFFBF), not at S 128
    # or past C 4,096
    for n_s, n_c in ((2, 256), (1, 257)):
        ws = wide(seeds, ("rbeg", "qbeg", "len", "valid"), n_s)
        wc = wide(wide(chains, ("assign",), n_s), ("f_rbeg", "rid"), n_c)
        with pytest.raises(ValueError, match="unusable"):
            ecu.setup_args(ws, wc, wide(flt, ("order", "kept"), n_c), lens,
                           refs, p)
    with pytest.raises(ValueError, match="kept"):
        ecu.extend_setup_cuda(seeds, chains, dict(flt, kept=flt["kept"]
                                                  .long()), lens, refs, p)
    with pytest.raises(ValueError, match="CUDA"):
        ecu.extend_setup_cuda(seeds, chains, flt, lens, refs, p)


# ---- the rounds without host waits ----

def _guards(call: ec.ExtendCall) -> dict:
    """What the guarded order skips in ``call``: the dead rounds (a scan
    with no active lane) and the sides that took no retry."""
    _, calls = call.stages()
    scans = [s for s in calls if s.kind == "extend_scan"]
    dead = sum(not bool(s.run(plain=True)["act"].any()) for s in scans)
    merges = [s for s in calls if s.kind == "extend_merge"]
    return dict(dead=dead, no_retry=sum(not bool(m.args[7].any())
                                        for m in merges))


@pytest.mark.parametrize("case", ["default", "band 8", "max_regs 1", "dead"])
def test_guard_free_rounds_equal_the_guarded(edge, case):
    call = dict(edge["int32"]).get(case) or dict(edge["int32"])["default"].dead
    guarded = call.run()
    with ec.route("gates"):
        free = call.run()
    assert ec.max_abs_err(free, guarded) == 0
    n = _guards(call)
    assert n["dead"] > 0, n
    if case != "dead":
        assert n["no_retry"] > 0, n


def test_route_by_device_and_group():
    """extend_all's route: a CUDA graph on the card, the host's guards on
    the CPU and under an index mesh's group whatever is forced; a forced
    route elsewhere (a graph only on the card)."""
    group = object()
    assert extend._route(True, None) == "graph"
    assert extend._route(False, None) == "guards"
    assert extend._route(True, group) == "guards"
    for name in extend.ROUTES:
        with ec.route(name):
            assert extend._route(True, None) == name
            assert extend._route(True, group) == "guards"
            assert extend._route(False, None) == (
                "gates" if name == "gates" else "guards")
    with pytest.raises(ValueError, match="no route"):
        with ec.route("eager"):
            pass
    assert extend._ROUTE is None


def test_host_gates_scan_count_and_in_place_merge(host_lib, stages):
    # the scan adds its active reads to its count
    scan = stages["extend_scan"]
    count = torch.tensor([5], dtype=torch.int32)
    out, args, _ = ecu.scan_args(*scan.args, count=count)
    assert ecu.bind(host_lib, "extend_scan_host", stream=False)(
        ecu.array(args), len(args)) == 0
    assert int(count) == 5 + int(out["act"].sum()) and out["act"].any()
    # a closed gate: the merges write nothing, the windows no SW buffer
    closed = torch.zeros(1, dtype=torch.int32)
    for name in ("extend_merge left", "extend_merge right"):
        st = stages[name]
        out, args, _ = ecu.merge_args(*st.args, gate=closed)
        flat = lambda o: [t for v in o.values() for t in (
            v.values() if isinstance(v, dict) else [v])]
        for t in flat(out):
            t.fill_(-7) if t.dtype != torch.bool else t.fill_(True)
        assert ecu.bind(host_lib, f"{st.entry}_host", stream=False)(
            ecu.array(args), len(args)) == 0
        assert all((t == -7).all() if t.dtype != torch.bool else t.all()
                   for t in flat(out)), name
    win = stages["extend_windows"]
    tab, fm, pac, scan_out, perm, p, _ = win.args
    out, args, _ = ecu.windows_args(tab, fm.seq_len, pac, scan_out, perm, p,
                                    gate=closed)
    out["qbuf"].fill_(-7)
    assert ecu.bind(host_lib, "extend_windows_host", stream=False)(
        ecu.array(args), len(args)) == 0
    want = win.run(plain=True)
    assert (out["qbuf"] == -7).all()
    for k in ("qn", "tn", "active", "h0", "inv"):
        assert torch.equal(out[k], want[k]), k
    # the right merge in place equals it out of place
    right = stages["extend_merge right"]
    want = right.host(host_lib)
    st = {k: ({f: t.clone() for f, t in v.items()} if isinstance(v, dict)
              else v.clone()) for k, v in right.args[2].items()}
    args = list(right.args)
    args[2] = st
    out, arr, _ = ecu.merge_args(*args, gate=torch.ones(1,
                                                        dtype=torch.int32))
    assert ecu.bind(host_lib, "extend_merge_right_host", stream=False)(
        ecu.array(arr), len(arr)) == 0
    assert out["n_regs"] is st["n_regs"]
    assert ec.max_abs_err(out, want) == 0
