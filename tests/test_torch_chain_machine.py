"""Chaining's split into CUDA kernels (csrc/chain.cu) and their plain
twins, on the CPU (the kernels themselves run only on the card:
``tests/test_torch_chain_cuda.py``).

- Lane independence, the premise of the kernels' one thread a read: the
  plain twins on a recorded pipeline batch and on ``edge_seeds`` (int32
  and int64 ranks) run in reverse read order, as two halves and read by
  read equal the whole batch's run read for read.
- JAX parity: on ``edge_seeds``, int32 and int64 (under x64),
  ``chain_seeds_plain`` and ``filter_chains_plain`` equal the JAX
  package's ``chain_seeds`` and ``filter_chains``, and the edge set
  holds every case it was made for.
- Dispatch: on CPU tensors ``chain_seeds`` and ``filter_chains`` run
  the plain twins and never build or load a kernel library.
- The wrappers refuse CPU tensors, wrong dtypes and more than 64 chains
  (ValueError) before they touch a library.
- The constants of ``csrc/chain.cu`` equal the Python modules'.
- The kernels' lane bodies, compiled for the host with g++ (the source's
  host entries), equal the plain twins on ``edge_seeds`` at the
  pipeline's S and C and on the recorded batch; skipped without g++.
- ``chain_seeds``' group body (a group of 8 threads a read, its chains
  spread over the lanes) on the host build equals the twin on
  ``chain_calls.group_calls`` at C 8, 16 and 64 (one, two and eight
  chains a lane; S one past a multiple of 8), int32 and int64 past 2^31: C
  reached (new chains refused with overflow), contained seeds, equal
  pos on different lanes and in one lane (the first slot wins), a
  strand crossing and a chain below NEG, each after enough chains that
  the one it is about sits on a later lane, and a read whose only chain
  lies below NEG; each case holds what it was made for.
- ``filter_chains``' group body (16 threads a read up to C 16, a warp
  past it, two chains a lane past 32) on the host build equals the twin
  on ``chain_calls.filter_calls`` at C 8, 16, 32 and 64, int32 and int64
  past 2^31, at the pipeline's options and others: no chain, C chains,
  equal weights at equal pos, assign past C - 1, two promotions, a drop
  by the first kept chain, random reads over three passes of slots; each
  case holds what it was made for.
Integer programs: tolerance 0."""

import ctypes
import inspect
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioseqdb_tpu.kernels import chain as jch
from bioseqdb_tpu.kernels import fm as jfm
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels import chain as tch
from bioseqdb_tpu_torch.kernels import chain_cuda as ccu
from bioseqdb_tpu_torch.tools import chain_calls as cc
from bioseqdb_tpu_torch.utils.sim import simulate_genome, simulate_reads

ALT = dict(mask_level=0.3, chain_drop_ratio=0.7, min_chain_weight=25)


def _edit(s, rng):
    """An indel or a clip: delete, insert or replace a run of bases."""
    p = int(rng.integers(20, len(s) - 30))
    k = int(rng.integers(1, 12))
    ins = "".join("ACGT"[c] for c in rng.integers(0, 4, k))
    return [s[:p] + s[p + k :], s[:p] + ins + s[p:], s[:p] + ins + s[p + k :]
            ][int(rng.integers(0, 3))][:150]


@pytest.fixture(scope="module")
def recorded():
    """The chain_seeds and filter_chains calls of a kmer-seeded CPU batch
    on a small genome with a repeat: simulated, edited, repeat-spanning
    and chimeric reads."""
    rng = np.random.default_rng(41)
    core = simulate_genome(50_000, seed=41)
    rep = simulate_genome(500, seed=42)
    g = core[:12000] + rep + core[12000:30000] + rep + core[30000:]
    idx = build_index([("g", g), ("h", simulate_genome(6_000, seed=43))])
    sim = simulate_reads(g, 60, read_len=150, sub_rate=0.02, seed=44)
    reads = list(sim.reads[:48]) + [_edit(r, rng) for r in sim.reads[48:]]
    reads += [g[12000 + 60 * k : 12150 + 60 * k] for k in range(6)]
    reads += [g[7000:7075] + g[40000:40075], g[30050:30130] + "N" * 4
              + g[100:166]]
    batch = pack_reads(reads, [f"r{i}" for i in range(len(reads))])
    calls = []
    with cc.recording(calls):
        Aligner.build(idx, AlignOptions(), device="cpu").device_regions(batch)
    return cc.pairs(calls)[0]


def _calls(case, recorded):
    if case == "recorded":
        return recorded
    rdt = torch.int64 if case == "edge int64" else torch.int32
    return cc.edge_calls(rdt)[:2]


def _rows(out: dict, idx) -> dict:
    return {k: v[idx] for k, v in out.items()}


def _cat(parts: list[dict]) -> dict:
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


@pytest.mark.parametrize("case", ["recorded", "edge int32", "edge int64"])
def test_lanes_are_independent(recorded, case):
    for call in _calls(case, recorded):
        whole = call.run(plain=True)
        B = call.dims[0]
        err = lambda got, want: cc.max_abs_err(got, want, call.kind)
        rev = torch.arange(B - 1, -1, -1)
        assert err(_rows(call.lanes(rev).run(plain=True), rev), whole) == 0
        half = B // 2
        halves = _cat([call.lanes(slice(0, half)).run(plain=True),
                       call.lanes(slice(half, B)).run(plain=True)])
        assert err(halves, whole) == 0
        for b in range(0, B, max(1, B // 12)):
            one = call.lanes(slice(b, b + 1)).run(plain=True)
            assert err(one, _rows(whole, slice(b, b + 1))) == 0, b


def _jax_fm(l_pac: int, rdt):
    fields = {f: jnp.zeros(1, jnp.int32) for f in jfm.FMDevice._fields}
    return jfm.FMDevice(**dict(fields, l_pac=jnp.asarray(l_pac, rdt)))


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("rank_dtype", [torch.int32, torch.int64])
def test_plain_twins_equal_jax_on_edge_seeds(rank_dtype):
    cs, fc, kinds = cc.edge_calls(rank_dtype)
    chains = cs.run(plain=True)
    seeds = cs.seeds
    with jax.enable_x64(rank_dtype == torch.int64):
        jdt = jnp.int64 if rank_dtype == torch.int64 else jnp.int32
        js = {k: jnp.asarray(v.numpy()) for k, v in seeds.items()}
        assert js["rbeg"].dtype == jdt
        jchains = _np(jax.device_get(jch.chain_seeds(
            _jax_fm(cs.args["fm"].l_pac, jdt), js, max_chains=cs.dims[2],
            **cc.CHAIN_OPTS)))
        for k in cc.CHAIN_OUT:
            assert np.array_equal(jchains[k], chains[k].numpy()), k
        jc = {k: jnp.asarray(v) for k, v in jchains.items()}
        for opts in (cc.FILTER_OPTS, dict(cc.FILTER_OPTS, **ALT)):
            want = _np(jax.device_get(jch.filter_chains(jc, js, **opts)))
            got = tch.filter_chains_plain(chains, seeds, **opts)
            for k in cc.FILTER_OUT:
                assert np.array_equal(want[k], got[k].numpy()), k
    # the cases the edge set was made for
    row = {k: kinds.index(k) for k in kinds}
    n, assign, ovf = chains["n"], chains["assign"], chains["overflow"]
    flt = fc.run(plain=True)
    kept, weight = flt["kept"], flt["weight"]
    assert ovf[row["overflow"]] and n[row["overflow"]] == cs.dims[2]
    assert (assign[row["contained"]] == -2).sum() == 2
    assert n[row["strand"]] == 3 and assign[row["strand"], 2] == 1
    r = row["equal_pos"]
    assert chains["pos"][r, 0] == chains["pos"][r, 1] and assign[r, 2] == 0
    r = row["equal_weight"]
    assert weight[r, 0] == weight[r, 1] == weight[r, 2] == 40
    assert n[row["invalid"]] == 0 and (assign[row["invalid"]] == -1).all()
    assert n[row["one_seed"]] == 1 and assign[row["one_seed"], 5] == 0
    assert kept[row["drop_after_sig"], :3].tolist() == [3, 3, 1]
    assert kept[row["drop_after_sig_overlap"], :3].tolist() == [2, 3, 0]
    assert (kept == 2).any() and (weight >= 0).sum() > 100
    if rank_dtype == torch.int64:
        assert int(seeds["rbeg"][seeds["valid"]].min()) >= 2 ** 31


def test_cpu_dispatch_runs_the_plain_twins(recorded, monkeypatch):
    def no_library(name):
        raise AssertionError(f"library {name} loaded on the CPU")

    monkeypatch.setattr(build, "library", no_library)
    n0 = {k: build.LAUNCHES[k] for k in ("chain_seeds", "filter_chains")}
    for call in recorded:
        assert cc.max_abs_err(call.run(), call.run(plain=True),
                              call.kind) == 0
    assert all(build.LAUNCHES[k] == v for k, v in n0.items())


@pytest.mark.parametrize("field,dtype", [
    ("rbeg", torch.float32), ("qbeg", torch.int64), ("len", torch.int16),
    ("rid", torch.int64), ("valid", torch.int32)])
def test_chain_wrapper_refuses_wrong_dtypes(monkeypatch, field, dtype):
    monkeypatch.setattr(build, "library", None)   # never reached
    cs, _, _ = cc.edge_calls(torch.int32)
    seeds = dict(cs.seeds, **{field: cs.seeds[field].to(dtype)})
    with pytest.raises(ValueError, match=field):
        ccu.chain_seeds_cuda(seeds, 100, 16, **cc.CHAIN_OPTS)


@pytest.mark.parametrize("field", ["pos", "n", "assign"])
def test_filter_wrapper_refuses_wrong_dtypes(monkeypatch, field):
    monkeypatch.setattr(build, "library", None)   # never reached
    _, fc, _ = cc.edge_calls(torch.int32)
    chains = dict(fc.args["chains"])
    chains[field] = chains[field].to(torch.int64 if field != "pos"
                                     else torch.int16)
    with pytest.raises(ValueError, match=field):
        ccu.filter_chains_cuda(chains, fc.seeds, **cc.FILTER_OPTS)


def test_wrappers_refuse_cpu_tensors_and_too_many_chains(monkeypatch):
    monkeypatch.setattr(build, "library", None)   # never reached
    cs, fc, _ = cc.edge_calls(torch.int32)
    l_pac = cs.args["fm"].l_pac
    with pytest.raises(ValueError, match="CUDA"):
        ccu.chain_seeds_cuda(cs.seeds, l_pac, 16, **cc.CHAIN_OPTS)
    with pytest.raises(ValueError, match="CUDA"):
        ccu.filter_chains_cuda(fc.args["chains"], fc.seeds, **cc.FILTER_OPTS)
    with pytest.raises(ValueError, match="max_chains"):
        ccu.chain_seeds_cuda(cs.seeds, l_pac, ccu.MAX_CHAINS + 1,
                             **cc.CHAIN_OPTS)
    wide = {k: v.repeat(1, 5) if v.dim() == 2 and v.shape[1] == 16 else v
            for k, v in fc.args["chains"].items()}
    with pytest.raises(ValueError, match="max_chains"):
        ccu.filter_chains_cuda(wide, fc.seeds, **cc.FILTER_OPTS)
    with pytest.raises(ValueError, match="l_pac"):
        ccu.chain_seeds_cuda(cs.seeds, 2 ** 31, 16, **cc.CHAIN_OPTS)


def test_kernel_constants_equal_the_modules():
    src = (build.CSRC / build.SOURCES["chain"]).read_text()
    consts = {k: int(v, 0) for k, v in re.findall(
        r"constexpr (?:int|long long) (\w+) = (-?\w+);", src)}
    assert consts["kMaxChains"] == ccu.MAX_CHAINS == 64
    assert consts["kNeg"] == tch.NEG == -(1 << 30)
    plain = inspect.getsource(tch.filter_chains_plain)
    assert consts["kBegFill"] == 1 << 29 and "zc(1 << 29)" in plain
    assert "rank_of, 1 << 29)" in plain
    assert consts["kPosFill"] == 0x7FFFFFFF and "0x7FFFFFFF)" in plain
    for k in ("chain_seeds", "filter_chains"):
        assert k in build.KERNELS and k in build.LAUNCHES
        assert f"LANE_ENTRY({k})" in src


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the lane bodies for the host")
    so = tmp_path_factory.mktemp("chain_host") / "libchain_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-o", str(so),
                    str(build.CSRC / build.SOURCES["chain"])], check=True)
    return ctypes.CDLL(str(so))


def _host_run(lib, call: cc.ChainCall) -> dict:
    a = call.args
    if call.kind == "chain_seeds":
        out, args, _ = ccu.chain_seeds_args(
            a["seeds"], a["fm"].l_pac, a["max_chains"], a["bandwidth"],
            a["max_chain_gap"])
    else:
        out, args, _ = ccu.filter_chains_args(
            a["chains"], a["seeds"], a["mask_level"], a["chain_drop_ratio"],
            a["min_chain_weight"], a["min_seed_len"], a["max_chain_gap"])
    assert ccu.bind(lib, f"{call.kind}_host", stream=False)(*args) == 0
    return out


@pytest.mark.parametrize("rank_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("S,C", [(64, 16), (189, 32), (378, 64)])
def test_host_build_of_the_lane_bodies_equals_plain(host_lib, rank_dtype, S,
                                                    C):
    cs, fc, _ = cc.edge_calls(rank_dtype, S=S, C=C)
    calls = [cs, fc, cc.ChainCall("filter_chains",
                                  dict(fc.args, **ALT))]
    for call in calls:
        assert cc.max_abs_err(_host_run(host_lib, call),
                              call.run(plain=True), call.kind) == 0


def test_host_build_equals_plain_on_a_recorded_batch(host_lib, recorded):
    cs, fc = recorded
    for call in (cs, fc, cs.lanes(slice(3, 40))):
        assert cc.max_abs_err(_host_run(host_lib, call),
                              call.run(plain=True), call.kind) == 0
    assert (cs.run(plain=True)["n"] > 1).any()


@pytest.mark.parametrize("rank_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", cc.GROUP_CASES)
def test_group_body_equals_plain_on_group_calls(host_lib, rank_dtype, case):
    for C in (8, 16, 64):
        call = cc.group_calls(rank_dtype, C)[case]
        want = call.run(plain=True)
        assert cc.max_abs_err(_host_run(host_lib, call), want,
                              call.kind) == 0, C
        seeds = call.seeds
        n_far = C // 2 + 1
        n, assign = int(want["n"][0]), want["assign"][0]
        rbeg = seeds["rbeg"][0]
        slot = lambda r, q: int(torch.nonzero(
            (rbeg == r) & (seeds["qbeg"][0] == q) & seeds["valid"][0])[0, 0])
        if case == "overflow at C":
            assert bool(want["overflow"][0]) and n == C
            assert int((assign[seeds["valid"][0]] == -1).sum()) == 3
        elif case == "contained on a later lane":
            assert int((assign == -2).sum()) == 2 and n == n_far + 1
        elif case == "equal pos across lanes":
            pos = want["pos"][0, :n]
            first = int(torch.nonzero(pos == pos[2])[0, 0])
            assert first == 2 and int((pos == pos[2]).sum()) >= 2
            last = int(torch.nonzero(seeds["valid"][0])[-1, 0])
            assert int(assign[last]) == 2
        elif case == "strand crossing on a later lane":
            l_pac = call.args["fm"].l_pac
            a = [int(assign[slot(l_pac + d, q)])
                 for d, q in ((-60, 0), (0, 60), (40, 100))]
            assert a[0] != a[1] == a[2] and n == n_far + 3
        else:
            first = 0 if case == "only chain below NEG" else n_far
            below = int(assign[slot(-(1 << 30) - 400, 100)])
            assert below == first + 1 and n == first + 3


@pytest.mark.parametrize("rank_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("C", [8, 16, 32, 64])
def test_filter_group_body_equals_plain_on_filter_calls(host_lib, rank_dtype,
                                                        C):
    call, kinds = cc.filter_calls(rank_dtype, C)
    for opts in (ALT, {}):
        c = cc.ChainCall("filter_chains", dict(call.args, **opts))
        want = c.run(plain=True)
        assert cc.max_abs_err(_host_run(host_lib, c), want, c.kind) == 0
    row = {k: kinds.index(k) for k in cc.FILTER_CASES}
    w, kept, order = want["weight"], want["kept"], want["order"]
    r = row["n 0"]
    assert (w[r] == -1).all() and (kept[r] == 0).all()
    assert (w[row["n C"]] >= 0).all()
    r = row["equal weight and pos"]
    assert w[r, :4].tolist() == [40] * 4 and order[r, :4].tolist() == [
        0, 1, 2, 3]
    r = row["ci past C - 1"]
    assert int(w[r, C - 1]) == 80 and int(order[r, 0]) == C - 1
    assert kept[row["two promotions"], :4].tolist() == [1, 1, 3, 3]
    assert kept[row["drop at the first kept chain"], :3].tolist() == [3, 2, 0]
    if rank_dtype == torch.int64:
        assert int(call.seeds["rbeg"].min()) >= 2 ** 31
