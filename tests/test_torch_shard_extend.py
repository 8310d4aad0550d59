"""The index mesh's window fetch, ``resolve_seeds`` and backward search on
their hand kernels, on the CPU (the kernels themselves run only on the
card: ``tests/test_torch_dist_cuda.py``).

``csrc/extend.cu`` (``windows_shard_query`` and ``extend_windows`` in its
summed-target mode), ``csrc/resolve.cu`` (``resolve_expand``,
``resolve_finish``) and ``csrc/fm_shard.cu`` (the sharded SA walk's and
the backward search's query and apply), compiled for the host with g++
(their ``*_host`` entries), run through the same host loops as on the
card (``extend.extend_windows_sharded``, ``chain.resolve_seeds_sharded``,
``fm.search_sharded``: a query, the ``all_reduce`` and an apply) in gloo
ranks spawned through ``dist/launch.py`` (``tools/shard_calls.py``
``route_rank``; one spawn a world size, together; the children import
the port alone), at ``index`` 2 with int32 ranks and ``index`` 3 (uneven
shards) with int64 ranks, on the 30 kb genome of seed 81 and a contig
that repeats its first 400 bases (``shard_calls.edge_refs``), indexed at
SA interval 32. Each rank's index-mesh step (``device_regions``) on the
120 bp reads of ``shard_calls.edge_batches`` (and at ``index`` 2 its
250 bp reads) and on eight reads at the strands' boundary
(``shard_calls.strand_batch``) is recorded, then:

- every window fetch it made equals ``extend_windows_plain(..., group)``
  on all seven outputs, with equal ``COLLECTIVES`` calls and bytes; the
  recorded windows reach past the text's ends and across the strands'
  boundary, and reference windows cut some short;
- every ``resolve_seeds`` call (B * S at most 4,096) equals
  ``resolve_seeds_plain(..., group)`` on its six outputs, calls and
  bytes equal, and so do the first call's reads three times over (B * S
  8,640) walked at every lane, at the JAX buffer's cap and at a cap of
  600 lanes that cuts reads (they overflow);
- the backward search equals ``backward_search_plain(..., group)`` on
  ``shard_calls.search_batch``: exact reads of both strands, repeat
  copies, full-width reads, reads with an N, empty, all-N and junk
  reads;
- on CPU tensors under the group the three dispatchers take their plain
  twins and no rank builds or loads a kernel library;
- the sources' argument counts equal the wrappers'.

The JAX parity of the three functions stays with
``tests/test_torch_shard_index.py``. Skipped without g++. Integer
programs: tolerance 0. The plain twins run on one intra-op thread
(``dist/launch.py`` sets it in every rank).
"""

import concurrent.futures
import re
import shutil

import numpy as np
import pytest
import torch

from bioseqdb_tpu_torch.dist import launch
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels import extend_cuda as ecu
from bioseqdb_tpu_torch.kernels import fm_shard_cuda as fsc
from bioseqdb_tpu_torch.tools import shard_calls as sc
from bioseqdb_tpu_torch.utils.sim import simulate_genome

# world size: (rank dtype, batches of the recorded step)
WORLDS = {2: (torch.int32, ("short", "wide", "strand")),
          3: (torch.int64, ("short", "strand"))}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels' bodies for the host")
    libs = sc.host_libraries(tmp_path_factory.mktemp("route_host"))
    refs = sc.edge_refs(simulate_genome(30_000, seed=81))
    idx = build_index(refs, sa_interval=32)
    short, wide = sc.edge_batches(refs)
    batches = dict(short=short, wide=wide, strand=sc.strand_batch(refs))
    search = sc.search_batch(refs, short)
    pool = concurrent.futures.ThreadPoolExecutor(len(WORLDS))
    spawns = {n: pool.submit(launch.spawn, sc.route_rank, n, "gloo",
                             ("cpu", libs, idx, [batches[b] for b in bs],
                              search, (dt,)), 600.0)
              for n, (dt, bs) in WORLDS.items()}
    res = {n: f.result() for n, f in spawns.items()}
    pool.shutdown()
    return res


def _rows(run, world):
    for r in run[world]:
        (d,) = r["dtypes"]
        assert d["rank_dtype"] == str(WORLDS[world][0])
        yield r["rank"], d


def _equal(pair, rank, what):
    k, p = pair["kernel"], pair["plain"]
    for name in p["out"]:
        assert np.array_equal(k["out"][name], p["out"][name]), (rank, what,
                                                                name)
    assert k["collectives"]["calls"] == p["collectives"]["calls"] > 0, what
    assert k["collectives"]["bytes"] == p["collectives"]["bytes"], what
    assert sc.max_abs_err(pair) == 0


def test_children_import_the_port_alone(run):
    assert all(not r["forbidden"] for rs in run.values() for r in rs)


@pytest.mark.parametrize("world", list(WORLDS))
def test_window_fetch_equals_plain_twin(run, world):
    for rank, d in _rows(run, world):
        assert len(d["windows"]) >= 2
        for i, pair in enumerate(d["windows"]):
            _equal(pair, rank, f"window fetch {i}")
            assert set(pair["plain"]["out"]) == set(sc.WINDOW_OUTPUTS)


@pytest.mark.parametrize("world", list(WORLDS))
def test_windows_reach_the_text_and_strand_edges(run, world):
    for _, d in _rows(run, world):
        reach = d["reach"]
        assert reach["lanes"] > 0
        assert reach["text_end"] > 0 and reach["strand"] > 0, reach
        assert reach["clipped"] > 0, reach


@pytest.mark.parametrize("world", list(WORLDS))
def test_resolve_equals_plain_twin(run, world):
    for rank, d in _rows(run, world):
        rows = d["resolve"]
        assert any(r["lanes"] <= 4096 for r in rows)
        assert [r["cap"] for r in rows if r["lanes"] > 4096] == [None, 0, 600]
        for i, pair in enumerate(rows):
            _equal(pair, rank, f"resolve {i}")
        # the 600-lane cap cuts reads: they overflow where the others do not
        wide = {r["cap"]: r["plain"]["out"] for r in rows if r["lanes"] > 4096}
        assert (wide[600]["overflow"] & ~wide[None]["overflow"]).any()
        assert wide[600]["valid"].sum() < wide[None]["valid"].sum()


@pytest.mark.parametrize("world", list(WORLDS))
def test_backward_search_equals_plain_twin(run, world):
    for rank, d in _rows(run, world):
        pair = d["search"]
        _equal(pair, rank, "backward search")
        # a step a column: W, the batch's width (120 bp padded)
        assert pair["kernel"]["collectives"]["calls"] >= 120
        lo, hi = pair["kernel"]["out"]["lo"], pair["kernel"]["out"]["hi"]
        n = hi - lo
        assert (n[:16] == 1).sum() >= 12 and (n[16:19] == 2).all()
        assert (n[19:21] >= 1).all() and n[21] == 0   # the N kills it
        assert (lo[n == 0] == 0).all() and (hi[n == 0] == 0).all()


def test_cpu_tensors_take_the_plain_twins(run):
    for rs in run.values():
        for r in rs:
            assert r["dispatch"] and r["built"] == 0


def test_kernel_arguments_equal_the_wrappers():
    src = (build.CSRC / build.SOURCES["fm_shard"]).read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr (?:int|long long) (\w+) = (\d+);", src)}
    assert consts["kBsArgs"] == fsc.BS_ARGS
    args = re.search(r"inline bool bs_params.*?\n}\n", src, re.S).group(0)
    fields = re.findall(r"p\.(\w+) = ", args)
    assert len(fields) == fsc.BS_ARGS and fields[fsc.BS_STEP] == "t"
    for k in fsc.SEARCH_ENTRIES:
        assert k in build.SEARCH_SHARD_KERNELS and k in build.PATH_KERNELS
        assert f"LANE_ENTRY({k})" in src
    ext = (build.CSRC / build.SOURCES["extend"]).read_text()
    entry = re.search(r"LANE_ENTRY\(windows_shard_query\).*?\n}\n", ext,
                      re.S).group(0)
    reads = re.findall(r"g\.(ptr|num)<?", entry)
    # the rank size, the pointers (seeds() reads four), the sizes
    assert len(reads) + 4 == 1 + len(ecu.WINDOWS_QUERY_ARGS) + 8
    assert "windows_shard_query" in build.WINDOWS_SHARD_KERNELS
    assert "windows_shard_query" in build.PATH_KERNELS
