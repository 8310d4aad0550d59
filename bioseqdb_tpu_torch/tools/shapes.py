"""Shapes, seeded tables and CUDA timers shared by the probe
microbenchmarks and ``chip_smoke.py``.

Two sets of shapes:
- the TPU tools' own (``tools/microbench_pallas_gather.py``: a
  (20480, 16) table, 8192 lanes; ``tools/microbench_mosaic_seed.py``: a
  (16384, 128) table, 128 lanes, T in {1024, 16384});
- the seeding machine's: 16,384 lanes (the main-path batch) over an Occ
  table of 12 int32 per 128 doubled bases, for the 4.6 Mb main-path
  genome (71,875 rows, 3.45 MB, L2-resident) and for a GRCh38-class
  genome (6.2e9 doubled bases: 48,437,500 rows, 2.3 GB, device memory).

Tables are filled on the card from a seeded ``torch.Generator``.
"""

from __future__ import annotations

import statistics
from typing import NamedTuple

import torch

VALUE_RANGE = 1 << 20          # table values, as in the TPU tools
MAIN_LANES = 16_384
OCC_COLS = 12


class Table(NamedTuple):
    name: str
    rows: int
    cols: int
    lanes: int


GATHER_TOOL = Table("tool (20480, 16)", 20_480, 16, 8_192)
SEED_TOOL = Table("tool (16384, 128)", 16_384, 128, 128)
OCC_MAIN = Table("main-path occ (71875, 12)", 71_875, OCC_COLS, MAIN_LANES)
OCC_GRCH38 = Table("GRCh38-class occ (48437500, 12)", 48_437_500, OCC_COLS,
                   MAIN_LANES)
SEED_STEPS = (1024, 16384)     # the TPU tool's in-kernel step counts


def require_cuda() -> torch.device:
    """The first CUDA device; raises without one (the probes measure the
    card and never fall back to the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probe microbenchmarks need a CUDA device")
    return torch.device("cuda", 0)


def make_table(t: Table, seed: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """(int32 (rows, cols) table of values in [0, 2^20), int32 (lanes,)
    start indices in [0, rows)), both made on ``dev`` from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    tab = torch.randint(0, VALUE_RANGE, (t.rows, t.cols), generator=g,
                        dtype=torch.int32, device=dev)
    idx = torch.randint(0, t.rows, (t.lanes,), generator=g,
                        dtype=torch.int32, device=dev)
    return tab, idx


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest absolute difference of two integer tensors of one shape;
    raises if the shapes differ."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def event_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of one ``fn()`` (CUDA events around each
    call), after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_of(fn, calls: int = 20) -> "torch.cuda.CUDAGraph":
    """A CUDA graph of ``calls`` back-to-back ``fn()`` calls (one warm-up
    call outside the capture). ``fn`` must not synchronise."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Median device milliseconds per ``fn()``, from a CUDA graph of
    ``calls`` back-to-back calls replayed ``reps`` times: the host's
    enqueue time of each call does not count. ``fn`` must not
    synchronise."""
    return event_ms(graph_of(fn, calls).replay, reps) / calls


def turns_ms(fns: dict, reps: int = 10, rounds: int = 2) -> dict:
    """Each ``fn``'s median milliseconds (``event_ms``), timed in turns in
    one process: the order of ``fns``, then the reverse, ``rounds``
    times (old, new, new, old for two). Returns {name: [ms of each
    turn]}."""
    names = list(fns)
    out = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            out[n].append(event_ms(fns[n], reps))
    return out
