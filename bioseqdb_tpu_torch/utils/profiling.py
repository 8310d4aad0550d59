"""Tracing and per-stage throughput counters.

The port of ``bioseqdb_tpu/utils/profiling.py``: ``device_trace`` records
a ``torch.profiler`` trace (host ops, and the card's kernels when a card
is present) and writes it as a Chrome trace, viewable in
ui.perfetto.dev or chrome://tracing; ``StageTimer`` accumulates host
wall-clock seconds and item counts per pipeline stage and reports them
as one JSON line (reads/s is the north-star metric).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass, field

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(trace_dir: str):
    """Record the enclosed block with ``torch.profiler`` and write the
    Chrome trace to ``trace_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


@dataclass
class StageTimer:
    """Accumulates wall-clock + item counts per pipeline stage."""

    times: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, n_items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + n_items

    def report(self, fh=None) -> dict:
        """Print ``{"stages": {name: {seconds, items, items_per_s}}}`` as
        one JSON line to ``fh`` (default: the current ``sys.stderr``)."""
        out = {}
        for name, t in self.times.items():
            n = self.counts.get(name, 0)
            out[name] = {
                "seconds": round(t, 4),
                "items": n,
                "items_per_s": round(n / t, 1) if t > 0 and n else None,
            }
        print(json.dumps({"stages": out}), file=fh or sys.stderr, flush=True)
        return out
