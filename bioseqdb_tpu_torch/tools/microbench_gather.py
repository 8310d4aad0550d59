"""Row-gather and launch-cost microbenchmark on the card.

The Hopper counterpart of ``tools/microbench_pallas_gather.py``: the
FM-index hot loop is a dependent chain of table-row gathers, so this
measures

1. a check: ``gather_rows`` (csrc/probes.cu) equals ``tab[idx]``, and
   one call's device time (from a CUDA graph of 20 calls) beside the plain
   gather's (eager, CUDA events) and ``torch.index_select``'s (graph);
2. a dependent chain of 100 gathers, the next indices computed from the
   rows read (``(idx * 48271 + row[:, 0] + 11) % N``), with the kernel
   and with the plain PyTorch gather: microseconds per gather and
   nanoseconds per row, device time from a CUDA graph of the chain;
3. the cost of one launch: ``add_one`` on int32 (8, 128) chained 100
   times, launched eagerly from Python and replayed as one CUDA graph;
   and one call timed as in 1, beside ``x + 1`` and ``torch.add``.

It runs at the TPU tool's shape (a (20480, 16) table, 8192 lanes) and at
the seeding machine's: 16,384 lanes over the main-path Occ table and a
GRCh38-class one (``tools/shapes.py``). Needs a CUDA device; without one
it raises.

    python -m bioseqdb_tpu_torch.tools.microbench_gather [--seed S]
"""

from __future__ import annotations

import argparse

import torch

from bioseqdb_tpu_torch.kernels import probes
from bioseqdb_tpu_torch.tools import shapes

CHAIN = 100


def gather_chain(gather, tab: torch.Tensor, idx: torch.Tensor
                 ) -> torch.Tensor:
    """``CHAIN`` dependent gathers; returns the last indices."""
    n = tab.shape[0]
    for _ in range(CHAIN):
        rows = gather(tab, idx)
        idx = ((idx.long() * probes.GATHER_A + rows[:, 0] + 11) % n
               ).to(torch.int32)
    return idx


def launch_chain(add_one, x: torch.Tensor) -> torch.Tensor:
    for _ in range(CHAIN):
        x = add_one(x)
    return x


def run_table(t: shapes.Table, seed: int, dev) -> dict:
    """``max_abs_err`` (0, or it raises); one call's ``ms``, ``plain_ms``
    and ``library_ms``; ``rows_read`` (distinct rows gathered); and the
    chain's time a gather, kernel and plain."""
    tab, idx = shapes.make_table(t, seed, dev)
    err = shapes.max_abs_err(probes.gather_rows_cuda(tab, idx),
                             probes.gather_rows_plain(tab, idx))
    if err or not torch.equal(
            gather_chain(probes.gather_rows_cuda, tab, idx),
            gather_chain(probes.gather_rows_plain, tab, idx)):
        raise AssertionError(f"gather_rows != tab[idx] on {t.name}")
    res = dict(max_abs_err=err,
               ms=shapes.graph_ms(lambda: probes.gather_rows_cuda(tab, idx)),
               plain_ms=shapes.event_ms(
                   lambda: probes.gather_rows_plain(tab, idx)),
               library_ms=shapes.graph_ms(
                   lambda: torch.index_select(tab, 0, idx)),
               rows_read=int(torch.unique(idx).numel()))
    print(f"{t.name}: gather_rows == tab[idx], chains of {CHAIN} equal; "
          f"one call {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
          f"index_select {res['library_ms']:.4f} ms", flush=True)
    for side, fn in (("kernel", probes.gather_rows_cuda),
                     ("plain", probes.gather_rows_plain)):
        ms = shapes.graph_ms(lambda: gather_chain(fn, tab, idx), calls=1,
                             reps=5)
        us = ms * 1e3 / CHAIN
        res[side] = dict(us_per_gather=us, ns_per_row=us * 1e3 / t.lanes)
        print(f"{t.name}, {t.lanes} lanes, {side:6s}: {us:9.3f} us/gather "
              f"({us * 1e3 / t.lanes:7.4f} ns/row), chain of {CHAIN}",
              flush=True)
    del tab
    return res


def run_launch(dev) -> dict:
    """``max_abs_err`` (0, or it raises); one call's ``ms``, ``plain_ms``
    and ``library_ms`` as in ``run_table``; microseconds a launch in the
    chain, eagerly and in a CUDA graph."""
    x = torch.zeros(8, 128, dtype=torch.int32, device=dev)
    err = shapes.max_abs_err(launch_chain(probes.add_one_cuda, x),
                             launch_chain(probes.add_one_plain, x))
    if err:
        raise AssertionError("add_one chain != x + 100")
    one = dict(max_abs_err=err,
               ms=shapes.graph_ms(lambda: probes.add_one_cuda(x)),
               plain_ms=shapes.event_ms(lambda: probes.add_one_plain(x)),
               library_ms=shapes.graph_ms(lambda: torch.add(x, 1)))
    eager = shapes.event_ms(lambda: launch_chain(probes.add_one_cuda, x),
                            reps=5) * 1e3 / CHAIN
    graph = shapes.graph_ms(lambda: launch_chain(probes.add_one_cuda, x),
                            calls=1, reps=5) * 1e3 / CHAIN
    print(f"add_one launch: eager {eager:.3f} us/launch, CUDA graph "
          f"{graph:.3f} us/launch ({CHAIN} chained launches); one call "
          f"{one['ms']:.4f} ms, x + 1 {one['plain_ms']:.4f} ms, torch.add "
          f"{one['library_ms']:.4f} ms", flush=True)
    return dict(one, eager_us=eager, graph_us=graph)


def run(seed: int = 0) -> dict:
    dev = shapes.require_cuda()
    out = {t.name: run_table(t, seed, dev)
           for t in (shapes.GATHER_TOOL, shapes.OCC_MAIN, shapes.OCC_GRCH38)}
    out["launch"] = run_launch(dev)
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(torch.cuda.get_device_name(0) if torch.cuda.is_available()
          else "no CUDA device", flush=True)
    run(args.seed)


if __name__ == "__main__":
    main()
