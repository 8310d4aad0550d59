"""Dependent-gather-chain microbenchmark for a seeding mega-kernel.

The Hopper counterpart of ``tools/microbench_mosaic_seed.py``: can the
seeding state machine live in one kernel? Its binding cost is a chain of
dependent table-row gathers per lane (the next index derives from the
row just read). ``gather_chain`` (csrc/probes.cu) runs T such steps per
lane inside one kernel; every timing is the marginal between T = 1024
and T = 16384, so the launch and the fixed costs difference out.

Variants (the TPU tool's strategies A-E):
- 1 row:   r = tab[j, 0]                            (A, B and C)
- 2 rows:  r = tab[j, 0] + tab[(j * 40503 + 7) & mask, 0]  (A2, the FM
  fetch shape: occ at k and k + s)
- smem:    the same, the reachable column 0 copied to shared memory
  first (the TPU's VMEM-resident table), where it fits in 227 KB
- fresh:   the same with a per-step salt, so every step reads a new
  random row as the FM walk does; the tool's own step is one fixed
  random mapping, on which each lane soon circles a short cycle of
  cached rows (``kernels/probes.py``)
- floor D: r = 7, no load, every lane                (D)
- floor E: r = 0, no load, lane 0 only; the other lanes return their
  start index                                       (E)

Each variant is checked against its plain PyTorch version at both step
counts, bit for bit, and the plain version is timed at T = 1024. Runs
at the TPU tool's shape (128 lanes, a (16384, 128) table) and at the
seeding machine's: 16,384 lanes over the main-path Occ table and a
GRCh38-class one (``tools/shapes.py``). Needs a CUDA device; without one
it raises.

    python -m bioseqdb_tpu_torch.tools.microbench_seed [--seed S]
"""

from __future__ import annotations

import argparse

import torch

from bioseqdb_tpu_torch.kernels import probes
from bioseqdb_tpu_torch.tools import shapes

VARIANTS = {  # name: gather_chain keyword arguments
    "1 row": dict(rows=1),
    "2 rows": dict(rows=2),
    "1 row smem": dict(rows=1, smem=True),
    "2 rows smem": dict(rows=2, smem=True),
    "1 row fresh": dict(rows=1, salt=probes.FRESH_SALT),
    "2 rows fresh": dict(rows=2, salt=probes.FRESH_SALT),
    "floor D": dict(floor="d"),
    "floor E": dict(floor="e"),
}


def variants_for(mask: int) -> dict:
    """The variants a table with reachable rows [0, mask] can run."""
    fits = (mask + 1) * 4 <= probes.MAX_SMEM
    return {k: v for k, v in VARIANTS.items() if fits or not v.get("smem")}


def run_table(t: shapes.Table, seed: int, dev) -> dict:
    """Per variant: ``max_abs_err`` (0, or it raises), kernel ``ms`` at
    both step counts, ``plain_ms`` and ``rows_read`` (distinct table rows
    the chain reads) at T = 1024, and the marginal step."""
    tab, idx = shapes.make_table(t, seed, dev)
    mask = probes.chain_mask(t.rows)
    t1, t2 = shapes.SEED_STEPS
    res = {}
    for name, kw in variants_for(mask).items():
        def call(steps):
            return probes.gather_chain_cuda(tab, idx, steps, mask, **kw)

        def plain(steps, seen=None):
            return probes.gather_chain_plain(tab, idx, steps, mask, **kw,
                                             seen=seen)
        seen = torch.zeros(mask + 1, dtype=torch.bool, device=dev)
        err = max(shapes.max_abs_err(call(t1), plain(t1, seen)),
                  shapes.max_abs_err(call(t2), plain(t2)))
        if err:
            raise AssertionError(f"gather_chain [{name}] != plain on {t.name}")
        ms1 = shapes.event_ms(lambda: call(t1), reps=5)
        ms2 = shapes.event_ms(lambda: call(t2), reps=5)
        plain_ms = shapes.event_ms(lambda: plain(t1), reps=3)
        us_step = (ms2 - ms1) * 1e3 / (t2 - t1)
        res[name] = dict(max_abs_err=err, ms=(ms1, ms2), plain_ms=plain_ms,
                         rows_read=int(seen.sum()), us_per_step=us_step,
                         ns_per_row=us_step * 1e3 / t.lanes)
        print(f"{t.name}, {t.lanes} lanes, {name:12s} ok  call "
              f"{ms1:8.3f}/{ms2:9.3f} ms  marginal {us_step:8.4f} us/step "
              f"({us_step * 1e3 / t.lanes:8.4f} ns/row)  plain {plain_ms:9.3f}"
              f" ms at T={t1}", flush=True)
    del tab
    return res


def run(seed: int = 0) -> dict:
    dev = shapes.require_cuda()
    out = {t.name: run_table(t, seed, dev)
           for t in (shapes.SEED_TOOL, shapes.OCC_MAIN, shapes.OCC_GRCH38)}
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
