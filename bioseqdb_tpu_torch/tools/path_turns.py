"""Two trees of the repository in turns on one card: the main path, the
FM-seeded main path, the long-read leg and exact mode of each; with
``--dist N``, each tree's ``tools/dist_leg.py --reads N`` instead (its
three mesh cells, each run clocked and unclocked); with ``--split K``,
each tree's ``index`` 2 cell on dist_leg's 16,384-read batch, its device
step clocked K times in the same ranks (the first is the ranks'
warm-up), each run's stage split and collectives a JSON line.

    python -m bioseqdb_tpu_torch.tools.path_turns OLD_ROOT NEW_ROOT \
        [--turns 2] [--dist N | --split K]

Each turn starts a process of its own in one tree's root, which builds
that tree's kernels and runs its ``chip_smoke.py`` ``main_path``,
``fm_main_path``, ``long_path`` and ``exact_path`` (each checks truth
and the host oracle or the CPU path, as in ``chip_smoke.py``): OLD,
NEW, NEW, OLD for two turns, so that a drift of the card or its host
over the call falls on both trees. It prints the card line, then each
turn's lines that carry reads/s, a timed batch or a device step,
prefixed with the tree ("[old]", "[new]"); a turn that fails stops the
run (with ``--dist``, each cell's JSON line). Unpack the other tree
with ``git archive`` into a directory that ``.gitignore`` lists. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys

from bioseqdb_tpu_torch.tools.shapes import card_line

CHILD = """
import sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.tools.shapes import card_line
dev = torch.device("cuda", 0)
card = card_line()
build.build()
m = cs.main_path(dev, card)
cs.fm_main_path(m, dev, card)
cs.long_path(m, card)
cs.exact_path(m, dev, card)
"""
KEEP = re.compile(r"reads/s|device step|timed batch")
DIST_CHILD = """
import sys
sys.path.insert(0, ".")
from bioseqdb_tpu_torch.tools import dist_leg
dist_leg.main(["--reads", sys.argv[1]])
"""
DIST_KEEP = re.compile(r'^\{"cell"')
SPLIT_CHILD = """
import json, sys
sys.path.insert(0, ".")
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.tools import dist_leg, long_leg
from bioseqdb_tpu_torch.utils.sim import simulate_genome
build.build()
genome = simulate_genome(dist_leg.GENOME_LEN, seed=dist_leg.GENOME_SEED)
_, batch = long_leg.simulate(genome, dist_leg.BATCH, dist_leg.READ_SEED,
                             dist_leg.READ_LEN)
jobs = [dict(kind="regions", batch=batch, clock=True)
        for _ in range(int(sys.argv[1]))]
res, backend = dist_leg.spawn_tasks(
    [dict(cell=((2,), ("index",)), idx=build_index([("sim", genome)]),
          jobs=jobs)], 2, "cuda")
for k, job in enumerate(res[0]["tasks"][0]["jobs"]):
    print(json.dumps(dict(split=k, backend=backend,
                          step=job["seconds"]["device_regions"],
                          stages={n: v for n, v in job["stages"].items()
                                  if n in long_leg.CLOCKED},
                          collectives=job["collectives"])), flush=True)
"""
SPLIT_KEEP = re.compile(r'^\{"split"')


def turn(name: str, root: str, dist: int = 0, split: int = 0) -> None:
    if split:
        cmd, keep = [sys.executable, "-c", SPLIT_CHILD, str(split)], SPLIT_KEEP
    elif dist:
        cmd, keep = [sys.executable, "-c", DIST_CHILD, str(dist)], DIST_KEEP
    else:
        cmd, keep = [sys.executable, "-c", CHILD], KEEP
    out = subprocess.run(cmd, cwd=root, text=True, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT)
    for line in out.stdout.splitlines():
        if keep.search(line):
            print(f"[{name}] {line}", flush=True)
    if out.returncode != 0:
        raise SystemExit(f"the {name} tree's turn failed:\n"
                         f"{out.stdout[-3000:]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--dist", type=int, default=0, metavar="N",
                    help="run each tree's dist leg on N reads instead")
    ap.add_argument("--split", type=int, default=0, metavar="K",
                    help="clock each tree's index cell K times instead")
    args = ap.parse_args(argv)
    print(card_line(), flush=True)
    trees = [("old", args.old), ("new", args.new)]
    for k in range(args.turns):
        for name, root in (trees if k % 2 == 0 else trees[::-1]):
            turn(name, root, args.dist, args.split)


if __name__ == "__main__":
    main()
