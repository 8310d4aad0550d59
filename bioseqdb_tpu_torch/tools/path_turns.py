"""Two trees of the repository in turns on one card: the main path, the
FM-seeded main path, the long-read leg and exact mode of each; with
``--dist N``, each tree's ``tools/dist_leg.py --reads N`` instead (its
three mesh cells, each run clocked and unclocked).

    python -m bioseqdb_tpu_torch.tools.path_turns OLD_ROOT NEW_ROOT \
        [--turns 2] [--dist N]

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


def turn(name: str, root: str, dist: int = 0) -> None:
    cmd = ([sys.executable, "-c", DIST_CHILD, str(dist)] if dist
           else [sys.executable, "-c", CHILD])
    out = subprocess.run(cmd, cwd=root, text=True, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT)
    keep = DIST_KEEP if dist else KEEP
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
    args = ap.parse_args(argv)
    print(card_line(), flush=True)
    trees = [("old", args.old), ("new", args.new)]
    for k in range(args.turns):
        for name, root in (trees if k % 2 == 0 else trees[::-1]):
            turn(name, root, args.dist)


if __name__ == "__main__":
    main()
