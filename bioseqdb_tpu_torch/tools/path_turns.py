"""Two trees of the repository in turns on one card: the main path, the
FM-seeded main path, the long-read leg and exact mode of each.

    python -m bioseqdb_tpu_torch.tools.path_turns OLD_ROOT NEW_ROOT [--turns 2]

Each turn starts a process of its own in one tree's root, which builds
that tree's kernels and runs its ``chip_smoke.py`` ``main_path``,
``fm_main_path``, ``long_path`` and ``exact_path`` (each checks truth
and the host oracle or the CPU path, as in ``chip_smoke.py``): OLD,
NEW, NEW, OLD for two turns, so that a drift of the card or its host
over the call falls on both trees. It prints the card line, then each
turn's lines that carry reads/s, a timed batch or a device step,
prefixed with the tree ("[old]", "[new]"); a turn that fails stops the
run. Unpack the other tree with ``git archive`` into a directory that
``.gitignore`` lists. Needs a CUDA device.
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


def turn(name: str, root: str) -> None:
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=root, text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for line in out.stdout.splitlines():
        if KEEP.search(line):
            print(f"[{name}] {line}", flush=True)
    if out.returncode != 0:
        raise SystemExit(f"the {name} tree's turn failed:\n"
                         f"{out.stdout[-3000:]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    print(card_line(), flush=True)
    trees = [("old", args.old), ("new", args.new)]
    for k in range(args.turns):
        for name, root in (trees if k % 2 == 0 else trees[::-1]):
            turn(name, root)


if __name__ == "__main__":
    main()
