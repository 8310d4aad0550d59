"""Variants of csrc/extend.cu, csrc/fm.cu or csrc/seedsw.cu in turns on
one card: this tree's source with some of its layout constants changed,
and another tree's.

    python -m bioseqdb_tpu_torch.tools.extend_variants \\
        --variant NAME:CONST=VALUE[,CONST=VALUE...] ... [--other ROOT] \\
        [--source extend|fm|seedsw] [--only KIND,...]

Run from this tree's root. Builds this tree's source (``extend.cu`` by
default, ``fm.cu`` with ``--source fm``), each ``--variant`` (the source
with each ``constexpr int CONST`` set to VALUE, e.g.
``half-warp:kScanGroup=16``) and ROOT's (nvcc, the package's flags, into
``_build/variants``), and prints each build's ``-Xptxas -v`` lines for
the entries of the kernels timed. Runs ``chip_smoke.py``'s main path, PE
path and long-read path once on this tree's kernels, recording their
calls. ``extend``: for each stage call of the main path's, the PE step's
fat retry (S 128) and the long-read warm-up's ``extend_all`` calls whose
kind ``--only`` names (comma-separated, of
``kernel_turns.EXTEND_TIMED``; all of them by default), and of the int64
warm-up's (``kernel_turns.int64_calls``); ``fm``: the ``sa_resolve``
calls ``kernel_turns.walk_calls`` gives (each path's masked walk, the
exact step's and random ranks) and the ``backward_search`` calls
``kernel_turns.search_calls`` gives (the exact step's, random and edge
reads), as ``--only`` names them; ``seedsw``: the whole filter calls
(``seedsw_calls.FilterCall``) of the long-read warm-up and timed
batches and of the 8, 18 and 25 kb batches. Each
call holds every build bit-equal
to the plain twin, then times them in palindromic turns (this, the
variants, other, and back; ``kernel_ms``: a launch in a CUDA graph). A
line a kernel and call: each build's two times (an extension kernel's
summed over the call's launches), beside the bound
(``chip_smoke.extend_bound``, ``kernel_turns.walk_bound``). Unpack the
other tree with ``git archive`` into a directory that ``.gitignore``
lists. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.tools import extend_calls, fm_calls, seedsw_calls
from bioseqdb_tpu_torch.tools.kernel_turns import (EXTEND_TIMED, fat_retry,
                                                  int64_calls, loading,
                                                  search_calls, walk_bound,
                                                  walk_calls)
from bioseqdb_tpu_torch.tools.shapes import card_line

OUT = build.BUILD_DIR / "variants"
FM_TIMED = ("sa_resolve", "backward_search")   # --source fm's kinds


def variant_source(text: str, consts: dict) -> str:
    """``text`` with each ``constexpr int NAME = ...;`` of ``consts`` set
    to its value; raises for a name the source does not define once."""
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = -?\w+;",
                          f"constexpr int {name} = {int(value)};", text)
        if n != 1:
            raise ValueError(f"the source defines {name} {n} times, not "
                             "once")
    return text


def parse_variant(spec: str) -> tuple[str, dict]:
    """NAME:CONST=VALUE,... as (NAME, {CONST: VALUE})."""
    name, _, body = spec.partition(":")
    consts = dict(kv.split("=", 1) for kv in body.split(",") if kv)
    if not name or not consts:
        raise ValueError(f"a variant is NAME:CONST=VALUE[,...], not {spec!r}")
    return name, consts


def build_all(sources: dict, source: str, keys: tuple) -> dict:
    """{name: CDLL} of ``sources`` ({name: (csrc dir, text of ``source``)}),
    one nvcc each, concurrently; logs each build's lines of the entries
    whose names hold one of ``keys``."""
    procs = {}
    file = build.SOURCES[source]
    for name, (csrc, text) in sources.items():
        d = OUT / re.sub(r"\W", "_", name)
        d.mkdir(parents=True, exist_ok=True)
        (d / file).write_text(text)
        for h in csrc.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        so = d / f"lib{source}.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(d / file)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        keep = False
        for line in log.splitlines():
            if "Compiling entry" in line:
                keep = any(k in line for k in keys)
            if keep and any(k in line for k in ("Compiling entry",
                                                "registers", "stack frame")):
                cs.log(f"ptxas {source} [{name}]: {line.strip()}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def in_turns(call, libs: dict, source: str, err) -> tuple[dict, object]:
    """({build: [ms, ms]}, the plain twin's output) of ``call`` on every
    build of ``libs`` in palindromic turns, each build first held
    bit-equal to the plain twin (``err(got, want) == 0``)."""
    names = list(libs)
    want = call.run(plain=True)
    for n in names:
        with loading({source: libs[n]}):
            got = call.run()
            torch.cuda.synchronize()
        if err(got, want) != 0:
            raise AssertionError(f"{n} disagrees with the plain twin on "
                                 f"{call.shape}")
    ms = {n: [] for n in names}
    for n in names + names[::-1]:
        with loading({source: libs[n]}):
            ms[n].append(call.kernel_ms())
    return ms, want


def line(kernel: str, name: str, shape: str, ms: dict, bound: float,
         extra: str = "") -> str:
    order = list(ms) + list(ms)[::-1]
    return (f"{kernel} [{name}] {shape}{extra}, bound {bound:.5f} ms: "
            + "; ".join(f"{n} {a:.4f} / {b:.4f} ms ({100 * bound / a:.2f}%)"
                        for n, (a, b) in ms.items())
            + " (turns " + ", ".join(order) + ")")


def extend_turns(name: str, call: "extend_calls.ExtendCall", libs: dict,
                 only: tuple = EXTEND_TIMED) -> None:
    """Log the launches in ``call`` of the kinds ``only`` names on every
    build of ``libs``, in palindromic turns, summed over the call (each
    merge entry apart)."""
    _, stages = call.stages()
    sums = {}
    for st in stages:
        if st.kind not in only:
            continue
        ms, want = in_turns(st, libs, "extend", extend_calls.max_abs_err)
        t_bytes, t_ops, _ = cs.extend_bound(st, want)
        r = sums.setdefault(st.name, dict(
            n=0, bound=0.0, ms={k: [0.0, 0.0] for k in libs}))
        r["n"] += 1
        r["bound"] += max(t_bytes, t_ops)
        for k, t in ms.items():
            r["ms"][k] = [a + b for a, b in zip(r["ms"][k], t)]
    for kernel, r in sums.items():
        cs.log(line(kernel, name, call.shape, r["ms"], r["bound"],
                    f", {r['n']} launches summed"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    type=parse_variant)
    ap.add_argument("--other", type=Path)
    ap.add_argument("--source", choices=("extend", "fm", "seedsw"),
                    default="extend")
    ap.add_argument("--only", default=",".join(EXTEND_TIMED),
                    help="the extension kernels to time, comma-separated")
    args = ap.parse_args(argv)
    only = tuple(args.only.split(","))
    kinds = FM_TIMED if args.source == "fm" else EXTEND_TIMED
    if args.source == "fm" and args.only == ",".join(EXTEND_TIMED):
        only = FM_TIMED
    if args.source != "seedsw" and not set(only) <= set(kinds):
        raise SystemExit(f"--only takes kinds of {kinds}")
    if not torch.cuda.is_available():
        raise SystemExit("extend_variants needs a CUDA device")
    card = card_line()
    cs.log(card)
    file = build.SOURCES[args.source]
    text = (build.CSRC / file).read_text()
    sources = {"this": (build.CSRC, text)}
    for name, consts in args.variant:
        sources[name] = (build.CSRC, variant_source(text, consts))
    if args.other is not None:
        csrc = args.other / "bioseqdb_tpu_torch" / "csrc"
        sources["other"] = (csrc, (csrc / file).read_text())
    keys = (only if args.source == "fm"
            else ("seed_sw",) if args.source == "seedsw"
            else tuple(k.removeprefix("extend_") for k in only))
    libs = build_all(sources, args.source, keys)
    build.build()
    dev = torch.device("cuda", 0)
    m = cs.main_path(dev, card)
    if args.source == "seedsw":
        lr = cs.long_path(m, card)
        huge = cs.huge_reads_path(m)
        for name, call in (("long-read warm-up", lr["sw_calls"][0][0]),
                           ("long-read timed", lr["sw_calls"][1][0]),
                           ("8 kb", lr["sw_wide"][0]),
                           *((f"{k} kb", c) for k, c in huge.items())):
            ms, _ = in_turns(call, libs, "seedsw", seedsw_calls.max_abs_err)
            n = call.counts()
            cs.log(line("seed_sw", name, call.shape, ms,
                        cs.bound(n["read"] + n["written"], n["instr"])[0]))
        cs.log(card)
        return
    if args.source == "extend" or "sa_resolve" in only:
        pe_walks = []
        with fm_calls.recording(pe_walks):
            pe = cs.pe_path(m, card)
        pe["fmi_calls"] = pe_walks
        lr = cs.long_path(m, card)
        i64 = int64_calls(m, dev)
    if args.source == "fm":
        calls = []
        if "sa_resolve" in only:
            fmp = cs.fm_main_path(m, dev, card)
            paths = {"main path": m, "PE": pe, "FM-seeded": fmp,
                     "long-read warm-up": lr, "int64": i64}
            calls += walk_calls(paths, m, dev, card)
        if "backward_search" in only:
            calls += search_calls(m, dev, card)
        for name, call in calls:
            ms, _ = in_turns(call, libs, "fm", lambda got, want:
                             fm_calls.max_abs_err(got, want, call.kind))
            cs.log(line(call.kind, name, call.shape, ms,
                        walk_bound(call)[0]))
    else:
        calls = [("main path", m["ext_calls"][0]),
                 ("PE fat retry", fat_retry(pe["ext_calls"])),
                 ("long-read warm-up", lr["ext_calls"][0]),
                 ("int64", i64["ext_calls"][0])]
        for name, call in calls:
            if call is not None:
                extend_turns(name, call, libs, only)
    cs.log(card)


if __name__ == "__main__":
    main()
