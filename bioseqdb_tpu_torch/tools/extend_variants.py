"""Variants of csrc/extend.cu in turns on one card: this tree's source with
some of its layout constants changed, and another tree's.

    python -m bioseqdb_tpu_torch.tools.extend_variants \\
        --variant NAME:CONST=VALUE[,CONST=VALUE...] ... [--other ROOT]

Run from this tree's root. Builds this tree's ``extend.cu``, each
``--variant`` (the source with each ``constexpr int CONST`` set to VALUE,
e.g. ``half-warp:kScanGroup=16``) and ROOT's (nvcc, the package's flags,
into ``_build/variants``), and prints each build's ``-Xptxas -v`` lines
for the scan and merge entries. Runs ``chip_smoke.py``'s main path and
long-read path once on this tree's kernels, recording their
``extend_all`` calls; for each of their ``extend_scan`` and
``extend_merge`` stage calls holds every build bit-equal to the plain
twin, then times them in palindromic turns (this, the variants, other,
and back; ``StageCall.kernel_ms``: a launch in a CUDA graph). A line a
kernel and call: each build's two times summed over the call's
launches, beside ``chip_smoke.extend_bound``. Unpack the other tree with
``git archive`` into a directory that ``.gitignore`` lists. Needs a CUDA
device.
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
from bioseqdb_tpu_torch.tools import extend_calls
from bioseqdb_tpu_torch.tools.kernel_turns import EXTEND_TIMED, loading
from bioseqdb_tpu_torch.tools.shapes import card_line

OUT = build.BUILD_DIR / "variants"


def variant_source(text: str, consts: dict) -> str:
    """``text`` with each ``constexpr int NAME = ...;`` of ``consts`` set
    to its value; raises for a name the source does not define once."""
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = -?\w+;",
                          f"constexpr int {name} = {int(value)};", text)
        if n != 1:
            raise ValueError(f"extend.cu defines {name} {n} times, not once")
    return text


def parse_variant(spec: str) -> tuple[str, dict]:
    """NAME:CONST=VALUE,... as (NAME, {CONST: VALUE})."""
    name, _, body = spec.partition(":")
    consts = dict(kv.split("=", 1) for kv in body.split(",") if kv)
    if not name or not consts:
        raise ValueError(f"a variant is NAME:CONST=VALUE[,...], not {spec!r}")
    return name, consts


def build_all(sources: dict) -> dict:
    """{name: CDLL} of ``sources`` ({name: (csrc dir, source text)}), one
    nvcc each, concurrently; logs each build's scan and merge lines."""
    procs = {}
    for name, (csrc, text) in sources.items():
        d = OUT / re.sub(r"\W", "_", name)
        d.mkdir(parents=True, exist_ok=True)
        (d / "extend.cu").write_text(text)
        (d / "lanes.cuh").write_text((csrc / "lanes.cuh").read_text())
        so = d / "libextend.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
             str(d / "extend.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        keep = False
        for line in log.splitlines():
            if "Compiling entry" in line:
                keep = "scan" in line or "merge" in line
            if keep and any(k in line for k in ("Compiling entry",
                                                "registers", "stack frame")):
                cs.log(f"ptxas extend [{name}]: {line.strip()}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def turns(name: str, call: "extend_calls.ExtendCall", libs: dict) -> None:
    """Log EXTEND_TIMED's launches in ``call`` on every build of ``libs``,
    in palindromic turns, summed over the call (each merge entry apart)."""
    names = list(libs)
    order = names + names[::-1]
    _, stages = call.stages()
    sums = {}
    for st in stages:
        if st.kind not in EXTEND_TIMED:
            continue
        want = st.run(plain=True)
        for n in names:
            with loading({"extend": libs[n]}):
                got = st.run()
                torch.cuda.synchronize()
            if extend_calls.max_abs_err(got, want) != 0:
                raise AssertionError(f"{n} disagrees with the plain twin on "
                                     f"{st.name} of {name}")
        t_bytes, t_ops, _ = cs.extend_bound(st, want)
        r = sums.setdefault(st.name, dict(
            n=0, bound=0.0, ms={k: [0.0, 0.0] for k in names}))
        r["n"] += 1
        r["bound"] += max(t_bytes, t_ops)
        seen = dict.fromkeys(names, 0)
        for n in order:
            with loading({"extend": libs[n]}):
                r["ms"][n][seen[n]] += st.kernel_ms()
            seen[n] += 1
    for kernel, r in sums.items():
        cs.log(f"{kernel} [{name}] {call.shape}, {r['n']} launches summed, "
               f"bound {r['bound']:.5f} ms: " + "; ".join(
                   f"{n} {a:.4f} / {b:.4f} ms ({100 * r['bound'] / a:.2f}%)"
                   for n, (a, b) in r["ms"].items())
               + " (turns " + ", ".join(order) + ")")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    type=parse_variant)
    ap.add_argument("--other", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("extend_variants needs a CUDA device")
    card = card_line()
    cs.log(card)
    text = (build.CSRC / build.SOURCES["extend"]).read_text()
    sources = {"this": (build.CSRC, text)}
    for name, consts in args.variant:
        sources[name] = (build.CSRC, variant_source(text, consts))
    if args.other is not None:
        csrc = args.other / "bioseqdb_tpu_torch" / "csrc"
        sources["other"] = (csrc, (csrc / build.SOURCES["extend"]).read_text())
    libs = build_all(sources)
    build.build()
    dev = torch.device("cuda", 0)
    m = cs.main_path(dev, card)
    lr = cs.long_path(m, card)
    for name, call in (("main path", m["ext_calls"][0]),
                       ("long-read warm-up", lr["ext_calls"][0])):
        turns(name, call, libs)
    cs.log(card)


if __name__ == "__main__":
    main()
