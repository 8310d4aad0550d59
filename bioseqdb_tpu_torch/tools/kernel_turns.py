"""Another tree's ``kmer_seed``, ``fm_seed``, ``chain_seeds``,
``filter_chains``, ``extend_setup``, ``extend_scan``, ``extend_merge``,
``extend_seedcov``, ``resolve_expand``, ``sa_resolve``, ``seed_sw`` and
``backward_search`` against this tree's, in turns on one card, at the
calls the pipeline gives them.

    python -m bioseqdb_tpu_torch.tools.kernel_turns OTHER_ROOT [--only K,..]

Run from this tree's root. Builds OTHER_ROOT's ``csrc/kmer.cu``,
``csrc/fm_seed.cu``, ``csrc/extend.cu``, ``csrc/chain.cu``,
``csrc/resolve.cu`` and ``csrc/fm.cu`` (nvcc, the package's flags, into
``_build/other``) and this tree's, and prints each build's ``-Xptxas
-v`` lines (registers, stack frame, spills). Runs ``chip_smoke.py``'s
main, PE, FM-seeded and long-read paths once on this tree's kernels,
recording their calls, and the int64 warm-up batch (the main path's
first batch with int64 ranks forced): the main path's and the PE step's
kmer calls; the machine calls of the main path's reseed entry, the
FM-seeded batch and the long-read warm-up; the chain_seeds and
filter_chains calls, the ``resolve_seeds`` calls and the stage calls of
the ``extend_all`` calls of the main path, the PE step (and its fat
retry, S 128), the FM-seeded batch, the long-read warm-up and the int64
batch (``ExtendCall.stages``); the ``sa_resolve`` walks of the same
paths' ``resolve_seeds`` calls (masked), and, unmasked, the exact step's
(``chip_smoke.exact_path``, with ``--only`` naming ``sa_resolve``) and
65,536 random ranks on ``fm_calls``' edge index at SA interval 32;
``backward_search`` on the exact step and on ``fm_calls``' random reads
(4,096 of 0-120 bp, seed 1) and edge reads (``edge_calls`` "reads" and
``group_calls``); ``seed_sw`` as the whole filter call
(``seedsw_calls.FilterCall``) of the long-read warm-up and timed
batches and of the 8, 18 and 25 kb batches (``chip_smoke.long_path``,
``huge_reads_path``): this tree's one launch against, for a tree whose
``csrc/seedsw.cu`` has the scores entry alone (``seed_sw_launch``),
that tree's filter: the eager windows (``seed_sw_windows``), its
scores launch and the keep / score selects. Each
call is checked bit-equal to the plain twin on both trees' kernels (the
C entry points take the same arguments; a ``resolve_seeds`` call runs
both of the tree's resolve kernels), then timed on them in turns:
other, this, this, other (``KmerCall.kernel_ms``,
``ChainCall.kernel_ms``, ``ResolveCall.expand_ms``,
``StageCall.kernel_ms`` and ``FmCall.kernel_ms``: a launch in a CUDA
graph; ``MachineCall.kernel_ms``: CUDA events, median of 3). A line a
call: both trees' times, the bound (``chip_smoke.bound`` / ``fm_bound``
/ ``chain_bound`` / ``extend_bound``; ``FmCall.counts`` for the walk)
and each share of it; for the machine also its slowest lane's steps (so
us a step) and the backward share of the summed steps; for the
extension kernels, each kernel summed over the call's launches
(``extend_merge left`` and ``right`` apart). ``--only`` times the
kernels it names alone (comma-separated; all by default). Unpack the
other tree with ``git archive`` into a directory that ``.gitignore``
lists. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from bioseqdb_tpu_torch.kernels import build, seedsw
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels.seed import build_r3_jump
from bioseqdb_tpu_torch.tools import (chain_calls, extend_calls, fm_calls,
                                      fm_machine, kmer_calls, long_leg,
                                      resolve_calls, seedsw_calls, shapes)
from bioseqdb_tpu_torch.tools.shapes import card_line

SOURCES = ("kmer", "fm_seed", "extend", "chain", "resolve", "fm", "seedsw")
# the extension kernels timed in turns (the others are another tree's too)
EXTEND_TIMED = ("extend_setup", "extend_scan", "extend_merge",
                "extend_seedcov")
TIMED = ("kmer_seed", "fm_seed", "chain_seeds", "filter_chains",
         "resolve_expand", "sa_resolve", "seed_sw",
         "backward_search") + EXTEND_TIMED
FAT_S = 128   # the PE fat retry's seed slots
ORDER = ("other", "this", "this", "other")


def ptxas_lines(log: str) -> list[str]:
    """The ``-Xptxas -v`` lines of a build's log that say what a kernel
    uses."""
    keys = ("Compiling entry", "registers", "stack frame")
    return [ln.strip() for ln in log.splitlines() if any(k in ln for k in keys)]


def build_other(root: Path) -> dict:
    """{source name: (CDLL, nvcc log)} of ``root``'s SOURCES, built
    concurrently."""
    out = build.BUILD_DIR / "other"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        src = root / "bioseqdb_tpu_torch" / "csrc" / build.SOURCES[name]
        so = out / f"lib{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {root}'s {name}:\n{log}")
        libs[name] = (ctypes.CDLL(str(so)), log)
    return libs


@contextlib.contextmanager
def loading(libs: dict | None):
    """Within the block the wrappers launch from ``libs`` ({source name:
    CDLL}) in place of this tree's libraries (None: this tree's)."""
    saved = build.library
    if libs is not None:
        build.library = lambda name: libs.get(name) or saved(name)
    try:
        yield
    finally:
        build.library = saved


def eager_filter(call: "seedsw_calls.FilterCall", lib: ctypes.CDLL) -> dict:
    """``call`` as a tree whose seedsw.cu has the scores entry alone
    (``seed_sw_launch``: the scores of given windows) filters:
    ``seedsw.seed_sw_windows`` as eager ops, that entry's one launch, then
    the keep and score selects (the filter before the window bounds
    joined the kernel)."""
    a = call.args
    win = seedsw.seed_sw_windows(a["fm"], a["lens"], a["seeds"],
                                 a["match_score"], a["min_chain_weight"])
    codes, pac_rows = a["codes"], a["pac_rows"]
    B, W = codes.shape
    N = win["need"].shape[0]
    score = torch.empty(N, dtype=torch.int32, device=codes.device)
    ins = [codes, pac_rows] + [win[k] for k in ("qb", "qe", "rb", "re",
                                                "need")] + [score]
    fn = lib.seed_sw_launch
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = [ll] + [vp] * 8 + [ll] * 11 + [vp]
    fn.restype = ctypes.c_int
    rc = fn(win["rb"].element_size(), *[t.data_ptr() for t in ins],
            pac_rows.numel(), a["fm"].seq_len, N, N // B, W,
            *[a[k] for k in seedsw_calls.SCORING],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("the other tree's seed_sw launch failed")
    need = win["need"]
    S = N // B
    keep = ~need | (score >= win["min_hsp"])
    slen = a["seeds"]["len"].reshape(N)
    return dict(valid=(a["seeds"]["valid"].reshape(N) & keep).reshape(B, S),
                score=torch.where(need, score, slen * a["match_score"]
                                  ).reshape(B, S).to(torch.int32))


def filter_turns(name: str, call: "seedsw_calls.FilterCall", other: dict
                 ) -> None:
    """Log the whole filter ``call`` on both trees in turns (a call in a
    CUDA graph), each first held bit-equal to ``seed_sw_filter_plain``,
    with the bound (``FilterCall.counts``) and the first count's."""
    lib = other["seedsw"]
    old = ((lambda: eager_filter(call, lib))
           if not hasattr(lib, "seed_sw_filter_launch") else None)

    def run(tree):
        if tree == "this" or old is None:
            with loading(other if tree == "other" else None):
                return call.run()
        return old()

    want = call.run(plain=True)
    for tree in ("other", "this"):
        got = run(tree)
        torch.cuda.synchronize()
        if seedsw_calls.max_abs_err(got, want) != 0:
            raise AssertionError(f"{tree} tree's filter disagrees with the "
                                 f"plain twin on {call.shape}")
    times = {"other": [], "this": []}
    for tree in ORDER:
        with loading(other if tree == "other" else None):
            times[tree].append(shapes.graph_ms(lambda: run(tree)))
    n = call.counts()
    bound_ms, bound_by = cs.bound(n["read"] + n["written"], n["instr"])
    first, _ = cs.bound(n["read"] + n["written"], n["instr_first"])
    cs.log(turn_line("seed_sw", name, call, times, bound_ms, bound_by)
           + f"; {n['lanes']} lanes need the SW, {n['cells']} DP cells; the "
             f"first count's bound {first:.5f} ms")


def in_turns(call, other: dict) -> dict:
    """{tree: [ms, ms]} of ``call`` timed in ORDER, each tree's kernel
    first held bit-equal to the plain twin (a ``ResolveCall``: the whole
    call through the tree's kernels, its ``resolve_expand`` timed)."""
    err = (fm_machine.max_abs_err
           if isinstance(call, fm_machine.MachineCall)
           else extend_calls.max_abs_err
           if isinstance(call, extend_calls.StageCall)
           else (lambda got, want: chain_calls.max_abs_err(got, want,
                                                           call.kind))
           if isinstance(call, chain_calls.ChainCall)
           else resolve_calls.max_abs_err
           if isinstance(call, resolve_calls.ResolveCall)
           else (lambda got, want: fm_calls.max_abs_err(got, want,
                                                        call.kind))
           if isinstance(call, fm_calls.FmCall)
           else kmer_calls.max_abs_err)
    ms = (call.expand_ms if isinstance(call, resolve_calls.ResolveCall)
          else call.kernel_ms)
    want = call.run(plain=True)
    times = {"other": [], "this": []}
    for tree in ("other", "this"):
        with loading(other if tree == "other" else None):
            got = call.run()
            torch.cuda.synchronize()
        if err(got, want) != 0:
            raise AssertionError(f"{tree} tree's kernel disagrees with the "
                                 f"plain twin on {call.shape}")
    for tree in ORDER:
        with loading(other if tree == "other" else None):
            times[tree].append(ms())
    return times


def int64_calls(m: dict, dev) -> dict:
    """The ``extend_all`` call (``ext_calls``), the chaining calls
    (``ch_calls``), the ``resolve_seeds`` calls (``res_calls``) and the
    FM index's (``fmi_calls``) of the main path's warm-up batch with
    int64 ranks forced (``chip_smoke.int64_path``'s Aligner)."""
    fm64 = kfm.FMDevice.from_host(m["idx"], dev, rank_dtype=torch.int64)
    al = dataclasses.replace(m["al"], fm=fm64, jump=build_r3_jump(fm64))
    ext, ch, res, fmi = [], [], [], []
    with (extend_calls.recording(ext), chain_calls.recording(ch),
          resolve_calls.recording(res), fm_calls.recording(fmi)):
        long_leg.run_batch(al, m["batches"][0])
    return dict(ext_calls=ext, ch_calls=ch, res_calls=res, fmi_calls=fmi)


def fat_retry(calls: list):
    """The first of ``calls`` (``extend_all`` or ``sa_resolve`` calls) at
    the fat retry's S (FAT_S), or None."""
    for c in calls:
        S = (c.dims[1] if isinstance(c, extend_calls.ExtendCall)
             else c.args["ranks"].shape[-1] if c.kind == "sa_resolve"
             else None)
        if S == FAT_S:
            return c
    return None


def walks(calls: list) -> list:
    """The ``sa_resolve`` calls of ``calls`` (fm_calls)."""
    return [c for c in calls if c.kind == "sa_resolve"]


def walk_calls(paths: dict, m: dict, dev, card: str) -> list:
    """[(name, call)]: the ``sa_resolve`` walks of ``paths`` ({name:
    chip_smoke path dict with ``fmi_calls``}: each path's first, and the
    PE fat retry's (FAT_S) where ``paths`` has "PE"), masked; then,
    unmasked, the exact step's (``chip_smoke.exact_path`` on ``m``'s
    index) and 65,536 random ranks on ``fm_calls``' edge index at SA
    interval 32."""
    out = []
    for name, d in paths.items():
        sa = walks(d["fmi_calls"])
        out.append((name, sa[0]))
        if name == "PE" and fat_retry(sa) is not None:
            out.append(("PE fat retry", fat_retry(sa)))
    ex = cs.exact_path(m, dev, card)
    es = fm_calls.edge_setup()
    fm = kfm.FMDevice.from_host(es.idx, dev)
    return out + [("exact step", walks(ex["fmi_calls"])[0]),
                  ("random, interval 32", fm_calls.random_calls(
                      es, fm, 1, device=dev, n_ranks=65536,
                      n_reads=16)["random ranks 1"])]


def search_calls(m: dict, dev, card: str) -> list:
    """[(name, call)]: the ``backward_search`` calls timed: the exact
    step's (``chip_smoke.exact_path`` on ``m``'s index), 4,096 random
    reads (``fm_calls.random_calls`` seed 1) and the edge reads
    (``edge_calls`` "reads", ``group_calls``) on ``fm_calls``' edge
    index."""
    ex = cs.exact_path(m, dev, card)
    es = fm_calls.edge_setup()
    fm = kfm.FMDevice.from_host(es.idx, dev)
    out = [("exact step", [c for c in ex["fmi_calls"]
                           if c.kind == "backward_search"][0]),
           ("random reads", fm_calls.random_calls(
               es, fm, 1, device=dev, n_ranks=16,
               n_reads=4096)["random reads 1"]),
           ("edge reads", fm_calls.edge_calls(es, fm, device=dev)["reads"])]
    return out + list(fm_calls.group_calls(es, fm, device=dev).items())


def walk_bound(call: "fm_calls.FmCall") -> tuple[float, str]:
    """``chip_smoke.bound`` of an ``sa_resolve`` or ``backward_search``
    call (``FmCall.counts``: the distinct table rows, the ranks, mask and
    positions or the lengths, codes and intervals; the steps'
    instructions)."""
    n = call.counts()
    return cs.bound(n["table_bytes"] + n["io_bytes"], n["instr"])


def extend_turns(name: str, call: "extend_calls.ExtendCall", other: dict,
                 only: tuple = EXTEND_TIMED) -> None:
    """Log the launches in ``call`` of the kernels ``only`` names (each
    entry of ``extend_merge`` apart), summed over the call, in turns."""
    _, stages = call.stages()
    sums = {}
    for st in stages:
        if st.kind not in only:
            continue
        times = in_turns(st, other)
        t_bytes, t_ops, _ = cs.extend_bound(st, st.run())
        r = sums.setdefault(st.name, dict(
            n=0, other=[0.0, 0.0], this=[0.0, 0.0], t_bytes=0.0, t_ops=0.0))
        r["n"] += 1
        for tree in ("other", "this"):
            r[tree] = [a + b for a, b in zip(r[tree], times[tree])]
        r["t_bytes"] += t_bytes
        r["t_ops"] += t_ops
    for kernel, r in sums.items():
        by = "bytes" if r["t_bytes"] >= r["t_ops"] else "operations"
        cs.log(turn_line(kernel, name, call, r, max(r["t_bytes"], r["t_ops"]),
                         by) + f"; {r['n']} launches summed")


def turn_line(kernel: str, name: str, call, times: dict, bound_ms: float,
              bound_by: str) -> str:
    fmt = lambda t: " / ".join(f"{x:.4f}" for x in t)
    share = lambda t: " / ".join(f"{100 * bound_ms / x:.2f}%" for x in t)
    return (f"{kernel} [{name}] {call.shape}: other {fmt(times['other'])} "
            f"ms, this {fmt(times['this'])} ms (in turns: other, this, "
            f"this, other); bound {bound_ms:.5f} ms ({bound_by}): other "
            f"{share(times['other'])}, this {share(times['this'])}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--only", default=",".join(TIMED),
                    help="the kernels to time, comma-separated")
    args = ap.parse_args(argv)
    only = tuple(args.only.split(","))
    if not set(only) <= set(TIMED):
        raise SystemExit(f"--only takes kernels of {TIMED}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_turns needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = card_line()
    cs.log(card)
    logs = build.build(SOURCES)
    other = build_other(args.other)
    for name in SOURCES:
        for tree, log in (("other", other[name][1]),
                          ("this", logs.get(name, ""))):
            for line in ptxas_lines(log):
                cs.log(f"ptxas {name} [{tree}]: {line}")
    other = {name: lib for name, (lib, _) in other.items()}
    build.build()
    m = cs.main_path(dev, card)
    pe_walks = []
    with fm_calls.recording(pe_walks):
        pe = cs.pe_path(m, card)
    pe["fmi_calls"] = pe_walks
    fmp = cs.fm_main_path(m, dev, card)
    lr = cs.long_path(m, card)
    if "kmer_seed" in only:
        for name, call in (("main path", m["km_calls"][0]),
                           ("PE", pe["km_calls"][0])):
            times = in_turns(call, other)
            n = call.counts()
            cs.log(turn_line("kmer_seed", name, call, times,
                             *cs.bound(n["read"] + n["written"], n["instr"])))
    if "fm_seed" in only:
        for name, call in (("reseed entry", m["fm_calls"][0]),
                           ("FM-seeded", fmp["fm_calls"][0]),
                           ("long-read warm-up", lr["fm_calls"][0])):
            times = in_turns(call, other)
            _, out, touched = call.plain_ms()
            steps = out["iters"]
            slow, summed = int(steps.max()), int(steps.sum())
            us = lambda t: " / ".join(f"{1e3 * x / slow:.3f}" for x in t)
            cs.log(turn_line("fm_seed", name, call, times,
                             *cs.fm_bound(call, out, touched))
                   + f"; slowest lane {slow} steps: us a step other "
                     f"{us(times['other'])}, this {us(times['this'])}; "
                     f"backward steps {touched['bwd']} of {summed} summed "
                     f"({100 * touched['bwd'] / max(summed, 1):.1f}%)")
    i64 = int64_calls(m, dev)
    paths = {"main path": m, "PE": pe, "FM-seeded": fmp,
             "long-read warm-up": lr, "int64": i64}
    for k, kind in enumerate(cs.CHAIN_KERNELS):
        if kind not in only:
            continue
        for name, d in paths.items():
            call = chain_calls.pairs(d["ch_calls"])[0][k]
            times = in_turns(call, other)
            cs.log(turn_line(kind, name, call, times,
                             *cs.chain_bound(call, call.run())[:2]))
    if "resolve_expand" in only:
        for name, d in paths.items():
            call = d["res_calls"][0]
            times = in_turns(call, other)
            ex, _, _ = call.stages()
            c = call.counts(ex, call.run())["expand"]
            cs.log(turn_line("resolve_expand", name, call, times,
                             *cs.bound(c["read"] + c["written"], c["instr"])))
    timed = tuple(k for k in EXTEND_TIMED if k in only)
    if timed:
        ext = [(name, d["ext_calls"][0]) for name, d in paths.items()]
        fat = fat_retry(pe["ext_calls"])
        if fat is not None:
            ext.insert(2, ("PE fat retry", fat))
        for name, call in ext:
            extend_turns(name, call, other, timed)
    if "sa_resolve" in only:
        for name, call in walk_calls(paths, m, dev, card):
            times = in_turns(call, other)
            cs.log(turn_line("sa_resolve", name, call, times,
                             *walk_bound(call)))
    if "backward_search" in only:
        for name, call in search_calls(m, dev, card):
            times = in_turns(call, other)
            cs.log(turn_line("backward_search", name, call, times,
                             *walk_bound(call))
                   + f"; slowest read "
                     f"{int(fm_calls.search_steps(call)['steps'].max())} "
                     f"steps")
    if "seed_sw" in only:
        huge = cs.huge_reads_path(m)
        for name, call in (("long-read warm-up", lr["sw_calls"][0][0]),
                           ("long-read timed", lr["sw_calls"][1][0]),
                           ("8 kb", lr["sw_wide"][0]),
                           *((f"{k} kb", c) for k, c in huge.items())):
            filter_turns(name, call, other)


if __name__ == "__main__":
    main()
