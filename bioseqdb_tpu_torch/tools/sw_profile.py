"""Where the banded-SW kernel spends its time, on the card.

    python -m bioseqdb_tpu_torch.tools.sw_profile [--turns LABEL=SOURCE ...]

1. Builds ``csrc/sw_extend.cu`` with ``-DSW_PROFILE``, which turns on its
   ``clock64()`` marks between the phases of a row (set-up, pass 1, the F
   scan, pass 2, the fix-ups, the reductions, the lane's update, the
   end-of-row sync), and runs lanes whose lane 0 is timed: one wide lane
   alone, the same lane among 16,384 copies, and one narrow lane alone.
   Prints the mean cycles a row of each phase.
2. Counts the DPX and other instructions of interest in the SASS of the
   package's own build (``cuobjdump -sass``).
3. With ``--turns``: builds each other ``sw_extend`` source given (one
   with the same C entry point ``sw_extend_launch``, such as an earlier
   version from git), checks it bit-equal to the plain version, and times
   it in turns with the package's kernel (the package's, the others, the
   others again in reverse, four turns each; device time a launch in a
   CUDA graph) on the synthetic case set and on each SW launch of the
   main path's warm-up batch (``tools/sw_sets.py``).

The builds here are for measurement only: they launch through their own
binding, never count as the package's launches, and the package never
loads them. Needs a CUDA device and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import re
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels.sw import FIELDS
from bioseqdb_tpu_torch.kernels.sw_cuda import sw_extend_cuda
from bioseqdb_tpu_torch.tools import sw_sets
from bioseqdb_tpu_torch.tools.shapes import graph_of, require_cuda, turns_ms

PHASES = ("total", "set-up", "pass 1", "scan", "pass 2", "fix-ups",
          "reductions", "lane update", "sync")
SASS_OPS = ("VIADDMNMX", "VIMNMX3", "VIMNMX", "PRMT", "SHFL", "LDS", "STS")
TURNS = 4


def build_sources(specs: dict) -> dict:
    """{label: (source path, tuple of -D flags)} built with the package's
    nvcc flags, one ``nvcc`` each, all at once, into the package's build
    directory under a hash of source and flags. Returns {label:
    (ctypes.CDLL, nvcc log)}; raises with the log if a build fails."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, (src, defines) in specs.items():
        h = hashlib.sha1(Path(src).read_bytes())
        h.update(repr(tuple(defines)).encode())
        dst = build.BUILD_DIR / f"libsw_measure-{h.hexdigest()[:12]}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS,
               *(f"-D{d}" for d in defines), "-o", str(dst), str(src)]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        dst)
    out = {}
    for label, (proc, dst) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{text}")
        out[label] = (ctypes.CDLL(str(dst)), text)
    return out


def launcher(lib: ctypes.CDLL):
    """A function with ``sw_cuda.sw_extend_cuda``'s signature that
    launches ``lib``'s ``sw_extend_launch`` on the current stream (inputs
    as the package's wrapper takes them, unchecked)."""
    fn = lib.sw_extend_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(query, qlen, target, tlen, w0, h0, *, match_score,
               mismatch_penalty, o_del, e_del, o_ins, e_ins, end_bonus, zdrop):
        B, WQ = query.shape
        out = torch.empty(6, B, dtype=torch.int32, device=query.device)
        rc = fn(query.data_ptr(), qlen.data_ptr(), target.data_ptr(),
                tlen.data_ptr(), w0.data_ptr(), h0.data_ptr(), out.data_ptr(),
                B, WQ, int(target.shape[1]), match_score, mismatch_penalty,
                o_del, e_del, o_ins, e_ins, end_bonus, zdrop,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"sw_extend_launch failed: CUDA error {rc}")
        return dict(zip(FIELDS, out))

    return launch


def lanes(dev, qlen: int, tlen: int, h0: int, n: int, seed: int):
    """n copies of one read-like lane: a query, and a target that starts
    with it and runs on with random bases."""
    rng = np.random.default_rng(seed)
    qq = rng.integers(0, 4, qlen)
    tt = np.concatenate([qq, rng.integers(0, 4, tlen - qlen)])
    q = torch.full((n, sw_sets.MAIN_WQ), 4, dtype=torch.int32)
    t = torch.full((n, sw_sets.MAIN_WT), 4, dtype=torch.int32)
    q[:, :qlen] = torch.from_numpy(qq)
    t[:, :tlen] = torch.from_numpy(tt)
    vec = lambda v: torch.full((n,), v, dtype=torch.int32)
    return [x.to(dev) for x in (q, vec(qlen), t, vec(tlen), vec(100), vec(h0))]


def profile(dev) -> dict:
    src = build.CSRC / build.SOURCES["sw_extend"]
    lib, _ = build_sources({"profile": (src, ("SW_PROFILE",))})["profile"]
    launch = launcher(lib)
    kw = dict(match_score=1, mismatch_penalty=4, end_bonus=5, zdrop=100,
              **sw_sets.SW_GAPS)
    out = {}
    for label, args in (("wide lane (qlen 150, tlen 400, h0 60) alone",
                         (150, 400, 60, 1)),
                        ("the same lane, 16,384 copies", (150, 400, 60, 16384)),
                        ("narrow lane (qlen 20, tlen 400, h0 130) alone",
                         (20, 400, 130, 1))):
        call = lanes(dev, *args, seed=3)
        launch(*call, **kw)
        torch.cuda.synchronize()
        if lib.sw_prof_zero() != 0:
            raise RuntimeError("sw_profile: zeroing the counters failed")
        launch(*call, **kw)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 10)()
        if lib.sw_prof_read(buf) != 0:
            raise RuntimeError("sw_profile: reading the counters failed")
        rows = max(buf[9], 1)
        out[label] = dict(rows=buf[9], **{name: buf[k] / rows
                                          for k, name in enumerate(PHASES)})
        print(f"{label}: {buf[9]} rows; cycles a row: " + ", ".join(
            f"{name} {buf[k] / rows:.0f}" for k, name in enumerate(PHASES)),
            flush=True)
    return out


def sass_census() -> dict:
    build.build(["sw_extend"])
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build.lib_path("sw_extend"))], check=True,
                          capture_output=True, text=True).stdout
    ops = collections.Counter(
        m.group(1) for m in re.finditer(r"\s([A-Z][A-Z0-9]*(?:\.[A-Z0-9x.]+)?)\s",
                                        sass)
        if m.group(1).split(".")[0] in SASS_OPS)
    print("SASS of the package's sw_extend: " + ", ".join(
        f"{op} {n}" for op, n in sorted(ops.items())), flush=True)
    return dict(ops)


def main_path_calls(dev) -> list:
    """The SW launches of the main path's warm-up batch, recorded."""
    idx, al, _, batches, _ = sw_sets.main_path_setup(dev)
    calls = []
    with sw_sets.recording(calls):
        al.absorb_overflow(batches[0], al.device_regions(batches[0]))
    return calls


def turns(dev, sources: dict) -> dict:
    """The package's kernel and each of ``sources`` ({label: path}) in
    turns on the synthetic set and each recorded main-path launch.
    Returns {input name: {label: [ms a launch of each turn]}}."""
    libs = build_sources({k: (p, ()) for k, p in sources.items()})
    for label, (_, text) in libs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {label}: {line.strip()}", flush=True)
    launches = {"this": sw_extend_cuda,
                **{k: launcher(lib) for k, (lib, _) in libs.items()}}
    synthetic = next(sw_sets.SwCall.from_cases(cases, *opts, dev)
                     for name, cases, *opts in
                     sw_sets.sw_sets(np.random.default_rng(7))
                     if name == "synthetic")
    inputs = [("synthetic", synthetic)] + [
        (f"main-path launch {k}", c) for k, c in enumerate(main_path_calls(dev))]
    out, sums = {}, {}
    for name, call in inputs:
        ref = call.plain()
        for label, launch in launches.items():
            if call.err(ref, launch):
                raise AssertionError(f"{label} disagrees with plain on {name}")
        graphs = {label: graph_of(lambda f=launch: call.kernel(f),
                                  sw_sets.SW_CALLS)
                  for label, launch in launches.items()}
        ms = {k: [t / sw_sets.SW_CALLS for t in v] for k, v in turns_ms(
            {k: g.replay for k, g in graphs.items()}, reps=10,
            rounds=TURNS).items()}
        out[name] = ms
        print(f"turns [{name}, {call.shape()}]: " + "; ".join(
            f"{k} {', '.join(f'{v:.4f}' for v in ts)} ms (median "
            f"{statistics.median(ts):.4f})" for k, ts in ms.items()),
            flush=True)
        if name != "synthetic":
            for k, ts in ms.items():
                sums[k] = [x + y for x, y in zip(sums.get(k, [0.0] * TURNS),
                                                 ts)]
    print("turns [main-path launches summed]: " + "; ".join(
        f"{k} {', '.join(f'{v:.4f}' for v in ts)} ms (median "
        f"{statistics.median(ts):.4f})" for k, ts in sums.items()),
        flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", action="append", default=[],
                    metavar="LABEL=SOURCE",
                    help="another sw_extend source to time in turns")
    args = ap.parse_args(argv)
    dev = require_cuda()
    print(torch.cuda.get_device_name(0), flush=True)
    profile(dev)
    sass_census()
    if args.turns:
        turns(dev, dict(s.split("=", 1) for s in args.turns))


if __name__ == "__main__":
    main()
