"""Build and load the port's hand-written CUDA kernels.

Each source in ``bioseqdb_tpu_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C entry point, loaded with
``ctypes``. Builds happen at first use into ``bioseqdb_tpu_torch/_build``
(listed in ``.gitignore``), named by a hash of the source and the shared
headers (``csrc/*.cuh``), so an edited source or header never loads a
stale library. ``build`` starts one ``nvcc`` per source, all at once.

``LAUNCHES`` counts kernel launches by kernel name: each wrapper adds one
where it launches its kernel, so a run can show that it went through the
kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = {"sw_extend": "sw_extend.cu", "fm_seed": "fm_seed.cu",
           "kmer": "kmer.cu", "seedsw": "seedsw.cu", "chain": "chain.cu",
           "extend": "extend.cu", "fm": "fm.cu", "resolve": "resolve.cu",
           "probes": "probes.cu"}
EXTEND_KERNELS = ("extend_setup", "extend_scan", "extend_windows",
                  "extend_merge", "extend_seedcov")
RESOLVE_KERNELS = ("resolve_expand", "resolve_finish")
KERNELS = ("sw_extend",                            # sw_extend.cu
           "fm_seed",                              # fm_seed.cu
           "kmer_seed",                            # kmer.cu
           "seed_sw",                              # seedsw.cu
           "chain_seeds", "filter_chains",         # chain.cu
           *EXTEND_KERNELS,                        # extend.cu
           "sa_resolve", "backward_search",        # fm.cu
           *RESOLVE_KERNELS,                       # resolve.cu
           "gather_rows", "gather_chain", "add_one")  # probes.cu
# the kernels a full-pipeline device step launches: kmer_seed on the kmer
# seeder's batches (W <= 320), seed_sw on long reads only
STEP_KERNELS = ("sw_extend", "fm_seed", "kmer_seed", "seed_sw",
                "chain_seeds", "filter_chains", *EXTEND_KERNELS, "sa_resolve",
                *RESOLVE_KERNELS)
# the kernels an exact-mode step launches
EXACT_KERNELS = ("backward_search", "sa_resolve")
# the kernels a user's path launches (every kernel but the probes)
PATH_KERNELS = STEP_KERNELS + ("backward_search",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def lib_path(name: str) -> Path:
    """The library of source ``name``, named by a hash of the source and
    of the headers it may include (``csrc/*.cuh``)."""
    src = (CSRC / SOURCES[name]).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names=None) -> dict:
    """Compile the named sources (all by default) that are not built yet,
    one ``nvcc`` each, concurrently. Returns {name: nvcc log}; raises
    with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        dst = lib_path(name)
        if dst.exists():
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, dst)
    logs, failed = {}, []
    for name, (proc, tmp, dst) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, dst)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built on first use."""
    build([name])
    return ctypes.CDLL(str(lib_path(name)))
