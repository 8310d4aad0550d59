"""The port stands alone: it runs without jax (the machine with the card
has none) and imports nothing of the JAX package.

A subprocess blocks ``jax``, ``jaxlib`` and ``bioseqdb_tpu`` before any
import, imports every module of ``bioseqdb_tpu_torch`` (its tools
included; ``dist.mesh``, ``dist.launch``, ``dist.shard_index`` and
``tools.dist_leg`` also by name) and ``chip_smoke`` as a module, builds an index with the port's
own builder and read simulator, and aligns a few reads on the CPU, then
a few pairs through ``align_pairs_columns`` and ``align_pairs`` (one
pair with an all-N mate, so mate rescue runs) and renders their SAM
text: every function-level import of ``align/paired.py`` runs. Then the
CLI (``index``, ``align --cpu`` in full and exact mode, ``import``), an
FM-seeded step with int64 ranks forced (its regions equal the int32
step's) and ``search`` run on the CPU. It then asserts that no ``jax`` or
``bioseqdb_tpu`` module was loaded."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "jaxlib", "bioseqdb_tpu"):
    sys.modules[blocked] = None
import bioseqdb_tpu_torch
for m in pkgutil.walk_packages(bioseqdb_tpu_torch.__path__, "bioseqdb_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from bioseqdb_tpu_torch.dist import launch, mesh, shard_index
from bioseqdb_tpu_torch.tools import dist_leg
from bioseqdb_tpu_torch import align, align_pairs, align_pairs_columns
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.sam.emit import emit_sam_pair_columns
from bioseqdb_tpu_torch.utils.sim import (simulate_genome, simulate_pairs,
                                          simulate_reads)
g = simulate_genome(30_000, seed=5)
idx = build_index([("g", g)])
sim = simulate_reads(g, 6, read_len=150, sub_rate=0.01, seed=6)
res = align(sim.reads, idx, device="cpu")
ok = sum(r.hits[0].ref_begin == p for r, p in zip(res, sim.positions) if r.hits)
assert ok == 6, ok
r1, r2, _ = simulate_pairs(g, 12, read_len=150, insert_std=30, seed=7)
b1 = pack_reads(r1.reads, r1.names)
b2 = pack_reads(r2.reads[:-1] + ["N" * 150], r2.names)
cols1, cols2 = align_pairs_columns(b1, b2, idx, device="cpu")
sam = emit_sam_pair_columns(cols1, cols2, idx, b1, b2, header=False)
assert sam.count("\n") == 24 and cols1.fast.any() and cols1.extra
pairs = align_pairs(b1, b2, idx, device="cpu")
assert sum(bool(a.pe.flag_extra & 0x2) for a, _ in pairs) == 11
assert (pairs[-1][1].mapped, int(cols1.pos[0])) == (False, r1.positions[0])
import os, tempfile
from bioseqdb_tpu_torch import cli, search
from bioseqdb_tpu_torch.io.fasta import write_fasta
with tempfile.TemporaryDirectory() as d:
    fa, fq, ix = (os.path.join(d, f) for f in ("g.fa", "r.fa", "g.idx"))
    write_fasta(fa, [("g", g)])
    write_fasta(fq, list(zip(sim.names, sim.reads)))
    assert cli.main(["index", fa, "-o", ix]) == 0
    for extra in ([], ["--mode", "exact"]):
        out = os.path.join(d, "o.sam")
        assert cli.main(["align", ix, fq, "-o", out, "--cpu", *extra]) == 0
        body = [l for l in open(out) if not l.startswith("@")]
        assert len(body) >= 6 and (extra or all("\tg\t" in l for l in body))
    assert cli.main(["import", fq, "-o", os.path.join(d, "sh")]) == 0
import dataclasses, torch
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.kernels import fm as kfm, seed as kseed
al = Aligner.build(idx, device="cpu", seeder="fm")
fm64 = kfm.FMDevice.from_host(idx, "cpu", rank_dtype=torch.int64)
al64 = dataclasses.replace(al, fm=fm64, jump=kseed.build_r3_jump(fm64))
batch = pack_reads(sim.reads, sim.names)
o32, o64 = al.device_regions(batch), al64.device_regions(batch)
assert o64["regs"]["rb"].dtype.itemsize == 8
assert all((o32["regs"][k] == o64["regs"][k]).all() for k in o32["regs"])
hit = search(g[300:400], [("g", g)], device="cpu")[0]
assert (hit.ref_match_start, hit.cigar) == (300, "100M")
loaded = [k for k, v in sys.modules.items() if v is not None and (
    k.split(".")[0] in ("jax", "jaxlib", "bioseqdb_tpu"))]
assert not loaded, loaded
print("NOJAX_OK")
"""


def test_port_imports_and_aligns_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "NOJAX_OK" in r.stdout, r.stderr[-3000:]
