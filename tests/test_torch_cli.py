"""The port's CLI equals the JAX package's, exactly, on the CPU: ``index``
writes an index the JAX package loads with every field equal (and a
JAX-saved index aligns in the port's CLI); ``align --cpu`` in full mode,
``--mode exact`` and ``--mate`` writes the same SAM text; ``import``
writes the same shards and manifest, and resumes. Both CLIs run in one
process, so the ``@PG`` line's command line is the same. Also: ``align``
without ``--cpu`` exits non-zero where there is no card, and a batch
whose device step fails twice is retried once, skipped, and leaves the
same exit code (0) and SAM text in both CLIs."""

import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from bioseqdb_tpu import cli as jcli
from bioseqdb_tpu.align.pipeline import Aligner as JAligner
from bioseqdb_tpu.index.fmindex import FMIndex as JFMIndex
# imported here, not inside a test: the JAX StageTimer.report binds
# sys.stderr as a default argument when its module is first imported, and
# a test's captured stream closes when the test ends
from bioseqdb_tpu.utils import profiling as _jprofiling  # noqa: F401
from bioseqdb_tpu_torch import cli
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.io.batch import pack_reads_from_file
from bioseqdb_tpu_torch.io.fasta import FastaRecord, write_fasta, write_fastq
from bioseqdb_tpu_torch.utils.sim import (simulate_genome, simulate_pairs,
                                          simulate_reads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fastq(path, sim, qual="I"):
    write_fastq(path, [FastaRecord(n, n, r, qual * len(r))
                       for n, r in zip(sim.names, sim.reads)])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    g1 = simulate_genome(14_000, seed=81)
    g2 = simulate_genome(6_000, seed=82)
    write_fasta(d / "ref.fa", [("chr1", g1), ("chr2", g2)])
    sim = simulate_reads(g1, 30, read_len=90, sub_rate=0.01, seed=83)
    _fastq(d / "reads.fq", sim)
    r1, r2, _ = simulate_pairs(g1, 12, read_len=90, insert_mean=300.0,
                               insert_std=30.0, sub_rate=0.01, seed=84)
    _fastq(d / "r1.fq", r1)
    _fastq(d / "r2.fq", r2)
    # exact mode: reads with no edits, a few with an N
    ex = simulate_reads(g2, 20, read_len=80, sub_rate=0.0, seed=85)
    ex.reads[3] = ex.reads[3][:40] + "N" + ex.reads[3][41:]
    _fastq(d / "exact.fq", ex)
    assert cli.main(["index", str(d / "ref.fa"), "-o", str(d / "t.idx")]) == 0
    assert jcli.main(["index", str(d / "ref.fa"), "-o", str(d / "j.idx")]) == 0
    return d


def test_index_loads_in_jax(files):
    j = JFMIndex.load(str(files / "j.idx"))
    t = JFMIndex.load(str(files / "t.idx"))
    for f in dataclasses.fields(JFMIndex):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def _align(main, files, idx, out, *extra):
    return main(["align", str(files / idx), str(files / "reads.fq"), "-o",
                 str(files / out), "--cpu", *extra])


@pytest.mark.parametrize("mode", ["full", "exact", "mate"])
def test_align_equals_jax(files, mode, capsys):
    extra = {"full": [], "exact": ["--mode", "exact"],
             "mate": ["--mate", str(files / "r2.fq")]}[mode]
    reads = {"full": "reads.fq", "exact": "exact.fq", "mate": "r1.fq"}[mode]
    sams = {}
    for name, main, idx in (("jax", jcli.main, "j.idx"),
                            ("port", cli.main, "t.idx")):
        out = files / f"{mode}.{name}.sam"
        assert main(["align", str(files / idx), str(files / reads), "-o",
                     str(out), "--cpu", "--batch-size", "16", *extra]) == 0
        sams[name] = out.read_text()
    assert sams["port"] == sams["jax"]
    body = [l for l in sams["port"].splitlines() if not l.startswith("@")]
    n_reads = {"full": 30, "exact": 20, "mate": 24}[mode]
    assert len(body) >= n_reads
    assert sum(not int(l.split("\t")[1]) & 0x4 for l in body) >= n_reads - 1
    # the port's report counts every read
    err = capsys.readouterr().err
    assert f"aligned {n_reads} reads" in err.split("[bioseqdb-tpu]")[-1]
    stages = json.loads(re.findall(r'^\{"stages".*$', err, re.M)[-1])["stages"]
    key = {"full": "finalize", "exact": "align", "mate": "align_pe"}[mode]
    assert stages[key]["items"] == n_reads


def test_jax_saved_index_aligns_in_port(files):
    assert _align(cli.main, files, "j.idx", "jidx.port.sam") == 0
    assert _align(cli.main, files, "t.idx", "tidx.port.sam") == 0
    assert ((files / "jidx.port.sam").read_text()
            == (files / "tidx.port.sam").read_text())


def test_import_equals_jax_and_resumes(files, capsys):
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        assert main(["import", str(files / "reads.fq"), "-o",
                     str(files / f"shards.{name}"), "--batch-size", "16"]) == 0
    j, t = files / "shards.jax", files / "shards.port"
    assert sorted(os.listdir(j)) == sorted(os.listdir(t)) == [
        "manifest.json", "shard00000.npz", "shard00001.npz"]
    assert (json.loads((j / "manifest.json").read_text())
            == json.loads((t / "manifest.json").read_text()))
    batches = list(pack_reads_from_file(files / "reads.fq", batch_size=16))
    for k, b in enumerate(batches):
        zj, zt = (np.load(d / f"shard{k:05d}.npz") for d in (j, t))
        for key in ("codes", "lens", "names"):
            assert zt[key].dtype == zj[key].dtype
            assert np.array_equal(zt[key], zj[key]), key
        assert np.array_equal(zt["codes"], b.codes)
        assert np.array_equal(zt["lens"], b.lens)
    # a second run finds the manifest and writes nothing new
    capsys.readouterr()
    assert cli.main(["import", str(files / "reads.fq"), "-o", str(t),
                     "--batch-size", "16"]) == 0
    err = capsys.readouterr().err
    assert "resuming: 2 shard(s) present" in err and "wrote" not in err
    assert "imported 30 reads" in err


def test_align_without_card_fails(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run(
        [sys.executable, "-m", "bioseqdb_tpu_torch", "align",
         str(files / "t.idx"), str(files / "reads.fq"), "-o",
         str(files / "nocard.sam")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def test_failed_batch_exits_1(files, monkeypatch, capsys):
    """A full-mode batch whose device step fails twice: both CLIs retry
    it once, report it, skip it and exit with the same code, 0. (The name
    predates the repair: the port's ``align`` used to exit 1 here.)"""
    calls = {"jax": [], "port": []}

    def broken(name):
        def device_regions(self, batch, *args, **kw):
            calls[name].append(batch.n)
            return {}    # a wire dict with no tables: the batch fails
        return device_regions

    monkeypatch.setattr(JAligner, "device_regions", broken("jax"))
    monkeypatch.setattr(Aligner, "device_regions", broken("port"))
    rcs, sams = {}, {}
    for name, main, idx in (("jax", jcli.main, "j.idx"),
                            ("port", cli.main, "t.idx")):
        rcs[name] = _align(main, files, idx, f"broken.{name}.sam")
        sams[name] = (files / f"broken.{name}.sam").read_text()
        err = capsys.readouterr().err
        assert "retrying once" in err and "failed twice" in err, name
        assert "aligned 0 reads" in err, name
    assert rcs["port"] == rcs["jax"] == 0
    assert calls == {"jax": [30, 30], "port": [30, 30]}
    assert sams["port"] == sams["jax"]
    assert sams["port"].startswith("@HD") and all(
        l.startswith("@") for l in sams["port"].splitlines())
