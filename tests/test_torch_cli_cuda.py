"""The port's CLI on the card writes the same SAM text as with ``--cpu``,
in full and in exact mode, and its trace (``--profile``) names the SW
kernel. Skips without a CUDA device. Imports no jax, so it runs on a card
machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cli_cuda.py``."""

import os

import pytest
import torch

from bioseqdb_tpu_torch import cli
from bioseqdb_tpu_torch.io.fasta import FastaRecord, write_fasta, write_fastq
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.utils.profiling import TRACE_FILE
from bioseqdb_tpu_torch.utils.sim import simulate_genome, simulate_reads

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = tmp_path_factory.mktemp("cli_cuda")
    g = simulate_genome(60_000, seed=91)
    write_fasta(d / "ref.fa", [("g", g)])
    for name, sub, seed in (("reads", 0.01, 92), ("exact", 0.0, 93)):
        sim = simulate_reads(g, 200, read_len=150, sub_rate=sub, seed=seed)
        write_fastq(d / f"{name}.fq", [
            FastaRecord(n, n, r, "I" * len(r))
            for n, r in zip(sim.names, sim.reads)])
    assert cli.main(["index", str(d / "ref.fa"), "-o", str(d / "idx")]) == 0
    return d


@pytest.mark.parametrize("mode", ["full", "exact"])
def test_cli_cuda_equals_cpu(files, mode):
    reads = files / ("exact.fq" if mode == "exact" else "reads.fq")
    sams, launched = {}, {}
    for dev, extra in (("cuda", []), ("cpu", ["--cpu"])):
        out = files / f"{mode}.{dev}.sam"
        n0 = build.LAUNCHES["sw_extend"]
        assert cli.main(["align", str(files / "idx"), str(reads), "-o",
                         str(out), "--mode", mode, "--batch-size", "64",
                         *extra]) == 0
        launched[dev] = build.LAUNCHES["sw_extend"] - n0
        sams[dev] = out.read_text()
    assert sams["cuda"] == sams["cpu"]
    body = [l for l in sams["cuda"].splitlines() if not l.startswith("@")]
    assert len(body) >= 200
    assert sum(not int(l.split("\t")[1]) & 0x4 for l in body) >= 190
    # the CPU runs its plain SW; the card's full mode launched the kernel,
    # and exact mode runs no SW at all
    assert launched["cpu"] == 0
    assert (launched["cuda"] > 0) == (mode == "full")


def test_cli_cuda_profile_names_sw_kernel(files):
    trace = files / "trace"
    n0 = build.LAUNCHES["sw_extend"]
    assert cli.main(["align", str(files / "idx"), str(files / "reads.fq"),
                     "-o", str(files / "prof.sam"), "--profile",
                     str(trace)]) == 0
    assert build.LAUNCHES["sw_extend"] > n0
    text = (trace / TRACE_FILE).read_text()
    assert "sw_kernel" in text and os.path.getsize(trace / TRACE_FILE) > 0
