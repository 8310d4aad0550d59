"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi); no CUDA device
   -> exits non-zero before any result;
2. builds the hand-written CUDA kernels from ``bioseqdb_tpu_torch/csrc``;
3. kernel phase: each kernel against its plain PyTorch version on the
   card (bit-equal on every case set and at the main-path shape), with
   both times from CUDA events;
4. main path: a 4.6 Mb simulated genome (E. coli scale), two batches of
   16,384 150 bp single-end reads at 1% substitutions through
   ``Aligner.device_regions`` -> ``absorb_overflow`` ->
   ``finalize_columns``; the second batch is timed. Reads at their
   simulated origin are counted, and every read off it must equal the
   host oracle. Launch counts are zeroed just before the timed batch and
   read just after;
5. prints the kernels line, then the device line as the last line.

Nothing is caught: any failed check exits non-zero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from bioseqdb_tpu.align.columns import finalize_columns
from bioseqdb_tpu.align.options import AlignOptions
from bioseqdb_tpu.cpu import oracle as O
from bioseqdb_tpu.cpu.ksw import fill_scmat
from bioseqdb_tpu.index.builder import build_index
from bioseqdb_tpu.io.batch import pack_reads
from bioseqdb_tpu.utils.sim import simulate_genome, simulate_reads
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels.sw import FIELDS, sw_extend_batch
from bioseqdb_tpu_torch.kernels.sw_cuda import sw_extend_cuda

GENOME_LEN = 4_600_000
BATCH = 16_384
READ_LEN = 150
# exact equality: the kernel and its plain version are integer programs
TOLERANCE = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events),
    after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def sw_cases(rng, n, max_q, max_t, amb=False, indel=False):
    """Read-like (query, target, h0) triples: a query, and a target that
    starts with its mutated copy and runs on with random bases."""
    cases = []
    for _ in range(n):
        ql = int(rng.integers(1, max_q + 1))
        qq = rng.integers(0, 5 if amb else 4, ql)
        tt = qq.copy()
        if indel and tt.size > 8:
            p = int(rng.integers(2, tt.size - 4))
            k = int(rng.integers(1, 4))
            tt = (np.delete(tt, slice(p, p + k)) if rng.random() < 0.5
                  else np.insert(tt, p, rng.integers(0, 4, k)))
        m = rng.random(tt.size) < 0.05
        tt[m] = rng.integers(0, 5 if amb else 4, m.sum())
        tail = rng.integers(0, 4, int(rng.integers(0, max_t)))
        tt = np.concatenate([tt, tail])[:max_t]
        if rng.random() < 0.2:   # unrelated pair
            tt = rng.integers(0, 4, int(rng.integers(1, max_t + 1)))
        cases.append((qq, tt, int(rng.integers(0, 80))))
    return cases


def sw_inputs(cases, max_q, max_t, dev):
    B = len(cases)
    q = np.full((B, max_q), 4, np.int32)
    t = np.full((B, max_t), 4, np.int32)
    qlen, tlen, h0 = (np.zeros(B, np.int32) for _ in range(3))
    for i, (qq, tt, hh) in enumerate(cases):
        q[i, : len(qq)] = qq
        t[i, : len(tt)] = tt
        qlen[i], tlen[i], h0[i] = len(qq), len(tt), hh
    return [torch.from_numpy(x).to(dev) for x in (q, qlen, t, tlen, h0)]


def kernel_phase(dev) -> dict:
    rng = np.random.default_rng(7)
    gaps = dict(o_del=6, e_del=1, o_ins=6, e_ins=1)
    sets = [  # (name, cases, max_qlen, max_tlen, w, zdrop, end_bonus, a, b)
        ("random", sw_cases(rng, 64, 50, 90), 64, 128, 100, 100, 5, 1, 4),
        ("narrow_band", sw_cases(rng, 64, 40, 60), 64, 128, 3, 100, 5, 1, 4),
        ("zdrop", sw_cases(rng, 64, 40, 60), 64, 128, 100, 5, 5, 1, 4),
        ("ambiguous_indels", sw_cases(rng, 64, 60, 90, amb=True, indel=True),
         64, 128, 100, 100, 5, 1, 4),
        ("ragged_11", sw_cases(rng, 11, 20, 30), 24, 32, 100, 100, 5, 2, 3),
        ("main_path", sw_cases(rng, BATCH, 152, 616, indel=True), 152, 616,
         100, 100, 5, 1, 4),
    ]
    max_err = 0
    for name, cases, mq, mt, w, zdrop, bonus, a, b in sets:
        q, qlen, t, tlen, h0 = sw_inputs(cases, mq, mt, dev)
        w0 = torch.full_like(qlen, w)
        mat = torch.from_numpy(fill_scmat(a, b)).to(dev)
        plain = lambda: sw_extend_batch(q, qlen, t, tlen, mat, gaps["o_del"],
                                        gaps["e_del"], gaps["o_ins"],
                                        gaps["e_ins"], w0, bonus, zdrop, h0, mq)
        kern = lambda: sw_extend_cuda(q, qlen, t, tlen, w0, h0, match_score=a,
                                      mismatch_penalty=b, end_bonus=bonus,
                                      zdrop=zdrop, **gaps)
        ref, got = plain(), kern()
        torch.cuda.synchronize()
        err = max(int((ref[f] - got[f]).abs().max()) for f in FIELDS)
        max_err = max(max_err, err)
        log(f"kernel sw_extend vs plain [{name}] B={len(cases)} Wq={mq} "
            f"Wt={mt}: max_abs_err={err}")
        if err > TOLERANCE:
            raise AssertionError(f"sw_extend disagrees with plain on {name}")
    ms = cuda_ms(kern, 20)
    plain_ms = cuda_ms(plain, 3)
    log(f"sw_extend main-path shape B={BATCH} Wq=152 Wt=616: "
        f"cuda {ms:.3f} ms, plain {plain_ms:.3f} ms (median, CUDA events)")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def main_path(dev, card: str) -> dict:
    t0 = time.time()
    genome = simulate_genome(GENOME_LEN, seed=1)
    idx = build_index([("sim", genome)])
    al = Aligner.build(idx, AlignOptions(), device=dev)
    log(f"index {GENOME_LEN} bases + Aligner.build: {time.time() - t0:.1f} s")

    sims = [simulate_reads(genome, BATCH, read_len=READ_LEN, sub_rate=0.01,
                           seed=100 + k) for k in range(2)]
    batches = [pack_reads(s.reads, s.names) for s in sims]

    def run(batch):
        t = [time.time()]
        out = al.device_regions(batch)
        t.append(time.time())
        n_ovf = int(np.asarray(out["overflow"])[: batch.n].sum())
        out = al.absorb_overflow(batch, out)
        t.append(time.time())
        cols = finalize_columns(idx, al.options, batch, out)
        t.append(time.time())
        return cols, n_ovf, np.diff(t)

    t0 = time.time()
    run(batches[0])
    log(f"warm-up batch: {time.time() - t0:.1f} s")
    build.reset_launches()
    cols, n_ovf, parts = run(batches[1])
    launches = dict(build.LAUNCHES)
    total = float(parts.sum())
    rps = BATCH / total
    log(f"timed batch: device_regions {parts[0]:.3f} s, absorb_overflow "
        f"{parts[1]:.3f} s, finalize_columns {parts[2]:.3f} s, total "
        f"{total:.3f} s")
    log(f"main path: {rps:.1f} reads/s ({BATCH} x {READ_LEN} bp SE, "
        f"{GENOME_LEN} b genome) on {card}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")

    sim, batch = sims[1], batches[1]
    n = len(sim.positions)
    at_truth = (cols.mapped[:n] & (cols.pos[:n] == sim.positions)
                & (cols.is_rev[:n] == sim.strands.astype(bool)))
    ne_oracle = 0
    off = np.flatnonzero(~at_truth)
    for i in off:
        q = np.asarray(batch.codes)[i, : batch.lens[i]].astype(np.uint8)
        regs = O.align_read(idx, al.options, q, rand_id=int(i),
                            min_score=al.options.min_score, all_hits=True)
        prim = next((a for a in regs if not a.flag & 0x100), None)
        if prim is None:
            agree = not cols.mapped[i]
        else:
            agree = (bool(cols.mapped[i]) and int(cols.pos[i]) == prim.pos
                     and bool(cols.is_rev[i]) == bool(prim.is_rev)
                     and int(cols.score[i]) == prim.score)
        ne_oracle += not agree
    log(f"truth: {int(at_truth.sum())}/{n}; device overflow before retry: "
        f"{n_ovf}; host-oracle rows after retry: {len(cols.extra)}; "
        f"off-truth reads: {off.size}, device_ne_oracle: {ne_oracle}")
    if ne_oracle or at_truth.sum() < 0.98 * n:
        raise AssertionError("main path disagrees with the host oracle")
    return dict(launches=launches, rps=rps)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.time()
    logs = build.build()
    log(f"kernel build: {time.time() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    k = kernel_phase(dev)
    m = main_path(dev, card)
    log(json.dumps({"kernels": [dict(
        name="sw_extend", route="cuda",
        source="bioseqdb_tpu_torch/csrc/sw_extend.cu",
        replaces="bioseqdb_tpu/kernels/sw_pallas.py:52",
        launches=m["launches"]["sw_extend"], max_abs_err=k["max_abs_err"],
        ms=k["ms"], plain_ms=k["plain_ms"])]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
