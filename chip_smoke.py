"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi); no CUDA device
   -> exits non-zero before any result;
2. builds the hand-written CUDA kernels from ``bioseqdb_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once);
3. SW kernel phase: ``sw_extend`` against its plain PyTorch version on
   the card (bit-equal on every case set and at the main-path shape),
   with both times from CUDA events and its bound from the DP cells the
   plain version counts on the main-path case set;
4. main path: a 4.6 Mb simulated genome (E. coli scale), two batches of
   16,384 150 bp single-end reads at 1% substitutions through
   ``Aligner.device_regions`` -> ``absorb_overflow`` ->
   ``finalize_columns``; the second batch is timed. Reads at their
   simulated origin are counted, and every read off it must equal the
   host oracle. Launch counts are zeroed just before the timed batch and
   read just after: ``sw_extend`` must have run;
5. probe path: counts zeroed, the two probe entry points
   (``tools/microbench_gather.py``, ``tools/microbench_seed.py``) run at
   the TPU tools' shapes and the seeding machine's (16,384 lanes over
   the main-path and a GRCh38-class Occ table), counts read: every probe
   kernel must have run. The entry points hold ``gather_rows``,
   ``gather_chain`` (every variant) and ``add_one`` bit-equal to their
   plain versions and time both; this adds each one's bound at the
   main-path table;
6. prints the kernels line, then the device line as the last line.

Kernel times: CUDA events around one call, or, for kernels shorter than
the host's enqueue time (``gather_rows``, ``add_one`` and their library
calls), the device time per call of a CUDA graph of 20 calls. Plain
versions are timed eagerly with CUDA events. ``bound_ms`` is the larger
of the bytes the function must move over 3.35 TB/s and the instructions
it must issue over the card's issue rate (132 SMs x 4 schedulers x 32
lanes x 1.98 GHz), each fused instruction (a multiply-add, a three-input
add, a DPX add-max) counted once.

Nothing is caught: any failed check exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from bioseqdb_tpu_torch.align.columns import finalize_columns
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.cpu import oracle as O
from bioseqdb_tpu_torch.cpu.ksw import fill_scmat
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels.sw import FIELDS, sw_extend_batch
from bioseqdb_tpu_torch.kernels.sw_cuda import sw_extend_cuda
from bioseqdb_tpu_torch.tools import microbench_gather, microbench_seed
from bioseqdb_tpu_torch.tools.shapes import OCC_MAIN, SEED_STEPS, event_ms
from bioseqdb_tpu_torch.utils.sim import simulate_genome, simulate_reads

GENOME_LEN = 4_600_000
BATCH = 16_384
READ_LEN = 150
# exact equality: the kernels and their plain versions are integer programs
TOLERANCE = 0
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM device memory
# thread-instructions a second: 132 SMs x 4 schedulers x 32 lanes, one
# warp-instruction a scheduler a clock, at the 1.98 GHz boost clock. No
# mix of integer pipes issues faster.
ISSUE_PER_S = 132 * 4 * 32 * 1.98e9
# instructions a DP cell of ksw_extend needs at least, with Hopper's DPX
# forms: M + q and its zero test (2), H = max3(M, E, F) (__vimax3, 1), the
# row max and its column (__vibmax and a select, 2), E and F each
# max(x - e, max(M - oe, 0)) (__viaddmax twice, 2 + 2): 9; the s16x2 forms
# do two cells an instruction, since main-path scores fit int16
SW_INSTR_PER_CELL = 9 / 2
PROBES = ("gather_rows", "gather_chain", "add_one")
REPLACES = dict(gather_rows="tools/microbench_pallas_gather.py:48",
                gather_chain="tools/microbench_mosaic_seed.py:180",
                add_one="tools/microbench_pallas_gather.py:110")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def bound(n_bytes: float, n_instr: float) -> tuple[float, str]:
    """The least milliseconds the card could take, and what sets it:
    the bytes over the memory rate, or the instructions over the issue
    rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_instr / ISSUE_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    ms = event_ms(kern, 20)
    plain_ms = event_ms(plain, 3)
    cells = int(sw_extend_batch(q, qlen, t, tlen, mat, gaps["o_del"],
                                gaps["e_del"], gaps["o_ins"], gaps["e_ins"],
                                w0, bonus, zdrop, h0, mq,
                                count_cells=True)["cells"].sum())
    n_bytes = 4 * (q.numel() + t.numel() + 4 * BATCH + 6 * BATCH)
    bound_ms, bound_by = bound(n_bytes, SW_INSTR_PER_CELL * cells)
    log(f"sw_extend main-path shape B={BATCH} Wq=152 Wt=616: "
        f"cuda {ms:.3f} ms, plain {plain_ms:.3f} ms (median, CUDA events); "
        f"{cells} DP cells -> bound {bound_ms:.5f} ms ({bound_by}), kernel "
        f"at {100 * bound_ms / ms:.2f}% of it")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                shape=f"B={BATCH} Wq=152 Wt=616, {cells} DP cells")


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
    if launches["sw_extend"] <= 0:
        raise AssertionError("kernel sw_extend was not launched on the "
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


def chain_instructions(rows: int = 1, floor: str | None = None,
                       smem: bool = False, salt: int = 0) -> int:
    """Instructions one lane-step of the chain must issue: the floor's
    multiply-add (its constants folded in) and AND; a loaded row adds its
    address multiply-add, its load and the add of its value; a second row
    its index multiply-add and AND, its address and its load (its value
    joins the same three-input add); a salt the bump's running sum. A
    shared-memory table changes the load, not the count."""
    if floor:
        return 2
    return 5 + 4 * (rows == 2) + (salt != 0)


def probe_path() -> list[dict]:
    """The probe entry points at their shapes, counts zeroed just before
    and read just after. Each entry point checks every kernel bit-equal
    to its plain version at every shape (the tools' and the seeding
    machine's) and raises otherwise; this adds the bounds at the seeding
    machine's shape (16,384 lanes over the main-path Occ table) and
    returns the kernels line's entries."""
    build.reset_launches()
    gat = microbench_gather.run(seed=0)
    seed = microbench_seed.run(seed=0)
    launches = dict(build.LAUNCHES)
    log(f"probe path launches: { {k: launches[k] for k in PROBES} }")
    for name in PROBES:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "probe path")
    t, steps = OCC_MAIN, SEED_STEPS[0]
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms")

    r = gat[t.name]
    n_bytes = 4 * (r["rows_read"] * t.cols + t.lanes + t.lanes * t.cols)
    gather = dict({k: r[k] for k in keys}, shape=f"{t.name}, {t.lanes} lanes")
    gather["bound_ms"], gather["bound_by"] = bound(
        n_bytes, 2 * t.lanes * t.cols // 4)   # a 16-byte load and store

    chains = {}
    for name, r in seed[t.name].items():
        kw = microbench_seed.VARIANTS[name]
        lanes = 1 if kw.get("floor") == "e" else t.lanes
        bound_ms, bound_by = bound(4 * (r["rows_read"] + 2 * t.lanes),
                                   chain_instructions(**kw) * lanes * steps)
        chains[name] = dict(ms=r["ms"][0], plain_ms=r["plain_ms"],
                            bound_ms=bound_ms, bound_by=bound_by)
        log(f"gather_chain [{t.name}, {t.lanes} lanes, {name}, T={steps}, "
            f"{r['rows_read']} rows read]: cuda {r['ms'][0]:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}), "
            f"kernel at {100 * bound_ms / r['ms'][0]:.2f}% of it")
    # the kernels line carries make_a2's function, the FM fetch shape
    chain = dict(chains["2 rows"], library_ms=None, max_abs_err=max(
        v["max_abs_err"] for res in seed.values() for v in res.values()),
        shape=f"{t.name}, {t.lanes} lanes, 2 rows, T={steps}")

    add_one = {k: gat["launch"][k] for k in keys}
    add_one["bound_ms"], add_one["bound_by"] = bound(
        2 * 4 * 8 * 128, 3 * 8 * 128)          # a load, add and store each
    add_one["shape"] = "int32 (8, 128)"
    for name, e in (("gather_rows", gather), ("gather_chain", chain),
                    ("add_one", add_one)):
        lib = e["library_ms"]
        log(f"{name} [{e['shape']}]: cuda {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms, library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
            f"{e['bound_ms']:.7f} ms ({e['bound_by']}), max_abs_err "
            f"{e['max_abs_err']}")
        if e["max_abs_err"] > TOLERANCE:
            raise AssertionError(f"{name} disagrees with plain")
    return [dict(name=name, route="cuda",
                 source="bioseqdb_tpu_torch/csrc/probes.cu",
                 replaces=REPLACES[name], launches=launches[name], **e)
            for name, e in (("gather_rows", gather), ("gather_chain", chain),
                            ("add_one", add_one))]


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

    sw = kernel_phase(dev)
    m = main_path(dev, card)
    kernels = [dict(name="sw_extend", route="cuda",
                    source="bioseqdb_tpu_torch/csrc/sw_extend.cu",
                    replaces="bioseqdb_tpu/kernels/sw_pallas.py:52",
                    launches=m["launches"]["sw_extend"], **sw)]
    kernels += probe_path()
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
