"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi); no CUDA device
   -> exits non-zero before any result;
2. builds the hand-written CUDA kernels from ``bioseqdb_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once);
3. SW kernel phase: ``sw_extend`` against its plain PyTorch version on
   the card, bit-equal on every case set of ``tools/sw_sets.py``: small
   ones, ``synthetic`` (16,384 read-like pairs at the extension stage's
   widths, Wq 160, Wt 624), ``int16_edge`` (h0 + a * qlen just below and
   just above the int16 limit), ``wide_320`` (Wq 320) and ``retry_band``
   (band 200, the band-doubling retry); the bound from the DP cells and
   rows the plain version counts on the synthetic set, which gives the
   kernels line its time; and the synthetic set's 1% of lanes with the
   most cells timed alone;
4. main path: a 4.6 Mb simulated genome (E. coli scale), two batches of
   16,384 150 bp single-end reads at 1% substitutions through
   ``Aligner.device_regions`` -> ``absorb_overflow`` ->
   ``finalize_columns``; the second batch is timed. Reads at their
   simulated origin are counted, and every read off it must equal the
   host oracle. Launch counts are zeroed just before the timed batch and
   read just after: ``sw_extend`` must have run. The warm-up batch
   records the inputs of every ``sw_extend`` launch the extension stage
   makes (the wrapper ``kernels/extend.py`` calls is wrapped for that
   batch only, and the recorded calls must match the launches counted);
   each recorded launch is then run again alone: active lanes, DP cells,
   rows, time, bound and share, bit-equal to plain;
5. paired-end path, on the main path's index: two batches of 8,192 FR
   pairs (150 bp, 1% substitutions, inserts 400 +- 40; pair seeds 700,
   the warm-up, and 701) through ``device_regions_pair`` ->
   ``absorb_overflow_pair`` -> ``finalize_pairs_columns``
   (``tools/pe_leg.py``), both mates of a batch in one 16,384-row device
   step. The warm-up batch's ``sw_extend`` launches are recorded and each
   is run again alone, as on the main path; counts are zeroed just before
   the timed batch and read just after: ``sw_extend`` must have run. R1
   and R2 at their simulated origin are counted (each >= 98%), and every
   pair with a mate off it must equal the host's slow PE path
   (``pe_ne_oracle`` 0). The timed batch's SAM text is rendered with
   ``emit_sam_pair_columns``;
6. probe path: counts zeroed, the two probe entry points
   (``tools/microbench_gather.py``, ``tools/microbench_seed.py``) run at
   the TPU tools' shapes and the seeding machine's (16,384 lanes over
   the main-path and a GRCh38-class Occ table), counts read: every probe
   kernel must have run. The entry points hold ``gather_rows``,
   ``gather_chain`` (every variant) and ``add_one`` bit-equal to their
   plain versions and time both; this adds each one's bound at the
   main-path table;
7. prints the kernels line (``sw_extend``'s launches: the timed
   single-end and paired-end batches'), then the device line as the last
   line.

Kernel times: the device time per call of a CUDA graph of calls
(``sw_extend``: 5 launches; ``gather_rows``, ``add_one`` and their
library calls: 20), so that the host's enqueue time does not count;
``gather_chain``: CUDA events around one call. Plain versions are timed
eagerly with CUDA events. ``bound_ms`` is the larger
of the bytes the function must move over 3.35 TB/s and the instructions
it must issue over the card's issue rate (132 SMs x 4 schedulers x 32
lanes x 1.98 GHz), each fused instruction (a multiply-add, a three-input
add, a DPX add-max) counted once. ``tools/sw_profile.py`` times other
builds of the SW kernel in turns with this one.

Nothing is caught: any failed check exits non-zero.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from bioseqdb_tpu_torch.align.columns import finalize_columns
from bioseqdb_tpu_torch.cpu import oracle as O
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.kernels.sw_cuda import blocks_per_sm
from bioseqdb_tpu_torch.sam.emit import emit_sam_pair_columns
from bioseqdb_tpu_torch.tools import microbench_gather, microbench_seed, pe_leg
from bioseqdb_tpu_torch.tools.shapes import (OCC_MAIN, SEED_STEPS,
                                             card_line, event_ms)
from bioseqdb_tpu_torch.tools.sw_sets import (BATCH, GENOME_LEN, MAIN_WQ,
                                              READ_LEN, SwCall,
                                              main_path_setup, recording,
                                              sw_sets)

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


def bound(n_bytes: float, n_instr: float) -> tuple[float, str]:
    """The least milliseconds the card could take, and what sets it:
    the bytes over the memory rate, or the instructions over the issue
    rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_instr / ISSUE_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sw_bound(call: SwCall, counted: dict) -> tuple[float, str]:
    """The SW bound on ``call``'s inputs, from what the plain version
    counted there: the function must read the query codes of each lane
    that runs a row, one target code a row it runs, and four int32 inputs
    a lane, and write six int32 outputs a lane; it does SW_INSTR_PER_CELL
    instructions a DP cell."""
    qlen, rows = call.args[1], counted["rows"]
    n_bytes = 4 * (int(qlen[rows > 0].sum()) + int(rows.sum())
                   + 10 * len(qlen))
    return bound(n_bytes, SW_INSTR_PER_CELL * int(counted["cells"].sum()))


def kernel_phase(dev) -> dict:
    for wq in (MAIN_WQ, 320):
        n = blocks_per_sm(wq)
        log(f"sw_extend occupancy at Wq={wq}: {n} blocks of 128 threads an "
            f"SM ({4 * n} warps)")
    rng = np.random.default_rng(7)
    max_err, calls = 0, {}
    for name, cases, *opts in sw_sets(rng):
        call = SwCall.from_cases(cases, *opts, dev)
        calls[name] = call
        err = call.err(call.plain())
        max_err = max(max_err, err)
        timing = ""
        if len(cases) >= 2048:
            timing = f", cuda {call.ms():.4f} ms"
        log(f"kernel sw_extend vs plain [{name}] {call.shape()}: "
            f"max_abs_err={err}{timing}")
        if err > TOLERANCE:
            raise AssertionError(f"sw_extend disagrees with plain on {name}")
    syn = calls["synthetic"]
    ms = syn.ms()
    plain_ms = event_ms(syn.plain, 3)
    counted = syn.plain(count_cells=True)
    lane_cells, ref_rows = counted["cells"], counted["rows"]
    cells = int(lane_cells.sum())
    bound_ms, bound_by = sw_bound(syn, counted)
    log(f"sw_extend [synthetic] {syn.shape()}: cuda {ms:.4f} ms (a launch "
        f"in a CUDA graph), plain {plain_ms:.3f} ms (CUDA events); {cells} "
        f"DP cells, {int(ref_rows.sum())} rows -> "
        f"bound {bound_ms:.5f} ms ({bound_by}), kernel at "
        f"{100 * bound_ms / ms:.2f}% of it")
    # what holds the kernel back: the lanes with the most work alone show
    # how much of the time is one lane's chain of rows
    top = torch.argsort(lane_cells, descending=True)[: BATCH // 100]
    slow = syn.subset(top)
    log(f"sw_extend [synthetic, the {len(top)} lanes with the most cells "
        f"({int(lane_cells[top].sum())} DP cells) alone]: cuda "
        f"{slow.ms():.4f} ms")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                shape=f"synthetic set, {syn.shape()}, {cells} DP cells")


def main_path_launches(calls: list, path: str = "main-path") -> list[dict]:
    """Each recorded launch of ``path`` alone: bit-equal to plain, its
    time, DP cells, bound and share."""
    rows = []
    for k, call in enumerate(calls):
        ref = call.plain(count_cells=True)
        err = call.err(ref)
        cells = int(ref["cells"].sum())
        ran = ref["rows"][ref["rows"] > 0].float()
        mean_rows = float(ran.mean()) if len(ran) else 0.0
        ms = call.ms()
        bound_ms, bound_by = sw_bound(call, ref)
        log(f"{path} launch {k}: {call.shape()}, {cells} DP cells, rows "
            f"a lane that ran: mean {mean_rows:.1f}, "
            f"max {int(ref['rows'].max())}; largest value "
            f"{int(ref['max_value'].max())}: cuda {ms:.4f} ms, bound "
            f"{bound_ms:.3g} ms ({bound_by}), kernel at "
            f"{100 * bound_ms / ms:.3g}% of it, max_abs_err={err}")
        if err > TOLERANCE:
            raise AssertionError(f"sw_extend disagrees with plain on "
                                 f"{path} launch {k}")
        rows.append(dict(ms=ms, cells=cells, bound_ms=bound_ms))
    log(f"{path} launches: {len(rows)}, together cuda "
        f"{sum(r['ms'] for r in rows):.4f} ms, {sum(r['cells'] for r in rows)} "
        f"DP cells, bound {sum(r['bound_ms'] for r in rows):.5f} ms")
    return rows


def main_path(dev, card: str) -> dict:
    t0 = time.time()
    idx, al, sims, batches, genome = main_path_setup(dev)
    log(f"index {GENOME_LEN} bases + Aligner.build + reads: "
        f"{time.time() - t0:.1f} s")

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
    calls = []
    n0 = build.LAUNCHES["sw_extend"]
    with recording(calls):
        run(batches[0])
    warm = build.LAUNCHES["sw_extend"] - n0
    log(f"warm-up batch: {time.time() - t0:.1f} s, {len(calls)} sw_extend "
        f"launches recorded, {warm} counted")
    if not 0 < len(calls) == warm:
        raise AssertionError("the warm-up batch's sw_extend launches were "
                             "not all recorded")
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
    return dict(launches=launches, rps=rps, calls=calls, idx=idx, al=al,
                genome=genome)


def pe_path(m: dict, card: str) -> dict:
    """The paired-end path on the main path's index and ``Aligner``."""
    idx, al = m["idx"], m["al"]
    t0 = time.time()
    warm, timed = (pe_leg.simulate(m["genome"], pe_leg.PAIRS, seed)
                   for seed in (700, 701))
    log(f"two batches of {pe_leg.PAIRS} pairs simulated: "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    calls = []
    n0 = build.LAUNCHES["sw_extend"]
    with recording(calls):
        pe_leg.run_batch(al, warm)
    counted = build.LAUNCHES["sw_extend"] - n0
    log(f"PE warm-up batch: {time.time() - t0:.1f} s, {len(calls)} "
        f"sw_extend launches recorded, {counted} counted")
    if not 0 < len(calls) == counted:
        raise AssertionError("the PE warm-up batch's sw_extend launches "
                             "were not all recorded")
    build.reset_launches()
    res = pe_leg.run_batch(al, timed)
    launches = dict(build.LAUNCHES)
    if launches["sw_extend"] <= 0:
        raise AssertionError("kernel sw_extend was not launched on the PE "
                             "path")
    sec = res["seconds"]
    total = sum(sec.values())
    log("PE timed batch: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                       sec.items())
        + f", total {total:.3f} s; rows overflowing before the retry "
        f"{res['n_ovf']}; sw_extend launches {launches['sw_extend']}")
    log(f"PE path: {2 * pe_leg.PAIRS / total:.1f} reads/s "
        f"({pe_leg.PAIRS} pairs x 2 x {pe_leg.READ_LEN} bp, {GENOME_LEN} b "
        f"genome) on {card}")
    t0 = time.time()
    chk = pe_leg.check(al, timed, res)
    n = chk["pairs"]
    log(f"PE truth: R1 {chk['r1_truth']}/{n}, R2 {chk['r2_truth']}/{n}, "
        f"proper {chk['proper']}/{n}; pairs off truth "
        f"{chk['off_truth_pairs']}, pe_ne_oracle {chk['pe_ne_oracle']} "
        f"(check {time.time() - t0:.1f} s)")
    if (chk["pe_ne_oracle"] or chk["r1_truth"] < 0.98 * n
            or chk["r2_truth"] < 0.98 * n):
        raise AssertionError("PE path disagrees with the host")
    t0 = time.time()
    sam = emit_sam_pair_columns(*res["cols"], idx, *timed.batches,
                                header=False)
    n_rec = sam.count("\n")
    log(f"PE SAM text (emit_sam_pair_columns): {n_rec} records, "
        f"{time.time() - t0:.3f} s")
    main_path_launches(calls, "PE")
    return launches


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
    main_path_launches(m["calls"])
    t0 = time.time()
    pe = pe_path(m, card)
    log(f"PE phase: {time.time() - t0:.1f} s")
    kernels = [dict(name="sw_extend", route="cuda",
                    source="bioseqdb_tpu_torch/csrc/sw_extend.cu",
                    replaces="bioseqdb_tpu/kernels/sw_pallas.py:52",
                    launches=m["launches"]["sw_extend"] + pe["sw_extend"],
                    **sw)]
    kernels += probe_path()
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
