"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi); no CUDA device
   -> exits non-zero before any result;
2. builds the hand-written CUDA kernels from ``bioseqdb_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once): ``sw_extend``, ``fm_seed``,
   ``kmer_seed`` (``kmer.cu``), ``seed_sw`` (``seedsw.cu``),
   ``chain_seeds`` and ``filter_chains`` (``chain.cu``), ``extend_setup``,
   ``extend_scan``, ``extend_windows``, ``extend_merge`` and
   ``extend_seedcov`` (``extend.cu``), ``sa_resolve`` and
   ``backward_search`` (``fm.cu``), ``resolve_expand`` and
   ``resolve_finish`` (``resolve.cu``), the index mesh's
   ``fm_shard_query``, ``fm_shard_apply``, ``sa_shard_query`` and
   ``sa_shard_apply`` (``fm_shard.cu``) and the probes. Every phase that
   runs the full pipeline on one device (main path, PE, FM-seeded, long
   reads, int64, API, the CLI's full-mode ``align`` commands) must launch
   every step kernel of its path in its counted window (``sa_resolve``,
   ``extend_setup`` and the resolve kernels among them):
   ``kmer_seed`` on the kmer seeder's paths and never on the FM-seeded
   or long-read ones, ``seed_sw`` on long reads only; exact mode (the
   exact step, ``align --mode exact``, the data mesh's exact run) must
   launch ``backward_search`` and ``sa_resolve`` and no other;
3. SW kernel phase: ``sw_extend`` against its plain PyTorch version on
   the card, bit-equal on every case set of ``tools/sw_sets.py``: small
   ones, ``synthetic`` (16,384 read-like pairs at the extension stage's
   widths, Wq 160, Wt 624), ``int16_edge`` (h0 + a * qlen just below and
   just above the int16 limit), ``wide_320`` (Wq 320) and ``retry_band``
   (band 200, the band-doubling retry), and the long-read widths, where
   the kernel keeps H and E in a ring over the band: ``long_1500``
   (4,096 pairs, Wq 1,504, Wt 1,968) and ``wide_2048`` (1,024 pairs, Wq
   2,048, Wt 2,512, band 200), and past the ring's shared memory, where
   it keeps only the ring there and reads the query codes from device
   memory (its wide layout, which it must take): ``wide_18000`` (16
   pairs, Wq 18,000, band 100: the launch of a batch of 16 18 kb reads;
   the card tests and ``tools/sw_profile.py --sets`` take
   ``wide_25000``); the bound from the DP cells and rows the plain
   version counts on the synthetic set, which gives the kernels line its
   time, and on the three long-read sets (time, bound, share);
   and the synthetic set's 1% of lanes with the most cells timed alone;
4. main path: a 4.6 Mb simulated genome (E. coli scale), two batches of
   16,384 150 bp single-end reads at 1% substitutions through
   ``Aligner.device_regions`` -> ``absorb_overflow`` ->
   ``finalize_columns``; the second batch is timed, after the first
   runs once more unrecorded (the recorders run ``extend_all`` launch by
   launch, so that run captures its CUDA graph, which the timed batch
   replays, as every batch of a shape after a server's first does). Reads at their
   simulated origin are counted, and every read off it must equal the
   host oracle. Launch counts are zeroed just before the timed batch and
   read just after: ``sw_extend`` must have run; then the timed batch
   runs again under the stage clock for its stage split. The warm-up batch
   records the inputs of every ``sw_extend`` launch the extension stage
   makes (the wrapper ``kernels/extend.py`` calls is wrapped for that
   batch only; a launch whose gate is closed, a dead round's or a side's
   with no retry, is counted apart, and the recorded calls and those must
   match the launches counted);
   each recorded launch is then run again alone: active lanes, DP cells,
   rows, time, bound and share, bit-equal to plain. The timed batch's
   SAM text is rendered with ``emit_sam_columns`` outside the timed
   window (for the CLI phase). The FM machine's calls of this warm-up
   batch, and of the FM-seeded and long-read ones, are recorded
   (``tools/fm_machine.py``) for phase 7b; the chaining calls of this
   warm-up batch, and of the PE, FM-seeded, long-read and int64 ones
   (``tools/chain_calls.py``), for phase 9b, their ``extend_all``
   calls (``tools/extend_calls.py``) for phase 9c, and the kmer seeder's
   calls of this warm-up batch, the PE one and the int64 one
   (``tools/kmer_calls.py``) for phase 9d, and the ``sa_resolve`` calls
   of this warm-up batch, the FM-seeded, long-read and int64 ones
   (``tools/fm_calls.py``) for phase 9f, and the ``resolve_seeds`` calls
   of this warm-up batch, the PE, FM-seeded, long-read and int64 ones
   (``tools/resolve_calls.py``) for phase 9g;
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
   ``emit_sam_pair_columns`` (for the CLI phase);
6. FM-seeded main path: the main path's index and read batches (seeds
   100, the warm-up, and 101) through an ``Aligner`` built with
   ``seeder="fm"``: the FM state machine with its round-3 jump table
   seeds every read. Counts zeroed just before the timed batch and read
   just after (``sw_extend`` must have run); the timed batch runs under
   ``tools/long_leg.py``'s ``stage_clock``, which gives the FM machine's
   seconds and its slowest lane's steps, so seconds a step. Truth >= 98%
   and ``device_ne_oracle`` 0, as on the main path;
7. long-read leg (``tools/long_leg.py``), on the main path's index and
   kmer ``Aligner``: 1,500 bp reads at 1% substitutions, read seed 300
   (1,024 reads, the warm-up) and 301 (4,096 reads, timed). Batches this
   wide take the FM seeder and the seed-SW filter. The warm-up's
   ``sw_extend`` launches are recorded and each one wider than 320 is run
   again alone, as on the main path; the timed batch runs once untimed
   (``extend_all`` captures its CUDA graph), then under the stage
   clock with counts zeroed just before and read just after, and must
   launch ``sw_extend`` at Wq > 320, four times a round of each of its
   ``extend_all`` calls (recorded, with their widths).
   Reads/s, bases/s, the stage split, truth >= 98% and every read off
   truth equal to the host oracle. The seed-SW filter's calls of both
   batches are recorded (``tools/seedsw_calls.py``) for phase 9e, and the
   timed batch's ``extend_all`` call for phase 9c. Then 64 reads of 8 kb
   (seed 302), 16 of 18 kb (seed 303) and 16 of 25 kb (seed 304) run
   twice each (``huge_reads_path`` the last two, whose launches stay out
   of the kernels line): every step kernel of the path launched (at 18
   and 25 kb ``sw_extend`` at its wide layout at both bands of each
   recorded ``extend_all`` call), truth, the host oracle, and the same
   records both times;
7b. FM machine phase: ``fm_seed`` against its plain twin
   (``seed.collect_seeds_plain``) on the card, bit-equal on all six
   outputs (mems, n_mem, overflow, iters, it_r1, it_r2) at the recorded
   inputs: the main path's reseed entry, the FM-seeded batch (jump depth
   8), the long-read warm-up's first 256 reads (W 1,504, max_mem 142;
   the twin of all 1,024 takes minutes), both short ones with
   int64 ranks, the FM-seeded batch's first 4,096 reads at the fat
   retry's caps, the FM-seeded batch under a 300-step budget (it must
   overflow lanes), 2,048 ragged reads (lengths 0-150, Ns, junk, all-N,
   empty; read seed 900), any fat retry of the short warm-ups and
   ``fm_machine.edge_calls`` at int32 and int64 (a budget that runs out
   in the middle of a backward row, P 1, P 32). Each: the kernel's time
   (CUDA events, median of 3 launches), the plain twin's, the slowest
   lane's steps, the summed steps and the backward share of them, the
   distinct table rows the lanes read (counted by the plain twin), the
   bound;
8. exact phase (``bench.py bench_exact``'s workload): the main path's
   genome, 16,384 150 bp reads with no edits (read seed 2), an ``Aligner``
   built with ``mode="exact"``; one warm-up and five timed calls of
   ``exact_align_step`` at ``max_hits`` 4 (the warm-up's
   ``backward_search`` and ``sa_resolve`` calls recorded for phase 9f;
   counts zeroed just before the timed calls and read just after: both
   kernels, once a call, and no other), then one ``align_batch`` at the
   default ``max_hits``. Every read must have a hit, every read with one
   hit its primary at its simulated position and strand, and the records
   and SAM text must equal the port's CPU path on the same batch;
9. int64 phase: the main path's index with int64 ranks forced (an
   ``FMDevice`` built with ``rank_dtype=torch.int64`` and its jump table,
   put into the main path's kmer ``Aligner``, the FM-seeded one and the
   exact one, as the tests build them). The warm-up batch (kmer-seeded)
   records its ``sw_extend`` launches, each run again alone against the
   plain version as on the main path; the timed batch runs kmer-seeded
   and FM-seeded (under the stage clock: the FM machine's steps and ms a
   step), counts zeroed just before each and read just after
   (``sw_extend`` must have run); then exact mode's 16,384 reads. Each
   one's records (every ``AlignColumns`` field, or the exact
   ``ReadResult``s) and SAM text must equal the int32 phase's, and the
   regions' ``rb`` must be int64;
9b. chain phase: ``chain_seeds`` and ``filter_chains`` against their
   plain twins (``chain.chain_seeds_plain``, ``chain.filter_chains_plain``)
   on the card, bit-equal on every output (the chain tables, n, assign,
   overflow; weight, kept, order, beg, end) at the recorded inputs: the
   main path's (B 16,384, S 64, C 16), the PE step's (16,384 rows), the
   FM-seeded one's, the long-read warm-up's (1,024 reads, S 189, C 32),
   the int64 one's and any fat retry of them (S 128, C 32), at
   ``edge_seeds`` with int32 and int64 ranks, and (``chain_seeds``) at
   ``chain_calls.group_calls`` (C reached, contained seeds, equal pos,
   a strand crossing and chains below NEG on later lanes of the group,
   at C 8, 16 and 64, both dtypes), and (``filter_chains``) at
   ``chain_calls.filter_calls`` (no chain, C chains, equal weights at
   equal pos, assign past C - 1, two promotions, a drop by the first kept
   chain, random reads over three 64-slot passes; C 8, 16, 32 and 64, both
   dtypes, the pipeline's options and others). Each recorded and
   ``edge_seeds`` call: the kernel's time (a
   launch in a CUDA graph), the plain twin's, the bound (each input the
   function needs read once: the valid mask, the fields of the valid or
   assigned seed slots, the live chains' pos; each output written once;
   the instructions of the valid seeds, the live chains they scan and the
   chain pairs the filter compares) and the share;
9c. extend phase: ``extend_setup``, ``extend_scan``, ``extend_windows``,
   ``extend_merge`` (both entries) and ``extend_seedcov`` against their
   plain twins
   (``extend.extend_*_plain``) on the card, bit-equal on every output at
   every stage call of the recorded ``extend_all`` calls (the main
   path's: B 16,384, S 64, R 8; the PE step's and its fat retry's, the
   FM-seeded one's, the long-read warm-up's: 1,024 reads, W 1,504, S 189;
   the int64 one's), of ``extend_calls.edge_calls`` (covered seeds with
   and without the overlap rescue, band doubling at bandwidth 8, overflow
   at max_regs 1, windows at the strand boundary and reference ends, the
   edge batch's fat retry; int32 and int64, int64 also shifted past
   2^31), of its random stage inputs (seeds 5-7, both dtypes), of
   ``extend_calls.setup_calls`` (the set-up at S 64 / 128 / 189 / 1,536
   and C 16 / 32 / 256, both dtypes, int64 also past 2^31) and
   ``setup_edge_calls`` (no, one and every seed usable, S 45 / 189 /
   1,564 / 4,200, C 16 / 32 / 64, tied keys past S 128, seeds outside
   any chain, chain ranks up to 4,094 at C 4,095), of
   ``extend_calls.lane_cases`` (the scan's first stop on the edge lanes
   of a pass, n_usable off a multiple of 32, more extended seeds than a
   warp, 0 and 16 live regions; the right merge at R 1 and 16 and S 40
   and 70, both dtypes); each
   ``extend_all`` call with the kernels equal to it with the plain
   twins. For each recorded call, each kernel's launches summed: time
   (each a launch in a CUDA graph), plain twins' time, bound (the bytes
   of the seed slots the stage reads, the region table, the window codes
   and the outputs; the instructions of its trips) and share. For the
   main path's call: the host's waits on the card with the kernels (must
   be 0: the rounds' and retries' guards are gates on the card) and with
   the plain twins, its clocked split (set-up, scan, windows, SW, merge,
   seedcov, the rest) and its unclocked time (a sync at its ends only)
   both ways, in turns; its and the long-read calls' (the warm-up's and
   the timed batch's) active reads a round and unclocked time by each
   route of ``extend_all`` (``extend_calls.route``: its CUDA graph, the
   default; the same gated launches issued one by one; the host guards,
   a wait a round and a side, the earlier order), in turns, and the seconds
   of a call that captures the graph; the gated launches' time in a CUDA
   graph (their device time without the host's dispatch), and the cost
   of a dead round with and without the gates (the call with no usable
   seed, in CUDA graphs of 6 rounds and of 1);
9d. kmer phase: ``kmer_seed`` against its plain twin
   (``kmer.collect_seeds_kmer_plain``) on the card, bit-equal on every
   output (mem_pos, mem_s, mem_b, mem_e, n_mem, needs_r2, overflow, why)
   at the recorded calls (the main path's: B 16,384, W 160; the PE
   step's 16,384 rows; the int64 phase's), at ``kmer_calls.edge_calls``
   (every fallback bit, needs_r2, round 3 off, W 150, 160, 161 and 320
   at nmz 104 and dmax 40, tandem repeats, reads before the text's start
   and across the strand boundary) and at its random calls (seeds 1-3: random bucket
   words and entries). Each recorded call: the kernel's time (a launch in
   a CUDA graph), the plain twin's (CUDA events), the bound (the codes,
   the bucket words and entries of the valid minimizers and the text
   words under the valid diagonals read once, every output written once;
   the instructions of the positions, the reach compares and the
   entries) and the share; then the main path's timed batch clocked
   with the kernel and with the plain twin, in turns (plain, kernel,
   kernel, plain);
9e. seed-SW phase: ``seed_sw_filter`` (one launch of ``seed_sw``: the
   windows, the need test, the SW and the outputs) against
   ``seed_sw_filter_plain`` on the card, bit-equal on ``valid`` and
   ``score``, at every recorded call (the long-read warm-up's 1,024 and
   timed 4,096 reads, S 189; the 8, 18 and 25 kb batches) and at
   ``seedsw_calls.edge_calls`` (activation length, min_hsp, windows at
   l_pac and reference ends, asymmetric gaps), ``fold_calls`` (five
   references, both activation thresholds, the kernel's column
   boundaries, tlen 1, 2 and 199, an all-N read) and ``random_calls``
   (seeds 1, 2), each at the three ``seedsw_calls.SCORINGS`` (the s16x2
   body at the defaults and asymmetric gaps, the s32 body at ``WIDE``),
   with int32 and int64 ranks, int64 also past 2^31. One
   filter call of the timed batch under ``torch.profiler`` issues the
   one ``seed_sw`` kernel and nothing else. Each recorded call: the
   whole filter's time (a call in a CUDA graph), the plain filter's
   (CUDA events), the bound (the DP cells the needed lanes' windows
   span, tlen x qlen, at 3.5 instructions a cell, the first count's 10
   beside; the seeds' and windows' bytes) and the share; then the
   long-read timed batch clocked with the kernel and with the plain
   twin, in turns;
9f. FM-index phase: ``sa_resolve`` and ``backward_search`` against their
   plain twins (``fm.sa_resolve_plain``, ``fm.backward_search_plain``)
   on the card, bit-equal, at the recorded calls (the main path's
   ``resolve_seeds`` walk: 16,384 x 64 lanes under its lane mask; the
   FM-seeded, long-read and int64 ones; the exact step's search of
   16,384 reads and walk of 16,384 x 4 ranks), at
   ``fm_calls.edge_calls`` on an index at SA interval 32 (rank 0, the
   primary, ``seq_len``, the dummy rank 1, marked ranks, ranks that need
   all 31 steps, a lane mask, ranks off the table; empty, one-base,
   full-width, all-ambiguous and no-match reads, an ambiguous base at
   either end, repeats, a length past the width) with int32 and int64
   ranks and past 2^31, and at its random calls (seeds 1-3: 65,536
   ranks, 4,096 reads), and ``fm_calls.group_calls`` (the search's
   group layout: reads either side of a load of codes, ambiguous ends,
   intervals emptied mid-read). Each recorded and random call: the
   kernel's time (a launch in a CUDA graph), the plain twin's (CUDA
   events), the bound (the distinct mark, Occ, major, count and sample
   rows the lanes read, each once, the ranks, mask and positions, or the
   lengths, codes and intervals; or the steps' instructions) and the
   share; a search also beside its latency floor (its slowest read's
   steps x one dependent L2 round trip, ``gather_chain`` on an
   L2-resident table of the main path's Occ shape);
9g. resolve phase: ``resolve_seeds`` through ``resolve_expand``, the
   ``sa_resolve`` walk and ``resolve_finish`` against its plain twin
   (``chain.resolve_seeds_plain``) on the card, bit-equal on the whole
   dict, at the recorded calls (the main path's: B 16,384, S 64, the
   compact cap 4,096; the PE step's, the FM-seeded one's, the long-read
   one's: S 189, no cap; the int64 one's; any fat retry of them), at
   ``resolve_calls.edge_calls`` on an index at SA interval 32 (the cap
   flooded at 4,096 and at (B x S) // 4, position rows, sampling past
   max_occ, more seeds than slots, seeds bridging l_pac and reference
   ends, B x S <= 4,096, no cap, a cap of 64), its random calls
   (seeds 1-3) and ``resolve_calls.lane_calls`` (M 1, 24 and 142, no live
   interval and every one live, equal keys, keys about 0 and 2^27,
   live keys at and past the dead key, int64 keys past 32 bits, negative
   counts and wrapped offsets, S off a multiple of 32), int32, int64 and
   past 2^31. Each recorded call, the
   flooded edge calls and the random ones: each kernel's time (a launch
   in a CUDA graph), the plain twin's before and after its walk (CUDA
   events), the bound (the live intervals, the slots' values and flags,
   the six outputs; the sort's and the slots' compares) and the share,
   and the walk's time under the expansion's mask (every walking lane:
   the cap is applied after the walk) and under the cap's mask alone;
   the main path's call clocked with the kernels and with the plain
   twin, in turns;
10. API phase: ``multi_search`` of the first 256 reads of the main path's
   timed batch against the main path's ``Aligner``, counts zeroed just
   before and read just after (``sw_extend`` must have run); the
   ``SearchResult`` list must equal an ``Aligner`` on the CPU's;
11. CLI phase, in process through ``cli.main``: the genome written as
   FASTA, the main path's timed batch, the exact phase's reads and the PE
   phase's timed pairs as FASTQ; ``index``, ``align --batch-size 16384``
   (its SAM body equal to the main path's), ``align --mode exact`` (equal
   to the exact phase's), ``align --mate`` at 8,192 pairs (equal to the PE
   phase's), ``align --profile`` on one batch of 2,048 reads (the trace
   must name the SW kernel) and ``import`` (shards equal to
   ``pack_reads`` of the file). Every command returns 0, and the reads
   counted in its report are the reads given; counts zeroed just before
   each command and read just after;
12. dist phase (``tools/dist_leg.py``'s ``run_tasks``, one process a
   rank through ``dist/launch.py``; ``gloo`` on ``cuda:0`` when the host
   has fewer GPUs than ranks, else ``nccl``; the kernels built before):
   data-parallel (``data`` 2: the kmer ``Aligner`` on the main path's
   index, each rank half of the rows; the timed batch, and exact mode
   on the exact phase's reads, where every rank must launch
   ``backward_search`` and ``sa_resolve`` and no other kernel),
   index-sharded (``index`` 2: the FM tables split in two, the timed
   batch) and ``data`` 2 x ``index`` 2 (4 ranks, its first 4,096
   reads). Each cell runs its batch twice:
   clocked (a device sync around each stage and each collective; also
   the warm-up), then unclocked. It prints the backend, the unclocked
   run's reads/s and device step, and the clocked run's stage split, FM
   machine steps and ms a step and the collectives' calls, bytes and
   share of the clocked step. Records
   and SAM must equal the main path's (data) or the FM-seeded phase's
   (index) on every read that overflowed in neither run (the others are
   counted), exact mode's the exact phase's; truth >= 98% and
   ``device_ne_oracle`` 0; every rank must launch ``sw_extend``,
   ``chain_seeds``, ``filter_chains``, ``extend_setup``, ``extend_scan``,
   ``extend_windows``, ``extend_merge``, ``extend_seedcov``,
   ``resolve_expand`` and ``resolve_finish`` in both runs, ``fm_seed``,
   ``kmer_seed`` and ``sa_resolve`` too on the data mesh and never on an
   index mesh (its FM machine and SA walk take the shard kernels, and its
   FM seeder has no kmer stage), ``fm_shard_query``, ``fm_shard_apply``,
   ``sa_shard_query``, ``sa_shard_apply`` and ``windows_shard_query``
   on every rank of an index mesh and never on the data mesh, and
   ``seed_sw`` (short reads), ``backward_search``, ``bs_shard_query``
   and ``bs_shard_apply`` on no rank (counts zeroed just before each
   job and read just after, in each rank; the unclocked runs' go on the
   kernels line). The ``index`` 2 cell also runs ``queries``: the
   sharded backward search of the exact phase's 16,384 reads, which
   must launch ``bs_shard_query`` and ``bs_shard_apply`` and no other
   kernel in every rank and equal the exact phase's intervals. It then
   records the FM machine calls, SA walks, window fetches and
   ``resolve_seeds`` call of the whole timed batch (16,384 reads;
   ``tools/shard_calls.py`` ``shard_check``), with that search, and runs
   each in every rank on the kernels and on its plain twin under the
   group (each walk also under a lane mask): all outputs bit-equal and
   the all_reduce calls and bytes equal; it prints each one's steps,
   each launch's device ms a step and the all_reduce's (CUDA events
   around each on a stream the blocking all_reduce left idle, so a
   launch's include its host submit), each kernel's ms a launch in a
   CUDA graph of 20 (the call's first chunk, the walk's LF step, the
   first window fetch, the resolve call, the search's first step)
   beside its bound, and the plain twin's seconds (the walk's and the
   search's warmed, then timed);
13. probe path: counts zeroed, the two probe entry points
   (``tools/microbench_gather.py``, ``tools/microbench_seed.py``) run at
   the TPU tools' shapes and the seeding machine's (16,384 lanes over
   the main-path and a GRCh38-class Occ table), counts read: every probe
   kernel must have run. The entry points hold ``gather_rows``,
   ``gather_chain`` (every variant) and ``add_one`` bit-equal to their
   plain versions and time both; this adds each one's bound at the
   main-path table;
14. prints the kernels line (the step kernels' launches: the timed
   batches of the main, paired-end, FM-seeded and long-read paths, the
   int64 phase's two, the API phase, the CLI's commands and the dist
   phase's unclocked runs in every rank; ``fm_seed``'s times and bound
   are the FM-seeded batch's, ``kmer_seed``'s, ``chain_seeds``' and
   ``filter_chains``' the main path's, ``seed_sw``'s the long-read timed
   batch's, the extension kernels' the main path's call with each
   kernel's launches summed, ``sa_resolve``'s the main path's walk,
   ``backward_search``'s the exact step's, ``resolve_expand``'s and
   ``resolve_finish``'s the main path's call; the index mesh's kernels'
   the ``index`` 2 cell's check, rank 0's first machine call, walk and
   window fetch and the exact reads' search: ms a launch in a CUDA
   graph, the plain twin's ms a whole step outside its all_reduce (the
   machine call's; the median over every walk's timed runs, masked and
   unmasked; the window fetch's; the search's), the bound of the bytes
   that launch must move (``shard_calls.machine_bytes`` /
   ``walk_bytes`` / ``windows_bytes`` / ``search_bytes``); the exact
   step's, the dist phase's exact run's and the index cell's sharded
   search's launches count too), then the device line as the last
   line.

Kernel times: the device time per call of a CUDA graph of calls
(``sw_extend``: 5 launches; ``gather_rows``, ``add_one``, ``kmer_seed``,
``seed_sw``, ``chain_seeds``, ``filter_chains``, ``sa_resolve``,
``backward_search`` and the library calls: 20), so that the host's enqueue
time does not count; ``gather_chain``: CUDA events around one call;
``fm_seed``: CUDA events around one launch, the median of 3. Plain
versions are timed eagerly with CUDA events. ``bound_ms`` is the larger
of the bytes the function must move over 3.35 TB/s and the instructions
it must issue over the card's issue rate (132 SMs x 4 schedulers x 32
lanes x 1.98 GHz), each fused instruction (a multiply-add, a three-input
add, a DPX add-max) counted once. ``tools/sw_profile.py`` times other
builds of the SW kernel in turns with this one.

Nothing is caught: any failed check exits non-zero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

from bioseqdb_tpu_torch import cli
from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner, exact_align_step
from bioseqdb_tpu_torch.api import multi_search
from bioseqdb_tpu_torch.io.batch import pack_reads, pack_reads_from_file
from bioseqdb_tpu_torch.io.fasta import FastaRecord, write_fasta, write_fastq
from bioseqdb_tpu_torch.kernels import build, probes, seedsw
from bioseqdb_tpu_torch.kernels import fm as kfm
from bioseqdb_tpu_torch.kernels import fm_shard_cuda as fsc
from bioseqdb_tpu_torch.kernels.seed import build_r3_jump
from bioseqdb_tpu_torch.kernels.sw_cuda import (FULL_MAX_QLEN, blocks_per_sm,
                                                layout as sw_layout)
from bioseqdb_tpu_torch.sam.emit import (emit_sam, emit_sam_columns,
                                         emit_sam_pair_columns)
from bioseqdb_tpu_torch.utils.profiling import TRACE_FILE
from bioseqdb_tpu_torch.utils.sim import simulate_reads
from bioseqdb_tpu_torch.tools import (chain_calls, dist_leg, extend_calls,
                                      fm_calls, fm_machine, kmer_calls,
                                      long_leg, microbench_gather,
                                      microbench_seed, pe_leg, resolve_calls,
                                      seedsw_calls, shard_calls)
from bioseqdb_tpu_torch.tools.shapes import (OCC_MAIN, SEED_STEPS,
                                             card_line, event_ms, graph_ms,
                                             make_table)
from bioseqdb_tpu_torch.tools.sw_sets import (BATCH, GENOME_LEN, LONG_WQ,
                                              MAIN_WQ, READ_LEN, WIDE_LAYOUT,
                                              WIDE_WQ,
                                              SwCall, main_path_setup,
                                              recording, sw_sets)

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
# the FM machine: a step that extends reads two Occ block rows of 48 bytes
# and their two major rows; it issues at least the counts of four codes in
# the live words of both rows (an XOR and shift-OR, a masked popcount and
# an add each, ~4 live words a row on average) and ~30 compares and
# selects
OCC_ROW_BYTES = 48
FM_INSTR_PER_STEP = 2 * 4 * 4 * 3 + 30
FAT_READS = 4096               # the fat-retry-caps input's lanes
LONG_PLAIN_READS = 256   # the long-read warm-up's reads the twin replays
RAGGED_READS, RAGGED_SEED = 2048, 900
# exact phase: bench.py bench_exact's reads and step
EXACT_SEED, EXACT_STEPS, EXACT_MAX_HITS = 2, 5, 4
API_READS = 256
WIDE_READS, WIDE_LEN, WIDE_SEED = 64, 8000, 302   # long_path's wide batch
# huge_reads_path's reads past the SW ring layout: (reads, length, seed)
HUGE_READS = ((16, 18000, 303), (16, 25000, 304))
DIST_GRID_READS = 4096    # the data x index cell's batch
# the TPU loops the index mesh's kernels replace: the FM machine's owner
# sums under shard_axis, the SA walk's loop
# the index mesh's kernels on the kernels line: the TPU loop each replaces
# (JAX package paths) and, where not fm_shard.cu, its source
SHARD_LINES = dict(fm_shard_query="kernels/seed.py:736",
                   fm_shard_apply="kernels/seed.py:736",
                   sa_shard_query="kernels/fm.py:536",
                   sa_shard_apply="kernels/fm.py:536",
                   windows_shard_query="kernels/extend.py:125",
                   bs_shard_query="dist/shard_index.py:155",
                   bs_shard_apply="dist/shard_index.py:155")
SHARD_SOURCES = dict(windows_shard_query="extend.cu")
# the dist phase's launch rules (``dist_path``): on every mesh, on a data
# mesh only, on an index mesh only, nowhere in a full step
MESH_BOTH = ("sw_extend", "chain_seeds", "filter_chains",
             *build.EXTEND_KERNELS, *build.RESOLVE_KERNELS)
DATA_ONLY = ("fm_seed", "kmer_seed", "sa_resolve")
INDEX_ONLY = (*build.SHARD_KERNELS, *build.WINDOWS_SHARD_KERNELS)
NEVER = ("seed_sw", "backward_search", *build.SEARCH_SHARD_KERNELS)
PROFILE_READS = 2048
QUAL = "I"   # the base quality written to every FASTQ record
# chaining: a valid seed's trip issues at least its five loads, the
# chosen chain's fields, the contained / strand / grow tests and the
# assign store (~24); each live chain its closest-chain test scans a load,
# two compares and two selects (5); an invalid slot a load and a store.
# The filter: an assigned seed's six chain-field updates (~20); a pair of
# live chains the shadow loop compares, the overlap, the mask-level and
# drop tests (~12, float products included); a chain slot its weight,
# order and five stores (~10)
CHAIN_KERNELS = ("chain_seeds", "filter_chains")
CHAIN_INSTR = dict(trips=24, scans=5, invalid=2)
# filter options other than the pipeline's (lower drop and mask levels, a
# weight floor)
FILTER_ALT = dict(mask_level=0.3, chain_drop_ratio=0.7, min_chain_weight=25)
FILTER_INSTR = dict(trips=20, pairs=12, slots=10)
# the extension kernels: the JAX extend_all lines each replaces (the
# containment scan's chunked_while, the round's window fetch, its region
# append, seedcov's fori_loop)
EXTEND_LINES = dict(extend_setup=195, extend_scan=341, extend_windows=462,
                    extend_merge=520, extend_seedcov=567)
RANDOM_SEEDS = (5, 6, 7)   # extend_calls.random_calls' inputs
# the FM-index kernels: the JAX loops each replaces (sa_resolve's
# fori_loop, backward_search's), and fm_calls.random_calls' inputs
FM_LINES = dict(sa_resolve=536, backward_search=409)
FM_RANDOM_SEEDS = (1, 2, 3)
# the resolve kernels: the JAX resolve_seeds lines each replaces (the
# intervals' argsort, the bridge test), and resolve_calls.random_calls'
# inputs
RESOLVE_LINES = dict(resolve_expand=76, resolve_finish=141)
RESOLVE_RANDOM_SEEDS = (1, 2, 3)
KMER_RANDOM_SEEDS = (1, 2, 3)   # kmer_calls.random_calls' inputs
SEEDSW_RANDOM_SEEDS = (1, 2)    # seedsw_calls.random_calls' inputs
# the lanes of the gather chain that times one dependent L2 round trip:
# 8 an SM, so that the loads wait on latency, not on L2's bandwidth
L2_TRIP_LANES = 1024
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


LONG_SETS = ("long_1500", "wide_2048", "wide_18000")
# sw_sets' sets the SW phase leaves out: the card tests hold Wq 25,000
# against plain at both bands, and this set's plain run takes a minute
UNCHECKED_SETS = ("wide_25000",)


def kernel_phase(dev) -> dict:
    for wq, w in ((MAIN_WQ, 200), (320, 200), (LONG_WQ, 100), (WIDE_WQ, 200),
                  *((wq, w) for _, wq, _, w in WIDE_LAYOUT.values())):
        n = blocks_per_sm(wq, w)
        log(f"sw_extend occupancy at Wq={wq}, bands up to {w} "
            f"({sw_layout(wq, w)} layout): {n} blocks of 128 threads an SM "
            f"({4 * n} warps)")
    rng = np.random.default_rng(7)
    max_err, calls, counted_sets = 0, {}, {}
    for name, cases, *opts in sw_sets(rng):
        if name in UNCHECKED_SETS:
            continue
        call = SwCall.from_cases(cases, *opts, dev)
        calls[name] = call
        ref = call.plain(count_cells=name in LONG_SETS)
        if name in LONG_SETS:   # the wide sets' plain runs take seconds
            counted_sets[name] = ref
        err = call.err(ref)
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
    for name in LONG_SETS:   # the band-ring and wide layouts of long reads
        call, ref = calls[name], counted_sets[name]
        wq, w = call.args[0].shape[1], call.kw["max_w"]
        want = "wide" if name in WIDE_LAYOUT else "ring"
        if sw_layout(wq, w) != want:
            raise AssertionError(f"sw_extend [{name}] takes the "
                                 f"{sw_layout(wq, w)} layout, not {want}")
        wide_ms = call.ms()
        b_ms, b_by = sw_bound(call, ref)
        log(f"sw_extend [{name}] {call.shape()}, {want} layout: cuda "
            f"{wide_ms:.4f} ms (a "
            f"launch in a CUDA graph); {int(ref['cells'].sum())} DP cells, "
            f"{int(ref['rows'].sum())} rows, a lane at most "
            f"{int(ref['rows'].max())} -> bound {b_ms:.5f} ms ({b_by}), "
            f"kernel at {100 * b_ms / wide_ms:.3f}% of it")
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


def must_launch(path: str, launches: dict, kmer: bool = True,
                long_reads: bool = False) -> None:
    """``path`` ran the full pipeline: every kernel of its device step
    must have launched, and none it does not run: ``kmer_seed`` runs on
    the kmer seeder's paths (``kmer``) only, ``seed_sw`` on long reads
    only."""
    runs = dict(kmer_seed=kmer, seed_sw=long_reads)
    for name in build.STEP_KERNELS:
        if (launches[name] > 0) != runs.get(name, True):
            raise AssertionError(f"kernel {name}: {launches[name]} launches "
                                 f"on the {path}")


def must_launch_exact(path: str, launches: dict) -> None:
    """``path`` ran exact mode: both FM-index kernels must have launched,
    and no other kernel of a full-pipeline step."""
    for name in build.PATH_KERNELS:
        if (launches[name] > 0) != (name in build.EXACT_KERNELS):
            raise AssertionError(f"kernel {name}: {launches[name]} launches "
                                 f"on the {path}")


def fm_bound(call: "fm_machine.MachineCall", out: dict, touched: dict
             ) -> tuple[float, str]:
    """The FM machine's bound on ``call``'s inputs, from what its plain
    twin counted there (``MachineCall.plain_ms``): each distinct Occ row,
    major row and jump row the lanes read, read once (the lanes' millions
    of fetches re-read a table of a few MB, which stays in L2; split-row
    stall steps fetch nothing); the codes (int32), lens and a reseed
    entry's mems read once, the mems and the five per-lane outputs
    written once; FM_INSTR_PER_STEP instructions a step that extends."""
    a = call.args
    B, W = a["codes"].shape
    rb = a["fm"].occ_majors.element_size()
    io = 4 * B * W + 4 * B + rb * out["mems"].numel() + 17 * B
    if a["entry_reseed"]:
        io += 5 * B + rb * sum(a["reseed_entry"][k].numel()
                               for k in ("mem_s", "mem_b", "mem_e"))
    tables = (OCC_ROW_BYTES * touched["occ"] + 4 * rb * touched["major"]
              + 3 * rb * touched["jump"])
    return bound(tables + io, touched["steps"] * FM_INSTR_PER_STEP)


def fm_machine_phase(m: dict, fmp: dict, lr: dict, dev) -> dict:
    """``fm_seed`` against its plain twin on the card, bit-equal on all
    six outputs, at the inputs the pipeline gave it (recorded in the
    warm-up batches): the main path's reseed entry, the FM-seeded batch
    (jump depth 8), the long-read warm-up's first LONG_PLAIN_READS reads
    (W 1,504, max_mem 142), both
    short ones with int64 ranks, the FM-seeded batch's first FAT_READS
    reads at the fat retry's caps, the FM-seeded batch under a 300-step
    budget, a ragged batch, every fat retry the short warm-ups made, and
    the edge calls (``fm_machine.edge_calls``) at both rank dtypes.
    Each: the kernel's time (CUDA events, median of 3), the plain twin's,
    the slowest lane's steps, the lanes' summed steps and the backward
    share of them, the bound.
    Returns the kernels line's entry (the FM-seeded batch's numbers)."""
    reseed, fmc, long_ = (m["fm_calls"][0], fmp["fm_calls"][0],
                          lr["fm_calls"][0])
    if (not reseed.args["entry_reseed"] or reseed.args["max_mem_intv"]
            or fmc.args["jump"].depth != 8
            or long_.args["codes"].shape[1] != 1504
            or long_.args["max_mem"] != 142):
        raise AssertionError("the recorded machine calls are not the "
                             "pipeline's: " + "; ".join(
                                 c.shape for c in (reseed, fmc, long_)))
    fm64 = kfm.FMDevice.from_host(m["idx"], dev, rank_dtype=torch.int64)
    W = fmc.args["codes"].shape[1]
    codes, lens = fm_machine.ragged_batch(m["genome"], RAGGED_READS,
                                          RAGGED_SEED)
    inputs = [
        ("reseed entry", reseed),
        ("FM-seeded", fmc),
        # its plain twin takes minutes at 1,024 reads: the first
        # LONG_PLAIN_READS, held against the kernel on the same reads
        (f"long-read warm-up, first {LONG_PLAIN_READS} reads",
         long_.lanes(slice(0, LONG_PLAIN_READS))),
        ("int64 reseed entry", reseed.replace(fm=fm64)),
        ("int64 FM-seeded", fmc.replace(fm=fm64, jump=build_r3_jump(fm64))),
        ("fat-retry caps", fmc.lanes(slice(0, FAT_READS)).replace(
            max_cand=32, max_mem=32, max_iters=3 * (10 * W + 256))),
        ("max_iters 300", fmc.replace(max_iters=300)),
        ("ragged, Ns, empty, junk", fmc.replace(codes=codes.to(dev),
                                                lens=lens.to(dev))),
    ] + [(f"recorded fat retry {k}", c) for k, c in
         enumerate(m["fm_calls"][1:] + fmp["fm_calls"][1:])]
    eidx, ecodes, elens, _ = fm_machine.edge_case_setup()
    ecodes, elens = ecodes.to(dev), elens.to(dev)
    for rdt in (torch.int32, torch.int64):
        efm = kfm.FMDevice.from_host(eidx, dev, rank_dtype=rdt)
        inputs += [(f"edge {name}, {str(rdt).removeprefix('torch.')}", c)
                   for name, c in fm_machine.edge_calls(
                       eidx, efm, ecodes, elens).items()]
    rows = {}
    for name, call in inputs:
        got = call.run()
        torch.cuda.synchronize()
        plain_ms, want, touched = call.plain_ms()
        err = fm_machine.max_abs_err(got, want)
        ms = call.kernel_ms()
        it = got["iters"]
        steps, slow = int(it.sum()), int(it.max())
        bound_ms, bound_by = fm_bound(call, got, touched)
        ovf = int(got["overflow"].sum())
        log(f"fm_seed [{name}] {call.shape}: cuda {ms:.4f} ms, plain "
            f"{plain_ms:.1f} ms; slowest lane {slow} steps (a chain of "
            f"dependent Occ fetches: {1e3 * ms / max(slow, 1):.3f} us a "
            f"step), summed steps {steps} ({touched['steps']} extending, "
            f"{touched['bwd']} of them backward: "
            f"{100 * touched['bwd'] / max(steps, 1):.1f}% of the summed "
            f"steps; distinct rows read: Occ {touched['occ']}, major "
            f"{touched['major']}, jump {touched['jump']}); {ovf} lanes "
            f"overflowed; bound {bound_ms:.5f} ms ({bound_by}), kernel at "
            f"{100 * bound_ms / ms:.2f}% of it; max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"fm_seed disagrees with plain on {name}")
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, ovf=ovf,
                          shape=f"{name}: {call.shape}, {slow} steps "
                                f"slowest lane, {steps} summed")
    if rows["max_iters 300"]["ovf"] == 0:
        raise AssertionError("the 300-step budget overflowed no lane")
    e = rows["FM-seeded"]
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                ms=e["ms"], plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
                bound_by=e["bound_by"], library_ms=None, shape=e["shape"])


def chain_bound(call: "chain_calls.ChainCall", out: dict
                ) -> tuple[float, str, dict]:
    """A chaining kernel's bound on ``call``'s inputs, from its outputs
    ``out`` (``ChainCall.counts``): each input the function needs read
    once (the seed fields of valid or assigned slots only, the pos of
    live chains only), each output written once; CHAIN_INSTR /
    FILTER_INSTR instructions a trip. Returns
    (ms, what sets it, the counts)."""
    n = call.counts(out)
    if call.kind == "chain_seeds":
        instr = (CHAIN_INSTR["trips"] * n["trips"]
                 + CHAIN_INSTR["scans"] * n["scans"]
                 + CHAIN_INSTR["invalid"] * (n["slots"] - n["trips"]))
    else:
        instr = sum(FILTER_INSTR[k] * n[k] for k in FILTER_INSTR)
    return (*bound(n["read"] + n["written"], instr), n)


def chain_phase(m: dict, pe: dict, fmp: dict, lr: dict, i64: dict, dev
                ) -> dict:
    """``chain_seeds`` and ``filter_chains`` against their plain twins on
    the card, bit-equal on every output, at the inputs the pipeline gave
    them (recorded in the warm-up batches: the main path's, the PE
    step's, the FM-seeded one's, the long-read one's, the int64 one's,
    and any fat retry of them) and at ``tools/chain_calls.py``'s edge
    seeds with int32 and int64 ranks. Each: the kernel's time (a launch
    in a CUDA graph), the plain twin's, the bound and the share. Returns
    the kernels line's entries (the main path's numbers)."""
    recorded = {}
    for path, d in (("main path", m), ("PE", pe), ("FM-seeded", fmp),
                    ("long-read", lr), ("int64", i64)):
        for k, pair in enumerate(chain_calls.pairs(d["ch_calls"])):
            recorded[path if k == 0 else f"{path} fat retry {k}"] = pair
    want = {"main path": (BATCH, 64, 16, torch.int32),
            "long-read": (long_leg.WARM_READS, 189, 32, torch.int32),
            "int64": (BATCH, 64, 16, torch.int64)}
    for path, (B, S, C, rdt) in want.items():
        cs = recorded[path][0]
        if cs.dims != (B, S, C) or cs.seeds["rbeg"].dtype != rdt:
            raise AssertionError(f"the recorded {path} chain call is not the "
                                 f"pipeline's: {cs.shape}")
    inputs = list(recorded.items())
    for rdt in (torch.int32, torch.int64):
        cs, fc, _ = chain_calls.edge_calls(rdt, device=dev)
        inputs.append((f"edge seeds {str(rdt).removeprefix('torch.')}",
                       (cs, fc)))
        n = 0
        for C in (8, 16, 64):   # the group's chains on later lanes
            for case, call in chain_calls.group_calls(rdt, C, dev).items():
                got = call.run()
                if chain_calls.max_abs_err(got, call.run(plain=True),
                                           call.kind):
                    raise AssertionError(f"chain_seeds disagrees with plain "
                                         f"on {case}, C {C}, {rdt}")
                n += 1
        log(f"chain_seeds on chain_calls.group_calls "
            f"({str(rdt).removeprefix('torch.')}, C 8 / 16 / 64: "
            f"{', '.join(chain_calls.GROUP_CASES)}): {n} calls, "
            f"max_abs_err=0")
        n = 0
        for C in (8, 16, 32, 64):   # the filter's groups and passes
            call, _ = chain_calls.filter_calls(rdt, C, dev)
            for opts in ({}, FILTER_ALT):
                c = chain_calls.ChainCall("filter_chains",
                                          dict(call.args, **opts))
                if chain_calls.max_abs_err(c.run(), c.run(plain=True),
                                           c.kind):
                    raise AssertionError(f"filter_chains disagrees with "
                                         f"plain on filter_calls, C {C}, "
                                         f"{rdt}, {opts}")
                n += 1
        log(f"filter_chains on chain_calls.filter_calls "
            f"({str(rdt).removeprefix('torch.')}, C 8 / 16 / 32 / 64, "
            f"two option sets: {', '.join(chain_calls.FILTER_CASES)}, "
            f"random reads): {n} calls, max_abs_err=0")
    rows = {k: {} for k in CHAIN_KERNELS}
    for name, calls in inputs:
        for call in calls:
            got = call.run()
            torch.cuda.synchronize()
            plain_ms, ref = call.plain_ms()
            err = chain_calls.max_abs_err(got, ref, call.kind)
            ms = call.kernel_ms()
            bound_ms, bound_by, n = chain_bound(call, got)
            work = ", ".join(f"{k} {v}" for k, v in n.items())
            log(f"{call.kind} [{name}] {call.shape}: cuda {ms:.4f} ms a "
                f"launch in a CUDA graph; plain {plain_ms:.1f} ms "
                f"({plain_ms / ms:.0f}x);"
                f" {work}; bound {bound_ms:.5f} ms ({bound_by}), kernel at "
                f"{100 * bound_ms / ms:.2f}% of it; max_abs_err={err}")
            if err != 0:
                raise AssertionError(f"{call.kind} disagrees with plain on "
                                     f"{name}")
            rows[call.kind][name] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, shape=f"{name}: {call.shape}")
    out = {}
    for kind, r in rows.items():
        e = r["main path"]
        out[kind] = dict(max_abs_err=max(x["max_abs_err"] for x in r.values()),
                         ms=e["ms"], plain_ms=e["plain_ms"],
                         bound_ms=e["bound_ms"], bound_by=e["bound_by"],
                         library_ms=None, shape=e["shape"])
    return out


def extend_bound(stage: "extend_calls.StageCall", out
                 ) -> tuple[float, float, dict]:
    """An extension kernel's bound on ``stage``'s inputs, from its outputs
    ``out`` (``StageCall.counts``: each input the function needs read
    once, each output written once, the instructions of its trips):
    (the bytes' ms, the instructions' ms, the counts)."""
    n = stage.counts(out)
    return ((n["read"] + n["written"]) / HBM_BYTES_PER_S * 1e3,
            n["instr"] / ISSUE_PER_S * 1e3, n)


def extend_phase(m: dict, pe: dict, fmp: dict, lr: dict, i64: dict, dev
                 ) -> dict:
    """``extend_scan``, ``extend_windows``, ``extend_merge`` and
    ``extend_seedcov`` against their plain twins on the card, bit-equal on
    every output, at every stage call of the ``extend_all`` calls the
    pipeline made (recorded in the warm-up batches: the main path's, the
    PE step's, the FM-seeded one's, the long-read one's, the int64 one's
    and any fat retry of them), of ``extend_calls.edge_calls`` (int32 and
    int64, with the edge batch's fat retry; int64 also past 2^31) and of
    its random stage inputs; each ``extend_all`` call with the kernels
    equal to it with the plain twins. For the recorded calls, each
    kernel's launches summed over the call: the time (each a launch in a
    CUDA graph), the plain twins', the bound and the share. For the main
    path's call: the host's waits on the card and a clocked run's split
    (scan, windows, SW, merge, seedcov), with the kernels and with the
    plain twins (the eager loops the port ran before). Then the random
    stage inputs and ``extend_calls.lane_cases`` (the boundaries of the
    kernels' thread layout), bit-equal. Returns the kernels line's
    entries (the main path's call)."""
    recorded = {}
    for path, d in (("main path", m), ("PE", pe), ("FM-seeded", fmp),
                    ("long-read", lr), ("int64", i64)):
        for k, call in enumerate(d["ext_calls"]):
            recorded[path if k == 0 else f"{path} fat retry {k}"] = call
    want = {"main path": (BATCH, 64, 8, torch.int32),
            "long-read": (long_leg.WARM_READS, 189, 8, torch.int32),
            "int64": (BATCH, 64, 8, torch.int64)}
    for path, (B, S, R, rdt) in want.items():
        c = recorded[path]
        if c.dims != (B, S, R) or c.args["seeds"]["rbeg"].dtype != rdt:
            raise AssertionError(f"the recorded {path} extend_all call is "
                                 f"not the pipeline's: {c.shape}")
    main = recorded["main path"]
    waits = {way: main.syncs(plain=way == "plain") for way in ("kernels",
                                                               "plain")}
    log(f"extend_all [main path] {main.shape}: the host waits on the card "
        f"{waits['kernels']} times with the kernels, {waits['plain']} with "
        f"the plain twins (the eager loops)")
    if waits["kernels"] != 0:
        raise AssertionError("extend_all with the kernels waits on the card")
    for way in ("plain", "kernels", "kernels", "plain"):
        sp = main.clocked(plain=way == "plain")
        log(f"extend_all [main path] clocked with the {way}: total "
            f"{sp['total']:.4f} s = " + ", ".join(
                f"{k} {sp[k]:.4f}" for k in (*extend_calls.PARTS, "rest"))
            + f"; unclocked (a sync at the ends only) "
            f"{main.wall(plain=way == 'plain'):.4f} s")
    # each route of extend_all (its CUDA graph, the gated launches one by
    # one, the host guards: a wait a round and a side), in turns,
    # between syncs at the ends; each round's active reads; and a call
    # that captures the graph
    for path, call in (("main path", main),
                       ("long-read", recorded["long-read"]),
                       ("long-read timed", lr["timed_ext_call"])):
        acts = [int(st.run(plain=True)["act"].sum()) for st in
                call.stages()[1] if st.kind == "extend_scan"]
        routes = ("guards", "gates", "graph")
        call.run()   # its graph captured before the turns
        walls = {way: [] for way in routes}
        for way in routes + routes[::-1]:
            with extend_calls.route(way):
                walls[way].append(call.wall())
        with extend_calls.route("guards"):
            waits = call.syncs()
        capture = call.capture_s()
        log(f"extend_all [{path}] {call.shape}: active reads a round "
            f"{acts}; unclocked (a sync at the ends only), in turns: "
            + "; ".join(f"{way} " + ", ".join(f"{t:.4f}" for t in walls[way])
                        for way in routes)
            + f" s (the guards wait {waits} times, the others 0); a call "
            f"that captures the graph {capture:.4f} s")
    # the call's device time alone (a CUDA graph of it: no host dispatch),
    # and a dead round's, with and without the gates: a graph of the
    # call with no usable seed at 6 rounds less one at 1 round, over 5
    dead = main.dead
    ms = {}
    for way in ("gated", "ungated"):
        with (extend_calls.ungated() if way == "ungated"
              else contextlib.nullcontext()):
            ms[way] = [dead.replace(max_rounds=r).graph_ms()
                       for r in (1, main.args["max_rounds"])]
    n_dead = main.args["max_rounds"] - 1
    log(f"extend_all [main path] in a CUDA graph: {main.graph_ms():.4f} ms "
        f"a call (the clocked totals above less this: the host's dispatch)"
        f"; a dead round (the call with no usable seed: "
        f"{ms['gated'][0]:.4f} ms at 1 round, {ms['gated'][1]:.4f} at "
        f"{n_dead + 1}): gated "
        f"{(ms['gated'][1] - ms['gated'][0]) / n_dead:.4f} ms, ungated "
        f"{(ms['ungated'][1] - ms['ungated'][0]) / n_dead:.4f} ms "
        f"({ms['ungated'][0]:.4f} / {ms['ungated'][1]:.4f})")
    if extend_calls.max_abs_err(dead.run(), dead.run(plain=True)):
        raise AssertionError("extend_all disagrees with plain on dead rounds")
    inputs = list(recorded.items())
    for rdt in (torch.int32, torch.int64):
        edge, _ = extend_calls.edge_calls(rdt, device=dev, retry=True)
        dt = str(rdt).removeprefix("torch.")
        inputs += [(f"edge {dt} {name}", call) for name, call in edge]
    rows = {k: {} for k in build.EXTEND_KERNELS}
    for name, call in inputs:
        timed = name in recorded
        out, stages = call.stages()
        err = extend_calls.max_abs_err(out, call.run(plain=True))
        if err != 0:
            raise AssertionError(f"extend_all with the kernels disagrees "
                                 f"with the plain twins on {name}")
        if name.startswith("edge int64"):
            stages += [st.shifted() for st in stages
                       if st.kind != "extend_windows"]
        sums = {}
        for st in stages:
            got = st.run()
            torch.cuda.synchronize()
            plain_ms, ref = (st.plain_ms() if timed
                             else (0.0, st.run(plain=True)))
            e = extend_calls.max_abs_err(got, ref)
            if e != 0:
                raise AssertionError(f"{st.name} disagrees with plain on "
                                     f"{name}: {e}")
            if not timed:
                continue
            t_bytes, t_ops, n = extend_bound(st, got)
            r = sums.setdefault(st.kind, dict(
                launches=0, ms=0.0, plain_ms=0.0, bound_ms=0.0, t_bytes=0.0,
                t_ops=0.0, shape=f"{name}: {st.shape}"))
            r["launches"] += 1
            r["ms"] += st.kernel_ms()
            r["plain_ms"] += plain_ms
            r["bound_ms"] += max(t_bytes, t_ops)
            r["t_bytes"] += t_bytes
            r["t_ops"] += t_ops
        log(f"extend_all [{name}] {call.shape}: kernels equal to the plain "
            f"twins at {len(stages)} stage calls, and end to end")
        for kind, r in sums.items():
            by = "bytes" if r["t_bytes"] >= r["t_ops"] else "operations"
            log(f"  {kind} [{name}]: {r['launches']} launches, cuda "
                f"{r['ms']:.4f} ms together (each a launch in a CUDA graph); "
                f"plain {r['plain_ms']:.1f} ms; bound {r['bound_ms']:.5f} ms "
                f"({by}), kernels at {100 * r['bound_ms'] / r['ms']:.2f}% of "
                f"it; max_abs_err=0")
            rows[kind][name] = dict(
                max_abs_err=0, ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=by, library_ms=None,
                shape=f"{r['shape']}, {r['launches']} launches summed")
    for rdt in (torch.int32, torch.int64):
        n = 0
        for name, st in [
                *extend_calls.setup_calls(rdt, device=dev).items(),
                *extend_calls.setup_edge_calls(rdt, device=dev).items()]:
            for c in [st] + ([st.shifted()] if rdt == torch.int64 else []):
                if extend_calls.max_abs_err(c.run(), c.run(plain=True)):
                    raise AssertionError(f"extend_setup disagrees with plain "
                                         f"on the set-up call {name}")
                n += 1
        log(f"extend_setup on the set-up calls "
            f"({str(rdt).removeprefix('torch.')}: "
            f"{', '.join(extend_calls.SETUP_CASES)}; the sort's edges: "
            f"{', '.join(extend_calls.SETUP_EDGE_CASES)}; int64 also past "
            f"2^31): "
            f"{n} calls, max_abs_err=0")
        n = 0
        for seed in RANDOM_SEEDS:
            calls = extend_calls.random_calls(rdt, seed=seed, device=dev)
            if rdt == torch.int64:
                calls += [c.shifted() for c in calls
                          if c.kind != "extend_windows"]
            for st in calls:
                if extend_calls.max_abs_err(st.run(), st.run(plain=True)):
                    raise AssertionError(f"{st.name} disagrees with plain on "
                                         f"random inputs (seed {seed})")
                n += 1
        log(f"extend kernels on random stage inputs "
            f"({str(rdt).removeprefix('torch.')}, seeds {RANDOM_SEEDS}): "
            f"{n} calls, max_abs_err=0")
        n = 0
        for name, (calls, want) in extend_calls.lane_cases(
                rdt, device=dev).items():
            if rdt == torch.int64:
                calls = calls + [c.shifted() for c in calls
                                 if c.kind != "extend_windows"]
            for st in calls:
                got = st.run()
                if extend_calls.max_abs_err(got, st.run(plain=True)):
                    raise AssertionError(f"{st.name} disagrees with plain on "
                                         f"the lane case {name}")
                n += 1
            if want is not None and not torch.equal(
                    calls[0].run()["cursor"].long().cpu(), want):
                raise AssertionError(f"the lane case {name} lost its stops")
        log(f"extend kernels on the lane cases "
            f"({str(rdt).removeprefix('torch.')}: "
            f"{', '.join(extend_calls.LANE_CASES)}): {n} calls, "
            f"max_abs_err=0")
    return {k: r["main path"] for k, r in rows.items()}


def kmer_phase(m: dict, pe: dict, i64: dict, dev) -> dict:
    """``kmer_seed`` against its plain twin on the card, bit-equal on every
    output, at the calls the pipeline made (recorded in the warm-up
    batches: the main path's, the PE step's, the int64 phase's), at
    ``kmer_calls.edge_calls`` and at its random calls. Each recorded
    call: the kernel's time (a launch in a CUDA graph), the plain twin's,
    the bound and the share. Returns the kernels line's entry (the main
    path's numbers)."""
    recorded = {}
    for path, d in (("main path", m), ("PE", pe), ("int64", i64)):
        for k, call in enumerate(d["km_calls"]):
            recorded[path if k == 0 else f"{path} call {k}"] = call
    for path, B in (("main path", BATCH), ("PE", 2 * pe_leg.PAIRS),
                    ("int64", BATCH)):
        call = recorded[path]
        if call.args["codes"].shape[0] != B:
            raise AssertionError(f"the recorded {path} kmer call is not the "
                                 f"pipeline's: {call.shape}")
    inputs = list(recorded.items())
    inputs += [(f"edge {name}", call)
               for name, call in kmer_calls.edge_calls(dev)]
    inputs += [(f"random {seed}.{k}", call) for seed in KMER_RANDOM_SEEDS
               for k, call in enumerate(kmer_calls.random_calls(seed, dev))]
    rows = {}
    for name, call in inputs:
        n0 = build.LAUNCHES["kmer_seed"]
        got = call.run()
        torch.cuda.synchronize()
        if build.LAUNCHES["kmer_seed"] != n0 + 1:
            raise AssertionError(f"kmer_seed [{name}]: not one launch")
        if name == "main path":   # the run's first plain call: warm it up
            call.run(plain=True)
        plain_ms, ref = call.plain_ms()
        err = kmer_calls.max_abs_err(got, ref)
        why = got["why"]
        bits = [int(((why >> k) & 1).sum()) for k in range(7)]
        text = (f"kmer_seed [{name}] {call.shape}: fallback bits {bits}, "
                f"needs_r2 {int(got['needs_r2'].sum())}, seeds "
                f"{int(got['n_mem'].sum())}")
        if name in recorded:
            ms = call.kernel_ms()
            n = call.counts()
            bound_ms, bound_by = bound(n["read"] + n["written"], n["instr"])
            text += (f"; cuda {ms:.4f} ms a launch in a CUDA graph, plain "
                     f"{plain_ms:.1f} ms ({plain_ms / ms:.0f}x); lookups "
                     f"{n['lookups']}, entries {n['entries']}, valid "
                     f"diagonals {n['diags']}, text words {n['text_words']}; "
                     f"bound {bound_ms:.5f} ms ({bound_by}), kernel at "
                     f"{100 * bound_ms / ms:.2f}% of it")
            rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=None, shape=f"{name}: {call.shape}")
        log(f"{text}; max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"kmer_seed disagrees with plain on {name}")
    for way in ("plain", "kernel", "kernel", "plain"):
        with (kmer_calls.plain_seeder() if way == "plain"
              else contextlib.nullcontext()), long_leg.stage_clock() as clock:
            res = long_leg.run_batch(m["al"], m["batches"][1])
        log(f"main path clocked with the {way} seeder: {stage_line(clock)}; "
            f"the batch {sum(res['seconds'].values()):.4f} s")
    return dict(rows["main path"], max_abs_err=0)


def kernels_of(fn) -> list[str]:
    """The CUDA kernels (and copies) that one ``fn()`` issues on the card,
    by name, in order (``torch.profiler``'s CUDA activity)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def seedsw_phase(m: dict, lr: dict, huge: dict, dev) -> dict:
    """``seed_sw_filter`` (one launch of ``seed_sw``: the windows, the need
    test, the SW and the outputs) against ``seed_sw_filter_plain`` on the
    card, bit-equal on ``valid`` and ``score``, at every recorded call
    (the long-read warm-up and timed batches, the 8, 18 and 25 kb
    batches) and at ``seedsw_calls``' edge, fold and random calls
    (SEEDSW_RANDOM_SEEDS), each at the three ``seedsw_calls.SCORINGS``
    (the s16x2 body at two, the s32 body at ``WIDE``), with int32 and
    int64 ranks, int64 also past 2^31. One filter call of the timed batch under ``torch.profiler``
    issues the one ``seed_sw`` kernel and nothing else (the windows' eager
    ops alone issue the number logged). Each recorded call: the whole
    filter's time (a call in a CUDA graph), the plain filter's, the
    bound (the needed cells at ``seedsw_calls.INSTR_PER_CELL``, the first
    count's beside) and the share. Then the long-read timed batch clocked
    with the kernel and with the plain filter, in turns. Returns the
    kernels line's entry (the timed batch's numbers)."""
    recorded = {}
    for batch, calls, B in (("warm-up", lr["sw_calls"][0],
                             long_leg.WARM_READS),
                            ("timed", lr["sw_calls"][1],
                             long_leg.TIMED_READS)):
        if calls[0].args["codes"].shape[0] != B:
            raise AssertionError(f"the recorded long-read filter call is not "
                                 f"the pipeline's: {calls[0].shape}")
        for k, call in enumerate(calls):
            recorded[f"long-read {batch}" + (f" call {k}" if k else "")] = call
    recorded[f"{WIDE_LEN // 1000} kb"] = lr["sw_wide"][0]
    recorded.update({f"{kb} kb": call for kb, call in huge.items()})
    timed = recorded["long-read timed"]
    issued = kernels_of(timed.run)
    eager = kernels_of(lambda: seedsw.seed_sw_windows(
        timed.args["fm"], timed.args["lens"], timed.args["seeds"],
        timed.args["match_score"], timed.args["min_chain_weight"]))
    log(f"seed_sw_filter [long-read timed]: the card ran {issued}; the "
        f"windows' eager ops alone {len(eager)} kernels")
    if len(issued) != 1 or "seed_sw" not in issued[0]:
        raise AssertionError(f"a seed_sw_filter call issued {issued}, not "
                             f"the one seed_sw kernel")
    inputs = list(recorded.items())
    fold = seedsw_calls.fold_setup()
    for rdt in (torch.int32, torch.int64):
        dt = str(rdt).removeprefix("torch.")
        calls = (seedsw_calls.edge_calls(rdt, dev)
                 + seedsw_calls.fold_calls(rdt, dev, setup=fold))
        for seed in SEEDSW_RANDOM_SEEDS:
            calls += seedsw_calls.random_calls(rdt, seed, dev, setup=fold)
        if rdt == torch.int64:
            calls += [(f"{n}, past 2^31", c.shifted()) for n, c in calls]
        inputs += [(f"{dt} {name}", call) for name, call in calls]
    rows = {}
    for name, call in inputs:
        n0 = build.LAUNCHES["seed_sw"]
        got = call.run()
        torch.cuda.synchronize()
        if build.LAUNCHES["seed_sw"] != n0 + 1:
            raise AssertionError(f"seed_sw [{name}]: not one launch")
        want = call.run(plain=True)
        err = seedsw_calls.max_abs_err(got, want)
        dropped = int((call.args["seeds"]["valid"] & ~got["valid"]).sum())
        text = f"seed_sw [{name}] {call.shape}: seeds dropped {dropped}"
        if name in recorded:
            ms = call.kernel_ms()
            plain_ms, _ = call.plain_ms()
            n = call.counts()
            bound_ms, bound_by = bound(n["read"] + n["written"], n["instr"])
            first, _ = bound(n["read"] + n["written"], n["instr_first"])
            text += (f"; the filter: cuda {ms:.4f} ms a call in a CUDA "
                     f"graph, plain {plain_ms:.1f} ms ({plain_ms / ms:.0f}x); "
                     f"{n['lanes']} lanes need the SW, {n['cells']} DP "
                     f"cells; bound {bound_ms:.5f} ms ({bound_by}), kernel "
                     f"at {100 * bound_ms / ms:.2f}% of it (the first "
                     f"count's bound {first:.5f} ms, "
                     f"{100 * first / ms:.2f}%)")
            rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=None, shape=f"{name}: {call.shape}")
        log(f"{text}; max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"seed_sw disagrees with plain on {name}")
    for way in ("plain", "kernel", "kernel", "plain"):
        with (seedsw_calls.plain_filter() if way == "plain"
              else contextlib.nullcontext()), long_leg.stage_clock() as clock:
            res = long_leg.run_batch(m["al"], lr["batch"])
        log(f"long-read batch clocked with the {way} filter: "
            f"{stage_line(clock)}; the batch "
            f"{sum(res['seconds'].values()):.4f} s")
    return dict(rows["long-read timed"], max_abs_err=0)


def l2_round_trip_us(dev, lanes: int = L2_TRIP_LANES,
                     steps: int = SEED_STEPS[0]) -> float:
    """One dependent L2 round trip on this card, in microseconds:
    ``probes.cu`` ``gather_chain`` (one row a step) over the main path's
    Occ-table shape (OCC_MAIN: 71,875 x 12 int32, 3.45 MB, which stays in
    L2), ``lanes`` lanes of ``steps`` dependent loads, a launch in a CUDA
    graph, over its steps."""
    tab, idx = make_table(OCC_MAIN, 0, dev)
    mask = probes.chain_mask(OCC_MAIN.rows)
    ms = graph_ms(lambda: probes.gather_chain_cuda(tab, idx[:lanes], steps,
                                                   mask))
    return 1e3 * ms / steps


def fm_index_phase(m: dict, fmp: dict, lr: dict, i64: dict, ex: dict,
                   dev) -> dict:
    """``sa_resolve`` and ``backward_search`` against their plain twins
    (``fm.sa_resolve_plain``, ``fm.backward_search_plain``) on the card,
    bit-equal, at the calls the pipeline gave them (recorded in the
    warm-ups: the main path's, the FM-seeded, long-read and int64 ones
    and the exact step's) and at ``tools/fm_calls.py``'s edge sets and
    random inputs (seeds FM_RANDOM_SEEDS) on an index at SA interval 32,
    int32, int64 and past 2^31. Each recorded and random call: the
    kernel's time (a launch in a CUDA graph), the plain twin's (CUDA
    events), the bound (the distinct table rows the lanes read, each
    once, with the ranks, mask and positions or the lengths, the codes
    the searches take and the intervals; or the steps' instructions) and
    the share. Returns the kernels line's entries: the main path's
    ``sa_resolve`` call, the exact step's ``backward_search``."""
    recorded = []
    for path, d in (("main path", m), ("FM-seeded", fmp), ("long-read", lr),
                    ("int64", i64), ("exact step", ex)):
        recorded += [(f"{path} call {k}", c)
                     for k, c in enumerate(d["fmi_calls"])]
    first = dict(recorded)
    sa, bs, xs = (first["main path call 0"], first["exact step call 0"],
                  first["exact step call 1"])
    if (sa.kind != "sa_resolve" or sa.lanes < BATCH * 64
            or sa.args["mask"] is None or bs.kind != "backward_search"
            or xs.kind != "sa_resolve" or xs.args["ranks"].shape[1]
            != EXACT_MAX_HITS or first["int64 call 0"].fm.rank_dtype
            != torch.int64):
        raise AssertionError("the recorded FM-index calls are not the "
                             "pipeline's: " + "; ".join(
                                 f"{n}: {c.kind} {c.shape}"
                                 for n, c in recorded))
    inputs = [(name, c, True) for name, c in recorded]
    es = fm_calls.edge_setup()
    for rdt in (torch.int32, torch.int64):
        fm = kfm.FMDevice.from_host(es.idx, dev, rank_dtype=rdt)
        tag = str(rdt).removeprefix("torch.")
        inputs += [(f"edge {n}, {tag}", c, False) for n, c in
                   fm_calls.edge_calls(es, fm, device=dev).items()]
        inputs += [(f"edge {n}, {tag}", c, False) for n, c in
                   fm_calls.group_calls(es, fm, device=dev).items()]
        for seed in FM_RANDOM_SEEDS:
            inputs += [(f"{n}, {tag}", c, True) for n, c in
                       fm_calls.random_calls(es, fm, seed, device=dev,
                                             n_ranks=65536,
                                             n_reads=4096).items()]
        if rdt == torch.int64:
            inputs += [(f"edge {n}, past 2^31", c, False) for n, c in
                       fm_calls.edge_calls(es, fm_calls.shifted(fm),
                                           device=dev).items()]
    trip = l2_round_trip_us(dev)
    log(f"one dependent L2 round trip: {trip:.4f} us (gather_chain, "
        f"{L2_TRIP_LANES} lanes on {OCC_MAIN.name})")
    rows = {k: {} for k in FM_LINES}
    for name, call, timed in inputs:
        got = call.run()
        torch.cuda.synchronize()
        plain_ms, ref = call.plain_ms()
        err = fm_calls.max_abs_err(got, ref, call.kind)
        if err != 0:
            raise AssertionError(f"{call.kind} disagrees with plain on "
                                 f"{name}: max_abs_err={err}")
        if not timed:
            log(f"{call.kind} [{name}] {call.shape}: max_abs_err={err}")
            continue
        ms = call.kernel_ms()
        n = call.counts()
        bound_ms, bound_by = bound(n["table_bytes"] + n["io_bytes"],
                                   n["instr"])
        work = ", ".join(f"{k} {v}" for k, v in n.items())
        floor = ""
        if call.kind == "backward_search":
            slow = int(fm_calls.search_steps(call)["steps"].max())
            floor = (f"; latency floor {slow * trip / 1e3:.5f} ms (the "
                     f"slowest read's {slow} steps x {trip:.4f} us), kernel "
                     f"at {100 * slow * trip / 1e3 / ms:.2f}% of it")
        log(f"{call.kind} [{name}] {call.shape}: cuda {ms:.4f} ms a launch "
            f"in a CUDA graph; plain {plain_ms:.2f} ms ({plain_ms / ms:.0f}x)"
            f"; {work}; bound {bound_ms:.5f} ms ({bound_by}), kernel at "
            f"{100 * bound_ms / ms:.2f}% of it{floor}; max_abs_err={err}")
        rows[call.kind][name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, shape=f"{name}: {call.shape}")
    out = {}
    for kind, key in (("sa_resolve", "main path call 0"),
                      ("backward_search", "exact step call 0")):
        e = rows[kind][key]
        out[kind] = dict(max_abs_err=0, ms=e["ms"], plain_ms=e["plain_ms"],
                         bound_ms=e["bound_ms"], bound_by=e["bound_by"],
                         library_ms=None, shape=e["shape"])
    return out


def resolve_phase(m: dict, pe: dict, fmp: dict, lr: dict, i64: dict, dev
                  ) -> dict:
    """``resolve_seeds`` with ``resolve_expand`` and ``resolve_finish``
    (around the ``sa_resolve`` walk) against its plain twin
    (``chain.resolve_seeds_plain``) on the card, bit-equal on the whole
    dict, at every call the pipeline made (recorded in the warm-ups: the
    main path's, the PE step's, the FM-seeded one's, the long-read one's,
    the int64 one's and any fat retry of them), at
    ``resolve_calls.edge_calls`` and random intervals (int32, int64 and
    past 2^31). Each recorded and random call: each kernel's time (a
    launch in a CUDA graph), the plain twin's time before and after its
    walk (CUDA events), the bound and the share; the walk's time under
    the expansion's mask (every walking lane) and under the cap's alone.
    The main path's call clocked through the kernels and the plain twin,
    in turns. Returns the kernels line's entries (the main path's
    call)."""
    recorded = {}
    for path, d in (("main path", m), ("PE", pe), ("FM-seeded", fmp),
                    ("long-read", lr), ("int64", i64)):
        for k, call in enumerate(d["res_calls"]):
            recorded[path if k == 0 else f"{path} fat retry {k}"] = call
    want = {"main path": (BATCH, 64, torch.int32, 4096),
            "long-read": (long_leg.WARM_READS, 189, torch.int32, None),
            "int64": (BATCH, 64, torch.int64, 4096)}
    for path, (B, S, rdt, cap) in want.items():
        c = recorded[path]
        if (c.dims[0], c.dims[2]) != (B, S) or (
                c.args["mems"].dtype != rdt or c.args["compact_cap"] != cap):
            raise AssertionError(f"the recorded {path} resolve_seeds call is "
                                 f"not the pipeline's: {c.shape}")
    main = recorded["main path"]
    for way in ("plain", "kernels", "kernels", "plain"):
        log(f"resolve_seeds [main path] {main.shape} clocked with the "
            f"{way}: {main.clocked(plain=way == 'plain'):.6f} s")
    inputs = [(name, c, True) for name, c in recorded.items()]
    es = fm_calls.edge_setup()
    for rdt in (torch.int32, torch.int64):
        fm = kfm.FMDevice.from_host(es.idx, dev, rank_dtype=rdt)
        tag = str(rdt).removeprefix("torch.")
        edge = resolve_calls.edge_calls(es, fm, device=dev)
        for seed in RESOLVE_RANDOM_SEEDS:
            edge.update(resolve_calls.random_calls(es, fm, seed, device=dev))
        edge.update({f"lanes {n}": c for n, c in
                     resolve_calls.lane_calls(es, fm, device=dev).items()})
        if rdt == torch.int64:
            edge.update({f"{n}, past 2^31": c.shifted()
                         for n, c in list(edge.items())})
        inputs += [(f"edge {n}, {tag}", c, n.startswith("random")
                    or n.startswith("cap 4096")) for n, c in edge.items()]
    rows = {k: {} for k in RESOLVE_LINES}
    for name, call, timed in inputs:
        got = call.run()
        torch.cuda.synchronize()
        before, after, ref = call.plain_ms()
        err = resolve_calls.max_abs_err(got, ref)
        if err != 0:
            raise AssertionError(f"resolve_seeds with the kernels disagrees "
                                 f"with plain on {name}: {err}")
        if not timed:
            log(f"resolve_seeds [{name}] {call.shape}: max_abs_err=0")
            continue
        ex, pos, ends = call.stages()
        n = call.counts(ex, got)
        walk = call.walk_ms()
        log(f"resolve_seeds [{name}] {call.shape}: the walk of "
            f"{walk['walking']} walking lanes (the cap {call.cap}): cuda "
            f"{walk['all']:.4f} ms under the expansion's mask (all), "
            f"{walk['capped']:.4f} under the cap's; max_abs_err=0")
        for kind, ms, plain_ms in (("resolve_expand", call.expand_ms(),
                                    before),
                                   ("resolve_finish", call.finish_ms(),
                                    after)):
            c = n[kind.removeprefix("resolve_")]
            bound_ms, bound_by = bound(c["read"] + c["written"], c["instr"])
            log(f"  {kind} [{name}]: cuda {ms:.4f} ms a launch in a CUDA "
                f"graph; plain {plain_ms:.3f} ms ({plain_ms / ms:.0f}x); "
                f"read {c['read']} B, written {c['written']} B, "
                f"{c['instr']} instructions: bound {bound_ms:.5f} ms "
                f"({bound_by}), kernel at {100 * bound_ms / ms:.2f}% of it")
            rows[kind][name] = dict(
                max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                shape=f"{name}: {call.shape}")
    return {k: r["main path"] for k, r in rows.items()}


def main_path(dev, card: str) -> dict:
    t0 = time.time()
    idx, al, sims, batches, genome = main_path_setup(dev)
    log(f"index {GENOME_LEN} bases + Aligner.build + reads: "
        f"{time.time() - t0:.1f} s")

    t0 = time.time()
    calls, mc_calls, ch_calls, ext_calls, km_calls = [], [], [], [], []
    fmi_calls, res_calls = [], []
    n0 = build.LAUNCHES["sw_extend"]
    with (recording(calls) as sw_rec, fm_machine.recording(mc_calls),
          chain_calls.recording(ch_calls),
          extend_calls.recording(ext_calls), kmer_calls.recording(km_calls),
          fm_calls.recording(fmi_calls),
          resolve_calls.recording(res_calls)):
        long_leg.run_batch(al, batches[0])
    warm = build.LAUNCHES["sw_extend"] - n0
    log(f"warm-up batch: {time.time() - t0:.1f} s, {len(calls)} sw_extend "
        f"launches recorded and {sw_rec.closed} with a closed gate, {warm} "
        f"counted")
    if not 0 < len(calls) + sw_rec.closed == warm:
        raise AssertionError("the warm-up batch's sw_extend launches were "
                             "not all recorded")
    # the warm-up again, unrecorded: extend_all captures its CUDA graph
    # (the recorders run it launch by launch), as a server's first batch
    # of a shape does, so the timed batch replays it
    t0 = time.time()
    long_leg.run_batch(al, batches[0])
    log(f"warm-up batch again, unrecorded (extend_all's graph captured): "
        f"{time.time() - t0:.3f} s")
    build.reset_launches()
    res = long_leg.run_batch(al, batches[1])
    launches = dict(build.LAUNCHES)
    sec = res["seconds"]
    total = sum(sec.values())
    rps = BATCH / total
    log("timed batch: " + ", ".join(f"{k} {v:.3f} s" for k, v in sec.items())
        + f", total {total:.3f} s")
    log(f"main path: {rps:.1f} reads/s ({BATCH} x {READ_LEN} bp SE, "
        f"{GENOME_LEN} b genome) on {card}; launches {launches}")
    must_launch("main path", launches)
    truth_check("main path", al, sims[1], batches[1], res["cols"],
                res["n_ovf"])
    sam = se_sam(idx, res["cols"], batches[1])
    with long_leg.stage_clock() as clock:
        long_leg.run_batch(al, batches[1])
    log(f"main path device step (the timed batch again, clocked): "
        f"{stage_line(clock)}")
    return dict(launches=launches, rps=rps, calls=calls, fm_calls=mc_calls,
                ch_calls=ch_calls, ext_calls=ext_calls, km_calls=km_calls,
                fmi_calls=fmi_calls, res_calls=res_calls, idx=idx, al=al,
                genome=genome,
                sims=sims, batches=batches, cols=res["cols"], ovf=res["ovf"],
                sam=sam)


def with_quals(batch):
    """``batch`` with the qualities of its FASTQ records (``QUAL``)."""
    return dataclasses.replace(batch, qualities=[
        QUAL * int(n) for n in batch.lens[: batch.n]])


def texts(batch) -> list[str]:
    return [batch.read_text(i) for i in range(batch.n)]


def se_sam(idx, cols, batch) -> str:
    """A single-end batch's SAM records, rendered as the CLI renders the
    batch read from its FASTQ file."""
    t0 = time.time()
    sam = emit_sam_columns(cols, idx, with_quals(batch), header=False,
                           seqs=texts(batch))
    log(f"SAM text (emit_sam_columns): {sam.count(chr(10))} records, "
        f"{time.time() - t0:.3f} s")
    return sam


def truth_check(path: str, al, sim, batch, cols, n_ovf: int) -> None:
    """Reads at their simulated origin (>= 98%), and every read off it
    equal to the host oracle (``tools/long_leg.py`` ``check``)."""
    chk = long_leg.check(al, sim, batch, cols)
    n = chk["reads"]
    log(f"{path} truth: {chk['truth']}/{n}; device overflow before retry: "
        f"{n_ovf}; host-oracle rows after retry: {chk['host_oracle_rows']}; "
        f"off-truth reads: {chk['off_truth']}, device_ne_oracle: "
        f"{chk['ne_oracle']}")
    if chk["ne_oracle"] or chk["truth"] < 0.98 * n:
        raise AssertionError(f"{path} disagrees with the host oracle")


def stage_line(clock: "long_leg.stage_clock") -> str:
    """The device step's stage split of a clocked batch, and the FM
    machine's slowest lane's steps and seconds a step."""
    sp = clock.split()
    text = ", ".join(f"{k} {sp[k]:.4f} s" for k in long_leg.CLOCKED
                     if k in sp)
    if "fm_machine_steps" in sp:
        text += (f"; FM machine {sp['fm_machine_s']:.3f} s for its slowest "
                 f"lane's {sp['fm_machine_steps']} steps: "
                 f"{1e3 * sp['fm_s_per_step']:.3f} ms a step")
    return text


def fm_main_path(m: dict, dev, card: str) -> dict:
    """The main path's index and batches through an FM-seeded Aligner."""
    t0 = time.time()
    al = Aligner.build(m["idx"], AlignOptions(), device=dev, seeder="fm")
    log(f"FM-seeded Aligner.build (jump depth {al.jump.depth}): "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    mc_calls, ch_calls, ext_calls, fmi_calls, res_calls = [], [], [], [], []
    with (fm_machine.recording(mc_calls), chain_calls.recording(ch_calls),
          extend_calls.recording(ext_calls), fm_calls.recording(fmi_calls),
          resolve_calls.recording(res_calls)):
        long_leg.run_batch(al, m["batches"][0])
    log(f"FM-seeded warm-up batch: {time.time() - t0:.1f} s")
    build.reset_launches()
    with long_leg.stage_clock() as clock:
        res = long_leg.run_batch(al, m["batches"][1])
    launches = dict(build.LAUNCHES)
    sec = res["seconds"]
    total = sum(sec.values())
    log("FM-seeded timed batch: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in sec.items()) + f", total {total:.3f} s")
    log(f"FM-seeded device step: {stage_line(clock)}")
    log(f"FM-seeded main path: {BATCH / total:.1f} reads/s ({BATCH} x "
        f"{READ_LEN} bp SE, {GENOME_LEN} b genome) on {card}; launches "
        f"{launches}")
    must_launch("FM-seeded main path", launches, kmer=False)
    truth_check("FM-seeded main path", al, m["sims"][1], m["batches"][1],
                res["cols"], res["n_ovf"])
    return dict(launches=launches, al=al, cols=res["cols"], ovf=res["ovf"],
                fm_calls=mc_calls, ch_calls=ch_calls, ext_calls=ext_calls,
                fmi_calls=fmi_calls, res_calls=res_calls,
                sam=se_sam(m["idx"], res["cols"], m["batches"][1]))


def long_path(m: dict, card: str) -> dict:
    """The long-read leg on the main path's index and Aligner."""
    al = m["al"]
    t0 = time.time()
    warm, timed = (long_leg.simulate(m["genome"], n, seed) for n, seed in
                   ((long_leg.WARM_READS, long_leg.WARM_SEED),
                    (long_leg.TIMED_READS, long_leg.TIMED_SEED)))
    log(f"long reads simulated: {time.time() - t0:.1f} s")
    t0 = time.time()
    calls, mc_calls, ch_calls, ext_calls, fmi_calls = [], [], [], [], []
    res_calls = []
    sw_calls = ([], [])   # the warm-up's seed-SW filter calls, the timed's
    n0 = build.LAUNCHES["sw_extend"]
    with (recording(calls) as sw_rec, fm_machine.recording(mc_calls),
          chain_calls.recording(ch_calls),
          extend_calls.recording(ext_calls),
          seedsw_calls.recording(sw_calls[0]), fm_calls.recording(fmi_calls),
          resolve_calls.recording(res_calls)):
        long_leg.run_batch(al, warm[1])
    counted = build.LAUNCHES["sw_extend"] - n0
    log(f"long-read warm-up batch ({long_leg.WARM_READS} x "
        f"{long_leg.READ_LEN} bp): {time.time() - t0:.1f} s, {len(calls)} "
        f"sw_extend launches recorded and {sw_rec.closed} with a closed "
        f"gate, {counted} counted")
    if not 0 < len(calls) + sw_rec.closed == counted:
        raise AssertionError("the long-read warm-up batch's sw_extend "
                             "launches were not all recorded")
    # the timed batch once unrecorded and unclocked: extend_all captures
    # the CUDA graph of its shape (the warm-up's recorders ran it launch
    # by launch, at another batch size), as a server's first batch does
    t0 = time.time()
    long_leg.run_batch(al, timed[1])
    log(f"long-read timed batch, a first run (extend_all's graph "
        f"captured): {time.time() - t0:.3f} s")
    build.reset_launches()
    timed_ext = []
    with (long_leg.stage_clock() as clock,
          seedsw_calls.recording(sw_calls[1]),
          extend_calls.recording(timed_ext)):
        res = long_leg.run_batch(al, timed[1])
    launches = dict(build.LAUNCHES)
    # every round of an extend_all call launches sw_extend four times
    # (each side and its retry) at Wq = the batch's width
    sw_calls_made = sum(4 * c.args["max_rounds"] for c in timed_ext)
    wide = [c.args["codes"].shape[1] for c in timed_ext
            if c.args["codes"].shape[1] > FULL_MAX_QLEN]
    sec = res["seconds"]
    total = sum(sec.values())
    n = long_leg.TIMED_READS
    log("long-read timed batch: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in sec.items()) + f", total {total:.3f} s")
    log(f"long-read device step: {stage_line(clock)}")
    log(f"long-read path: {n / total:.1f} reads/s, "
        f"{n * long_leg.READ_LEN / total:.0f} bases/s ({n} x "
        f"{long_leg.READ_LEN} bp SE, {GENOME_LEN} b genome) on {card}; "
        f"launches {launches}; sw_extend at Wq > {FULL_MAX_QLEN}: "
        f"{len(wide)} (Wq {sorted(set(wide))})")
    if launches["sw_extend"] != sw_calls_made or not wide:
        raise AssertionError("the long-read batch did not launch sw_extend "
                             f"at Wq > {FULL_MAX_QLEN}")
    must_launch("long-read path", launches, kmer=False, long_reads=True)
    truth_check("long-read path", al, *timed, res["cols"], res["n_ovf"])
    main_path_launches([c for c in calls if c.args[0].shape[1] > FULL_MAX_QLEN],
                       "long-read")
    # reads of 8 kb (the FM seeder's M 548, S 730: the set-up's and the
    # expansion's tables of a read in shared memory still, the fat
    # retry's set-up past it), twice: truth, and the same records
    sim, batch = long_leg.simulate(m["genome"], WIDE_READS, WIDE_SEED,
                                   read_len=WIDE_LEN)
    build.reset_launches()
    t0 = time.time()
    sw_wide = []
    with seedsw_calls.recording(sw_wide):
        wide = [long_leg.run_batch(al, batch)]
    wide.append(long_leg.run_batch(al, batch))
    log(f"wide reads ({WIDE_READS} x {WIDE_LEN} bp, twice): "
        f"{time.time() - t0:.2f} s; launches {dict(build.LAUNCHES)}")
    must_launch("wide reads", dict(build.LAUNCHES), kmer=False,
                long_reads=True)
    truth_check("wide reads", al, sim, batch, wide[0]["cols"],
                wide[0]["n_ovf"])
    if not cols_equal(wide[0]["cols"], wide[1]["cols"]):
        raise AssertionError("wide reads: two runs differ")
    return dict(launches=launches, fm_calls=mc_calls, ch_calls=ch_calls,
                ext_calls=ext_calls, timed_ext_call=timed_ext[0],
                sw_calls=sw_calls, sw_wide=sw_wide, fmi_calls=fmi_calls,
                res_calls=res_calls, batch=timed[1])


def huge_reads_path(m: dict) -> dict:
    """Reads past the SW ring layout's shared memory (18 kb and 25 kb) on
    the main path's index and Aligner, twice each: every step kernel
    launches, sw_extend at its wide layout; truth; the same records.
    Returns each batch's first seed-SW filter call by its kb."""
    al = m["al"]
    sw = {}
    for n_reads, read_len, seed in HUGE_READS:
        what = f"{read_len // 1000} kb reads"
        sim, batch = long_leg.simulate(m["genome"], n_reads, seed,
                                       read_len=read_len)
        build.reset_launches()
        ext, flt = [], []
        t0 = time.time()
        with extend_calls.recording(ext), seedsw_calls.recording(flt):
            runs = [long_leg.run_batch(al, batch)]
        sw[read_len // 1000] = flt[0]
        runs.append(long_leg.run_batch(al, batch))
        huge_launches = dict(build.LAUNCHES)
        widths = sorted({c.args["codes"].shape[1] for c in ext})
        layouts = {w: (sw_layout(w, c.args["bandwidth"]),
                       sw_layout(w, 2 * c.args["bandwidth"]))
                   for c in ext for w in [c.args["codes"].shape[1]]}
        log(f"{what} ({n_reads} x {read_len} bp, seed {seed}, twice): "
            f"{time.time() - t0:.2f} s; launches {huge_launches}; "
            f"extend_all at Wq {widths}, sw_extend layouts at its bands "
            f"{layouts}")
        must_launch(what, huge_launches, kmer=False, long_reads=True)
        if not ext or any(v != ("wide", "wide") for v in layouts.values()):
            raise AssertionError(f"{what}: sw_extend did not take its wide "
                                 f"layout: {layouts}")
        truth_check(what, al, sim, batch, runs[0]["cols"], runs[0]["n_ovf"])
        if not cols_equal(runs[0]["cols"], runs[1]["cols"]):
            raise AssertionError(f"{what}: two runs differ")
    return sw


def pe_path(m: dict, card: str) -> dict:
    """The paired-end path on the main path's index and ``Aligner``."""
    idx, al = m["idx"], m["al"]
    t0 = time.time()
    warm, timed = (pe_leg.simulate(m["genome"], pe_leg.PAIRS, seed)
                   for seed in (700, 701))
    log(f"two batches of {pe_leg.PAIRS} pairs simulated: "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    calls, ch_calls, ext_calls, km_calls, res_calls = [], [], [], [], []
    n0 = build.LAUNCHES["sw_extend"]
    with (recording(calls) as sw_rec, chain_calls.recording(ch_calls),
          extend_calls.recording(ext_calls), kmer_calls.recording(km_calls),
          resolve_calls.recording(res_calls)):
        pe_leg.run_batch(al, warm)
    counted = build.LAUNCHES["sw_extend"] - n0
    log(f"PE warm-up batch: {time.time() - t0:.1f} s, {len(calls)} "
        f"sw_extend launches recorded and {sw_rec.closed} with a closed "
        f"gate, {counted} counted")
    if not 0 < len(calls) + sw_rec.closed == counted:
        raise AssertionError("the PE warm-up batch's sw_extend launches "
                             "were not all recorded")
    build.reset_launches()
    res = pe_leg.run_batch(al, timed)
    launches = dict(build.LAUNCHES)
    must_launch("PE path", launches)
    sec = res["seconds"]
    total = sum(sec.values())
    log("PE timed batch: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                       sec.items())
        + f", total {total:.3f} s; rows overflowing before the retry "
        f"{res['n_ovf']}; launches {launches}")
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
    sam = pe_sam(idx, res["cols"], timed)
    main_path_launches(calls, "PE")
    return dict(launches=launches, timed=timed, sam=sam, ch_calls=ch_calls,
                ext_calls=ext_calls, km_calls=km_calls, res_calls=res_calls)


def pe_sam(idx, cols, pb) -> str:
    """A pair batch's SAM records, rendered as the CLI renders the pairs
    read from their FASTQ files."""
    t0 = time.time()
    b1, b2 = pb.batches
    sam = emit_sam_pair_columns(*cols, idx, with_quals(b1), with_quals(b2),
                                header=False, seqs1=texts(b1),
                                seqs2=texts(b2))
    log(f"PE SAM text (emit_sam_pair_columns): {sam.count(chr(10))} "
        f"records, {time.time() - t0:.3f} s")
    return sam


def exact_path(m: dict, dev, card: str, n_reads: int = BATCH) -> dict:
    """Exact mode on the main path's index: ``exact_align_step`` timed,
    then ``align_batch``, held against truth and the port's CPU path."""
    idx = m["idx"]
    t0 = time.time()
    sim = simulate_reads(m["genome"], n_reads, read_len=READ_LEN,
                         sub_rate=0.0, seed=EXACT_SEED)
    batch = pack_reads(sim.reads, sim.names)
    log(f"exact reads simulated: {time.time() - t0:.1f} s")
    t0 = time.time()
    al = Aligner.build(idx, AlignOptions(), device=dev, mode="exact")
    log(f"exact-mode Aligner.build: {time.time() - t0:.2f} s")
    codes = torch.from_numpy(batch.codes).to(dev)
    lens = torch.from_numpy(batch.lens).to(dev)

    def step():
        return exact_align_step(al.fm, codes, lens, EXACT_MAX_HITS,
                                sa_interval=idx.sa_interval)

    fmi_calls = []
    t0 = time.perf_counter()
    with fm_calls.recording(fmi_calls):
        step()
    warm = time.perf_counter() - t0
    build.reset_launches()
    t0 = time.perf_counter()
    for _ in range(EXACT_STEPS):
        out = step()
    step_s = (time.perf_counter() - t0) / EXACT_STEPS
    launches = dict(build.LAUNCHES)
    log(f"exact_align_step launches ({EXACT_STEPS} calls): "
        f"{ {k: launches[k] for k in build.EXACT_KERNELS} }")
    must_launch_exact("exact step", launches)
    log(f"exact_align_step ({n_reads} x {READ_LEN} bp, max_hits "
        f"{EXACT_MAX_HITS}, {READ_LEN} backward steps + "
        f"{idx.sa_interval - 1} LF steps): warm-up {warm:.4f} s, "
        f"{step_s:.4f} s a call (mean of {EXACT_STEPS}), "
        f"{n_reads / step_s:.1f} reads/s on {card}")
    n_hits = out["n_hits"][:n_reads]
    t0 = time.perf_counter()
    res = al.align_batch(batch)
    batch_s = time.perf_counter() - t0
    log(f"exact align_batch (default max_hits "
        f"{min(al.options.resolve_max_occ(idx.n_refs), 64)}): "
        f"{batch_s:.3f} s, {n_reads / batch_s:.1f} reads/s on {card}")
    uniq = np.flatnonzero(n_hits == 1)
    at = sum(res[i].hits[0].ref_begin == sim.positions[i]
             and res[i].hits[0].is_reverse == bool(sim.strands[i])
             for i in uniq.tolist())
    log(f"exact truth: every read has a hit: {bool((n_hits >= 1).all())}; "
        f"{uniq.size} reads with one hit, {at} of them at their simulated "
        f"position and strand; {int((n_hits > 1).sum())} repeated")
    if not (n_hits >= 1).all() or at != uniq.size:
        raise AssertionError("exact mode missed a read's simulated origin")
    t0 = time.time()
    cpu = Aligner.build(idx, AlignOptions(), device="cpu", mode="exact")
    want = cpu.align_batch(batch)
    seqs, quals = texts(batch), with_quals(batch).qualities
    sam = emit_sam(res, idx, seqs, quals, header=False)
    same = ([dataclasses.asdict(r) for r in res]
            == [dataclasses.asdict(r) for r in want]
            and sam == emit_sam(want, idx, seqs, quals, header=False))
    log(f"exact records and SAM text equal to the CPU path's: {same} "
        f"({time.time() - t0:.1f} s)")
    if not same:
        raise AssertionError("exact mode on the card differs from the CPU")
    lo, hi = kfm.backward_search(al.fm, codes, lens)
    return dict(sim=sim, batch=batch, al=al, res=res, sam=sam,
                launches=launches, fmi_calls=fmi_calls,
                intervals=(lo.cpu().numpy(), hi.cpu().numpy()))


def cols_equal(a, b) -> bool:
    """Two batches' ``AlignColumns``, every field (the per-read results of
    rows off the columns included), equal; the text blob by each row's
    CIGAR and MD (the blob's unused bytes are uninitialised)."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "text":
            same = all(a.cigar(i) == b.cigar(i) and a.md(i) == b.md(i)
                       for i in range(a.n))
        elif f.name == "extra":
            same = x.keys() == y.keys() and all(
                dataclasses.asdict(x[k]) == dataclasses.asdict(y[k])
                for k in x)
        elif isinstance(x, np.ndarray):
            same = x.dtype == y.dtype and np.array_equal(x, y)
        else:
            same = x == y
        if not same:
            return False
    return True


def int64_path(m: dict, fmp: dict, ex: dict, dev, card: str) -> dict:
    """The main path's batches and the exact reads with int64 ranks forced
    on the main path's index (the ``Aligner``s given an FMDevice built
    with ``rank_dtype=torch.int64``, as the tests build it): the warm-up
    batch's ``sw_extend`` launches recorded and each run again alone, the
    timed batch kmer- and FM-seeded (counts zeroed just before each and
    read just after), exact mode; records and SAM equal to the int32
    phases', ``rb`` int64."""
    idx, batch = m["idx"], m["batches"][1]
    t0 = time.time()
    fm64 = kfm.FMDevice.from_host(idx, dev, rank_dtype=torch.int64)
    jump = build_r3_jump(fm64)
    als = {name: dataclasses.replace(al, fm=fm64, jump=jump)
           for name, al in (("kmer", m["al"]), ("fm", fmp["al"]))}
    log(f"int64 FMDevice + jump table (depth {jump.depth}): "
        f"{time.time() - t0:.2f} s")
    t0 = time.time()
    calls, ch_calls, ext_calls, km_calls, fmi_calls = [], [], [], [], []
    res_calls = []
    n0 = build.LAUNCHES["sw_extend"]
    with (recording(calls) as sw_rec, chain_calls.recording(ch_calls),
          extend_calls.recording(ext_calls), kmer_calls.recording(km_calls),
          fm_calls.recording(fmi_calls), resolve_calls.recording(res_calls)):
        long_leg.run_batch(als["kmer"], m["batches"][0])
    counted = build.LAUNCHES["sw_extend"] - n0
    log(f"int64 warm-up batch: {time.time() - t0:.1f} s, {len(calls)} "
        f"sw_extend launches recorded and {sw_rec.closed} with a closed "
        f"gate, {counted} counted")
    if not 0 < len(calls) + sw_rec.closed == counted:
        raise AssertionError("the int64 warm-up batch's sw_extend launches "
                             "were not all recorded")
    total = {k: 0 for k in build.KERNELS}
    want = dict(kmer=(m["cols"], m["sam"]), fm=(fmp["cols"], fmp["sam"]))
    for name, clocked in (("kmer", False), ("fm", True)):
        build.reset_launches()
        with (long_leg.stage_clock() if clocked
              else contextlib.nullcontext()) as clock:
            res = long_leg.run_batch(als[name], batch)
        launches = dict(build.LAUNCHES)
        for k in total:
            total[k] += launches[k]
        sec = res["seconds"]
        rps = BATCH / sum(sec.values())
        sam = se_sam(idx, res["cols"], batch)
        rb = res["out"]["regs"]["rb"].dtype
        same = cols_equal(res["cols"], want[name][0]) and sam == want[name][1]
        log(f"int64 {name}-seeded timed batch: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in sec.items()))
        if clocked:
            log(f"int64 {name}-seeded device step: {stage_line(clock)} "
                f"on {card}")
        log(f"int64 {name}-seeded main path: {rps:.1f} reads/s ({BATCH} x "
            f"{READ_LEN} bp SE) on {card}; launches {launches}; rb {rb}; "
            f"records and SAM equal to the int32 phase's: {same}")
        must_launch(f"int64 {name}-seeded batch", launches,
                    kmer=name == "kmer")
        if rb != np.int64 or not same:
            raise AssertionError(f"int64 {name}-seeded batch: rb {rb}, "
                                 f"equal to int32: {same}")
    t0 = time.perf_counter()
    res = dataclasses.replace(ex["al"], fm=fm64).align_batch(ex["batch"])
    sec = time.perf_counter() - t0
    b = ex["batch"]
    sam = emit_sam(res, idx, texts(b), with_quals(b).qualities, header=False)
    same = ([dataclasses.asdict(r) for r in res]
            == [dataclasses.asdict(r) for r in ex["res"]] and sam == ex["sam"])
    log(f"int64 exact align_batch ({b.n} reads): {sec:.3f} s, "
        f"{b.n / sec:.1f} reads/s on {card}; records and SAM equal to the "
        f"int32 exact phase's: {same}")
    if not same:
        raise AssertionError("int64 exact mode differs from int32")
    main_path_launches(calls, "int64")
    return dict(launches=total, ch_calls=ch_calls, ext_calls=ext_calls,
                km_calls=km_calls, fmi_calls=fmi_calls, res_calls=res_calls)


def api_path(m: dict, card: str, n_reads: int = API_READS) -> dict:
    """``multi_search`` on the main path's ``Aligner`` against an
    ``Aligner`` on the CPU; counts zeroed just before the card's call and
    read just after."""
    reads = m["sims"][1].reads[:n_reads]
    build.reset_launches()
    t0 = time.perf_counter()
    got = multi_search(reads, m["al"])
    dt = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    t0 = time.time()
    want = multi_search(reads, Aligner.build(m["idx"], AlignOptions(),
                                             device="cpu"))
    same = ([dataclasses.asdict(r) for r in got]
            == [dataclasses.asdict(r) for r in want])
    log(f"API multi_search ({n_reads} reads): {dt:.3f} s on {card}, "
        f"{len(got)} results over {len({r.query_id for r in got})} queries; "
        f"launches {launches}; equal to the CPU Aligner's: {same} "
        f"({time.time() - t0:.1f} s)")
    must_launch("API phase", launches)
    if not same:
        raise AssertionError("API phase: the card's SearchResults differ "
                             "from the CPU's")
    return launches


def run_cli(argv: list[str]) -> tuple[int, str, float]:
    """``cli.main(argv)`` in process: its exit code, its standard error
    and its seconds."""
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, err.getvalue(), time.perf_counter() - t0


def check_report(what: str, err: str, stage: str, n: int) -> None:
    """The ``aligned N reads`` line and the ``StageTimer`` report must
    count the ``n`` reads given."""
    aligned = re.findall(r"aligned (\d+) reads", err)
    stages = json.loads(re.findall(r'^\{"stages".*$', err, re.M)[-1])
    log(f"  {what}: {aligned[-1] if aligned else None} reads aligned; "
        f"stages {json.dumps(stages['stages'])}")
    if aligned != [str(n)] or stages["stages"][stage]["items"] != n:
        raise AssertionError(f"CLI {what}: the report does not count the "
                             f"{n} reads given:\n{err[-2000:]}")


def sam_body(path: str) -> str:
    with open(path) as fh:
        return "".join(l for l in fh if not l.startswith("@"))


def cli_path(m: dict, ex: dict, pe: dict, card: str,
             batch_size: int = BATCH, profile_reads: int = PROFILE_READS
             ) -> dict:
    """The CLI's commands on files of the earlier phases' data, each
    checked against that phase's result; returns the launches of every
    command summed."""
    total = {k: 0 for k in build.KERNELS}
    with tempfile.TemporaryDirectory() as d:
        f = {k: os.path.join(d, k) for k in (
            "ref.fa", "se.fq", "prof.fq", "exact.fq", "r1.fq", "r2.fq",
            "idx", "se.sam", "exact.sam", "pe.sam", "prof.sam", "trace",
            "shards")}
        t0 = time.time()
        write_fasta(f["ref.fa"], [("sim", m["genome"])])

        def fastq(path, sim, n=None):
            write_fastq(path, [FastaRecord(a, a, r, QUAL * len(r)) for a, r
                               in list(zip(sim.names, sim.reads))[:n]])

        fastq(f["se.fq"], m["sims"][1])
        fastq(f["prof.fq"], m["sims"][1], profile_reads)
        fastq(f["exact.fq"], ex["sim"])
        fastq(f["r1.fq"], pe["timed"].sims[0])
        fastq(f["r2.fq"], pe["timed"].sims[1])
        log(f"CLI files written: {time.time() - t0:.1f} s")
        n_se, n_ex = len(m["sims"][1].reads), len(ex["sim"].reads)
        n_pe = 2 * len(pe["timed"].sims[0].reads)
        runs = [
            ("index", ["index", f["ref.fa"], "-o", f["idx"]], None, 0),
            ("align", ["align", f["idx"], f["se.fq"], "-o", f["se.sam"],
                       "--batch-size", str(batch_size)], "finalize", n_se),
            ("align --mode exact", ["align", f["idx"], f["exact.fq"], "-o",
                                    f["exact.sam"], "--mode", "exact",
                                    "--batch-size", str(batch_size)],
             "align", n_ex),
            ("align --mate", ["align", f["idx"], f["r1.fq"], "--mate",
                              f["r2.fq"], "-o", f["pe.sam"], "--batch-size",
                              str(n_pe // 2)], "align_pe", n_pe),
            ("align --profile", ["align", f["idx"], f["prof.fq"], "-o",
                                 f["prof.sam"], "--profile", f["trace"],
                                 "--batch-size", str(profile_reads)],
             "finalize", profile_reads),
            ("import", ["import", f["se.fq"], "-o", f["shards"],
                        "--batch-size", str(batch_size)], None, 0),
        ]
        for what, argv, stage, n in runs:
            build.reset_launches()
            rc, err, sec = run_cli(argv)
            launches = dict(build.LAUNCHES)
            for k in total:
                total[k] += launches[k]
            rps = f", {n / sec:.1f} reads/s" if n else ""
            log(f"CLI {what}: exit {rc}, {sec:.2f} s{rps} on {card}; "
                f"launches {launches}")
            if rc != 0:
                raise AssertionError(f"CLI {what} exited {rc}:\n"
                                     f"{err[-2000:]}")
            if stage in ("finalize", "align_pe"):   # full-mode alignment
                must_launch(f"CLI {what}", launches)
            elif stage == "align":                  # exact mode
                must_launch_exact(f"CLI {what}", launches)
            if stage:
                check_report(what, err, stage, n)
        checks = {
            "align = main path": sam_body(f["se.sam"]) == m["sam"],
            "align --mode exact = exact phase":
                sam_body(f["exact.sam"]) == ex["sam"],
            "align --mate = PE phase": sam_body(f["pe.sam"]) == pe["sam"],
        }
        trace = os.path.join(f["trace"], TRACE_FILE)
        with open(trace) as fh:
            text = fh.read()
        checks["trace names sw_kernel"] = "sw_kernel" in text
        log(f"  profile trace: {os.path.getsize(trace)} bytes, "
            f"{text.count('sw_kernel')} mentions of sw_kernel")
        batches = list(pack_reads_from_file(f["se.fq"],
                                            batch_size=batch_size))
        with open(os.path.join(f["shards"], "manifest.json")) as fh:
            shards = sorted(json.load(fh)["shards"])
        ok = len(shards) == len(batches)
        for name, b in zip(shards, batches):
            z = np.load(os.path.join(f["shards"], name))
            ok &= (np.array_equal(z["codes"], b.codes)
                   and np.array_equal(z["lens"], b.lens))
        checks["import = pack_reads"] = ok
        log(f"CLI checks: {checks}")
        if not all(checks.values()):
            raise AssertionError(f"CLI phase failed: {checks}")
    return total


def dist_records(what: str, m: dict, job: dict, want: dict, batch) -> int:
    """A dist job's records and SAM held against ``want`` (an earlier
    phase's ``cols``, ``ovf`` and ``sam``) on every read that overflowed
    in neither run; returns the reads left out."""
    n = batch.n
    both = np.flatnonzero(~job["ovf"] & ~want["ovf"][:n])
    diff = dist_leg.rows_differ(job["cols"], want["cols"], both)
    got_sam = dist_leg.sam_by_read(se_sam(m["idx"], job["cols"], batch))
    want_sam = dist_leg.sam_by_read(want["sam"])
    sam_diff = [i for i in both.tolist()
                if got_sam[batch.names[i]] != want_sam[batch.names[i]]]
    log(f"  {what}: {both.size} of {n} reads overflowed in neither run "
        f"({int(job['ovf'].sum())} here, {int(want['ovf'][:n].sum())} "
        f"there); records differ on {len(diff)}, SAM on {len(sam_diff)}")
    if diff or sam_diff:
        raise AssertionError(f"{what}: records differ on reads "
                             f"{(diff or sam_diff)[:10]}")
    return n - both.size


def dist_line(what: str, timed: dict, clocked: dict, n: int, backend: str,
              ranks: int, card: str) -> None:
    row = dist_leg.summary(timed, clocked, n)
    co = row["collectives"]
    fm = (f"; FM machine {row['fm_steps']} steps (slowest lane), "
          f"{row['fm_ms_per_step']:.3f} ms a step" if "fm_steps" in row
          else "")
    log(f"{what} [{ranks} ranks, backend {backend}] on {card}: "
        f"{row['reads_per_s']:.1f} reads/s ({n} reads, unclocked run); "
        f"device step {row['device_regions']:.3f} s, finalize_columns "
        f"{row['finalize_columns']:.3f} s. Clocked run (a device sync "
        f"around each stage and each collective): device step "
        f"{row['clocked_step']:.3f} s ("
        + ", ".join(f"{k} {v:.3f} s" for k, v in row["step_stages"].items())
        + f"){fm}; collectives {co['calls']} ({co['bytes']} bytes, "
        f"{co['seconds']:.3f} s, {100 * row['collective_share']:.1f}% of "
        f"the clocked step)")


# the index cell's shard check: its kinds of recorded call, each with the
# launches its rows report
SHARD_KINDS = dict(machine=fsc.ENTRIES[:2], walks=fsc.ENTRIES[2:],
                   windows=shard_calls.WINDOWS_LAUNCHES,
                   resolve=shard_calls.RESOLVE_LAUNCHES,
                   search=fsc.SEARCH_ENTRIES)


def shard_line(what: str, rank: int, kind: str, row: dict, card: str
               ) -> None:
    """Log one row of the shard check: its steps, each launch's device ms
    a step and the all_reduce's, each kernel's ms a launch in a CUDA graph
    beside its bound, both routes' seconds, equality and collectives;
    raise where the kernels differ from the twin."""
    names = [n for n in SHARD_KINDS[kind] if n in row]
    shape = (f", W {row['width']}" if "width" in row else "") + (
        f", masked {row['masked']}" if "masked" in row else "")
    log(f"  {what} rank {rank} {kind} ({row['lanes']} lanes{shape}) on "
        f"{card}: {row['steps']} steps, "
        + ", ".join(f"{n} {row[n]['ms']:.4f} ms x {row[n]['launches']}"
                    for n in names)
        + f", all_reduce {row['all_reduce_ms_per_step']:.4f} ms a "
        f"step (CUDA events around each on an idle stream: a "
        f"launch's include its host submit); "
        + "".join(f"{n} {g['ms']:.4f} ms a launch in a CUDA graph "
                  f"({g['lanes']} lanes, bound "
                  f"{bound(g['bytes'], g.get('instr', 0))[0]:.6f} ms); "
                  for n, g in row.get("graph", {}).items())
        + f"kernels {row['kernel_s']:.3f} s, plain "
        f"twin {row['plain_s']:.3f} s ({row['plain_ms_per_step']:.4f}"
        f" ms a whole step outside its all_reduce, runs "
        + ", ".join(f"{t:.4f}" for t in row["plain_step_ms"])
        + " ms, "
        f"{row['plain_reduce_s']:.3f} s in it); equal {row['equal']}"
        f", all_reduce calls {row['steps']} / {row['plain_steps']}, "
        f"bytes {row['bytes']} / {row['plain_bytes']}")
    if (not row["equal"] or row["steps"] != row["plain_steps"]
            or row["bytes"] != row["plain_bytes"]):
        raise AssertionError(f"{what}: a sharded route differs from its "
                             f"plain twin: {row}")


def shard_rows(what: str, res: list, job: int, card: str) -> dict:
    """The index cell's ``shard_check`` job (``tools/shard_calls.py``):
    in every rank, each recorded FM machine call, SA walk, window fetch
    and ``resolve_seeds`` call and the exact reads' backward search on
    the kernels bit-equal to its plain twin under the group, with equal
    all_reduce calls and bytes (``shard_line``); returns rank 0's first
    row of each kind, the median plain walk step (``walk_plain_ms``) and
    the largest error."""
    rows_of = lambda sh: [(kind, row) for kind in SHARD_KINDS
                          for row in (sh[kind] if kind != "search"
                                      else [sh[kind]] if sh[kind] else [])]
    for r in res:
        sh = r["tasks"][0]["jobs"][job]["shard"]
        for kind, row in rows_of(sh):
            shard_line(what, r["rank"], kind, row, card)
        missing = [k for k in SHARD_KINDS if not sh[k]]
        if missing:
            raise AssertionError(f"{what}: nothing recorded of {missing}")
    sh = res[0]["tasks"][0]["jobs"][job]["shard"]
    return dict(machine=sh["machine"][0], walk=sh["walks"][0],
                windows=sh["windows"][0], resolve=sh["resolve"][0],
                search=sh["search"], walk_plain_ms=sh["walk_plain_ms"],
                err=max(row["max_abs_err"] for r in res for _, row in
                        rows_of(r["tasks"][0]["jobs"][job]["shard"])))


def shard_entry(name: str, shard: dict, launches: int) -> dict:
    """The kernels line's entry of index-mesh kernel ``name`` from the
    index cell's check (rank 0's first machine call, walk or window fetch,
    or the search): device ms a launch in a CUDA graph (the call's first
    chunk's lanes, the walk's LF step, the first window fetch's lanes,
    the search's first step), the plain twin's ms a whole step outside
    its all_reduce (the work of both launches of the step: the machine
    call's, the median over the walks' timed runs, the window fetch's
    whole twin, the search's), the bound of the bytes that launch must
    move."""
    kind = {"fm": "machine", "sa": "walk", "windows": "windows",
            "bs": "search"}[name.split("_")[0]]
    row = shard[kind]
    k = row["graph"][name]
    bound_ms, bound_by = bound(k["bytes"], 0)
    return dict(name=name, route="cuda",
                source="bioseqdb_tpu_torch/csrc/"
                       + SHARD_SOURCES.get(name, "fm_shard.cu"),
                replaces=f"bioseqdb_tpu/{SHARD_LINES[name]}",
                launches=launches, max_abs_err=shard["err"], ms=k["ms"],
                plain_ms=(shard["walk_plain_ms"] if kind == "walk"
                          else row["plain_ms_per_step"]), bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def dist_queries(res: list, job: int, ex: dict, card: str,
                 launches: dict) -> None:
    """The index cell's ``queries`` job: in every rank the sharded
    backward search launched ``bs_shard_query`` and ``bs_shard_apply``
    and no other kernel, and its intervals equal the exact phase's
    (``ex["intervals"]``); adds its launches to ``launches``."""
    want = ex["intervals"]
    for r in res:
        j = r["tasks"][0]["jobs"][job]
        ran = {n: j[n] for n in build.PATH_KERNELS if j[n]}
        same = all(np.array_equal(a, b) for a, b in zip(j["intervals"], want))
        if set(ran) != set(build.SEARCH_SHARD_KERNELS) or not same:
            raise AssertionError(f"index mesh's backward search, rank "
                                 f"{r['rank']}: launches {ran}, intervals "
                                 f"equal to the exact phase's: {same}")
        for n, v in ran.items():
            launches[n] += v
    j = res[0]["tasks"][0]["jobs"][job]
    sec = j["seconds"]["backward_search_sharded"]
    co = j["collectives"]
    log(f"  index mesh's backward search ({want[0].size} exact reads) on "
        f"{card}: {sec:.3f} s, {co['calls']} all_reduces ({co['bytes']} "
        f"bytes); launches rank 0 "
        f"{ {n: j[n] for n in build.SEARCH_SHARD_KERNELS} }; intervals "
        f"equal to the exact phase's in every rank")


def dist_path(m: dict, fmp: dict, ex: dict, card: str,
              device_type: str = "cuda", grid_reads: int = DIST_GRID_READS
              ) -> tuple[dict, dict]:
    """The dist phase: ranks spawned through ``dist/launch.py`` running
    ``tools/dist_leg.py``'s ``run_tasks`` on the main path's index. Each
    cell runs its batch clocked (the stage split and the collectives;
    also the ranks' warm-up), then unclocked (reads/s, the records);
    returns the step kernels' launches of the unclocked runs, every rank
    summed (each rank's counts zeroed just before a job and read just
    after; the index cell's sharded search's too), and the index cell's
    shard check (``shard_rows``). Every rank launches ``MESH_BOTH``'s
    kernels in both runs; ``DATA_ONLY``'s too on a data mesh and never
    on an index mesh (its FM machine and SA walk take the shard kernels,
    and its FM seeder has no kmer stage); ``INDEX_ONLY``'s (the FM
    machine's, the walk's and the window fetch's shard kernels) on every
    rank of an index mesh and never on a data mesh; ``NEVER``'s on no
    rank (short reads run no seed-SW, a full step no backward search).
    The index cell then runs the sharded backward search of the exact
    phase's reads (``queries``: only ``bs_shard_query`` and
    ``bs_shard_apply`` launch, and its intervals equal the exact
    phase's) and ``shard_check`` on the whole timed batch with that
    search."""
    idx, batch = m["idx"], m["batches"][1]
    grid = dist_leg.head(batch, grid_reads)
    runs = lambda b: [dict(kind="regions", batch=b, clock=True),
                      dict(kind="columns", batch=b, timed=True)]
    cells = [
        ("data-parallel", (2,), ("data",),
         runs(batch) + [dict(kind="align", batch=ex["batch"], mode="exact")]),
        ("index-sharded", (2,), ("index",),
         runs(batch) + [dict(kind="shard_check", batch=batch,
                             search=(ex["batch"].codes, ex["batch"].lens)),
                        dict(kind="queries", batch=ex["batch"])]),
        ("data x index", (2, 2), ("data", "index"), runs(grid)),
    ]
    launches = {k: 0 for k in build.PATH_KERNELS}
    shard = None
    for what, shape, names, jobs in cells:
        t0 = time.time()
        res, backend = dist_leg.spawn_tasks(
            [dict(cell=(shape, names), idx=idx, jobs=jobs)],
            int(np.prod(shape)), device_type)
        cell = res[0]["tasks"][0]
        log(f"{what} phase: {len(res)} ranks, backend {backend}, "
            f"{time.time() - t0:.1f} s (spawn, Aligner.build "
            f"{json.dumps(cell['build_s'])}, batches)")
        for k, job in enumerate(jobs[:2]):
            per_rank = {n: [r["tasks"][0]["jobs"][k][n] for r in res]
                        for n in launches}
            data = names == ("data",)
            ok = (all(min(per_rank[n]) > 0 for n in MESH_BOTH)
                  and all(min(per_rank[n]) > 0 if data
                          else max(per_rank[n]) == 0 for n in DATA_ONLY)
                  and all(max(per_rank[n]) == 0 if data
                          else min(per_rank[n]) > 0 for n in INDEX_ONLY)
                  and all(max(per_rank[n]) == 0 for n in NEVER))
            if not ok:
                raise AssertionError(f"{what}: launches by rank in job {k}: "
                                     f"{per_rank}")
            if job.get("timed"):
                for n in launches:
                    launches[n] += sum(per_rank[n])
                log(f"  launches by rank: {per_rank}")
        clocked, job = cell["jobs"][:2]
        b = jobs[1]["batch"]
        dist_line(what, job, clocked, b.n, backend, len(res), card)
        if names == ("data",):
            dist_records(what, m, job, m, b)
            al = m["al"]
            got = cell["jobs"][2]["results"]
            eb = ex["batch"]
            sam = emit_sam(got, idx, texts(eb), with_quals(eb).qualities,
                           header=False)
            same = ([dataclasses.asdict(r) for r in got]
                    == [dataclasses.asdict(r) for r in ex["res"]]
                    and sam == ex["sam"])
            sec = cell["jobs"][2]["seconds"]["align_batch"]
            per_rank = {n: [r["tasks"][0]["jobs"][2][n] for r in res]
                        for n in launches}
            log(f"  exact align_batch on the data mesh ({eb.n} reads): "
                f"{sec:.3f} s, {eb.n / sec:.1f} reads/s; records and SAM "
                f"equal to the exact phase's: {same}; launches by rank "
                f"{ {n: per_rank[n] for n in build.EXACT_KERNELS} }")
            if not same:
                raise AssertionError("exact mode on a data mesh differs")
            for rank in range(len(res)):
                must_launch_exact(f"data mesh's exact run, rank {rank}",
                                  {n: v[rank] for n, v in per_rank.items()})
            for n in build.EXACT_KERNELS:
                launches[n] += sum(per_rank[n])
        else:
            dist_records(what, m, job, fmp, b)
            al = fmp["al"]
            if names == ("index",):
                shard = shard_rows(what, res, 2, card)
                dist_queries(res, 3, ex, card, launches)
        sim = m["sims"][1]
        sim = dataclasses.replace(sim, positions=sim.positions[: b.n],
                                  strands=sim.strands[: b.n])
        truth_check(what, al, sim, b, job["cols"], job["n_ovf"])
    return launches, shard


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

    t0 = time.time()
    sw = kernel_phase(dev)
    log(f"SW phase: {time.time() - t0:.1f} s")
    m = main_path(dev, card)
    main_path_launches(m["calls"])
    t0 = time.time()
    pe = pe_path(m, card)
    log(f"PE phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    fm = fm_main_path(m, dev, card)
    log(f"FM-seeded phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    lr = long_path(m, card)
    huge = huge_reads_path(m)
    log(f"long-read phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    fms = fm_machine_phase(m, fm, lr, dev)
    log(f"FM machine phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    ex = exact_path(m, dev, card)
    log(f"exact phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    i64 = int64_path(m, fm, ex, dev, card)
    log(f"int64 phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    chs = chain_phase(m, pe, fm, lr, i64, dev)
    log(f"chain phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    ext = extend_phase(m, pe, fm, lr, i64, dev)
    log(f"extend phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    kms = kmer_phase(m, pe, i64, dev)
    log(f"kmer phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    sws = seedsw_phase(m, lr, huge, dev)
    log(f"seed-SW phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    fmi = fm_index_phase(m, fm, lr, i64, ex, dev)
    log(f"FM-index phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    rsv = resolve_phase(m, pe, fm, lr, i64, dev)
    log(f"resolve phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    api = api_path(m, card)
    log(f"API phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    cl = cli_path(m, ex, pe, card)
    log(f"CLI phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    dl, shard = dist_path(m, fm, ex, card)
    log(f"dist phase: {time.time() - t0:.1f} s")
    runs = (m["launches"], pe["launches"], fm["launches"], lr["launches"],
            ex["launches"], i64["launches"], api, cl, dl)
    kernels = [dict(name="sw_extend", route="cuda",
                    source="bioseqdb_tpu_torch/csrc/sw_extend.cu",
                    replaces="bioseqdb_tpu/kernels/sw_pallas.py:52",
                    launches=sum(x["sw_extend"] for x in runs), **sw),
               dict(name="fm_seed", route="cuda",
                    source="bioseqdb_tpu_torch/csrc/fm_seed.cu",
                    replaces="bioseqdb_tpu/kernels/seed.py:278",
                    launches=sum(x["fm_seed"] for x in runs), **fms),
               dict(name="kmer_seed", route="cuda",
                    source="bioseqdb_tpu_torch/csrc/kmer.cu",
                    replaces="bioseqdb_tpu/kernels/kmer.py:340",
                    launches=sum(x["kmer_seed"] for x in runs), **kms),
               dict(name="seed_sw", route="cuda",
                    source="bioseqdb_tpu_torch/csrc/seedsw.cu",
                    replaces="bioseqdb_tpu/kernels/seedsw.py:99",
                    launches=sum(x["seed_sw"] for x in runs), **sws)]
    kernels += [dict(name=name, route="cuda",
                     source="bioseqdb_tpu_torch/csrc/chain.cu",
                     replaces=f"bioseqdb_tpu/kernels/chain.py:{line}",
                     launches=sum(x[name] for x in runs), **chs[name])
                for name, line in zip(CHAIN_KERNELS, (287, 351))]
    kernels += [dict(name=name, route="cuda",
                     source="bioseqdb_tpu_torch/csrc/extend.cu",
                     replaces=f"bioseqdb_tpu/kernels/extend.py:{line}",
                     launches=sum(x[name] for x in runs), **ext[name])
                for name, line in EXTEND_LINES.items()]
    kernels += [dict(name=name, route="cuda",
                     source="bioseqdb_tpu_torch/csrc/fm.cu",
                     replaces=f"bioseqdb_tpu/kernels/fm.py:{line}",
                     launches=sum(x[name] for x in runs), **fmi[name])
                for name, line in FM_LINES.items()]
    kernels += [dict(name=name, route="cuda",
                     source="bioseqdb_tpu_torch/csrc/resolve.cu",
                     replaces=f"bioseqdb_tpu/kernels/chain.py:{line}",
                     launches=sum(x[name] for x in runs), **rsv[name])
                for name, line in RESOLVE_LINES.items()]
    kernels += [shard_entry(name, shard, sum(x[name] for x in runs))
                for name in (*build.SHARD_KERNELS,
                             *build.WINDOWS_SHARD_KERNELS,
                             *build.SEARCH_SHARD_KERNELS)]
    kernels += probe_path()
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
