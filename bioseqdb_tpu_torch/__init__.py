"""bioseqdb_tpu_torch — the PyTorch/CUDA port of bioseqdb_tpu.

Runs the single-end and paired-end full-alignment paths (kmer seeding,
FM reseed, chaining, banded-SW extension; both mates of a pair batch in
one device step) on a torch device; the banded SW is a hand-written
CUDA kernel for Hopper (``csrc/sw_extend.cu``). The host half (index
build, finalize, pairing and mate rescue, SAM, the oracle) is the port's
own copy of the JAX package's jax-free modules, under the same relative
paths. Imports torch, never jax, and nothing of ``bioseqdb_tpu``.

Package map (mirrors ``bioseqdb_tpu``):
- ``seq``, ``io``, ``index``  codec, FASTA/read batches, FM-index build
  (native SA-IS), ``index.convert`` for indexes the JAX package built
- ``index.layout``  host device-table layouts + upload
- ``kernels``       FM queries, seeding, chaining, extension, SW (+ CUDA),
  the gather/launch probes (``kernels.probes``, CUDA)
- ``align``         ``pipeline`` (``Aligner`` / ``align`` /
  ``align_pairs`` / ``align_pairs_columns``), options, finalize, columns,
  ``paired`` (insert-size statistics, pairing, mate rescue)
- ``cpu``, ``sam``, ``utils``  host oracle, SAM emission, read simulator
- ``tools``         the probes' microbenchmarks and the paired-end leg
  (run on the card)
"""

from bioseqdb_tpu_torch.align.pipeline import (Aligner, align, align_pairs,
                                               align_pairs_columns)

__all__ = ["Aligner", "align", "align_pairs", "align_pairs_columns"]
