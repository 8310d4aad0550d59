"""bioseqdb_tpu_torch — the PyTorch/CUDA port of bioseqdb_tpu.

Runs exact mode and the single-end and paired-end full-alignment paths
(kmer seeding, FM reseed, chaining, banded-SW extension; both mates of a
pair batch in one device step) on a torch device or a mesh of them
(data-parallel, index-sharded or both), behind the same search
API and CLI as the JAX package; the banded SW is a hand-written CUDA
kernel for Hopper (``csrc/sw_extend.cu``). The host half (index build,
finalize, pairing and mate rescue, SAM, the oracle) is the port's own
copy of the JAX package's jax-free modules, under the same relative
paths. Imports torch, never jax, and nothing of ``bioseqdb_tpu``.

Package map (mirrors ``bioseqdb_tpu``):
- ``seq``, ``io``, ``index``  codec, FASTA/read batches, FM-index build
  (native SA-IS), ``index.convert`` for indexes the JAX package built
- ``index.layout``  host device-table layouts + upload
- ``kernels``       FM queries (backward search included), seeding,
  chaining, extension, SW (+ CUDA), the gather/launch probes
  (``kernels.probes``, CUDA)
- ``align``         ``pipeline`` (``Aligner`` in full and exact mode,
  ``align`` / ``align_pairs`` / ``align_pairs_columns``), options,
  finalize, columns, ``paired`` (insert-size statistics, pairing, mate
  rescue)
- ``api``           ``search`` / ``multi_search`` -> ``SearchResult``
- ``cli``           ``index`` / ``align`` / ``import``
  (``python -m bioseqdb_tpu_torch``)
- ``cpu``, ``sam``, ``utils``  host oracle, SAM emission, read simulator,
  ``StageTimer`` and the ``torch.profiler`` trace
- ``dist``          mesh setup over ``torch.distributed``, one process a
  rank (``launch``), data-parallel batches, index sharding
- ``tools``         the probes' microbenchmarks and the paired-end,
  long-read, dist and past-2^31 legs (run on the card)
"""

from bioseqdb_tpu_torch.align.options import AlignOptions, bwa_opts
from bioseqdb_tpu_torch.align.pipeline import (Aligner, align, align_pairs,
                                               align_pairs_columns)
from bioseqdb_tpu_torch.api import SearchResult, multi_search, search
from bioseqdb_tpu_torch.index.builder import (build_index,
                                              build_index_from_fasta)
from bioseqdb_tpu_torch.index.fmindex import FMIndex
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.io.fasta import read_fasta, read_fastq
from bioseqdb_tpu_torch.sam.emit import emit_sam
from bioseqdb_tpu_torch.seq.codec import (ALLOWED_NUCLEOTIDES, Sequence,
                                          nuclseq_in)

__version__ = "0.1.0"

__all__ = [
    "ALLOWED_NUCLEOTIDES",
    "Sequence",
    "nuclseq_in",
    "AlignOptions",
    "bwa_opts",
    "Aligner",
    "align",
    "align_pairs",
    "align_pairs_columns",
    "FMIndex",
    "build_index",
    "build_index_from_fasta",
    "search",
    "multi_search",
    "SearchResult",
    "emit_sam",
    "pack_reads",
    "read_fasta",
    "read_fastq",
    "__version__",
]
