"""bioseqdb_tpu_torch — the PyTorch/CUDA port of bioseqdb_tpu.

Runs the single-end full-alignment path (kmer seeding, FM reseed,
chaining, banded-SW extension) on a torch device; the banded SW is a
hand-written CUDA kernel for Hopper (``csrc/sw_extend.cu``). The host
half (index build, finalize, SAM) is the JAX package's jax-free code,
reused as it is. Imports torch, never jax.

Package map (mirrors ``bioseqdb_tpu``):
- ``index.layout``  host device-table layouts + upload
- ``kernels``       FM queries, seeding, chaining, extension, SW (+ CUDA)
- ``align.pipeline`` ``Aligner`` / ``align``
"""

from bioseqdb_tpu_torch.align.pipeline import Aligner, align

__all__ = ["Aligner", "align"]
