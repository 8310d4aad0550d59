"""Carry an index built by the JAX package over to the port.

``fmindex_from_jax`` reads the fields of a ``bioseqdb_tpu`` ``FMIndex``
by attribute and returns the port's own ``FMIndex`` holding the same
arrays (shared, not copied). It imports nothing of ``bioseqdb_tpu``:
any object with those attributes will do.
"""

from __future__ import annotations

import dataclasses

from bioseqdb_tpu_torch.index.fmindex import FMIndex


def fmindex_from_jax(obj) -> FMIndex:
    """The port's ``FMIndex`` with every dataclass field of ``obj``
    (``l_pac``, ``seq_len``, ``primary``, ``L2``, ``blocks``,
    ``sa_sample``, ``sa_bits``, ``pac``, ``occ_majors``, ``sa_majors``,
    ``sa_interval`` and the ``ref_*`` / ``hole_*`` annotations)."""
    return FMIndex(**{f.name: getattr(obj, f.name)
                      for f in dataclasses.fields(FMIndex)})
