"""Process meshes for data-parallel and index-sharded runs.

The port of ``bioseqdb_tpu/dist/mesh.py``. JAX drives a mesh of devices
from one controller; torch runs one process per rank (SPMD), each with
its own device, through ``torch.distributed``:

- ``init_distributed`` starts the default process group (``gloo`` on the
  CPU, or for several ranks on one GPU; ``nccl`` when every rank has a
  GPU of its own);
- ``make_mesh`` is ``init_device_mesh`` with named axes: ``data`` (batch
  rows split across ranks) and ``index`` (the FM tables split by row
  range, ``dist/shard_index.py``). ``mesh.get_group("index")`` stands
  where the JAX code passes ``axis="index"``, and a rank's place on an
  axis (``axis_rank``) where it calls ``jax.lax.axis_index``;
- every rank is given the same global batch, pads it to a multiple of
  the ``data`` size (``pad_batch_rows``), takes its own rows
  (``local_rows``) and gathers the host results of all data ranks back
  into the global batch (``gather_host``).

The JAX module's ``replicated``, ``batch_sharded`` and
``shard_pytree_replicated`` have no counterpart: in SPMD torch a
replicated table is each rank's own copy (the replicated index is each
rank's own ``FMDevice``) and a batch sharded along ``data`` is each
rank's slice of the rows.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "index")


def init_distributed(backend: str, rank: int, world_size: int, store=None,
                     timeout: float = 120.0) -> None:
    """Start the default process group: ``backend`` (``gloo`` or
    ``nccl``), this process's ``rank`` of ``world_size``, a
    ``torch.distributed`` store (None: the ``MASTER_ADDR`` /
    ``MASTER_PORT`` environment), and ``timeout`` seconds for any
    collective, after which it raises instead of waiting on."""
    kw = dict(store=store) if store is not None else {}
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout),
                            **kw)


def rank_device(device_type: str) -> torch.device:
    """This rank's device: the CPU, or GPU ``rank % device_count`` made
    current (several ranks share a GPU when there are fewer GPUs than
    ranks). Raises for ``cuda`` without a GPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"no {device_type} device for this rank")
    dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def make_mesh(shape, names=("data",), device_type: str = "cpu"
              ) -> DeviceMesh:
    """A mesh over the world's ranks (row-major in ``shape``) with the
    named axes (``data``, ``index`` or both). Call after
    ``init_distributed`` and, for ``cuda``, ``rank_device``."""
    names = tuple(names)
    if not set(names) <= set(AXES) or len(set(names)) != len(names):
        raise ValueError(f"mesh axes {names} are not distinct names of "
                         f"{AXES}")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=names)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """Ranks along axis ``name`` (1 when the mesh lacks it)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def axis_rank(mesh: DeviceMesh, name: str) -> int:
    """This rank's place along axis ``name`` (0 when the mesh lacks it)."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(name) if name in names else 0


def pad_batch_rows(n: int, mesh: DeviceMesh) -> int:
    """Rows must divide evenly across the data axis."""
    d = axis_size(mesh, "data")
    return ((n + d - 1) // d) * d


def local_rows(n: int, mesh: DeviceMesh) -> slice:
    """This rank's rows of a batch of ``n`` rows padded by
    ``pad_batch_rows``."""
    per = pad_batch_rows(n, mesh) // axis_size(mesh, "data")
    r = axis_rank(mesh, "data")
    return slice(r * per, (r + 1) * per)


def pad_rows(codes: np.ndarray, lens: np.ndarray, mesh: DeviceMesh
             ) -> tuple[np.ndarray, np.ndarray]:
    """A batch's codes and lengths padded to ``pad_batch_rows`` rows
    with code 4 and length 0 (the JAX ``Aligner._put_batch``)."""
    rows = pad_batch_rows(codes.shape[0], mesh)
    pad = rows - codes.shape[0]
    if pad:
        codes = np.concatenate(
            [codes, np.full((pad, codes.shape[1]), 4, codes.dtype)])
        lens = np.concatenate([lens, np.zeros(pad, lens.dtype)])
    return codes, lens


def _concat(parts):
    if isinstance(parts[0], dict):
        return {k: _concat([p[k] for p in parts]) for k in parts[0]}
    return np.concatenate(parts)


def gather_host(tree, mesh: DeviceMesh):
    """A (nested dict of) host array(s) of this rank's rows,
    concatenated with every data rank's in data-axis order: the global
    batch's. Every rank of the mesh must call it."""
    d = axis_size(mesh, "data")
    if d == 1:
        return tree
    parts = [None] * d
    dist.all_gather_object(parts, tree, group=mesh.get_group("data"))
    return _concat(parts)
