"""One process per rank, with a deadline.

    results = spawn(fn, world_size, backend, args=(...), timeout_s=300)

Starts ``world_size`` processes with ``torch.multiprocessing.spawn``
(the ``spawn`` start method: each child is a fresh interpreter that
imports only the module of ``fn`` and what it imports). Each child sets
one intra-op thread, joins the default process group through a
``torch.distributed.FileStore`` in a new temporary directory (never a
fixed TCP port, so concurrent runs on one host do not collide), with
``collective_timeout_s`` for every collective, then calls
``fn(rank, world_size, *args)`` and hands its return value (picklable)
back to the parent. ``fn`` must be a module-level function.

A child that raises ends the run: the parent kills the others and
raises with the child's traceback. A run past ``timeout_s`` (a
collective one rank never entered, say) is killed and raises
``TimeoutError``. Nothing is retried.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from bioseqdb_tpu_torch.dist.mesh import init_distributed


def cuda_backend(world_size: int) -> str:
    """The backend for ``world_size`` ranks on this host's GPUs: ``nccl``
    when every rank has a GPU of its own, else ``gloo`` (NCCL refuses two
    ranks on one GPU; gloo's all_reduce, broadcast and object
    collectives take CUDA tensors)."""
    return "nccl" if torch.cuda.device_count() >= world_size else "gloo"


def _child(rank, fn, world_size, backend, tmp, args, collective_timeout_s):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world_size)
    init_distributed(backend, rank, world_size, store=store,
                     timeout=collective_timeout_s)
    try:
        out = fn(rank, world_size, *args)
        with open(os.path.join(tmp, f"result{rank}.pkl.tmp"), "wb") as fh:
            pickle.dump(out, fh)
        os.replace(os.path.join(tmp, f"result{rank}.pkl.tmp"),
                   os.path.join(tmp, f"result{rank}.pkl"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, backend: str = "gloo", args: tuple = (),
          timeout_s: float = 600.0, collective_timeout_s: float = 120.0
          ) -> list:
    """``fn(rank, world_size, *args)`` in ``world_size`` processes joined
    by ``backend``; returns their return values by rank."""
    with tempfile.TemporaryDirectory(prefix="bst_dist_") as tmp:
        ctx = mp.spawn(_child, args=(fn, world_size, backend, tmp, args,
                                     collective_timeout_s),
                       nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.0, min(
                    1.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{world_size} ranks of {fn.__name__} ran past "
                        f"{timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
        out = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"result{rank}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out
