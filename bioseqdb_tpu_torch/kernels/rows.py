"""Per-lane row reads and writes on (B, N, ...) tables.

The torch counterparts of the JAX package's ``dense.pick_row`` /
``dense.put_row`` (one-hot selects there, because TPU gathers cost per
row; plain indexing here). Indices must be in range."""

from __future__ import annotations

import torch


def pick_row(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """buf[b, idx[b], ...] for a (B, N, ...) table."""
    return buf[torch.arange(buf.shape[0], device=buf.device), idx.long()]


def put_row(buf: torch.Tensor, idx: torch.Tensor, val, do: torch.Tensor
            ) -> torch.Tensor:
    """A copy of ``buf`` with buf[b, idx[b], ...] = val[b, ...] where
    do[b]; ``val`` may be a Python scalar."""
    oh = (torch.arange(buf.shape[1], device=buf.device)[None, :]
          == idx.long()[:, None]) & do[:, None]
    val = torch.as_tensor(val, dtype=buf.dtype, device=buf.device)
    if val.dim():
        val = val[:, None]
    if buf.dim() == 3:
        oh = oh[:, :, None]
    return torch.where(oh, val, buf)


def take(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """col[b, idx[b, j]] for a (B, N) table and (B, J) indices."""
    return torch.gather(col, 1, idx.long())
