"""Plain retrieval: the rank of each query's own title among all titles,
and the exact top k of a query against an index (f32, TF32 off)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


@torch.no_grad()
def ranks(q: torch.Tensor, d: torch.Tensor, block: int = 2048) -> np.ndarray:
    """[N] int: 1 + the titles other than d[i] that score strictly above
    q[i] . d[i]."""
    out = []
    for lo in range(0, q.shape[0], block):
        s = q[lo:lo + block] @ d.T
        rows = torch.arange(s.shape[0], device=q.device)
        own = s[rows, rows + lo].clone()
        s[rows, rows + lo] = float("-inf")
        out.append((1 + (s > own[:, None]).sum(dim=1)).cpu())
    return torch.cat(out).numpy()


@torch.no_grad()
def top_k(q: torch.Tensor, index: torch.Tensor, k: int, block: int = 512
          ) -> Tuple[np.ndarray, np.ndarray]:
    """(scores [Q, k], ids [Q, k]), scores descending."""
    s_out, i_out = [], []
    for lo in range(0, q.shape[0], block):
        s, i = torch.topk(q[lo:lo + block] @ index.T, k, dim=1)
        s_out.append(s.cpu())
        i_out.append(i.cpu())
    return torch.cat(s_out).numpy(), torch.cat(i_out).numpy()
