"""Sparse trigram lookup over raw indices: the first tower layer of a batch
without dedupe fields (data.dedup_lookup=False).

The input is the fixed-K encoding (indices[..., K] int32, weights[..., K]
f32, index 0 = padding with weight 0) and the op is a weighted
embedding-sum:

    out[...] = sum_k weights[..., k] * table[indices[..., k]]

Counterpart of dssm_tpu/kernels/sparse_embed.py. There `impl="auto"` takes
XLA's gather for this raw-index bag, a choice measured on a TPU, where the
Pallas kernel pays one DMA descriptor per lookup. On the card a direct
gather-accumulate pays nothing of the kind, so here, as for every wrapper of
the port, "auto" launches the CUDA kernel for a CUDA tensor
(kernels/embed.py) and takes the plain version for a CPU tensor.

embedding_bag_plain is dssm_tpu's embedding_bag_xla; embedding_bag_grad_plain
its segment-sum table gradient (embedding_bag_grad_reference). Both are
kernels/embed.py's; embedding_bag returns f32 whatever the table's dtype.
Inside a sharded context (kernels/sharded_embed.py, installed by the
parallel steps when the table is cut over mp > 1 model ranks) embedding_bag
takes the local partial bag + the sum over the model group.
"""

import torch

from dssm_tpu_torch.kernels import embed, sharded_embed
from dssm_tpu_torch.kernels.embed import (  # noqa: F401
    embedding_bag_grad_plain, embedding_bag_plain)


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor,
                  *, impl: str = "auto") -> torch.Tensor:
    """kernels/embed.py's embedding_bag, or the sharded bag over this
    rank's table shard inside a sharded context."""
    ctx = sharded_embed.current_context()
    if ctx is not None:
        return sharded_embed.embedding_bag_sharded(table, idx, wgt, ctx[0],
                                                   impl=impl)
    return embed.embedding_bag(table, idx, wgt, impl=impl)
