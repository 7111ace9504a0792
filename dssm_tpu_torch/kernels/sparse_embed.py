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
its segment-sum table gradient (embedding_bag_grad_reference). All three are
kernels/embed.py's; embedding_bag returns f32 whatever the table's dtype.
"""

from dssm_tpu_torch.kernels.embed import (  # noqa: F401
    embedding_bag, embedding_bag_grad_plain, embedding_bag_plain)
