"""The MLP DSSM (Huang et al., CIKM 2013) in plain float32 PyTorch: the
benchmark's weights, the bag lookup, the towers, the cosine softmax over
in-batch negatives with its gradients, and an SGD step.

One tower config serves both sides (shared weights): a [V, H0] table read
as a bag of trigram rows, then dense layers H0 -> H1 -> ... -> D with the
activation after every layer (the first after the bag and its bias), then
an l2 normalisation. The loss of a batch of B pairs is the mean over
queries of -log softmax_j(gamma * q_i . d_j) at j = i.

Matrix products run in float32 with TF32 off. precision="fp8" is the
control, the towers one precision below the configuration's bf16, as fp8
training runs them: every tower product's operands in float8 e4m3 and the
gradient arriving at its output in float8 e5m2, each scaled per tensor to
its largest magnitude.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

LANE = 128  # the program keeps its table's columns padded to this
EPS = 1e-12
E4M3_MAX, E5M2_MAX = 448.0, 57344.0  # the fp8 formats' largest values
Params = Dict[str, torch.Tensor]


def dims(tower: dict) -> List[int]:
    return [tower["embed_width"], *tower["hidden_dims"],
            tower["semantic_dim"]]


def init_params(tower: dict, seed: int, device) -> Params:
    """The benchmark's fresh weights, in the program's layout: {"W0": the
    [V, H0 padded to 128] table, zero past H0, "b0", "W1", "b1", ...} f32,
    each U(-r, r) with r = sqrt(6 / (fan_in + fan_out)), drawn on `device`
    from one generator in a few large calls."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    sizes = [tower["vocab_size"], *dims(tower)]
    out: Params = {}
    for l in range(len(sizes) - 1):
        nin, nout = sizes[l], sizes[l + 1]
        r = math.sqrt(6.0 / (nin + nout))
        cols = nout + ((-nout) % LANE if l == 0 else 0)
        w = torch.zeros((nin, cols), device=device)
        w[:, :nout].uniform_(-r, r, generator=g)
        out[f"W{l}"] = w
        out[f"b{l}"] = torch.empty((nout,), device=device).uniform_(
            -r, r, generator=g)
    return out


def table_view(params: Params, tower: dict) -> torch.Tensor:
    """The table's [V, H0] f32 columns that hold weights, contiguous."""
    return params["W0"][:, :tower["embed_width"]].float().contiguous()


def bag(table: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor,
        chunk: int = 16384) -> torch.Tensor:
    """[N, H]: sum_k wgt[n, k] * table[idx[n, k]]."""
    out = [F.embedding_bag(idx[i:i + chunk], table, mode="sum",
                           per_sample_weights=wgt[i:i + chunk])
           for i in range(0, idx.shape[0], chunk)]
    return torch.cat(out) if out else table.new_zeros((0, table.shape[1]))


def bag_grad_(g_table: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor,
              g: torch.Tensor, chunk: int = 8192) -> None:
    """g_table[idx[n, k]] += wgt[n, k] * g[n], in place."""
    h = g.shape[1]
    for i in range(0, idx.shape[0], chunk):
        vals = wgt[i:i + chunk, :, None] * g[i:i + chunk, None, :]
        g_table.index_add_(0, idx[i:i + chunk].reshape(-1),
                           vals.reshape(-1, h))


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to an fp8 format at the scale that maps its largest
    magnitude to the format's."""
    amax = x.abs().max().clamp_min(1e-30)
    return (x * (top / amax)).to(dtype).float() * (amax / top)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """An operand of a product in e4m3; its gradient passes through."""
    with torch.no_grad():
        q = _round(x.detach(), torch.float8_e4m3fn, E4M3_MAX)
    return x + (q - x).detach()


class _GradE5M2(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def _matmul(a: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _GradE5M2.apply(_fp8(a) @ _fp8(w))
    return a @ w


def activate(z: torch.Tensor, activation: str) -> torch.Tensor:
    return torch.tanh(z) if activation == "tanh" else torch.clamp_min(z, 0.0)


def tower_from_lookup(params: Params, tower: dict, lookup: torch.Tensor,
                      precision: str = "f32") -> torch.Tensor:
    """[N, H0] bag -> [N, D] unit vectors."""
    act = tower["activation"]
    if precision == "fp8":  # the bag is a product with the table
        lookup = _GradE5M2.apply(_fp8(lookup))
    h = activate(lookup + params["b0"], act)
    l = 1
    while f"W{l}" in params:
        h = activate(_matmul(h, params[f"W{l}"], precision) + params[f"b{l}"],
                     act)
        l += 1
    norm = torch.sqrt(torch.sum(h * h, dim=-1, keepdim=True))
    return h / torch.clamp_min(norm, EPS)


@torch.no_grad()
def embed(params: Params, tower: dict, idx: torch.Tensor, wgt: torch.Tensor,
          precision: str = "f32", chunk: int = 65536,
          table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, D] f32 unit vectors of encoded texts (ids already remapped)."""
    table = table_view(params, tower) if table is None else table
    outs = [tower_from_lookup(params, tower,
                              bag(table, idx[i:i + chunk], wgt[i:i + chunk]),
                              precision)
            for i in range(0, idx.shape[0], chunk)]
    return torch.cat(outs)


@torch.no_grad()
def in_batch_loss_grads(q: torch.Tensor, d: torch.Tensor, gamma: float,
                        block: int = 8192
                        ) -> Tuple[float, torch.Tensor, torch.Tensor]:
    """(loss, dL/dq, dL/dd) of the mean in-batch cosine softmax, in blocks
    of query rows, so that no [B, B] matrix is formed whole."""
    b = q.shape[0]
    lse = torch.empty(b, dtype=torch.float32, device=q.device)
    for i in range(0, b, block):
        lse[i:i + block] = torch.logsumexp(gamma * (q[i:i + block] @ d.T),
                                           dim=1)
    pos = gamma * torch.sum(q * d, dim=1)
    loss = float((lse.double() - pos.double()).mean())
    dq = torch.empty_like(q)
    dd = torch.zeros_like(d)
    for i in range(0, b, block):
        p = torch.exp(gamma * (q[i:i + block] @ d.T) - lse[i:i + block, None])
        dq[i:i + block] = p @ d
        dd += p.T @ q[i:i + block]
    scale = gamma / b
    return loss, scale * (dq - d), scale * (dd - q)


def sgd_step(params: Params, tower: dict, batch: Sequence[torch.Tensor],
             gamma: float, lr: float, precision: str = "f32",
             table: Optional[torch.Tensor] = None
             ) -> Tuple[float, Params]:
    """One SGD step of the whole model on a batch (q_idx, q_wgt, d_idx,
    d_wgt), in place: (the loss before it, the gradient of every leaf,
    "W0" the [V, H0] table's). `table` is the table's [V, H0] f32 view,
    which is updated with W0."""
    q_idx, q_wgt, d_idx, d_wgt = batch
    table = table_view(params, tower) if table is None else table
    with torch.no_grad():
        lq, ld = bag(table, q_idx, q_wgt), bag(table, d_idx, d_wgt)
    dense = {k: v.detach().requires_grad_(True) for k, v in params.items()
             if k != "W0"}
    lq.requires_grad_(True)
    ld.requires_grad_(True)
    with torch.enable_grad():
        q = tower_from_lookup(dense, tower, lq, precision)
        d = tower_from_lookup(dense, tower, ld, precision)
        loss, dq, dd = in_batch_loss_grads(q.detach(), d.detach(), gamma)
        names = list(dense)
        grads = torch.autograd.grad([q, d], [lq, ld] + [dense[k]
                                                         for k in names],
                                    grad_outputs=[dq, dd])
    g_table = torch.zeros_like(table)
    bag_grad_(g_table, q_idx, q_wgt, grads[0])
    bag_grad_(g_table, d_idx, d_wgt, grads[1])
    out = {"W0": g_table, **{k: g for k, g in zip(names, grads[2:])}}
    with torch.no_grad():
        table.sub_(lr * g_table)
        for k in names:
            params[k].sub_(lr * out[k])
    return loss, out
