"""dssm_tpu_torch's CUDA kernels against their plain PyTorch versions on the
GPU, each alone and through the served model. Marked `cuda`; each test skips
without a card. Imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the gather is a copy (exact); the count lookup and the f32 tower
only sum in another order (rtol 1e-5); the bf16 tower may round one
intermediate to the neighbouring bf16 value (2e-2).
"""

import numpy as np
import pytest
import torch

from dssm_tpu_torch.config import DataConfig, RunConfig, TowerConfig, TrainConfig
from dssm_tpu_torch.data.dedupe import SKIP_SENTINEL_GID
from dssm_tpu_torch.data.toy import make_toy_pairs
from dssm_tpu_torch.kernels import _build
from dssm_tpu_torch.kernels.count import count_lookup, count_lookup_plain
from dssm_tpu_torch.kernels.gather import gather_row_groups, gather_row_groups_plain
from dssm_tpu_torch.kernels.tower import dense_tower, dense_tower_plain
from dssm_tpu_torch.models import base as model_base
from dssm_tpu_torch.serve import build_doc_index

V, H, GROUP, SLOTS = 4096, 128, 8, 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc (the kernels run only there)")
    return torch.device("cuda")


def _ragged(rng, rows, k, u2):
    inv = rng.integers(0, u2, size=(rows, k)).astype(np.int32)
    wgt = rng.integers(1, 4, size=(rows, k)).astype(np.float32)
    nnz = rng.integers(0, k + 1, size=(rows,))
    wgt[np.arange(k)[None, :] >= nnz[:, None]] = 0.0
    inv[np.arange(k)[None, :] >= nnz[:, None]] = -1  # out of range: no-op
    return inv, wgt


@pytest.mark.cuda
def test_gather_kernel_matches_plain(dev):
    rng = np.random.default_rng(21)
    table = torch.from_numpy(rng.normal(size=(V, H)).astype(np.float32)).to(dev)
    gids = np.full((SLOTS,), SKIP_SENTINEL_GID, np.int32)
    gids[:23] = np.sort(rng.choice(V // GROUP, 23, replace=False))
    gids = torch.from_numpy(gids).to(dev)
    # bf16 rows come in groups of 16: ids past V // 16 read as out of range.
    for tbl, group in ((table, GROUP), (table.to(torch.bfloat16), 16)):
        assert torch.equal(gather_row_groups(tbl, gids, group, impl="kernel"),
                           gather_row_groups_plain(tbl, gids, group))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_count_kernel_matches_plain(dev, dtype):
    rng = np.random.default_rng(22)
    c2 = torch.from_numpy(rng.normal(size=(128, 384)).astype(np.float32))
    c2 = c2.to(dev, dtype)
    for rows, k in ((256, 32), (100, 70)):
        inv, wgt = _ragged(rng, rows, k, 128)
        inv, wgt = torch.from_numpy(inv).to(dev), torch.from_numpy(wgt).to(dev)
        got = count_lookup(c2, inv, wgt, impl="kernel")
        want = count_lookup_plain(c2, inv, wgt)
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_tower_kernel_matches_plain(dev, dtype, tol):
    rng = np.random.default_rng(23)
    dims = (40, 64, 30, 32)  # three layers, widths not multiples of 16
    x = torch.from_numpy(rng.uniform(-1, 1, size=(70, dims[0])).astype(
        np.float32)).to(dev, dtype)
    layers = [(torch.from_numpy(rng.normal(size=(dims[i], dims[i + 1]))
                                .astype(np.float32) * 0.2).to(dev, dtype),
               torch.from_numpy(rng.normal(size=(dims[i + 1],))
                                .astype(np.float32) * 0.1).to(dev, dtype))
              for i in range(len(dims) - 1)]
    for act in ("tanh", "relu"):
        for norm in (True, False):
            got = dense_tower(x, layers, act, norm, impl="kernel")
            want = dense_tower_plain(x, layers, act, norm)
            torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.cuda
def test_served_index_kernels_match_plain(dev):
    cfg = RunConfig(
        tower=TowerConfig(vocab_size=V, embed_width=40, hidden_dims=(64,),
                          semantic_dim=32, compute_dtype="bfloat16"),
        data=DataConfig(max_trigrams=16, max_trigrams_query=8,
                        max_unique=512, max_unique_rows=128),
        train=TrainConfig(batch_size=64))
    params = model_base.init_params(cfg.tower, seed=0, device=dev)
    titles = make_toy_pairs(150, 64, 5).titles
    _build.reset_launch_counts()
    got = build_doc_index(params, cfg, titles, 64, impl="auto", device=dev)
    assert all(n == 3 for n in _build.launch_counts().values())  # 3 batches
    want = build_doc_index(params, cfg, titles, 64, impl="plain", device=dev)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
