"""Structured JSONL metrics, one record per log event tagged train / eval /
weights, mirrored to TensorBoard on request; per-weight summaries.

Counterpart of dssm_tpu/io/metrics.py. Where dssm_tpu quietly drops its
TensorBoard summaries when torch.utils.tensorboard cannot be imported, the
port raises, naming the package.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, IO, Optional

import numpy as np
import torch


class MetricsWriter:
    """JSONL metrics (the primary contract) + optional TensorBoard events.

    With tensorboard_dir, each record's `tag` gets a SummaryWriter of its
    own under <tensorboard_dir>/<tag> ("train", "eval", "eval_final",
    "weights"), and its int and float values land there as scalars under
    their own names; lists (the histograms) stay in the JSONL file."""

    def __init__(self, path: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None):
        self._fh: Optional[IO[str]] = None
        self._tb_dir = tensorboard_dir
        self._tb_writers: Dict[str, Any] = {}
        if tensorboard_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise ImportError(
                    "io.tensorboard needs the `tensorboard` package "
                    "(torch.utils.tensorboard could not be imported: "
                    f"{e})") from e
            self._summary_writer = SummaryWriter
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def _tb(self, tag: str):
        if self._tb_dir is None:
            return None
        if tag not in self._tb_writers:
            self._tb_writers[tag] = self._summary_writer(
                os.path.join(self._tb_dir, tag))
        return self._tb_writers[tag]

    def write(self, tag: str, step: int, metrics: Dict[str, Any]) -> None:
        record = {"tag": tag, "step": step, "time": time.time(), **metrics}
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
        tb = self._tb(tag)
        if tb is not None:
            for name, value in metrics.items():
                if isinstance(value, (int, float)):
                    tb.add_scalar(name, value, global_step=step)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        for w in self._tb_writers.values():
            w.close()
        self._tb_writers.clear()


def weight_summaries(params: Dict[str, Dict[str, torch.Tensor]],
                     histogram_bins: int = 0) -> Dict:
    """Per-weight mean / stddev / min / max, keyed <tower>/<leaf>/<stat> in
    sorted order (dssm_tpu's tree order); dssm_tpu's variable_summaries().

    The statistics are jnp's: mean and the population stddev computed in
    f32 and, on a bf16 leaf, rounded to bf16 (the variance first, then its
    square root, as jnp.std rounds them); an int8 leaf's mean and stddev
    are f32, its min and max integers. histogram_bins > 0 adds
    np.histogram of the leaf as f32 on the host under
    <name>/hist_counts and <name>/hist_edges (edges rounded to 6 places).
    """
    out: Dict = {}
    for tower in sorted(params):
        for leaf in sorted(params[tower]):
            name = f"{tower}/{leaf}"
            x = params[tower][leaf].detach()
            x32 = x.float()
            var, mean = torch.var_mean(x32, correction=0)
            if x.is_floating_point() and x.dtype != torch.float32:
                mean, var = mean.to(x.dtype), var.to(x.dtype)
            out[f"{name}/mean"] = float(mean)
            out[f"{name}/stddev"] = float(torch.sqrt(var))
            out[f"{name}/min"] = float(x.min())
            out[f"{name}/max"] = float(x.max())
            if histogram_bins > 0:
                counts, edges = np.histogram(
                    x32.cpu().numpy().ravel(), bins=histogram_bins)
                out[f"{name}/hist_counts"] = counts.tolist()
                out[f"{name}/hist_edges"] = [round(float(e), 6)
                                             for e in edges]
    return out
