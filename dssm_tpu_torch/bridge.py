"""Carry weights, train states and batches across from numpy to the port.

params_from_jax takes dssm_tpu's parameter pytree as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)`` on the JAX side) and returns the port's
parameters with the same keys, dtypes (an f32, bf16 or int8 table; an int8
table with its `<table>_scale`) and padded shapes, for the mlp, cnn and
lstm towers; state_from_jax does the same for a whole TrainState (step,
params, the optax state of the tree its optimizer covers; as JAX hands it
out, or as io/orbax_reader.py reads it from dssm_tpu's checkpoint), and
params_to_numpy is the way back; shard_state cuts a state carried across
whole to one rank of a mesh (its rows of the vocab table and of the table's
optimizer state). batch_to_torch moves a numpy batch from
the loader onto a device, widening the compressed wire fields there as
dssm_tpu's lookup does; given the table's rows it first checks a raw-index
batch's lookups on the host (check_raw_rows), so that the lookup kernel on
the card has no check to read back. batch_to_device stops before the
widening: its WireBatch is the packed block, which a compiled train step
(train/compiled.py) copies into static buffers of the batch's signature
and widens inside its graph (an eval block of K stacked batches too).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from dssm_tpu_torch.config import TowerConfig
from dssm_tpu_torch.device import DeviceLike, as_device
from dssm_tpu_torch.io.orbax_reader import BFloat16Array
from dssm_tpu_torch.models.base import TABLE_KEY, Params, arch_module
from dssm_tpu_torch.train.state import TrainState

# Batch fields that are lookup slots or indices (widened to int32) and
# lookup weights (widened to f32).
_INDEX_SUFFIXES = ("_inv", "_idx", "_uniq", "_sel")
_INDEX_FIELDS = ("uniq", "sel")
# Lookup weights and the sequence towers' word masks (widened to f32).
_F32_SUFFIXES = ("_wgt", "_mask")


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    # A bfloat16 array: ml_dtypes.bfloat16, as JAX hands it out, or its
    # bits as the orbax reader returns them.
    bf16 = isinstance(a, BFloat16Array) or a.dtype.name == "bfloat16"
    a = np.ascontiguousarray(a)
    if bf16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(np_params: Mapping[str, Mapping[str, np.ndarray]],
                    cfg: TowerConfig, device: DeviceLike = "cuda") -> Params:
    """{"shared"|"query"|"doc": {<table>, ...}} numpy -> tensors on
    `device`, checked against the config's keys and padded shapes (mlp: W0,
    b0, W1, ...; cnn: Wc, bc, Ws, bs; lstm: Win, bin, Wx, Wh, bh, Ws, bs)."""
    dev = as_device(device)
    key = TABLE_KEY[cfg.arch]
    want = arch_module(cfg).param_shapes(cfg)
    out: Params = {}
    for tower, tp in np_params.items():
        if tower not in ("shared", "query", "doc"):
            raise KeyError(f"unexpected tower {tower!r}")
        want_t = dict(want)
        if key in tp and np.asarray(tp[key]).dtype == np.int8:
            # An int8 table comes with its per-row scale.
            want_t[f"{key}_scale"] = (cfg.vocab_size, 1)
        if set(tp) != set(want_t):
            raise KeyError(f"tower {tower!r} has keys {sorted(tp)}, "
                           f"expected {sorted(want_t)}")
        out[tower] = {}
        for k, v in tp.items():
            if tuple(v.shape) != want_t[k]:
                raise ValueError(f"{tower}/{k}: shape {tuple(v.shape)}, "
                                 f"expected {want_t[k]}")
            out[tower][k] = _to_tensor(v).to(dev)
    return out


def check_raw_rows(batch: Mapping[str, np.ndarray], vocab_size: int) -> None:
    """Raise IndexError when a live lookup (weight not 0) of a raw-index
    numpy batch names no row of a vocab_size-row table. Dedupe batches are
    not looked at: their slots come from the dedupe. Lookups of weight 0
    read nothing, wherever they point."""
    if "uniq" in batch or "q_uniq" in batch:
        return
    for side in "qd":
        idx, wgt = batch.get(f"{side}_idx"), batch.get(f"{side}_wgt")
        if idx is None or wgt is None:
            continue
        idx = np.asarray(idx)
        bad = (np.asarray(wgt) != 0) & ((idx < 0) | (idx >= vocab_size))
        if bad.any():
            raise IndexError(
                f"{side}_idx: a lookup of nonzero weight names row "
                f"{int(idx[bad].reshape(-1)[0])}, outside the table's "
                f"{vocab_size} rows")


Layout = Tuple[Tuple[str, int, Tuple[int, ...], torch.dtype], ...]


def _layout(fields: Mapping[str, Tuple[Tuple[int, ...], torch.dtype, int]]
            ) -> Tuple[Layout, int]:
    """(key, byte offset, shape, dtype) of each field in one block, at
    16-byte aligned offsets, and the block's bytes."""
    layout, total = [], 0
    for k, (shape, dtype, nbytes) in fields.items():
        layout.append((k, total, tuple(shape), dtype))
        total += -(-nbytes // 16) * 16
    return tuple(layout), max(total, 16)


def widen(fields: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The fields the steps read: index fields (int16 on the compressed
    wire) int32, weights (uint8 counts) and word masks f32."""
    out = {}
    for k, t in fields.items():
        if k in _INDEX_FIELDS or k.endswith(_INDEX_SUFFIXES):
            t = t.to(torch.int32)
        elif k.endswith(_F32_SUFFIXES):
            t = t.to(torch.float32)
        out[k] = t
    return out


class WireBatch:
    """A batch's wire arrays packed into one byte block (`layout`: each
    field's key, 16-byte aligned offset, shape and dtype; the batch's
    signature), bound for `device`. The packed block waits in host memory
    (pinned for a GPU) until `block` moves it, with one copy that does not
    wait for the card, or a compiled step copies it into a static block of
    its own (copy_to). `fields()` are the block's typed views, widened."""

    def __init__(self, layout: Layout, nbytes: int, device: torch.device,
                 host: Optional[torch.Tensor] = None,
                 block: Optional[torch.Tensor] = None):
        self.layout, self.nbytes, self.device = layout, nbytes, device
        self._host, self._block = host, block

    @property
    def block(self) -> torch.Tensor:
        return self.to_device()._block

    def to_device(self) -> "WireBatch":
        """Move the packed block to the device now (a batch made ahead)."""
        if self._block is None:
            self._block = self._host.to(self.device, non_blocking=True)
            self._host = None
        return self

    def copy_to(self, block: torch.Tensor) -> None:
        """The packed block into `block` (of this layout), on the current
        stream, without a wait."""
        src = self._host if self._host is not None else self._block
        block.copy_(src, non_blocking=True)

    def fields(self, block: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        """The widened fields, views of `block` (default: this batch's) as
        far as widening leaves them."""
        block = self.block if block is None else block
        return widen({k: block[off:off + _nbytes(shape, dtype)].view(
            dtype).view(shape) for k, off, shape, dtype in self.layout})


def _nbytes(shape: Tuple[int, ...], dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def batch_to_device(batch: Mapping[str, np.ndarray], device: DeviceLike,
                    vocab_size: Optional[int] = None) -> WireBatch:
    """Numpy batch -> a WireBatch bound for `device`: its arrays packed, as
    they come off the wire, into one host block (pinned for a GPU). With
    vocab_size (the table's rows) a raw-index batch's lookups are checked
    on the host first (check_raw_rows): the train loop and CLI, eval and
    serving pass it."""
    if vocab_size is not None:
        check_raw_rows(batch, vocab_size)
    dev = as_device(device)
    arrays = {k: np.ascontiguousarray(v) for k, v in batch.items()}
    layout, total = _layout({k: (a.shape, _torch_dtype(a), a.nbytes)
                             for k, a in arrays.items()})
    host = torch.empty((total,), dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    buf = host.numpy()
    for (k, off, _, _), a in zip(layout, arrays.values()):
        buf[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    if dev.type == "cpu":
        return WireBatch(layout, total, dev, block=host)
    return WireBatch(layout, total, dev, host=host)


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(a[:0].reshape(-1)).dtype


def pack_fields(fields: Mapping[str, torch.Tensor]) -> WireBatch:
    """A batch of tensors on one device (e.g. batch_to_torch's) as a
    WireBatch on that device: its fields copied into one block."""
    dev = next(iter(fields.values())).device
    layout, total = _layout({k: (tuple(t.shape), t.dtype,
                                 t.numel() * t.element_size())
                             for k, t in fields.items()})
    block = torch.zeros((total,), dtype=torch.uint8, device=dev)
    for k, off, shape, dtype in layout:
        t = fields[k].contiguous().reshape(-1)
        block[off:off + t.numel() * t.element_size()].copy_(
            t.view(torch.uint8))
    return WireBatch(layout, total, dev, block=block)


def batch_to_torch(batch: Mapping[str, np.ndarray], device: DeviceLike,
                   vocab_size: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
    """Numpy batch -> tensors on `device`. Index fields (int16 on the
    compressed wire) become int32; weights (uint8 counts) and word masks
    f32. With vocab_size (the table's rows), a raw-index batch's lookups
    are checked on the host first (check_raw_rows): the train loop and CLI,
    eval and serving pass it. The batch goes as one block (batch_to_device;
    to a GPU through pinned host memory, without a wait for the steps
    queued before it) and is widened there."""
    return batch_to_device(batch, device, vocab_size).fields()


def optax_field(opt_state: Any, name: str) -> Any:
    """The first optax sub-state that has field `name`, e.g. `trace` or
    `mu`: a namedtuple in a tuple chain, as JAX hands it out, or a dict in a
    list, as the orbax reader returns it."""
    if name in getattr(opt_state, "_fields", ()):
        return getattr(opt_state, name)
    if isinstance(opt_state, Mapping) and name in opt_state:
        return opt_state[name]
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = optax_field(sub, name)
            if found is not None:
                return found
    return None


def state_from_jax(step: int, np_params: Mapping, np_opt_state: Any,
                   cfg, device: DeviceLike = "cuda") -> TrainState:
    """dssm_tpu's TrainState as numpy (``jax.tree.map(np.asarray, state)``:
    its step, params and opt_state) -> the port's TrainState on `device`.
    The optax state of sgd is empty, of sgd-with-momentum a trace tree, of
    adam a count and the mu / nu trees, each over the tree the optimizer
    covers: the dense subtree on the sparse path, the whole tree, table
    included, on the dense-table step."""
    dev = as_device(device)
    opt = cfg.train.optimizer
    fields = {"sgd": (), "momentum": ("trace",),
              "adam": ("count", "mu", "nu")}.get(opt)
    if fields is None:
        raise ValueError(f"unknown optimizer {opt!r}")
    found = {f for f in ("trace", "count", "mu", "nu")
             if optax_field(np_opt_state, f) is not None}
    if found != set(fields):
        raise ValueError(
            f"the optimizer state holds {sorted(found) or 'nothing'}, "
            f"train.optimizer={opt!r} needs {list(fields) or 'nothing'}: "
            "pass the --train.optimizer the run was trained with")

    def tree(name):
        return {tower: {k: _to_tensor(np.asanyarray(v)).to(dev)
                        for k, v in tp.items()}
                for tower, tp in optax_field(np_opt_state, name).items()}

    opt_state: Dict[str, Any] = {
        f: int(optax_field(np_opt_state, f)) if f == "count" else tree(f)
        for f in fields}
    return TrainState(step=int(step),
                      params=params_from_jax(np_params, cfg.tower, dev),
                      opt_state=opt_state)


def params_to_numpy(params: Params) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's parameters as numpy arrays: float32 (bf16 widened), an
    int8 table as int8."""
    return {tower: {k: (v.detach() if v.dtype == torch.int8
                        else v.detach().float()).cpu().numpy()
                    for k, v in tp.items()} for tower, tp in params.items()}


def shard_state(state: TrainState, mesh) -> TrainState:
    """This rank's part of a whole TrainState (e.g. state_from_jax's): the
    rows of every vocab table (and of the optimizer state over it) that its
    model coordinate holds (parallel/train_step.py::param_pspec), every
    other tensor whole."""
    from dssm_tpu_torch.parallel.train_step import shard_tree

    return TrainState(step=state.step,
                      params=shard_tree(state.params, mesh),
                      opt_state=shard_tree(state.opt_state, mesh),
                      host_step=state.host_step)
