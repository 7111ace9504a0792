"""The compiled train step: the port's counterpart of dssm_tpu's
`jax.jit(step_body, donate_argnums=(0,))` and of its `lax.scan` over K
steps a call (dssm_tpu/train/sparse_update.py, train/loop.py).

A step body (train/sparse_update.py::make_sparse_train_step_body,
train/loop.py::make_dense_train_step_body) takes (state, batch fields),
writes the new state into the state's own tensors (the parameters, the
optimizer state, the device step counter: the donated state) and returns
its aux values. CompiledStep runs a body on a CUDA state as a replayed CUDA
graph:

  - the first call with a batch signature (the packed wire block's keys,
    shapes and dtypes, bridge.WireBatch.layout) and a state copies the
    batch into a static device block of that signature, runs the body on
    it once on a side stream (a real step, whose result is kept; it also
    sets up the kernels' attributes and cuBLAS's workspaces), then captures
    the body on the same block into a CUDA graph. Capture runs nothing, so
    the call moves the state one step, as an eager call does;
  - every later call copies its batch into the static block on the current
    stream and replays the graph: the whole step in one dispatch, widening
    the compressed wire fields included, on the state's own tensors;
  - another signature or another state's tensors captures a graph of its
    own, as jit retraces; a CompiledStep's graphs share one memory pool.

With multi=True a call is K steps (the counterpart of lax.scan): the
batch's fields carry a leading [K] axis, the graph holds K bodies, body j
on the views [j], and the aux values come back stacked [K]. The
stochastic-rounding seeds and adam's bias correction are computed on the
card from the device counters, so each replay, and each body of a replay,
computes its own step's values.

A replay's aux values are the graph's static outputs: a call returns
clones, so the aux of step i survives replay i + 1. The kernels' launches
recorded during capture (kernels/_build.py) are counted again at every
replay. A capture or replay that fails raises; nothing gives way to the
eager body. On a CPU state the body runs eagerly (eager_step).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Iterator, NamedTuple, Tuple, Union

import torch

from dssm_tpu_torch.bridge import WireBatch, pack_fields
from dssm_tpu_torch.kernels import _build
from dssm_tpu_torch.train.state import TrainState

Fields = Dict[str, torch.Tensor]
Batch = Union[WireBatch, Fields]
Body = Callable[[TrainState, Fields], Dict[str, torch.Tensor]]


def _leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)


def state_tensors(state: TrainState) -> Tuple[torch.Tensor, ...]:
    """Every tensor of the state: the step counter, the parameters and the
    optimizer state."""
    return tuple(_leaves({"step": state.step, "params": state.params,
                          "opt": state.opt_state}))


def _fields(batch: Batch) -> Fields:
    return batch.fields() if isinstance(batch, WireBatch) else batch


def _run(body: Body, multi: bool, state: TrainState, fields: Fields
         ) -> Tuple[int, Dict[str, torch.Tensor]]:
    """(steps taken, aux): the body once, or K times on the views [j] of
    [K, ...] fields with the aux stacked."""
    if not multi:
        return 1, {k: v.detach() for k, v in body(state, fields).items()}
    k = next(iter(fields.values())).shape[0]
    auxes = [body(state, {key: v[j] for key, v in fields.items()})
             for j in range(k)]
    return k, {key: torch.stack([a[key].detach() for a in auxes])
               for key in auxes[0]}


def eager_step(body: Body, multi: bool = False) -> Callable:
    """(state, batch) -> (state, aux): the body run eagerly, the state
    updated in place and returned; batch: fields on the state's device, or
    a WireBatch bound for it."""

    def step(state: TrainState, batch: Batch):
        k, aux = _run(body, multi, state, _fields(batch))
        state.host_step += k
        return state, aux

    functools.update_wrapper(step, body)
    return step


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    block: torch.Tensor      # the static batch block the graph reads
    aux: Dict[str, torch.Tensor]  # its static outputs
    steps: int
    launches: Dict[str, int]  # the kernels' launches a replay makes


class CompiledStep:
    """(state, batch) -> (state, aux): the body as a replayed CUDA graph on
    a CUDA state (the module docstring), eagerly on a CPU state. The state
    is updated in place and returned. batch: a WireBatch
    (bridge.batch_to_device) or fields on the state's device
    (bridge.batch_to_torch), which are packed into a block first."""

    def __init__(self, body: Body, multi: bool = False):
        functools.update_wrapper(self, body)
        self.body, self.multi = body, multi
        self._eager = eager_step(body, multi)
        self._graphs: Dict[tuple, _Graph] = {}
        self._pool = None

    def __call__(self, state: TrainState, batch: Batch
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.step.device.type != "cuda":
            return self._eager(state, batch)
        wire = batch if isinstance(batch, WireBatch) else pack_fields(batch)
        key = (wire.layout, tuple(t.data_ptr() for t in state_tensors(state)))
        g = self._graphs.get(key)
        if g is None:
            return self._capture(key, state, wire)
        wire.copy_to(g.block)
        g.graph.replay()
        _build.add_launches(g.launches)
        state.host_step += g.steps
        return state, {k: v.clone() for k, v in g.aux.items()}

    def _capture(self, key: tuple, state: TrainState, wire: WireBatch):
        dev = state.step.device
        block = torch.empty((wire.nbytes,), dtype=torch.uint8, device=dev)
        wire.copy_to(block)
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            steps, aux = _run(self.body, self.multi, state,
                              wire.fields(block))
        current.wait_stream(side)
        for v in aux.values():
            v.record_stream(current)  # read there by the caller
        state.host_step += steps  # a real step, whatever the capture does
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        _build.captured_launches(reset=True)
        with torch.cuda.graph(graph, pool=self._pool):
            _, static_aux = _run(self.body, self.multi, state,
                                 wire.fields(block))
        launches = _build.captured_launches(reset=True)
        moved = key[1] != tuple(t.data_ptr() for t in state_tensors(state))
        if moved:
            raise RuntimeError(
                f"{self.__qualname__}: the step body put new tensors into "
                "the state; a compiled step updates the state in place")
        self._graphs[key] = _Graph(graph, block, static_aux, steps,
                                   {k: n for k, n in launches.items() if n})
        return state, aux

    @property
    def num_graphs(self) -> int:
        """The graphs captured so far (one a batch signature and state)."""
        return len(self._graphs)
