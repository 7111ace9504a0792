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

The parallel steps (parallel/) are compiled the same way, their NCCL
collectives captured into the graph (collectives=True: the capture mode of
_capture; parallel/dist.py says what keeps a collective capturable).

A replay's aux values are the graph's static outputs: a call returns
clones, so the aux of step i survives replay i + 1. The kernels' launches
recorded during capture (kernels/_build.py) are counted again at every
replay. A capture or replay that fails raises; nothing gives way to the
eager body. On a CPU state the body runs eagerly (eager_step).

CompiledForward is the forward-only counterpart, for eval and serving
(dssm_tpu's jitted _embed_fwd / _embed_fwd_stacked, _rank_all and
_topk_all): a no-grad function as a replayed CUDA graph a key, at most
GRAPH_CACHE_SIZE graphs (the lru_cache(maxsize=32) of _embed_fwd). As a jit
reads device arrays in place, the graph reads the parameters and every
input tensor already on the card where they lie, keyed on their address,
shape, dtype and stride; a host tensor or a wire block is copied into a
static buffer keyed on its position, shape and dtype or layout, one
buffer a key shared by the graphs that read it. The key also holds the
static arguments. The two share the capture mechanics (_warm, _capture).
"""

from __future__ import annotations

import collections
import functools
import weakref
from typing import (Any, Callable, Dict, Iterator, NamedTuple, Optional,
                    Tuple, Union)

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
    elif isinstance(tree, (tuple, list)):
        for v in tree:
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


def _warm(run: Callable[[], Any], dev: torch.device) -> Any:
    """run() once on a side stream, as a capture runs it (a real call: its
    result is the caller's; it also sets up the kernels' attributes and
    cuBLAS's workspaces before the capture)."""
    current = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = run()
    current.wait_stream(side)
    for v in _leaves(out):
        v.record_stream(current)  # read there by the caller
    return out


def _capture(run: Callable[[], Any], pool, collectives: bool = False
             ) -> Tuple[torch.cuda.CUDAGraph, Any, Dict[str, int]]:
    """(graph, its static outputs, the kernels' launches a replay makes) of
    run() captured into `pool`. collectives: run() issues process-group
    collectives; the capture then refuses unsafe calls of this thread only
    (thread_local), since ProcessGroupNCCL's watchdog thread polls the
    events of earlier eager collectives meanwhile, which the default global
    mode counts against the capture."""
    graph = torch.cuda.CUDAGraph()
    _build.captured_launches(reset=True)
    with torch.cuda.graph(graph, pool=pool, capture_error_mode=(
            "thread_local" if collectives else "global")):
        out = run()
    launches = _build.captured_launches(reset=True)
    return graph, out, {k: n for k, n in launches.items() if n}


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
    (bridge.batch_to_torch), which are packed into a block first.
    collectives: the body issues process-group collectives (the parallel
    steps, parallel/), captured into the graph with them (_capture)."""

    def __init__(self, body: Body, multi: bool = False,
                 collectives: bool = False):
        functools.update_wrapper(self, body)
        self.body, self.multi = body, multi
        self.collectives = collectives
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
        steps, aux = _warm(
            lambda: _run(self.body, self.multi, state, wire.fields(block)),
            dev)
        state.host_step += steps  # a real step, whatever the capture does
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph, (_, static_aux), launches = _capture(
            lambda: _run(self.body, self.multi, state, wire.fields(block)),
            self._pool, self.collectives)
        moved = key[1] != tuple(t.data_ptr() for t in state_tensors(state))
        if moved:
            raise RuntimeError(
                f"{self.__qualname__}: the step body put new tensors into "
                "the state; a compiled step updates the state in place")
        self._graphs[key] = _Graph(graph, block, static_aux, steps, launches)
        return state, aux

    @property
    def num_graphs(self) -> int:
        """The graphs captured so far (one a batch signature and state)."""
        return len(self._graphs)

    @property
    def pool_bytes(self) -> int:
        """The device memory the graphs' pool holds (its segments)."""
        return _pool_bytes(self._pool)


# The captured forward graphs a CompiledForward keeps (dssm_tpu's
# lru_cache(maxsize=32) around _embed_fwd): new parameter tensors at every
# eval (a mesh's gathered table, cli/train.py) capture a graph each, and the
# oldest is dropped, its static tensors with it.
GRAPH_CACHE_SIZE = 32

Input = Union[WireBatch, torch.Tensor]


class ForwardKey(NamedTuple):
    static: tuple    # the static arguments, sorted (name, value) pairs
    params: tuple    # every parameter's (address, shape, dtype, stride)
    inputs: tuple    # each input's _input_key


class _Forward(NamedTuple):
    graph: torch.cuda.CUDAGraph
    # the static buffer each input is copied into; None: read in place
    inputs: Tuple[Optional[torch.Tensor], ...]
    out: Any                          # its static outputs
    launches: Dict[str, int]          # the kernels' launches a replay makes


def _tensor_key(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.dtype, t.stride())


def _input_key(x: Input, device: torch.device) -> tuple:
    """A wire block's layout or a host tensor's (shape, dtype): copied into
    a static buffer of that key; a tensor on `device`: read in place, keyed
    as a parameter is."""
    if isinstance(x, WireBatch):
        return ("wire", x.layout)
    if x.device == device:
        return ("in_place",) + _tensor_key(x)
    return ("copied", tuple(x.shape), x.dtype)


def forward_key(params, inputs: Tuple[Input, ...], static: Dict[str, Any],
                device: torch.device) -> ForwardKey:
    """The key a CompiledForward caches a graph on, for a call on
    `device`."""
    return ForwardKey(
        tuple(sorted(static.items())),
        tuple(_tensor_key(t) for t in _leaves(params)),
        tuple(_input_key(x, device) for x in inputs))


def _run_forward(fn: Callable, multi: bool, params, inputs, static):
    """fn once, or (multi) on the views [j] of every [K, ...] input (a
    WireBatch's fields, or a tensor), the outputs stacked [K, ...]."""
    if not multi:
        return fn(params, *inputs, **static)
    k = next(_leaves(list(inputs))).shape[0]
    outs = [fn(params, *({n: v[j] for n, v in x.items()}
                         if isinstance(x, dict) else x[j] for x in inputs),
               **static) for j in range(k)]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(torch.stack(o) for o in zip(*outs))


class CompiledForward:
    """fn(params, *inputs, **static) -> a tensor or a tuple of tensors, run
    without autograd as a replayed CUDA graph on the card (the module
    docstring), eagerly on the CPU.

    params: a tree (dicts, tuples) of tensors the graph reads where they
    lie, e.g. a model's parameters updated in place between calls. inputs:
    WireBatches (fn gets the widened fields of a static block the batch is
    copied into) or tensors (one on the card is read where it lies, as a
    parameter is; fn gets a static tensor of the same shape and dtype that
    any other is copied into). static: hashable keyword arguments of fn,
    part of the key. With multi=True the inputs carry a leading [K] axis
    and a call is K bodies, body j on the views [j] (lax.scan), the outputs
    stacked [K, ...].

    The first call with a key copies its inputs into static buffers, runs
    fn once on a side stream (a real call, whose result it returns) and
    captures fn into a pool this object's graphs share; a later call copies
    its inputs in and replays. Each replay counts its kernels' launches
    (kernels/_build.py). A capture or a replay that fails raises.
    collectives: fn issues process-group collectives (the parallel eval
    forward's model-group sums), captured with it as CompiledStep's.
    """

    def __init__(self, fn: Callable, multi: bool = False,
                 collectives: bool = False):
        functools.update_wrapper(self, fn)
        self.fn, self.multi, self.collectives = fn, multi, collectives
        self._graphs: "collections.OrderedDict[ForwardKey, _Forward]" = (
            collections.OrderedDict())
        # {(position, input key): static buffer}, while a graph that
        # reads it is kept
        self._buffers: "weakref.WeakValueDictionary[tuple, torch.Tensor]" = (
            weakref.WeakValueDictionary())
        self._pool = None
        self.captures = self.replays = 0  # calls that captured / replayed

    def __call__(self, params, *inputs: Input,
                 device: Optional[torch.device] = None, eager: bool = False,
                 **static):
        """The result: on a replay copies of the graph's static outputs, so
        the next replay cannot overwrite it. device: the card's or the CPU
        (default: the first parameter's). eager=True runs fn eagerly on the
        card too (the reference; plain versions, which read values back,
        need it)."""
        if device is None:
            device = next(_leaves(params)).device
        with torch.no_grad():
            if device.type != "cuda" or eager:
                return _run_forward(self.fn, self.multi, params, tuple(
                    x.fields() if isinstance(x, WireBatch) else x.to(device)
                    for x in inputs), static)
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            key = forward_key(params, inputs, static, device)
            g = self._lookup(key)
            if g is None:
                return self._capture(key, params, inputs, static, device)
            self._copy_in(inputs, g.inputs)
            g.graph.replay()
        self.replays += 1
        _build.add_launches(g.launches)
        if isinstance(g.out, torch.Tensor):
            return g.out.clone()
        return tuple(v.clone() for v in g.out)

    @staticmethod
    def _copy_in(inputs, buffers) -> None:
        for x, buf in zip(inputs, buffers):
            if isinstance(x, WireBatch):
                x.copy_to(buf)
            elif buf is not None:
                buf.copy_(x, non_blocking=True)

    def _buffer(self, pos: int, ikey: tuple, x: Input, dev
                ) -> Optional[torch.Tensor]:
        """The static buffer of input `pos` of key `ikey` (None: read in
        place)."""
        if ikey[0] == "in_place":
            return None
        buf = self._buffers.get((pos, ikey))
        if buf is None:
            buf = (torch.empty((x.nbytes,), dtype=torch.uint8, device=dev)
                   if isinstance(x, WireBatch)
                   else torch.empty(x.shape, dtype=x.dtype, device=dev))
            self._buffers[pos, ikey] = buf
        return buf

    def _capture(self, key: ForwardKey, params, inputs, static, dev):
        buffers = tuple(self._buffer(i, k, x, dev)
                        for i, (k, x) in enumerate(zip(key.inputs, inputs)))
        self._copy_in(inputs, buffers)

        def run():  # a wire block is widened inside the graph
            views = tuple(x if buf is None
                          else x.fields(buf) if isinstance(x, WireBatch)
                          else buf for x, buf in zip(inputs, buffers))
            return _run_forward(self.fn, self.multi, params, views, static)

        out = _warm(run, dev)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph, static_out, launches = _capture(run, self._pool,
                                               self.collectives)
        self.captures += 1
        self._store(key, _Forward(graph, buffers, static_out, launches))
        return out

    def _lookup(self, key: ForwardKey) -> Optional[_Forward]:
        """The graph of `key`, now the most recently used, or None."""
        g = self._graphs.get(key)
        if g is not None:
            self._graphs.move_to_end(key)
        return g

    def _store(self, key: ForwardKey, g: _Forward) -> None:
        """Keep `g`, dropping the least recently used beyond
        GRAPH_CACHE_SIZE."""
        self._graphs[key] = g
        while len(self._graphs) > GRAPH_CACHE_SIZE:
            self._graphs.popitem(last=False)

    def clear(self) -> None:
        """Drop every graph, with its static tensors. The next capture takes
        a new pool: a pool whose graphs are all gone is released only once
        its last block is freed, and a block made in a capture can outlive
        its graph (a workspace a library caches for the capture stream), so
        the old pool cannot take a capture again."""
        self._graphs.clear()
        self._pool = None

    @property
    def num_graphs(self) -> int:
        """The graphs held (at most GRAPH_CACHE_SIZE)."""
        return len(self._graphs)

    @property
    def buffer_bytes(self) -> int:
        """The device memory of the static input buffers the graphs hold
        (outside the pool)."""
        return sum(b.numel() * b.element_size()
                   for b in self._buffers.values())

    @property
    def pool_bytes(self) -> int:
        """The device memory the graphs' pool holds (its segments)."""
        return _pool_bytes(self._pool)


def _pool_bytes(pool) -> int:
    """The device memory of a graph pool's segments (0 for no pool)."""
    if pool is None:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))
