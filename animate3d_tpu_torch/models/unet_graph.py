"""Replay of the MV-VDM UNet's no-grad forward from CUDA graphs.

Sampling and the SDS guidance call the UNet without gradients at a fixed
shape, step after step. Eagerly, the host launches each of the forward's
thousands of kernels from Python, and the card waits on those launches
after every step's sync. A :class:`GraphCache` records the forward once
per call signature and replays it, so a step costs the copies of its
inputs, one graph launch and a copy of the output.

When a forward replays (:func:`engages`): its input is on CUDA, no
gradient is taken, the module is in eval mode and no ring attention is in
scope. Otherwise it runs eagerly, as without this module.

Per call signature (:func:`call_key`), the first call warms up eagerly on
a side stream, the second records the graph into static input and output
buffers and replays it, and each later call copies its inputs into the
static buffers, replays and returns a clone of the static output, which
the caller may keep across later calls. At most :data:`MAX_GRAPHS`
signatures are kept, the least recently used dropped first. The graphs
read the parameters' storages: weights updated in place stay valid, and
weights replaced (a new storage) drop every graph (:func:`weights_key`).

The kernel wrappers in ``ops/`` count a launch in ``_build.LAUNCHES`` only
when Python calls them, which a replay never does: each replay adds the
launches counted over its graph's capture (:func:`launch_changes`), so
the counters read the same work as eager forwards.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from animate3d_tpu_torch.ops import _build, attention, routing
from animate3d_tpu_torch.utils import trace

MAX_GRAPHS = 4


def engages(x: torch.Tensor, training: bool) -> bool:
    """Whether a forward on input ``x`` replays from a graph."""
    return (x.is_cuda and not torch.is_grad_enabled() and not training
            and not attention.ring_in_scope())


def _spec(t: Optional[torch.Tensor]):
    return None if t is None else (tuple(t.shape), t.dtype, t.device)


def call_key(tensors: Sequence[Optional[torch.Tensor]], *flags) -> tuple:
    """A graph's key: each tensor input's shape, dtype and device (None
    where absent), the call's ``flags``, the attention backend in scope,
    whether the ops run their plain versions and whether inference mode is
    on."""
    return (tuple(_spec(t) for t in tensors), *flags, attention.backend_in_scope(),
            routing.plain_in_scope(), torch.is_inference_mode_enabled())


def weights_key(slots: Sequence[Tuple[dict, str]]) -> tuple:
    """The storages of a module's parameters and buffers (``slots``: each
    ``(module._parameters or module._buffers, name)``): a new tensor or
    ``.data`` in any slot changes it, an in-place update does not."""
    return tuple(d[name].data_ptr() for d, name in slots)


def tensor_slots(module: torch.nn.Module) -> Tuple[Tuple[dict, str], ...]:
    """Every parameter and buffer slot of ``module`` and its submodules."""
    return tuple((d, name) for m in module.modules()
                 for d in (m._parameters, m._buffers)
                 for name, t in d.items() if t is not None)


def launch_changes(before: Dict[tuple, int], after: Dict[tuple, int]) -> Dict[tuple, int]:
    """The kernel-launch counters' change from ``before`` to ``after``
    (two snapshots of ``_build.LAUNCHES``, which also holds the tracer's
    span, sync and cast counters), zeros left out: what one replay of a
    graph captured in between launches."""
    return {k: n - before.get(k, 0) for k, n in after.items()
            if k[0] in _build.COUNTERS and n != before.get(k, 0)}


@dataclass
class _Entry:
    inputs: Tuple[Optional[torch.Tensor], ...] = ()
    output: Optional[torch.Tensor] = None
    graph: Optional[object] = None  # torch.cuda.CUDAGraph once captured
    launches: Dict[tuple, int] = field(default_factory=dict)


class GraphCache:
    """A module's graphs by call key, least recently used dropped beyond
    :data:`MAX_GRAPHS`."""

    def __init__(self):
        self._entries: "collections.OrderedDict[tuple, _Entry]" = collections.OrderedDict()
        self._slots: Optional[Tuple[Tuple[dict, str], ...]] = None
        self._weights: Optional[tuple] = None
        self._pool = None
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def clear(self) -> None:
        self._entries.clear()
        self._pool = None

    def weights(self, module: torch.nn.Module) -> tuple:
        """``module``'s :func:`weights_key`, its slots listed at the first
        call."""
        if self._slots is None:
            self._slots = tensor_slots(module)
        return weights_key(self._slots)

    def run(self, key: tuple, weights: tuple, fn: Callable,
            tensors: Tuple[Optional[torch.Tensor], ...]) -> torch.Tensor:
        """``fn(*tensors)`` (the first tensor always given): warmed up,
        captured or replayed by ``key`` (see the module's docstring).
        ``weights`` is the module's
        :func:`weights_key`; another value than the last drops every graph."""
        if weights != self._weights:
            self.clear()
            self._weights = weights
        entry = self._entries.get(key)
        if entry is None:
            self._entries[key] = _Entry()
            while len(self._entries) > MAX_GRAPHS:
                self._entries.popitem(last=False)
            trace.count(("unet_graph", "eager"), 1)
            return self._warm_up(fn, tensors)
        self._entries.move_to_end(key)
        if entry.graph is None:
            trace.count(("unet_graph", "capture"), 1)
            self._capture(entry, fn, tensors)
        else:
            trace.count(("unet_graph", "replay"), 1)
            for static, t in zip(entry.inputs, tensors):
                if static is not None:
                    static.copy_(t)
            entry.graph.replay()
            _build.LAUNCHES.update(entry.launches)
        return entry.output.clone()

    def _stream(self, device: torch.device) -> torch.cuda.Stream:
        s = self._streams.get(device)
        if s is None:
            s = self._streams[device] = torch.cuda.Stream(device=device)
        return s

    def _warm_up(self, fn: Callable, tensors) -> torch.Tensor:
        """The first call of a key, eagerly on the side stream the capture
        will use (lazy set-up, such as a library's workspace for a stream,
        happens outside the capture)."""
        device = tensors[0].device
        side, current = self._stream(device), torch.cuda.current_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = fn(*tensors)
        current.wait_stream(side)
        out.record_stream(current)
        return out

    def _capture(self, entry: _Entry, fn: Callable, tensors) -> None:
        """The second call of a key: record ``fn`` on static copies of its
        inputs, note the launches counted meanwhile, then replay the graph
        once for this call's output."""
        entry.inputs = tuple(None if t is None else t.clone() for t in tensors)
        before = dict(_build.LAUNCHES)
        entry.graph, entry.output = self._record(fn, entry.inputs)
        entry.launches = launch_changes(before, dict(_build.LAUNCHES))
        entry.graph.replay()

    def _record(self, fn: Callable, inputs) -> tuple:
        """(graph, static output) of ``fn(*inputs)`` captured on the side
        stream, in the memory pool this cache's graphs share (they replay
        one at a time, in stream order, and each keeps its output)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream(inputs[0].device),
                              capture_error_mode="thread_local"):
            out = fn(*inputs)
        if self._pool is None:
            self._pool = graph.pool()
        return graph, out
