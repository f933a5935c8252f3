"""Capture-and-replay of CUDA graphs, one per static signature: the port's
counterpart of ``jax.jit``'s cache of one compiled program per static
arguments (``sift_pyocl_tpu/models/vo.py``'s ``vo_step``).

``GraphCache(fn)`` runs ``fn(static, *tensors) -> tensors`` on a
device.  A key (``graph_key``: the device, every input's shape and dtype,
and the hashable static arguments) is captured at its first call and
replayed at every later one:

* first call: the inputs are copied into the key's static input buffer;
  ``fn`` runs once eagerly on the cache's capture stream for the device (a
  warm-up: the kernels' per-stream scratch and counters and their cached
  tables are made there, outside the capture), then ``fn`` is captured with
  ``torch.cuda.graph`` on that stream, its outputs packed into one static
  output buffer inside the graph;
* every call: the inputs are copied into the static input buffer (those
  on the device in one ``torch.cat``, each on the host by its own copy,
  which does not wait for the device), the graph is replayed on the
  current stream, and the static output buffer is cloned: the returned
  tensors are views of that fresh clone, so a later replay never
  overwrites a result the caller holds (JAX's results are immutable).  ``to_host`` brings such views home in one copy.

Nothing falls back to the eager function: a capture or replay that fails
raises.  The cache holds at most ``GraphCache.max_graphs`` keys (least recently used out
first); an evicted graph frees its memory pool.

Every cache captures on one stream a device (``_STREAMS``), so replays of
every graph of every cache on a device (``vo_step``'s, ``SiftPlan``'s, the
SfM registration's) use that stream's kernel scratch (K3's ticket and
epoch words, K7's ticket counters), which the kernels leave zeroed after
each call.  That holds only while the calls on that scratch are
serialised: a capture's warm-up waits for the device, and a replay on
another stream than the last replay of any cache waits for that one
(``_LAST``, under one lock).  Python-side launch counters (``ops.kernels``'
``launch_counts()``) count what ``fn`` launched at the warm-up and the
capture, never at a replay; a replay's launches are read on the card
(``utils/profiling.py::device_profile``).
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Callable, Dict, Hashable, List, Sequence, Tuple

import torch

from ..ops import _build

Spec = Tuple[Tuple[int, ...], torch.dtype]
ALIGN = 16      # byte alignment of every tensor packed in a flat buffer

# shared by every GraphCache: the capture stream of each device, the stream
# of the last replay on it, and the lock that orders captures and replays
_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}
_LAST: Dict[torch.device, torch.cuda.Stream] = {}
_LOCK = threading.RLock()


def graph_key(device, tensors: Sequence[torch.Tensor], static: Hashable) -> tuple:
    """The cache key of a call on `device`: each input's shape and dtype,
    and the static arguments (which must hash)."""
    hash(static)
    return (torch.device(device), tuple((tuple(t.shape), t.dtype) for t in tensors), static)


class _Layout:
    """Tensors of the given (shape, dtype) packed in order into one uint8
    buffer, each at an ALIGN-byte offset."""

    def __init__(self, specs: Sequence[Spec]):
        self.specs = list(specs)
        self.sizes = [math.prod(shape) * dtype.itemsize for shape, dtype in self.specs]
        self.offsets, n = [], 0
        for size in self.sizes:
            self.offsets.append(n)
            n += -(-size // ALIGN) * ALIGN
        self.nbytes = n

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        return [flat[o:o + size].view(dtype).view(shape)
                for o, size, (shape, dtype) in zip(self.offsets, self.sizes, self.specs)]

    def parts(self, tensors: Sequence[torch.Tensor], pad: torch.Tensor) -> List[torch.Tensor]:
        """`tensors` as uint8 pieces, with slices of `pad` between them, for
        one ``torch.cat`` into this layout."""
        out = []
        for t, o, size, nxt in zip(tensors, self.offsets, self.sizes,
                                   self.offsets[1:] + [self.nbytes]):
            out.append(t.contiguous().reshape(-1).view(torch.uint8))
            if nxt - o > size:
                out.append(pad[:nxt - o - size])
        return out

    def fill(self, flat: torch.Tensor, tensors: Sequence[torch.Tensor],
             pad: torch.Tensor) -> None:
        """Copy `tensors` into `flat` at this layout: those up to the first
        that lies elsewhere than `flat` in one ``torch.cat``, each later one
        by its own copy (a host frame, a map, K, random draws), which does
        not wait for the device where the host memory is pageable
        (``_staged``)."""
        k = next((i for i, t in enumerate(tensors) if t.device != flat.device), len(tensors))
        if k:
            end = self.offsets[k] if k < len(tensors) else self.nbytes
            torch.cat(self.parts(tensors[:k], pad), out=flat[:end])
        for t, o, size, (shape, dtype) in zip(tensors[k:], self.offsets[k:], self.sizes[k:],
                                              self.specs[k:]):
            flat[o:o + size].view(dtype).view(shape).copy_(t, non_blocking=_staged(t))


def _staged(t: torch.Tensor) -> bool:
    """Whether a copy of `t` to the device may skip waiting for it: pageable
    host memory, which CUDA stages before the copy returns (a pinned
    tensor could be overwritten before an asynchronous copy reads it)."""
    return t.device.type == "cpu" and not t.is_pinned()


def _specs(tensors: Sequence[torch.Tensor]) -> List[Spec]:
    return [(tuple(t.shape), t.dtype) for t in tensors]


class _Graph:
    """One key's graph: static input buffer, capture, static output buffer."""

    def __init__(self, fn: Callable, static: Hashable, inputs: Sequence[torch.Tensor],
                 device: torch.device, stream: torch.cuda.Stream):
        self.device = device
        self.in_layout = _Layout(_specs(inputs))
        self.in_flat = torch.empty(self.in_layout.nbytes, dtype=torch.uint8, device=device)
        self.in_views = self.in_layout.views(self.in_flat)
        self.pad = torch.zeros(ALIGN, dtype=torch.uint8, device=device)
        self.in_layout.fill(self.in_flat, inputs, self.pad)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            # the warm-up: whatever a kernel makes at its first call on a
            # stream (scratch, counters, tables) is made here, not captured
            warm = tuple(fn(static, *self.in_views))
        self.out_layout = _Layout(_specs(warm))
        del warm
        self.graph = torch.cuda.CUDAGraph()
        with _build.graph_holds() as self.holds, torch.cuda.graph(self.graph, stream=stream):
            outs = tuple(fn(static, *self.in_views))
            if _specs(outs) != self.out_layout.specs:
                raise RuntimeError("the captured call returned other shapes than its warm-up")
            self.out_flat = torch.cat(self.out_layout.parts(outs, self.pad))
            del outs

    def __call__(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        self.in_layout.fill(self.in_flat, inputs, self.pad)
        self.graph.replay()
        return self.out_layout.views(self.out_flat.clone())

    def release(self) -> None:
        torch.cuda.synchronize(self.device)     # no replay of it still runs
        self.graph.reset()
        self.in_flat = self.in_views = self.out_flat = self.holds = None


class GraphCache:
    """CUDA graphs of ``fn(static, *tensors) -> sequence of tensors``, one
    per ``graph_key``, at most ``max_graphs`` of them.  ``fn`` must be pure:
    its outputs depend only on its inputs and `static`, and it syncs no
    host."""

    max_graphs = 8

    def __init__(self, fn: Callable):
        self.fn = fn
        self._graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self.captures = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def __call__(self, device, static: Hashable,
                 inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Replay (capturing first, for a new key) on the CUDA `device`;
        each returned tensor is a view of one fresh buffer."""
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        key = graph_key(device, inputs, static)
        with _LOCK:
            graph = self._graphs.get(key)
            if graph is None:
                while len(self._graphs) >= self.max_graphs:
                    self._graphs.popitem(last=False)[1].release()
                # nothing of an earlier replay or call may still run on the
                # scratch the warm-up takes
                torch.cuda.synchronize(device)
                stream = _STREAMS.get(device)
                if stream is None:
                    stream = _STREAMS[device] = torch.cuda.Stream(device)
                graph = _Graph(self.fn, static, inputs, device, stream)
                self._graphs[key] = graph
                self.captures += 1
            else:
                self._graphs.move_to_end(key)
            cur = torch.cuda.current_stream(device)
            last = _LAST.get(device)
            if last is not None and last != cur:
                cur.wait_stream(last)       # the replays share the capture stream's scratch
            _LAST[device] = cur
            return graph(inputs)

    def clear(self) -> None:
        """Drop every graph (the next call of each key captures again)."""
        with _LOCK:
            while self._graphs:
                self._graphs.popitem(last=False)[1].release()


def to_host(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """`tensors` on the host: where all are views of one device buffer (a
    replay's outputs), views of one host copy of it, else each copied on
    its own (an eager call's)."""
    if not tensors or tensors[0].device.type == "cpu":
        return [t.cpu() for t in tensors]
    st = tensors[0].untyped_storage()
    if any(t.untyped_storage().data_ptr() != st.data_ptr() for t in tensors):
        return [t.cpu() for t in tensors]
    host = st.cpu()
    return [torch.empty(0, dtype=t.dtype).set_(host, t.storage_offset(), t.shape, t.stride())
            for t in tensors]
