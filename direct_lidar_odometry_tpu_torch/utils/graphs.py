"""CUDA graphs: the port's captures and their replays.

On a CUDA device two parts of the per-frame step replay captured graphs
instead of issuing their operations one by one: each GICP iteration and
LM retry (``registration/gicp.py``), and each stretch of the step outside
GICP between two host reads (:class:`Stretches`, ``odometry/pipeline.py``).
Both capture on the device's one side stream (:func:`side_stream`), in
thread-local error mode and a private memory pool per graph
(:func:`capture`), after one eager run there that builds what a capture
cannot: K1's library, the cuBLAS handles and workspaces, the constants of
``utils/sync.constant``.

A stretch is a function of tensors (nested in tuples and NamedTuples) and
plain values that reads nothing on the host. :class:`Stretches` runs it
for one owner (a sequence's keyframe ring) and keys its graphs on
everything a capture depends on: the function, the plain values (a value
other than None, a bool, a number or a string by identity, held while the
graph lives), and each tensor's role:

- **resident**: the keyframe ring's and the submap cache's buffers, read
  and written where they are (keyed by address, shape and dtype);
- **chained**: an output of another stretch of the same owner, read where
  its graph left it (keyed by identity);
- **copied**: anything else, copied into the graph's own buffer of the
  same layout before each replay (keyed by shape, strides, offset, dtype
  and device).

A stretch's outputs are its graph's buffers, valid until it runs again;
with ``keep`` they are cloned. The first call of a key is the warm run,
this call's result, and the capture follows it. The graphs of an owner
live as long as its tensor does: a fresh ring (a new runner, a resumed
checkpoint) captures anew and never replays into another ring.

Counters (``utils/sync.py``): ``step_graph.captures``,
``step_graph.replays`` and ``step_graph.eager`` (stretches run operation by
operation on a card, warm runs included).
"""

from __future__ import annotations

import torch
from torch.utils.weak import WeakIdKeyDictionary

from direct_lidar_odometry_tpu_torch.utils import sync

_SIDE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


def side_stream(dev: torch.device) -> torch.cuda.Stream:
    """The one stream a device's captures run on: cuBLAS keeps a workspace
    per stream, which a new stream for each key would add to the memory
    held for the process's life."""
    if dev not in _SIDE_STREAMS:
        _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _SIDE_STREAMS[dev]


def capture(side: torch.cuda.Stream, body, counter: str):
    """(the graph, what ``body`` returned), counted as ``counter``:
    ``torch.cuda.graph``'s capture without its device-wide synchronize and
    cache flush, which would stall the caller's stream and the chunk
    worker's copies; capture errors of this thread only; a private memory
    pool."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = body()
        finally:
            graph.capture_end()
    sync.count(counter)
    return graph, out


def eager(fn, *args, keep: bool = False):
    """A stretch run operation by operation: ``fn(*args)``."""
    return fn(*args)


def eager_on_card(fn, *args, keep: bool = False):
    """:func:`eager`, counted as ``step_graph.eager``: the run of a card
    whose stretches are not graphed."""
    sync.count("step_graph.eager")
    return fn(*args)


_PLAIN = (bool, int, float, str, type(None))


def _walk(tree, leaves: list, key: list, keep_alive: list) -> None:
    """The tensors of ``tree`` in order, and the key of its structure and
    plain values."""
    if isinstance(tree, tuple):
        key.append((type(tree), len(tree)))
        for x in tree:
            _walk(x, leaves, key, keep_alive)
    elif isinstance(tree, torch.Tensor):
        leaves.append(tree)
    elif isinstance(tree, _PLAIN):
        key.append((type(tree), tree))
    else:
        key.append(id(tree))
        keep_alive.append(tree)


def _rebuild(tree, tensors):
    """``tree`` with its tensors taken in order from the iterator ``tensors``."""
    if isinstance(tree, tuple):
        items = [_rebuild(x, tensors) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    return tree


def _tensors(tree) -> list[torch.Tensor]:
    leaves: list = []
    _walk(tree, leaves, [], [])
    return leaves


def _buffer_like(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor of ``t``'s layout: shape, strides and
    storage offset (a reduction may add in another order over another
    layout or alignment)."""
    extent = t.storage_offset() + 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    base = torch.empty(extent if t.numel() else 0, dtype=t.dtype, device=t.device)
    return base.as_strided(t.shape, t.stride(), t.storage_offset() if t.numel() else 0)


class _Graph:
    __slots__ = ("graph", "buffers", "out", "keep_alive")

    def __init__(self, graph, buffers, out, keep_alive):
        self.graph, self.buffers, self.out, self.keep_alive = graph, buffers, out, keep_alive


class _Book:
    """An owner's graphs by key, and its stretches' outputs by identity."""

    __slots__ = ("graphs", "outputs")

    def __init__(self):
        self.graphs: dict[tuple, _Graph] = {}
        self.outputs: dict[int, torch.Tensor] = {}


_BOOKS = WeakIdKeyDictionary()


class Stretches:
    """The stretches of one owner's per-frame step, each replayed from a
    CUDA graph captured on its first call (see the module's docstring).
    ``resident``: the tensors the graphs read and write where they are."""

    __slots__ = ("book", "resident")

    def __init__(self, owner: torch.Tensor, resident: tuple):
        book = _BOOKS.get(owner)
        if book is None:
            book = _BOOKS[owner] = _Book()
        self.book = book
        self.resident = {id(t) for t in resident}

    def __call__(self, fn, *args, keep: bool = False):
        leaves: list = []
        key: list = [fn, keep]
        keep_alive: list = []
        _walk(args, leaves, key, keep_alive)
        outputs, resident = self.book.outputs, self.resident
        for t in leaves:
            if outputs.get(id(t)) is t:
                key.append(("chained", id(t)))
            elif id(t) in resident:
                key.append((t.data_ptr(), t.shape, t.dtype))
            else:
                key.append((t.shape, t.stride(), t.storage_offset(), t.dtype, t.device))
        key = tuple(key)
        run = self.book.graphs.get(key)
        if run is None:
            out = self._capture(key, fn, args, leaves, keep_alive, keep)
        else:
            for buf, t in zip(run.buffers, leaves):
                if buf is not None and buf is not t:
                    buf.copy_(t)
            run.graph.replay()
            sync.count("step_graph.replays")
            out = run.out
        return _rebuild(out, iter([t.clone() for t in _tensors(out)])) if keep else out

    def _capture(self, key, fn, args, leaves, keep_alive, keep):
        """The warm run, this call's result, on the side stream; then the
        capture over the graph's buffers, whose outputs take the warm run's
        values."""
        dev = leaves[0].device
        outputs, resident = self.book.outputs, self.resident
        buffers = [t if outputs.get(id(t)) is t else None if id(t) in resident
                   else _buffer_like(t) for t in leaves]
        static = _rebuild(args, iter(t if b is None else b for t, b in zip(leaves, buffers)))
        current = torch.cuda.current_stream(dev)
        side = side_stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            warm = fn(*args)
        sync.count("step_graph.eager")
        graph, out = capture(side, lambda: fn(*static), "step_graph.captures")
        current.wait_stream(side)
        mine = _tensors(out)
        for t, value in zip(mine, _tensors(warm)):
            t.copy_(value)
        if not keep:
            outputs.update((id(t), t) for t in mine)
        self.book.graphs[key] = _Graph(graph, buffers, out, keep_alive)
        return out
