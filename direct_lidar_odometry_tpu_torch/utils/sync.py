"""The port's tracing: host reads and every other host wait on the device,
spans at the layer boundaries, and counters.

- **Reads.** Every place where the per-frame step needs a device value on
  the host — a loop exit, a branch — goes through :func:`read`, which
  waits for the device; ``counts["host_reads"]`` counts them. The count
  is what a CUDA graph or a device-side fixed trip would remove later.
- **Waits.** A read is one of three kinds of host wait on the device, each
  a span of kind ``read``, ``event`` (:func:`wait_event`: a CUDA event or
  the whole device) or ``copy`` (:func:`upload`: a blocking copy from
  pageable host memory to a CUDA device, which drains its stream first).
  A wait is attributed to the innermost open span of its thread, its
  site.
- **Spans.** ``with span(name):`` times a layer's call on the host clock
  (``time.perf_counter_ns``); each thread keeps its own stack, so a span
  knows its parent. Per name the module keeps the count, the total and the
  self time: the duration less what child spans (waits included) cover.
- **Counters.** :func:`count` adds to ``counts`` (every counter since
  :func:`reset`).

Spans, waits and counts that end while a ``torch.profiler`` is active are
kept apart (:func:`totals` with ``profiled=True``): the profiler slows the
host several times over. While it is active each span is also appended to
:func:`timeline`, stamped in Unix ns, the clock of the profiler's kineto
events, so the host's spans can be laid over the device's operations.
No span is a profiler annotation: the trace's device timeline stays the
program's own operations.

Spans and counters in the program, and what reads them (the benchmark's
``benchmark/metrics/`` readers through ``benchmark/program_trace.py``):

- ``runner.scan``, ``runner.chunk``, ``runner.prepare``, ``runner.refine``
  (``odometry/runner.py``): ``FrameStats.wall_ms``, the refine log's
  ``wall_ms``, ``runner_ms_per_frame``, ``prep_cpu_ms_per_frame``,
  ``refine_ms_per_frame``;
- ``refine.candidates``, ``refine.register``, ``refine.solve``,
  ``refine.reanchor`` and the counters ``refine.rounds``,
  ``refine.edges_registered``, ``refine.edges_accepted``,
  ``refine.live_keyframes`` (``odometry/loopclosure.refine_and_reanchor``):
  ``refine_rounds_per_frame``, ``loop_edges_per_round``,
  ``loop_register_ms_per_round``, ``posegraph_ms_per_round``,
  ``reanchor_ms_per_round``;
- ``step`` and ``step.preprocess``, ``step.normals``, ``step.s2s_coarse``,
  ``step.s2s``, ``step.submap``, ``step.s2m``, ``step.rescue``,
  ``step.keyframe`` (``odometry/pipeline.py``): ``dispatch_ms_per_frame``,
  ``registration_ms_per_frame``;
- waits: ``host_waits_per_frame``, ``host_wait_ms_per_frame``;
- ``frames`` (steps run), ``frames_prepared``, ``align_iters.<stage>`` and
  ``lm_steps.<stage>`` (``registration/gicp.align``, under the innermost
  span), ``feeder_scans`` (``io/native.ScanFeeder``), ``host_reads``;
- ``gicp_graph.captures``, ``gicp_graph.replays`` (iteration and LM retry
  graphs replayed) and ``gicp_graph.eager_iters`` (GICP iterations on a
  CUDA device issued operation by operation; ``registration/gicp.align``):
  ``gicp_graph_share``;
- ``gicp_trial.kernel`` (LM trials run by kernel K7, launched eagerly or
  replayed in a graph; ``registration/gicp.align``):
  ``lm_trial_kernel_share``;
- ``step_graph.captures``, ``step_graph.replays`` and ``step_graph.eager``
  (the per-frame step's stretches outside GICP captured, replayed from a
  CUDA graph, and run operation by operation on a CUDA device, warm runs
  included; ``utils/graphs.py``): ``step_graph_share``.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

# every counter since reset(), the profiled part included
counts: defaultdict[str, int] = defaultdict(int)


class Entry(NamedTuple):
    """One span of the timeline: its parent's name (None at the top), the
    thread's native id, the frames stepped when it began, start and end in
    Unix ns."""

    name: str
    parent: str | None
    thread: int
    frame: int
    start_ns: int
    end_ns: int


class Totals(NamedTuple):
    """The aggregates of one book: ``spans`` name -> (count, total ns, self
    ns); ``waits`` (kind, site, on the main thread) -> (count, ns);
    ``counts`` name -> n."""

    spans: dict
    waits: dict
    counts: dict


class _Book:
    __slots__ = ("spans", "waits", "counts")

    def __init__(self):
        self.spans: dict[str, list[int]] = {}
        self.waits: dict[tuple, list[int]] = {}
        self.counts: defaultdict[str, int] = defaultdict(int)


_lock = threading.Lock()
_local = threading.local()
_books = (_Book(), _Book())  # outside profiling, while profiling
_timeline: list[Entry] = []


def _unix_offset() -> int:
    return time.time_ns() - time.perf_counter_ns()


_offset = _unix_offset()


def _profiling() -> bool:
    return getattr(_profiler, "_is_profiler_enabled", False)


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        _local.main = threading.current_thread() is threading.main_thread()
        _local.tid = threading.get_native_id()
        return _local.stack


class Span:
    """An open span (``with span(name) as s:``); ``s.ns`` and ``s.ms`` are
    its duration once closed. ``kind`` marks a wait."""

    __slots__ = ("name", "kind", "parent", "frame", "t0", "child_ns", "ns")

    def __init__(self, name: str, kind: str | None = None):
        self.name, self.kind, self.ns = name, kind, 0

    def __enter__(self) -> Span:
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.frame = counts.get("frames", 0)
        self.child_ns = 0
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        ns = self.ns = t1 - self.t0
        _local.stack.pop()
        parent = self.parent
        if parent is not None:
            parent.child_ns += ns
        site = parent.name if parent is not None else None
        on = _profiling()
        book = _books[on]
        with _lock:
            if self.kind is None:
                agg = book.spans.get(self.name)
                if agg is None:
                    agg = book.spans[self.name] = [0, 0, 0]
                agg[0] += 1
                agg[1] += ns
                agg[2] += ns - self.child_ns
            else:
                key = (self.kind, site, _local.main)
                agg = book.waits.get(key)
                if agg is None:
                    agg = book.waits[key] = [0, 0]
                agg[0] += 1
                agg[1] += ns
            if on:
                _timeline.append(Entry(self.name, site, _local.tid, self.frame,
                                       self.t0 + _offset, t1 + _offset))
        return False

    @property
    def ms(self) -> float:
        return self.ns / 1e6


def span(name: str) -> Span:
    """A span named ``name`` around a ``with`` block."""
    return Span(name)


def site() -> str | None:
    """The name of this thread's innermost open span."""
    stack = _stack()
    return stack[-1].name if stack else None


def count(name: str, n: int = 1) -> None:
    on = _profiling()
    with _lock:
        counts[name] += n
        _books[on].counts[name] += n


def read(t: torch.Tensor) -> list | bool | int | float:
    """One host sync: the tensor's values as Python objects (``tolist``)."""
    with Span("wait.read", "read"):
        count("host_reads")
        return t.tolist()


def _copy(data, device, dtype):
    if isinstance(data, torch.Tensor):
        return data.to(device) if dtype is None else data.to(device=device, dtype=dtype)
    return torch.tensor(data, dtype=dtype, device=device)


def upload(data, device, dtype=None) -> torch.Tensor:
    """``data`` (a host tensor, or what ``torch.tensor`` takes) on
    ``device``. To a CUDA device this is a blocking copy from pageable
    memory, which waits for the device's stream to drain: a ``copy``
    wait. To the CPU it is no wait and is not counted."""
    if device is None or torch.device(device).type == "cpu":
        return _copy(data, device, dtype)
    with Span("wait.copy", "copy"):
        return _copy(data, device, dtype)


_constants: dict[tuple, torch.Tensor] = {}


def constant(values: tuple, device, dtype=torch.float32) -> torch.Tensor:
    """The vector ``values`` on ``device``, built there by fills (no copy
    from the host, so no wait) once per (values, device, dtype) and shared:
    callers must not modify it in place. On a CUDA device it has to be
    built outside a graph capture, whose fills would only be recorded."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (values, device, dtype)
    t = _constants.get(key)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"constant {values} first built inside a CUDA graph capture")
        t = torch.zeros(len(values), dtype=dtype, device=device)
        for i, v in enumerate(values):
            if v:
                t[i].fill_(v)
        _constants[key] = t
    return t


def wait_event(event) -> None:
    """Block the host until ``event`` (a ``torch.cuda.Event``, or a CUDA
    ``torch.device`` for all its queued work) has completed: an ``event``
    wait."""
    with Span("wait.event", "event"):
        if isinstance(event, torch.device):
            torch.cuda.synchronize(event)
        else:
            event.synchronize()


def totals(profiled: bool = False) -> Totals:
    """A copy of the aggregates outside profiling, or (``profiled``) of
    those kept apart while a profiler was active."""
    book = _books[profiled]
    with _lock:
        return Totals({k: tuple(v) for k, v in book.spans.items()},
                      {k: tuple(v) for k, v in book.waits.items()}, dict(book.counts))


def timeline() -> list[Entry]:
    """The spans (waits included) that ended while a profiler was active,
    in the order they ended."""
    with _lock:
        return list(_timeline)


def reset() -> None:
    """Clear every counter, aggregate and the timeline."""
    global _offset
    with _lock:
        counts.clear()
        for book in _books:
            book.spans.clear()
            book.waits.clear()
            book.counts.clear()
        _timeline.clear()
        _offset = _unix_offset()
