"""
The port's tracer: named host spans inside an export, and the export's
counters, for an operator who wants to know where an export's time goes.

    from shaderflow_tpu_torch import tracing
    with tracing.session() as records:
        scene.main(output="null", ...)
    records.spans                       # Span records, in the order they opened
    records.counters                    # export id -> {counter: count}
    tracing.self_times(records.spans)   # name -> self seconds

Off (no session open) a span site reads one module flag and gets one
shared no-op context: no clock read, no allocation, no profiler range. In
a session a span reads time.perf_counter_ns at its start and end and
records the index of the span open around it (its parent), the export's
id (0, 1, ... in the session: each ShaderScene.main export) and the index
of the batch the export loop is on (None outside the loop; the pipe of a
batch staged earlier carries the batch of the loop turn that delivers it).
Spans are kept in the session's list and handed out when it ends; the
tracer writes no file. Only the thread that opened the session records.
While a torch.profiler session is active each span also opens
record_function("sf.<name>"): it then shows in the profiler's Chrome
trace, on the device trace's clock, with the kernels it launched.

Spans of an export (indentation is nesting):

  export                ShaderScene.main of an export (root)
    export.setup        _setup_run, make_sink, open_bar
    prewarm             _prewarm_modules
    engine.build        RenderEngine.build (first begin_batch, or a stale flush)
    scene.step          ShaderScene.next, a frame
      capture           RenderEngine.capture_frame
    engine.flush        RenderEngine.flush
      flush.pack        stack_captures + stack_streams
      flush.upload      RenderEngine.upload
        staging.wait    StagingPool's wait on its oldest buffer
      engine.preludes   _run_preludes (K2)
      frame             render_frame, a frame (Frag, textures, the zero fill)
        fragment        ShaderProgram.render_layer
        tail            run_tail_final, or the plain final pass
          tail.prepare  tailgen.prepare inside fused_tail_final (K1)
    wire.stage          to_wire (pinned buffer, D2H enqueue)
    export.pipe         ExportingHelper.pipe_batch
      wire.wait         WireBatch.wait
      sink.write        the sink's write_batch, or NullSink's accounting
    export.drain        after the loop: the last pipes, finish, log_stats

Counters of an export (records.counters[export id]): `frames` and
`batches` flushed, and the change over the export of the program's own
counters: `k1.prepares` (tailgen.compiled calls), `k1.misses`
(compiled.builds), `k1.launches` (fused_tail_final, u8 and planes forms),
`k2.launches` (expand_tables), `k3.launches` (escape_iterations and
escape_iterations_sep), `builds` (new build.build_events), and the
fragment's CUDA graph (fraggraph.FragmentGraph): `fragment.calls`
(render_layer calls), `fragment.replays` (calls that replayed the
graph), `fragment.captures` (graphs recorded) and `fragment.refusals`
(captures refused: that build renders eagerly). The k*.launches count
eager launches: kernels a graph launches are counted by its launches,
`fragment.captures + fragment.replays`.

SHADERFLOW_BATCH_TRACE prints its line a batch from these spans (it opens
a session for its export where none is open); examples/torch/
profile_export.py prints its host table from self_times.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Iterator, Optional

import torch
from torch.autograd.profiler import record_function

PREFIX = "sf."

_OFF = contextlib.nullcontext()
_records: Optional["Records"] = None   # the open session's, else None


class Span:
    """One span: name, start and end (perf_counter_ns), the index of its
    parent in the session's list, the export id and the batch index.
    `profiled`: it opened a record_function range."""

    __slots__ = ("name", "start", "end", "parent", "export", "batch", "profiled",
                 "_records", "_range")

    def __init__(self, name: str, records: "Records"):
        self.name, self.start, self.end = name, 0, None
        self.parent = records.stack[-1] if records.stack else None
        self.export, self.batch = records.export, records.batch
        self.profiled = False
        self._records, self._range = records, None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self.end = time.perf_counter_ns()
        self._records.stack.pop()
        self._records = None


class Records:
    """What a session recorded: its spans and each export's counters."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[int, dict[str, int]] = {}
        self.thread = threading.get_ident()
        self.stack: list[int] = []          # indices of the open spans
        self.export: Optional[int] = None   # the export being recorded
        self.batch: Optional[int] = None
        self.batch_first = 0                # index of the batch's first span

    def open(self, name: str) -> Span:
        span = Span(name, self)
        self.stack.append(len(self.spans))
        self.spans.append(span)
        span.start = time.perf_counter_ns()
        if torch.autograd._profiler_enabled():
            span.profiled = True
            span._range = record_function(PREFIX + name)
            span._range.__enter__()
        return span


@contextlib.contextmanager
def session() -> Iterator[Records]:
    """Record spans and counters until the block ends; one session at a
    time."""
    global _records
    if _records is not None:
        raise RuntimeError("a tracing session is already open")
    _records = records = Records()
    try:
        yield records
    finally:
        _records = None


def span(name: str):
    """A context that records span `name` in the open session."""
    records = _records
    if records is None or threading.get_ident() != records.thread:
        return _OFF
    return records.open(name)


def _program_counters() -> dict[str, int]:
    from shaderflow_tpu_torch import build
    from shaderflow_tpu_torch.fraggraph import FragmentGraph as graph
    from shaderflow_tpu_torch.ops import fractal, sampling, tailfuse, tailgen
    tail = tailfuse.fused_tail_final
    return {"k1.prepares": tailgen.compiled.calls, "k1.misses": tailgen.compiled.builds,
            "k1.launches": tail.launches + tail.planes_launches,
            "k2.launches": sampling.expand_tables.launches,
            "k3.launches": fractal.escape_iterations.launches
            + fractal.escape_iterations_sep.launches,
            "builds": len(build.build_events), "fragment.calls": graph.calls,
            "fragment.replays": graph.replays, "fragment.captures": graph.captures,
            "fragment.refusals": graph.refusals}


@contextlib.contextmanager
def export(batch_trace: bool = False) -> Iterator[Optional[int]]:
    """An export's root span and counters -> its id (None with no
    session). `batch_trace` opens a session for the export where none is
    open (SHADERFLOW_BATCH_TRACE)."""
    if batch_trace and _records is None:
        with session(), export() as number:
            yield number
        return
    records = _records
    if records is None or threading.get_ident() != records.thread:
        yield None
        return
    number, outer = len(records.counters), (records.export, records.batch)
    counters = records.counters[number] = {"frames": 0, "batches": 0}
    before = _program_counters()
    records.export, records.batch = number, None
    try:
        with records.open("export"):
            yield number
    finally:
        after = _program_counters()
        counters.update({name: after[name] - before[name] for name in after})
        records.export, records.batch = outer


def batch(index: Optional[int]) -> None:
    """The export loop's batch from here on (None: outside the loop)."""
    records = _records
    if records is not None:
        records.batch = index
        records.batch_first = len(records.spans)


def flushed(frames: int) -> None:
    """A flush of `frames` frames, counted in the export's counters."""
    records = _records
    if records is not None and records.export is not None:
        counters = records.counters[records.export]
        counters["frames"] += frames
        counters["batches"] += 1


def batch_seconds(*names: str) -> dict[str, float]:
    """Seconds in the spans named `names` of the current export's current
    batch (SHADERFLOW_BATCH_TRACE's capture, dispatch and drain)."""
    totals = dict.fromkeys(names, 0.0)
    records = _records
    if records is None:
        return totals
    for item in records.spans[records.batch_first:]:
        if (item.name in totals and item.end is not None and item.export == records.export
                and item.batch == records.batch):
            totals[item.name] += item.seconds
    return totals


def self_times(spans: list[Span]) -> dict[str, float]:
    """name -> seconds of its spans' durations less what their child spans
    cover, summed over a session's list of spans (parents are indices into
    it). Spans still open count nothing."""
    covered: dict[int, int] = defaultdict(int)
    for item in spans:
        if item.end is not None and item.parent is not None:
            covered[item.parent] += item.end - item.start
    totals: dict[str, float] = defaultdict(float)
    for position, item in enumerate(spans):
        if item.end is not None:
            totals[item.name] += (item.end - item.start - covered.get(position, 0)) * 1e-9
    return dict(totals)
