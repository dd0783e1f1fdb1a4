"""
The port's own spans in a traced run (--trace 1).

The port records spans and per-export counters in a session of
shaderflow_tpu_torch.tracing, held open over the window only (the
warm-up export stays out). While the device stretch's profiler runs, each
span also opens a record_function range named "sf.<name>".

The harness knows nothing of this module: the metric files that read the
port's spans give `window_session()` as their SPANS. The harness gathers
SPANS from a traced run's metric files once, after the warm-up and before
the window (registry.spans, called from cell._run); there
`window_session` opens the session on that run's Trace and has the
stretch's Chrome trace read for its "sf." ranges as well (a profiler
exports its trace once, and DeviceStretch.collect deletes the file). It
wraps no call of the port and opens nothing anywhere else, an untraced
run loads no metric file, and the benchmark's own spans, readers and
breakdown() read what they read without it. After the window the first
of those metrics to be read (`of`) closes the session and:

- `annotations` has read the "sf." ranges from the stretch's trace.
- `attach` puts the session's spans on the trace's clock, by the median
  offset between each profiled span's start and its range's (the k-th
  profiled span of a name and the k-th range of that name form a pair),
  and puts each interval of the stretch in which the device is idle down
  to the innermost span open on the host at that time, or to "outside"
  where the host is in none. The result is `trace.program`, which the
  per-layer metrics that read the port's own spans read.
- `notes` gives the pairs' count, offset and spread (the median absolute
  deviation of the offsets), the idle time a frame by span, each export's
  counters, and the program's span counts and totals beside the
  benchmark's wrappers of the same calls, on standard error.

A checkout whose port has no tracer gets no session: `trace.program` is
then None, and those metrics read nothing.
"""

from __future__ import annotations

import importlib
import json
import statistics
import sys
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from pathlib import Path

PREFIX = "sf."
OUTSIDE = "outside"
# The spans that are an export's fixed costs, paid once an export
FIXED = ("export.setup", "prewarm", "engine.build", "export.drain")
# Program spans that cover the same call as a benchmark wrapper
WRAPPED = ("scene.step", "engine.flush", "fragment", "tail", "engine.preludes", "prewarm")


@dataclass
class Program:
    """What the port recorded over a run's window."""
    spans: list                                        # tracing.Span: start, end in ns
    counters: dict                                     # export id -> {counter: count}
    pairs: int = 0                                     # spans matched to their "sf." range
    offset_us: float = 0.0                             # trace clock - perf_counter, us
    spread_us: float = 0.0                             # median absolute deviation
    idle: dict = field(default_factory=dict)           # innermost span -> idle seconds
    unpaired: dict = field(default_factory=dict)       # name -> (profiled spans, ranges)

    def seconds(self, *names: str) -> float:
        """Host seconds in the spans named `names` (nested ones counted
        once each: give names that do not nest in one another)."""
        return sum(span.end - span.start for span in self.spans
                   if span.name in names and span.end is not None) * 1e-9

    def self_seconds(self) -> dict:
        """name -> host seconds of its spans less what their children
        cover (a span's parent is an index into `spans`)."""
        covered = defaultdict(int)
        for span in self.spans:
            if span.end is not None and span.parent is not None:
                covered[span.parent] += span.end - span.start
        totals = defaultdict(float)
        for index, span in enumerate(self.spans):
            if span.end is not None:
                totals[span.name] += (span.end - span.start - covered.get(index, 0)) * 1e-9
        return dict(totals)

    def total(self, counter: str) -> int:
        return sum(counts.get(counter, 0) for counts in self.counters.values())

    def exports(self) -> int:
        return len(self.counters)


class Session:
    """The port's tracing session, open from construction to close(); none
    where the port has no tracer or a session is open already. `close`
    also undoes what `undo` lists: (owner, attribute, original)."""

    def __init__(self):
        self.undo: list = []
        try:
            tracing = importlib.import_module("shaderflow_tpu_torch.tracing")
            self.manager = tracing.session()
            self.records = self.manager.__enter__()
        except (ModuleNotFoundError, RuntimeError):
            self.manager = self.records = None

    def close(self):
        """-> the records, or None without a tracer."""
        for owner, attribute, original in reversed(self.undo):
            setattr(owner, attribute, original)
        self.undo.clear()
        if self.manager is not None:
            self.manager.__exit__(None, None, None)
            self.manager = None
        return self.records


def _traced_run():
    """The Trace of the traced run whose spans the harness is gathering
    (cell._run inside registry.spans), else None."""
    frame, gathering = sys._getframe(1), False
    while frame is not None:
        name, module = frame.f_code.co_name, frame.f_globals.get("__name__")
        if name == "spans" and module == "portbench.harness.registry":
            gathering = True
        elif name == "_run" and module == "portbench.harness.cell":
            return frame.f_locals.get("trace") if gathering and frame.f_locals.get(
                "traced") else None
        frame = frame.f_back
    return None


def window_session() -> dict:
    """The SPANS of a metric that reads the port's spans: none of the
    benchmark's wrappers ({}). While the harness gathers a traced run's
    spans, before its window, this opens the port's session for the run
    (once a run, on its Trace; see the module note); elsewhere it does
    nothing."""
    trace = _traced_run()
    if trace is not None and "session" not in vars(trace) and "program" not in vars(trace):
        trace.session = open_session(trace)
    return {}


def open_session(trace) -> Session:
    """The port's session, and until it closes the "sf." ranges of the
    Chrome trace that DeviceStretch.collect reads (the harness's
    read_chrome_trace) put on `trace.annotations` as well."""
    session = Session()
    if session.records is not None:
        module = sys.modules[type(trace).__module__]
        original = module.read_chrome_trace

        def read_chrome_trace(path):
            found = original(path)
            trace.annotations = annotations(path)
            return found

        module.read_chrome_trace = read_chrome_trace
        session.undo.append((module, "read_chrome_trace", original))
    return session


def of(trace):
    """trace.program, the session of the run closed and attached at the
    first call after its window; None where no session was opened."""
    session = vars(trace).pop("session", None)
    if session is not None:
        attach(trace, session)
    return getattr(trace, "program", None)


def annotations(path: Path) -> list:
    """The "sf." ranges of a Chrome trace written by torch.profiler:
    [(name without the prefix, start us, end us)], in the order of their
    starts."""
    with open(path) as handle:
        events = json.load(handle)["traceEvents"]
    found = [(event["name"][len(PREFIX):], float(event["ts"]),
              float(event["ts"]) + float(event.get("dur", 0)))
             for event in events
             if event.get("ph") == "X" and event.get("cat") == "user_annotation"
             and str(event.get("name", "")).startswith(PREFIX) and "ts" in event]
    return sorted(found, key=lambda item: item[1])


def clock_pairs(spans: list, ranges: list) -> list:
    """[(span, range)]: per name, the k-th profiled span with the k-th
    range, where a name has as many of each."""
    by_name = defaultdict(list)
    for item in ranges:
        by_name[item[0]].append(item)
    profiled = defaultdict(list)
    for span in spans:
        if span.profiled and span.end is not None:
            profiled[span.name].append(span)
    pairs = []
    for name, items in profiled.items():
        if len(items) == len(by_name.get(name, ())):
            pairs.extend(zip(sorted(items, key=lambda s: s.start), by_name[name]))
    return pairs


def innermost_segments(intervals: list, start: float, end: float) -> list:
    """[(start, end, label)] covering [start, end]: where the host is in
    each of `intervals` ((start, end, label), nested or apart), the label
    of the innermost one open, else OUTSIDE."""
    segments = []
    stack = []          # (end, label) of the open intervals, innermost last
    cursor = start

    def emit(until, label):
        nonlocal cursor
        until = min(max(until, cursor), end)
        if until > cursor:
            segments.append((cursor, until, label))
        cursor = max(cursor, until)

    for begin, finish, label in sorted(intervals, key=lambda item: (item[0], -item[1])):
        while stack and stack[-1][0] <= begin:
            emit(stack[-1][0], stack.pop()[1])
        emit(begin, stack[-1][1] if stack else OUTSIDE)
        if stack:
            finish = min(finish, stack[-1][0])
        stack.append((finish, label))
    while stack:
        emit(stack[-1][0], stack.pop()[1])
    emit(end, OUTSIDE)
    return segments


def idle_intervals(device: list, start: float, end: float) -> list:
    """[(start, end)] of [start, end] in which no device event runs."""
    idle, reach = [], start
    for event in sorted(device, key=lambda e: e.start):
        if event.start > reach:
            idle.append((reach, min(event.start, end)))
        reach = max(reach, event.end)
    if reach < end:
        idle.append((reach, end))
    return [(a, b) for a, b in idle if b > a]


def attribute(idle: list, segments: list) -> dict:
    """label -> seconds of `idle` (us intervals) in each labelled segment."""
    totals = defaultdict(float)
    index = 0
    for begin, finish in idle:
        while index < len(segments) and segments[index][1] <= begin:
            index += 1
        probe = index
        while probe < len(segments) and segments[probe][0] < finish:
            low, high, label = segments[probe]
            overlap = min(high, finish) - max(low, begin)
            if overlap > 0:
                totals[label] += overlap * 1e-6
            probe += 1
    return dict(totals)


def build(records, trace) -> Program:
    """The Program of a session's records against a traced run's Trace."""
    program = Program(spans=list(records.spans), counters=dict(records.counters))
    ranges = getattr(trace, "annotations", None) or []
    pairs = clock_pairs(program.spans, ranges)
    program.pairs = len(pairs)
    profiled = Counter(span.name for span in program.spans
                       if span.profiled and span.end is not None)
    found = Counter(name for name, *_ in ranges)
    program.unpaired = {name: (profiled[name], found[name])
                        for name in sorted(set(profiled) | set(found))
                        if profiled[name] != found[name]}
    if not pairs or not trace.device:
        return program
    offsets = [begin - span.start * 1e-3 for span, (_, begin, _) in pairs]
    program.offset_us = statistics.median(offsets)
    program.spread_us = statistics.median(abs(value - program.offset_us) for value in offsets)
    start, end = trace.stretch
    mapped = [(span.start * 1e-3 + program.offset_us, span.end * 1e-3 + program.offset_us,
               span.name) for span in program.spans if span.end is not None]
    mapped = [item for item in mapped if item[1] > start and item[0] < end]
    program.idle = attribute(idle_intervals(trace.device, start, end),
                             innermost_segments(mapped, start, end))
    return program


def notes(program: Program, trace) -> list:
    """The traced run's notes on the port's spans (see the module note)."""
    frames = program.total("frames")
    lines = [f"program spans: {len(program.spans)} over {program.exports()} exports, "
             f"{frames} frames; clock pairs {program.pairs}, offset "
             f"{program.offset_us:.3f} us, spread (MAD) {program.spread_us:.3f} us"]
    if program.unpaired:
        lines.append("not paired (profiled spans/ranges): " + ", ".join(
            f"{name} {spans}/{ranges}" for name, (spans, ranges) in program.unpaired.items()))
    if program.idle and trace.stretch_frames:
        idle = sum(program.idle.values())
        lines.append(f"stretch idle {idle:.6f} s over {trace.stretch_frames} frames, "
                     "ms a frame by innermost span: " + ", ".join(
                         f"{name} {1e3 * seconds / trace.stretch_frames:.4f} "
                         f"({100 * seconds / idle:.1f} %)"
                         for name, seconds in sorted(program.idle.items(),
                                                     key=lambda kv: -kv[1])))
    if frames:
        lines.append("host self ms a frame by span: " + ", ".join(
            f"{name} {1e3 * seconds / frames:.4f}" for name, seconds in
            sorted(program.self_seconds().items(), key=lambda kv: -kv[1])))
    for number, counts in sorted(program.counters.items()):
        lines.append(f"export {number} counters: " + ", ".join(
            f"{name} {value}" for name, value in counts.items()))
    counts = Counter(span.name for span in program.spans if span.end is not None)
    lines.append("program against wrappers (count, host s): " + ", ".join(
        f"{name} {counts[name]}/{len(trace.host.get(name, ()))} "
        f"{program.seconds(name):.4f}/{trace.host_seconds(name):.4f}"
        for name in WRAPPED if name in trace.host or counts[name]))
    return lines


def attach(trace, session: Session) -> None:
    """Close the session, set trace.program (None without a tracer) and
    print the notes on standard error."""
    records = session.close()
    trace.program = None if records is None else build(records, trace)
    if trace.program is not None:
        for line in notes(trace.program, trace):
            print(line, file=sys.stderr)
