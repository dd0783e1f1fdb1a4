"""
Spans and the device trace of a traced run (--trace 1).

Spans come from the benchmark's own wrappers around calls into the port:
each wrapped call adds its perf_counter interval to the span list of its
label, and opens a torch.profiler.record_function range named
"pb.<label>" so that the kernels it launches can be found in the device
trace. The host spans cover the whole window; the device trace covers a
steady stretch of it: from the third flush of the window for `flushes`
flushes (at least two, about 240 frames), ended by a synchronize so that
every kernel launched in the stretch has run when the profiler stops.

The device trace is torch.profiler's Chrome trace (CUPTI activity), read
back into DeviceEvent records: every kernel, copy and memset with its
device interval, and the innermost "pb." range that was open on the host
when it was launched (matched by the launch's correlation id).
"""

from __future__ import annotations

import bisect
import functools
import json
import math
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

PREFIX = "pb."


@dataclass
class DeviceEvent:
    name: str
    kind: str            # "kernel", "memcpy" or "memset"
    start: float         # microseconds, the trace's clock
    end: float
    span: str | None     # the innermost benchmark span open at the launch
    bytes: int = 0
    direction: str = ""  # memcpy: "DtoH", "HtoD", "DtoD"


@dataclass
class Trace:
    """What the per-layer readers read (portbench/metrics/*.py)."""
    host: dict = field(default_factory=lambda: defaultdict(list))   # label -> [(start, end)]
    device: list = field(default_factory=list)        # DeviceEvent, the stretch
    stretch: tuple = (0.0, 0.0)  # (start, end) of the traced stretch, microseconds
    stretch_frames: int = 0      # frames flushed in the stretch
    frame_bytes: int = 0         # bytes of one u8 output frame
    work: dict = field(default_factory=dict)          # the counting functions' results

    def host_seconds(self, label: str) -> float:
        return sum(end - start for start, end in self.host.get(label, ()))

    def device_seconds(self, span: str = None, kind: str = None, name: str = None,
                       direction: str = None) -> float:
        """Summed device time of the stretch's events, filtered by the span
        they were launched in, their kind, a substring of their name and a
        copy's direction."""
        total = 0.0
        for event in self.device:
            if span is not None and event.span != span:
                continue
            if kind is not None and event.kind != kind:
                continue
            if name is not None and name not in event.name:
                continue
            if direction is not None and event.direction != direction:
                continue
            total += event.end - event.start
        return total * 1e-6

    def busy_seconds(self) -> float:
        """Length of the union of every device interval in the stretch."""
        return union_length([(e.start, e.end) for e in self.device]) * 1e-6

    def window_seconds(self) -> float:
        return (self.stretch[1] - self.stretch[0]) * 1e-6


def union_length(intervals: list) -> float:
    total, reach = 0.0, -math.inf
    for start, end in sorted(intervals):
        if end <= reach:
            continue
        total += end - max(start, reach)
        reach = end
    return total


class Spans:
    """Wrappers around the port's calls. Install them with `wrap`, take
    them out with `restore` (the original attributes come back)."""

    def __init__(self, trace: Trace, record_function):
        self.trace = trace
        self.record_function = record_function
        self._restore: list = []

    def wrap(self, owner, attribute: str, label: str) -> None:
        original = getattr(owner, attribute)
        spans = self

        @functools.wraps(original)
        def wrapper(*args, **kwargs):
            started = time.perf_counter()
            try:
                with spans.record_function(PREFIX + label):
                    return original(*args, **kwargs)
            finally:
                spans.trace.host[label].append((started, time.perf_counter()))

        setattr(owner, attribute, wrapper)
        self._restore.append((owner, attribute, original))

    def restore(self) -> None:
        for owner, attribute, original in reversed(self._restore):
            setattr(owner, attribute, original)
        self._restore.clear()


def read_chrome_trace(path: Path) -> tuple:
    """(device events, (start, end) of every event of the trace, host and
    device) from a Chrome trace written by torch.profiler."""
    with open(path) as handle:
        events = json.load(handle)["traceEvents"]
    annotations = defaultdict(list)         # tid -> [(start, end, label)]
    launches = {}                           # correlation -> (tid, ts)
    device = []
    first, last = math.inf, -math.inf
    for event in events:
        if event.get("ph") != "X" or "ts" not in event:
            continue
        first = min(first, float(event["ts"]))
        last = max(last, float(event["ts"]) + float(event.get("dur", 0)))
        category = event.get("cat", "")
        name = event.get("name", "")
        args = event.get("args") or {}
        if category == "user_annotation" and name.startswith(PREFIX):
            annotations[event.get("tid")].append(
                (float(event["ts"]), float(event["ts"]) + float(event.get("dur", 0)),
                 name[len(PREFIX):]))
        elif category in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (event.get("tid"), float(event["ts"]))
        elif category in ("kernel", "gpu_memcpy", "gpu_memset"):
            kind = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}[category]
            direction = ""
            if kind == "memcpy":
                for tag in ("DtoH", "HtoD", "DtoD", "HtoH"):
                    if tag in name:
                        direction = tag
            device.append((name, kind, float(event["ts"]),
                           float(event["ts"]) + float(event.get("dur", 0)),
                           args.get("correlation"), int(args.get("bytes", 0) or 0), direction))
    for spans in annotations.values():
        spans.sort()
    starts = {tid: [begin for begin, _, _ in spans] for tid, spans in annotations.items()}
    out = []
    for name, kind, start, end, correlation, nbytes, direction in device:
        span = None
        launch = launches.get(correlation)
        if launch is not None:
            tid, ts = launch
            spans = annotations.get(tid, ())
            # Ranges of one thread nest: the innermost open at `ts` is the
            # latest-starting one that has not ended
            index = bisect.bisect_right(starts.get(tid, ()), ts) - 1
            while index >= 0:
                begin, finish, label = spans[index]
                if finish >= ts:
                    span = label
                    break
                index -= 1
        out.append(DeviceEvent(name, kind, start, end, span, nbytes, direction))
    return out, (first, last)


class DeviceStretch:
    """Starts torch.profiler before flush number `first` of the window and
    stops it, after a synchronize, once `count` flushes have returned."""

    def __init__(self, torch, trace: Trace, first: int, count: int, scratch: Path):
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.trace = trace
        self.first, self.count = first, count
        self.scratch = scratch
        self.flushes = 0
        self.frames = 0
        self.done = False
        self.profiler = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def before_flush(self) -> None:
        if self.done or self.flushes != self.first:
            return
        self.torch.cuda.synchronize()
        self.profiler.start()

    def after_flush(self, frames: int) -> None:
        if self.done:
            return
        if self.first <= self.flushes < self.first + self.count:
            self.frames += frames
        self.flushes += 1
        if self.flushes == self.first + self.count:
            self.stop()

    def stop(self) -> None:
        if self.done or self.flushes <= self.first:
            return
        self.torch.cuda.synchronize()
        self.profiler.stop()
        self.done = True

    def collect(self) -> None:
        """After the window: read the stretch's trace into the Trace."""
        if not self.done:
            return
        handle, name = tempfile.mkstemp(suffix=".json", dir=self.scratch)
        os.close(handle)
        path = Path(name)
        try:
            self.profiler.export_chrome_trace(str(path))
            events, extent = read_chrome_trace(path)
        finally:
            path.unlink(missing_ok=True)
        self.trace.device = events
        self.trace.stretch_frames = self.frames
        if events:
            self.trace.stretch = extent


def breakdown(trace: Trace, limit: int = 10) -> dict:
    """The stretch's device operations that took most time, and its
    longest idle gaps named by the span the host was in when the next
    device operation was launched (or "host" outside every span)."""
    by_name = defaultdict(float)
    for event in trace.device:
        by_name[event.name[:120]] += (event.end - event.start) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:limit]
    gaps = defaultdict(float)
    reach = None
    for event in sorted(trace.device, key=lambda e: e.start):
        if reach is not None and event.start > reach:
            gaps[f"before {event.span or 'host'}"] += (event.start - reach) * 1e-6
        reach = event.end if reach is None else max(reach, event.end)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:limit]
    return {"device_ops": [[name, seconds] for name, seconds in ops],
            "idle_gaps": [[name, seconds] for name, seconds in idle]}
