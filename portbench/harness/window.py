"""
The measured window: the benchmark's host sink and the rate arithmetic.

Scene.main takes no sink, so for the window ExportingHelper.make_sink is
wrapped to hand the export a BenchSink. The sink asks for host frames (the
export stages each batch's pinned device-to-host copy, as for every real
output), timestamps each delivered batch, keeps the frames the seed picked
for the comparison, and drops the rest without writing them anywhere.
When the window's time is up it asks the scene to stop after the batch in
hand.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Delivery:
    """One batch handed to the sink."""
    job: int
    first: int          # the clip's frame index of the batch's first frame
    count: int
    at: float           # perf_counter when the frames were on the host


@dataclass
class Window:
    """Everything the sink saw in a run's window."""
    start: float
    end: float
    deliveries: list = field(default_factory=list)
    kept: dict = field(default_factory=dict)       # (job, frame) -> (H, W, 3) u8
    jobs: list = field(default_factory=list)       # (job, clip, started, finished)


def export_fps(deliveries: list, start: float, end: float) -> float | None:
    """Frames delivered in [start, end] over the time from `start` to the
    last of those deliveries; None when nothing was delivered in it."""
    inside = [d for d in deliveries if start <= d.at <= end]
    if not inside:
        return None
    last = max(d.at for d in inside)
    return sum(d.count for d in inside) / (last - start)


class BenchSink:
    """A VideoSink of the benchmark: see the module docstring."""

    def __init__(self, window: Window, job: int, keep: set, scene):
        self.window = window
        self.job = job
        self.keep = keep            # frame indices of this job to keep
        self.scene = scene
        self.frames = 0

    def write_batch(self, frames: np.ndarray) -> None:
        now = time.perf_counter()
        first = self.frames
        self.window.deliveries.append(Delivery(self.job, first, int(frames.shape[0]), now))
        for index in self.keep:
            if first <= index < first + frames.shape[0]:
                self.window.kept[(self.job, index)] = np.array(frames[index - first])
        self.frames += int(frames.shape[0])
        if now >= self.window.end:
            self.scene.quit = True

    def finish(self):
        return None


@contextlib.contextmanager
def bench_sink(exporting_module, make):
    """While inside, every ExportingHelper.make_sink returns make(helper)
    (a BenchSink) in place of the sink its output names."""
    original = exporting_module.ExportingHelper.make_sink

    def make_sink(self, output, *, width, height, turbo=True, buffers=5):
        self.type = exporting_module.OutputType.NULL
        self.relay = False      # no progress bar
        self.sink = make(self)
        return self.sink

    exporting_module.ExportingHelper.make_sink = make_sink
    try:
        yield
    finally:
        exporting_module.ExportingHelper.make_sink = original
