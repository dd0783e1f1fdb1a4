"""tail.k1_frame_pct on stub traces: K1's launches over the frames of the
window's exports, in percent; nothing where the port recorded no frames
or has no tracer."""

import types

import pytest

from portbench.harness import program, registry

READ = registry.metric_reader("tail.k1_frame_pct")


def _trace(counters):
    trace = types.SimpleNamespace()
    trace.program = None if counters is None else program.Program(spans=[], counters=counters)
    return trace


@pytest.mark.parametrize("counters,value", [
    ({0: {"frames": 1200, "k1.launches": 1200}, 1: {"frames": 400, "k1.launches": 400}}, 100.0),
    ({0: {"frames": 1200, "k1.launches": 0}}, 0.0),
    ({0: {"frames": 300, "k1.launches": 300}, 1: {"frames": 100, "k1.launches": 0}}, 75.0),
    ({0: {"frames": 0, "batches": 0}}, None),
    (None, None),
], ids=["every-frame", "none", "one-export-of-two", "no-frames", "no-tracer"])
def test_k1_frame_pct_reads_launches_over_frames(counters, value):
    assert READ(_trace(counters)) == value
