"""The readers of a traced run on a small recorded fixture: a Chrome trace
with the benchmark's "pb." ranges and the port's "sf." ranges, kernels,
a memset and a D2H copy, and the host spans of the port's tracing
session. The nine readers that time the port from outside, and
breakdown(), give what they gave before the port had spans; the six that
read the port's spans give the values worked out by hand below."""

import json
import sys
import types

import pytest

from portbench.harness import program, registry, trace as tracing

OFFSET_US = 5000.0          # the trace's clock less perf_counter's, microseconds
FRAME_BYTES = 100
READ_CHROME_TRACE = tracing.read_chrome_trace

# The session's spans: (name, start, end) on the trace's clock (us), the
# index of the parent, the export, and the sf. range's jitter (us) where
# the span was profiled (None: opened outside the profiler's stretch)
SPANS = [
    ("export", 0, 1948, None, 0, None),
    ("export.setup", 10, 200, 0, 0, None),
    ("prewarm", 200, 500, 0, 0, None),
    ("engine.build", 500, 520, 0, 0, None),
    ("scene.step", 520, 600, 0, 0, None),
    ("capture", 530, 590, 4, 0, None),
    ("scene.step", 600, 700, 0, 0, None),
    ("engine.flush", 1000, 1895, 0, 0, 0),
    ("flush.upload", 1000, 1002, 7, 0, 0),
    ("staging.wait", 1000.5, 1001.5, 8, 0, 1),
    ("engine.preludes", 1002, 1008, 7, 0, -1),
    ("frame", 1010, 1400, 7, 0, 1),
    ("fragment", 1020, 1200, 11, 0, -1),
    ("tail", 1210, 1390, 11, 0, 1),
    ("frame", 1400, 1880, 7, 0, -1),
    ("fragment", 1410, 1600, 14, 0, 1),
    ("tail", 1610, 1870, 14, 0, -1),
    ("tail.prepare", 1615, 1640, 16, 0, 1),
    ("wire.stage", 1895, 1940, 0, 0, 0),
    ("export.drain", 1940, 1948, 0, 0, -1),
    # The next export starts inside the stretch; its root's range is not
    # in the trace, so the name "export" is not paired
    ("export", 1952, 3000, None, 1, 0),
    ("export.setup", 1952, 1958, 20, 1, 1),
    ("export.pipe", 1958, 2095, 20, 1, 0),
    ("wire.wait", 1960, 2090, 22, 1, -1),
    ("sink.write", 2090, 2095, 22, 1, 0),
    ("export.drain", 2200, 2500, 20, 1, None),
]
COUNTERS = {0: {"frames": 2, "batches": 1, "k1.prepares": 2, "k1.misses": 1},
            1: {"frames": 0, "batches": 0, "k1.prepares": 0, "k1.misses": 0}}

# The benchmark's wrappers: (name, start, end) of each range on the trace
PB = [("engine.flush", 1000, 1900), ("engine.preludes", 1002, 1008),
      ("fragment", 1018, 1202), ("tail", 1208, 1392),
      ("fragment", 1408, 1602), ("tail", 1608, 1872)]
# Device events: (category, name, launch ts, start, end, bytes)
DEVICE = [("gpu_memset", "Memset (Device)", 1012, 1090, 1095, 0),
          ("kernel", "lookup_expand_kernel", 1004, 1100, 1150, 0),
          ("kernel", "conv_depthwise2d_forward", 1100, 1300, 1500, 0),
          ("kernel", "escape_kernel", 1101, 1300, 1400, 0),
          ("kernel", "tail_kernel", 1300, 1500, 1550, 0),
          ("kernel", "conv_depthwise2d_forward", 1500, 1700, 1800, 0),
          ("kernel", "tail_kernel", 1700, 1800, 1850, 0),
          ("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 1900, 1950, 2000, 200)]

# The wrappers' host spans over the window (perf_counter seconds)
HOST = {"scene.step": [(0.0, 0.0004), (1.0, 1.0006)],
        "prewarm": [(0.5, 0.7)],
        "engine.flush": [(2.0, 2.009)]}
WORK = {"tail_ops": 4.0e6, "tail_bytes": 9.0e6, "escape_steps": 2.0e6,
        "barfield_bytes": 3.0e6}

# What the nine readers that time the port from outside, and breakdown(),
# read on this fixture before the port had spans
WRAPPERS = {"scene.step_host_ms": 0.4999999999999669,
            "prewarm.clip_s": 0.19999999999999996,
            "engine.flush_host_ms": 4.4999999999999485,
            "fragment.device_ms": 0.19999999999999998,
            "tail_roofline": 5.373134328358209,
            "escape_roofline": 0.5380509641873278,
            "barfield_roofline": 3.582089552238806,
            "wire.d2h_ms": 0.024999999999999998,
            "device.idle_pct": 54.09090909090908}
BREAKDOWN = {
    "device_ops": [["conv_depthwise2d_forward", 0.0003],
                   ["escape_kernel", 9.999999999999999e-05],
                   ["tail_kernel", 9.999999999999999e-05],
                   ["lookup_expand_kernel", 4.9999999999999996e-05],
                   ["Memcpy DtoH (Device -> Pinned)", 4.9999999999999996e-05],
                   ["Memset (Device)", 4.9999999999999996e-06]],
    "idle_gaps": [["before fragment", 0.0003], ["before engine.flush", 9.999999999999999e-05],
                  ["before engine.preludes", 4.9999999999999996e-06]]}

# By hand: idle intervals of the stretch (1000, 2100) in us: [1000, 1090]
# 90, [1095, 1100] 5, [1150, 1300] 150, [1550, 1700] 150, [1850, 1950]
# 100, [2000, 2100] 100; 595 in all. The innermost span over each: the
# fragment 70 + 5 + 50 + 50, the tail 90 + 5 + 60 + 20, its prepare 25,
# the frames 10 + 10 + 10 + 10, the flush 2 + 15, the upload 0.5 + 0.5
# and its staging wait 1, the preludes 6, the wire's stage 45 and wait
# 90, the drain 8, outside 2 (1948-1950, between the exports), the sink
# 5, the second export's root 5 (2095-2100)
IDLE_US = {"fragment": 175, "tail": 175, "tail.prepare": 25, "frame": 40,
           "engine.flush": 17, "flush.upload": 1, "staging.wait": 1,
           "engine.preludes": 6, "wire.stage": 45, "wire.wait": 90, "export.drain": 8,
           program.OUTSIDE: 2, "sink.write": 5, "export": 5}
NEW = {"fragment.host_ms": (180 + 190) * 1e-3 / 2,
       "tail.host_ms": (180 + 260) * 1e-3 / 2,
       "wire.wait_host_ms": (130 + 1) * 1e-3 / 2,
       "export.fixed_s": (190 + 300 + 20 + 8 + 6 + 300) * 1e-6 / 2,
       "device.idle_fragment_pct": 100 * 175 / 595,
       "tail.k1_hit_pct": 50.0}


def chrome_trace() -> dict:
    events = [{"ph": "X", "cat": "user_annotation", "name": "pb." + name, "ts": start,
               "dur": end - start, "tid": 1} for name, start, end in PB]
    for name, start, end, _, _, jitter in SPANS:
        if jitter is not None and name != "export":
            events.append({"ph": "X", "cat": "user_annotation", "name": "sf." + name,
                           "ts": start + jitter, "dur": end - start, "tid": 1})
    # Their projections on the device's timeline are not host ranges
    events.append({"ph": "X", "cat": "gpu_user_annotation", "name": "sf.fragment",
                   "ts": 1300, "dur": 200, "tid": 7})
    for correlation, (category, name, launch, start, end, nbytes) in enumerate(DEVICE):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": launch, "dur": 1, "tid": 1, "args": {"correlation": correlation}})
        events.append({"ph": "X", "cat": category, "name": name, "ts": start,
                       "dur": end - start, "tid": 7,
                       "args": {"correlation": correlation, "bytes": nbytes}})
    events.append({"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 2099, "dur": 1,
                   "tid": 1})
    return {"traceEvents": events}


def session_records():
    spans = [types.SimpleNamespace(name=name, start=round((start - OFFSET_US) * 1e3),
                                   end=round((end - OFFSET_US) * 1e3), parent=parent,
                                   export=export, profiled=jitter is not None)
             for name, start, end, parent, export, jitter in SPANS]
    return types.SimpleNamespace(spans=spans, counters=COUNTERS)


class Profiler:
    def export_chrome_trace(self, path):
        with open(path, "w") as handle:
            json.dump(chrome_trace(), handle)


@pytest.fixture
def fixture_trace(tmp_path):
    """The Trace a traced run builds from the fixture, through
    DeviceStretch.collect with the port's session open, the "sf." ranges
    read on the way."""
    trace = tracing.Trace(frame_bytes=FRAME_BYTES)
    stretch = tracing.DeviceStretch.__new__(tracing.DeviceStretch)
    stretch.trace, stretch.scratch, stretch.done = trace, tmp_path, True
    stretch.frames, stretch.profiler = 2, Profiler()
    session = program.open_session(trace)
    try:
        stretch.collect()
    finally:
        session.close()
    assert tracing.read_chrome_trace is READ_CHROME_TRACE
    for label, spans in HOST.items():
        trace.host[label].extend(spans)
    trace.work = dict(WORK)
    return trace


def test_the_readers_of_the_wrappers_read_what_they_read(fixture_trace):
    assert fixture_trace.stretch == (1000.0, 2100.0)
    readings = {name: registry.metric_reader(name)(fixture_trace) for name in WRAPPERS}
    assert readings == WRAPPERS
    assert tracing.breakdown(fixture_trace) == BREAKDOWN


def test_the_readers_of_the_port_s_spans(fixture_trace, capsys):
    assert all(registry.metric_reader(name)(fixture_trace) is None for name in NEW)
    records = session_records()
    program.attach(fixture_trace, types.SimpleNamespace(close=lambda: records))
    found = fixture_trace.program
    assert found.pairs == 17
    assert found.unpaired == {"export": (1, 0)}
    assert found.offset_us == pytest.approx(OFFSET_US, abs=1e-6)
    assert found.spread_us == pytest.approx(1.0, abs=1e-6)
    assert found.idle == pytest.approx({name: us * 1e-6 for name, us in IDLE_US.items()})
    for name, value in NEW.items():
        assert registry.metric_reader(name)(fixture_trace) == pytest.approx(value), name
    readings = {name: registry.metric_reader(name)(fixture_trace) for name in WRAPPERS}
    assert readings == WRAPPERS
    notes = capsys.readouterr().err
    assert "clock pairs 17" in notes and "spread (MAD) 1.000 us" in notes
    assert "not paired (profiled spans/ranges): export 1/0" in notes
    assert "outside 0.0010 (0.3 %)" in notes
    assert "export 0 counters: frames 2, batches 1, k1.prepares 2, k1.misses 1" in notes
    assert "engine.flush 1/1 0.0009/0.0090" in notes
    # The flush's 895 us less its upload (2), preludes (6) and frames
    # (390 + 480), over 2 frames
    assert found.self_seconds()["engine.flush"] == pytest.approx(17e-6)
    assert "engine.flush 0.0085" in notes.split("host self ms a frame by span: ")[1]


def test_a_port_without_a_tracer_reads_nothing(fixture_trace, monkeypatch):
    """An older port: no session, trace.program None, no reading and no
    error."""
    monkeypatch.setitem(sys.modules, "shaderflow_tpu_torch.tracing", None)
    session = program.Session()
    assert session.records is None
    program.attach(fixture_trace, session)
    assert fixture_trace.program is None
    assert all(registry.metric_reader(name)(fixture_trace) is None for name in NEW)


def test_innermost_segments_cover_the_stretch():
    segments = program.innermost_segments(
        [(0, 10, "a"), (2, 4, "b"), (2, 3, "c"), (6, 12, "d"), (15, 16, "e")], 1, 20)
    assert segments == [(1, 2, "a"), (2, 3, "c"), (3, 4, "b"), (4, 6, "a"), (6, 10, "d"),
                        (10, 15, program.OUTSIDE), (15, 16, "e"), (16, 20, program.OUTSIDE)]


def test_a_traced_run_opens_the_port_s_session_over_its_window(tiny_root):
    """Through the harness as it is: the metric files' SPANS open the
    session after the warm-up export and before the window, the first
    reading closes it, and nothing of it stays open after the run. (The
    run's `correct` is not asked: on a loaded CPU an export can outlast
    the short window.)"""
    import time

    from portbench.harness import cell
    from shaderflow_tpu_torch import tracing as port_tracing

    # Outside a traced run's gathering of spans a metric file opens nothing
    assert registry.metric_module("fragment.host_ms").SPANS == {}
    assert port_tracing._records is None
    path = tiny_root / "BENCHMARK.json"
    saved = path.read_text()
    benchmark = json.loads(saved)
    for metric in benchmark["per_layer"]:
        if metric["name"] in NEW:
            metric["workloads"].append("visualizer.tiny")
    path.write_text(json.dumps(benchmark))
    try:
        outcome = cell.run("visualizer.tiny", 2**31 + 9, 2.0, True,
                           process_start=time.perf_counter(), device="cpu", root=tiny_root)
    finally:
        path.write_text(saved)
    assert port_tracing._records is None
    assert tracing.read_chrome_trace is READ_CHROME_TRACE
    found = outcome["trace"].program
    jobs = outcome["window"].jobs
    assert found.exports() == len(jobs) >= 1
    names = [span.name for span in found.spans]
    assert names.count("export") == len(jobs)
    assert names.count("scene.step") == found.total("frames") > 0
    metrics = outcome["result"]["metrics"]
    for name in ("fragment.host_ms", "tail.host_ms", "wire.wait_host_ms", "export.fixed_s",
                 "scene.step_host_ms", "engine.flush_host_ms"):
        assert metrics[name]["value"] >= 0, name

