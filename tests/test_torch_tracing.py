"""The port's tracer (shaderflow_tpu_torch/tracing.py) on the CPU: off it
reads no clock and records nothing; in a session an export's spans nest as
the module note draws them, with one export id a `main`; the counters
are the change of the program's own counters; under torch.profiler every
span is an "sf." range that the benchmark's reader pairs with it; and
SHADERFLOW_BATCH_TRACE's lines come from the spans.

    python -m pytest tests/test_torch_tracing.py -q
"""

import contextlib
import io
import re
import sys
import types
from collections import Counter
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_scene import _import_example  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# A BATCH_TRACE line (the progress bar may precede it on its line)
TRACE = re.compile(r"BATCH_TRACE frames=(\d+)\+(\d+) capture=(\d+\.\d)ms "
                   r"dispatch=(\d+\.\d)ms drain=(\d+\.\d)ms$", re.M)
# Each span's parent; K1's prepare and the staging pool's wait are reached
# on the card only
PARENTS = {
    "export": {None},
    "export.setup": {"export"}, "prewarm": {"export"}, "engine.build": {"export"},
    "scene.step": {"export"}, "engine.flush": {"export"}, "wire.stage": {"export"},
    "export.drain": {"export"},
    "capture": {"scene.step"},
    "flush.pack": {"engine.flush"}, "flush.upload": {"engine.flush"},
    "engine.preludes": {"engine.flush"}, "frame": {"engine.flush"},
    "fragment": {"frame"}, "tail": {"frame"},
    "export.pipe": {"export", "export.drain"},
    "wire.wait": {"export.pipe"}, "sink.write": {"export.pipe"},
}
# 11 frames in batches of 4
OPTIONS = dict(fps=10, time=1.1, batch=4, output="null", device="cpu")
SCENES = {
    "Visualizer": ("torch_demo", dict(width=128, height=72, ssaa=2)),
    "Mandelbrot": ("torch_fractals", dict(width=96, height=54, ssaa=2)),
}


def _scene(name: str):
    module, size = SCENES[name]
    return getattr(_import_example("torch", module), name)(), size


def _export(name: str, **options):
    scene, size = _scene(name)
    return scene.main(**{**OPTIONS, **size, **options})


def test_off_reads_no_clock_and_records_nothing(monkeypatch):
    from shaderflow_tpu_torch import tracing

    def clock():
        raise AssertionError("the tracer read the clock while off")

    monkeypatch.setattr(tracing, "time", types.SimpleNamespace(perf_counter_ns=clock))
    assert tracing._records is None
    first, second = tracing.span("scene.step"), tracing.span("engine.flush")
    assert first is second
    with first:
        pass
    with tracing.export() as number:
        assert number is None
    _export("Mandelbrot")
    assert tracing._records is None


@pytest.mark.parametrize("name", sorted(SCENES))
def test_spans_nest_with_one_export_id_a_main(name):
    from shaderflow_tpu_torch import tracing
    with tracing.session() as records:
        _export(name)
        _export(name, time=0.5)
    spans = records.spans
    assert all(span.end is not None and span.end >= span.start for span in spans)
    names = Counter(span.name for span in spans)
    assert set(names) == set(PARENTS)
    for position, span in enumerate(spans):
        parent = spans[span.parent] if span.parent is not None else None
        assert (parent.name if parent else None) in PARENTS[span.name], span.name
        if parent is not None:
            assert parent.start <= span.start and span.end <= parent.end
            assert span.parent < position
    roots = [span for span in spans if span.name == "export"]
    assert [root.export for root in roots] == [0, 1]
    for span in spans:
        root = span
        while root.parent is not None:
            root = spans[root.parent]
        assert root.name == "export" and span.export == root.export
    assert records.counters[0]["frames"] == 11 and records.counters[0]["batches"] == 3
    assert records.counters[1]["frames"] == 5 and records.counters[1]["batches"] == 2
    for number, counts in records.counters.items():
        mine = [span for span in spans if span.export == number]
        assert sum(span.name == "scene.step" for span in mine) == counts["frames"]
        assert sum(span.name == "frame" for span in mine) == counts["frames"]
        assert sum(span.name == "engine.flush" for span in mine) == counts["batches"]
        assert sum(span.name == "wire.stage" for span in mine) == counts["batches"]
        assert sum(span.name == "export.pipe" for span in mine) == counts["batches"]
    steps = [span.batch for span in spans if span.name == "scene.step" and span.export == 0]
    assert steps == [0] * 4 + [1] * 4 + [2] * 3
    assert {span.batch for span in spans if span.name in ("export.setup", "export.drain")} \
        == {None}
    times = tracing.self_times(spans)
    assert set(times) == set(PARENTS) and all(value >= 0 for value in times.values())


def test_counters_are_the_program_counters_deltas(monkeypatch):
    """On the CPU the kernels' plain versions count nothing; here each
    rendered frame moves every counter the tracer reads, and one export's
    counters are the change the test sees around it."""
    from shaderflow_tpu_torch import build, engine, tracing
    from shaderflow_tpu_torch.fraggraph import FragmentGraph
    from shaderflow_tpu_torch.ops import fractal, sampling, tailfuse, tailgen
    counted = [(tailgen.compiled, "calls", 3), (tailgen.compiled, "builds", 1),
               (tailfuse.fused_tail_final, "launches", 1),
               (tailfuse.fused_tail_final, "planes_launches", 2),
               (sampling.expand_tables, "launches", 1),
               (fractal.escape_iterations, "launches", 1),
               (fractal.escape_iterations_sep, "launches", 4),
               (FragmentGraph, "replays", 1), (FragmentGraph, "captures", 2),
               (FragmentGraph, "refusals", 3)]
    for owner, attribute, _ in counted:
        monkeypatch.setattr(owner, attribute, getattr(owner, attribute))
    monkeypatch.setattr(build, "build_events", list(build.build_events))
    render_frame = engine.RenderEngine.render_frame

    def counting(self, *args, **kwargs):
        for owner, attribute, step in counted:
            setattr(owner, attribute, getattr(owner, attribute) + step)
        build.build_events.append(("source", "test", 0.0))
        return render_frame(self, *args, **kwargs)

    monkeypatch.setattr(engine.RenderEngine, "render_frame", counting)

    def snapshot():
        return {"k1.prepares": tailgen.compiled.calls, "k1.misses": tailgen.compiled.builds,
                "k1.launches": tailfuse.fused_tail_final.launches
                + tailfuse.fused_tail_final.planes_launches,
                "k2.launches": sampling.expand_tables.launches,
                "k3.launches": fractal.escape_iterations.launches
                + fractal.escape_iterations_sep.launches,
                "builds": len(build.build_events), "fragment.calls": FragmentGraph.calls,
                "fragment.replays": FragmentGraph.replays,
                "fragment.captures": FragmentGraph.captures,
                "fragment.refusals": FragmentGraph.refusals}

    before = snapshot()
    with tracing.session() as records:
        _export("Mandelbrot")
    after = snapshot()
    assert records.counters == {0: {"frames": 11, "batches": 3,
                                    **{key: after[key] - before[key] for key in after}}}
    assert records.counters[0]["k1.launches"] == 3 * 11
    assert records.counters[0]["fragment.calls"] == 11   # render_layer's own count


def test_every_span_is_a_profiler_range_on_one_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from shaderflow_tpu_torch import tracing
    sys.path.insert(0, str(REPO))
    from portbench.harness import program
    with tracing.session() as records:
        with profile(activities=[ProfilerActivity.CPU]) as profiler:
            _export("Visualizer", time=0.5)
    path = tmp_path / "trace.json"
    profiler.export_chrome_trace(str(path))
    ranges = program.annotations(path)
    spans = records.spans
    assert all(span.profiled for span in spans)
    assert Counter(name for name, *_ in ranges) == Counter(span.name for span in spans)
    pairs = program.clock_pairs(spans, ranges)
    assert len(pairs) == len(spans)
    assert all(span.name == name for span, (name, *_) in pairs)
    trace = types.SimpleNamespace(annotations=ranges, device=[], stretch=(0.0, 0.0))
    assert program.build(records, trace).pairs == len(spans)


def test_spans_outside_a_profiler_open_no_range():
    from shaderflow_tpu_torch import tracing
    with tracing.session() as records:
        with tracing.span("scene.step"):
            pass
    assert [span.profiled for span in records.spans] == [False]
    with pytest.raises(RuntimeError, match="already open"):
        with tracing.session(), tracing.session():
            pass


@pytest.mark.parametrize("outer", [False, True], ids=["own session", "open session"])
def test_batch_trace_lines_come_from_the_spans(monkeypatch, outer):
    """SHADERFLOW_BATCH_TRACE=1: a line a flush in the JAX package's
    format, covering every frame; capture, dispatch and drain are the
    batch's scene steps, flush and pipes. Without a session the switch
    opens one for its export and nothing stays open."""
    from shaderflow_tpu_torch import tracing
    monkeypatch.setenv("SHADERFLOW_BATCH_TRACE", "1")
    err = io.StringIO()
    with contextlib.ExitStack() as stack:
        records = stack.enter_context(tracing.session()) if outer else None
        with contextlib.redirect_stderr(err):
            _export("Visualizer")
    assert tracing._records is None
    lines = [match.groups() for match in TRACE.finditer(err.getvalue())]
    assert len(lines) == err.getvalue().count("BATCH_TRACE") == 3
    assert [(int(first), int(count)) for first, count, *_ in lines] == [(0, 4), (4, 4), (8, 3)]
    if records is None:
        return
    for batch, (_, _, capture, dispatch, drain) in enumerate(lines):
        mine = [span for span in records.spans if span.batch == batch]
        for name, printed in (("scene.step", capture), ("engine.flush", dispatch),
                              ("export.pipe", drain)):
            seconds = sum(span.seconds for span in mine if span.name == name)
            assert f"{1e3 * seconds:.1f}" == printed
