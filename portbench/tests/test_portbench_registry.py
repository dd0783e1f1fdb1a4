"""The harness finds a configuration, a traffic mix, an input kind, a
per-layer metric with the spans it reads and a reference by name, from
new files alone."""

import json
import time

import pytest

from portbench.harness import cell, registry


def test_new_files_are_found_by_name(tmp_path):
    bench = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics", "reference", "inputs"):
        (bench / sub).mkdir(parents=True)
    (bench / "configs" / "newscene.json").write_text(json.dumps({"fps": 30}))
    (bench / "traffic" / "720p.json").write_text(json.dumps({"width": 1280}))
    (bench / "metrics" / "new.layer_ms.py").write_text(
        "SPANS = {'new.step': ('a.b', 'C', 'step')}\n\ndef read(trace):\n    return 4.5\n")
    (bench / "metrics" / "old.layer_ms.py").write_text(
        "SPANS = {'new.step': ('a.b', 'C', 'step'), 'old': ('a', None, 'f')}\n")
    (bench / "metrics" / "clash.py").write_text("SPANS = {'old': ('a', None, 'g')}\n")
    (bench / "reference" / "newscene.py").write_text("def render(*args):\n    return {}\n")
    (bench / "inputs" / "new_kind.py").write_text(
        "def make(name, item, seed, directory, clip_seconds):\n    return [name], [seed]\n")
    assert registry.config("newscene", bench) == {"fps": 30}
    assert registry.traffic("720p", bench) == {"width": 1280}
    assert registry.metric_reader("new.layer_ms", bench)(None) == 4.5
    assert registry.spans(["new.layer_ms", "old.layer_ms"], bench) == {
        "new.step": ("a.b", "C", "step"), "old": ("a", None, "f")}
    with pytest.raises(ValueError, match="span 'old'"):
        registry.spans(["old.layer_ms", "clash"], bench)
    assert registry.input_maker("new_kind", bench)("x", {}, 7, None, 1.0) == (["x"], [7])
    with pytest.raises(ValueError, match="unknown input kind"):
        registry.input_maker("missing_kind", bench)
    assert registry.reference("newscene", bench).render() == {}


def test_cell_metrics_follow_workloads_lists():
    benchmark = {"per_layer": [{"name": "a"}, {"name": "b", "workloads": ["x.1"]}],
                 "end_to_end": []}
    assert [m["name"] for m in registry.cell_metrics("x.1", benchmark, "per_layer")] == ["a", "b"]
    assert [m["name"] for m in registry.cell_metrics("y.1", benchmark, "per_layer")] == ["a"]


def test_a_cell_and_a_metric_added_as_files_run(tiny_root, tmp_path):
    """A cell added to BENCHMARK.json with its traffic file, a configuration
    whose input is of a new kind, and a per-layer metric that reads a new
    span, are made, run and read with no other edit."""
    bench = tiny_root / "portbench"
    config = json.loads((bench / "configs" / "mandelbrot.json").read_text())
    config["inputs"] = {"note": {"kind": "added_note", "text": "made"}}
    (bench / "configs" / "mandelbrot_noted.json").write_text(json.dumps(config))
    (bench / "reference" / "mandelbrot_noted.py").write_text(
        "from portbench.reference.mandelbrot import render, work  # noqa: F401\n")
    (bench / "inputs" / "added_note.py").write_text(
        "def make(name, item, seed, directory, clip_seconds):\n"
        "    path = directory / f'{name}.txt'\n"
        "    path.write_text(f\"{item['text']} {seed}\")\n"
        "    return [path], [path.read_text()]\n")
    benchmark = json.loads((tiny_root / "BENCHMARK.json").read_text())
    benchmark["workloads"].append({"name": "mandelbrot.added", "config": "mandelbrot_noted",
                                   "traffic": "added", "chips": 1, "why": "test"})
    benchmark["per_layer"].append({"name": "added.renders", "unit": "frames", "better": "higher",
                                   "source": "program_span", "layer": "engine",
                                   "moves": "export_fps", "workloads": ["mandelbrot.added"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(benchmark))
    (bench / "traffic" / "added.json").write_text(json.dumps(
        {"width": 64, "height": 36, "ssaa": 2, "clip_seconds": 0.5, "batch": 8,
         "compare_frames": 2}))
    (bench / "metrics" / "added.renders.py").write_text(
        "SPANS = {'added.render': ('shaderflow_tpu_torch.engine', 'RenderEngine', "
        "'render_frame')}\n\n"
        "def read(trace):\n    return len(trace.host.get('added.render', ()))\n")
    try:
        made = cell.Cell("mandelbrot.added", 11, tiny_root, tmp_path)
        outcome = cell.run("mandelbrot.added", 11, 3.0, True, process_start=time.perf_counter(),
                           device="cpu", root=tiny_root)
    finally:
        benchmark["workloads"].pop()
        benchmark["per_layer"].pop()
        (tiny_root / "BENCHMARK.json").write_text(json.dumps(benchmark))
    assert made.inputs["note.data"] == ["made 11"]
    metrics = outcome["result"]["metrics"]
    assert metrics["added.renders"]["value"] > 0
    assert outcome["result"]["correct"] is True
