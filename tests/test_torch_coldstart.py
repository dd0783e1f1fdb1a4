"""The timings the port keeps for its cold-start breakdown
(examples/torch/coldstart.py), on the CPU: the audio precomputes'
precompute_timings, the engine's compile_events (flushes that built a
K1), build.build_events (each nvcc batch, g++ and Triton build), and the tool's
own run from a fresh copy of the tree. On the card: chip_smoke.py phase
50."""

import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch
from test_torch_scene import _import_example

from shaderflow_tpu_torch import build
from shaderflow_tpu_torch.io import framepump
from shaderflow_tpu_torch.ops import tailgen

REPO = Path(__file__).resolve().parent.parent


def test_precompute_timings_after_a_cpu_prewarm():
    """The visualizer's spectrogram and waveform precomputes each keep
    {"run": seconds} (no trace or compile step: the work is eager)."""
    demo = _import_example("torch", "torch_demo")
    scene = demo.Visualizer()
    scene._setup_run(width=32, height=18, fps=10, time=0.3, freewheel=True, device="cpu")
    assert scene.spectrogram.precompute_timings == scene.waveform.precompute_timings == {}
    scene._prewarm_modules()
    for module in (scene.spectrogram, scene.waveform):
        assert set(module.precompute_timings) == {"run"}
        assert module.precompute_timings["run"] > 0


def test_compile_events_stay_empty_on_the_cpu(tmp_path):
    """No K1 builds on the CPU (its plain version runs): no compile events."""
    fractals = _import_example("torch", "torch_fractals")
    scene = fractals.Mandelbrot()
    scene.main(width=32, height=18, fps=10, time=0.2, ssaa=2, output=str(tmp_path / "m.rgb"),
               device="cpu")
    assert scene.engine.compile_events == []
    assert scene.engine.last_flush_retraced is False


def test_a_flush_that_builds_k1_is_a_compile_event(monkeypatch):
    """A flush during which tailgen.compiled built a new K1 records (its
    frames, its host seconds) and sets last_flush_retraced."""
    fractals = _import_example("torch", "torch_fractals")
    scene = fractals.Mandelbrot()
    scene._setup_run(width=32, height=18, fps=10, time=0.2, freewheel=True, device="cpu")
    engine = scene.engine
    started = time.perf_counter()
    monkeypatch.setattr(tailgen.compiled, "builds", tailgen.compiled.builds + 1)
    engine._note_builds(tailgen.compiled.builds - 1, 7, started)
    assert engine.last_flush_retraced is True
    (frames, seconds), = engine.compile_events
    assert frames == 7 and seconds >= 0
    engine._note_builds(tailgen.compiled.builds, 7, started)
    assert engine.last_flush_retraced is False and len(engine.compile_events) == 1


def test_the_frame_pumps_build_is_a_build_event(tmp_path, monkeypatch):
    """The frame pump's g++ build into an empty build directory adds one
    ("framepump.cpp", "g++", seconds) entry; loading it again adds none."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libraries", {})
    monkeypatch.setattr(build, "build_events", [])
    build.cxx_library(framepump.SOURCE)
    (source, tool, seconds), = build.build_events
    assert (source, tool) == ("framepump.cpp", "g++") and seconds > 0
    assert (tmp_path / "build" / "libframepump.so").exists()
    monkeypatch.setattr(build, "_libraries", {})
    build.cxx_library(framepump.SOURCE)
    assert len(build.build_events) == 1


def test_each_nvcc_build_is_a_build_event(tmp_path, monkeypatch):
    """One nvcc per stale source, all started together: one entry for the
    batch, ("one.cu two.cu", "nvcc", its wall seconds), so the entries add
    up to the cold start (a stand-in compiler writes the library)."""
    compiler = tmp_path / "nvcc"
    compiler.write_text(f"#!{sys.executable}\nimport sys, time\ntime.sleep(0.05)\n"
                        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n")
    compiler.chmod(0o755)
    sources = []
    for name in ("one", "two"):
        source = tmp_path / f"{name}.cu"
        source.write_text("// a kernel\n")
        sources.append(source)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc", lambda: str(compiler))
    monkeypatch.setattr(build, "build_events", [])
    assert build.build_cuda_libraries(sources) == ["one", "two"]
    (source, tool, seconds), = build.build_events
    assert (source, tool) == ("one.cu two.cu", "nvcc") and seconds >= 0.05
    assert build.build_cuda_libraries(sources) == [] and len(build.build_events) == 1


def test_the_tool_runs_a_fresh_tree(capsys):
    """coldstart.py --cpu at a small size: the export from a fresh copy of
    the tree in a child; one JSON line with the phases (no build on the
    CPU), the precomputes and both exports."""
    coldstart = _import_example("torch", "coldstart")
    assert coldstart.main(["--cpu", "--seconds", "0.2", "--width", "32", "--height", "18"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["cache"] == "fresh" and result["device"] == "cpu"
    assert result["build_events"] == []
    phases = result["phases"]
    for key in ("import_torch_cuda_init", "cold_export_total", "warm_export_total",
                "spectrogram_run", "waveform_run"):
        assert phases[key] > 0, key
    assert not any(key.startswith("engine_build") for key in phases)


def test_the_tool_needs_a_card_by_default():
    """Without --cpu the export runs on the card: with none it fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    coldstart = _import_example("torch", "coldstart")
    with pytest.raises(RuntimeError, match="export's process failed"):
        coldstart.main(["--seconds", "0.1", "--width", "32", "--height", "18"])
