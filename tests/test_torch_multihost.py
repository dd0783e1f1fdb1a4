"""The segmented export of the PyTorch port (shaderflow_tpu_torch/parallel/
multihost.py) against the JAX package's plan, and joined exports against
the single export: disjoint frame-aligned windows rendered on their own
(Scene.main(start=)) must join byte for byte."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
from test_torch_scene import _import_example

from shaderflow_tpu_torch.parallel import (
    export_segment, join_segments, segment_path, segment_plan)

REPO = Path(__file__).resolve().parent.parent
WIDTH, HEIGHT, FPS, SECONDS = 32, 18, 10.0, 1.2


@pytest.mark.parametrize("hosts", [1, 2, 3, 4, 5])
def test_segment_plan_matches_jax(hosts):
    """The plan equals the JAX package's over a grid of durations and
    rates, and covers every frame exactly once."""
    from shaderflow_tpu.parallel.multihost import segment_plan as jax_plan
    for duration in (0.1, 1.0, 1.1, 1.2, 2.5, 7.3, 30.0):
        for fps in (10.0, 24.0, 29.97, 30.0, 60.0):
            plan = segment_plan(duration, fps, hosts)
            assert plan == jax_plan(duration, fps, hosts)
            frames = [k for start, end in plan for k in range(round(start * fps),
                                                              round(end * fps))]
            assert frames == list(range(round(duration * fps)))
    with pytest.raises(ValueError):
        segment_plan(1.0, 10.0, 0)


def test_segment_path_matches_jax(tmp_path):
    from shaderflow_tpu.parallel.multihost import segment_path as jax_path
    for name in ("out.rgb", "clip.final.mp4", "x.mkv"):
        for host in (0, 7, 123):
            assert segment_path(tmp_path / name, host) == jax_path(tmp_path / name, host)


@pytest.mark.parametrize("scene_name", ["Mandelbrot", "Visualizer"])
def test_segmented_export_joins_byte_equal(tmp_path, scene_name):
    """Three segments of Mandelbrot (K3 + K1's plain versions) and of the
    music visualizer (K2 + K1's), each exported by a scene of its own and
    joined, equal the single export byte for byte; the .json frame counts
    add up and the segment files are gone."""
    module = _import_example("torch", "torch_fractals" if scene_name == "Mandelbrot"
                             else "torch_demo")
    cls = getattr(module, scene_name)
    options = dict(width=WIDTH, height=HEIGHT, ssaa=2, device="cpu")
    single = tmp_path / "single.rgb"
    cls().main(output=str(single), fps=FPS, time=SECONDS, **options)
    joined = tmp_path / "joined.rgb"
    for host in range(3):
        export_segment(cls(), joined, hosts=3, host=host, time=SECONDS, fps=FPS, **options)
        assert segment_path(joined, host).exists()
    join_segments(joined, hosts=3)
    frames = round(SECONDS * FPS)
    assert single.stat().st_size == frames * HEIGHT * WIDTH * 3
    assert joined.read_bytes() == single.read_bytes()
    meta = json.loads(joined.with_suffix(".rgb.json").read_text())
    assert meta["frames"] == frames
    assert not segment_path(joined, 0).exists()
    assert np.fromfile(joined, np.uint8).std() > 5


def test_feedback_scene_rejected(tmp_path):
    from shaderflow_tpu_torch.scene import ShaderScene

    class Feedback(ShaderScene):
        def build(self):
            self.shader.texture.temporal = 2

    scene = Feedback()
    scene._setup_run(width=8, height=8, fps=10, freewheel=True, device="cpu")
    with pytest.raises(ValueError, match="temporal feedback"):
        export_segment(scene, tmp_path / "x.rgb", hosts=2, host=0, time=1.0, fps=10,
                       width=8, height=8, device="cpu")


def test_missing_segment_raises(tmp_path):
    segment_path(tmp_path / "out.rgb", 0).write_bytes(b"\0" * 12)
    with pytest.raises(FileNotFoundError, match="seg001"):
        join_segments(tmp_path / "out.rgb", hosts=2)
    assert segment_path(tmp_path / "out.rgb", 0).exists()


def test_container_segments_join_through_concat(tmp_path, monkeypatch):
    """Containers join through FFmpeg.concat_segments: a stub ffmpeg on
    PATH records the concat demuxer's command and the listing of the
    segments in order."""
    stub = tmp_path / "bin" / "ffmpeg"
    stub.parent.mkdir()
    stub.write_text(f"""#!{sys.executable}
import sys, pathlib
args = sys.argv[1:]
listing = pathlib.Path(args[args.index("-i") + 1]).read_text()
pathlib.Path(args[-1]).write_text(" ".join(args[:-1]) + "\\n" + listing)
""")
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", f"{stub.parent}:{os.environ['PATH']}")
    from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
    FFmpeg.binary.cache_clear()
    try:
        output = tmp_path / "out.mp4"
        for host in range(3):
            segment_path(output, host).write_bytes(b"segment")
        join_segments(output, hosts=3)
    finally:
        FFmpeg.binary.cache_clear()
    text = output.read_text()
    assert "-f concat -safe 0" in text and "-c copy" in text
    assert [line.split("'")[1] for line in text.splitlines()[1:]] == [
        str(segment_path(output, host).absolute()) for host in range(3)]
    assert not segment_path(output, 0).exists()
