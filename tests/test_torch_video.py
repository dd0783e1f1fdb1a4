"""Video of the PyTorch port against the JAX package, on the CPU: the
decode-ahead worker (shaderflow_tpu_torch/video.py FramePrefetcher: order,
overlap, end of stream, close), the video probes and the decoded frames
(io/ffmpeg.py: OpenCV here, and the ffmpeg rawvideo pipe through a stub
ffmpeg and ffprobe on PATH that replay pre-made rgb24 frames), the
frame's orientation in the texture, and the Video scene
(examples/torch/torch_demo.py) exported by both packages. Every
comparison is bit-equal: both sides decode the same bytes, and the u8
stream is normalized the same way (engine.normalize_u8)."""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from test_torch_scene import _import_example

REPO = Path(__file__).resolve().parent.parent
WIDTH, HEIGHT = 96, 54

sys.path.insert(0, str(REPO))
from chip_smoke import make_stub_decoder  # noqa: E402  (the card run's stub decoder)


def _clear_probe_caches(*classes):
    for cls in classes:
        for name in ("binary", "ffprobe", "get_video_resolution", "get_video_framerate",
                     "get_video_duration", "get_video_total_frames"):
            getattr(cls, name).cache_clear()


def _ramp_frames(count, height, width):
    """Frames whose every row and column differs: k * 37 + 3 * row + column."""
    k = np.arange(count)[:, None, None, None]
    y = np.arange(height)[None, :, None, None]
    x = np.arange(width)[None, None, :, None]
    c = np.arange(3)[None, None, None, :]
    return ((k * 37 + 3 * y + x + 85 * c) % 256).astype(np.uint8)


@pytest.fixture()
def clip():
    """The generated example clip (examples/assets.py video_file: OpenCV
    writes it, 320x180 at 30 fps, 2 s)."""
    assets = _import_example("basic", "demo").assets
    return assets.video_file()


@pytest.mark.parametrize("package", ["shaderflow_tpu", "shaderflow_tpu_torch"])
def test_frame_prefetcher_order_overlap_and_end(package):
    """Frames come in order, the worker fills its queue while the consumer
    is idle (the overlap), and StopIteration comes at the end, for the
    port's FramePrefetcher as for the JAX package's, on the same input."""
    import importlib
    FramePrefetcher = importlib.import_module(f"{package}.video").FramePrefetcher

    def slow_frames(n=12, delay=0.005):
        for k in range(n):
            time.sleep(delay)
            yield np.full((2, 2, 3), k, np.uint8)

    pf = FramePrefetcher(slow_frames(), depth=8)
    assert int(pf.next()[0, 0, 0]) == 0
    time.sleep(0.2)
    assert pf._queue.qsize() >= 4
    assert [int(pf.next()[0, 0, 0]) for _ in range(11)] == list(range(1, 12))
    with pytest.raises(StopIteration):
        pf.next()
    pf.close()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()


def test_frame_prefetcher_close_unblocks_producer():
    """close() frees a producer blocked on a full queue, ends the frame
    generator (its finally runs: a decoder process would end there) and
    returns once the thread has."""
    from shaderflow_tpu_torch.video import FramePrefetcher
    ended = []

    def endless():
        k = 0
        try:
            while True:
                yield np.full((2, 2, 3), k % 256, np.uint8)
                k += 1
        finally:
            ended.append(k)

    pf = FramePrefetcher(endless(), depth=2)
    pf.next()
    time.sleep(0.05)
    pf.close()
    assert not pf._thread.is_alive() and ended


def test_video_probes_and_frames_match_jax(clip):
    """The OpenCV path of both packages' probes and decoder on the clip:
    size, rate, duration, frame count equal; every frame equal, from the
    start and with skip=5."""
    from shaderflow_tpu.io.ffmpeg import FFmpeg as JaxFFmpeg
    from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
    _clear_probe_caches(FFmpeg, JaxFFmpeg)
    assert FFmpeg.available() is False
    for name in ("get_video_resolution", "get_video_framerate", "get_video_duration",
                 "get_video_total_frames"):
        assert getattr(FFmpeg, name)(clip) == getattr(JaxFFmpeg, name)(clip), name
    assert FFmpeg.get_video_resolution(clip) == (320, 180)
    assert FFmpeg.get_video_total_frames(clip) == 60
    for skip in (0, 5):
        got = list(FFmpeg.iter_video_frames(clip, skip=skip))
        want = list(JaxFFmpeg.iter_video_frames(clip, skip=skip))
        assert len(got) == len(want) == 60 - skip
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert FFmpeg.get_video_resolution(REPO / "no-such-clip.mp4") is None
    assert FFmpeg.iter_video_frames(REPO / "no-such-clip.mp4") is None


def test_ffmpeg_pipe_matches_jax_with_stub_decoder(tmp_path, monkeypatch):
    """The rawvideo rgb24 pipe, through a stub ffmpeg and ffprobe on PATH:
    both packages build the same command (the select filter at `skip`) and
    read the same frames; the probes answer from ffprobe."""
    from shaderflow_tpu.io.ffmpeg import FFmpeg as JaxFFmpeg
    from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
    frames = _ramp_frames(4, 18, 32)
    stub = make_stub_decoder(tmp_path / "bin", frames, fps=60, total=10)
    source = tmp_path / "source.mp4"
    source.write_bytes(b"stub")
    monkeypatch.setenv("PATH", f"{stub}{os.pathsep}{os.environ['PATH']}")
    _clear_probe_caches(FFmpeg, JaxFFmpeg)
    try:
        assert FFmpeg.available() and FFmpeg.binary() == str(stub / "ffmpeg")
        assert FFmpeg.get_video_resolution(source) == (32, 18)
        assert FFmpeg.get_video_framerate(source) == 60.0
        assert FFmpeg.get_video_duration(source) == JaxFFmpeg.get_video_duration(source)
        for skip in (0, 3):
            got = list(FFmpeg.iter_video_frames(source, skip=skip))
            want = list(JaxFFmpeg.iter_video_frames(source, skip=skip))
            assert len(got) == len(want) == 10 - skip
            for k, (g, w) in enumerate(zip(got, want)):
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(g, frames[(k + skip) % 4])
    finally:
        monkeypatch.undo()
        _clear_probe_caches(FFmpeg, JaxFFmpeg)


def test_video_frame_orientation(tmp_path, monkeypatch):
    """A decoded frame's top row is the top of the rendered frame: the
    Video scene at the source's own size (texel centers on pixel centers,
    ssaa 1, subsample 1) renders, at each frame, exactly the decoded frame
    the texture holds (its u8 wire: rows top first, storage order), each
    one of the source's frames the right way up (every row of the source
    differs)."""
    from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
    frames = _ramp_frames(3, HEIGHT, WIDTH)
    stub = make_stub_decoder(tmp_path / "bin", frames, fps=10, total=6)
    source = tmp_path / "source.mp4"
    source.write_bytes(b"stub")
    monkeypatch.setenv("PATH", f"{stub}{os.pathsep}{os.environ['PATH']}")
    _clear_probe_caches(FFmpeg)
    demo = _import_example("torch", "torch_demo")
    scene = demo.Video()
    scene.path = source
    shown = []

    def update(video, original=demo_update(scene)):
        original(video)
        wire = video.texture.wire_u8
        shown.append(np.zeros_like(frames[0]) if wire is None else wire[0, 0].copy())

    out = tmp_path / "video.rgb"
    try:
        scene.initialize()
        monkeypatch.setattr(type(scene.video), "update", update)
        scene.main(width=WIDTH, height=HEIGHT, fps=10, time=0.4, ssaa=1, subsample=1,
                   output=str(out), device="cpu")
        rendered = np.fromfile(out, np.uint8).reshape(-1, HEIGHT, WIDTH, 3)
        assert scene.engine._streamed_names == {"iVideo"}
    finally:
        scene.destroy()
        monkeypatch.undo()
        _clear_probe_caches(FFmpeg)
    assert rendered.shape[0] == 4 and len(shown) >= 4 and scene.video._frames >= 3
    decoded = [k for k in range(4) if shown[k].any()]
    assert len(decoded) >= 3
    for k in range(4):
        # the frames of the batch before the texture's first write read
        # its first snapshot (the engine's backfill, as the reference's)
        np.testing.assert_array_equal(rendered[k], shown[max(k, decoded[0])],
                                      err_msg=f"frame {k}")
    for k in decoded:
        assert any(np.array_equal(shown[k], frame) for frame in frames), k


def demo_update(scene):
    """The ShaderVideo update the scene's module class carries."""
    from shaderflow_tpu_torch.video import ShaderVideo
    return ShaderVideo.update


JAX_SCRIPT = """
import sys
import numpy as np
import pytest
sys.path.insert(0, TESTS)
from test_torch_scene import _fix_reference_texture, _import_example
_fix_reference_texture(pytest.MonkeyPatch())
scene = _import_example("basic", "demo").Video()
scene.main(width=WIDTH, height=HEIGHT, fps=10, time=0.5, output=OUTPUT)
"""


def test_video_scene_matches_jax(clip, tmp_path):
    """The Video scene on the generated clip (OpenCV decodes it on both
    sides), 96x54 at 10 fps for 0.5 s, default ssaa and subsample, against
    the JAX package's in an AVX child: bit-equal."""
    reference = tmp_path / "jax.rgb"
    script = (f"TESTS, OUTPUT = {str(REPO / 'tests')!r}, {str(reference)!r}\n"
              f"WIDTH, HEIGHT = {WIDTH}, {HEIGHT}\n" + JAX_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               SHADERFLOW_NO_COMPILE_CACHE="1", HOME=str(tmp_path))
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-4000:]
    demo = _import_example("torch", "torch_demo")
    scene = demo.Video()
    out = tmp_path / "port.rgb"
    try:
        scene.main(width=WIDTH, height=HEIGHT, fps=10, time=0.5, output=str(out),
                   device="cpu")
    finally:
        scene.destroy()
    got = np.fromfile(out, np.uint8)
    want = np.fromfile(reference, np.uint8)
    assert got.size == want.size == 5 * HEIGHT * WIDTH * 3
    np.testing.assert_array_equal(got, want)
    assert got.reshape(5, HEIGHT, WIDTH, 3)[-1].std() > 10
