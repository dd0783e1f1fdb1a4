"""The port's frame pump (shaderflow_tpu_torch/io/framepump.{py,cpp}) and
FFmpegSink's `turbo` and `buffers` against the JAX package's: ordered
delivery and a broken pipe for the native and the Python writer, 1080p
frames byte-equal, `buffers` slots held while the reader is stalled, a
failed g++ build raising, both packages' FFmpegSink through one stub
encoder, and Scene.main to an .mp4 through the stub equal to the .rgb
export. The stub `ffmpeg` copies its stdin to its output path verbatim.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_framepump.py -q
"""

import importlib
import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from shaderflow_tpu_torch.io import framepump
from shaderflow_tpu_torch.io.framepump import FramePump
from test_torch_scene import _import_example

# A stub encoder: its stdin copied to the last argument (the output path)
STUB_FFMPEG = """#!{python}
import shutil, sys
with open(sys.argv[-1], "wb") as out:
    shutil.copyfileobj(sys.stdin.buffer, out, 1 << 20)
"""
# One reader's wait: a test's step that should finish takes far less
WAIT_S = 30.0


def _reader(fd: int, sink: bytearray, gate: threading.Event = None) -> threading.Thread:
    """A thread reading `fd` to its EOF into `sink`, once `gate` is set."""
    def run():
        if gate is not None:
            gate.wait()
        while chunk := os.read(fd, 1 << 20):
            sink.extend(chunk)
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread


def _frames(count: int, nbytes: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, nbytes, dtype=np.uint8) for _ in range(count)]


@pytest.mark.parametrize("native", [True, False])
def test_ordered_delivery(native):
    """Frames of varying sizes come out in the order submitted, whole."""
    read_fd, write_fd = os.pipe()
    received = bytearray()
    reader = _reader(read_fd, received)
    frames = [frame[: 300 + 37 * index] for index, frame in enumerate(_frames(40, 2000))]
    pump = FramePump(write_fd, 2000, slots=3, native=native)
    assert pump.is_native == native
    for frame in frames:
        pump.submit(frame)
    pump.flush()
    pump.close()
    os.close(write_fd)
    reader.join(WAIT_S)
    os.close(read_fd)
    assert bytes(received) == b"".join(frame.tobytes() for frame in frames)


@pytest.mark.parametrize("native", [True, False])
def test_broken_pipe_raises(native):
    """With the reader gone, a write fails with EPIPE: the next submit,
    flush or close raises BrokenPipeError, and keeps raising."""
    read_fd, write_fd = os.pipe()
    os.close(read_fd)
    pump = FramePump(write_fd, 1 << 16, slots=2, native=native)
    frame = np.zeros(1 << 16, np.uint8)
    with pytest.raises(BrokenPipeError) as raised:
        for _ in range(10):
            pump.submit(frame)
        pump.flush()
    assert raised.value.errno == 32                          # EPIPE
    with pytest.raises(BrokenPipeError):
        pump.close()
    os.close(write_fd)


@pytest.mark.parametrize("native", [True, False])
def test_1080p_frames_byte_equal(native):
    """Eight 1920x1080 rgb24 frames through five slots, byte-equal."""
    frame_bytes = 1920 * 1080 * 3
    frames = [frame.reshape(1080, 1920, 3) for frame in _frames(8, frame_bytes, seed=3)]
    read_fd, write_fd = os.pipe()
    received = bytearray()
    reader = _reader(read_fd, received)
    pump = FramePump(write_fd, frame_bytes, slots=5, native=native)
    for frame in frames:
        pump.submit(frame)
    pump.close()
    os.close(write_fd)
    reader.join(WAIT_S)
    os.close(read_fd)
    assert len(received) == 8 * frame_bytes
    assert bytes(received) == b"".join(frame.tobytes() for frame in frames)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("buffers", [1, 5])
def test_buffers_slots_then_blocks(native, buffers):
    """With the reader held, `buffers` submits return (the first one is in
    the writer's hands, blocked in write) and the next one blocks until the
    reader resumes."""
    read_fd, write_fd = os.pipe()
    received = bytearray()
    gate = threading.Event()
    reader = _reader(read_fd, received, gate)
    frame_bytes = 1 << 20                # far above a pipe's 64 KiB buffer
    frames = _frames(buffers + 1, frame_bytes, seed=5)
    pump = FramePump(write_fd, frame_bytes, slots=buffers, native=native)
    returned = [threading.Event() for _ in frames]

    def submit_all():
        for frame, event in zip(frames, returned):
            pump.submit(frame)
            event.set()
    submitter = threading.Thread(target=submit_all, daemon=True)
    submitter.start()
    for event in returned[:buffers]:
        assert event.wait(WAIT_S), "a submit with a free slot blocked"
    assert not returned[buffers].wait(0.5), "a submit returned with every slot taken"
    gate.set()
    assert returned[buffers].wait(WAIT_S), "the blocked submit did not return"
    submitter.join(WAIT_S)
    pump.close()
    os.close(write_fd)
    reader.join(WAIT_S)
    os.close(read_fd)
    assert bytes(received) == b"".join(frame.tobytes() for frame in frames)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises with the compiler's words: the native
    pump never falls back to the Python writer on its own."""
    broken = tmp_path / "broken_framepump.cpp"
    broken.write_text('extern "C" int pump_create( { return 0; }\n')
    monkeypatch.setattr(framepump, "SOURCE", broken)
    monkeypatch.setattr(framepump, "_LIBRARY", None)
    read_fd, write_fd = os.pipe()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed on .*broken_framepump.cpp"):
            FramePump(write_fd, 64, slots=2)
        # native=False is the one way to the Python writer
        pump = FramePump(write_fd, 64, slots=2, native=False)
        assert not pump.is_native
        pump.close()
    finally:
        os.close(write_fd)
        os.close(read_fd)


# --------------------------------------------------------------------------- #
# FFmpegSink through a stub encoder, in both packages

@pytest.fixture
def copy_ffmpeg(tmp_path, monkeypatch):
    """The stub encoder first on PATH, FFmpeg's caches of both packages
    cleared on the way in and out."""
    from test_torch_audio_decode import clear_ffmpeg_caches
    directory = tmp_path / "bin"
    directory.mkdir()
    stub = directory / "ffmpeg"
    stub.write_text(STUB_FFMPEG.format(python=sys.executable))
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", f"{directory}{os.pathsep}{os.environ['PATH']}")
    clear_ffmpeg_caches()
    yield stub
    monkeypatch.undo()
    clear_ffmpeg_caches()


def _sink_bytes(package, output: Path, frames: np.ndarray, turbo: bool, buffers: int) -> bytes:
    """The bytes `package`'s FFmpegSink hands the stub for `frames`, two
    batches."""
    ffmpeg_module = importlib.import_module(f"{package}.io.ffmpeg")
    sinks = importlib.import_module(f"{package}.io.sinks")
    _, height, width, _ = frames.shape
    ffmpeg = ffmpeg_module.FFmpeg()
    ffmpeg.pipe_input(pixel_format="rgb24", width=width, height=height, framerate=30)
    ffmpeg.output(path=output)
    ffmpeg.h264(preset="fast", crf=20)
    sink = sinks.FFmpegSink(ffmpeg, frame_bytes=height * width * 3, buffers=buffers,
                            turbo=turbo)
    assert (sink.pump is not None) == turbo
    if turbo:
        assert sink.pump.is_native
    sink.write_batch(frames[:3])
    sink.write_batch(frames[3:])
    assert sink.finish() == output
    return output.read_bytes()


@pytest.mark.parametrize("turbo", [True, False])
def test_ffmpeg_sink_bytes_match_jax(copy_ffmpeg, tmp_path, turbo):
    """The port's FFmpegSink and the JAX package's hand the same encoder the
    same bytes, the frames themselves, with turbo on and off."""
    frames = np.random.default_rng(9).integers(0, 256, (7, 36, 64, 3), dtype=np.uint8)
    port = _sink_bytes("shaderflow_tpu_torch", tmp_path / "port.mp4", frames, turbo, 3)
    reference = _sink_bytes("shaderflow_tpu", tmp_path / "jax.mp4", frames, turbo, 3)
    assert port == reference == frames.tobytes()


def test_ffmpeg_sink_raises_with_the_encoders_stderr(tmp_path, monkeypatch):
    """An encoder that dies after its first frame: the pump's EPIPE (frames
    larger than a pipe's buffer, so a write meets the closed end) raises
    with what the encoder wrote to stderr."""
    from test_torch_audio_decode import clear_ffmpeg_caches
    from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
    from shaderflow_tpu_torch.io.sinks import FFmpegSink
    height, width = 256, 256
    frame_bytes = height * width * 3
    directory = tmp_path / "bin"
    directory.mkdir()
    stub = directory / "ffmpeg"
    stub.write_text(f"#!{sys.executable}\nimport sys\n"
                    f"sys.stdin.buffer.read({frame_bytes})\n"
                    "sys.stderr.write('stub encoder: no more frames\\n')\n")
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", f"{directory}{os.pathsep}{os.environ['PATH']}")
    clear_ffmpeg_caches()
    try:
        ffmpeg = FFmpeg()
        ffmpeg.pipe_input(pixel_format="rgb24", width=width, height=height, framerate=30)
        ffmpeg.output(path=tmp_path / "dead.mp4")
        sink = FFmpegSink(ffmpeg, frame_bytes=frame_bytes, buffers=2)
        frames = np.zeros((6, height, width, 3), np.uint8)
        with pytest.raises(RuntimeError, match="stub encoder: no more frames"):
            sink.write_batch(frames)
            sink.finish()
    finally:
        monkeypatch.undo()
        clear_ffmpeg_caches()


@pytest.mark.parametrize("turbo,buffers", [(True, 2), (True, 5), (False, 5)])
def test_scene_export_through_the_stub_equals_rgb(copy_ffmpeg, tmp_path, turbo, buffers):
    """Scene.main(output=...mp4, turbo=..., buffers=...) hands the encoder
    exactly the frames of the .rgb export."""
    fractals = _import_example("torch", "torch_fractals")
    options = dict(width=64, height=36, fps=10, time=0.6, ssaa=2, device="cpu")
    result = fractals.Mandelbrot().main(output=str(tmp_path / "out.mp4"), turbo=turbo,
                                        buffers=buffers, **options)
    assert Path(result) == tmp_path / "out.mp4"
    fractals.Mandelbrot().main(output=str(tmp_path / "out.rgb"), **options)   # RawSink
    encoded = (tmp_path / "out.mp4").read_bytes()
    assert len(encoded) == 6 * 36 * 64 * 3
    assert encoded == (tmp_path / "out.rgb").read_bytes()
