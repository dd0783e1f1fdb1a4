"""The export surface of the PyTorch port against the JAX package: pipe
and TCP outputs (PipeSink, TCPSink, FFmpegSink's pipe_output), the
encoder command make_sink builds for them, the progress bar and relay,
FFmpeg.{loop_video, concat_segments, is_valid_video} on a stub ffmpeg,
and the sidecar WAV's warnings. Bytes and command lines are held equal;
the scenes used render bit-equal in both packages on the CPU."""

import logging
import os
import socket
import sys
import threading

import numpy as np
import pytest
from test_torch_audio_decode import clear_ffmpeg_caches, make_stub_audio, seeded_pcm, stub_calls
from test_torch_scene import _fix_reference_texture, _import_example

SMALL = dict(width=64, height=36, fps=10, time=0.5)
FRAMES = 5
FRAME_BYTES = 36 * 64 * 3


def _scenes(monkeypatch):
    """(port demo module, JAX demo module) with the reference texture fixed."""
    _fix_reference_texture(monkeypatch)
    return _import_example("torch", "torch_demo"), _import_example("basic", "demo")


def _no_ffmpeg(monkeypatch):
    from shaderflow_tpu.io.ffmpeg import FFmpeg as Reference
    from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
    for ffmpeg in (FFmpeg, Reference):
        monkeypatch.setattr(ffmpeg, "binary", staticmethod(lambda: None))


@pytest.fixture
def stub_ffmpeg(tmp_path, monkeypatch):
    """The stub encoder/decoder first on PATH (test_torch_audio_decode)."""
    directory = make_stub_audio(tmp_path / "bin", seeded_pcm(0.5), 44100, width=64, height=36)
    monkeypatch.setenv("PATH", f"{directory}{os.pathsep}{os.environ['PATH']}")
    clear_ffmpeg_caches()
    yield directory
    monkeypatch.undo()
    clear_ffmpeg_caches()


class Listener:
    """A TCP server on 127.0.0.1 that reads one connection to its EOF."""

    def __init__(self):
        self.server = socket.create_server(("127.0.0.1", 0))
        self.url = f"tcp://127.0.0.1:{self.server.getsockname()[1]}"
        self.data = bytearray()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        connection, _ = self.server.accept()
        with connection:
            while chunk := connection.recv(1 << 16):
                self.data += chunk

    def result(self) -> bytes:
        self.thread.join(timeout=30)
        self.server.close()
        assert not self.thread.is_alive()
        return bytes(self.data)


def test_pipe_sink_bytes_match_jax(monkeypatch, tmp_path):
    """output="pipe" without an ffmpeg binary returns the raw rgb24 frames:
    the port's bytes equal the JAX PipeSink's, and the port's .rgb file."""
    port, reference = _scenes(monkeypatch)
    _no_ffmpeg(monkeypatch)
    got = port.ShaderToy().main(output="pipe", device="cpu", **SMALL)
    want = reference.ShaderToy().main(output="pipe", **SMALL)
    assert isinstance(got, bytes) and len(got) == FRAMES * FRAME_BYTES
    assert got == want
    port.ShaderToy().main(output=str(tmp_path / "toy.rgb"), device="cpu", **SMALL)
    assert (tmp_path / "toy.rgb").read_bytes() == got
    assert np.frombuffer(got, np.uint8).std() > 10


def test_tcp_sink_streams_the_frames(monkeypatch):
    """output="tcp://..." without an ffmpeg binary streams raw rgb24 to the
    URL: a local listener reads the port's bytes, equal to the JAX
    TCPSink's and to the pipe's; main returns the URL, as the JAX one."""
    port, reference = _scenes(monkeypatch)
    _no_ffmpeg(monkeypatch)
    received = []
    for run in (lambda url: port.Dynamics().main(output=url, device="cpu", **SMALL),
                lambda url: reference.Dynamics().main(output=url, **SMALL)):
        listener = Listener()
        assert run(listener.url) == listener.url
        received.append(listener.result())
    piped = port.Dynamics().main(output="pipe", device="cpu", **SMALL)
    assert len(received[0]) == FRAMES * FRAME_BYTES
    assert received[0] == received[1] == piped


@pytest.mark.parametrize("name, output", [("ShaderToy", "pipe"), ("ShaderToy", "tcp"),
                                          ("Visualizer", "pipe")])
def test_encoder_commands_match_jax(monkeypatch, stub_ffmpeg, name, output):
    """With an ffmpeg binary (the stub), "pipe" encodes to matroska on
    stdout and tcp:// has the encoder mux mpegts to the URL: make_sink
    builds the JAX package's command line (the audio module's input
    hooked in for the visualizer), and the "pipe" result is the encoder's
    stdout, which counts the F x H x W x 3 bytes it was fed."""
    port, reference = _scenes(monkeypatch)
    target = "tcp://127.0.0.1:9" if output == "tcp" else "pipe"
    options = dict(SMALL, time=0.2) if name == "Visualizer" else SMALL
    frames = round(options["time"] * options["fps"])
    results = [getattr(port, name)().main(output=target, device="cpu", **options)]
    commands = [[args for args in stub_calls(stub_ffmpeg) if "rawvideo" in args]]
    results.append(getattr(reference, name)().main(output=target, **options))
    commands.append([args for args in stub_calls(stub_ffmpeg) if "rawvideo" in args][1:])
    assert len(commands[0]) == len(commands[1]) == 1
    assert commands[0] == commands[1]
    command = commands[0][0]
    if output == "pipe":
        assert command[-3:] == ["-f", "matroska", "-"]
        assert results[0] == results[1] == b"STUB" + (frames * FRAME_BYTES).to_bytes(8, "little")
    else:
        assert command[-6:] == ["-pix_fmt", "yuv420p", "-f", "mpegts", "-y", target]
        assert results[0] == results[1]
    if name == "Visualizer":
        assert str(port.MUSIC) in command and "-shortest" in command


def _record_helpers(patch, module, relay=None):
    """Every ExportingHelper of `module` that opens its bar, with `relay(i)`
    set as the i-th one's relay before its bar opens (as a caller of the
    helper sets it); `patch` is a monkeypatch context."""
    helpers = []
    original = module.ExportingHelper.open_bar

    def open_bar(self):
        if relay is not None:
            self.relay = relay(len(helpers))
        helpers.append(self)
        original(self)

    patch.setattr(module.ExportingHelper, "open_bar", open_bar)
    return helpers


def test_progress_bar_and_relay_count_frames(monkeypatch):
    """The relay hears (frame, total) once a delivered batch, the frames
    before it, as the JAX helper's; the bar (tqdm) counts every frame."""
    pytest.importorskip("tqdm")
    import shaderflow_tpu.exporting as reference_exporting
    import shaderflow_tpu_torch.exporting as exporting
    port, reference = _scenes(monkeypatch)
    heard = {"port": [], "jax": []}
    for key, module, scene, extra in (("port", exporting, port, {"device": "cpu"}),
                                      ("jax", reference_exporting, reference, {})):
        with monkeypatch.context() as patch:
            helpers = _record_helpers(patch, module, relay=lambda index, key=key: (
                lambda frame, total: heard[key].append((frame, total))))
            scene.ShaderToy().main(output="null", batch=2, **SMALL, **extra)
        assert helpers[-1].frame == FRAMES and helpers[-1].finished
    assert heard["port"] == heard["jax"] == [(0, 5), (2, 5), (4, 5)]
    with monkeypatch.context() as patch:
        bars = _record_helpers(patch, exporting)
        port.ShaderToy().main(output="null", batch=2, device="cpu", **SMALL)
    assert bars[-1].relay is None and bars[-1].bar.n == bars[-1].bar.total == FRAMES


def test_export_without_tqdm_goes_on(monkeypatch):
    """A divergence from the reference, held here: without tqdm the JAX
    open_bar raises ImportError; the port's leaves the bar None, the export
    goes on and the relay still reports."""
    import shaderflow_tpu.exporting as reference_exporting
    import shaderflow_tpu_torch.exporting as exporting
    port, reference = _scenes(monkeypatch)
    _no_ffmpeg(monkeypatch)
    monkeypatch.setitem(sys.modules, "tqdm", None)
    heard = []
    helpers = _record_helpers(monkeypatch, exporting,
                              relay=lambda index: lambda frame, total: heard.append(frame))
    frames = port.ShaderToy().main(output="pipe", device="cpu", **SMALL)
    assert helpers[-1].bar is None and heard == [0] and len(frames) == FRAMES * FRAME_BYTES
    with pytest.raises(ImportError):
        reference_exporting.ExportingHelper(reference.ShaderToy()).open_bar()


def test_loop_video_and_concat_segments_match_jax(stub_ffmpeg, tmp_path):
    """FFmpeg.loop_video and concat_segments run the JAX package's commands
    (on the stub, which writes the outputs), return the same paths, and
    is_valid_video answers from the probe as the JAX one does."""
    from shaderflow_tpu.io.ffmpeg import FFmpeg as Reference
    from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
    clip = tmp_path / "clip.mp4"
    segments = [tmp_path / "a.mp4", tmp_path / "b.mp4"]
    for segment in segments:
        segment.write_bytes(b"segment")
    runs = []
    for ffmpeg in (FFmpeg, Reference):
        clip.write_bytes(b"clip")
        before = len(stub_calls(stub_ffmpeg))
        looped = ffmpeg.loop_video(clip, times=3)
        joined = ffmpeg.concat_segments(segments, tmp_path / "joined.mp4")
        runs.append(dict(paths=(looped, joined, clip.read_bytes()[:4]),
                         calls=stub_calls(stub_ffmpeg)[before:],
                         valid=(ffmpeg.is_valid_video(clip),
                                ffmpeg.is_valid_video(tmp_path / "missing.mp4")),
                         single=ffmpeg.loop_video(clip, times=1)))
        assert not (tmp_path / "joined.concat.txt").exists()
    assert runs[0] == runs[1]
    assert runs[0]["paths"] == (clip, tmp_path / "joined.mp4", b"STUB")
    loop, concat = runs[0]["calls"]
    assert loop[loop.index("-stream_loop") + 1] == "2" and concat[concat.index("-f") + 1] == "concat"
    assert runs[0]["valid"] == (True, False)


def test_sidecar_wav_warns_on_an_unwritable_target(monkeypatch, tmp_path, caplog):
    """A sidecar target that cannot be written ('<output>.wav' is a
    directory) warns and leaves no sidecar, in both packages."""
    from shaderflow_tpu.exporting import ExportingHelper as ReferenceHelper
    from shaderflow_tpu_torch.exporting import ExportingHelper
    port, reference = _scenes(monkeypatch)
    (tmp_path / "out.mp4.wav").mkdir()
    results = []
    for helper_class, scene in ((ExportingHelper, port.Visualizer()),
                                (ReferenceHelper, reference.Visualizer())):
        scene.initialize()
        scene.set_duration(0.5)
        helper = helper_class(scene)
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            returned = helper._write_sidecar_audio(tmp_path / "out.mp4")
        results.append((returned, [r.getMessage().split(":")[0] for r in caplog.records
                                   if r.levelno == logging.WARNING]))
    assert results[0][0] is None and ExportingHelper(port.Visualizer()).sidecar_audio is None
    assert results[0][1] == results[1][1] == ["Could not write sidecar audio"]


def test_sidecar_wav_warns_on_an_undecodable_track(monkeypatch, tmp_path, caplog):
    """A track the reader cannot decode (not WAV, and no ffmpeg) warns and
    leaves no sidecar, with the JAX package's message."""
    from shaderflow_tpu.exporting import ExportingHelper as ReferenceHelper
    from shaderflow_tpu.io.ffmpeg import FFmpeg as Reference
    from shaderflow_tpu_torch.exporting import ExportingHelper
    from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
    port, reference = _scenes(monkeypatch)
    _no_ffmpeg(monkeypatch)
    for ffmpeg in (FFmpeg, Reference):
        monkeypatch.setattr(ffmpeg, "ffprobe", staticmethod(lambda: None))
    track = tmp_path / "track.ogg"
    track.write_bytes(b"OggS but not really")
    results = []
    for helper_class, scene in ((ExportingHelper, port.Visualizer()),
                                (ReferenceHelper, reference.Visualizer())):
        scene.audio_file = track
        scene.initialize()
        scene.set_duration(0.3)
        helper = helper_class(scene)
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            returned = helper._write_sidecar_audio(tmp_path / "out.mp4")
        results.append((returned, [r.getMessage() for r in caplog.records
                                   if r.levelno == logging.WARNING]))
    assert results[0][0] is None and not (tmp_path / "out.mp4.wav").exists()
    assert results[0][1] == results[1][1]
    assert len(results[0][1]) == 1 and results[0][1][0].startswith("Could not write sidecar")
