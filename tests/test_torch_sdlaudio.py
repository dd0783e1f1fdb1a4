"""The realtime audio backends of the PyTorch port against the JAX package:
backend selection (SHADERFLOW_AUDIO_BACKEND), the SDL backend
(shaderflow_tpu_torch/audio/sdlaudio.py) capturing and playing on SDL's
dummy driver, the audio module's device commands, the BrokenAudio buffer
names, and the Audio scene (examples/torch/torch_demo.py) rendered from a
stub recorder, bit for bit. Only the parts that open SDL need pygame, and
only those skip without it."""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
from test_torch_scene import _fix_reference_texture, _import_example

AMPLITUDE, TONE, RATE, BLOCK = 0.25, 440.0, 44100, 735


def stub_backend(amplitude: float = AMPLITUDE, block: int = BLOCK):
    """A realtime audio backend module with one recorder: each record(n)
    returns the next n (default `block`) frames of a stereo sine of
    `amplitude` at TONE Hz."""

    class Recorder:
        _samplerate = float(RATE)

        def __init__(self):
            self.position = 0

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

        def record(self, numframes=None):
            count = numframes or block
            t = (self.position + np.arange(count)) / RATE
            self.position += count
            wave = (amplitude * np.sin(2 * np.pi * TONE * t)).astype(np.float32)
            return np.stack([wave, wave], axis=1)

    class Device:
        name, channels, isloopback = "stub sine", 2, False

        def recorder(self, samplerate=RATE, channels=None, blocksize=512):
            return Recorder()

    module = types.ModuleType("stub_audio_backend")
    module.all_microphones = lambda include_loopback=False: [Device()]
    module.all_speakers = lambda: []
    module.default_microphone = Device
    module.default_speaker = Device
    return module


def _use_backend(monkeypatch, backend) -> None:
    from shaderflow_tpu.audio import BrokenAudio as Reference
    from shaderflow_tpu_torch.audio import BrokenAudio
    for cls in (BrokenAudio, Reference):
        monkeypatch.setattr(cls, "_backend", staticmethod(lambda: backend))


def _has_pygame() -> bool:
    try:
        import pygame  # noqa: F401
        return True
    except ImportError:
        return False


@pytest.mark.parametrize("choice", [None, "sdl", "soundcard", "none"])
def test_backend_selection_matches_jax(monkeypatch, choice):
    """The backend module each value of SHADERFLOW_AUDIO_BACKEND selects
    (by its name; None for no backend) equals the JAX package's."""
    from shaderflow_tpu.audio import BrokenAudio as Reference
    from shaderflow_tpu_torch.audio import BrokenAudio
    if choice is None:
        monkeypatch.delenv("SHADERFLOW_AUDIO_BACKEND", raising=False)
    else:
        monkeypatch.setenv("SHADERFLOW_AUDIO_BACKEND", choice)
    monkeypatch.setenv("SHADERFLOW_SDL_AUDIODRIVER", "dummy")
    monkeypatch.delenv("SDL_AUDIODRIVER", raising=False)

    def name(module):
        return None if module is None else module.__name__.rsplit(".", 1)[-1]

    got, want = name(BrokenAudio._backend()), name(Reference._backend())
    assert got == want
    if choice == "none":
        assert got is None
    elif choice == "sdl":
        assert got == ("sdlaudio" if _has_pygame() else None)
    if got == "sdlaudio":
        assert BrokenAudio._backend().__name__ == "shaderflow_tpu_torch.audio.sdlaudio"


@pytest.fixture
def sdl(monkeypatch):
    pytest.importorskip("pygame")
    monkeypatch.setenv("SHADERFLOW_AUDIO_BACKEND", "sdl")
    monkeypatch.setenv("SHADERFLOW_SDL_AUDIODRIVER", "dummy")
    monkeypatch.delenv("SDL_AUDIODRIVER", raising=False)


def test_sdl_capture_on_dummy_driver_matches_jax(sdl):
    """One capture cycle of each package's SDL recorder on the dummy driver
    (a real SDL audio thread): samples land in the rolling buffer, the
    blocks have the JAX recorder's shape, type and rate."""
    from shaderflow_tpu.audio import AudioMode as ReferenceMode
    from shaderflow_tpu.audio import BrokenAudio as Reference
    from shaderflow_tpu_torch.audio import AudioMode, BrokenAudio, sdlaudio
    results = {}
    for key, cls, mode in (("port", BrokenAudio, AudioMode), ("jax", Reference, ReferenceMode)):
        audio = cls()
        audio.open_recorder(samplerate=RATE, blocksize=512)
        try:
            assert audio.recorder is not None and audio.mode == mode.Realtime
            data = audio.record(numframes=1024)
            before = audio.tell
            block = audio.recorder.record(numframes=512)
            audio.record(numframes=256)
            results[key] = dict(data=(data.shape[0], data.dtype, data.shape[1] >= 1024),
                                block=(block.shape, block.dtype),
                                rate=audio.samplerate, advanced=audio.tell - before,
                                device=type(audio.recorder_device).__name__,
                                buffer=audio.shape)
        finally:
            if audio.recorder is not None:
                # The JAX recorder's close pauses its device holding the GIL,
                # which deadlocks with a callback in flight (ROADMAP,
                # faults in the reference): pause it as the port does first
                sdlaudio.pause_device(audio.recorder._device)
            audio.close_recorder()
    assert results["port"] == results["jax"]
    assert results["port"]["block"] == ((512, 2), np.float32)
    assert results["port"]["advanced"] >= 256


def test_sdl_player_on_dummy_driver(sdl):
    """The SDL player queues a chunk of each package's shape and drains."""
    from shaderflow_tpu_torch.audio import sdlaudio
    t = np.arange(4410) / RATE
    chunk = np.stack([0.2 * np.sin(2 * np.pi * TONE * t)] * 2, axis=1).astype(np.float32)
    with sdlaudio.default_speaker().player(samplerate=48000) as player:
        player.play(chunk)
        player.play(chunk[:, 0])
        player.drain(timeout=10.0)
    names = [device.name for device in sdlaudio.all_speakers()]
    assert names and all(isinstance(name, str) for name in names)


def test_device_commands_match_jax(monkeypatch, capsys):
    """`<Scene> print-recorders` / `print-speakers`: the audio module's
    commands, through each package's command line, print the same lines."""
    from shaderflow_tpu.cli import launch as reference_launch
    from shaderflow_tpu_torch.cli import launch
    _fix_reference_texture(monkeypatch)
    _use_backend(monkeypatch, stub_backend())
    outputs = []
    for run, module in ((launch, _import_example("torch", "torch_demo")),
                        (reference_launch, _import_example("basic", "demo"))):
        for command in ("print-recorders", "print-speakers"):
            run([module.Audio], ["Audio", command])
        outputs.append(capsys.readouterr().out)
    assert outputs[0] == outputs[1] and "recorder: stub sine" in outputs[0]


def test_broken_audio_buffer_names_match_jax():
    """buffer_seconds (getter and setter), shape, the data between samples
    and seconds, stereo and mono, on the same appended samples."""
    from shaderflow_tpu.audio import BrokenAudio as Reference
    from shaderflow_tpu_torch.audio import BrokenAudio
    rng = np.random.default_rng(3)
    chunks = [rng.standard_normal((2, n)).astype(np.float32) for n in (300, 1200, 77)]
    views = []
    for cls in (BrokenAudio, Reference):
        audio = cls(samplerate=8000)
        audio.buffer_seconds = 0.5
        for chunk in chunks:
            audio.add_data(chunk)
        single = cls(samplerate=8000, channels=1, buffer_seconds=0.25)
        views.append(dict(seconds=audio.buffer_seconds, shape=audio.shape,
                          stereo=audio.stereo, mono=audio.mono,
                          samples=audio.get_data_between_samples(3990, 4000).copy(),
                          span=audio.get_data_between_seconds(0.4, 0.5).copy(),
                          mono_after=(single.mono, single.stereo, single.shape)))
    got, want = views
    for key in ("samples", "span"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("seconds", "shape", "stereo", "mono", "mono_after"):
        assert got[key] == want[key], key
    assert got["shape"] == (2, 4000) and got["span"].shape == (2, 800)


def test_audio_scene_matches_jax(monkeypatch, tmp_path):
    """The Audio scene (the recorder's volume as brightness) exported at
    96x54 from the stub recorder: the port's frames equal the JAX Audio
    scene's bit for bit, and brighten as the integrated volume rises."""
    _fix_reference_texture(monkeypatch)
    frames = {}
    for key, module, extra in (("port", _import_example("torch", "torch_demo"), {"device": "cpu"}),
                               ("jax", _import_example("basic", "demo"), {})):
        _use_backend(monkeypatch, stub_backend())
        scene = module.Audio()
        output = tmp_path / f"{key}.rgb"
        scene.main(width=96, height=54, fps=10, time=0.8, output=str(output), **extra)
        assert scene.audio.recorder is not None
        frames[key] = np.fromfile(output, np.uint8).reshape(-1, 54, 96, 3)
    assert frames["port"].shape == (8, 54, 96, 3)
    np.testing.assert_array_equal(frames["port"], frames["jax"])
    levels = frames["port"][:, 0, 0, 0].astype(int)
    assert levels[0] == 0 and levels[-1] > 100 and np.all(np.diff(levels) >= 0)
    assert (frames["port"] == frames["port"][:, :1, :1]).all()


def test_port_imports_without_pygame_or_jax(tmp_path):
    """With pygame, jax and the JAX package blocked, the port and its new
    modules import, the SDL backend is unavailable (None, as the JAX
    _backend gives without pygame) and the recorder warns and degrades."""
    repo = Path(__file__).resolve().parent.parent
    script = f"""
import os, sys
for name in ("jax", "shaderflow_tpu", "pygame"):
    sys.modules[name] = None
sys.path.insert(0, {str(repo)!r})
sys.path.insert(0, {str(repo / "examples" / "torch")!r})
os.environ["SHADERFLOW_AUDIO_BACKEND"] = "sdl"
import shaderflow_tpu_torch.audio.sdlaudio, shaderflow_tpu_torch.exporting
import shaderflow_tpu_torch.io.sinks, shaderflow_tpu_torch.io.ffmpeg
from shaderflow_tpu_torch.audio import BrokenAudio
import torch_demo
assert BrokenAudio._backend() is None
scene = torch_demo.Audio()
scene.main(width=16, height=9, fps=10, time=0.2, output="pipe", device="cpu")
assert scene.audio.recorder is None
print("ok")
"""
    result = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                            timeout=120, env={**os.environ, "HOME": str(tmp_path)})
    assert result.returncode == 0 and result.stdout.strip().endswith("ok"), result.stderr
    assert "recorder not opened" in result.stderr
