"""
Audio subsystem: rolling buffers, file streaming, reactive level uniforms.

Port of shaderflow_tpu/audio/__init__.py. BrokenAudio keeps a rolling
(channels, samples) buffer fed from a file (read in chunks of the frame's
real dt by io/ffmpeg.AudioReader) and, in offline exports, the whole
decoded file, so the spectrogram and waveform batch the entire export.
ShaderAudio adds the smoothed iAudioVolume / iAudioSTD uniforms, reports
the file duration as the scene runtime and muxes the file into FFmpeg
outputs.

Realtime devices go through a backend module (_backend): the `soundcard`
package when it is installed, else SDL2 through pygame (audio/sdlaudio.py,
on SDL's dummy driver where no sound server answers), else none;
SHADERFLOW_AUDIO_BACKEND=soundcard|sdl|none chooses. A missing backend or
device warns and the scene carries on without sound, as the reference
does.
"""

from __future__ import annotations

import math
import os
from enum import Enum
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from shaderflow_tpu_torch import logger
from shaderflow_tpu_torch.dynamics import ShaderDynamics
from shaderflow_tpu_torch.io.ffmpeg import AudioReader, FFmpeg
from shaderflow_tpu_torch.module import ShaderModule


def root_mean_square(data) -> float:
    return float(np.sqrt(np.mean(np.square(data)))) if np.size(data) else 0.0


class AudioMode(Enum):
    Realtime = "realtime"
    File = "file"


class BrokenAudio:
    """Rolling audio buffer and its sources: a file, a recorder."""

    def __init__(self, *, file=None, mode: AudioMode = AudioMode.Realtime,
                 samplerate: float = 44100, channels: int = 2,
                 buffer_seconds: float = 30.0):
        self.mode = AudioMode(mode)
        self.dtype = np.dtype(np.float32)
        self._samplerate = samplerate
        self._channels = channels
        self._buffer_seconds = buffer_seconds
        self.tell: int = 0            # samples consumed (file cursor, offline)
        self._file: Optional[Path] = None
        self._file_reader: Optional[AudioReader] = None
        self._file_stream = None
        self.full_data: Optional[np.ndarray] = None  # (C, S) whole file, offline mode
        self.recorder = None
        self.recorder_device = None
        self.speaker = None
        self.speaker_device = None
        self.create_buffer()
        if file is not None:
            self.file = file

    # -- buffer --------------------------------------------------------------

    @property
    def samplerate(self) -> float:
        return self._samplerate or 44100

    @property
    def channels(self) -> int:
        return self._channels or 2

    @property
    def buffer_seconds(self) -> float:
        """Seconds of audio the rolling buffer keeps (setting it rebuilds
        the buffer, empty)."""
        return self._buffer_seconds

    @buffer_seconds.setter
    def buffer_seconds(self, value: float) -> None:
        self._buffer_seconds = value
        self.create_buffer()

    @property
    def buffer_size(self) -> int:
        return int(self.samplerate * self.buffer_seconds)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.channels, self.buffer_size)

    def create_buffer(self) -> None:
        """A doubled backing store with a write cursor: appending copies
        one chunk, and the live window slides back to the front once per
        buffer length; `data` is a view of the newest buffer_size samples,
        the layout of the reference's np.roll ring."""
        self._ring_size = self.buffer_size
        self._store = np.zeros((self.channels, 2 * self._ring_size), dtype=self.dtype)
        self._cursor = self._ring_size

    @property
    def data(self) -> np.ndarray:
        return self._store[:, self._cursor - self._ring_size:self._cursor]

    def add_data(self, data: np.ndarray) -> Optional[np.ndarray]:
        """Roll-append new (channels, length) samples."""
        data = np.asarray(data, dtype=self.dtype)
        if data.ndim == 1:
            data = np.tile(data, (self.channels, 1))
        if data.shape[0] != self._store.shape[0]:
            self.create_buffer()
        length = data.shape[1]
        size = self._ring_size
        if length >= size:
            self._store[:, :size] = data[:, -size:]
            self._cursor = size
        else:
            if self._cursor + length > self._store.shape[1]:
                self._store[:, :size] = self._store[:, self._cursor - size:self._cursor]
                self._cursor = size
            self._store[:, self._cursor:self._cursor + length] = data
            self._cursor += length
        self.tell += length
        return data

    def get_data_between_samples(self, start: int, end: int) -> np.ndarray:
        return self.data[:, int(start):int(end)]

    def get_data_between_seconds(self, start: float, end: float) -> np.ndarray:
        return self.get_data_between_samples(start * self.samplerate, end * self.samplerate)

    def get_last_n_samples(self, n: int, *, offset: int = 0) -> np.ndarray:
        """The last n samples before the cursor (the trailing sample left
        out, as the reference's slice); in offline mode a window of the
        whole file, zero-filled before its start."""
        if self.full_data is not None:
            end = int(self.tell - offset - 1)
            start = end - int(n)
            out = np.zeros((self.channels, int(n)), dtype=self.dtype)
            lo, hi = max(0, start), max(0, min(end, self.full_data.shape[1]))
            if hi > lo:
                out[:, lo - start:hi - start] = self.full_data[:, lo:hi]
            return out
        return self.data[:, -(int(n + offset) + 1):-(int(offset) + 1)]

    def get_last_n_seconds(self, n: float) -> np.ndarray:
        return self.get_last_n_samples(int(n * self.samplerate))

    # -- file source ----------------------------------------------------------

    @property
    def file(self) -> Optional[Path]:
        return self._file

    @file.setter
    def file(self, value) -> None:
        if value is None:
            return
        self._file = Path(value)
        if not self._file.exists():
            logger.warn(f"Audio File doesn't exist ({value})")
            return
        self._samplerate = FFmpeg.get_audio_samplerate(self._file) or 44100
        self._channels = FFmpeg.get_audio_channels(self._file) or 2
        self.create_buffer()
        self._file_reader = AudioReader(path=self._file)
        self._file_stream = self._file_reader.stream
        self.mode = AudioMode.File
        self.close_recorder()

    def load_full_file(self) -> Optional[np.ndarray]:
        """Decode the entire file -> (C, S) float32 (offline exports)."""
        if self.full_data is None and self._file is not None and self._file.exists():
            samples = FFmpeg.get_audio_numpy(self._file)
            if samples is not None:
                self.full_data = np.ascontiguousarray(samples.T)
        return self.full_data

    # -- realtime devices -------------------------------------------------------

    @staticmethod
    def _backend():
        """The realtime audio backend module, or None: soundcard, else SDL
        (probed: pygame and an SDL audio driver must start), else None.
        SHADERFLOW_AUDIO_BACKEND=soundcard|sdl|none chooses one."""
        choice = (os.environ.get("SHADERFLOW_AUDIO_BACKEND") or "").lower()
        if choice == "none":
            return None
        if choice != "sdl":
            try:
                import soundcard
                return soundcard
            except Exception as error:
                if choice == "soundcard":
                    logger.warn(f"soundcard backend requested but unavailable ({error})")
                    return None
        try:
            from shaderflow_tpu_torch.audio import sdlaudio
            sdlaudio._init_sdl_audio()
            return sdlaudio
        except Exception as error:
            logger.debug(f"SDL audio backend unavailable: {error}")
            return None

    @staticmethod
    def recorders() -> Iterable:
        backend = BrokenAudio._backend()
        if backend is not None:
            yield from backend.all_microphones(include_loopback=True)

    @staticmethod
    def speakers() -> Iterable:
        backend = BrokenAudio._backend()
        if backend is not None:
            yield from backend.all_speakers()

    def open_recorder(self, name: Optional[str] = None, *, samplerate: float = 44100,
                      channels=None, blocksize: int = 512) -> "BrokenAudio":
        backend = self._backend()
        if backend is None:
            logger.warn("no realtime audio backend (neither 'soundcard' nor "
                        "pygame/SDL importable); recorder not opened")
            return self
        self.close_recorder()
        try:
            if name is None:
                for device in self.recorders():
                    if getattr(device, "isloopback", False):
                        self.recorder_device = device
                        break
                self.recorder_device = self.recorder_device or backend.default_microphone()
            else:
                matches = [d for d in self.recorders()
                           if name.lower() in (d.name or "").lower()]
                self.recorder_device = matches[0] if matches else backend.default_microphone()
            self.recorder = self.recorder_device.recorder(
                samplerate=samplerate, channels=channels, blocksize=blocksize).__enter__()
        except Exception as error:
            # A realtime run carries on without capture
            logger.warn(f"Could not open recorder "
                        f"{getattr(self.recorder_device, 'name', None)!r}: {error}")
            self.recorder = None
            return self
        self._samplerate = getattr(self.recorder, "_samplerate", samplerate)
        self._channels = getattr(self.recorder_device, "channels", 2)
        self.create_buffer()
        self.mode = AudioMode.Realtime
        return self

    def close_recorder(self) -> "BrokenAudio":
        if self.recorder is not None:
            try:
                self.recorder.__exit__(None, None, None)
            except Exception:
                pass
        self.recorder = None
        return self

    def open_speaker(self, name: Optional[str] = None, *, samplerate=None) -> "BrokenAudio":
        backend = self._backend()
        if backend is None:
            logger.warn("no realtime audio backend (neither 'soundcard' nor "
                        "pygame/SDL importable); speaker not opened")
            return self
        self.close_speaker()
        try:
            self.speaker_device = backend.default_speaker() if name is None else next(
                (d for d in self.speakers() if name.lower() in (d.name or "").lower()),
                backend.default_speaker())
            self.speaker = self.speaker_device.player(
                samplerate=samplerate or self.samplerate).__enter__()
        except Exception as error:
            logger.warn(f"Could not open speaker "
                        f"{getattr(self.speaker_device, 'name', None)!r}: {error}")
            self.speaker = None
        return self

    def close_speaker(self) -> "BrokenAudio":
        if self.speaker is not None:
            try:
                self.speaker.__exit__(None, None, None)
            except Exception:
                pass
        self.speaker = None
        return self

    def record(self, numframes: Optional[int] = None) -> Optional[np.ndarray]:
        if self.recorder is not None:
            return self.add_data(self.recorder.record(numframes=numframes).T)
        return None

    def play(self, data: np.ndarray) -> None:
        if self.speaker is not None:
            try:
                self.speaker.play(np.asarray(data).T)
            except Exception:
                pass

    @property
    def stereo(self) -> bool:
        return self.channels == 2

    @property
    def mono(self) -> bool:
        return self.channels == 1

    @property
    def duration(self) -> float:
        if self.mode == AudioMode.File and self._file is not None:
            return FFmpeg.get_audio_duration(self._file) or 0.0
        return math.inf


class ShaderAudio(BrokenAudio, ShaderModule):
    """Audio as a scene module: iAudioVolume (2*RMS*sqrt2 of the last 0.1 s,
    integrated) and iAudioSTD uniforms, the file muxed into the export, its
    duration driving the scene runtime."""

    final: bool = True

    def __init__(self, scene=None, name: str = "iAudio", *, file=None, **kwargs):
        BrokenAudio.__init__(self, file=file)
        ShaderModule.__init__(self, scene=scene, name=name, **kwargs)
        self.volume = ShaderDynamics(
            scene=self.scene, name=f"{self.name}Volume",
            frequency=2, zeta=1, response=0, value=0, integrate=True)
        self.std = ShaderDynamics(
            scene=self.scene, name=f"{self.name}STD",
            frequency=10, zeta=1, response=0, value=0)

    def ui(self):
        yield f"mode {self.mode.name}  {self.samplerate:.0f} Hz x{self.channels}"
        if self._file is not None:
            yield f"file {self._file.name}  {self.duration:.1f}s"
        yield (f"volume {float(self.volume.value):.3f}  "
               f"std {float(self.std.value):.3f}")

    def commands(self) -> None:
        self.register_command(self.print_recorders)
        self.register_command(self.print_speakers)

    def print_recorders(self) -> None:
        """List available audio capture devices."""
        try:
            for device in self.recorders():
                print(f"recorder: {device.name}")
        except Exception as error:
            print(f"no audio backend available ({error})")

    def print_speakers(self) -> None:
        """List available audio playback devices."""
        try:
            for device in self.speakers():
                print(f"speaker: {device.name}")
        except Exception as error:
            print(f"no audio backend available ({error})")

    @property
    def duration(self) -> float:
        if self._file is None:
            return 0.0
        return FFmpeg.get_audio_duration(self._file) or 0.0

    def setup(self) -> None:
        if self._file is not None:
            self.file = self._file   # re-open the stream for a fresh run
            if self.scene.freewheel:
                self.load_full_file()
        if self.final and self.scene.realtime:
            if self.mode == AudioMode.File:
                self.open_speaker()
            else:
                self.open_recorder()

    def ffhook(self, ffmpeg: FFmpeg) -> None:
        if self._file is not None and self._file.exists():
            ffmpeg.input(path=self._file)
            ffmpeg.shortest = True

    def update(self) -> None:
        if self.full_data is not None and self.scene.freewheel:
            # The whole file is in memory: advance the cursor
            self.tell = min(int(round(self.scene.time * self.samplerate)),
                            self.full_data.shape[1])
            start = max(0, self.tell - int(0.1 * self.samplerate))
            window = self.full_data[:, start:self.tell]
        else:
            # File mode consumes exactly the frame's real dt (rdt) of audio
            if self._file_stream is not None:
                try:
                    self._file_reader.chunk = self.scene.rdt
                    data = next(self._file_stream).T
                    self.add_data(data)
                    if self.scene.realtime:
                        self.play(data)
                except StopIteration:
                    self._file_stream = None
            elif self.mode == AudioMode.Realtime and self.recorder is not None:
                self.record()
            window = self.get_last_n_seconds(0.1)
        self.volume.target = 2 * root_mean_square(window) * (2 ** 0.5)
        self.std.target = float(np.std(window)) if np.size(window) else 0.0
