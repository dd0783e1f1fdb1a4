"""
Audio subsystem, offline file mode: the file source and the reactive
level uniforms.

Port of shaderflow_tpu/audio/__init__.py, its offline path. BrokenAudio
holds a file's format and, in offline exports, the whole decoded file, so
the spectrogram and waveform batch the entire export. ShaderAudio adds the
smoothed iAudioVolume / iAudioSTD uniforms, reports the file duration as
the scene runtime and muxes the file into FFmpeg outputs. The reference's
rolling buffer feeds its realtime recorder, speaker and per-frame file
stream; none of those is ported yet (they raise NotImplementedError).
"""

from __future__ import annotations

import math
from enum import Enum
from pathlib import Path
from typing import Optional

import numpy as np

from shaderflow_tpu_torch import logger
from shaderflow_tpu_torch.dynamics import ShaderDynamics
from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
from shaderflow_tpu_torch.module import ShaderModule


def root_mean_square(data) -> float:
    return float(np.sqrt(np.mean(np.square(data)))) if np.size(data) else 0.0


class AudioMode(Enum):
    Realtime = "realtime"
    File = "file"


class BrokenAudio:
    """An audio file's format and, once loaded, its samples."""

    def __init__(self, *, file=None, mode: AudioMode = AudioMode.Realtime,
                 samplerate: float = 44100, channels: int = 2):
        self.mode = AudioMode(mode)
        self._samplerate = samplerate
        self._channels = channels
        self.tell: int = 0            # the current sample of the export
        self._file: Optional[Path] = None
        self.full_data: Optional[np.ndarray] = None  # (C, S) whole file, offline mode
        if file is not None:
            self.file = file

    @property
    def samplerate(self) -> float:
        return self._samplerate or 44100

    @property
    def channels(self) -> int:
        return self._channels or 2

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
        self.mode = AudioMode.File

    def load_full_file(self) -> Optional[np.ndarray]:
        """Decode the entire file -> (C, S) float32 (offline exports)."""
        if self.full_data is None and self._file is not None and self._file.exists():
            samples = FFmpeg.get_audio_numpy(self._file)
            if samples is not None:
                self.full_data = np.ascontiguousarray(samples.T)
        return self.full_data

    # -- realtime devices -----------------------------------------------------

    def open_recorder(self, *args, **kwargs):
        raise NotImplementedError("Realtime audio capture is not ported yet")

    def open_speaker(self, *args, **kwargs):
        raise NotImplementedError("Realtime audio playback is not ported yet")

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

    @property
    def duration(self) -> float:
        if self._file is None:
            return 0.0
        return FFmpeg.get_audio_duration(self._file) or 0.0

    def setup(self) -> None:
        if self._file is not None and self.scene.freewheel:
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
        if self.full_data is None:
            window = np.zeros((self.channels, 0), np.float32)   # no file: silence
        else:
            # The whole file is in memory: advance the cursor
            self.tell = min(int(round(self.scene.time * self.samplerate)),
                            self.full_data.shape[1])
            start = max(0, self.tell - int(0.1 * self.samplerate))
            window = self.full_data[:, start:self.tell]
        self.volume.target = 2 * root_mean_square(window) * (2 ** 0.5)
        self.std.target = float(np.std(window)) if np.size(window) else 0.0
