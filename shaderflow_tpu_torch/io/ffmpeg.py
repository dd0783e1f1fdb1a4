"""
FFmpeg command builder, audio probes and PCM audio decoding — the part of
shaderflow_tpu/io/ffmpeg.py the port's export path calls.

The builder assembles the encode command of FFmpegSink (a rawvideo pipe in,
x264 + AAC out, an optional scale filter, audio inputs added by module
ffhooks). The probes answer from ffprobe when it exists, else from the
stdlib `wave` header. AudioReader decodes PCM WAV files with the stdlib;
other formats need the reference's ffmpeg decode pipe, not ported yet.
"""

from __future__ import annotations

import shutil
import subprocess
import wave
from dataclasses import dataclass, field
from functools import lru_cache
from pathlib import Path
from typing import Any, Iterator, Optional, Union

import numpy as np

from shaderflow_tpu_torch import logger


# --------------------------------------------------------------------------- #
# Inputs, outputs, codecs, filters

@dataclass
class InputPath:
    path: Union[str, Path]

    def args(self) -> list[str]:
        return ["-i", str(self.path)]


@dataclass
class InputPipe:
    """Rawvideo frames on stdin."""
    width: int = 0
    height: int = 0
    framerate: float = 60.0
    pixel_format: str = "rgb24"

    def args(self) -> list[str]:
        return ["-f", "rawvideo", "-pix_fmt", self.pixel_format,
                "-s", f"{self.width}x{self.height}", "-r", f"{self.framerate}",
                "-i", "-"]


@dataclass
class OutputPath:
    path: Union[str, Path]
    pixel_format: Optional[str] = "yuv420p"

    def args(self) -> list[str]:
        out = ["-pix_fmt", self.pixel_format] if self.pixel_format else []
        return out + ["-y", str(self.path)]


@dataclass
class Codec:
    """`-c:v` / `-c:a` with its options (None values are left out)."""
    flag: str
    codec: str
    extra: dict[str, Any] = field(default_factory=dict)

    def args(self) -> list[str]:
        out = [self.flag, self.codec]
        for key, value in self.extra.items():
            if value is not None:
                out += [f"-{key}", str(value)]
        return out


@dataclass
class FilterScale:
    width: Optional[int] = None
    height: Optional[int] = None
    resample: str = "lanczos"

    def __str__(self) -> str:
        return f"scale={self.width or -1}:{self.height or -1}:flags={self.resample}"


class FFmpeg:
    """Aggregate command builder with a fluent interface."""

    def __init__(self):
        self.inputs: list[Any] = []
        self.outputs: list[Any] = []
        self.filters: list[Any] = []
        self.vcodec: Optional[Codec] = None
        self.acodec: Optional[Codec] = None
        self.time: Optional[float] = None
        self.shortest: bool = False
        self.loglevel: str = "info"

    @staticmethod
    @lru_cache
    def binary() -> Optional[str]:
        return shutil.which("ffmpeg")

    @staticmethod
    @lru_cache
    def ffprobe() -> Optional[str]:
        return shutil.which("ffprobe")

    @classmethod
    def available(cls) -> bool:
        return cls.binary() is not None

    def clear(self, inputs=True, outputs=True, filters=True, video_codec=True,
              audio_codec=True) -> "FFmpeg":
        if inputs:
            self.inputs.clear()
        if outputs:
            self.outputs.clear()
        if filters:
            self.filters.clear()
        if video_codec:
            self.vcodec = None
        if audio_codec:
            self.acodec = None
        return self

    def input(self, path) -> "FFmpeg":
        self.inputs.append(InputPath(path=path))
        return self

    def pipe_input(self, **options) -> "FFmpeg":
        self.inputs.append(InputPipe(**options))
        return self

    def output(self, path, **options) -> "FFmpeg":
        self.outputs.append(OutputPath(path=path, **options))
        return self

    def h264(self, preset: str = "slow", crf: int = 20) -> "FFmpeg":
        self.vcodec = Codec("-c:v", "libx264", dict(preset=preset, crf=crf))
        return self

    def aac(self, bitrate: str = "192k") -> "FFmpeg":
        self.acodec = Codec("-c:a", "aac", {"b:a": bitrate})
        return self

    def scale(self, width=None, height=None, resample="lanczos") -> "FFmpeg":
        self.filters.append(FilterScale(width, height, resample))
        return self

    @property
    def command(self) -> list[str]:
        if not self.inputs:
            raise ValueError("FFmpeg requires at least one input")
        if not self.outputs:
            raise ValueError("FFmpeg requires at least one output")
        cmd: list[str] = [self.binary() or "ffmpeg", "-hide_banner", "-loglevel", self.loglevel]
        for item in self.inputs:
            cmd += item.args()
        if self.time is not None:
            cmd += ["-t", str(self.time)]
        if self.shortest:
            cmd.append("-shortest")
        for output in self.outputs:
            if self.acodec is not None:
                cmd += self.acodec.args()
            if self.vcodec is not None:
                cmd += self.vcodec.args()
            if self.filters:
                cmd += ["-vf", ",".join(map(str, self.filters))]
            cmd += output.args()
        return cmd

    def popen(self, **options) -> subprocess.Popen:
        logger.debug(f"FFmpeg: {' '.join(self.command)}")
        return subprocess.Popen(self.command, **options)

    # -- audio probes (ffprobe, else the WAV header) --------------------------

    @staticmethod
    def _probe(path: Path, entries: str, stream: int = 0) -> Optional[str]:
        if FFmpeg.ffprobe() is None:
            return None
        out = subprocess.check_output(
            (FFmpeg.ffprobe(), "-v", "quiet", "-show_entries", entries,
             "-of", "csv=p=0", "-i", str(path)), stdin=subprocess.DEVNULL
        ).decode().strip().splitlines()
        return out[stream] if out else None

    @staticmethod
    def _wav_params(path: Path):
        try:
            with wave.open(str(path), "rb") as handle:
                return handle.getparams()
        except (wave.Error, EOFError, OSError):
            return None

    @staticmethod
    @lru_cache
    def get_audio_samplerate(path, stream: int = 0) -> Optional[int]:
        path = Path(path)
        if not path.exists():
            return None
        value = FFmpeg._probe(path, "stream=sample_rate", stream)
        if value:
            return int(value)
        params = FFmpeg._wav_params(path)
        return params.framerate if params else None

    @staticmethod
    @lru_cache
    def get_audio_channels(path, stream: int = 0) -> Optional[int]:
        path = Path(path)
        if not path.exists():
            return None
        value = FFmpeg._probe(path, "stream=channels", stream)
        if value:
            return int(value)
        params = FFmpeg._wav_params(path)
        return params.nchannels if params else None

    @staticmethod
    def get_audio_duration(path) -> Optional[float]:
        path = Path(path)
        if not path.exists():
            return None
        params = FFmpeg._wav_params(path)
        if params:
            return params.nframes / params.framerate
        value = FFmpeg._probe(path, "format=duration")
        return float(value) if value else None

    @staticmethod
    def get_audio_numpy(path) -> Optional[np.ndarray]:
        """Decode a whole audio file -> float32 (samples, channels)."""
        path = Path(path)
        if not path.exists():
            return None
        chunks = list(AudioReader(path=path, chunk=10).stream)
        if not chunks:
            return None
        return np.concatenate(chunks)


# --------------------------------------------------------------------------- #

class AudioReader:
    """Stream float32 (samples, channels) chunks of a PCM WAV file,
    time-accurate: each chunk's length is computed against the target time,
    so sample-domain rounding never accumulates (the reference's
    AudioReader, stdlib `wave` path)."""

    SAMPLE_BYTES = 4   # chunk lengths are reckoned in f32 PCM, as the reference's

    def __init__(self, path, chunk: float = 0.1):
        self.path = Path(path)
        self.chunk = float(chunk)
        self.channels: Optional[int] = None
        self.samplerate: Optional[int] = None
        self.read = 0

    @property
    def block_size(self) -> int:
        return self.SAMPLE_BYTES * (self.channels or 1)

    @property
    def bytes_per_second(self) -> int:
        return self.block_size * (self.samplerate or 44100)

    @property
    def time(self) -> float:
        return self.read / self.bytes_per_second

    @property
    def stream(self) -> Iterator[np.ndarray]:
        """Yield (samples, channels) float32 chunks; `chunk` may change
        between iterations."""
        self.channels = FFmpeg.get_audio_channels(self.path) or 2
        self.samplerate = FFmpeg.get_audio_samplerate(self.path) or 44100
        self.read = 0
        try:
            handle = wave.open(str(self.path), "rb")
        except wave.Error as error:
            raise NotImplementedError(
                f"{self.path.name}: only PCM WAV audio decodes in the port "
                f"(the ffmpeg decode pipe is not ported yet): {error}") from None
        with handle:
            width = handle.getsampwidth()
            channels = handle.getnchannels()
            target = 0.0
            while True:
                target += self.chunk
                length = (target - self.time) * self.bytes_per_second
                length = int(self.block_size * round(length / self.block_size))
                length = max(length, self.block_size)
                frames = handle.readframes(max(1, length // (self.SAMPLE_BYTES * channels)))
                if not frames:
                    break
                if width == 2:
                    data = np.frombuffer(frames, np.int16).astype(np.float32) / 32768.0
                elif width == 4:
                    data = np.frombuffer(frames, np.int32).astype(np.float32) / 2147483648.0
                elif width == 1:
                    data = (np.frombuffer(frames, np.uint8).astype(np.float32) - 128.0) / 128.0
                else:
                    raise ValueError(f"Unsupported WAV sample width {width}")
                usable = data.size - data.size % self.channels
                if usable == 0:
                    break
                yield data[:usable].reshape(-1, self.channels)
                self.read += usable * self.SAMPLE_BYTES
