"""
FFmpeg command assembly, audio probes and PCM audio decoding.

Port of shaderflow_tpu/io/ffmpeg.py. The FFmpeg class has the reference's whole
surface: inputs and outputs (paths, rawvideo pipes), the video codecs
(x264, x265, NVENC, QuickSync, AMF, SVT-AV1, rav1e, rawvideo, copy, none),
the audio codecs (AAC, MP3, Opus, FLAC, PCM, copy, none, silent) and the
filters (scale, vflip, custom); the CLI's chained codec grammar drives its
methods (cli.py). The probes answer from ffprobe when it exists, else from
the stdlib `wave` header (audio) or OpenCV (video). iter_video_frames
decodes a video through ffmpeg's rawvideo rgb24 pipe, else OpenCV.
AudioReader decodes any audio file through ffmpeg's PCM pipe when the
binary exists (WAV files too, as the reference), else PCM WAV files with
the stdlib `wave` module.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import wave
from dataclasses import dataclass, field
from functools import lru_cache
from pathlib import Path
from subprocess import DEVNULL, PIPE
from typing import Any, Iterator, Optional, Union

import numpy as np

from shaderflow_tpu_torch import logger


# --------------------------------------------------------------------------- #
# Inputs / outputs

@dataclass
class InputPath:
    path: Union[str, Path]
    stream_loop: int = 0
    options: dict[str, Any] = field(default_factory=dict)

    def args(self, ff: "FFmpeg") -> list[str]:
        out: list[str] = []
        if self.stream_loop:
            out += ["-stream_loop", str(self.stream_loop)]
        for key, value in self.options.items():
            out += [f"-{key}", str(value)]
        out += ["-i", str(self.path)]
        return out


@dataclass
class InputPipe:
    """Rawvideo frames on stdin."""
    width: int = 0
    height: int = 0
    framerate: float = 60.0
    pixel_format: str = "rgb24"

    def args(self, ff: "FFmpeg") -> list[str]:
        return [
            "-f", "rawvideo",
            "-pix_fmt", self.pixel_format,
            "-s", f"{self.width}x{self.height}",
            "-r", f"{self.framerate}",
            "-i", "-",
        ]


@dataclass
class OutputPath:
    path: Union[str, Path]
    pixel_format: Optional[str] = "yuv420p"
    options: dict[str, Any] = field(default_factory=dict)

    def args(self, ff: "FFmpeg") -> list[str]:
        out: list[str] = []
        if self.pixel_format:
            out += ["-pix_fmt", self.pixel_format]
        for key, value in self.options.items():
            out += [f"-{key}", str(value)]
        out += ["-y", str(self.path)]
        return out


@dataclass
class OutputPipe:
    format: str = "matroska"
    pixel_format: Optional[str] = None

    def args(self, ff: "FFmpeg") -> list[str]:
        out: list[str] = []
        if self.pixel_format:
            out += ["-pix_fmt", self.pixel_format]
        if self.format:
            out += ["-f", self.format]
        return out + ["-"]


# --------------------------------------------------------------------------- #
# Video codecs

@dataclass
class VideoCodec:
    codec: str = "libx264"
    extra: dict[str, Any] = field(default_factory=dict)

    def args(self, ff: "FFmpeg") -> list[str]:
        out = ["-c:v", self.codec]
        for key, value in self.extra.items():
            if value is not None:
                out += [f"-{key}", str(value)]
        return out


def H264(preset: str = "slow", tune: Optional[str] = None, crf: int = 20,
         profile: Optional[str] = None, **extra) -> VideoCodec:
    return VideoCodec("libx264", dict(preset=preset, tune=tune, crf=crf, profile=profile, **extra))

def H264_NVENC(preset: str = "p5", tune: str = "hq", cq: int = 25, **extra) -> VideoCodec:
    return VideoCodec("h264_nvenc", dict(preset=preset, tune=tune, cq=cq, **extra))

def H265(preset: str = "slow", crf: int = 25, **extra) -> VideoCodec:
    return VideoCodec("libx265", dict(preset=preset, crf=crf, **extra))

def H265_NVENC(preset: str = "p5", tune: str = "hq", cq: int = 25, **extra) -> VideoCodec:
    return VideoCodec("hevc_nvenc", dict(preset=preset, tune=tune, cq=cq, **extra))

def AV1_SVT(preset: int = 7, crf: int = 25, **extra) -> VideoCodec:
    return VideoCodec("libsvtav1", dict(preset=preset, crf=crf, **extra))

def AV1_RAV1E(speed: int = 7, qp: int = 80, **extra) -> VideoCodec:
    return VideoCodec("librav1e", dict(speed=speed, qp=qp, **extra))

def AV1_NVENC(preset: str = "p5", cq: int = 30, **extra) -> VideoCodec:
    return VideoCodec("av1_nvenc", dict(preset=preset, cq=cq, **extra))

def H264_QSV(preset: str = "slow", crf: int = 25, **extra) -> VideoCodec:
    """Intel QuickSync: command assembly only (selection fails at run time
    without the hardware)."""
    return VideoCodec("h264_qsv", dict(preset=preset, global_quality=crf, **extra))

def H265_QSV(preset: str = "slow", crf: int = 25, **extra) -> VideoCodec:
    return VideoCodec("hevc_qsv", dict(preset=preset, global_quality=crf, **extra))

def H264_AMF(preset: str = "quality", crf: int = 25, **extra) -> VideoCodec:
    """AMD AMF: command assembly only."""
    return VideoCodec("h264_amf", dict(quality=preset, qp_i=crf, qp_p=crf, **extra))

def H265_AMF(preset: str = "quality", crf: int = 25, **extra) -> VideoCodec:
    return VideoCodec("hevc_amf", dict(quality=preset, qp_i=crf, qp_p=crf, **extra))

def Rawvideo() -> VideoCodec:
    return VideoCodec("rawvideo")

def CopyVideo() -> VideoCodec:
    return VideoCodec("copy")

@dataclass
class NoVideo:
    def args(self, ff: "FFmpeg") -> list[str]:
        return ["-vn"]


# --------------------------------------------------------------------------- #
# Audio codecs

@dataclass
class AudioCodec:
    codec: str = "aac"
    extra: dict[str, Any] = field(default_factory=dict)

    def args(self, ff: "FFmpeg") -> list[str]:
        out = ["-c:a", self.codec]
        for key, value in self.extra.items():
            if value is not None:
                out += [f"-{key}", str(value)]
        return out


def AAC(bitrate: str = "192k") -> AudioCodec:
    return AudioCodec("aac", {"b:a": bitrate})

def MP3(bitrate: str = "192k") -> AudioCodec:
    return AudioCodec("libmp3lame", {"b:a": bitrate})

def Opus(bitrate: str = "96k") -> AudioCodec:
    return AudioCodec("libopus", {"b:a": bitrate})

def FLAC() -> AudioCodec:
    return AudioCodec("flac")

def CopyAudio() -> AudioCodec:
    return AudioCodec("copy")

@dataclass
class NoAudio:
    def args(self, ff: "FFmpeg") -> list[str]:
        return ["-an"]

@dataclass
class EmptyAudio:
    """Silent anullsrc track (keeps duration when no audio input exists)."""
    samplerate: int = 44100

    def args(self, ff: "FFmpeg") -> list[str]:
        return ["-f", "lavfi", "-t", str(ff.time or 60), "-i",
                f"anullsrc=channel_layout=stereo:sample_rate={self.samplerate}"]


# PCM formats: name -> (bytes/sample, numpy dtype)
PCM_FORMATS: dict[str, tuple[int, np.dtype]] = {
    "pcm_f64le": (8, np.dtype("<f8")), "pcm_f64be": (8, np.dtype(">f8")),
    "pcm_f32le": (4, np.dtype("<f4")), "pcm_f32be": (4, np.dtype(">f4")),
    "pcm_s32le": (4, np.dtype("<i4")), "pcm_s32be": (4, np.dtype(">i4")),
    "pcm_s24le": (3, None), "pcm_s24be": (3, None),
    "pcm_s16le": (2, np.dtype("<i2")), "pcm_s16be": (2, np.dtype(">i2")),
    "pcm_u32le": (4, np.dtype("<u4")), "pcm_u32be": (4, np.dtype(">u4")),
    "pcm_u24le": (3, None), "pcm_u24be": (3, None),
    "pcm_u16le": (2, np.dtype("<u2")), "pcm_u16be": (2, np.dtype(">u2")),
    "pcm_s8": (1, np.dtype("i1")), "pcm_u8": (1, np.dtype("u1")),
}


@dataclass
class PCM:
    format: str = "pcm_f32le"

    def args(self, ff: "FFmpeg") -> list[str]:
        return ["-c:a", self.format, "-f", self.format.replace("pcm_", "")]

    @property
    def size(self) -> int:
        return PCM_FORMATS[self.format][0]

    @property
    def dtype(self) -> np.dtype:
        dtype = PCM_FORMATS[self.format][1]
        if dtype is None:
            raise ValueError(f"24-bit PCM has no numpy dtype ({self.format})")
        return dtype


# --------------------------------------------------------------------------- #
# Filters

@dataclass
class FilterScale:
    width: Optional[int] = None
    height: Optional[int] = None
    resample: str = "lanczos"

    def __str__(self) -> str:
        return f"scale={self.width or -1}:{self.height or -1}:flags={self.resample}"

@dataclass
class FilterVerticalFlip:
    def __str__(self) -> str:
        return "vflip"

@dataclass
class FilterCustom:
    content: str = ""

    def __str__(self) -> str:
        return self.content


# --------------------------------------------------------------------------- #

class FFmpeg:
    """The ffmpeg command, assembled through a fluent interface."""

    def __init__(self, **options):
        self.inputs: list[Any] = []
        self.outputs: list[Any] = []
        self.filters: list[Any] = []
        self.vcodec: Optional[Any] = None
        self.acodec: Optional[Any] = None
        self.time: Optional[float] = None
        self.shortest: bool = False
        self.stream_loop: int = 0
        self.loglevel: str = "info"
        self.hide_banner: bool = True
        self.hwaccel: Optional[str] = None
        self.vsync: Optional[str] = None
        for key, value in options.items():
            setattr(self, key, value)

    # -- management ---------------------------------------------------------

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

    def quiet(self) -> "FFmpeg":
        self.loglevel = "error"
        return self

    def clear(self, inputs=True, outputs=True, filters=True, video_codec=True, audio_codec=True) -> "FFmpeg":
        if inputs: self.inputs.clear()
        if outputs: self.outputs.clear()
        if filters: self.filters.clear()
        if video_codec: self.vcodec = None
        if audio_codec: self.acodec = None
        return self

    # -- inputs / outputs ---------------------------------------------------

    def input(self, path, **options) -> "FFmpeg":
        self.inputs.append(InputPath(path=path, options=options))
        return self

    def pipe_input(self, **options) -> "FFmpeg":
        self.inputs.append(InputPipe(**options))
        return self

    def output(self, path, **options) -> "FFmpeg":
        if str(path) == "-":
            self.outputs.append(OutputPipe(format=options.pop("format", None)))
        else:
            self.outputs.append(OutputPath(path=path, **options))
        return self

    def pipe_output(self, **options) -> "FFmpeg":
        self.outputs.append(OutputPipe(**options))
        return self

    # -- codecs (fluent) ----------------------------------------------------

    def h264(self, **kw) -> "FFmpeg": self.vcodec = H264(**kw); return self
    def h264_nvenc(self, **kw) -> "FFmpeg": self.vcodec = H264_NVENC(**kw); return self
    def h264_qsv(self, **kw) -> "FFmpeg": self.vcodec = H264_QSV(**kw); return self
    def h264_amf(self, **kw) -> "FFmpeg": self.vcodec = H264_AMF(**kw); return self
    def h265(self, **kw) -> "FFmpeg": self.vcodec = H265(**kw); return self
    def h265_nvenc(self, **kw) -> "FFmpeg": self.vcodec = H265_NVENC(**kw); return self
    def h265_qsv(self, **kw) -> "FFmpeg": self.vcodec = H265_QSV(**kw); return self
    def h265_amf(self, **kw) -> "FFmpeg": self.vcodec = H265_AMF(**kw); return self
    def av1_svt(self, **kw) -> "FFmpeg": self.vcodec = AV1_SVT(**kw); return self
    def av1_rav1e(self, **kw) -> "FFmpeg": self.vcodec = AV1_RAV1E(**kw); return self
    def av1_nvenc(self, **kw) -> "FFmpeg": self.vcodec = AV1_NVENC(**kw); return self
    def rawvideo(self) -> "FFmpeg": self.vcodec = Rawvideo(); return self
    def copy_video(self) -> "FFmpeg": self.vcodec = CopyVideo(); return self
    def no_video(self) -> "FFmpeg": self.vcodec = NoVideo(); return self

    def aac(self, **kw) -> "FFmpeg": self.acodec = AAC(**kw); return self
    def mp3(self, **kw) -> "FFmpeg": self.acodec = MP3(**kw); return self
    def opus(self, **kw) -> "FFmpeg": self.acodec = Opus(**kw); return self
    def flac(self) -> "FFmpeg": self.acodec = FLAC(); return self
    def pcm(self, format: str = "pcm_f32le") -> "FFmpeg": self.acodec = PCM(format); return self
    def copy_audio(self) -> "FFmpeg": self.acodec = CopyAudio(); return self
    def no_audio(self) -> "FFmpeg": self.acodec = NoAudio(); return self
    def empty_audio(self, **kw) -> "FFmpeg": self.acodec = EmptyAudio(**kw); return self

    # -- filters ------------------------------------------------------------

    def scale(self, width=None, height=None, resample="lanczos") -> "FFmpeg":
        self.filters.append(FilterScale(width, height, resample))
        return self

    def vflip(self) -> "FFmpeg":
        self.filters.append(FilterVerticalFlip())
        return self

    def filter(self, content: str) -> "FFmpeg":
        self.filters.append(FilterCustom(content))
        return self

    # -- command assembly ---------------------------------------------------

    @property
    def command(self) -> list[str]:
        if not self.inputs:
            raise ValueError("FFmpeg requires at least one input")
        if not self.outputs:
            raise ValueError("FFmpeg requires at least one output")

        cmd: list[str] = [self.binary() or "ffmpeg"]
        if self.hide_banner:
            cmd.append("-hide_banner")
        cmd += ["-loglevel", self.loglevel]
        if self.hwaccel:
            cmd += ["-hwaccel", self.hwaccel]
        if self.vsync:
            cmd += ["-vsync", self.vsync]
        if self.stream_loop:
            cmd += ["-stream_loop", str(self.stream_loop)]
        for item in self.inputs:
            cmd += item.args(self)
        if self.time is not None:
            cmd += ["-t", str(self.time)]
        if self.shortest:
            cmd.append("-shortest")
        for output in self.outputs:
            if self.acodec is not None:
                cmd += self.acodec.args(self)
            if self.vcodec is not None:
                cmd += self.vcodec.args(self)
            if self.filters:
                cmd += ["-vf", ",".join(map(str, self.filters))]
            cmd += output.args(self)
        return cmd

    def run(self, **options) -> subprocess.CompletedProcess:
        # Never inherit stdin: ffmpeg reads it for interactive commands and
        # a probe/convert run must not steal or block on the caller's input
        options.setdefault("stdin", DEVNULL)
        return subprocess.run(self.command, **options)

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

    # -- video probes (ffprobe, else OpenCV) and the rawvideo decode pipe ------

    @staticmethod
    @lru_cache
    def get_video_resolution(path) -> Optional[tuple[int, int]]:
        path = Path(path)
        if not path.exists():
            return None
        value = FFmpeg._probe(path, "stream=width,height")
        if value:
            width, height = value.split(",")[:2]
            return (int(width), int(height))
        try:
            import cv2
            cap = cv2.VideoCapture(str(path))
            if cap.isOpened():
                size = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                        int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
                cap.release()
                return size
        except ImportError:
            pass
        return None

    @staticmethod
    @lru_cache
    def get_video_framerate(path) -> Optional[float]:
        path = Path(path)
        if not path.exists():
            return None
        value = FFmpeg._probe(path, "stream=r_frame_rate")
        if value:
            num, _, den = value.partition("/")
            return float(num) / float(den or 1)
        try:
            import cv2
            cap = cv2.VideoCapture(str(path))
            if cap.isOpened():
                fps = cap.get(cv2.CAP_PROP_FPS)
                cap.release()
                return float(fps) or None
        except ImportError:
            pass
        return None

    @staticmethod
    @lru_cache
    def get_video_duration(path) -> Optional[float]:
        path = Path(path)
        if not path.exists():
            return None
        value = FFmpeg._probe(path, "format=duration")
        if value:
            return float(value)
        frames = FFmpeg.get_video_total_frames(path)
        rate = FFmpeg.get_video_framerate(path)
        if frames and rate:
            return frames / rate
        return None

    @staticmethod
    @lru_cache
    def get_video_total_frames(path) -> Optional[int]:
        path = Path(path)
        if not path.exists():
            return None
        try:
            import cv2
            cap = cv2.VideoCapture(str(path))
            if cap.isOpened():
                count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
                cap.release()
                if count > 0:
                    return count
        except ImportError:
            pass
        if FFmpeg.available():
            result = (FFmpeg(vsync="cfr").quiet().input(path).pipe_output(format="null")
                      ).run(stderr=PIPE, stdout=DEVNULL)
            found = re.findall(rb"frame=\s*(\d+)", result.stderr)
            if found:
                return int(found[-1])
        return None

    @staticmethod
    def iter_video_frames(path, skip: int = 0) -> Optional[Iterator[np.ndarray]]:
        """Decoded (H, W, 3) uint8 RGB frames from frame `skip` on: the
        ffmpeg rawvideo rgb24 pipe (a select filter skips), else OpenCV."""
        path = Path(path)
        if not path.exists():
            return None
        size = FFmpeg.get_video_resolution(path)
        if size is None:
            return None
        width, height = size

        if FFmpeg.available():
            def ffmpeg_frames() -> Iterator[np.ndarray]:
                proc = (FFmpeg(vsync="cfr").quiet()
                        .input(path)
                        .filter(f"select='gte(n\\,{skip})'")
                        .rawvideo().no_audio()
                        .pipe_output(format="rawvideo", pixel_format="rgb24")
                        ).popen(stdout=PIPE, stderr=DEVNULL, stdin=DEVNULL)
                stride = width * height * 3
                try:
                    while (raw := proc.stdout.read(stride)) and len(raw) == stride:
                        yield np.frombuffer(raw, np.uint8).reshape(height, width, 3)
                finally:
                    proc.kill()
                    proc.wait()
            return ffmpeg_frames()

        def cv2_frames() -> Iterator[np.ndarray]:
            import cv2
            cap = cv2.VideoCapture(str(path))
            for _ in range(skip):
                cap.read()
            try:
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        return
                    yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            finally:
                cap.release()
        return cv2_frames()

    @staticmethod
    def is_valid_video(path) -> bool:
        return FFmpeg.get_video_resolution(path) is not None

    @staticmethod
    def loop_video(path, *, times: int = 1, output=None) -> Optional[Path]:
        """Loop a video `times` times without re-encoding, into `output`
        (the input by default): None when the input is missing."""
        path = Path(path)
        if not path.exists() or times <= 1:
            return path if path.exists() else None
        output = Path(output or path)
        looped = output.with_stem(f"{output.stem}-{times}-loops")
        (FFmpeg(stream_loop=(times - 1)).quiet().copy_audio().copy_video()
         .input(path).output(looped, pixel_format=None).run(check=True))
        return looped.replace(output) or output

    @staticmethod
    def concat_segments(segments, output) -> Path:
        """Join export segments losslessly (ffmpeg's concat demuxer over a
        listing file, streams copied): the resume workflow's last step."""
        output = Path(output)
        listing = output.with_suffix(".concat.txt")
        listing.write_text("".join(f"file '{Path(s).absolute()}'\n" for s in segments))
        try:
            subprocess.run(
                (FFmpeg.binary() or "ffmpeg", "-hide_banner", "-loglevel", "error",
                 "-f", "concat", "-safe", "0", "-i", str(listing),
                 "-c", "copy", "-y", str(output)), check=True)
        finally:
            listing.unlink(missing_ok=True)
        return output


# --------------------------------------------------------------------------- #

class AudioReader:
    """Stream float32 (samples, channels) chunks of an audio file,
    time-accurate: each chunk's length is computed against the target
    time, so sample-domain rounding never accumulates. Decodes through an
    ffmpeg PCM pipe when the binary exists (any format, WAV included),
    else PCM WAV files through the stdlib `wave` module."""

    def __init__(self, path, chunk: float = 0.1, format: str = "pcm_f32le"):
        self.path = Path(path)
        self.chunk = float(chunk)
        self.format = PCM(format)
        self.channels: Optional[int] = None
        self.samplerate: Optional[int] = None
        self.read = 0
        self._proc: Optional[subprocess.Popen] = None
        self._wave = None

    @property
    def block_size(self) -> int:
        return self.format.size * (self.channels or 1)

    @property
    def bytes_per_second(self) -> int:
        return self.block_size * (self.samplerate or 44100)

    @property
    def time(self) -> float:
        return self.read / self.bytes_per_second

    def _open_stream(self):
        """A read(nbytes) callable producing interleaved PCM bytes."""
        if FFmpeg.available():
            # stdin=DEVNULL: ffmpeg polls stdin for interactive commands, and
            # a decoder left reading an inherited pipe outlives the export
            self._proc = (FFmpeg().quiet().input(self.path).pcm(self.format.format)
                          .no_video().output("-")).popen(stdout=PIPE, stderr=DEVNULL,
                                                         stdin=DEVNULL)
            return self._proc.stdout.read

        handle = self._wave = wave.open(str(self.path), "rb")
        params = handle.getparams()
        width = params.sampwidth

        def read(nbytes: int) -> bytes:
            frames = handle.readframes(max(1, nbytes // (self.format.size * params.nchannels)))
            if not frames:
                return b""
            if width == 2:
                data = np.frombuffer(frames, np.int16).astype(np.float32) / 32768.0
            elif width == 4:
                data = np.frombuffer(frames, np.int32).astype(np.float32) / 2147483648.0
            elif width == 1:
                data = (np.frombuffer(frames, np.uint8).astype(np.float32) - 128.0) / 128.0
            else:
                raise ValueError(f"Unsupported WAV sample width {width}")
            return data.astype("<f4").tobytes()
        return read

    @property
    def stream(self) -> Iterator[np.ndarray]:
        """Yield (samples, channels) float32 chunks; `chunk` may change
        between iterations (the audio module sets it to the frame's dt)."""
        self.channels = FFmpeg.get_audio_channels(self.path) or 2
        self.samplerate = FFmpeg.get_audio_samplerate(self.path) or 44100
        self.read = 0
        self._proc = None
        reader = self._open_stream()
        try:
            target = 0.0
            while True:
                target += self.chunk
                length = (target - self.time) * self.bytes_per_second
                length = int(self.block_size * round(length / self.block_size))
                length = max(length, self.block_size)
                data = reader(length)
                if not data:
                    break
                # A dying decoder can hand back a partial sample block: drop
                # the trailing bytes (the count below keeps them, as the
                # reference's does)
                frame_bytes = self.format.size * self.channels
                usable = len(data) - (len(data) % frame_bytes)
                if usable == 0:
                    break
                array = np.frombuffer(data[:usable], dtype=self.format.dtype)
                yield array.reshape(-1, self.channels).astype(np.float32, copy=False)
                self.read += len(data)
        finally:
            # Reap the decoder on any exit: the end of the stream, a
            # consumer's break, an error
            if self._proc is not None:
                self._proc.kill()
                self._proc.wait()
                self._proc = None
            if self._wave is not None:
                self._wave.close()
                self._wave = None


# The reference's name for the reader
BrokenAudioReader = AudioReader
