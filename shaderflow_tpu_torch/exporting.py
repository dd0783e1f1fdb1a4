"""
Export orchestration: pick the sink, move frame batches, track progress
and stats.

Port of shaderflow_tpu/exporting.py on the port's own sinks
(shaderflow_tpu_torch/io/sinks.py): NullSink for "null"/None, RawSink for
.rgb/.raw, ImageSink for directories and .png, FFmpegSink when an ffmpeg
binary exists, else CV2Sink, beside which the scene's audio track is
written as '<output>.wav' (16-bit PCM of the export's runtime; a failure
to decode or write it warns and the export goes on). Output "pipe" (or
"-", bytes) returns the encoder's matroska stdout, or the raw rgb24 bytes
without a binary (PipeSink); "tcp://host:port" has the encoder connect to
the URL (mpegts), or streams raw rgb24 there without one (TCPSink).
Batches arrive as engine.WireBatch (the device->host copy already in
flight). The progress bar is tqdm's where it is installed; a `relay`
callback takes (frame, total) instead of the bar, and without tqdm the
bar is None and only the relay reports.
"""

from __future__ import annotations

import time
import wave
from datetime import datetime
from enum import Enum
from pathlib import Path
from typing import TYPE_CHECKING, Callable, Optional, Union

import numpy as np

from shaderflow_tpu_torch import logger
from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
from shaderflow_tpu_torch.io.sinks import (
    CV2Sink, FFmpegSink, ImageSink, NullSink, PipeSink, RawSink, TCPSink, VideoSink)

if TYPE_CHECKING:
    from shaderflow_tpu_torch.engine import WireBatch
    from shaderflow_tpu_torch.scene import ShaderScene


class OutputType(str, Enum):
    PATH = "file"
    PIPE = "pipe"
    TCP = "tcp"
    NULL = "null"


class ExportingHelper:

    def __init__(self, scene: "ShaderScene"):
        self.scene = scene
        self.type: Optional[OutputType] = None
        self.sink: Optional[VideoSink] = None
        self.frame = 0
        self.start = time.monotonic()
        self.relay: Optional[Callable[[int, int], None]] = None
        self.bar = None
        self.took: Optional[float] = None
        self.sidecar_audio: Optional[Path] = None

    @property
    def ffmpeg(self) -> FFmpeg:
        return self.scene.ffmpeg

    @property
    def total_frames(self) -> int:
        return max(1, round(self.scene.runtime * self.scene.fps))

    @property
    def finished(self) -> bool:
        return self.frame >= self.total_frames

    # -- progress -----------------------------------------------------------

    def open_bar(self) -> None:
        """A tqdm bar over the export's frames, disabled where a relay
        reports progress (or relay is False) and in realtime; None where
        tqdm is not installed."""
        try:
            import tqdm
        except ImportError:
            self.bar = None
            return
        self.bar = tqdm.tqdm(
            total=self.total_frames,
            disable=((self.relay is False) or bool(self.relay) or self.scene.realtime),
            desc=f"Scene ({self.scene.name}) → Video",
            unit=" frames",
            dynamic_ncols=True,
            mininterval=1 / 30,
            maxinterval=0.5,
            smoothing=0.1,
            leave=False,
        )

    def update(self, count: int = 1) -> None:
        """`count` more frames delivered: the relay hears (frame, total)
        before the count moves, once a call; the bar moves by `count`."""
        if self.relay:
            self.relay(self.frame, self.total_frames)
        if self.bar:
            self.bar.update(count)
        self.frame += count

    # -- FFmpeg command configuration ----------------------------------------

    def ffmpeg_clean(self) -> None:
        """Drop the last export's inputs, outputs and the exporter's own size
        filter; filters a user composed and the codecs stay."""
        self.ffmpeg.filters = [f for f in self.ffmpeg.filters
                               if not getattr(f, "_exporter_added", False)]
        self.ffmpeg.clear(video_codec=False, audio_codec=False, filters=False)

    def ffmpeg_sizes(self, width: int, height: int) -> None:
        """Pipe rawvideo at the scene size; scale where the encode target
        differs (a raw or ssaa < 1 export pipes the render resolution)."""
        scene = self.scene
        self.ffmpeg.time = scene.runtime
        self.ffmpeg.pipe_input(pixel_format="rgb24", width=scene.width,
                               height=scene.height, framerate=scene.fps)
        if (width, height) != (scene.width, scene.height):
            self.ffmpeg.scale(width=width, height=height)
            self.ffmpeg.filters[-1]._exporter_added = True

    def ffmpeg_output(self, output: Union[Path, str]) -> None:
        """"pipe" (or "-", bytes) encodes to stdout as matroska; anything
        else is a file path, a directory getting a dated file name."""
        if output in ("pipe", "-", bytes):
            self.type = OutputType.PIPE
            self.ffmpeg.pipe_output(format="matroska")
        else:
            self.type = OutputType.PATH
            output = Path(output).expanduser().absolute()
            if not output.name:
                stamp = datetime.now().strftime("%Y-%m-%d %H-%M-%S")
                output = output / f"({stamp}) {self.scene.name}.mp4"
            output.parent.mkdir(parents=True, exist_ok=True)
            self.ffmpeg.output(path=output)

    def ffhook(self) -> None:
        for module in self.scene.modules:
            module.ffhook(self.ffmpeg)

    def _default_codecs(self) -> None:
        """x264 slow crf20 video, AAC audio, where the command has none."""
        if self.ffmpeg.vcodec is None:
            self.ffmpeg.h264(preset="slow", crf=20)
        if self.ffmpeg.acodec is None:
            self.ffmpeg.aac()

    def _encoder(self, output, width: int, height: int, **options) -> None:
        """The encode command of an export to `output`: a file path, "pipe",
        or a URL given with its muxer options."""
        self.ffmpeg_clean()
        self.ffmpeg_sizes(width, height)
        if options:
            self.ffmpeg.output(path=output, options=options)
        else:
            self.ffmpeg_output(output)
        self._default_codecs()
        self.ffhook()

    # -- sink selection ------------------------------------------------------

    def make_sink(self, output: Union[Path, str, None], *, width: int, height: int,
                  turbo: bool = True, buffers: int = 5) -> VideoSink:
        """The sink of `output`. An FFmpegSink hands its frames to the frame
        pump with `turbo` (`buffers` slots of one frame), else writes the
        encoder's stdin from the export loop."""
        scene = self.scene
        frame_bytes = scene.width * scene.height * 3
        if output is None or str(output) in ("null", "null://", "/dev/null"):
            self.type = OutputType.NULL
            self.sink = NullSink()
            return self.sink

        if output in ("pipe", "-", bytes):
            self.type = OutputType.PIPE
            if FFmpeg.available():
                self._encoder(output, width, height)
                self.sink = FFmpegSink(self.ffmpeg, frame_bytes, buffers, turbo, pipe_output=True)
            else:
                logger.warn("No ffmpeg binary: pipe output returns raw rgb24 bytes")
                self.sink = PipeSink()
            return self.sink

        if isinstance(output, str) and output.startswith("tcp://"):
            self.type = OutputType.TCP
            if FFmpeg.available():
                self._encoder(output, width, height, f="mpegts")
                self.sink = FFmpegSink(self.ffmpeg, frame_bytes, buffers, turbo)
            else:
                logger.warn("No ffmpeg binary: streaming raw rgb24 over TCP")
                self.sink = TCPSink(output)
            return self.sink

        path = Path(output).expanduser().absolute()
        suffix = path.suffix.lower()
        self.type = OutputType.PATH
        # Raw and OpenCV sinks take the piped frames verbatim (no rescale)
        pipe_w, pipe_h = scene.width, scene.height
        if (pipe_w, pipe_h) != (width, height) and suffix in (".rgb", ".raw"):
            logger.warn(f"Output rescale {pipe_w}x{pipe_h} -> {width}x{height} "
                        f"needs an ffmpeg binary; writing {pipe_w}x{pipe_h} frames as-is")
        if suffix in (".rgb", ".raw"):
            self.sink = RawSink(path, pipe_w, pipe_h, scene.fps)
        elif suffix in ("", ".png") or path.is_dir():
            self.sink = ImageSink(path if suffix == "" else path.parent)
        elif FFmpeg.available():
            self._encoder(path, width, height)
            self.sink = FFmpegSink(self.ffmpeg, frame_bytes, buffers, turbo)
        else:
            logger.warn(f"No ffmpeg binary: encoding {path.name} with OpenCV "
                        f"(audio, if any, becomes a sidecar .wav)")
            self.sink = CV2Sink(path, pipe_w, pipe_h, scene.fps)
            self.sidecar_audio = self._write_sidecar_audio(path)
        return self.sink

    def _write_sidecar_audio(self, video_path: Path) -> Optional[Path]:
        """Without ffmpeg nothing muxes: write the first audio module's file
        as '<output>.wav', its first runtime x samplerate samples as 16-bit
        PCM. Modules without a file, or whose file is missing, are skipped;
        a file that does not decode, or a target that cannot be written,
        warns and the export goes on without it, as in the reference."""
        for module in self.scene.modules:
            audio_file = getattr(module, "file", None)
            samplerate = getattr(module, "samplerate", None)
            if audio_file is None or samplerate is None:
                continue
            target = video_path.with_suffix(video_path.suffix + ".wav")
            try:
                samples = FFmpeg.get_audio_numpy(audio_file)
                if samples is None:
                    continue
                samples = samples[:int(self.scene.runtime * samplerate)]
                with wave.open(str(target), "wb") as handle:
                    handle.setnchannels(samples.shape[1])
                    handle.setsampwidth(2)
                    handle.setframerate(int(samplerate))
                    handle.writeframes(
                        (np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes())
            except Exception as error:
                logger.warn(f"Could not write sidecar audio: {error}")
                return None
            logger.info(f"Wrote sidecar audio {target}")
            return target
        return None

    # -- frame transport -----------------------------------------------------

    @property
    def wants_host_frames(self) -> bool:
        """True when the sink consumes frame bytes on the host (everything
        except NullSink, which measures pure render throughput)."""
        return self.sink is not None and not isinstance(self.sink, NullSink)

    def pipe_batch(self, batch: "WireBatch") -> None:
        """Deliver one staged (F, H, W, 3) uint8 batch to the sink."""
        count = int(batch.shape[0])
        if isinstance(self.sink, NullSink):
            batch.wait()
            self.sink.frames += count
            self.sink.bytes += count * batch.shape[1] * batch.shape[2] * batch.shape[3]
        elif self.sink is not None:
            self.sink.write_batch(batch.fetch())
        self.update(count)

    # -- finish --------------------------------------------------------------

    def finish(self) -> Optional[Union[Path, bytes]]:
        result = self.sink.finish() if self.sink is not None else None
        if self.bar is not None:
            self.bar.close()
        self.took = time.monotonic() - self.start
        return result

    def log_stats(self, output=None) -> None:
        if isinstance(output, bytes):
            output = f"{len(output)} bytes"
        if output is not None:
            logger.info(f"Finished rendering ({output})")
        took = self.took or (time.monotonic() - self.start)
        logger.info(
            f"• Stats: (Took {took:.2f}s) at "
            f"({self.frame / took:.2f}fps | "
            f"{self.scene.runtime / took:.2f}x Realtime) with "
            f"({self.frame} Total Frames)")
