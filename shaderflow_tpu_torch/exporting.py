"""
Export orchestration: pick the sink, move frame batches, track stats.

Port of shaderflow_tpu/exporting.py on the port's own sinks
(shaderflow_tpu_torch/io/sinks.py): NullSink for "null"/None, RawSink for
.rgb/.raw, ImageSink for directories and .png, FFmpegSink when an ffmpeg
binary exists, else CV2Sink, beside which the scene's audio track is
written as '<output>.wav' (16-bit PCM of the export's runtime; the
reference warns and goes on where the write fails, the port raises).
Batches arrive as engine.WireBatch (the device->host copy already in
flight). Not ported yet: pipe and TCP outputs, the progress bar.
"""

from __future__ import annotations

import time
import wave
from pathlib import Path
from typing import TYPE_CHECKING, Optional, Union

import numpy as np

from shaderflow_tpu_torch import logger
from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
from shaderflow_tpu_torch.io.sinks import (
    CV2Sink, FFmpegSink, ImageSink, NullSink, RawSink, VideoSink)

if TYPE_CHECKING:
    from shaderflow_tpu_torch.engine import WireBatch
    from shaderflow_tpu_torch.scene import ShaderScene


class ExportingHelper:

    def __init__(self, scene: "ShaderScene"):
        self.scene = scene
        self.sink: Optional[VideoSink] = None
        self.frame = 0
        self.start = time.monotonic()
        self.took: Optional[float] = None
        self.sidecar_audio: Optional[Path] = None

    @property
    def ffmpeg(self) -> FFmpeg:
        return self.scene.ffmpeg

    @property
    def total_frames(self) -> int:
        return max(1, round(self.scene.runtime * self.scene.fps))

    # -- FFmpeg command configuration ----------------------------------------

    def _configure_ffmpeg(self, path: Path, width: int, height: int) -> None:
        """Pipe rawvideo at the scene size into an encode of `path`, scaled
        when the encode target differs (x264 slow crf20 / AAC defaults)."""
        scene = self.scene
        self.ffmpeg.filters = [f for f in self.ffmpeg.filters
                               if not getattr(f, "_exporter_added", False)]
        self.ffmpeg.clear(video_codec=False, audio_codec=False, filters=False)
        self.ffmpeg.time = scene.runtime
        self.ffmpeg.pipe_input(pixel_format="rgb24", width=scene.width,
                               height=scene.height, framerate=scene.fps)
        if (width, height) != (scene.width, scene.height):
            self.ffmpeg.scale(width=width, height=height)
            self.ffmpeg.filters[-1]._exporter_added = True
        path.parent.mkdir(parents=True, exist_ok=True)
        self.ffmpeg.output(path=path)
        if self.ffmpeg.vcodec is None:
            self.ffmpeg.h264(preset="slow", crf=20)
        if self.ffmpeg.acodec is None:
            self.ffmpeg.aac()
        for module in scene.modules:
            module.ffhook(self.ffmpeg)

    # -- sink selection ------------------------------------------------------

    def make_sink(self, output: Union[Path, str, None], *, width: int, height: int,
                  turbo: bool = True, buffers: int = 5) -> VideoSink:
        scene = self.scene
        if output is None or str(output) in ("null", "null://", "/dev/null"):
            self.sink = NullSink()
            return self.sink
        if output in ("pipe", "-", bytes) or str(output).startswith("tcp://"):
            raise NotImplementedError("Pipe and TCP outputs are not ported yet")

        path = Path(output).expanduser().absolute()
        suffix = path.suffix.lower()
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
            self._configure_ffmpeg(path, width, height)
            self.sink = FFmpegSink(self.ffmpeg)
        else:
            logger.warn(f"No ffmpeg binary: encoding {path.name} with OpenCV "
                        f"(audio, if any, becomes a sidecar .wav)")
            self.sink = CV2Sink(path, pipe_w, pipe_h, scene.fps)
            self.sidecar_audio = self._write_sidecar_audio(path)
        return self.sink

    def _write_sidecar_audio(self, video_path: Path) -> Optional[Path]:
        """Without ffmpeg nothing muxes: write the first audio module's file
        as '<output>.wav', its first runtime x samplerate samples as 16-bit
        PCM. Modules without a file, or whose file is missing, are skipped
        as in the reference; a failure to decode or write raises."""
        for module in self.scene.modules:
            audio_file = getattr(module, "file", None)
            samplerate = getattr(module, "samplerate", None)
            if audio_file is None or samplerate is None:
                continue
            samples = FFmpeg.get_audio_numpy(audio_file)
            if samples is None:
                continue
            samples = samples[:int(self.scene.runtime * samplerate)]
            target = video_path.with_suffix(video_path.suffix + ".wav")
            with wave.open(str(target), "wb") as handle:
                handle.setnchannels(samples.shape[1])
                handle.setsampwidth(2)
                handle.setframerate(int(samplerate))
                handle.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes())
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
        self.frame += count

    # -- finish --------------------------------------------------------------

    def finish(self) -> Optional[Union[Path, bytes]]:
        result = self.sink.finish() if self.sink is not None else None
        self.took = time.monotonic() - self.start
        return result

    def log_stats(self, output=None) -> None:
        if output is not None:
            logger.info(f"Finished rendering ({output})")
        took = self.took or (time.monotonic() - self.start)
        logger.info(
            f"• Stats: (Took {took:.2f}s) at "
            f"({self.frame / took:.2f}fps | "
            f"{self.scene.runtime / took:.2f}x Realtime) with "
            f"({self.frame} Total Frames)")
