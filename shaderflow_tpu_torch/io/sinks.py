"""
Video sinks: where rendered uint8 frame batches go (the offline sinks of
shaderflow_tpu/io/sinks.py).

  FFmpegSink  - rawvideo frames written to an FFmpeg subprocess's stdin
  CV2Sink     - OpenCV VideoWriter (mp4 without an ffmpeg binary)
  ImageSink   - numbered PNG frames
  RawSink     - headerless .rgb dump + sidecar metadata
  NullSink    - swallow frames (render throughput)

FFmpegSink writes each batch to the encoder's stdin from the export loop's
thread; the reference's multithreaded C++ frame pump is not carried over.
"""

from __future__ import annotations

import json
from pathlib import Path
from subprocess import PIPE
from tempfile import TemporaryFile
from typing import Optional

import numpy as np

from shaderflow_tpu_torch import logger
from shaderflow_tpu_torch.io.ffmpeg import FFmpeg


class VideoSink:
    """Consumes (F, H, W, 3) uint8 frame batches."""

    def write_batch(self, frames: np.ndarray) -> None:
        raise NotImplementedError

    def finish(self) -> Optional[Path]:
        """Flush and close; returns the output path."""
        return None


class NullSink(VideoSink):
    def __init__(self):
        self.frames = 0
        self.bytes = 0

    def write_batch(self, frames: np.ndarray) -> None:
        self.frames += frames.shape[0]
        self.bytes += frames.nbytes

    def finish(self) -> None:
        logger.info(f"NullSink consumed {self.frames} frames ({self.bytes / 1e6:.1f} MB)")
        return None


class FFmpegSink(VideoSink):
    """Rawvideo frames piped to an FFmpeg subprocess; process death is
    detected per batch and its captured stderr is replayed in the error."""

    def __init__(self, ffmpeg: FFmpeg):
        self.ffmpeg = ffmpeg
        self.stderr = TemporaryFile(mode="w+b")
        self.process = ffmpeg.popen(stdin=PIPE, stderr=self.stderr)

    def _check_alive(self) -> None:
        if self.process.poll() is not None:
            self.stderr.seek(0)
            raise RuntimeError(
                "FFmpeg process closed unexpectedly with traceback:\n"
                + self.stderr.read().decode("utf-8", "replace"))

    def write_batch(self, frames: np.ndarray) -> None:
        self._check_alive()
        self.process.stdin.write(np.ascontiguousarray(frames).data)

    def finish(self) -> Optional[Path]:
        self.process.stdin.close()
        self.process.wait()
        self.stderr.close()
        for output in self.ffmpeg.outputs:
            return Path(output.path)
        return None


class CV2Sink(VideoSink):
    """OpenCV VideoWriter fallback (no audio muxing)."""

    def __init__(self, path: Path, width: int, height: int, fps: float):
        import cv2
        self._cv2 = cv2
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fourcc = cv2.VideoWriter_fourcc(*("mp4v" if self.path.suffix in (".mp4", ".m4v")
                                          else "MJPG"))
        self.size = (height, width)
        self.writer = cv2.VideoWriter(str(self.path), fourcc, fps, (width, height))
        if not self.writer.isOpened():
            raise RuntimeError(f"cv2.VideoWriter could not open {self.path}")

    def write_batch(self, frames: np.ndarray) -> None:
        # cv2.VideoWriter silently drops mismatched frames: fail loudly
        if tuple(frames.shape[1:3]) != self.size:
            raise ValueError(
                f"CV2Sink opened for {self.size} frames, got {frames.shape[1:3]}")
        for frame in frames:
            self.writer.write(self._cv2.cvtColor(frame, self._cv2.COLOR_RGB2BGR))

    def finish(self) -> Path:
        self.writer.release()
        return self.path


class ImageSink(VideoSink):
    def __init__(self, directory: Path, prefix: str = "frame"):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.prefix = prefix
        self.index = 0

    def write_batch(self, frames: np.ndarray) -> None:
        from PIL import Image
        for frame in frames:
            Image.fromarray(frame).save(self.directory / f"{self.prefix}{self.index:06d}.png")
            self.index += 1

    def finish(self) -> Path:
        return self.directory


class RawSink(VideoSink):
    def __init__(self, path: Path, width: int, height: int, fps: float):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.handle = open(self.path, "wb")
        self.meta = dict(width=width, height=height, fps=fps, format="rgb24", frames=0)

    def write_batch(self, frames: np.ndarray) -> None:
        expect = (self.meta["height"], self.meta["width"])
        if tuple(frames.shape[1:3]) != expect:
            raise ValueError(
                f"RawSink opened for {expect} frames, got {frames.shape[1:3]}")
        self.handle.write(np.ascontiguousarray(frames).data)
        self.meta["frames"] += int(frames.shape[0])

    def finish(self) -> Path:
        self.handle.close()
        self.path.with_suffix(self.path.suffix + ".json").write_text(json.dumps(self.meta))
        return self.path
