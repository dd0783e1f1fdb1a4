"""
Video sinks: where rendered uint8 frame batches go (the offline sinks of
shaderflow_tpu/io/sinks.py).

  FFmpegSink  - rawvideo frames written to an FFmpeg subprocess's stdin
                (its encoded stdout returned in memory with pipe_output)
  CV2Sink     - OpenCV VideoWriter (mp4 without an ffmpeg binary)
  ImageSink   - numbered PNG frames
  RawSink     - headerless .rgb dump + sidecar metadata
  PipeSink    - raw rgb24 bytes returned in memory (output="pipe")
  TCPSink     - raw rgb24 bytes streamed to a TCP endpoint (tcp://host:port)
  NullSink    - swallow frames (render throughput)

FFmpegSink hands each frame to the frame pump (io/framepump.py, `turbo`),
which writes `buffers` slots to the encoder's stdin on a thread of its own
while the export renders on; turbo=False writes stdin from the export
loop's thread.
"""

from __future__ import annotations

import json
from pathlib import Path
from subprocess import PIPE, TimeoutExpired
from tempfile import TemporaryFile
from typing import Optional, Union

import numpy as np

from shaderflow_tpu_torch import logger
from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
from shaderflow_tpu_torch.io.framepump import FramePump


class VideoSink:
    """Consumes (F, H, W, 3) uint8 frame batches."""

    def write_batch(self, frames: np.ndarray) -> None:
        raise NotImplementedError

    def finish(self) -> Optional[Union[Path, bytes, str]]:
        """Flush and close; returns the output path, URL or bytes."""
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
    """Rawvideo frames piped to an FFmpeg subprocess: with `turbo`, frame by
    frame through the frame pump (`buffers` slots of `frame_bytes`), else
    written to stdin directly. Process death is detected per batch, and a
    write that fails (the encoder gone: EPIPE) raises with the encoder's
    captured stderr. pipe_output=True collects the encoder's stdout, which
    finish returns."""

    def __init__(self, ffmpeg: FFmpeg, frame_bytes: int, buffers: int = 5, turbo: bool = True,
                 pipe_output: bool = False):
        self.ffmpeg = ffmpeg
        self.pipe_output = pipe_output
        self.stdout = TemporaryFile(mode="w+b") if pipe_output else None
        self.stderr = TemporaryFile(mode="w+b")
        self.process = ffmpeg.popen(stdin=PIPE, stdout=self.stdout, stderr=self.stderr)
        self.pump: Optional[FramePump] = None
        if turbo:
            self.pump = FramePump(self.process.stdin.fileno(), frame_bytes, slots=buffers)

    def _encoder_error(self) -> RuntimeError:
        """The encoder's death as an error carrying its captured stderr
        (waiting for it to exit, so all of it is there)."""
        try:
            self.process.wait(timeout=10)
        except TimeoutExpired:
            pass
        self.stderr.seek(0)
        return RuntimeError("FFmpeg process closed unexpectedly with traceback:\n"
                            + self.stderr.read().decode("utf-8", "replace"))

    def _check_alive(self) -> None:
        if self.process.poll() is not None:
            raise self._encoder_error()

    def write_batch(self, frames: np.ndarray) -> None:
        self._check_alive()
        try:
            if self.pump is not None:
                for frame in frames:
                    self.pump.submit(frame)
            else:
                self.process.stdin.write(np.ascontiguousarray(frames).data)
        except BrokenPipeError as error:
            raise self._encoder_error() from error

    def finish(self) -> Optional[Union[Path, bytes]]:
        try:
            if self.pump is not None:
                pump, self.pump = self.pump, None
                pump.close()
            self.process.stdin.close()
        except BrokenPipeError as error:
            raise self._encoder_error() from error
        self.process.wait()
        self.stderr.close()
        if self.pipe_output:
            self.stdout.seek(0)
            encoded = self.stdout.read()
            self.stdout.close()
            return encoded
        for output in self.ffmpeg.outputs:
            path = getattr(output, "path", None)
            if path is not None:
                return Path(path)
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


class PipeSink(VideoSink):
    """Raw rgb24 frames collected in memory (output "pipe", "-" or bytes
    without an ffmpeg binary); finish returns them."""

    def __init__(self):
        self.chunks: list[bytes] = []

    def write_batch(self, frames: np.ndarray) -> None:
        self.chunks.append(np.ascontiguousarray(frames).tobytes())

    def finish(self) -> bytes:
        return b"".join(self.chunks)


class TCPSink(VideoSink):
    """Raw rgb24 frames streamed to a TCP endpoint (output "tcp://host:port"
    without an ffmpeg binary; with one, the encoder connects to the URL
    itself); finish half-closes the socket, so the peer reads an EOF, and
    returns the URL."""

    def __init__(self, url: str):
        import socket
        from urllib.parse import urlparse
        parsed = urlparse(url)
        self.url = url
        self.sock = socket.create_connection((parsed.hostname, parsed.port), timeout=10.0)
        self.frames = 0

    def write_batch(self, frames: np.ndarray) -> None:
        self.sock.sendall(np.ascontiguousarray(frames).data)
        self.frames += int(frames.shape[0])

    def finish(self) -> str:
        try:
            self.sock.shutdown(1)   # SHUT_WR: the peer reads an EOF
        except OSError:
            pass
        self.sock.close()
        return self.url
