"""
ShaderVideo — a video file as a texture.

Port of shaderflow_tpu/video.py. A daemon thread decodes frames ahead
(io/ffmpeg.py: the ffmpeg rawvideo rgb24 pipe, or OpenCV without a
binary) into a bounded queue; update() writes the next frame into a u8
texture each time scene time passes its due time. The texture is
streamed: the engine snapshots its u8 wire twin each frame and sends the
batch's frames to the card in the flush's one staged copy (StagingPool),
normalized there (engine.normalize_u8).
"""

from __future__ import annotations

import atexit
import queue
import threading
import weakref
from pathlib import Path
from typing import Optional

import numpy as np

from shaderflow_tpu_torch import logger
from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
from shaderflow_tpu_torch.module import ShaderModule
from shaderflow_tpu_torch.texture import ShaderTexture


_LIVE: "weakref.WeakSet[FramePrefetcher]" = weakref.WeakSet()


@atexit.register
def _close_live() -> None:
    """Stop the decoders still running when the interpreter exits: a daemon
    thread frozen inside a native decoder aborts the process."""
    for prefetcher in list(_LIVE):
        prefetcher.close()


class FramePrefetcher:
    """Decode-ahead worker for a frame iterator: a daemon thread puts up to
    `depth` decoded frames into a bounded queue, so decoding overlaps the
    render and memory stays depth x H x W x 3 bytes. close() stops the
    thread, also while it waits on a full queue, and waits for it."""

    def __init__(self, iterator, depth: int = 16):
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._finished = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(iterator,), daemon=True,
            name="shaderflow-video-prefetch")
        self._thread.start()
        _LIVE.add(self)

    def _run(self, iterator) -> None:
        try:
            for frame in iterator:
                while not self._stop.is_set():
                    try:
                        self._queue.put(frame, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except Exception as error:  # a decode error ends the stream
            logger.warn(f"Video decode stopped: {error}")
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:   # a generator's finally ends its decoder
                close()
            self._finished.set()

    def next(self) -> np.ndarray:
        """The next decoded frame; StopIteration at the end of the stream."""
        while True:
            try:
                return self._queue.get(timeout=0.1)
            except queue.Empty:
                if self._finished.is_set() and self._queue.empty():
                    raise StopIteration

    def close(self, timeout: float = 5.0) -> None:
        """Stop the worker and wait for it (up to `timeout` s): it ends its
        decoder (a generator's finally: the ffmpeg process, the OpenCV
        capture) before the interpreter can exit under it."""
        self._stop.set()
        # Unblock a producer waiting on a full queue
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)


class ShaderVideo(ShaderModule):
    """A video's frames in the (width x height, 3 components, u8) texture
    named `name`, one frame each 1 / fps of scene time."""

    def __init__(self, scene=None, name: str = "iVideo", *, path=None,
                 width: Optional[int] = None, height: Optional[int] = None,
                 fps: Optional[float] = None, **kwargs):
        self.path = Path(path) if path else None
        self._request = (width, height, fps)
        self._reader = None
        self._frames = 0
        self.texture: Optional[ShaderTexture] = None
        super().__init__(scene=scene, name=name, **kwargs)

    def build(self) -> None:
        width, height, fps = self._request
        if self.path is not None:
            if not all((width, height)):
                size = FFmpeg.get_video_resolution(self.path)
                if size is None:
                    logger.warn(f"Could not probe video {self.path}")
                    size = (1280, 720)
                width, height = size
            fps = fps or FFmpeg.get_video_framerate(self.path) or 30.0
            self._reader = FramePrefetcher(FFmpeg.iter_video_frames(self.path))
        self.width = int(width or 1280)
        self.height = int(height or 720)
        self.fps = float(fps or 30.0)
        self.texture = ShaderTexture(scene=self.scene, name=self.name, width=self.width,
                                     height=self.height, dtype=np.uint8, components=3)

    def setup(self) -> None:
        if self.path is not None:
            if isinstance(self._reader, FramePrefetcher):
                self._reader.close()
            self._reader = FramePrefetcher(FFmpeg.iter_video_frames(self.path))
            self._frames = 0

    def update(self) -> None:
        if self._reader is None:
            return
        # Write only when a new content frame is due
        while self.scene.time > (self._frames / self.fps):
            try:
                frame = self._reader.next()
            except StopIteration:
                self._reader = None
                return
            self.texture.roll()
            # write() takes GL's bottom-up rows: the top-down frame goes in
            # flipped (a view; the texture keeps the decoded bytes)
            self.texture.write(frame[::-1])
            self._frames += 1

    def destroy(self) -> None:
        if isinstance(self._reader, FramePrefetcher):
            self._reader.close()
            self._reader = None

    @property
    def duration(self) -> float:
        if self.path is None:
            return 0.0
        return FFmpeg.get_video_duration(self.path) or 0.0
