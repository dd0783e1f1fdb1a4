"""Latest-frame-wins device->host transfer worker for the realtime preview.

Port of shaderflow_tpu/io/displaypump.py. The realtime loop offers every
dispatched frame batch and picks up the newest completed host frame,
never blocking: a transfer slower than the frame period drops frames
(latest wins) instead of stalling scene time, input and audio.

On the card the worker copies the newest frame of a batch on its own CUDA
stream into page-locked host buffers (a ring of three per shape, so a
frame handed to the window is not overwritten by the next transfer). Its
waits use blocking events: the thread sleeps instead of spinning beside
the render loop's launches. The
engine allocates each flush's frames from PyTorch's caching allocator: the
worker records its stream on the frame (record_stream) and holds the
batch until its copy has completed, so the memory is not handed to a
later flush while the copy is in flight (a torn frame).

The reference's two remote-link defenses are kept as it decides them:
a duty cycle (after a transfer longer than 5 ms the worker idles so that
transfers take at most SHADERFLOW_DISPLAY_DUTY, default 0.35, of the
time) and adaptive decimation (when a full frame takes longer than
SHADERFLOW_DISPLAY_MS, default 150 ms, the next transfers stride the frame
on the device by the smallest power of two <= 8 that fits). Where a frame
crosses well inside both limits, as on a local PCIe link, both stay idle.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch


class DisplayPump:

    RING = 3

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._handle: Optional[tuple] = None    # (frames, ready event, tag) not yet started
        self._result: Optional[np.ndarray] = None  # newest completed host frame
        self._result_tag: Any = None
        self._stop = False
        self._duty = float(os.environ.get("SHADERFLOW_DISPLAY_DUTY", "0.35"))
        self._target_s = float(os.environ.get("SHADERFLOW_DISPLAY_MS", "150")) / 1e3
        self.decimate = 1                 # current device-side stride
        self._warm_sig = None             # last (decimate, shape) fetched
        self._stream: Optional[torch.cuda.Stream] = None
        self._host: dict = {}             # (shape, device) -> [pinned buffers], next index
        # Counters: batches offered, replaced before their transfer started
        # (dropped), transferred, frames taken; the last transfers' seconds
        self.offered = self.dropped = self.transferred = self.taken = 0
        self.transfer_times: deque = deque(maxlen=256)
        self.shown_tag: Any = None        # the tag of the frame take() returned last
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="shaderflow-display")
        self._thread.start()

    def offer(self, frames: Any, tag: Any = None) -> None:
        """Hand the newest dispatched (N, H, W, 3) batch to the pump; it
        replaces a batch whose transfer has not started (latest wins).
        `tag` comes back as shown_tag with its frame. Never blocks."""
        ready = None
        if isinstance(frames, torch.Tensor) and frames.is_cuda:
            ready = torch.cuda.Event(blocking=True)
            ready.record(torch.cuda.current_stream(frames.device))
        with self._cv:
            if self._handle is not None:
                self.dropped += 1
            self._handle = (frames, ready, tag)
            self.offered += 1
            self._cv.notify()

    def take(self) -> Optional[np.ndarray]:
        """The newest completed host frame, or None when no transfer
        finished since the last take. Never blocks."""
        with self._cv:
            result, self._result = self._result, None
            if result is not None:
                self.taken += 1
                self.shown_tag = self._result_tag
            return result

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=5.0)

    def reserve(self, frame: Any) -> None:
        """Make the copy stream and the page-locked ring for frames like
        `frame` (one CUDA frame) now, on the caller's thread: both stall
        the CUDA context (and page-locking the caller), so the loop pays them
        once, at a tick of its choosing, instead of at a transfer racing
        the render."""
        if isinstance(frame, torch.Tensor) and frame.is_cuda:
            if self._stream is None:
                self._stream = torch.cuda.Stream(frame.device)
            self._ring(tuple(frame.shape), frame.dtype)

    def _ring(self, shape: tuple, dtype) -> list:
        key = (shape, dtype)
        if key not in self._host:
            self._host[key] = [[torch.empty(shape, dtype=dtype, pin_memory=True)
                                for _ in range(self.RING)], 0]
        return self._host[key]

    def _host_buffer(self, frame: torch.Tensor) -> torch.Tensor:
        ring = self._ring(tuple(frame.shape), frame.dtype)
        buffers, index = ring
        ring[1] = (index + 1) % self.RING
        return buffers[index]

    def _fetch(self, frames: Any) -> np.ndarray:
        """The newest frame of the batch on the host, strided on the device
        when the link cannot move a full frame within the budget."""
        k = self.decimate
        frame = frames[-1]
        if k > 1:
            try:
                frame = frame[::k, ::k, :]
            except Exception:
                pass   # not sliceable: transfer it whole
        if isinstance(frame, torch.Tensor):
            if not frame.is_cuda:
                return frame.numpy().copy()
            host = self._host_buffer(frame)
            with torch.cuda.device(frame.device):
                if self._stream is None:
                    self._stream = torch.cuda.Stream(frame.device)
                with torch.cuda.stream(self._stream):
                    frame.record_stream(self._stream)
                    host.copy_(frame, non_blocking=True)
                    done = torch.cuda.Event(blocking=True)
                    done.record(self._stream)
            done.synchronize()
            return host.numpy()
        return np.asarray(frame)

    def _adapt(self, seconds: float, host: np.ndarray) -> None:
        """The next transfer's decimation from this one's time: the
        smallest power-of-2 stride whose full-frame estimate (measured
        time x current k^2) fits the budget."""
        if seconds <= 0 or host.nbytes == 0:
            return
        full_s = seconds * (self.decimate ** 2)
        k = 1
        while k < 8 and full_s / (k * k) > self._target_s:
            k *= 2
        self.decimate = k

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._handle is None and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                (frames, ready, tag), self._handle = self._handle, None
            # The render must complete before timing: the decimation reads
            # link time, not device compute
            if ready is not None:
                ready.synchronize()
            sig = (self.decimate, getattr(frames, "shape", None))
            started = time.perf_counter()
            host = self._fetch(frames)    # blocks this thread only
            took = time.perf_counter() - started
            del frames                    # the copy has completed: release the batch
            with self._cv:
                self._result = host
                self._result_tag = tag
                self.transferred += 1
                self.transfer_times.append(took)
            if sig == self._warm_sig:
                self._adapt(took, host)
            else:
                # The first transfer of a (decimate, shape) pays one-time
                # setup (buffers, the stream): never adapt on it
                self._warm_sig = sig
            # Duty cycle: idle so transfers leave the link to the renders
            # (interruptible by close())
            if took > 5e-3 and 0.0 < self._duty < 1.0:
                deadline = time.perf_counter() + took * (1.0 / self._duty - 1.0)
                with self._cv:
                    while not self._stop:
                        left = deadline - time.perf_counter()
                        if left <= 0:
                            break
                        self._cv.wait(timeout=left)
                    if self._stop:
                        return
