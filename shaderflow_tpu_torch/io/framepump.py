"""
The frame pump: an ordered, asynchronous writer of frames to a file
descriptor, so an export renders the next batch while the encoder still
takes this one (FFmpegSink's `turbo`, `buffers` slots).

    pump = FramePump(fd, slot_size=frame_bytes, slots=5)
    pump.submit(frame)     # copies into a free slot and returns
    pump.flush()           # waits until every submitted frame is written
    pump.close()           # flush, stop the writer; raises on a failed write

The native pump (framepump.cpp beside this file) is built with g++ at
first use into BUILD_DIR (build.cxx_library) and bound with ctypes. A
failed build raises: the Python writer thread (native=False) runs only
when it is asked for. Both hold `slots` frames: with every slot taken,
submit waits until the writer frees one. A failed write raises
BrokenPipeError (with the errno) on the next submit, flush or close.
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).parent / "framepump.cpp"
_LIBRARY: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """Build (once, when missing or stale) and bind libframepump.so."""
    global _LIBRARY
    if _LIBRARY is None:
        from shaderflow_tpu_torch.build import cxx_library
        library = cxx_library(SOURCE)
        library.pump_create.restype = ctypes.c_void_p
        library.pump_create.argtypes = [ctypes.c_int, ctypes.c_size_t, ctypes.c_int]
        for name in ("pump_flush", "pump_error", "pump_destroy"):
            getattr(library, name).restype = ctypes.c_long
            getattr(library, name).argtypes = [ctypes.c_void_p]
        library.pump_submit.restype = ctypes.c_long
        library.pump_submit.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        _LIBRARY = library
    return _LIBRARY


def _raise_on(status: int) -> None:
    if status != 0:
        raise BrokenPipeError(-status, f"framepump write failed: {os.strerror(-status)}")


class FramePump:
    """Ordered asynchronous writer of frames of at most `slot_size` bytes
    to `fd`, `slots` of them in flight."""

    def __init__(self, fd: int, slot_size: int, slots: int = 5, native: bool = True):
        self.fd = fd
        self.slot_size = int(slot_size)
        self.slots = max(1, int(slots))
        self._native: Optional[tuple] = None
        self._python: Optional[_PythonPump] = None
        if native:
            library = _library()
            handle = library.pump_create(fd, self.slot_size, self.slots)
            if not handle:
                raise ValueError(f"pump_create refused fd {fd}, slot_size {self.slot_size}, "
                                 f"slots {self.slots}")
            self._native = (library, ctypes.c_void_p(handle))
        else:
            self._python = _PythonPump(fd, self.slots)

    @property
    def is_native(self) -> bool:
        return self._native is not None

    def submit(self, data) -> None:
        """Queue one frame (any C-contiguous buffer); returns once it is
        copied into a slot, so the caller may reuse its buffer at once."""
        array = np.ascontiguousarray(data if isinstance(data, np.ndarray)
                                     else np.frombuffer(data, np.uint8))
        if array.nbytes > self.slot_size:
            raise ValueError(f"frame of {array.nbytes} bytes over the pump's slots of "
                             f"{self.slot_size}")
        if self._native is not None:
            library, handle = self._native
            _raise_on(library.pump_submit(handle, ctypes.c_void_p(array.ctypes.data),
                                          array.nbytes))
        elif self._python is not None:
            self._python.submit(array.tobytes())
        else:
            raise ValueError("the frame pump is closed")

    def flush(self) -> None:
        if self._native is not None:
            library, handle = self._native
            _raise_on(library.pump_flush(handle))
        elif self._python is not None:
            self._python.flush()

    def close(self) -> None:
        """Write what is queued, stop the writer; raises if a write failed."""
        if self._native is not None:
            library, handle = self._native
            self._native = None
            _raise_on(library.pump_destroy(handle))
        elif self._python is not None:
            pump, self._python = self._python, None
            pump.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _PythonPump:
    """The writer in Python: one thread and a queue, `slots` frames held
    (a semaphore: a slot is free again once its frame is written)."""

    def __init__(self, fd: int, slots: int):
        self.fd = fd
        self._free = threading.Semaphore(slots)
        self._queue: "queue.Queue[Optional[bytes]]" = queue.Queue()
        self._error: Optional[OSError] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while (data := self._queue.get()) is not None:
            try:
                view = memoryview(data)
                while self._error is None and view.nbytes:
                    view = view[os.write(self.fd, view):]
            except OSError as error:
                self._error = error
            finally:
                self._free.release()
                self._queue.task_done()
        self._queue.task_done()

    def _check(self) -> None:
        if self._error is not None:
            raise BrokenPipeError(self._error.errno,
                                  f"framepump write failed: {self._error.strerror}")

    def submit(self, data: bytes) -> None:
        self._check()
        self._free.acquire()
        self._check()
        self._queue.put(data)

    def flush(self) -> None:
        self._queue.join()
        self._check()

    def close(self) -> None:
        self._queue.put(None)
        self._thread.join()
        self._check()
