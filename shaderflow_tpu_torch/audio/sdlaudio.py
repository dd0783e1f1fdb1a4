"""
SDL audio backend: realtime capture and playback without `soundcard`.

Port of shaderflow_tpu/audio/sdlaudio.py. The `soundcard` package is the
preferred realtime backend (audio/__init__.py, BrokenAudio._backend);
where it is absent this module offers the same calls (`all_microphones`,
`all_speakers`, `default_microphone`, `default_speaker`, and the devices'
`.recorder()` / `.player()` context managers) over SDL2's audio subsystem,
which ships inside pygame. On a desktop the samples flow through the
system's sound server; on a machine without one, SDL's `dummy` driver
runs a real audio thread with paced callbacks (silence in, a sink out).

pygame is imported inside the functions that use it: the package imports
without it, and the backend probe (_init_sdl_audio) raises ImportError.

Blocking as soundcard's: `record(n)` waits for n frames from the driver's
callback; `record(None)` returns everything buffered (at least one
block); `play(data)` queues the chunk and blocks only while the device's
queue is full.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import numpy as np

from shaderflow_tpu_torch import logger

AUDIO_F32LSB = 0x8120  # SDL_AudioFormat: 32-bit float, little-endian


def _init_sdl_audio():
    """Initialize SDL's audio subsystem, on the dummy driver when no sound
    server is reachable -> the pygame._sdl2.audio module. Raises
    ImportError without pygame, or SDL's error when no driver starts."""
    import pygame
    import pygame._sdl2.audio as sdl2_audio

    if pygame.get_init() and pygame.mixer.get_init():
        return sdl2_audio
    driver = os.environ.get("SHADERFLOW_SDL_AUDIODRIVER")
    if driver:
        os.environ["SDL_AUDIODRIVER"] = driver
    try:
        pygame.mixer.init()
    except Exception:
        # No reachable sound server: retry on the dummy driver, then restore
        # SDL_AUDIODRIVER, so a later init (or a child process) reaches a
        # sound server that came up meanwhile
        previous = os.environ.get("SDL_AUDIODRIVER")
        os.environ["SDL_AUDIODRIVER"] = "dummy"
        try:
            pygame.mixer.init()
            logger.warn("No sound server reachable; SDL audio running on "
                        "the dummy driver (silence in/out) for this init")
        finally:
            if previous is None:
                os.environ.pop("SDL_AUDIODRIVER", None)
            else:
                os.environ["SDL_AUDIODRIVER"] = previous
    return sdl2_audio


def _sdl_library():
    """SDL2 as pygame loaded it (found by name in this process's memory
    maps) through ctypes, whose calls release the GIL; None where it is
    not found."""
    import ctypes
    try:
        with open("/proc/self/maps") as maps:
            for line in maps:
                path = line.split()[-1] if "/" in line else ""
                if os.path.basename(path).startswith("libSDL2-2"):
                    return ctypes.CDLL(path)
    except OSError:
        pass
    return None


def pause_device(device, pause: bool = True) -> None:
    """Pause (or resume) a pygame AudioDevice with the GIL released. SDL
    pauses under the device's lock, which its audio thread holds while the
    callback waits for the GIL: pygame's own pause(1), holding the GIL,
    deadlocks with a callback in flight."""
    import ctypes
    library = _sdl_library()
    if library is None:
        device.pause(int(pause))
        return
    library.SDL_PauseAudioDevice(ctypes.c_uint32(device.deviceid), ctypes.c_int(int(pause)))


class _SDLRecorder:
    """A capture stream: SDL's callback thread appends blocks under a lock,
    record() drains them. The surface of soundcard's recorder that
    BrokenAudio uses: the context manager, `.record(numframes)` ->
    (frames, channels) float32 in [-1, 1], `._samplerate`."""

    def __init__(self, devicename: Optional[str], samplerate: int,
                 channels: int, blocksize: int):
        sdl2_audio = _init_sdl_audio()
        self._chunks: list[np.ndarray] = []
        self._cond = threading.Condition()
        self._closed = False

        def callback(device, memoryview_bytes):
            block = np.frombuffer(bytes(memoryview_bytes), np.float32)
            with self._cond:
                self._chunks.append(block)
                self._cond.notify_all()

        if devicename is None:  # pygame needs a concrete device name
            names = _device_names(True)
            if not names:
                raise RuntimeError("SDL exposes no audio capture devices")
            devicename = names[0]
        # allowed_changes=0: SDL converts what the driver delivers to the
        # requested f32, rate and channels
        self._device = sdl2_audio.AudioDevice(
            devicename=devicename, iscapture=True,
            frequency=int(samplerate), audioformat=AUDIO_F32LSB,
            numchannels=int(channels), chunksize=int(blocksize),
            allowed_changes=0, callback=callback)
        self._samplerate = float(self._device.frequency)
        self.channels = int(self._device.numchannels)
        self._device.pause(0)

    def __enter__(self) -> "_SDLRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _buffered_frames(self) -> int:
        return sum(len(c) for c in self._chunks) // self.channels

    def record(self, numframes: Optional[int] = None) -> np.ndarray:
        """Block until `numframes` frames arrived (for None: at least one
        driver block) -> (frames, channels) float32; raises TimeoutError
        after 10 s without them."""
        deadline = time.monotonic() + 10.0
        with self._cond:
            while not self._closed:
                have = self._buffered_frames()
                if (have >= numframes) if numframes else (have > 0):
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        "SDL capture produced no data for 10 s (device "
                        "stalled or paused)")
                self._cond.wait(timeout=remaining)
            flat = np.concatenate(self._chunks) if self._chunks else np.zeros(0, np.float32)
            want = (numframes or self._buffered_frames()) * self.channels
            taken, rest = flat[:want], flat[want:]
            self._chunks = [rest] if len(rest) else []
        return taken.reshape(-1, self.channels)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        # Paused, the callback has returned and runs no more: closing is safe
        pause_device(self._device)
        self._device.close()


class _SDLPlayer:
    """A playback stream through pygame.mixer, which owns SDL's playback
    device. play() converts a chunk to the mixer's format and hands it to
    one channel, its queue slot as the stream buffer: it returns at once
    while the device has room (the current chunk and one queued) and
    blocks only on backpressure."""

    def __init__(self, devicename: Optional[str], samplerate: int,
                 channels: int, blocksize: int = 512):
        import pygame
        _init_sdl_audio()
        self._pygame = pygame
        init = pygame.mixer.get_init()
        # The mixer plays on the one device it was initialized with: another
        # requested device is not honored, and says so
        if devicename is not None:
            default = (_device_names(False) or [None])[0]
            if devicename != default:
                logger.warn(f"SDL playback backend uses the mixer's device; "
                            f"requested {devicename!r} is ignored "
                            "(install 'soundcard' for per-device playback)")
        # Chunks are resampled linearly from the caller's rate to the mixer's
        self._samplerate = float(samplerate)
        self._mixer_rate = float(init[0]) if init else 44100.0
        self._mixer_channels = int(init[2]) if init else int(channels)
        self._mixer_size = init[1] if init else -16
        self.channels = int(channels)
        self._channel = pygame.mixer.Channel(0)

    def __enter__(self) -> "_SDLPlayer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def play(self, data: np.ndarray) -> None:
        pygame = self._pygame
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data[:, None]
        # The mixer's channel count: repeat mono, drop extra channels
        if data.shape[1] < self._mixer_channels:
            data = np.repeat(data[:, :1], self._mixer_channels, axis=1)
        elif data.shape[1] > self._mixer_channels:
            data = data[:, :self._mixer_channels]
        if abs(self._samplerate - self._mixer_rate) > 0.5 and len(data) > 1:
            n_out = max(1, int(round(len(data) * self._mixer_rate / self._samplerate)))
            src = np.arange(len(data), dtype=np.float64)
            dst = np.linspace(0.0, len(data) - 1.0, n_out)
            data = np.stack([np.interp(dst, src, data[:, c])
                             for c in range(data.shape[1])], axis=1)
        if self._mixer_size in (-16, 16):
            pcm = (np.clip(data, -1.0, 1.0) * 32767.0).astype(np.int16)
        else:
            pcm = np.ascontiguousarray(data, np.float32)
        sound = pygame.mixer.Sound(buffer=np.ascontiguousarray(pcm).tobytes())
        deadline = time.monotonic() + 10.0 + len(data) / (self._mixer_rate or 44100.0)
        while True:
            if not self._channel.get_busy():
                self._channel.play(sound)
                return
            if self._channel.get_queue() is None:
                self._channel.queue(sound)   # gapless hand-off
                return
            if time.monotonic() > deadline:
                raise TimeoutError("SDL playback stalled for 10 s")
            time.sleep(0.002)

    def drain(self, timeout: float = 10.0) -> None:
        """Block until the device consumed everything queued."""
        deadline = time.monotonic() + timeout
        while self._channel.get_busy():
            if time.monotonic() > deadline:
                raise TimeoutError("SDL playback stalled while draining")
            time.sleep(0.005)

    def close(self) -> None:
        # This channel only: mixer.stop() would stop every channel
        try:
            self._channel.stop()
        except Exception:
            pass


class SDLDevice:
    """One SDL audio device, as a soundcard microphone or speaker: `.name`,
    `.channels`, `.isloopback`, `.recorder()` / `.player()`."""

    def __init__(self, name: str, iscapture: bool):
        self.name = name
        self.iscapture = iscapture
        self.isloopback = "monitor" in name.lower()  # PulseAudio's naming
        self.channels = 2

    def __repr__(self) -> str:
        kind = "microphone" if self.iscapture else "speaker"
        return f"<SDL {kind} {self.name!r}>"

    def recorder(self, samplerate: int = 44100, channels=None,
                 blocksize: int = 512) -> _SDLRecorder:
        return _SDLRecorder(self.name, samplerate, int(channels or self.channels), blocksize)

    def player(self, samplerate: int = 44100, channels=None,
               blocksize: int = 512) -> _SDLPlayer:
        return _SDLPlayer(self.name, samplerate, int(channels or self.channels), blocksize)


def _device_names(iscapture: bool) -> list[str]:
    """SDL's device names (pygame opens devices by name only)."""
    sdl2_audio = _init_sdl_audio()
    try:
        return sdl2_audio.get_audio_device_names(iscapture)
    except Exception as error:
        logger.debug(f"SDL device enumeration failed: {error}")
        return []


def all_microphones(include_loopback: bool = False) -> list[SDLDevice]:
    devices = [SDLDevice(n, True) for n in _device_names(True)]
    if not include_loopback:
        devices = [d for d in devices if not d.isloopback]
    return devices


def all_speakers() -> list[SDLDevice]:
    return [SDLDevice(n, False) for n in _device_names(False)]


def _default_device(iscapture: bool) -> SDLDevice:
    names = _device_names(iscapture)
    if not names:
        raise RuntimeError(
            f"SDL exposes no audio {'capture' if iscapture else 'playback'} "
            "devices (driver cannot enumerate)")
    return SDLDevice(names[0], iscapture)


def default_microphone() -> SDLDevice:
    return _default_device(True)


def default_speaker() -> SDLDevice:
    return _default_device(False)
