"""
Waveform oscilloscope bars.

Port of shaderflow_tpu/audio/waveform.py: the last `length` seconds of
audio reduced into `length * samplerate` bars (Average / RMS / STD chunk
reducers), a (1, points, channels) texture per frame. Offline exports
compute every frame's bars once on the scene's device
(ops/spectral.waveform_batch) and bind them as a device sequence; in
realtime each frame reduces the rolling buffer on the host and writes the
bars, which the engine streams.
"""

from __future__ import annotations

import time
from enum import Enum
from typing import Optional

import numpy as np
import torch

from shaderflow_tpu_torch.audio import BrokenAudio
from shaderflow_tpu_torch.module import ShaderModule
from shaderflow_tpu_torch.ops import spectral
from shaderflow_tpu_torch.texture import ShaderTexture
from shaderflow_tpu_torch.variable import Uniform


class WaveformReducer(Enum):
    Average = "average"
    RMS = "rms"
    STD = "std"

    @property
    def fn(self):
        return {
            WaveformReducer.Average: spectral.waveform_average,
            WaveformReducer.RMS: spectral.waveform_rms,
            WaveformReducer.STD: spectral.waveform_std,
        }[self]


class ShaderWaveform(ShaderModule):

    def __init__(self, scene=None, name: str = "iWaveform", *,
                 audio: Optional[BrokenAudio] = None, length: float = 3,
                 samplerate: float = 60, reducer: WaveformReducer = WaveformReducer.Average,
                 smooth: bool = True, **kwargs):
        self.audio = audio
        self.length = length
        self.samplerate = samplerate
        self.reducer = WaveformReducer(reducer)
        self.smooth = smooth
        self.texture: Optional[ShaderTexture] = None
        self._precomputed: Optional[torch.Tensor] = None  # (F, 1, points, C)
        self._precompute_key = None
        self._precompute_value = None
        # {"run": seconds} of the last whole-export precompute, the device's
        # work included (coldstart.py reads it)
        self.precompute_timings: dict[str, float] = {}
        super().__init__(scene=scene, name=name, **kwargs)

    def build(self) -> None:
        self.texture = ShaderTexture(
            scene=self.scene,
            name=self.name,
            filter=("linear" if self.smooth else "nearest"),
            components=self.audio.channels,
            width=self._points,
            height=1,
            dtype=np.float32,
        ).repeat(False)

    @property
    def length_samples(self) -> int:
        return int(max(1, self.length * self.scene.fps))

    @property
    def _points(self) -> int:
        return int(self.length * self.samplerate)

    @property
    def chunk_size(self) -> int:
        return max(1, int(self.length * self.audio.samplerate / self._points))

    @property
    def _offset(self) -> int:
        return self.audio.tell % self.chunk_size

    def setup(self) -> None:
        self._precomputed = None
        self.texture.set_sequence(None)

    def _precompute(self) -> Optional[torch.Tensor]:
        """Every frame's bars on the scene's device: (F, 1, points, C)."""
        full = self.audio.full_data
        if full is None and hasattr(self.audio, "load_full_file"):
            full = self.audio.load_full_file()
        if full is None:
            return None
        scene = self.scene
        fps = scene.fps
        total = max(1, round(scene.runtime * fps))
        chunk = self.chunk_size
        tells = np.round(np.arange(total) * self.audio.samplerate / fps).astype(np.int64)
        ends = tells - (tells % chunk)  # the chunk-aligned cursor
        audio = torch.from_numpy(np.ascontiguousarray(full, np.float32)).to(scene.device)
        bars = spectral.waveform_batch(audio, torch.from_numpy(ends).to(scene.device),
                                       self._points, chunk, self.reducer.fn)
        return bars[:, None, :, :].contiguous()

    def _precompute_cached(self) -> Optional[torch.Tensor]:
        key = (self.audio.file, self.audio.samplerate,
               round(self.scene.runtime * self.scene.fps), self._points,
               self.chunk_size, self.reducer, str(self.scene.device))
        if self._precompute_key == key and self._precompute_value is not None:
            return self._precompute_value
        started = time.perf_counter()
        self._precompute_value = self._precompute()
        if self._precompute_value is not None:
            if self._precompute_value.device.type == "cuda":
                torch.cuda.synchronize(self._precompute_value.device)
            self.precompute_timings = {"run": time.perf_counter() - started}
        self._precompute_key = key
        return self._precompute_value

    def prewarm(self) -> None:
        if self.scene.freewheel:
            self._precompute_cached()

    def update(self) -> None:
        self.texture.components = self.audio.channels
        if self.scene.freewheel and self._precomputed is None:
            bars = self._precompute_cached()
            if bars is not None:
                self.texture.set_sequence(bars)
                self._precomputed = bars
        if self.texture.sequence is not None:
            return

        # Realtime: reduce the rolling buffer's chunk-aligned tail on the host
        start = -int(self.chunk_size * self._points + self._offset + 1)
        end = -int(self._offset + 1)
        chunks = self.audio.data[:, start:end]
        chunks = chunks.reshape(self.audio.channels, -1, self.chunk_size)
        bars = np.ascontiguousarray(np.asarray(self.reducer.fn(chunks)).T)
        self.texture.write(bars.reshape(1, self._points, self.audio.channels))

    def pipeline(self):
        yield Uniform("int", f"{self.name}Length", self.length_samples)
