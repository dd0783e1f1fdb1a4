"""
Spectrogram: natural-scale banded STFT feeding a shader texture.

Port of shaderflow_tpu/audio/spectrogram.py. A windowed rFFT over the last
2^n samples, pluggable magnitude / window / interpolation strategies,
center frequencies on an Octave or MEL scale, a Whittaker-Shannon band
matrix mapping FFT bins to spectrogram bins, and second-order smoothing.
In offline exports the whole trajectory is computed once, before the first
frame, on the scene's device: a batched rFFT, one band matrix product and
the dynamics scan; each frame then reads its row of the device sequence
(texture.set_sequence). In realtime each frame runs the reference's host
path in numpy: an rFFT of the rolling buffer's last 2^n samples
(next_columns), one dynamics step, and a host write of the column into
the texture at the scrolling offset, which the engine streams.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from shaderflow_tpu_torch import logger
from shaderflow_tpu_torch.audio import BrokenAudio
from shaderflow_tpu_torch.module import ShaderModule, UIField
from shaderflow_tpu_torch.ops import dynamics as dyn
from shaderflow_tpu_torch.ops import spectral
from shaderflow_tpu_torch.ops.dynamics import DynamicNumber
from shaderflow_tpu_torch.piano.notes import PianoNote
from shaderflow_tpu_torch.texture import ShaderTexture
from shaderflow_tpu_torch.variable import Uniform


class FourierMagnitude:
    Amplitude = staticmethod(spectral.magnitude_amplitude)
    Power = staticmethod(spectral.magnitude_power)

class FourierVolume:
    dBFS = staticmethod(spectral.volume_dbfs)
    Sqrt = staticmethod(spectral.volume_sqrt)
    Linear = staticmethod(spectral.volume_linear)
    dBFsTremx = staticmethod(spectral.volume_dbfs_tremx)

class SpectrogramInterpolation:
    Euler = staticmethod(spectral.interpolation_euler(end=1.2))
    Dirac = staticmethod(spectral.interpolation_dirac)
    Sinc = staticmethod(spectral.interpolation_sinc)
    make_euler = staticmethod(spectral.interpolation_euler)

class SpectrogramScale:
    Octave = spectral.SCALE_OCTAVE
    MEL = spectral.SCALE_MEL

class SpectrogramWindow:
    hanning = staticmethod(spectral.hanning)
    hann_poisson = staticmethod(spectral.hann_poisson)
    none = staticmethod(spectral.no_window)


class BrokenSpectrogram:
    """Core math: FFT sizing, the band matrix, the per-frame host FFT."""

    def __init__(self, audio: Optional[BrokenAudio] = None, *, fft_n: int = 12,
                 sample_rateio: int = 1):
        self.audio = audio or BrokenAudio()
        self.fft_n = int(fft_n)
        self.sample_rateio = int(sample_rateio)
        self.scale = SpectrogramScale.Octave
        self.interpolation: Callable = SpectrogramInterpolation.Euler
        self.magnitude: Callable = FourierMagnitude.Power
        self.window: Callable = SpectrogramWindow.hanning
        self.volume: Callable = FourierVolume.Sqrt
        self.minimum_frequency: float = 20.0
        self.maximum_frequency: float = 20000.0
        self.spectrogram_bins: int = 1000
        self._matrix_cache: Optional[np.ndarray] = None

    @property
    def fft_size(self) -> int:
        return int(2 ** self.fft_n * self.sample_rateio)

    @property
    def fft_bins(self) -> int:
        return int(self.fft_size / 2 + 1)

    @property
    def fft_frequencies(self) -> np.ndarray:
        return np.fft.rfftfreq(self.fft_size, 1 / (self.audio.samplerate * self.sample_rateio))

    def fft(self) -> np.ndarray:
        """Per-frame host path: the windowed rFFT magnitude of the rolling
        buffer's last 2^n samples (upsampled by sample_rateio)."""
        data = self.audio.get_last_n_samples(int(2 ** self.fft_n))
        if self.sample_rateio != 1:
            data = spectral.sinc_upsample(np.asarray(data, np.float32), self.sample_rateio)
        window = self.window(self.fft_size)
        return np.asarray(self.magnitude(np.fft.rfft(window * data))).astype(np.float32)

    def next_columns(self) -> np.ndarray:
        """One frame's (channels, bins) spectrogram (host path)."""
        return self.spectrogram_matrix().dot(self.fft().T).T

    @property
    def spectrogram_frequencies(self) -> np.ndarray:
        key = (self.minimum_frequency, self.maximum_frequency, self.spectrogram_bins)
        cached = getattr(self, "_freq_cache", None)
        if cached is None or cached[0] != key:
            self._freq_cache = (key, spectral.scale_frequencies(
                self.minimum_frequency, self.maximum_frequency,
                self.spectrogram_bins, self.scale))
        return self._freq_cache[1]

    def spectrogram_matrix(self) -> np.ndarray:
        """(bins x fft_bins) dense Whittaker-Shannon band matrix."""
        if self._matrix_cache is None:
            self._matrix_cache = spectral.band_matrix(
                self.spectrogram_frequencies, self.fft_bins,
                float(self.fft_frequencies[1]), self.interpolation)
        return self._matrix_cache

    def from_notes(self, start, end, bins: int = 1000, piano: bool = False,
                   tuning: float = 440) -> "BrokenSpectrogram":
        start = PianoNote.get(start, tuning=tuning)
        end = PianoNote.get(end, tuning=tuning)
        logger.info(f"Making Spectrogram Piano Matrix from notes ({start.name} - {end.name})")
        self.minimum_frequency = start.frequency
        self.maximum_frequency = end.frequency
        if not piano:
            self.spectrogram_bins = bins
        else:
            # Advertised bins start and end exactly on notes
            half_semitone = 2 ** (0.5 / 12)
            self.spectrogram_bins = (end.note - start.note) + 1
            self.minimum_frequency /= half_semitone
            self.maximum_frequency *= half_semitone
        self._matrix_cache = None
        return self


class ShaderSpectrogram(BrokenSpectrogram, ShaderModule):

    def __init__(self, scene=None, name: str = "iSpectrogram", *,
                 audio: Optional[BrokenAudio] = None, length: float = 5,
                 smooth: bool = False, scrolling: bool = False,
                 fft_n: int = 12, sample_rateio: int = 1, **kwargs):
        BrokenSpectrogram.__init__(self, audio=audio, fft_n=fft_n, sample_rateio=sample_rateio)
        self.length = length
        self.smooth = smooth
        self.scrolling = scrolling
        self.offset = 0
        self.dynamics = DynamicNumber(frequency=4, zeta=1, response=0, dtype=np.float32)
        self.texture: Optional[ShaderTexture] = None
        self._precomputed: Optional[torch.Tensor] = None  # (F, bins, 1, C) smoothed
        self._precompute_key = None
        self._precompute_value = None
        # {"run": seconds} of the last whole-export precompute, the device's
        # work included (coldstart.py reads it)
        self.precompute_timings: dict[str, float] = {}
        ShaderModule.__init__(self, scene=scene, name=name, **kwargs)
        self.texture = ShaderTexture(
            scene=self.scene, name=self.name, dtype=np.float32, repeat_y=False)

    @property
    def length_samples(self) -> int:
        return int(max(1, self.length * self.scene.fps))

    def setup(self) -> None:
        self.offset = 0
        self._precomputed = None
        self.texture.set_sequence(None)
        self.dynamics.set(np.zeros((self.audio.channels, self.spectrogram_bins), np.float32))

    def load_state(self, state: dict) -> None:
        """Carry a reference run's realtime state (engine.load_reference_state):
        "value", "derivative", "previous" and "target" of the dynamics,
        (channels, bins) each, and "offset", the scrolling column."""
        unknown = set(state) - {"value", "derivative", "previous", "target", "offset"}
        if unknown:
            raise KeyError(f"ShaderSpectrogram carries no state named {sorted(unknown)}")
        for name in ("value", "derivative", "previous", "target"):
            if name in state:
                setattr(self.dynamics, name, np.array(state[name], np.float32))
        if "offset" in state:
            self.offset = int(state["offset"])

    # -- offline batched precompute -------------------------------------------

    def _precompute(self) -> Optional[torch.Tensor]:
        """Whole-export spectrogram on the scene's device: batched STFT, band
        matrix product and dynamics scan -> (F, bins, 1, C) in texture layout
        (storage row 0 = top = the highest bin)."""
        full = self.audio.full_data
        if full is None and hasattr(self.audio, "load_full_file"):
            full = self.audio.load_full_file()
        if full is None:
            return None
        scene = self.scene
        device = scene.device
        fps = scene.fps
        total = max(1, round(scene.runtime * fps))
        smoothing_dt = abs(scene.speed) / fps or 1.0 / fps
        ends = np.round(np.arange(total) * self.audio.samplerate / fps).astype(np.int32)
        offsets = torch.from_numpy(ends - int(2 ** self.fft_n)).to(device)
        window = np.asarray(self.window(self.fft_size), np.float32)
        matrix = np.asarray(self.spectrogram_matrix(), np.float32)
        audio = torch.from_numpy(np.ascontiguousarray(full, np.float32)).to(device)
        banded = spectral.spectrogram_batch(
            audio, offsets, self.fft_size, window, matrix,
            magnitude=self.magnitude, upsample=self.sample_rateio)   # (F, C, bins)
        flat = banded.reshape(total, -1)
        # Per-frame smoothing at the scene dt (speed / fps)
        smoothed = dyn.scan(flat, torch.zeros(flat.shape[1], device=device),
                            smoothing_dt, frequency=4.0, zeta=1.0, response=0.0)
        columns = smoothed.reshape(banded.shape).permute(0, 2, 1)    # (F, bins, C)
        logger.info(f"Precomputed {total} spectrogram frames on {device} "
                    f"({self.spectrogram_bins} bins x {columns.shape[2]} channels)")
        return columns.flip(1)[:, :, None, :].contiguous()

    def _precompute_cached(self) -> Optional[torch.Tensor]:
        """Re-running the same export does not pay the whole-file STFT again:
        the device tensor survives setup(), keyed by everything that shapes it."""
        key = (self.audio.file, self.audio.samplerate,
               round(self.scene.runtime * self.scene.fps), self.scene.speed,
               self.fft_n, self.sample_rateio, self.spectrogram_bins,
               self.length_samples, type(self.magnitude).__name__, self.smooth,
               str(self.scene.device))
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

    # -- per-frame update ------------------------------------------------------

    def update(self) -> None:
        self.texture.components = self.audio.channels
        self.texture.filter = "linear" if self.smooth else "nearest"
        self.texture.resolution = (self.length_samples, self.spectrogram_bins)

        if self.scene.freewheel and self._precomputed is None:
            columns = self._precompute_cached()
            if columns is not None:
                # length > 1 (scrolling texture): a ring sequence, the engine
                # builds the ring of the last L columns per frame
                window = self.length_samples if self.length_samples > 1 else None
                self.texture.set_sequence(columns, window=window)
                self._precomputed = columns

        self.offset = (self.offset + 1) % self.length_samples
        if self.texture.sequence is not None:
            return   # the frame reads its row of the device sequence

        # Realtime: one host column a frame, written at the scrolling offset.
        # The dynamics run in the (channels, bins) layout (the reference's
        # C-order reshape interleaves bins across channels; its evident
        # intent is kept)
        row_shape = (self.audio.channels, self.spectrogram_bins)
        if self.dynamics.value.shape != row_shape:
            self.dynamics.set(np.zeros(row_shape, np.float32))
        self.dynamics.next(target=self.next_columns(), dt=abs(self.scene.dt))
        column = np.asarray(self.dynamics.value).T          # (bins, C)
        self.texture.write(
            data=column.reshape(self.spectrogram_bins, 1, self.audio.channels),
            viewport=(self.offset, 0, 1, self.spectrogram_bins))

    def ui(self):
        yield (f"{self.spectrogram_bins} bins  fft 2^{self.fft_n}  "
               f"{self.minimum_frequency:.0f}-{self.maximum_frequency:.0f} Hz")
        yield f"device sequence: {self.texture.sequence is not None}"

    def ui_fields(self):
        def set_min(value):
            self.minimum_frequency = min(value, self.maximum_frequency / 2)

        def set_max(value):
            self.maximum_frequency = max(value, self.minimum_frequency * 2)

        # The band matrix rebuilds on its (min, max, bins) key: an edit
        # takes effect at the next update()
        return [
            UIField("min Hz", lambda: self.minimum_frequency, set_min,
                    step=10.0, minimum=1.0, fmt="{:.0f}"),
            UIField("max Hz", lambda: self.maximum_frequency, set_max,
                    step=500.0, minimum=10.0, fmt="{:.0f}"),
        ]

    def pipeline(self):
        yield Uniform("int", f"{self.name}Length", self.length_samples)
        yield Uniform("int", f"{self.name}Bins", self.spectrogram_bins)
        yield Uniform("float", f"{self.name}Offset", self.offset / self.length_samples)
        yield Uniform("int", f"{self.name}Smooth", self.smooth)
        yield Uniform("float", f"{self.name}Min", float(self.spectrogram_frequencies[0]))
        yield Uniform("float", f"{self.name}Max", float(self.spectrogram_frequencies[-1]))
        yield Uniform("bool", f"{self.name}Scroll", self.scrolling)
