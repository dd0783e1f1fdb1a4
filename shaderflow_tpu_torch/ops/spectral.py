"""
Batched audio DSP: windows, STFT, natural-scale band matrices, waveform bars.

Port of shaderflow_tpu/ops/spectral.py. The offline export knows every
sample up front, so the whole export's spectrogram is one batched program:
an (F, C, fft_size) windowed rFFT (torch.fft, cuFFT on the card) and one
dense (bins x fft_bins) matrix product. Functions take numpy arrays and
return numpy (the realtime per-frame path), or take tensors and return
tensors on the same device (the batched precompute). f32 products and
convolutions never run in TF32 (see shaderflow_tpu_torch.resolve_device).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable

import numpy as np
import torch

# --------------------------------------------------------------------------- #
# Windows

@lru_cache
def hanning(size: int) -> np.ndarray:
    return np.hanning(size)

@lru_cache
def hann_poisson(size: int, alpha: float = 2.0) -> np.ndarray:
    n = np.arange(size)
    a = 0.5 * (1 - np.cos(2 * np.pi * n / size))
    b = np.exp(-alpha * np.abs(size - 2 * n) / size)
    return a * b

@lru_cache
def no_window(size: int) -> np.ndarray:
    return np.ones(size)


# --------------------------------------------------------------------------- #
# Magnitude / volume mappings

def _xp(x):
    """numpy in -> numpy out; tensors in -> tensors out."""
    return np if isinstance(x, np.ndarray) else torch

def magnitude_amplitude(x):
    return _xp(x).abs(x)

def magnitude_power(x):
    if isinstance(x, np.ndarray):
        return (x * np.conjugate(x)).real
    return (x * torch.conj(x)).real

def volume_dbfs(x):
    return 10.0 * _xp(x).log10(x)

def volume_sqrt(x):
    return _xp(x).sqrt(x)

def volume_linear(x):
    return x

def volume_dbfs_tremx(x):
    return 10.0 * (_xp(x).log10(x + 0.1) + 1.0) / 1.0414


# --------------------------------------------------------------------------- #
# Frequency scales

SCALE_OCTAVE = (lambda x: np.log2(x), lambda x: 2.0 ** x)
SCALE_MEL = (
    lambda x: 2595.0 * np.log10(1.0 + x / 700.0),
    lambda x: 700.0 * (10.0 ** (x / 2595.0) - 1.0),
)

def scale_frequencies(minimum: float, maximum: float, bins: int, scale=SCALE_OCTAVE) -> np.ndarray:
    """Center frequencies T^-1(linspace(T(min), T(max), bins)) in a custom scale."""
    forward, inverse = scale
    return inverse(np.linspace(forward(minimum), forward(maximum), bins))


# --------------------------------------------------------------------------- #
# Whittaker-Shannon band-pass interpolation matrix

def interpolation_euler(end: float = 1.2) -> Callable[[np.ndarray], np.ndarray]:
    return lambda x: np.exp(-((2.0 * x / end) ** 2)) / (end * math.sqrt(math.pi))

def interpolation_dirac(x: np.ndarray) -> np.ndarray:
    dirac = np.zeros(x.shape)
    dirac[np.round(x) == 0] = 1
    return dirac

def interpolation_sinc(x: np.ndarray) -> np.ndarray:
    return np.abs(np.sinc(x))


def band_matrix(
    center_frequencies: np.ndarray,
    fft_bins: int,
    fft_df: float,
    interpolation: Callable[[np.ndarray], np.ndarray] | None = None,
    epsilon: float = 1e-5,
) -> np.ndarray:
    """(bins, fft_bins) dense float32 matrix; row b is a band-pass filter
    centered at center_frequencies[b] (FFT bins treated as a one-hertz-spaced
    function interpolated at the fractional center bin index)."""
    interpolation = interpolation or interpolation_euler()
    index = np.asarray(center_frequencies) / fft_df
    matrix = np.stack([interpolation(i - np.arange(fft_bins)) for i in index])
    matrix[np.abs(matrix) < epsilon] = 0.0
    return matrix.astype(np.float32)


# --------------------------------------------------------------------------- #
# Batched STFT

def stft_frames(audio: torch.Tensor, offsets: torch.Tensor, fft_size: int,
                window) -> torch.Tensor:
    """Gather + window frames: audio (C, S), offsets (F,) start samples ->
    (F, C, fft_size). Samples outside [0, S) read as zero; window=None skips
    the taper."""
    idx = offsets[:, None].to(torch.int64) + torch.arange(
        fft_size, device=audio.device)[None, :]                       # (F, N)
    valid = (idx >= 0) & (idx < audio.shape[1])
    idx = torch.clamp(idx, 0, audio.shape[1] - 1)
    frames = audio[:, idx]                                            # (C, F, N)
    frames = torch.where(valid[None], frames, 0.0)
    frames = frames.permute(1, 0, 2)
    if window is None:
        return frames
    window = torch.as_tensor(window, dtype=torch.float32, device=audio.device)
    return frames * window[None, None, :]


# --------------------------------------------------------------------------- #
# Windowed-sinc polyphase upsampling

@lru_cache
def sinc_kernel(factor: int, taps_per_phase: int = 16,
                beta: float = 8.555) -> np.ndarray:
    """Kaiser-windowed sinc low-pass for integer-factor upsampling: cutoff at
    the input Nyquist, odd length 2*taps_per_phase*factor + 1, DC gain
    `factor` (the zero-stuffed signal keeps its amplitude)."""
    half = taps_per_phase * factor
    m = np.arange(-half, half + 1, dtype=np.float64)
    h = np.sinc(m / factor) * np.kaiser(2 * half + 1, beta)
    return (factor * h / h.sum()).astype(np.float32)


def sinc_upsample(x, factor: int, taps_per_phase: int = 16):
    """Integer-factor upsample of the last axis: (..., N) -> (..., N*factor),
    centered (output j sits at input time j/factor), zero edges — the
    contract of scipy.signal.resample_poly(x, factor, 1). numpy in -> numpy
    out; a tensor in -> a conv1d over the zero-stuffed signal."""
    if factor == 1:
        return x
    h = sinc_kernel(int(factor), taps_per_phase)
    half = (h.size - 1) // 2
    lead, n = x.shape[:-1], x.shape[-1]
    if isinstance(x, np.ndarray):
        flat = np.ascontiguousarray(x, np.float32).reshape(-1, n)
        out = np.empty((flat.shape[0], n * factor), np.float32)
        stuffed = np.zeros(n * factor, np.float32)
        for row in range(flat.shape[0]):
            stuffed[::factor] = flat[row]
            out[row] = np.convolve(stuffed, h)[half:half + n * factor]
        return out.reshape(*lead, n * factor)
    flat = x.to(torch.float32).reshape(-1, 1, n)
    stuffed = torch.zeros((flat.shape[0], 1, n * factor), dtype=torch.float32,
                          device=x.device)
    stuffed[:, :, ::factor] = flat
    # conv1d is cross-correlation; the kernel is symmetric, so no flip
    kernel = torch.from_numpy(h).to(x.device)[None, None, :]
    out = torch.nn.functional.conv1d(stuffed, kernel, padding=half)
    return out.reshape(*lead, n * factor)


def spectrogram_batch(
    audio: torch.Tensor,
    offsets: torch.Tensor,
    fft_size: int,
    window,
    matrix,
    magnitude: Callable = magnitude_power,
    volume: Callable | None = None,
    upsample: int = 1,
) -> torch.Tensor:
    """Whole-trajectory spectrogram: (F, C, bins) = volume(M @ |rfft|). With
    upsample=r, each frame reads fft_size//r raw samples and sinc-upsamples
    them to fft_size before the taper."""
    window = torch.as_tensor(window, dtype=torch.float32, device=audio.device)
    matrix = torch.as_tensor(matrix, dtype=torch.float32, device=audio.device)
    if upsample > 1:
        frames = stft_frames(audio, offsets, fft_size // upsample, None)
        frames = sinc_upsample(frames, upsample) * window[None, None, :]
    else:
        frames = stft_frames(audio, offsets, fft_size, window)       # (F, C, N)
    spectrum = magnitude(torch.fft.rfft(frames, dim=-1))             # (F, C, N/2+1)
    banded = torch.matmul(spectrum.to(torch.float32), matrix.T)      # (F, C, bins)
    if volume is not None:
        banded = volume(banded)
    return banded


# --------------------------------------------------------------------------- #
# Waveform bar reduction

def waveform_average(x):
    xp = _xp(x)
    return xp.sqrt(xp.mean(xp.abs(x), axis=-1))

def waveform_rms(x):
    xp = _xp(x)
    return xp.sqrt(xp.sqrt(xp.mean(xp.square(x), axis=-1)) * (2.0 ** 0.5))

def waveform_std(x):
    if isinstance(x, np.ndarray):
        return np.sqrt(np.std(x, axis=-1))
    return torch.sqrt(torch.std(x, dim=-1, correction=0))


def waveform_batch(
    audio: torch.Tensor,
    ends: torch.Tensor,
    points: int,
    chunk_size: int,
    reducer: Callable = waveform_average,
) -> torch.Tensor:
    """Batched oscilloscope bars: audio (C, S), ends (F,) chunk-aligned
    exclusive end sample of each frame's window -> (F, points, C). The
    per-chunk reductions are computed once over the whole track and each
    frame gathers its `points` chunk indices; chunks outside the track
    reduce a zero window."""
    channels, samples = audio.shape
    n_chunks = max(1, samples // chunk_size)
    if samples < n_chunks * chunk_size:
        # Track shorter than one chunk: the tail reads as silence
        audio = torch.nn.functional.pad(audio, (0, n_chunks * chunk_size - samples))
    chunked = audio[:, :n_chunks * chunk_size].reshape(channels, n_chunks, chunk_size)
    reduced = reducer(chunked)                                      # (C, n_chunks)
    end_chunk = torch.div(ends.to(torch.int64), chunk_size, rounding_mode="floor")
    idx = end_chunk[:, None] - points + torch.arange(points, device=audio.device)[None, :]
    valid = (idx >= 0) & (idx < n_chunks)
    gathered = reduced[:, torch.clamp(idx, 0, n_chunks - 1)]         # (C, F, points)
    zero = reducer(torch.zeros((1, 1, chunk_size), dtype=audio.dtype,
                               device=audio.device))[0, 0]
    gathered = torch.where(valid[None], gathered, zero)
    return gathered.permute(1, 2, 0)


# --------------------------------------------------------------------------- #
# Rolling volume / std

def rolling_levels(audio: torch.Tensor, ends: torch.Tensor,
                   window_samples: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-frame (volume_target, std_target): volume = 2*RMS(last window)*sqrt(2),
    std = standard deviation of the same window (zeros outside the track)."""
    starts = ends.to(torch.int64) - window_samples
    idx = starts[:, None] + torch.arange(window_samples, device=audio.device)[None, :]
    valid = (idx >= 0) & (idx < audio.shape[1])
    idx = torch.clamp(idx, 0, audio.shape[1] - 1)
    windows = torch.where(valid[None], audio[:, idx], 0.0)          # (C, F, W)
    rms = torch.sqrt(torch.mean(torch.square(windows), dim=(0, 2)))
    volume = 2.0 * rms * (2.0 ** 0.5)
    std = torch.std(windows, dim=(0, 2), correction=0)
    return volume, std
