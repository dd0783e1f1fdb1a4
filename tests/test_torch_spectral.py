"""The offline audio DSP of the PyTorch port (shaderflow_tpu_torch/ops/
spectral.py and the dynamics scan of ops/dynamics.py) against the JAX
package on the same numpy inputs (JAX on the CPU in this process)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shaderflow_tpu.ops import dynamics as jax_dynamics
from shaderflow_tpu.ops import spectral as jax_spectral
from shaderflow_tpu_torch.ops import dynamics, spectral


def _audio(seed: int = 0, channels: int = 2, samples: int = 9000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 44100.0
    tone = 0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.2 * np.sin(2 * np.pi * 3520.0 * t)
    return (tone[None, :] + 0.1 * rng.standard_normal((channels, samples))).astype(np.float32)


def test_stft_frames_match_jax():
    """Gathered, windowed frames with zeros outside the track: exact."""
    audio = _audio()
    offsets = np.array([-700, -1, 0, 1234, 8000, 8999], np.int32)
    window = np.hanning(1024).astype(np.float32)
    for taper in (window, None):
        got = spectral.stft_frames(torch.from_numpy(audio), torch.from_numpy(offsets),
                                   1024, None if taper is None else torch.from_numpy(taper))
        want = jax_spectral.stft_frames(jnp.asarray(audio), jnp.asarray(offsets), 1024,
                                        None if taper is None else jnp.asarray(taper))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("interpolation", ["Euler", "Dirac", "Sinc"])
def test_band_matrix_matches_jax(interpolation):
    """The piano band matrix of the visualizer (115 bins, fft 4096): the
    same numpy function, equal bit for bit."""
    frequencies = jax_spectral.scale_frequencies(19.4454, 14080.0 * 2 ** (0.5 / 12), 115)
    np.testing.assert_array_equal(
        spectral.scale_frequencies(19.4454, 14080.0 * 2 ** (0.5 / 12), 115), frequencies)
    pick = {"Euler": (spectral.interpolation_euler(1.2), jax_spectral.interpolation_euler(1.2)),
            "Dirac": (spectral.interpolation_dirac, jax_spectral.interpolation_dirac),
            "Sinc": (spectral.interpolation_sinc, jax_spectral.interpolation_sinc)}
    ours, theirs = pick[interpolation]
    got = spectral.band_matrix(frequencies, 2049, 44100 / 4096, ours)
    want = jax_spectral.band_matrix(frequencies, 2049, 44100 / 4096, theirs)
    assert got.dtype == np.float32 and got.shape == (115, 2049)
    np.testing.assert_array_equal(got, want)


def test_spectrogram_batch_matches_jax():
    """Batched power spectrogram through the band matrix. The two FFT
    implementations round differently, so the bar is relative to the
    largest magnitude: measured max error 2.0e-7 of it, bound at 1e-5."""
    audio = _audio(seed=1, samples=20000)
    offsets = np.arange(-2048, 16000, 1500).astype(np.int32)
    window = np.hanning(4096).astype(np.float32)
    frequencies = jax_spectral.scale_frequencies(20.0, 14000.0, 115)
    matrix = jax_spectral.band_matrix(frequencies, 2049, 44100 / 4096)
    got = spectral.spectrogram_batch(torch.from_numpy(audio), torch.from_numpy(offsets),
                                     4096, window, matrix).numpy()
    want = np.asarray(jax_spectral.spectrogram_batch(
        jnp.asarray(audio), jnp.asarray(offsets), 4096, window, matrix))
    assert got.shape == want.shape == (len(offsets), 2, 115)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_sinc_upsample_matches_jax_and_scipy():
    """The tensor path (a conv1d over the zero-stuffed signal) against the
    JAX package's dilated convolution (<= 1e-6 relative to the signal's
    scale) and against scipy.signal.resample_poly with the same filter, as
    tests/test_spectral.py pins the JAX package (atol 2e-4)."""
    scipy_signal = pytest.importorskip("scipy.signal")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 256)).astype(np.float32)
    for factor in (2, 4):
        got = spectral.sinc_upsample(torch.from_numpy(x), factor).numpy()
        want = np.asarray(jax_spectral.sinc_upsample(jnp.asarray(x), factor))
        assert got.shape == (2, 256 * factor)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
        np.testing.assert_array_equal(spectral.sinc_upsample(x, factor),
                                      jax_spectral.sinc_upsample(x, factor))
        h = spectral.sinc_kernel(factor).astype(np.float64)
        reference = scipy_signal.resample_poly(x, factor, 1, axis=-1, window=h / factor)
        np.testing.assert_allclose(got, reference, atol=2e-4)


@pytest.mark.parametrize("reducer", ["waveform_average", "waveform_rms", "waveform_std"])
def test_waveform_batch_matches_jax(reducer):
    """Per-chunk bars gathered per frame (the visualizer's 180 points of
    735 samples), chunks before the track reducing a zero window: sums of
    735 samples in another order, <= 1e-6 relative."""
    audio = _audio(seed=2, samples=44100)
    tells = np.round(np.arange(12) * 44100 / 6).astype(np.int64)
    ends = (tells - tells % 735).astype(np.int32)
    got = spectral.waveform_batch(torch.from_numpy(audio), torch.from_numpy(ends), 180, 735,
                                  getattr(spectral, reducer)).numpy()
    want = np.asarray(jax_spectral.waveform_batch(jnp.asarray(audio), jnp.asarray(ends), 180,
                                                  735, getattr(jax_spectral, reducer)))
    assert got.shape == want.shape == (12, 180, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_rolling_levels_match_jax():
    """Per-frame volume (2 * RMS * sqrt 2) and standard deviation of the
    last window, zeros before the start: <= 1e-6 relative."""
    audio = _audio(seed=3, samples=30000)
    ends = np.array([0, 100, 4410, 17000, 29999], np.int32)
    volume, std = spectral.rolling_levels(torch.from_numpy(audio), torch.from_numpy(ends), 4410)
    want_volume, want_std = jax_spectral.rolling_levels(jnp.asarray(audio), jnp.asarray(ends),
                                                        4410)
    np.testing.assert_allclose(volume.numpy(), np.asarray(want_volume), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(std.numpy(), np.asarray(want_std), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("integrate", [False, True])
def test_dynamics_scan_matches_jax(integrate):
    """The spectrogram smoother: a second-order system stepped over 90
    frames of (2 x 115) targets at 1/60 s (frequency 4, zeta 1). The same
    f32 steps; XLA may fold a division by the constant dt into a product
    with its reciprocal, so the bar is 1e-6 relative to the trajectory's
    scale."""
    rng = np.random.default_rng(5)
    targets = (rng.random((90, 230), np.float32) * 100.0).astype(np.float32)
    got = dynamics.scan(torch.from_numpy(targets), torch.zeros(230), 1 / 60,
                        frequency=4.0, zeta=1.0, response=0.0, integrate=integrate)
    want = jax_dynamics.scan(jnp.asarray(targets), jnp.zeros(230), 1 / 60,
                             frequency=4.0, zeta=1.0, response=0.0, integrate=integrate)
    pairs = zip(got, want) if integrate else [(got, want)]
    for ours, theirs in pairs:
        theirs = np.asarray(theirs)
        assert ours.shape == theirs.shape == (90, 230)
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                                   atol=1e-6 * np.abs(theirs).max())
