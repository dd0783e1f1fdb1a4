"""
Input kind `music_wav`: music-like stereo 16-bit WAV clips made from the
seed, one file a clip.

The same seed gives the same bytes. Every seed gives the same sizes (clip
length, sample rate, channels); only the content moves: the chord
progression, the tempo's swing, the bass line and the noise of the hats.

    "audio": {"kind": "music_wav", "samplerate": 44100, "channels": 2, "clips": 3, ...}
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np

from portbench.harness.inputs import rng_for

# Chords a progression is drawn from (triads in Hz, around A3)
CHORDS = (
    (220.0, 261.63, 329.63), (174.61, 220.0, 261.63), (130.81, 164.81, 196.0),
    (196.0, 246.94, 293.66), (146.83, 174.61, 220.0), (164.81, 207.65, 246.94),
)


def music_samples(seed: int, clip: int, seconds: float, samplerate: int = 44100,
                  channels: int = 2) -> np.ndarray:
    """(samples, channels) float32 in [-1, 1]: a four-chord pad, a kick on
    every beat, hats on the off-beats and a wobbling bass, at 110-130 bpm."""
    rng = rng_for(seed, 1, clip)
    count = int(round(seconds * samplerate))
    t = np.arange(count, dtype=np.float64) / samplerate
    audio = np.zeros((count, 2), np.float64)
    beat = 60.0 / rng.uniform(110.0, 130.0)
    bar = 4 * beat
    progression = [CHORDS[i] for i in rng.choice(len(CHORDS), 4, replace=False)]
    index = np.minimum((t // bar).astype(np.int64), 1 << 30)
    phase = t - index * bar
    envelope = np.exp(-phase * 0.8) * 0.15
    for j in range(3):
        freq = np.array([chord[j] for chord in progression])[index % 4]
        tone = envelope * np.sin(2 * np.pi * freq * phase)
        audio[:, 0] += tone * (0.8 if j % 2 else 1.0)
        audio[:, 1] += tone * (1.0 if j % 2 else 0.8)
    beats = (t // beat).astype(np.int64)
    since = t - beats * beat
    kick = 0.6 * np.exp(-since * 30) * np.sin(
        2 * np.pi * (60 + 40 * np.exp(-since * 50)) * since) * (since < 0.15)
    audio += kick[:, None]
    hats = (beats % 2 == 1) & (since < 0.05)
    noise = rng.uniform(-1.0, 1.0, count) * 0.08 * np.exp(-since * 80)
    audio += np.where(hats, noise, 0.0)[:, None]
    bass = rng.uniform(45.0, 65.0)
    wobble = 0.5 + 0.5 * np.sin(2 * np.pi * t / rng.uniform(3.0, 5.0))
    audio += (0.12 * np.sin(2 * np.pi * bass * t) * wobble)[:, None]
    audio = np.clip(audio, -1.0, 1.0).astype(np.float32)
    return audio[:, :channels] if channels <= 2 else np.repeat(audio[:, :1], channels, 1)


def write_wav(path: Path, samples: np.ndarray, samplerate: int) -> Path:
    """16-bit PCM WAV of (samples, channels) float32."""
    with wave.open(str(path), "wb") as handle:
        handle.setnchannels(samples.shape[1])
        handle.setsampwidth(2)
        handle.setframerate(samplerate)
        handle.writeframes((samples * 32767).astype("<i2").tobytes())
    return path


def read_wav(path: Path) -> np.ndarray:
    """(samples, channels) float32 of a 16-bit PCM WAV: what a decoder
    hands the scene (int16 / 32768)."""
    with wave.open(str(path), "rb") as handle:
        channels = handle.getnchannels()
        data = np.frombuffer(handle.readframes(handle.getnframes()), "<i2")
    return (data.reshape(-1, channels).astype(np.float32) / 32768.0)


def make(name: str, item: dict, seed: int, directory: Path, clip_seconds: float) -> tuple:
    """([a WAV path a clip], [its decoded (samples, channels) float32])."""
    paths, data = [], []
    for clip in range(int(item.get("clips", 1))):
        samples = music_samples(seed, clip, clip_seconds, int(item["samplerate"]),
                                int(item["channels"]))
        path = write_wav(directory / f"{name}{clip}.wav", samples, int(item["samplerate"]))
        paths.append(path)
        data.append(read_wav(path))
    return paths, data
