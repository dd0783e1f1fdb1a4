"""
Input kind `piano_wav`: the audio of the seed's piano performances
(portbench/inputs/piano_midi.py, the same seed and clip), rendered by a
plain additive synth into 16-bit WAV clips, one file a clip: what a user
renders from the MIDI file with a synthesizer, so that the spectrogram
under the piano roll follows its notes.

Each note is its fundamental and five partials (amplitudes 1/k^1.5),
struck with a 5 ms attack, decaying with a time constant that shortens
with pitch, and released over 60 ms after its end; its loudness follows
its velocity; the right hand sits a little to the right, the left hand a
little to the left. The sum is scaled to a peak of 0.9.

    "audio": {"kind": "piano_wav", "samplerate": 44100, "channels": 2, "clips": 3, ...}
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from portbench.inputs import music_wav, piano_midi

PARTIALS = 6
ATTACK, RELEASE = 0.005, 0.06


def piano_samples(notes: list, seconds: float, samplerate: int = 44100,
                  channels: int = 2) -> np.ndarray:
    """(samples, channels) float32 in [-1, 1] of [(pitch, start, end,
    channel, velocity)]."""
    count = int(round(seconds * samplerate))
    audio = np.zeros((count, 2), np.float64)
    for pitch, start, end, hand, velocity in notes:
        first = int(round(start * samplerate))
        last = min(count, int(round((end + RELEASE) * samplerate)))
        if first >= last:
            continue
        t = np.arange(last - first, dtype=np.float64) / samplerate
        held = end - start
        envelope = np.minimum(1.0, t / ATTACK) * np.exp(-t / (0.2 + 2.5 * np.exp(-pitch / 30.0)))
        envelope *= np.clip(1.0 - (t - held) / RELEASE, 0.0, 1.0)
        frequency = 440.0 * 2.0 ** ((pitch - 69) / 12)
        tone = np.zeros_like(t)
        for k in range(1, PARTIALS + 1):
            if k * frequency < samplerate / 2:
                tone += np.sin(2 * np.pi * k * frequency * t) / k ** 1.5
        voice = (velocity / 127.0) ** 1.5 * envelope * tone
        pan = 0.65 if hand == 0 else 0.35
        audio[first:last, 0] += voice * (1.0 - pan)
        audio[first:last, 1] += voice * pan
    peak = float(np.max(np.abs(audio))) if audio.size else 0.0
    if peak > 0:
        audio *= 0.9 / peak
    audio = audio.astype(np.float32)
    return audio[:, :channels] if channels <= 2 else np.repeat(audio[:, :1], channels, 1)


def make(name: str, item: dict, seed: int, directory: Path, clip_seconds: float) -> tuple:
    """([a WAV path a clip], [its decoded (samples, channels) float32])."""
    rate, channels = int(item["samplerate"]), int(item["channels"])
    paths, data = [], []
    for clip in range(int(item.get("clips", 1))):
        _, notes = piano_midi.smf(seed, clip, clip_seconds)
        samples = piano_samples(notes, clip_seconds, rate, channels)
        path = music_wav.write_wav(Path(directory) / f"{name}{clip}.wav", samples, rate)
        paths.append(path)
        data.append(music_wav.read_wav(path))
    return paths, data
