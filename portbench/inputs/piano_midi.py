"""
Input kind `piano_midi`: solo piano performances made from the seed,
written as Standard MIDI Files of type 1, one file a clip.

The notes follow the statistics of the MAESTRO v3 dataset (Hawthorne et
al., ICLR 2019): onsets at about 10 notes a second on average, with
passages of 25-30 notes a second and chords of 3-5 notes; pitches over
the piano's 88 keys (MIDI 21-108), most of them near the middle;
durations drawn from a lognormal (median 0.15 s, held notes up to 3 s);
velocities about N(64, 18), clipped to 20-120. Two hands, split around
middle C with an overlap: the right on channel 0, the left on channel 1.

The file is written here, byte by byte: a conductor track with the tempo
at the start and one tempo change, then one track a hand. Both hands'
tracks use running status; the right hand ends its notes with note-off
events, the left with note-on events of velocity 0. A key struck again
while it sounds in the same hand first ends the sounding note.

The same seed gives the same bytes; every seed gives the same sizes (the
clip count and length), only the notes move.

    "midi": {"kind": "piano_midi", "clips": 3, "attr": "midi_file"}

make() returns the paths and, as decoded data, each clip's notes as the
file's ticks give them: (pitch, start s, end s, channel, velocity).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from portbench.harness.inputs import rng_for

PPQN = 480
LOWEST, HIGHEST = 21, 108
# Pitches a hand may take: the right from the split's lower edge up, the
# left from its upper edge down (the overlap around middle C)
SPLIT = (55, 65)


def _pitch(rng: np.random.Generator) -> int:
    """A pitch near the middle of the keyboard (a clipped normal)."""
    return int(np.clip(round(rng.normal(62.0, 13.0)), LOWEST, HIGHEST))


def _hand(pitch: int, rng: np.random.Generator) -> int:
    """0 (right hand, channel 0) or 1 (left hand, channel 1)."""
    if pitch >= SPLIT[1]:
        return 0
    if pitch < SPLIT[0]:
        return 1
    return int(rng.integers(0, 2))


def _duration(rng: np.random.Generator) -> float:
    return float(np.clip(rng.lognormal(np.log(0.15), 0.9), 0.03, 3.0))


def _velocity(rng: np.random.Generator) -> int:
    return int(np.clip(round(rng.normal(64.0, 18.0)), 20, 120))


def performance(seed: int, clip: int, seconds: float) -> list:
    """[(pitch, start s, end s, channel, velocity)] before the file's ticks,
    in order of onset: passages of 1-4 s, about one in eight fast (single
    notes stepping up or down at 25-30 a second), the others at about 5.3
    onsets a second, 15 % of them chords of 3-5 notes."""
    rng = rng_for(seed, 5, clip)
    notes = []
    time = float(rng.uniform(0.0, 0.2))
    while time < seconds:
        length = float(rng.uniform(1.0, 4.0))
        end = min(seconds, time + length)
        if rng.random() < 0.125:
            rate = float(rng.uniform(25.0, 30.0))
            pitch, direction = _pitch(rng), int(rng.choice((-1, 1)))
            while time < end:
                pitch += direction * int(rng.integers(1, 3))
                if not LOWEST <= pitch <= HIGHEST:
                    direction = -direction
                    pitch = int(np.clip(pitch, LOWEST, HIGHEST))
                notes.append((pitch, time, time + _duration(rng), _hand(pitch, rng),
                              _velocity(rng)))
                time += float(rng.gamma(8.0, 1.0 / (8.0 * rate)))
            continue
        while time < end:
            root = _pitch(rng)
            if rng.random() < 0.15:
                chord, pitch = [root], root
                for _ in range(int(rng.integers(3, 6)) - 1):
                    pitch += int(rng.integers(3, 6))
                    if pitch <= HIGHEST:
                        chord.append(pitch)
            else:
                chord = [root]
            hold, strength = _duration(rng), _velocity(rng)
            for pitch in chord:
                spread = float(rng.uniform(0.0, 0.015))
                held = min(3.0, hold * float(rng.uniform(0.8, 1.2)))
                notes.append((pitch, time + spread, time + spread + held,
                              _hand(pitch, rng),
                              int(np.clip(strength + rng.integers(-6, 7), 20, 120))))
            time += float(rng.gamma(4.0, 1.0 / (4.0 * 5.3)))
    return [note for note in notes if note[1] < seconds]


class TempoMap:
    """The conductor track's tempo at tick 0 and its one change."""

    def __init__(self, rng: np.random.Generator, seconds: float):
        self.first = int(round(60e6 / rng.uniform(80.0, 160.0)))    # us a quarter
        self.second = int(round(self.first / rng.uniform(0.8, 1.25)))
        change = rng.uniform(0.3, 0.7) * seconds
        self.change = int(round(change * 1e6 / self.first * PPQN))   # tick

    def tick(self, seconds: float) -> int:
        at = self.change * self.first / (PPQN * 1e6)
        if seconds < at:
            return int(round(seconds * 1e6 / self.first * PPQN))
        return self.change + int(round((seconds - at) * 1e6 / self.second * PPQN))

    def seconds(self, tick: int) -> float:
        """A tick's time, by the anchor sum that a SMF reader computes."""
        if tick < self.change:
            return tick * self.first / (PPQN * 1e6)
        at = self.change * self.first / (PPQN * 1e6)
        return at + (tick - self.change) * self.second / (PPQN * 1e6)


def _varlen(value: int) -> bytes:
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(out))


def _meta(kind: int, payload: bytes) -> bytes:
    return bytes([0xFF, kind]) + _varlen(len(payload)) + payload


def _chunk(events: list) -> bytes:
    """An MTrk chunk of (tick, event bytes) in order; channel events reuse
    the status byte of the event before them where it is the same."""
    body, previous, status = b"", 0, None
    for tick, event in events:
        body += _varlen(tick - previous)
        previous = tick
        if event[0] == 0xFF:
            status = None                # a meta event cancels running status
            body += event
        elif event[0] == status:
            body += event[1:]
        else:
            status = event[0]
            body += event
    body += _varlen(0) + _meta(0x2F, b"")
    return b"MTrk" + struct.pack(">I", len(body)) + body


def hand_events(notes: list, channel: int, note_off: bool) -> list:
    """(tick, bytes) of one hand's [(pitch, on tick, off tick, velocity)]:
    at one tick, the ends before the starts."""
    events = []
    for pitch, on, off, velocity in notes:
        events.append((on, 1, bytes([0x90 | channel, pitch, velocity])))
        release = bytes([0x80 | channel, pitch, 64]) if note_off else \
            bytes([0x90 | channel, pitch, 0])
        events.append((off, 0, release))
    events.sort(key=lambda item: (item[0], item[1]))
    return [(tick, event) for tick, _, event in events]


def smf(seed: int, clip: int, seconds: float) -> tuple:
    """(file bytes, [(pitch, start s, end s, channel, velocity)]) of one clip."""
    tempo = TempoMap(rng_for(seed, 6, clip), seconds)
    hands: dict = {0: [], 1: []}
    sounding: dict = {}                  # (channel, pitch) -> index in its hand
    for pitch, start, end, channel, velocity in sorted(performance(seed, clip, seconds),
                                                       key=lambda note: note[1]):
        on, off = tempo.tick(start), tempo.tick(end)
        previous = sounding.get((channel, pitch))
        if previous is not None and hands[channel][previous][2] > on:
            held = hands[channel][previous]
            if held[1] == on:            # struck twice at one tick: once
                continue
            hands[channel][previous] = (held[0], held[1], on, held[3])
        if off <= on:
            off = on + 1
        sounding[(channel, pitch)] = len(hands[channel])
        hands[channel].append((pitch, on, off, velocity))
    conductor = [(0, _meta(0x03, b"conductor")),
                 (0, _meta(0x51, tempo.first.to_bytes(3, "big"))),
                 (0, _meta(0x58, bytes([4, 2, 24, 8]))),
                 (tempo.change, _meta(0x51, tempo.second.to_bytes(3, "big")))]
    tracks = [_chunk(conductor)]
    for channel, name in ((0, b"right hand"), (1, b"left hand")):
        events = hand_events(hands[channel], channel, note_off=channel == 0)
        tracks.append(_chunk([(0, _meta(0x03, name)), *events]))
    blob = b"MThd" + struct.pack(">IHHH", 6, 1, len(tracks), PPQN) + b"".join(tracks)
    notes = [(pitch, tempo.seconds(on), tempo.seconds(off), channel, velocity)
             for channel in (0, 1) for pitch, on, off, velocity in hands[channel]]
    return blob, sorted(notes, key=lambda note: (note[1], note[0], note[3]))


def make(name: str, item: dict, seed: int, directory: Path, clip_seconds: float) -> tuple:
    """([a .mid path a clip], [its notes])."""
    paths, data = [], []
    for clip in range(int(item.get("clips", 1))):
        blob, notes = smf(seed, clip, clip_seconds)
        path = Path(directory) / f"{name}{clip}.mid"
        path.write_bytes(blob)
        paths.append(path)
        data.append(notes)
    return paths, data
