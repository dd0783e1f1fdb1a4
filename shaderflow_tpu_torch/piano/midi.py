"""
Minimal Standard MIDI File parser (pure Python).

A copy of shaderflow_tpu/piano/midi.py for the port, which imports nothing
of the JAX package: a self-contained SMF type 0/1 reader producing what
the piano module needs (absolute-time note intervals and tempo changes),
in place of the upstream project's pretty_midi dependency.

Supports: running status, meta events (tempo / end-of-track), multi-track
time merging with tempo-map-aware tick->seconds conversion (SMPTE and PPQN
divisions).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator


@dataclass
class MidiNote:
    pitch: int
    start: float
    end: float
    channel: int
    velocity: int


@dataclass
class MidiFile:
    notes: list[MidiNote] = field(default_factory=list)
    tempo_changes: list[tuple[float, float]] = field(default_factory=list)  # (seconds, bpm)
    duration: float = 0.0


def _read_varlen(data: bytes, pos: int) -> tuple[int, int]:
    value = 0
    while True:
        byte = data[pos]
        pos += 1
        value = (value << 7) | (byte & 0x7F)
        if not byte & 0x80:
            return value, pos


def _iter_events(track: bytes) -> Iterator[tuple[int, int, bytes]]:
    """Yield (delta_ticks, status, payload) for one track chunk."""
    pos = 0
    status = 0
    while pos < len(track):
        delta, pos = _read_varlen(track, pos)
        byte = track[pos]
        if byte & 0x80:
            status = byte
            pos += 1
        # else: running status — reuse previous status byte

        if status == 0xFF:  # meta
            meta_type = track[pos]
            pos += 1
            length, pos = _read_varlen(track, pos)
            yield delta, 0xFF00 | meta_type, track[pos:pos + length]
            pos += length
        elif status in (0xF0, 0xF7):  # sysex
            length, pos = _read_varlen(track, pos)
            yield delta, status, track[pos:pos + length]
            pos += length
        else:
            kind = status & 0xF0
            size = 1 if kind in (0xC0, 0xD0) else 2
            yield delta, status, track[pos:pos + size]
            pos += size


def load_midi(path) -> MidiFile:
    data = Path(path).read_bytes()
    if data[:4] != b"MThd":
        raise ValueError(f"Not a MIDI file: {path}")
    header_len, fmt, ntracks, division = struct.unpack(">IHHH", data[4:14])

    # Split track chunks
    tracks: list[bytes] = []
    pos = 8 + header_len
    while pos + 8 <= len(data) and len(tracks) < ntracks:
        tag = data[pos:pos + 4]
        (length,) = struct.unpack(">I", data[pos + 4:pos + 8])
        if tag == b"MTrk":
            tracks.append(data[pos + 8:pos + 8 + length])
        pos += 8 + length

    # Pass 1: tempo map in absolute ticks (all tracks; format 1 keeps it in
    # track 0, but merging is safe for both formats)
    tempo_map: list[tuple[int, int]] = [(0, 500000)]  # (tick, us/quarter)
    for track in tracks:
        tick = 0
        for delta, status, payload in _iter_events(track):
            tick += delta
            if status == 0xFF51 and len(payload) == 3:
                tempo_map.append((tick, int.from_bytes(payload, "big")))
    # By tick alone and stably, so that at one tick the file's tempo
    # follows the default 120 bpm and the last one set holds (sorted as
    # pairs, one tick's tempi would be ordered by value)
    tempo_map.sort(key=lambda item: item[0])

    smpte = bool(division & 0x8000)
    if smpte:
        frames = 256 - (division >> 8)          # negative two's complement fps
        subframes = division & 0xFF
        tick_seconds = 1.0 / (frames * subframes)

        def tick_to_seconds(tick: int) -> float:
            return tick * tick_seconds
    else:
        ppqn = max(1, division)
        # Precompute cumulative seconds at each tempo change
        anchors: list[tuple[int, float, int]] = []   # (tick, seconds, us/q)
        seconds = 0.0
        previous_tick, previous_tempo = 0, 500000
        for tick, tempo in tempo_map:
            seconds += (tick - previous_tick) * previous_tempo / (ppqn * 1e6)
            anchors.append((tick, seconds, tempo))
            previous_tick, previous_tempo = tick, tempo

        def tick_to_seconds(tick: int) -> float:
            base_tick, base_seconds, tempo = anchors[0]
            for anchor in anchors:
                if anchor[0] > tick:
                    break
                base_tick, base_seconds, tempo = anchor
            return base_seconds + (tick - base_tick) * tempo / (ppqn * 1e6)

    result = MidiFile()
    for tick, tempo in tempo_map:
        result.tempo_changes.append((tick_to_seconds(tick), 60e6 / tempo))

    # Pass 2: note intervals
    for track in tracks:
        tick = 0
        active: dict[tuple[int, int], tuple[int, int]] = {}  # (ch, pitch) -> (start_tick, vel)
        for delta, status, payload in _iter_events(track):
            tick += delta
            kind = status & 0xF0
            channel = status & 0x0F
            if kind == 0x90 and payload[1] > 0:  # note on
                active[(channel, payload[0])] = (tick, payload[1])
            elif kind == 0x80 or (kind == 0x90 and payload[1] == 0):  # note off
                key = (channel, payload[0])
                if key in active:
                    start_tick, velocity = active.pop(key)
                    note = MidiNote(
                        pitch=payload[0],
                        start=tick_to_seconds(start_tick),
                        end=tick_to_seconds(tick),
                        channel=channel,
                        velocity=velocity,
                    )
                    result.notes.append(note)
                    result.duration = max(result.duration, note.end)

    result.notes.sort(key=lambda n: (n.start, n.pitch))
    return result


def write_midi(path, notes: list[MidiNote], *, ppqn: int = 480, bpm: float = 120.0) -> Path:
    """Write a minimal type-0 SMF (used by tests and example asset
    generation)."""
    tempo = int(60e6 / bpm)

    def varlen(value: int) -> bytes:
        out = [value & 0x7F]
        value >>= 7
        while value:
            out.append(0x80 | (value & 0x7F))
            value >>= 7
        return bytes(reversed(out))

    def to_ticks(seconds: float) -> int:
        return round(seconds * 1e6 / tempo * ppqn)

    events: list[tuple[int, bytes]] = [(0, bytes([0xFF, 0x51, 0x03]) + tempo.to_bytes(3, "big"))]
    for note in notes:
        events.append((to_ticks(note.start),
                       bytes([0x90 | (note.channel & 0xF), note.pitch, note.velocity])))
        events.append((to_ticks(note.end),
                       bytes([0x80 | (note.channel & 0xF), note.pitch, 0])))
    events.sort(key=lambda item: item[0])

    track = b""
    previous = 0
    for tick, payload in events:
        track += varlen(tick - previous) + payload
        previous = tick
    track += varlen(0) + bytes([0xFF, 0x2F, 0x00])  # end of track

    blob = (b"MThd" + struct.pack(">IHHH", 6, 0, 1, ppqn)
            + b"MTrk" + struct.pack(">I", len(track)) + track)
    path = Path(path)
    path.write_bytes(blob)
    return path
