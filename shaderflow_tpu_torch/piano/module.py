"""
ShaderPiano — MIDI piano roll as textures.

Port of shaderflow_tpu/piano/module.py: notes live in an interval tree
keyed note -> second -> bucket; each frame scans the notes in
[time, time + roll_time + lookahead] to fill the rolling-notes texture
(MAX_NOTE x MAX_ROLLING RGBA32F of start/end/channel/velocity), the
pressed-keys velocity texture (smoothed by a second-order system) and the
channel texture, plus a dynamically zooming visible note range (a vec2
uniform). MIDI loading uses the in-package parser (piano/midi.py).

Offline exports (with `precompute`, the default) run the whole run's
scan up front and bind the three per-frame textures as device sequences;
the note range is recorded and replayed per frame. Otherwise (the
realtime preview, or precompute=False) each frame runs the scan and
writes the three textures, which the engine streams: one snapshot a frame,
up in the flush's one staged host-to-device copy. Live synthesis goes
through FluidSynth (pyfluidsynth) and sounds notes only in realtime; a
missing binary or module warns and the scene runs silent.
"""

from __future__ import annotations

import itertools
import shutil
from collections import deque
from pathlib import Path
from typing import Any, Iterable, Optional

import numpy as np
import torch

from shaderflow_tpu_torch import logger, tracing
from shaderflow_tpu_torch.module import ShaderModule
from shaderflow_tpu_torch.ops.dynamics import DynamicNumber
from shaderflow_tpu_torch.piano.midi import load_midi
from shaderflow_tpu_torch.piano.notes import PianoNote
from shaderflow_tpu_torch.texture import ShaderTexture
from shaderflow_tpu_torch.variable import ShaderVariable, Uniform

MAX_CHANNELS = 32
MAX_ROLLING = 256
MAX_NOTE = 128


class ShaderPiano(ShaderModule):

    # Counters of every piano's scans (in an export's tracing counters as
    # piano.frames and piano.notes): frames scanned and roll slots written
    frames_scanned = 0
    notes_written = 0

    name: str = "iPiano"
    precompute: bool = True
    """Freewheel exports precompute the whole run's textures as device
    sequences; False streams the per-frame scan as the realtime path does
    (an animated scene.speed needs it)."""
    time_offset: float = 0.0
    roll_time: float = 2.0
    height: float = 0.275
    black_ratio: float = 0.6
    extra_keys: int = 6
    lookahead: float = 2.0
    release_before_end: float = 0.03

    def __init__(self, scene=None, name: str = "iPiano", **kwargs):
        self.tempo: deque[tuple[float, float]] = deque()
        self.tree: dict[int, dict[int, deque[PianoNote]]] = {}
        self.global_minimum_note: int = MAX_NOTE
        self.global_maximum_note: int = 0
        self.key_press_dynamics = DynamicNumber(
            value=np.zeros(MAX_NOTE, np.float32),
            frequency=4, zeta=0.4, response=0, precision=0)
        self.note_range_dynamics = DynamicNumber(
            value=np.zeros(2, np.float32),
            frequency=0.05, zeta=1 / (2 ** 0.5), response=0)
        self._playing_matrix: list[list[Optional[PianoNote]]] = \
            [[None] * MAX_CHANNELS for _ in range(MAX_NOTE)]
        self.fluidsynth: Any = None
        self.soundfont: Any = None
        self.soundfont_file: Any = None  # a .sf2 loaded when the live synth starts
        self._sequence_key = None
        self._sequence_arrays = None
        self._range_values: Optional[np.ndarray] = None
        self._reference: dict[str, np.ndarray] = {}
        super().__init__(scene=scene, name=name, **kwargs)

    def build(self) -> None:
        scene = self.scene
        self.keys_texture = ShaderTexture(scene=scene, name=f"{self.name}Keys").from_numpy(
            self._empty_keys())
        self.channel_texture = ShaderTexture(scene=scene, name=f"{self.name}Chan").from_numpy(
            self._empty_keys())
        self.roll_texture = ShaderTexture(scene=scene, name=f"{self.name}Roll").from_numpy(
            self._empty_roll())
        self.tempo_texture = ShaderTexture(scene=scene, name=f"{self.name}Tempo").from_numpy(
            np.zeros((100, 1, 2), np.float32))

    @staticmethod
    def _empty_keys() -> np.ndarray:
        return np.zeros((1, MAX_NOTE), np.float32)

    @staticmethod
    def _empty_roll() -> np.ndarray:
        return np.zeros((MAX_NOTE, MAX_ROLLING, 4), np.float32)

    # -- data structure -------------------------------------------------------

    @property
    def lookup_time(self) -> float:
        return self.roll_time + self.lookahead

    @staticmethod
    def _ranges(start: float, end: float) -> range:
        return range(int(start), int(end) + 1)

    def clear(self) -> None:
        self.tree.clear()

    def add_note(self, note: Optional[PianoNote]) -> None:
        if note is None:
            return
        for index in self._ranges(note.start, note.end):
            self.tree.setdefault(note.note, {}).setdefault(index, deque()).append(note)
        self.update_global_ranges(note.note)

    @property
    def notes(self) -> Iterable[PianoNote]:
        for block in self.tree.values():
            for bucket in block.values():
                yield from bucket

    def __iter__(self):
        return iter(self.notes)

    @property
    def duration(self) -> float:
        return max((note.end for note in self.notes), default=0.0)

    def notes_between(self, index: int, start: float, end: float) -> Iterable[PianoNote]:
        seen = set()
        for second in self._ranges(start, end):
            for note in self.tree.get(index, {}).get(second, ()):
                if note.start > end or id(note) in seen:
                    continue
                seen.add(id(note))
                yield note

    def update_global_ranges(self, note: int) -> None:
        self.global_minimum_note = min(self.global_minimum_note, note)
        self.global_maximum_note = max(self.global_maximum_note, note)

    @property
    def maximum_velocity(self) -> Optional[int]:
        return max((note.velocity for note in self.notes), default=None)

    @property
    def minimum_velocity(self) -> Optional[int]:
        return min((note.velocity for note in self.notes), default=None)

    def normalize_velocities(self, minimum: int = 100, maximum: int = 100) -> None:
        hi, lo = self.maximum_velocity, self.minimum_velocity

        def remap(velocity: int) -> int:
            if hi != lo:
                return int((velocity - lo) / (hi - lo) * (maximum - minimum) + minimum)
            return int((maximum + minimum) / 2)

        for note in self.notes:
            note.velocity = remap(note.velocity)

    def setup(self) -> None:
        self._frame_index = 0
        # Live synthesis starts with a realtime run only
        if self.scene.realtime and not self.scene.freewheel and self.fluidsynth is None:
            self.fluid_start()
            if self.fluidsynth is not None and self.soundfont_file is not None:
                self.fluid_load(self.soundfont_file)

    def commands(self) -> None:
        self.register_command(self.midi_stats, "midi-stats")

    def midi_stats(self) -> None:
        """Print note/tempo statistics of the loaded MIDI file."""
        notes = list(self.notes)
        print(f"notes: {len(notes)}")
        print(f"note range: {self.global_minimum_note}-{self.global_maximum_note}")
        print(f"duration: {self.duration:.2f}s")
        print(f"tempo changes: {len(self.tempo)}")

    def load_midi(self, path) -> None:
        path = Path(path)
        if not path.exists():
            logger.warn(f"Input Midi file not found ({path})")
            return
        midi = load_midi(path)
        for note in midi.notes:
            self.add_note(PianoNote(
                note=note.pitch, start=note.start, end=note.end,
                channel=note.channel, velocity=note.velocity))
        for when, bpm in midi.tempo_changes:
            self.tempo.append((when, bpm))

        self.tempo_texture.clear()
        for offset, (when, bpm) in enumerate(self.tempo):
            if offset >= 100:
                break
            self.tempo_texture.write(
                data=np.array([when, bpm], np.float32),
                viewport=(0, offset, 1, 1))

    # -- offline whole-run precompute ------------------------------------------

    def _precompute_sequences(self) -> None:
        """Run the whole export's note scan up front and bind the three
        per-frame textures as device sequences (the engine indexes them by
        iFrameIndex), recording the smoothed note range for update() to
        replay. The scan runs at t_f = offset + f * speed / fps, and both
        dynamics step with the export's dt from a fresh state (frame 0 with
        dt == 0: the scene sets dt after the module updates). Reference
        state carried in by load_state replaces the computed arrays."""
        scene = self.scene
        total = max(1, round(scene.runtime * scene.fps))
        speed = float(scene.speed)
        key = (total, scene.fps, speed, self.time_offset, self.roll_time,
               self.lookahead, self.release_before_end,
               sum(len(b) for blk in self.tree.values() for b in blk.values()),
               self.global_minimum_note, self.global_maximum_note)
        if self._sequence_key != key:
            dt = abs(speed) / scene.fps
            keys_seq = np.empty((total, 1, MAX_NOTE, 1), np.float32)
            chan_seq = np.empty((total, 1, MAX_NOTE, 1), np.float32)
            roll_seq = np.empty((total, MAX_NOTE, MAX_ROLLING, 4), np.float32)
            ranges = np.empty((total, 2), np.float32)

            self.key_press_dynamics.set(np.zeros(MAX_NOTE, np.float32))
            self.note_range_dynamics.set(np.zeros(2, np.float32))
            with tracing.span("piano.scan"):
                for f in range(total):
                    time = self.time_offset + speed * f / scene.fps
                    roll, channels = self._scan_frame(time, dt if f else 0.0)
                    # Storage row 0 = top: texel_fetch's GL y = note reads
                    # row MAX_NOTE - 1 - note, so the rows go in reversed
                    roll_seq[f] = roll[::-1]
                    chan_seq[f, 0, :, 0] = channels[0]
                    keys_seq[f, 0, :, 0] = self.key_press_dynamics.value
                    ranges[f] = self.note_range_dynamics.value
            self._sequence_key = key
            self._sequence_arrays = (keys_seq, chan_seq, roll_seq, ranges)
        keys_seq, chan_seq, roll_seq, ranges = self._sequence_arrays
        carried = self._reference
        keys_seq = carried.get("keys", keys_seq)
        chan_seq = carried.get("channels", chan_seq)
        roll_seq = carried.get("roll", roll_seq)
        self.keys_texture.set_sequence(torch.from_numpy(keys_seq))
        self.channel_texture.set_sequence(torch.from_numpy(chan_seq))
        self.roll_texture.set_sequence(torch.from_numpy(roll_seq))
        self._range_values = carried.get("ranges", ranges)
        logger.info(f"Precomputed {total} piano-roll frames as device "
                    f"sequences ({roll_seq.nbytes / 1e6:.0f} MB roll)")

    def load_state(self, state: dict) -> None:
        """Carry a reference run's arrays (engine.load_reference_state):
        "ranges" (F, 2) replaces the recorded note range, "keys" /
        "channels" (F, 1, 128, 1) and "roll" (F, 128, 256, 4) the
        precomputed sequences."""
        unknown = set(state) - {"ranges", "keys", "channels", "roll"}
        if unknown:
            raise KeyError(f"ShaderPiano carries no state named {sorted(unknown)}")
        self._reference = {name: np.ascontiguousarray(value, np.float32)
                           for name, value in state.items()}
        self._sequence_key = None

    # -- per-frame scan (reference module.py:202-277) --------------------------

    def _scan_frame(self, time: float, dt: float):
        """One frame of the note scan: steps both dynamics, returns the
        (roll, channels) arrays for this frame."""
        upcoming: set[int] = set()

        self.key_press_dynamics.target.fill(0)
        roll = self._empty_roll()
        channels = self._empty_keys() - 1  # -1 = not playing

        written = 0
        for midi in range(self.global_minimum_note, self.global_maximum_note + 1):
            simultaneous = 0
            for note in self.notes_between(midi, time, time + self.lookup_time):
                upcoming.add(midi)
                if note.start >= time + self.roll_time:
                    continue
                if simultaneous < MAX_ROLLING:
                    roll[note.note, simultaneous] = (
                        note.start, note.end, note.channel, note.velocity)
                    simultaneous += 1
                if not (note.start <= time <= note.end):
                    continue

                # Shorten the perceived press so adjacent notes read twice
                too_small = (note.end - note.start) < self.release_before_end
                shorter = time < (note.end - self.release_before_end)
                if shorter or too_small:
                    self.key_press_dynamics.target[midi] = note.velocity
                channels[0][midi] = note.channel

                other = self._playing_matrix[midi][note.channel]
                if (other is None) or (other.end > note.end):
                    play_velocity = int(128 * ((note.velocity / 128) ** 0.5))
                    self.fluid_key_down(midi, play_velocity, note.channel)
                    self._playing_matrix[midi][note.channel] = note

            written += simultaneous
            for channel in range(MAX_CHANNELS * self.scene.realtime):
                other = self._playing_matrix[midi][channel]
                if other and other.end < time:
                    self._playing_matrix[midi][channel] = None
                    self.fluid_key_up(midi, other.channel)

        # Dynamic zoom follows the lookahead window
        self.note_range_dynamics.frequency = 0.5 / self.lookup_time
        if self.note_range_dynamics.value.sum() == 0:
            self.note_range_dynamics.value[:] = (
                self.global_minimum_note, self.global_maximum_note)
        self.note_range_dynamics.target = np.array((
            min(upcoming, default=self.global_minimum_note),
            max(upcoming, default=self.global_maximum_note)), np.float32)

        self.note_range_dynamics.next(dt=dt)
        self.key_press_dynamics.next(dt=dt)
        ShaderPiano.frames_scanned += 1
        ShaderPiano.notes_written += written
        return roll, channels

    def prewarm(self) -> None:
        if self.scene.freewheel and self.precompute:
            self._precompute_sequences()

    def update(self) -> None:
        if self.scene.freewheel and self.precompute:
            if self.keys_texture.sequence is None or self._range_values is None:
                self._precompute_sequences()
            index = min(self.scene._frame_counter, len(self._range_values) - 1)
            self.note_range_dynamics.value = self._range_values[index]
            return

        # The per-frame scan into the three textures: written during the
        # frame loop, the engine streams them (a snapshot each frame)
        self.keys_texture.set_sequence(None)
        self.channel_texture.set_sequence(None)
        self.roll_texture.set_sequence(None)
        roll, channels = self._scan_frame(
            self.scene.time + self.time_offset, abs(self.scene.dt))
        self.keys_texture.write(data=self.key_press_dynamics.value.astype(np.float32))
        self.roll_texture.write(data=roll)
        self.channel_texture.write(data=channels.astype(np.float32))

    def ui(self):
        yield (f"notes {sum(1 for _ in self.notes)}  "
               f"range {self.global_minimum_note}-{self.global_maximum_note}")
        rng = self.note_range_dynamics.value
        yield f"visible {rng[0]:.1f}-{rng[1]:.1f}  roll {self.roll_time:.1f}s"
        yield f"synth: {'live' if self.fluidsynth else 'off'}"

    def pipeline(self) -> Iterable[ShaderVariable]:
        yield Uniform("int", f"{self.name}GlobalMin", self.global_minimum_note)
        yield Uniform("int", f"{self.name}GlobalMax", self.global_maximum_note)
        yield Uniform("vec2", f"{self.name}Dynamic", self.note_range_dynamics.value)
        yield Uniform("float", f"{self.name}RollTime", self.roll_time)
        yield Uniform("float", f"{self.name}Extra", self.extra_keys)
        yield Uniform("float", f"{self.name}Height", self.height)
        yield Uniform("int", f"{self.name}Limit", MAX_ROLLING)
        yield Uniform("float", f"{self.name}BlackRatio", self.black_ratio)

    # -- FluidSynth (live synthesis, realtime only) -----------------------------

    @staticmethod
    def fluid_install() -> None:
        if not shutil.which("fluidsynth"):
            logger.warn("FluidSynth binary not found; live MIDI synthesis is disabled")

    def fluid_start(self) -> None:
        try:
            import fluidsynth
        except ImportError:
            logger.warn("pyfluidsynth not installed; live MIDI synthesis is disabled")
            return
        self.fluidsynth = fluidsynth.Synth()
        self.fluidsynth.setting("synth.gain", 1.2)
        self.fluidsynth.start()

    def fluid_load(self, soundfont) -> None:
        if self.fluidsynth is not None:
            self.soundfont = self.fluidsynth.sfload(str(soundfont))
            for channel in range(MAX_CHANNELS):
                self.fluid_select(channel, 0, 0)

    def fluid_select(self, channel: int = 0, bank: int = 0, preset: int = 0) -> None:
        if self.fluidsynth and self.scene.realtime:
            self.fluidsynth.program_select(channel, self.soundfont, bank, preset)

    def fluid_key_down(self, note: int, velocity: int = 127, channel: int = 0) -> None:
        if self.fluidsynth and self.scene.realtime:
            self.fluidsynth.noteon(channel, note, velocity)

    def fluid_key_up(self, note: int, channel: int = 0) -> None:
        if self.fluidsynth and self.scene.realtime:
            self.fluidsynth.noteoff(channel, note)

    def fluid_all_notes_off(self) -> None:
        if self.fluidsynth and self.scene.realtime:
            for channel, note in itertools.product(range(MAX_CHANNELS), range(MAX_NOTE)):
                self.fluidsynth.noteoff(channel, note)
