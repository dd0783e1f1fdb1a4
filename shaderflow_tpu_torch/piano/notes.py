"""
12-TET note math as plain vectorized functions, with a thin value-object
facade (`PianoNote`) for scene code.

A copy of shaderflow_tpu/piano/notes.py (numpy only): the same public
surface (PianoNote, PIANO_NOTES, the from_*/get constructors and the
index/name/frequency conversions). Module-level functions accept scalars
or numpy arrays.

Conventions: MIDI index (A4 = 69, C4 = 60), octaves named scientific pitch
(C4 = index 60 -> octave = index // 12 - 1), default tuning A4 = 440 Hz.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Union

import numpy as np

#: Pitch-class spellings, sharps only (flats accepted on parse).
PIANO_NOTES = ("C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B")

#: Bit i set <=> pitch class i is a black key (C#=1, D#=3, F#=6, G#=8, A#=10).
_BLACK_KEYS = sum(1 << pc for pc in (1, 3, 6, 8, 10))

_NAME_PATTERN = re.compile(r"^\s*([A-Ga-g])([#bs♯♭]?)\s*(-?\d+)\s*$")
_LETTER_CLASS = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}

Scalar = Union[int, float, np.ndarray]


# -- pure conversions (scalar or ndarray in, matching type out) -------------

def note_frequency(index: Scalar, tuning: float = 440.0) -> Scalar:
    """Equal-temperament frequency of a MIDI index (vectorizes)."""
    return tuning * 2.0 ** ((np.asarray(index, np.float64) - 69.0) / 12.0) \
        if isinstance(index, np.ndarray) else tuning * 2.0 ** ((index - 69) / 12)


def nearest_note(frequency: Scalar, tuning: float = 440.0) -> Scalar:
    """MIDI index of the closest 12-TET note to a frequency (vectorizes)."""
    semitones = 12.0 * np.log2(np.asarray(frequency, np.float64) / tuning) + 69.0
    rounded = np.rint(semitones).astype(np.int64)
    return rounded if isinstance(frequency, np.ndarray) else int(rounded)


def note_name(index: int) -> str:
    """Scientific pitch name of a MIDI index: 60 -> 'C4', 61 -> 'C#4'."""
    octave, pitch_class = divmod(int(index), 12)
    return f"{PIANO_NOTES[pitch_class]}{octave - 1}"


def parse_note(name: str) -> int:
    """MIDI index of a note name. Accepts sharps ('C#4', 'Cs4', '♯'),
    flats ('Db4', '♭'), lowercase letters, and negative octaves ('C-1')."""
    match = _NAME_PATTERN.match(name)
    if not match:
        raise ValueError(f"Not a note name: {name!r}")
    letter, accidental, octave = match.groups()
    pitch_class = _LETTER_CLASS[letter.upper()]
    if accidental in ("#", "s", "♯"):
        pitch_class += 1
    elif accidental in ("b", "♭"):
        pitch_class -= 1
    return pitch_class + 12 * (int(octave) + 1)


def is_black_key(index: Scalar) -> Union[bool, np.ndarray]:
    """True where the MIDI index lands on a black key (vectorizes)."""
    if isinstance(index, np.ndarray):
        return (_BLACK_KEYS >> (index % 12)) & 1 == 1
    return bool((_BLACK_KEYS >> (int(index) % 12)) & 1)


# -- value object ------------------------------------------------------------

@dataclass(slots=True)
class PianoNote:
    """One timed note event. Conversions delegate to the module functions;
    this class only adds the (start, end, channel, velocity) envelope the
    piano roll renders."""

    note: int = 60
    start: float = 0.0
    end: float = 0.0
    channel: int = 0
    velocity: int = 100
    tuning: float = 440.0

    def __repr__(self) -> str:
        return (f"PianoNote({self.name}, start={self.start:.3f}, "
                f"end={self.end:.3f}, ch={self.channel}, vel={self.velocity})")

    # Constructors: one per input domain, plus a duck-typed dispatcher.

    @classmethod
    def from_index(cls, note: int, **kwargs) -> "PianoNote":
        return cls(note=int(note), **kwargs)

    @classmethod
    def from_name(cls, name: str, **kwargs) -> "PianoNote":
        return cls(note=parse_note(name), **kwargs)

    @classmethod
    def from_frequency(cls, frequency: float, **kwargs) -> "PianoNote":
        tuning = kwargs.get("tuning", 440.0)
        return cls(note=nearest_note(frequency, tuning), **kwargs)

    @classmethod
    def get(cls, value: Any, **kwargs) -> "PianoNote":
        """Coerce ints (index) / strs (name) / floats (Hz) / PianoNotes;
        kwargs update an existing instance in place (spectrogram.from_notes
        passes tuning= through whatever the caller handed it)."""
        if isinstance(value, PianoNote):
            for field, item in kwargs.items():
                setattr(value, field, item)
            return value
        if isinstance(value, str):
            return cls.from_name(value, **kwargs)
        if isinstance(value, float):
            return cls.from_frequency(value, **kwargs)
        if isinstance(value, (int, np.integer)):
            return cls.from_index(value, **kwargs)
        return cls(**kwargs)

    # Static conversion aliases (the spelling scene code / tests use).

    index_to_name = staticmethod(note_name)
    name_to_index = staticmethod(parse_note)

    @staticmethod
    def index_to_frequency(index: int, *, tuning: float = 440.0) -> float:
        return note_frequency(index, tuning)

    @staticmethod
    def frequency_to_index(frequency: float, *, tuning: float = 440.0) -> int:
        return nearest_note(frequency, tuning)

    @staticmethod
    def name_to_frequency(name: str, *, tuning: float = 440.0) -> float:
        return note_frequency(parse_note(name), tuning)

    @staticmethod
    def frequency_to_name(frequency: float, *, tuning: float = 440.0) -> str:
        return note_name(nearest_note(frequency, tuning))

    @staticmethod
    def is_black(note: int) -> bool:
        return is_black_key(note)

    @staticmethod
    def is_white(note: int) -> bool:
        return not is_black_key(note)

    # Derived views.

    @property
    def name(self) -> str:
        return note_name(self.note)

    @name.setter
    def name(self, value: str) -> None:
        self.note = parse_note(value)

    @property
    def frequency(self) -> float:
        return note_frequency(self.note, self.tuning)

    @frequency.setter
    def frequency(self, value: float) -> None:
        self.note = nearest_note(value, self.tuning)

    @property
    def black(self) -> bool:
        return is_black_key(self.note)

    @property
    def white(self) -> bool:
        return not is_black_key(self.note)

    @property
    def duration(self) -> float:
        return self.end - self.start

    @duration.setter
    def duration(self, value: float) -> None:
        self.end = self.start + value
