"""Piano notes, the MIDI parser and the piano-roll module."""

from shaderflow_tpu_torch.piano.midi import MidiFile, MidiNote, load_midi, write_midi  # noqa: F401
from shaderflow_tpu_torch.piano.module import (  # noqa: F401
    MAX_CHANNELS, MAX_NOTE, MAX_ROLLING, ShaderPiano)
from shaderflow_tpu_torch.piano.notes import PIANO_NOTES, PianoNote  # noqa: F401
