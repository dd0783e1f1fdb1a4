"""Piano note model (the part of shaderflow_tpu/piano the ported slices use)."""

from shaderflow_tpu_torch.piano.notes import PIANO_NOTES, PianoNote  # noqa: F401
