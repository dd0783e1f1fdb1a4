"""The piano roll's spans and counters in the port's tracer
(shaderflow_tpu_torch/tracing.py) on the CPU: an export of PianoRoll from
a seeded MIDI performance records `piano.scan`, `engine.sequences` and
`tail.stencil` where the module note draws them, counts the frames it
scanned and the roll slots it wrote as the plain reference's scan does
(portbench/reference/pianoroll.py), and counts the bytes a sequence's
bind copies to another device; with no session open, those span sites
read no clock and make nothing.

    python -m pytest tests/test_torch_piano_tracing.py -q
"""

import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).parent))

from portbench.harness import registry  # noqa: E402
from portbench.harness.inputs import make_inputs  # noqa: E402
from test_torch_scene import _import_example  # noqa: E402

FPS, SECONDS = 30, 1.5
OPTIONS = dict(width=192, height=108, fps=FPS, time=SECONDS, ssaa=1, batch=16,
               output="null", device="cpu")
NEW = {"piano.scan": {"prewarm"}, "engine.sequences": {"engine.build", "engine.flush", "export"},
       "tail.stencil": {"tail"}}


@pytest.fixture(scope="module")
def clip(tmp_path_factory) -> dict:
    """A seeded 2 s performance and its audio (the benchmark's makers)."""
    inputs = registry.config("pianoroll")["inputs"]
    return make_inputs({name: {**item, "clips": 1} for name, item in inputs.items()},
                       2**31 + 29, tmp_path_factory.mktemp("clip"), 2.0)


def _scene(clip):
    module = _import_example("torch", "torch_piano_roll")
    return module.PianoRoll(midi_file=clip["midi"][0], audio_file=clip["audio"][0])


def test_piano_export_records_its_spans_and_counters(clip):
    from shaderflow_tpu_torch import tracing
    with tracing.session() as records:
        _scene(clip).main(**OPTIONS)
    spans = records.spans
    for name, parents in NEW.items():
        mine = [span for span in spans if span.name == name]
        assert mine, name
        assert all(spans[span.parent].name in parents for span in mine), name
    frames = round(FPS * SECONDS)
    assert sum(span.name == "piano.scan" for span in spans) == 1
    assert sum(span.name == "tail.stencil" for span in spans) == frames
    # The roll, keys and channel sequences, and the spectrogram's
    assert sum(span.name == "engine.sequences" for span in spans) == 4
    counters = records.counters[0]
    scan = registry.reference("pianoroll").Scan(
        registry.reference("pianoroll").parse_smf(clip["midi"][0].read_bytes()), frames, FPS)
    assert counters["piano.frames"] == frames
    assert counters["piano.notes"] == scan.slots_filled > 0
    assert counters["sequence.bytes"] == 0          # bound where they lie: no copy


def test_a_bind_to_another_device_counts_its_bytes(clip, monkeypatch):
    """sequence.bytes counts what a bind copies: here the piano's three
    sequences bound to the meta device (a copy that moves no data)."""
    from shaderflow_tpu_torch.engine import RenderEngine
    scene = _scene(clip)
    scene._setup_run(width=96, height=54, fps=FPS, time=SECONDS, freewheel=True, device="cpu")
    scene.piano._precompute_sequences()
    monkeypatch.setattr(RenderEngine, "device", property(lambda self: torch.device("meta")))
    monkeypatch.setattr(RenderEngine, "sequence_bytes", RenderEngine.sequence_bytes)
    before = RenderEngine.sequence_bytes
    scene.engine._refresh_textures()
    piano = scene.piano
    sequences = [piano.keys_texture.sequence, piano.channel_texture.sequence,
                 piano.roll_texture.sequence]
    assert RenderEngine.sequence_bytes - before == sum(seq.nbytes for seq in sequences)
    assert sequences[2].shape == (256, 128, 256, 4)            # padded to 256 frames
    bound = scene.engine.bound_sequences()
    assert all(seq.device.type == "meta" for seq in bound.values()) and len(bound) == 3


def test_span_sites_are_free_without_a_session(clip, monkeypatch):
    """No session: every span site of a piano export gets the one shared
    no-op context and the tracer reads no clock."""
    from shaderflow_tpu_torch import tracing

    def clock():
        raise AssertionError("the tracer read the clock while off")

    monkeypatch.setattr(tracing, "time", types.SimpleNamespace(perf_counter_ns=clock))
    handed = []
    span = tracing.span

    def watched(name):
        context = span(name)
        handed.append((name, context))
        return context

    monkeypatch.setattr(tracing, "span", watched)
    _scene(clip).main(**OPTIONS)
    assert set(NEW) <= {name for name, _ in handed}
    assert all(context is tracing._OFF for _, context in handed)
    assert tracing._records is None
