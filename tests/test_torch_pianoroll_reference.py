"""The piano-roll configuration of the benchmark (portbench/configs/
pianoroll.json) on the CPU at a small size: the port's PianoRoll exported
through the harness's own path against the plain reference
(portbench/reference/pianoroll.py), the three controls refused by the
configuration's limits, and the seeded MIDI and WAV inputs.

    python -m pytest tests/test_torch_pianoroll_reference.py -q
"""

import importlib.util
import json
import os
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "portbench" / "tests"))

from pianoroll_controls import CONTROLS, bf16_reference  # noqa: E402
from portbench.harness import cell as cells, compare, registry  # noqa: E402
from portbench.harness.inputs import make_inputs, rng_for  # noqa: E402
from portbench.inputs import piano_midi  # noqa: E402
from portbench.harness.window import BenchSink, Window, bench_sink  # noqa: E402


def _portbench_fixtures():
    """portbench/tests/conftest.py, by its path (tests/ has a conftest too)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_tests_conftest", ROOT / "portbench" / "tests" / "conftest.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CELL = "pianoroll.tiny"
SEED = 2**31 + 17
# Seeds whose first clip's tempo lies on either side of 120 bpm
SEEDS = (2**31 + 17, 2**33 + 1, -5)


@pytest.fixture(scope="module")
def piano_root(tmp_path_factory) -> Path:
    """A small checkout whose BENCHMARK.json adds pianoroll.tiny: 192x108,
    ssaa 1, 2 s clips, batches of 8, every frame compared."""
    root = _portbench_fixtures().make_tiny_root(tmp_path_factory.mktemp("checkout"))
    benchmark = json.loads((root / "BENCHMARK.json").read_text())
    benchmark["workloads"].append({"name": CELL, "config": "pianoroll",
                                   "traffic": "tiny-192-ssaa1", "chips": 1,
                                   "why": "CPU size"})
    (root / "BENCHMARK.json").write_text(json.dumps(benchmark))
    (root / "portbench" / "traffic" / "tiny-192-ssaa1.json").write_text(json.dumps(
        {"width": 192, "height": 108, "ssaa": 1, "clip_seconds": 2.0, "batch": 8,
         "compare_frames": 3}))
    return root


def export_every_frame(root: Path, seed: int, scratch: Path, env: dict = None) -> tuple:
    """(the cell, the port's frames of clip 0 as the harness's sink kept
    them: {(0, frame): (H, W, 3) u8})."""
    from shaderflow_tpu_torch import exporting
    cell = cells.Cell(CELL, seed, root, scratch)
    saved = {name: os.environ.get(name) for name in cell.config["env"]}
    os.environ.update({**cell.config["env"], **(env or {})})
    try:
        window = Window(0.0, float("inf"))
        scene = cell.scene(0)
        keep = set(range(cell.clip_frames))
        with bench_sink(exporting, lambda helper: BenchSink(window, 0, keep, scene)):
            scene.main(**cell.main_options("cpu", cell.clip_frames))
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
    return cell, window.kept


@pytest.fixture(scope="module")
def sound(piano_root, tmp_path_factory) -> tuple:
    """(cell, the port's frames, the reference's frames) of SEED."""
    cell, port = export_every_frame(piano_root, SEED, tmp_path_factory.mktemp("sound"))
    reference = registry.reference("pianoroll", piano_root / "portbench")
    expected = reference.render(cell.config, cell.traffic, cell.inputs,
                                [(0, 0, frame) for _, frame in sorted(port)], "cpu")
    return cell, port, expected


def judged(cell, port: dict, expected: dict) -> tuple:
    values = compare.numbers([(port[key], expected[key]) for key in sorted(port)])
    return compare.judge(values, cell.config["compare"], len(expected) - len(port))


def test_reference_equals_the_port_on_the_cpu(sound):
    """Every frame of a 2 s clip within the configuration's limits; on the
    CPU the port's plain tail and the reference agree bit for bit."""
    cell, port, expected = sound
    assert len(port) == len(expected) == cell.clip_frames == 120
    correct, lines = judged(cell, port, expected)
    assert correct, lines
    for key, frame in port.items():
        assert frame.shape == expected[key].shape == (108, 192, 3)
        assert np.array_equal(frame, expected[key]), key


def test_frames_move_with_the_notes(sound):
    """The comparison is not of still frames: the roll falls from frame to
    frame and the keyboard lights under the notes."""
    _, port, _ = sound
    assert not np.array_equal(port[(0, 30)], port[(0, 31)])
    assert len({port[(0, f)].tobytes() for f in range(0, 120, 10)}) == 12


@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_each_control_fails_the_limit(piano_root, sound, tmp_path, control):
    """A port that reads the roll of the frame before, or runs the
    stencil in float32, is refused."""
    cell, _, expected = sound
    with CONTROLS[control]():
        _, port = export_every_frame(piano_root, SEED, tmp_path)
    correct, lines = judged(cell, port, expected)
    assert not correct, lines


def test_reference_in_bfloat16_fails_the_limit(piano_root, sound):
    """The precision below the configuration's: the reference's tail in
    bfloat16 against the sound port is refused."""
    cell, port, _ = sound
    with bf16_reference(registry.reference("pianoroll", piano_root / "portbench")) as lower:
        expected = lower.render(cell.config, cell.traffic, cell.inputs,
                                [(0, 0, frame) for _, frame in sorted(port)], "cpu")
    correct, lines = judged(cell, port, expected)
    assert not correct, lines


@pytest.mark.parametrize("seed", SEEDS)
def test_both_parsers_give_the_makers_notes(tmp_path, seed):
    """The reference's own SMF reader and the port's load_midi read the
    maker's notes from its bytes, in one order; the seeds hold first
    tempi over and under 120 bpm (a file's tempo at tick 0 replaces the
    default)."""
    from shaderflow_tpu_torch.piano.midi import load_midi
    make = registry.input_maker("piano_midi")
    paths, data = make("midi", {"clips": 1}, seed, tmp_path, 20.0)
    blob = paths[0].read_bytes()
    reference = registry.reference("pianoroll").parse_smf(blob)
    port = [(n.pitch, n.start, n.end, n.channel, n.velocity) for n in load_midi(paths[0]).notes]
    assert reference == port
    assert sorted(port) == sorted(data[0]) and len(port) > 100
    assert struct.unpack(">HH", blob[8:12]) == (1, 3)          # type 1, three tracks


def test_seeds_hold_both_sides_of_120_bpm():
    tempi = [piano_midi.TempoMap(rng_for(seed, 6, 0), 20.0).first for seed in SEEDS]
    assert min(tempi) < 500000 < max(tempi)


def test_every_seed_gives_the_same_sizes(tmp_path):
    """Clip counts, WAV shapes and rates do not move with the seed; the
    bytes do, and one seed gives the same bytes twice."""
    config = registry.config("pianoroll")
    shapes, blobs = set(), []
    for n, seed in enumerate((*SEEDS, SEEDS[0])):
        directory = tmp_path / str(n)
        directory.mkdir()
        made = make_inputs(config["inputs"], seed, directory, 2.0)
        shapes.add((len(made["midi"]), len(made["audio"]),
                    tuple(a.shape for a in made["audio.data"])))
        blobs.append(b"".join(path.read_bytes() for path in made["midi"] + made["audio"]))
        assert all(0 <= note[1] < 2.0 for notes in made["midi.data"] for note in notes)
    assert shapes == {(3, 3, ((88200, 2),) * 3)}
    assert blobs[0] == blobs[-1] and len(set(blobs)) == len(SEEDS)
