"""On the card, at the cell's own size: the piano roll's controls
(pianoroll_controls.py) come out not correct on every seed, and sound
runs of the port correct. The two wrong ports (the roll of the frame
before, the stencil in float32) run on three seeds each; the precision
control, the reference's tail in bfloat16, is compared with each sound
run's own frames. Prints every reading, from which the limit in
portbench/configs/pianoroll.json was set (PERF.md §2).

    python3 -m pytest -m cuda portbench/tests/test_portbench_pianoroll_control.py -s
    PORTBENCH_SOUND_SEEDS=6 ...     (sound seeds; default 3)
"""

import contextlib
import json
import os
import tempfile
import time
from pathlib import Path

import pytest

from pianoroll_controls import CONTROLS, bf16_reference
from portbench.harness import cell, compare, registry

CELL = "pianoroll.4k-ssaa1"
SECONDS = 8.0


def _reading(seed: int, control: str = None) -> dict:
    with (CONTROLS[control] if control else contextlib.nullcontext)():
        outcome = cell.run(CELL, seed, SECONDS, False, process_start=time.perf_counter(),
                           device="cuda")
    return {"cell": CELL, "seed": seed, "control": control,
            "correct": outcome["result"]["correct"], "values": outcome["values"],
            "lines": outcome["lines"], "kept": outcome["window"].kept}


def _lower_precision(reading: dict) -> dict:
    """The precision control on a sound run's frames: the same inputs made
    again from the seed, the reference's tail in bfloat16."""
    with tempfile.TemporaryDirectory() as scratch:
        made = cell.Cell(CELL, reading["seed"], registry.ROOT, Path(scratch))
        kept = reading["kept"]
        requests = [(job, made.clip_of(job), frame) for job, frame in sorted(kept)]
        with bf16_reference(registry.reference("pianoroll")) as lower:
            expected = lower.render(made.config, made.traffic, made.inputs, requests, "cuda")
    values = compare.numbers([(kept[key], expected[key]) for key in sorted(kept)])
    correct, lines = compare.judge(values, made.config["compare"], 0)
    return {"cell": CELL, "seed": reading["seed"], "control": "bf16_reference",
            "correct": correct, "values": values, "lines": lines}


@pytest.mark.cuda
def test_pianoroll_controls_are_not_correct(card):
    sound_seeds = int(os.environ.get("PORTBENCH_SOUND_SEEDS", "3"))
    sound = [_reading(4_300_000_000 + k) for k in range(sound_seeds)]
    controls = [_lower_precision(reading) for reading in sound]
    controls += [_reading(4_400_000_000 + 10 * k + n, name)
                 for n, name in enumerate(CONTROLS) for k in range(3)]
    for reading in sound + controls:
        print("READING", json.dumps({k: v for k, v in reading.items() if k != "kept"}),
              flush=True)
    assert all(r["correct"] for r in sound)
    assert not any(r["correct"] for r in controls)
