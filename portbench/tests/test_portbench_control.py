"""On the card, at each cell's own size: the control, the port with its
bfloat16 tail (SHADERFLOW_TAIL_BF16=1, the step below the configurations'
float32 color chain), has to come out not correct, on three seeds; and
sound runs of the port correct. Prints every reading, from which the
limits in the configurations' files were set (PERF.md).

    python3 -m pytest -m cuda portbench/tests/test_portbench_control.py -s
    PORTBENCH_SOUND_SEEDS=12 ...     (sound seeds a cell; default 3)
"""

import json
import os
import time

import pytest

from portbench.harness import cell, registry

CELLS = [w["name"] for w in registry.load_benchmark()["workloads"]]
SECONDS = 8.0


def _reading(name: str, seed: int, env: dict) -> dict:
    outcome = cell.run(name, seed, SECONDS, False, process_start=time.perf_counter(),
                       device="cuda", env=env)
    result = outcome["result"]
    return {"cell": name, "seed": seed, "env": env, "correct": result["correct"],
            "values": outcome["values"], "lines": outcome["lines"]}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(card, name):
    sound_seeds = int(os.environ.get("PORTBENCH_SOUND_SEEDS", "3"))
    sound = [_reading(name, 4_100_000_000 + k, {"SHADERFLOW_TAIL_BF16": "0"})
             for k in range(sound_seeds)]
    control = [_reading(name, 4_200_000_000 + k, {"SHADERFLOW_TAIL_BF16": "1"})
               for k in range(3)]
    for reading in sound + control:
        print("READING", json.dumps(reading))
    assert all(r["correct"] for r in sound)
    assert not any(r["correct"] for r in control)
