"""
Inputs made from the run's seed. Each input of a configuration names a
kind, and `portbench/inputs/<kind>.py` makes it:

    make(name, item, seed, directory, clip_seconds) -> ([paths], [decoded data])

one path a clip or image, into a directory the caller owns (the run's
temporary directory). The same seed gives the same bytes, and every seed
the same sizes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator for one input of one seed (any whole number)."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), *stream])


def make_inputs(spec: dict, seed: int, directory: Path, clip_seconds: float,
                bench: Path = None) -> dict:
    """The files a configuration's `inputs` ask for -> {input name: [paths]},
    and the decoded content the reference reads under "<name>.data"."""
    from portbench.harness import registry
    made: dict = {}
    for name, item in spec.items():
        make = registry.input_maker(item["kind"], bench or registry.BENCH)
        made[name], made[f"{name}.data"] = make(name, item, seed, directory, clip_seconds)
    return made
