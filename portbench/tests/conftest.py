"""Fixtures of the benchmark's tests: a small checkout (`tiny_root`) whose
BENCHMARK.json adds cells at CPU sizes, and the card check for tests
marked `cuda` (decided inside the fixture, never at import)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Cells small enough for the CPU: the port's banded row sampling runs at
# these sizes as at the benchmark's (the visualizer needs a render height
# over about 222 rows for it)
TINY = {
    "visualizer.tiny": ("visualizer", "tiny-256", {"width": 256, "height": 144, "ssaa": 2}),
    "mandelbrot.tiny": ("mandelbrot", "tiny-96", {"width": 96, "height": 54, "ssaa": 2}),
    "mandelbrot.tiny4": ("mandelbrot", "tiny-96-ssaa4", {"width": 96, "height": 54, "ssaa": 4}),
}


def make_tiny_root(directory: Path, clip_seconds: float = 1.0) -> Path:
    """A checkout of the benchmark with TINY's cells: portbench/ copied,
    the port and its examples linked."""
    shutil.copytree(ROOT / "portbench", directory / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name in ("shaderflow_tpu_torch", "examples"):
        (directory / name).symlink_to(ROOT / name)
    benchmark = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, (config, traffic, size) in TINY.items():
        benchmark["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                       "chips": 1, "why": "CPU size"})
        (directory / "portbench" / "traffic" / f"{traffic}.json").write_text(json.dumps(
            {**size, "clip_seconds": clip_seconds, "batch": 8, "compare_frames": 3}))
    (directory / "BENCHMARK.json").write_text(json.dumps(benchmark))
    return directory


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def card():
    """Skips a test marked `cuda` where torch sees no CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name()
