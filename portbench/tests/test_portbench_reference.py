"""The plain references against shaderflow_tpu_torch on the CPU at small
sizes: every frame of a clip, through the harness's own export path,
within one u8 step of the reference's on under 0.1 % of the values (the
float32 convolution and products may sum in another order; the port's
own bar for its kernels against their plain versions is one step on under
1 %). Only the tests import the port beside a reference."""

import os
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import cell as cells, registry
from portbench.harness.window import BenchSink, Window, bench_sink


def export_every_frame(root: Path, name: str, seed: int, scratch: Path) -> tuple:
    from shaderflow_tpu_torch import exporting
    cell = cells.Cell(name, seed, root, scratch)
    os.environ.update(cell.config["env"])
    window = Window(0.0, float("inf"))
    scene = cell.scene(0)
    keep = set(range(cell.clip_frames))
    with bench_sink(exporting, lambda helper: BenchSink(window, 0, keep, scene)):
        scene.main(**cell.main_options("cpu", cell.clip_frames))
    reference = registry.reference(cell.workload["config"], root / "portbench")
    expected = reference.render(cell.config, cell.traffic, cell.inputs,
                                [(0, 0, frame) for frame in sorted(keep)], "cpu")
    return window.kept, expected


@pytest.mark.parametrize("name", ["visualizer.tiny", "mandelbrot.tiny", "mandelbrot.tiny4"])
def test_reference_equals_the_port_on_the_cpu(tiny_root, tmp_path, name):
    port, expected = export_every_frame(tiny_root, name, 2**31 + 5, tmp_path)
    assert len(port) == len(expected) == 60
    for key, frame in port.items():
        assert frame.shape == expected[key].shape
        diff = np.abs(frame.astype(np.int16) - expected[key].astype(np.int16))
        assert diff.max() <= 1, key
        assert np.count_nonzero(diff) < 1e-3 * diff.size, key


def test_visualizer_frames_move_with_the_music(tiny_root, tmp_path):
    """The comparison is not of constant frames: the visualizer's change
    from frame to frame, and with the seed's clip."""
    port, _ = export_every_frame(tiny_root, "visualizer.tiny", 2**31 + 5, tmp_path)
    assert not np.array_equal(port[(0, 10)], port[(0, 40)])
    (tmp_path / "b").mkdir()
    other, _ = export_every_frame(tiny_root, "visualizer.tiny", 2**31 + 6, tmp_path / "b")
    assert not np.array_equal(port[(0, 40)], other[(0, 40)])
