"""A run with the timed path broken underneath comes out not correct: the
harness's run without its look for a card, on the CPU at small sizes, for
each fault a cell can have. (One chip: there is no exchange between chips
to leave out. The Mandelbrot scene has no time: a frozen clock is no fault
there.)"""

import time

import pytest

from portbench.harness import cell


def frozen_clock(monkeypatch):
    from shaderflow_tpu_torch.scene import ShaderScene
    step = ShaderScene.next
    monkeypatch.setattr(ShaderScene, "next", lambda self, dt=0.0: step(self, 0.0))


def half_batch(monkeypatch):
    """Frames of the batch's second half left unrendered (black)."""
    from shaderflow_tpu_torch.engine import RenderEngine
    flush = RenderEngine.flush

    def broken(self, count=None):
        frames = flush(self, count)
        frames[frames.shape[0] // 2:] = 0
        return frames
    monkeypatch.setattr(RenderEngine, "flush", broken)


def altered_pixel(monkeypatch):
    """One pixel of every frame inverted where the frame is produced."""
    from shaderflow_tpu_torch.engine import RenderEngine
    flush = RenderEngine.flush

    def broken(self, count=None):
        frames = flush(self, count)
        height, width = frames.shape[1:3]
        frames[:, height // 2, width // 2] = 255 - frames[:, height // 2, width // 2]
        return frames
    monkeypatch.setattr(RenderEngine, "flush", broken)


def run(root, name, seed=3):
    return cell.run(name, seed, 10.0, False, process_start=time.perf_counter(),
                    device="cpu", root=root)["result"]


@pytest.mark.parametrize("name", ["visualizer.tiny", "mandelbrot.tiny", "mandelbrot.tiny4"])
def test_sound_run_is_correct(tiny_root, name):
    result = run(tiny_root, name)
    assert result["correct"] is True, result


@pytest.mark.parametrize("name,fault", [
    ("visualizer.tiny", frozen_clock),
    ("visualizer.tiny", half_batch),
    ("visualizer.tiny", altered_pixel),
    ("mandelbrot.tiny", half_batch),
    ("mandelbrot.tiny", altered_pixel),
    ("mandelbrot.tiny4", altered_pixel),
])
def test_fault_is_not_correct(tiny_root, monkeypatch, name, fault):
    fault(monkeypatch)
    result = run(tiny_root, name)
    assert result["correct"] is False, result


def test_control_is_not_correct_on_the_cpu(tiny_root):
    """The control at a CPU size: the port's bfloat16 tail."""
    result = cell.run("visualizer.tiny", 3, 6.0, False, process_start=time.perf_counter(),
                      device="cpu", root=tiny_root, env={"SHADERFLOW_TAIL_BF16": "1"})
    assert result["result"]["correct"] is False
