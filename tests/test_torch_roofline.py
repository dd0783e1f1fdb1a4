"""The port's per-config roofline (examples/torch/roofline.py) on the CPU:
a frame's count is the hand-written kernels' declared block costs times
their blocks (the plain versions on CPU tensors declare the launch the
card makes), K3's useful escape steps equal the JAX tool's
(tools/roofline.py:mandelbrot_rounds) on the same lines, the executed
steps follow csrc/escape.cu's warps, and a share over 100 % raises.
The timed exports run on the card (chip_smoke.py phase 49)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_scene import _import_example

from shaderflow_tpu_torch.ops import fractal, tailfuse, tailgen
from shaderflow_tpu_torch.tools import flopcount

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def roofline():
    # scene_for imports the example scenes by name: this checkout's, not
    # those another test file of the worker imported from a copied tree
    for name in ("torch_demo", "torch_fractals", "torch_piano_roll"):
        _import_example("torch", name)
    return _import_example("torch", "roofline")


def _counted(roofline, name: str, width: int, height: int, ssaa: float, frames: int):
    scene = roofline.scene_for(name)
    scene._setup_run(width=width, height=height, fps=60, ssaa=ssaa, time=frames / 60,
                     freewheel=True, device="cpu")
    return scene, roofline.frame_cost(scene, frames)


def test_mandelbrot_frame_is_its_kernels_declared_costs(roofline, monkeypatch):
    """A 96x54, 2x SSAA Mandelbrot frame (one walked flush of 4, over its
    frames): one K3 lines launch and one K1 launch; the count's bytes and
    escape loop are K3's per-pixel cost times its pixels plus K1's block
    cost times its blocks; its SFU ops are K1's; its ALU ops are K1's and
    a few line-sized ops outside the kernels (the camera's coordinate
    lines); K3's steps come from every walked frame."""
    declared = []
    original = tailgen.declared_plain

    def keep(*args):
        declared.append(args)
        return original(*args)

    monkeypatch.setattr(tailgen, "declared_plain", keep)
    width, height = 96, 54
    render_h, render_w = 2 * height, 2 * width
    frames = 4
    scene, counted = _counted(roofline, "mandelbrot", width, height, 2.0, frames)
    cost = counted["cost"]
    assert counted["kernels"] == {"K3 lines": 1, "K1": 1}
    assert len(declared) == len(scene.k3_frames) == frames
    assert 0 < counted["steps"]["useful_steps_px"] <= counted["steps"]["executed_steps_px"]

    pixels = render_h * render_w
    k3 = fractal._escape_cost(pixels, 4 * (render_h + render_w)).scaled(pixels)
    spec, rh, rw, out_h, out_w, s, aspect, quantize = declared[0]
    assert (rh, rw, out_h, out_w, s, quantize) == (render_h, render_w, height, width, 2, True)
    _, keys, op_counts, tile = tailgen._generated(spec, rh, rw, s, aspect, quantize)
    pointers = tailgen._operands(spec, keys, rh, rw, torch.device("cpu"))
    _, blocks, block_cost = tailgen._launch_cost(op_counts, tile, pointers, out_h, out_w, s,
                                                 quantize)
    k1 = block_cost().scaled(blocks)
    whole = tailgen.kernel_cost(op_counts, pointers, (out_h, out_w, 3), torch.uint8, s, True)
    assert k1.alu == pytest.approx(whole.alu) and k1.kernel_bytes == pytest.approx(
        whole.kernel_bytes)

    # one entry a walked frame, each over the frames: the frame's pixels
    assert k3.unknown_loops == [("K3 escape step", fractal.ESCAPE_STEP_OPS, float(pixels))]
    assert cost.unknown_loops == [("K3 escape step", fractal.ESCAPE_STEP_OPS,
                                   pixels / frames)] * frames
    assert cost.kernel_bytes == pytest.approx(k3.kernel_bytes + k1.kernel_bytes)
    assert cost.sfu == pytest.approx(k1.sfu) and cost.mma == 0
    outside = cost.alu - k1.alu
    # the camera's lines: O(H + W), not one op of any pixel
    assert 0 <= outside <= 32 * (render_h + render_w) < pixels, outside
    assert cost.io_bytes >= height * width * 3


def test_visualizer_frame_counts_k2_once_a_flush(roofline):
    """The visualizer's bar field expands in a batch prelude: K2 once a
    flush, a fraction of it a frame; K1 once a frame."""
    frames = 4
    _, counted = _counted(roofline, "visualizer", 64, 36, 2.0, frames)
    assert counted["kernels"] == {"K2": pytest.approx(1 / frames), "K1": 1}
    assert counted["steps"] is None
    assert counted["cost"].unknown_loops == []


JAX_ROUNDS = """
import json, sys
sys.path.insert(0, {tools!r})
import roofline
print(json.dumps(roofline.mandelbrot_rounds({width}, {height}, {ssaa})))
"""


def test_useful_steps_equal_the_jax_tool(roofline):
    """At a 96x54, 2x SSAA view, K3's counts (its plain version) on the
    JAX tool's lines with its cap give its useful steps a pixel
    (tools/roofline.py:87, run on XLA:CPU without FMA as the exact-count
    tests run it). The tool's cap (130) is not the scene's (142,
    torch_fractals.mandelbrot_cap, as examples/fractals/fractals.py
    computes it): the port closes K3's loop with the counted frame's own
    map instead."""
    width, height, ssaa = 96, 54, 2.0
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               SHADERFLOW_NO_COMPILE_CACHE="1")
    script = JAX_ROUNDS.format(tools=str(REPO / "tools"), width=width, height=height,
                               ssaa=ssaa)
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]
    jax = json.loads(result.stdout.strip().splitlines()[-1])

    render_w, render_h = round(width * ssaa), round(height * ssaa)
    xs = (np.arange(render_w) + 0.5) / render_w * 2.0 - 1.0
    ys = 1.0 - (np.arange(render_h) + 0.5) / render_h * 2.0
    cx = torch.tensor(xs * (width / height) - 0.5, dtype=torch.float32)
    cy = torch.tensor(ys, dtype=torch.float32)
    counts = fractal.escape_iterations_sep(cx, cy, jax["quality"], radius=3.0,
                                           saturate=jax["cap"], out_dtype=torch.float32)
    gx, gy = torch.broadcast_tensors(cx[None, :], cy[:, None])
    steps = roofline.escape_steps(counts, fractal._interior_mask(gx, gy), jax["cap"])
    print(f"useful {steps['useful_steps_px']:.6f} (JAX {jax['useful_iters_px']:.6f}), "
          f"executed {steps['executed_steps_px']:.3f} at 8 x 4 warps "
          f"(JAX {jax['executed_iters_px']:.3f} at the TPU's sub-blocks)")
    assert steps["useful_steps_px"] == pytest.approx(jax["useful_iters_px"], rel=1e-6)
    torch_fractals = _import_example("torch", "torch_fractals")
    assert torch_fractals.mandelbrot_cap(jax["quality"]) == 142 != jax["cap"]


@pytest.mark.parametrize("slow,executed", [(5, 6), (7, 8), (130, 130)])
def test_executed_steps_follow_the_warps(roofline, slow, executed):
    """csrc/escape.cu: an 8 x 4 warp runs until its slowest lane's count,
    rounded up to the CHECK (2) steps between exit branches, at most the
    trip; interior pixels iterate none. One slow pixel in an 8 x 8 map:
    its warp's 32 lanes execute its steps, the other warp's none."""
    counts = torch.zeros((8, 8), dtype=torch.int32)
    counts[3, 1] = slow
    counts[6, 6] = 500                       # an interior pixel: reports max_iter
    interior = torch.zeros((8, 8), dtype=torch.bool)
    interior[6, 6] = True
    steps = roofline.escape_steps(counts, interior, trip=130)
    assert steps["useful_steps_px"] == pytest.approx(slow / 64)
    assert steps["executed_steps_px"] == pytest.approx(executed * 32 / 64)


def test_steady_ms_is_what_the_long_export_adds(roofline):
    """Steady ms a frame: the median wall of the long export less the
    short one's, over the frames it adds (set-up cancels); an export that
    was not slower for its extra frames raises, naming the config."""
    walls = {384: [2.9, 2.5, 2.6], 128: [1.3, 0.9, 1.0]}
    assert roofline.steady_ms("visualizer", walls) == pytest.approx(1e3 * 1.6 / 256)
    with pytest.raises(AssertionError, match="basic"):
        roofline.steady_ms("basic", {128: [1.0], 384: [0.9]})


def test_share_above_one_raises(roofline):
    """A bound above the measured time is a fault of the count: it raises,
    naming the config (the JAX table's 486 % and 2541 % rows)."""
    assert roofline.check_share("mandelbrot", 0.5, 2.0) == 0.25
    with pytest.raises(roofline.ShareAboveOne, match="raymarch"):
        roofline.check_share("raymarch", 25.41, 1.0)


def test_walker_counts_the_plain_kernels_as_declared():
    """K1, K2 and K3 on CPU tensors declare the card's launch to the walker
    and skip their plain versions' ops: the same count on either device."""
    index = torch.arange(64, dtype=torch.int32) % 7
    tables = torch.ones((3, 7), dtype=torch.bfloat16)
    with flopcount.Walker() as walker:
        from shaderflow_tpu_torch.ops import sampling
        sampling.expand_tables(tables, index)
    assert walker.kernels == {"K2": 1}
    assert walker.cost.alu == 0
    assert walker.cost.kernel_bytes == pytest.approx(64 * (4 + 3 * 4) + 3 * 7 * 2)
    c = torch.stack(torch.meshgrid(torch.linspace(-2, 0.5, 8), torch.linspace(-1, 1, 4),
                                   indexing="xy"), dim=-1)
    with flopcount.Walker() as walker:
        fractal.escape_iterations(c, 20)
        fractal.escape_iterations_z0(c, 0.1, 0.2, 20)
    assert walker.kernels == {"K3 planes": 2}
    assert walker.cost.alu == 0
    assert walker.cost.kernel_bytes == pytest.approx(2 * (32 * 4 + 8 * 32) + 8)
    assert flopcount.walking() is False
    spec = tailfuse.make_spec(lambda tp: (tp.plane("c") * 0.5, tp.plane("c"), tp.plane("c")),
                              8, 16, c=torch.ones((8, 16)))
    with flopcount.Walker() as walker:
        tailfuse.fused_tail_final(spec, 8, 16, 4, 8, 2, 2.0)
    assert walker.kernels == {"K1": 1}
    assert walker.cost.kernel_bytes == 8 * 16 * 4 + 4 * 8 * 3
