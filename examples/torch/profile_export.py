"""
Where the time of a port export goes, on one CUDA card.

    python examples/torch/profile_export.py
        [visualizer|visualizer_bf16|mandelbrot|mandelbrot_rotated|julia|pianoroll]
        [--seconds 2] [--runs 5] [--json PATH]

Exports the scene into the NullSink at its graded configuration (1920x1080,
60 fps, 2x SSAA; pianoroll: 3840x2160, 60 fps, ssaa=1; visualizer_bf16:
the visualizer under SHADERFLOW_TAIL_BF16=1 and SHADERFLOW_VIZ_BLUR_LEVEL=1,
the combination the JAX package grades): one cold run
(builds and compiles), `--runs` warm runs timed by the wall clock
(median), then one warm run under torch.profiler. Prints as JSON (and
writes to PATH with --json): the warm walls and frames/s, the device
time by kernel and in all (CUDA activity of the profiled run), the device
busy share of the profiled wall, and host milliseconds per frame of the
export loop's stages (perf_counter around scene.next, the batch preludes,
the fragment, the tail's trace, codegen and launch, the equal-resolution
stencil, the whole flush).
Needs a CUDA card; no JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def _timed(owner, attribute: str, label: str, totals: dict) -> None:
    """Wrap owner.attribute so each call adds its perf_counter time to
    totals[label] (host time: the device runs asynchronously)."""
    original = getattr(owner, attribute)

    @functools.wraps(original)
    def wrapper(*args, **kwargs):
        started = time.perf_counter()
        try:
            return original(*args, **kwargs)
        finally:
            totals[label] += time.perf_counter() - started

    setattr(owner, attribute, wrapper)


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    parser = argparse.ArgumentParser()
    parser.add_argument("scene", nargs="?", default="visualizer",
                        choices=("visualizer", "visualizer_bf16", "mandelbrot",
                                 "mandelbrot_rotated", "julia", "pianoroll"))
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--json", type=Path, default=None)
    args = parser.parse_args()
    from shaderflow_tpu_torch import switches
    switches.refuse("profile_export")
    if not torch.cuda.is_available():
        print("profile_export: needs a CUDA card", file=sys.stderr)
        return 2
    if args.scene == "visualizer_bf16":
        os.environ.update(SHADERFLOW_TAIL_BF16="1", SHADERFLOW_VIZ_BLUR_LEVEL="1")

    import torch_demo
    import torch_fractals
    import torch_piano_roll
    from shaderflow_tpu_torch import engine as engine_module
    from shaderflow_tpu_torch import scene as scene_module
    from shaderflow_tpu_torch.ops import tailfuse, tailgen
    from shaderflow_tpu_torch.shader import ShaderProgram

    make, width, height, ssaa = {
        "visualizer": (torch_demo.Visualizer, 1920, 1080, 2),
        "visualizer_bf16": (torch_demo.Visualizer, 1920, 1080, 2),
        "mandelbrot": (torch_fractals.Mandelbrot, 1920, 1080, 2),
        "mandelbrot_rotated": (torch_fractals.MandelbrotRotated, 1920, 1080, 2),
        "julia": (torch_fractals.Julia, 1920, 1080, 2),
        "pianoroll": (torch_piano_roll.PianoRoll, 3840, 2160, 1),
    }[args.scene]
    frames = round(args.seconds * 60)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    def export():
        scene = make()
        torch.cuda.synchronize()
        started = time.perf_counter()
        scene.main(width=width, height=height, fps=60, ssaa=ssaa, time=args.seconds,
                   output="null", device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - started

    cold = export()
    walls = [export() for _ in range(args.runs)]

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled = export()
    kernels = defaultdict(float)
    for event in prof.key_averages():
        # Device-side events only (kernels, copies): the CPU ops that
        # launched them report the same time again
        if event.device_type == DeviceType.CUDA and event.self_device_time_total > 0:
            kernels[event.key[:100]] += event.self_device_time_total / 1e3
    device_ms = sum(kernels.values())

    totals: dict[str, float] = defaultdict(float)
    _timed(scene_module.ShaderScene, "next", "scene.next (module updates + capture)", totals)
    _timed(engine_module.RenderEngine, "_run_preludes", "batch preludes", totals)
    _timed(ShaderProgram, "render_layer", "fragment", totals)
    _timed(tailfuse, "fused_tail_final", "tail: trace, codegen and launch", totals)
    _timed(tailgen, "prepare", "tail: trace and codegen", totals)
    _timed(tailfuse, "final_equal_resolution", "equal-resolution stencil + quantize", totals)
    _timed(engine_module.RenderEngine, "flush", "engine.flush (all frames)", totals)
    instrumented = export()

    result = {
        "scene": args.scene, "size": f"{width}x{height}", "ssaa": ssaa,
        "frames": frames, "card": card,
        "cold_wall_s": cold, "warm_walls_s": walls,
        "median_fps": frames / statistics.median(walls),
        "profiled_wall_s": profiled, "device_ms": device_ms,
        "device_ms_per_frame": device_ms / frames,
        "device_busy_share": device_ms / 1e3 / profiled,
        "device_ms_by_kernel": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:15]),
        "instrumented_wall_s": instrumented,
        "host_ms_per_frame": {label: 1e3 * seconds / frames
                              for label, seconds in totals.items()},
    }
    text = json.dumps(result, indent=1)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
