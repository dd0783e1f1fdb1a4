"""
Device time of kernel K1's graded forms on one CUDA card, for the port in a
given checkout, so that two trees can be compared in one run.

    python examples/torch/bench_k1.py [--repo DIR] [--label NAME] [--repeats 50]
        [--forms a,bc,d,bf16_bc,bf16_a] [--json PATH]

Imports shaderflow_tpu_torch and the example scenes from DIR (default: this
checkout), builds each form's tail spec at its slice shape with the plain
functions (chip_smoke.py's helpers: the Mandelbrot tail over the default
view's escape counts; the visualizer's tail of frame 0 after a short
export, in f32 and in the bf16 level-1 mode; PianoRoll's tail of frame 0 at
4K, ssaa=1) and times the bound kernel (tailgen.prepare's launch) by
device time: torch.profiler's CUDA kernel durations over --repeats
launches, the mean of two turns. Prints one JSON line per form (and
appends them to PATH with --json): the form, the tree's label, the card,
ms, and the compiled kernel's registers, spills and tile where the tree
records them.
Needs a CUDA card; no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent.parent
WIDTH, HEIGHT, FPS = 1920, 1080, 60


def _smoke():
    """chip_smoke.py of this checkout, for its spec helpers and device_ms."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def form_args(smoke, form: str, device):
    """(tailgen.prepare's positional arguments, quantize) of one graded form."""
    import torch
    import torch_demo
    import torch_fractals
    import torch_piano_roll
    from shaderflow_tpu_torch.ops import fractal, tailfuse
    from shaderflow_tpu_torch.ops.cameralib import project_trivial
    from shaderflow_tpu_torch.shader import make_coords
    render_h, render_w, aspect = HEIGHT * 2, WIDTH * 2, WIDTH / HEIGHT
    if form in ("a", "bf16_a"):
        coords = make_coords(render_h, render_w, aspect, device)
        rays = project_trivial(
            gluv_x=(coords.u_line * 2.0 - 1.0) * aspect, gluv_y=coords.v_line * 2.0 - 1.0,
            position=[0.0, 0.0, 0.0], zoom=1.0, isometric=0.0, orbital=0.0, dolly=0.0,
            focal_length=1.0, aspect=aspect, want_aspect=aspect, resolution=[WIDTH, HEIGHT])
        gluv_x, gluv_y = rays.line("gluv")
        cap = torch_fractals.mandelbrot_cap(500)
        counts = fractal.escape_lines_plain((gluv_x - 0.5).contiguous(), gluv_y.contiguous(),
                                            500, 3.0, cap, torch.float32)
        spec = tailfuse.make_spec(
            torch_fractals.mandelbrot_tail(500, True), render_h, render_w, iters=counts,
            oob=tailfuse.Col(rays.out_of_bounds_x.to(torch.float32)))
        return (spec, render_h, render_w, HEIGHT, WIDTH, 2, aspect), True
    if form in ("bc", "bf16_bc"):
        scene = torch_demo.Visualizer()
        scene.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=2, time=0.1, output="null",
                   device="cuda")
        spec = smoke.visualizer_spec(scene, 0)
        return (spec, render_h, render_w, HEIGHT, WIDTH, 2, aspect), True
    scene = torch_piano_roll.PianoRoll()
    scene.main(width=3840, height=2160, fps=FPS, ssaa=1, time=0.1, output="null",
               device="cuda")
    spec = smoke.piano_spec(scene, 0)
    return (spec, 2160, 3840, 2160, 3840, 1, scene.aspect_ratio), False


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", default=str(HERE))
    parser.add_argument("--label", default="this tree")
    parser.add_argument("--repeats", type=int, default=50)
    parser.add_argument("--forms", default="a,bc,d,bf16_bc,bf16_a")
    parser.add_argument("--json")
    args = parser.parse_args()
    repo = Path(args.repo).resolve()
    sys.path[:0] = [str(repo), str(repo / "examples" / "torch")]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_k1: times K1 on a CUDA card; no card here")
    smoke = _smoke()
    from shaderflow_tpu_torch.ops import tailgen
    device = torch.device("cuda", torch.cuda.current_device())
    card = smoke.card_line()
    results = []
    for form in args.forms.split(","):
        bf16 = form.startswith("bf16")
        os.environ.update(SHADERFLOW_TAIL_BF16="1" if bf16 else "0",
                          SHADERFLOW_VIZ_BLUR_LEVEL="1" if bf16 else "4")
        prepare_args, quantize = form_args(smoke, form, device)
        out_h, out_w = prepare_args[3], prepare_args[4]
        out = (torch.empty((out_h, out_w, 3), dtype=torch.uint8, device=device) if quantize
               else torch.empty((3, out_h, out_w), dtype=torch.bfloat16, device=device))
        launch = tailgen.prepare(*prepare_args, device, quantize=quantize)
        times = [smoke.device_ms(lambda: launch(out), args.repeats) for _ in range(2)]
        result = {"form": form, "label": args.label, "card": card,
                  "ms": statistics.mean(times), "ms_turns": times}
        compiled = getattr(launch, "compiled", None)
        if compiled is not None:
            regs, spills = tailgen.registers(compiled)
            result.update(n_regs=regs, n_spills=spills, tile=list(getattr(launch, "tile", ())))
        print(json.dumps(result), flush=True)
        results.append(result)
    if args.json:
        with open(args.json, "a") as handle:
            for result in results:
                handle.write(json.dumps(result) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
