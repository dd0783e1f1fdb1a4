"""
Device time of kernel K3's three graded forms on one CUDA card, for the
port in a given checkout, so that two trees can be compared in one run.

    python examples/torch/bench_k3.py [--repo DIR] [--label NAME] [--repeats 50]
        [--forms lines,rotated,julia] [--json PATH]

Imports shaderflow_tpu_torch and the example scenes from DIR (default: this
checkout) and builds that tree's csrc/escape.cu with nvcc. Run it once for
this tree and once with --repo set to a parent's `git archive`, in turns
(parent, change, change, parent), to compare two trees on one card. To
time another setting of the kernel's constants, edit them and run again.
The forms, at the slices' render size
(3840x2160, the 1080p exports at 2x SSAA): `lines`, the Mandelbrot default
view's lines (max_iter 500, cap 142); `rotated`, frame 0's c field of
MandelbrotRotated; `julia`, frame 0's z0 planes and c of Julia (cap 290),
both from a short export through chip_smoke.py's helpers. For each form,
the kernel is checked torch.equal to the plain loop, then timed by device
time (chip_smoke.device_ms over --repeats calls, the mean of two turns).
Prints one JSON line per form (and appends them to PATH with --json): the
form, the label, the card, ms, the bound (cost walker), the mean escape
steps a pixel, lane efficiencies computed from the counts
(lane_efficiency: one thread a pixel with warps of 1 x 32, 4 x 8 and 8 x 4
pixels, rows x columns), and the compiled kernel's registers, spills and
SASS instructions a step
(shaderflow_tpu_torch/tools/sass.py of this checkout). Needs a CUDA card
and the CUDA toolkit; no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent.parent
WIDTH, HEIGHT, FPS, SSAA = 1920, 1080, 60, 2

# (mangled-name parts) of each form's float32-output kernel: this design's,
# then the one-thread-a-pixel kernels of the port's first K3
KERNELS = {
    "lines": [("escape_kernel", "6LinesCfE"), ("escape_lines_kernel", "IfE")],
    "rotated": [("escape_kernel", "5PairCfE"), ("escape_planes_kernel", "IfE")],
    "julia": [("escape_kernel", "6ApartCfE"), ("escape_planes_kernel", "IfE")],
}


def _load(name: str, path: Path):
    """A module of this checkout by its file (the package on sys.path may
    be another tree's)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build_escape() -> tuple[Path, str]:
    """Compile the imported tree's csrc/escape.cu into its build directory
    and load it as the tree's K3 library -> (its path, ptxas's report). The
    tree's own build may predate the kept report, so nvcc runs here."""
    from shaderflow_tpu_torch import BUILD_DIR, build
    from shaderflow_tpu_torch.ops import fractal
    source = Path(fractal.__file__).resolve().parent.parent / "csrc" / "escape.cu"
    path = BUILD_DIR / "bench_k3" / "libescape.so"
    path.parent.mkdir(parents=True, exist_ok=True)
    result = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(path), str(source)],
                            capture_output=True, text=True, timeout=600)
    if result.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{result.stdout}{result.stderr}")
    build._libraries["escape"] = ctypes.CDLL(str(path))
    fractal._escape_library()                    # binds the entry points' argtypes
    return path, result.stdout + result.stderr


def compiled_figures(sass, library: Path, log: str, form: str) -> dict:
    """Registers, spills (ptxas) and the hot loop's instructions a step
    (SASS) of the form's float32-output kernel."""
    text = sass.dump(library)
    for parts in KERNELS[form]:
        try:
            figures = sass.ptxas_figures(log, *parts)
        except ValueError:
            continue
        step = sass.step_figures(text, *parts)
        return {**figures, **{key: step[key] for key in
                              ("loop_instructions", "loop_steps", "instructions_per_step",
                               "ops")}}
    raise ValueError(f"no K3 kernel of form {form} in {library}")


def warp_efficiency(steps, warp_h: int = 1) -> float:
    """Useful steps over 32 x the slowest lane's, summed over warps of
    warp_h x (32 / warp_h) pixels (row-major, zero-padded at the edges): one
    thread a pixel."""
    import torch
    warp_w = 32 // warp_h
    height, width = steps.shape
    rows, cols = -(-height // warp_h), -(-width // warp_w)
    padded = torch.nn.functional.pad(steps, (0, cols * warp_w - width, 0, rows * warp_h - height))
    warps = padded.reshape(rows, warp_h, cols, warp_w).permute(0, 2, 1, 3).reshape(
        rows * cols, 32)
    return float(steps.sum()) / float(32 * warps.amax(1).sum())


def form_operands(smoke, form: str, device):
    """(run the kernel, run the plain loop, interior mask or None) at the
    form's slice shape."""
    import torch
    import torch_fractals
    from shaderflow_tpu_torch.ops import fractal
    from shaderflow_tpu_torch.ops.cameralib import project_trivial
    from shaderflow_tpu_torch.shader import make_coords
    render_h, render_w, aspect = HEIGHT * SSAA, WIDTH * SSAA, WIDTH / HEIGHT
    if form == "lines":
        coords = make_coords(render_h, render_w, aspect, device)
        rays = project_trivial(
            gluv_x=(coords.u_line * 2.0 - 1.0) * aspect, gluv_y=coords.v_line * 2.0 - 1.0,
            position=[0.0, 0.0, 0.0], zoom=1.0, isometric=0.0, orbital=0.0, dolly=0.0,
            focal_length=1.0, aspect=aspect, want_aspect=aspect, resolution=[WIDTH, HEIGHT])
        gluv_x, gluv_y = rays.line("gluv")
        cx, cy = (gluv_x - 0.5).contiguous(), gluv_y.contiguous()
        args = (cx, cy, 500, 3.0, torch_fractals.mandelbrot_cap(500), torch.float32)
        grid_x, grid_y = torch.broadcast_tensors(cx[None, :], cy[:, None])
        return (lambda: fractal.escape_iterations_sep(*args),
                lambda: fractal.escape_lines_plain(*args),
                fractal._interior_mask(grid_x, grid_y))
    cls = torch_fractals.Julia if form == "julia" else torch_fractals.MandelbrotRotated
    scene = cls()
    scene.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA, time=0.1, output="null",
               device="cuda")
    _, (z0, cx, cy, interior), quality = smoke.fractal_plain_frame(scene, 0, render_h, render_w)
    if form == "julia":
        cap = torch_fractals.julia_cap(quality)
        return (lambda: fractal.escape_iterations_z0(z0, cx, cy, quality, 3.0, None, cap, True,
                                                     torch.float32),
                lambda: fractal.escape_plain(z0[..., 0], z0[..., 1], cx, cy, quality, 3.0,
                                             saturate=cap, out_dtype=torch.float32),
                None)
    cap = torch_fractals.mandelbrot_cap(quality)
    return (lambda: fractal.escape_iterations(z0, quality, 3.0, cap, torch.float32),
            lambda: fractal.escape_plain(z0[..., 0], z0[..., 1], z0[..., 0], z0[..., 1],
                                         quality, 3.0, interior=interior, saturate=cap,
                                         out_dtype=torch.float32),
            interior)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", default=str(HERE))
    parser.add_argument("--label", default="this tree")
    parser.add_argument("--repeats", type=int, default=50)
    parser.add_argument("--forms", default="lines,rotated,julia")
    parser.add_argument("--json")
    args = parser.parse_args()
    repo = Path(args.repo).resolve()
    sys.path[:0] = [str(repo), str(repo / "examples" / "torch")]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_k3: times K3 on a CUDA card; no card here")
    smoke = _load("chip_smoke", HERE / "chip_smoke.py")
    sass = _load("k3_sass", HERE / "shaderflow_tpu_torch" / "tools" / "sass.py")
    device = torch.device("cuda", torch.cuda.current_device())
    card = smoke.card_line()
    path, log = build_escape()
    results = []
    for form in args.forms.split(","):
        run_kernel, run_plain, interior = form_operands(smoke, form, device)
        counts = run_kernel()
        if not torch.equal(counts, run_plain()):
            raise AssertionError(f"K3 {form} differs from the plain loop ({args.label})")
        steps = torch.where(interior, 0.0, counts) if interior is not None else counts
        steps = steps.to(torch.int64)
        bound_ms, bound_by = smoke.walked_bound(run_kernel, float(steps.float().mean()))
        times = [smoke.device_ms(run_kernel, args.repeats) for _ in range(2)]
        result = {"form": form, "label": args.label, "card": card,
                  "ms": statistics.mean(times), "ms_turns": times, "bound_ms": bound_ms,
                  "bound_by": bound_by, "steps_per_pixel": float(steps.float().mean()),
                  "lane_efficiency": {f"warp_{rows}x{32 // rows}": warp_efficiency(steps, rows)
                                      for rows in (1, 4, 8)},
                  **compiled_figures(sass, path, log, form)}
        print(json.dumps(result), flush=True)
        results.append(result)
    if args.json:
        with open(args.json, "a") as handle:
            for result in results:
                handle.write(json.dumps(result) + "\n")
    return 0

if __name__ == "__main__":
    raise SystemExit(main())
