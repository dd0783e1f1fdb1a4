"""
The port's roofline for the graded configurations, on one CUDA card.

    python examples/torch/roofline.py [config ...] [--cpu]
    python examples/torch/roofline.py --one <config>   (one config: one JSON line)

Counterpart of tools/roofline.py, over its six configurations at their
sizes and batches (tools/roofline.py:63-70). For each one, in a process of
its own (one process holding six scenes' buffers measures the allocator,
not the render: tools/roofline.py:23-27):

  ms a frame   steady: the median wall of a three-batch null export
               (Scene.main, output="null") less the median of a one-batch
               export, over the two batches' frames (WARM_RUNS turns of
               both after a cold three-batch export). Set-up, the first
               flush's fill and the last drain cancel; what an export
               pays for each further frame stays, its share of the audio
               precompute included
  count        the cost walker (shaderflow_tpu_torch/tools/flopcount.py)
               over one engine.flush of a batch, over its frames: plain
               ATen ops by class (alu, sfu, mma), each hand-written kernel
               by its declared block cost times its blocks
               (ops/fractal.py:_escape_cost for K3, tailgen.kernel_cost
               for K1, sampling._expand_cost for K2: the plain versions on
               CPU tensors declare the card's launch); bytes: the kernels'
               declared traffic, at least the frame's u8 output
  bound        flopcount.roofline: the larger of the bytes over 3.35 TB/s
               and the ops over their unit's peak (ALU one float32
               instruction per lane and clock, 128 x 132 x 1.98e9 a second;
               SFU 16 per SM and clock), the unit that bounds the frame,
               and the share bound / measured
  K3's loop    Mandelbrot's escape loop depends on the data: it closes
               with the count maps of the walked flush's frames (K3 called
               again on each frame's own lines, torch_fractals.
               mandelbrot_lines), at the granularity csrc/escape.cu
               executes (a warp of 8 x 4 pixels runs until its slowest
               lane's count, rounded up to the CHECK steps between its
               exit branches; interior pixels iterate none). Useful and
               executed steps a pixel are reported. RayMarch's march is a
               Python loop the walker runs, so its count is what ran.

RayMarch renders at 5-9 fps: two batches of 128 would take 30-50 s an
export, and its 13,592 ops a frame go through the walker one by one in
Python. Its exports are cut to 15 and 30 frames (one flush each, the
difference 15 frames) and its walked flush to 4 frames (CUTS).

A share over 100 % is a fault of the count: the tool raises and names the
config. Prints a table, then one JSON line a config. Needs no JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

# tools/roofline.py:63-70
CONFIGS = {
    "basic": dict(width=512, height=288, fps=30.0, ssaa=1.0, batch=128),
    "bars": dict(width=1280, height=720, fps=30.0, ssaa=1.0, batch=128),
    "visualizer": dict(width=1920, height=1080, fps=60.0, ssaa=2.0, batch=128),
    "mandelbrot": dict(width=1920, height=1080, fps=60.0, ssaa=2.0, batch=128),
    "raymarch": dict(width=1920, height=1080, fps=60.0, ssaa=1.0, batch=128),
    "pianoroll": dict(width=3840, height=2160, fps=60.0, ssaa=1.0, batch=64),
}
WARM_RUNS = 3
BATCHES = (1, 3)     # the short and the long export, in batches
# config -> (the short and long exports' frames, the walked flush's frames)
CUTS = {"raymarch": ((15, 30), 4)}
# csrc/escape.cu: a warp's tile of pixels, and the steps between exit branches
WARP_ROWS, WARP_COLS, CHECK = 8, 4, 2


def scene_for(name: str):
    import torch_demo
    import torch_fractals
    import torch_piano_roll

    class Mandelbrot(torch_fractals.Mandelbrot):
        """The graded Mandelbrot; while `k3_frames` is a list, it keeps each
        trivial-camera frame's context (for K3's count map)."""
        k3_frames = None

        def build(self):
            super().build()

            def fragment(sf):
                if self.k3_frames is not None and sf.uniform("iCameraTrivial", default=False):
                    self.k3_frames.append(sf)
                return torch_fractals.mandelbrot_frag(sf)

            self.shader.fragment = fragment

    return {
        "basic": torch_demo.Basic,
        "bars": torch_demo.MusicBars,
        "visualizer": torch_demo.Visualizer,
        "mandelbrot": Mandelbrot,
        "raymarch": torch_demo.RayMarch,
        "pianoroll": torch_piano_roll.PianoRoll,
    }[name]()


class ShareAboveOne(AssertionError):
    """A bound above the measured time: the count claims more work than ran."""


def check_share(name: str, bound_ms: float, ms: float) -> float:
    """bound / measured; raises ShareAboveOne, naming the config, over 1."""
    share = bound_ms / ms
    if share > 1.0:
        raise ShareAboveOne(f"{name}: the bound {bound_ms:.4f} ms exceeds the measured "
                            f"{ms:.4f} ms a frame ({share:.0%} of light): the count is wrong")
    return share


def escape_steps(counts, interior, trip: int) -> dict:
    """K3's work over a count map: the useful steps a pixel (each pixel's
    count, interior pixels none) and the executed ones (each 8 x 4 warp
    runs until its slowest lane's count rounded up to CHECK steps, at most
    the trip; every lane of the warp waits for it)."""
    import torch
    steps = torch.where(interior, 0, counts.to(torch.int64))
    height, width = steps.shape
    executed = torch.clamp(-(-steps // CHECK) * CHECK, max=trip)
    rows, cols = -(-height // WARP_ROWS), -(-width // WARP_COLS)
    padded = torch.nn.functional.pad(executed, (0, cols * WARP_COLS - width,
                                                0, rows * WARP_ROWS - height))
    warps = padded.reshape(rows, WARP_ROWS, cols, WARP_COLS).amax(dim=(1, 3))
    lanes = warps.repeat_interleave(WARP_ROWS, 0).repeat_interleave(WARP_COLS, 1)
    return {"useful_steps_px": float(steps.double().mean()),
            "executed_steps_px": float(lanes[:height, :width].double().mean())}


def frame_steps(frames: list) -> dict:
    """K3's useful and executed steps a pixel, averaged over the frame
    contexts `frames`: K3 lines on each frame's own lines and budget."""
    import torch
    import torch_fractals
    from shaderflow_tpu_torch.ops.fractal import _interior_mask, escape_iterations_sep
    total = {"useful_steps_px": 0.0, "executed_steps_px": 0.0}
    for sf in frames:
        cx_line, cy_line = torch_fractals.mandelbrot_lines(sf)
        quality, cap = torch_fractals.mandelbrot_quality(sf)
        counts = escape_iterations_sep(cx_line, cy_line, quality, saturate=cap)
        cx, cy = torch.broadcast_tensors(cx_line[None, :], cy_line[:, None])
        for key, value in escape_steps(counts, _interior_mask(cx, cy), min(quality, cap)).items():
            total[key] += value / len(frames)
    return total


def frame_cost(scene, frames: int) -> dict:
    """One frame's count at the scene's configuration (Scene._setup_run
    done): `frames` frames captured as an export does, then one
    engine.flush of them walked -> {"cost": flopcount.Cost a frame,
    "kernels": launches a frame by name, "steps": K3's useful and executed
    steps a pixel, where its lines form ran}."""
    import torch
    from shaderflow_tpu_torch.tools import flopcount
    engine = scene.engine
    scene._prewarm_modules()
    engine.begin_batch()
    for _ in range(frames):
        scene.next(dt=scene.frametime)
    recording = hasattr(scene, "k3_frames")
    if recording:
        scene.k3_frames = []
    with flopcount.Walker() as walker:
        out = engine.flush(frames)
    if out.device.type == "cuda":
        torch.cuda.synchronize(out.device)
    cost = walker.cost.scaled(1.0 / frames)
    cost.io_bytes = out[0].numel() * out.element_size()
    steps = frame_steps(scene.k3_frames) if recording and scene.k3_frames else None
    return {"cost": cost, "kernels": {name: count / frames
                                      for name, count in walker.kernels.items()},
            "steps": steps}


def steady_ms(name: str, walls: dict) -> float:
    """{frames: export walls (s)} of a short and a long export -> ms a frame
    of the frames the long one adds: the difference of their median walls
    over the difference of their frames. Raises, naming the config, where
    the long export was not the slower."""
    (short, short_walls), (long, long_walls) = sorted(walls.items())
    extra = statistics.median(long_walls) - statistics.median(short_walls)
    if extra <= 0:
        raise AssertionError(f"{name}: the {long}-frame export took no longer than the "
                             f"{short}-frame one ({walls})")
    return 1e3 * extra / (long - short)


def measure_one(name: str, device: str) -> dict:
    import torch
    from shaderflow_tpu_torch.tools import flopcount
    config = CONFIGS[name]
    scene = scene_for(name)
    short, long = CUTS[name][0] if name in CUTS else tuple(
        batches * config["batch"] for batches in BATCHES)
    common = dict(width=config["width"], height=config["height"], fps=config["fps"],
                  ssaa=config["ssaa"], batch=config["batch"], output="null", device=device)

    def export(frames: int) -> float:
        started = time.perf_counter()
        scene.main(time=frames / config["fps"], **common)
        if device != "cpu":
            torch.cuda.synchronize()
        return time.perf_counter() - started

    cold = export(long)
    walls = {short: [], long: []}
    for _ in range(WARM_RUNS):
        for frames in (short, long):
            walls[frames].append(export(frames))
    ms = steady_ms(name, walls)

    started = time.perf_counter()
    scene._setup_run(width=config["width"], height=config["height"], fps=config["fps"],
                     ssaa=config["ssaa"], time=long / config["fps"], freewheel=True,
                     device=device)
    counted = frame_cost(scene, CUTS[name][1] if name in CUTS else config["batch"])
    count_s = time.perf_counter() - started
    cost, steps = counted["cost"], counted["steps"]
    loop_trips = steps["executed_steps_px"] if steps else 0.0
    if cost.unknown_loops and not steps:
        raise AssertionError(f"{name}: a data-dependent kernel loop with no measured count")
    bound_ms, bound_by = flopcount.roofline(cost, loop_trips)
    loop_alu = sum(per_trip * loop_trips * multiplier
                   for _, per_trip, multiplier in cost.unknown_loops)
    row = {
        "config": name, **{key: config[key] for key in ("width", "height", "fps", "ssaa",
                                                       "batch")},
        "device": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
        "frames": [short, long], "cold_s": cold, "warm_s": [walls[short], walls[long]],
        "count_s": count_s, "ms_per_frame": ms, "export_fps": 1e3 / ms,
        "long_ms_per_frame": 1e3 * statistics.median(walls[long]) / long,
        "alu_pf": cost.alu + loop_alu, "sfu_pf": cost.sfu, "mma_pf": cost.mma,
        "bytes_pf": cost.bytes, "bound_ms": bound_ms, "bound_by": bound_by,
        "kernels_pf": counted["kernels"],
    }
    if steps:
        row.update(steps)
    row["share"] = check_share(name, bound_ms, ms) if device != "cpu" else None
    return row


def table(rows: list, card: str) -> list[str]:
    lines = [
        f"Roofline of the port's graded configs on {card} "
        "(`python examples/torch/roofline.py`; each config in its own process):",
        "",
        "| Config | frames (short, long) | steady ms/frame | long wall ms/frame | ALU Gop "
        "| SFU Gop | MMA GFLOP | GB | bound ms | bound by | share |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        share = "—" if r["share"] is None else f"{r['share']:.1%}"
        lines.append(
            f"| {r['config']} {r['width']}x{r['height']}@{r['fps']:g} ssaa={r['ssaa']:g} "
            f"batch={r['batch']} | {r['frames'][0]}, {r['frames'][1]} "
            f"| {r['ms_per_frame']:.3f} | {r['long_ms_per_frame']:.3f} | {r['alu_pf'] / 1e9:.3f} "
            f"| {r['sfu_pf'] / 1e9:.3f} | {r['mma_pf'] / 1e9:.3f} | {r['bytes_pf'] / 1e9:.4f} "
            f"| {r['bound_ms']:.4f} | {r['bound_by']} | {share} |")
    for r in rows:
        if "useful_steps_px" in r:
            lines += ["", f"{r['config']}: K3 takes {r['useful_steps_px']:.2f} useful escape "
                          f"steps a pixel and executes {r['executed_steps_px']:.2f} (8 x 4 "
                          f"warps wait for their slowest lane; {CHECK} steps between exits)."]
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    parser.add_argument("configs", nargs="*", help=f"any of {', '.join(CONFIGS)} (default: all)")
    parser.add_argument("--cpu", action="store_true", help="a smoke run on the CPU (no share)")
    parser.add_argument("--one", choices=list(CONFIGS), help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if args.one:
        import torch
        if device != "cpu" and not torch.cuda.is_available():
            raise RuntimeError("roofline measures on a CUDA card: none is available "
                               "(pass --cpu for a smoke run)")
        print(json.dumps(measure_one(args.one, device)), flush=True)
        return 0
    from shaderflow_tpu_torch import switches
    switches.refuse("roofline")
    unknown = sorted(set(args.configs) - set(CONFIGS))
    if unknown:
        parser.error(f"unknown configs {unknown}: choose from {list(CONFIGS)}")
    rows = []
    for name in args.configs or list(CONFIGS):
        command = [sys.executable, str(Path(__file__).resolve()), "--one", name] + (
            ["--cpu"] if args.cpu else [])
        started = time.perf_counter()
        process = subprocess.run(command, capture_output=True, text=True)
        if process.returncode != 0:
            print(process.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"roofline: config {name} failed")
        rows.append(json.loads(process.stdout.strip().splitlines()[-1]))
        rows[-1]["process_s"] = time.perf_counter() - started
    from psnr_gate import card_line
    print("\n".join(table(rows, "the CPU (smoke)" if args.cpu else card_line())))
    for row in rows:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
