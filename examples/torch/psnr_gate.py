"""
The PSNR parity gate of the PyTorch port, on one CUDA card.

    python examples/torch/psnr_gate.py [--cpu] [--out PATH]

Counterpart of tools/psnr_gate.py, with its configurations and its bars,
so the table compares row for row with PSNR_GATE.md:

  ORACLE rows        the port's frames against the independent NumPy
                     transcription of the reference GLSL (tools/gl_oracle.py,
                     loaded by path from this checkout: both gates use one
                     oracle). >= 40 dB (BASELINE.md); the binary scenes by
                     exact-pixel agreement (>= 0.99 of pixels within 2 u8
                     steps); Tetration >= 0.99, or >= 0.98 with at most 5 %
                     of its flips (> 1 step) off the oracle's 2-px-dilated
                     escape boundary. Two rows more at the graded size:
                     the visualizer and Mandelbrot at 1920x1080, 2x SSAA,
                     one frame each (K2 with K1 (b)+(c), K3 lines with
                     K1 (a): the shapes of the graded exports).
  FUSED-vs-REF rows  the frames of the fused route (K1-K3 on the card)
                     against the reference route: each frame's tail
                     inputs, copied to the CPU, through the tail and final
                     pass of eval_reference (SHADERFLOW_NO_TAILFUSE=1, which
                     the port takes on CPU tensors only). Both sides read
                     the same inputs, as the JAX gate's two sides share
                     one device: a frame re-rendered whole on the CPU
                     differs where a chaotic orbit meets the other float
                     library (Tetration on an H100 against the CPU: 35.6 dB). >= 40 dB.
  bf16-tail-vs-ref   the visualizer under SHADERFLOW_TAIL_BF16=1 against
                     the same reference. >= 40 dB.

Frames render in this process (on the card; with --cpu on the CPU: a
smoke run of the plain versions); the oracle, NumPy on the host, runs in a
pool of processes (one a core, at most 8), each frame handed over as soon
as it is rendered: its fragment a task, a graded frame's in STRIPS row
strips (every oracle fragment is pointwise over its coordinate grid), and
the final pass here on the assembled render. Uniforms and textures reach the
oracle as the JAX gate hands them over: each frame's uniforms with the
statics, storage row 0 of a texture as the top row (the oracle samples
GL's bottom-up storage).

Writes the table to stdout and to --out (default build/psnr_gate.md,
gitignored), headed by the card's name and power limit (nvidia-smi). Exits
1 when any row is under its bar. Needs no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from datetime import datetime, timezone
from multiprocessing import get_context
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

BAR_DB = 40.0
AGREE_BAR = 0.99
AGREE_BAR_CHAOTIC = 0.98
STRAY_BAR = 0.05
# Row strips of each graded frame's oracle fragment, spread over the pool
STRIPS = 8

# name -> (scene key, width, height, ssaa, subsample, frames, scene kwargs):
# tools/psnr_gate.py:47-58, then the two graded rows
ORACLE_CONFIGS = {
    "default (welcome) ssaa=1": ("basic", 512, 288, 1.0, 1, 3, {}),
    "default (welcome) ssaa=2": ("basic", 512, 288, 2.0, 2, 3, {}),
    "mandelbrot (escape kernel + fused tail)":
        ("mandelbrot", 320, 180, 2.0, 2, 2, {"quality": 5}),
    "raymarch (camera rays + SDF)": ("raymarch", 320, 180, 1.0, 1, 2, {}),
    "visualizer (flagship, blur level 4)":
        ("visualizer", 320, 180, 1.0, 1, 3, {}),
    "bars": ("bars", 320, 180, 1.0, 1, 3, {}),
    "tetration (binary k)": ("tetration", 320, 180, 1.0, 1, 2, {}),
    "waveform (binary thresholds)": ("waveform", 320, 180, 1.0, 1, 3, {}),
    "visualizer 1920x1080 ssaa=2 (graded)": ("visualizer", 1920, 1080, 2.0, 2, 1, {}),
    "mandelbrot 1920x1080 ssaa=2 (graded)": ("mandelbrot", 1920, 1080, 2.0, 2, 1, {}),
}
GRADED_CONFIGS = {"visualizer 1920x1080 ssaa=2 (graded)",
                  "mandelbrot 1920x1080 ssaa=2 (graded)"}
AGREEMENT_CONFIGS = {"tetration (binary k)", "waveform (binary thresholds)"}
# Flips confined to the oracle's escape boundary (tools/psnr_gate.py:59-70)
CHAOTIC_CONFIGS = {"tetration (binary k)"}

# tools/psnr_gate.py:72-77
FUSED_CONFIGS = {
    "visualizer": ("visualizer", 640, 360, 2.0, 2, 2, {}),
    "pianoroll": ("pianoroll", 192, 108, 1.0, 2, 2, {}),
    "julia": ("julia", 320, 180, 2.0, 2, 2, {"quality": 5}),
    "tetration": ("tetration", 320, 180, 2.0, 2, 2, {}),
}


def scene_class(key: str):
    import torch_demo
    import torch_fractals
    import torch_piano_roll
    return {
        "basic": torch_demo.Basic,
        "visualizer": torch_demo.Visualizer,
        "bars": torch_demo.MusicBars,
        "waveform": torch_demo.Waveform,
        "raymarch": torch_demo.RayMarch,
        "mandelbrot": torch_fractals.Mandelbrot,
        "julia": torch_fractals.Julia,
        "tetration": torch_fractals.Tetration,
        "pianoroll": torch_piano_roll.PianoRoll,
    }[key]


def render_frames(key, width, height, ssaa, subsample, frames, kwargs, device="cuda"):
    """`frames` frames at 10 fps through the port's engine on `device` (one
    flush) -> (u8 frames (F, H, W, 3), each frame's uniforms with the
    statics as numpy, the scene). device="cuda" raises without a card."""
    scene = scene_class(key)(**kwargs)
    scene._setup_run(fps=10, time=frames / 10, freewheel=True, width=width, height=height,
                     ssaa=ssaa, subsample=subsample, device=device)
    scene._prewarm_modules()
    engine = scene.engine
    engine.begin_batch()
    for _ in range(frames):
        scene.next(dt=scene.frametime)
    uniforms = [{name: np.asarray(value) for name, value in {**engine._statics, **snapshot}.items()}
                for snapshot in engine._frame_uniforms]
    out = engine.flush(frames).cpu().numpy()
    return out, uniforms, scene


def oracle_textures(scene, uniform) -> dict:
    """The engine's textures for the oracle at this frame (tools/psnr_gate.py:
    _oracle_textures): storage row 0 = top, flipped to GL's row 0 = bottom."""
    engine = scene.engine
    k = int(np.asarray(uniform.get("iFrameIndex", 0)))
    textures = {}
    if "background" in engine.state.static_tex:
        textures["background"] = engine.state.static_tex["background"].cpu().numpy()[0, 0][::-1]
    sequences = engine.bound_sequences(engine.state)
    if "iSpectrogram" in sequences:
        seq = sequences["iSpectrogram"]
        textures["spectrogram"] = seq[min(k, len(seq) - 1)].cpu().numpy()[:, 0, :][::-1]
    if "iWaveform" in sequences:
        seq = sequences["iWaveform"]
        textures["waveform"] = seq[min(k, len(seq) - 1)].cpu().numpy()[0]
    return textures


def by_path(name: str, path: Path):
    """The module at `path` in this checkout, loaded once as `name`."""
    module = sys.modules.get(name)
    if module is None:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[name] = module
    return module


def oracle_module():
    """tools/gl_oracle.py of this checkout, loaded by path."""
    return by_path("gl_oracle", REPO / "tools" / "gl_oracle.py")


def card_line() -> str:
    """The card's name and power limit, as chip_smoke.py reads them."""
    return by_path("chip_smoke", REPO / "chip_smoke.py").card_line()


def oracle_tasks(name: str, frames, uniforms, scene) -> list:
    """One oracle task a frame: the arguments of oracle_frame."""
    key, width, height, _, subsample, _, _ = ORACLE_CONFIGS[name]
    tasks = []
    for frame, uniform in zip(frames, uniforms):
        merged = dict(uniform)
        if key == "mandelbrot":
            merged.setdefault("iQuality", merged.get("iQualityS", 0.05))
        textures = oracle_textures(scene, uniform) if key in ("visualizer", "bars",
                                                               "waveform") else {}
        tasks.append((name, key, frame, merged, textures, tuple(scene.render_resolution),
                      width, height, subsample, float(scene.aspect_ratio)))
    return tasks


def strip_rows(height: int, strips: int) -> list[tuple[int, int]]:
    """`height` rows cut into `strips` bands of nearly equal height."""
    bounds = [round(height * k / strips) for k in range(strips + 1)]
    return [(first, last) for first, last in zip(bounds, bounds[1:]) if last > first]


def oracle_strip(key, uniform, textures, render_size, aspect, rows) -> tuple:
    """Rows [first, last) of the oracle's fragment at `render_size` (GL's
    bottom-up order) -> (the (rows, W, 3) float32 render, seconds). Each
    oracle fragment is pointwise over gl_oracle.coords' grid, so it runs on
    those rows of the grid alone: coords is swapped, in this process, for
    the call."""
    oracle = oracle_module()
    started = time.perf_counter()
    plain = {"basic": oracle.default_fragment, "mandelbrot": oracle.mandelbrot_fragment,
             "raymarch": oracle.raymarch_fragment, "tetration": oracle.tetration_fragment}
    textured = {"visualizer": oracle.visualizer_fragment, "bars": oracle.bars_fragment,
                "waveform": oracle.waveform_fragment}
    whole = oracle.coords
    first, last = rows
    oracle.coords = lambda width, height, aspect: {
        name: grid[first:last] for name, grid in whole(width, height, aspect).items()}
    try:
        if key in plain:
            render = plain[key](uniform, *render_size, aspect)
        else:
            render = textured[key](uniform, *render_size, aspect, textures)
    finally:
        oracle.coords = whole
    return render, time.perf_counter() - started


def oracle_frame(name, key, frame, uniform, textures, render_size, width, height,
                 subsample, aspect, strips=None) -> dict:
    """One frame against the oracle -> {"psnr", "agree", "stray", "seconds"}:
    PSNR, the share of pixels within 2 u8 steps, and for the chaotic rows
    the share of flips (> 1 step) off the oracle's 2-px-dilated escape
    boundary (0 while 3 or fewer), as tools/psnr_gate.py:139-190 computes
    them. `strips`: oracle_strip's results for the frame's rows in order
    (default: the whole fragment, run here); the final pass runs here."""
    oracle = oracle_module()
    if strips is None:
        strips = [oracle_strip(key, uniform, textures, render_size, aspect,
                               (0, render_size[1]))]
    started = time.perf_counter()
    render = np.concatenate([rows for rows, _ in strips])
    want = oracle.render_scene(lambda *_: render, uniform, *render_size, width, height,
                               subsample, aspect)
    agree, stray = agreement(frame, want, name in CHAOTIC_CONFIGS)
    return {"psnr": oracle.psnr(frame, want), "agree": agree, "stray": stray,
            "seconds": time.perf_counter() - started + sum(seconds for _, seconds in strips)}


def agreement(frame: np.ndarray, want: np.ndarray, chaotic: bool) -> tuple[float, float]:
    """(the share of pixels within 2 u8 steps of `want`, and with `chaotic`
    the share of the flips (> 1 step) off want's escape boundary dilated
    2 px, 0 while 3 or fewer; else 0)."""
    diff = np.abs(frame.astype(np.int16) - want.astype(np.int16)).max(-1)
    stray = 0.0
    if chaotic:
        height, width = diff.shape
        disagree = diff > 1
        k_field = (want[..., 0] > 127).astype(np.int16)
        pad = np.pad(k_field, 2, mode="edge")
        stacked = np.stack([pad[dy:dy + height, dx:dx + width]
                            for dy in range(5) for dx in range(5)])
        boundary = stacked.min(0) != stacked.max(0)
        off = int((disagree & ~boundary).sum())
        if off > 3:
            stray = off / max(1, int(disagree.sum()))
    return float((diff <= 2).mean()), stray


def oracle_row(name: str, results: list) -> tuple:
    """A config's frames' results -> (kind, name, value, stray or None,
    seconds): the worst frame, as the JAX gate reports it."""
    seconds = sum(r["seconds"] for r in results)
    if name in AGREEMENT_CONFIGS:
        stray = max(r["stray"] for r in results) if name in CHAOTIC_CONFIGS else None
        return ("oracle/agree", name, min(r["agree"] for r in results), stray, seconds)
    return ("oracle/psnr", name, min(r["psnr"] for r in results), None, seconds)


def pair_row(kind: str, name: str, a: np.ndarray, b: np.ndarray) -> tuple:
    """(kind, name, PSNR of a against b, the largest u8 step, 0 seconds)."""
    step = int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
    return (kind, name, oracle_module().psnr(a, b), step, 0.0)


def passes(kind: str, name: str, value: float, extra) -> bool:
    """A row against its bar (tools/psnr_gate.py:275-294)."""
    if kind == "oracle/agree":
        if name in CHAOTIC_CONFIGS:
            stray = extra if extra is not None else 1.0
            return value >= AGREE_BAR or (value >= AGREE_BAR_CHAOTIC and stray <= STRAY_BAR)
        return value >= AGREE_BAR
    return value >= BAR_DB


def table(rows: list, device: str) -> tuple[list[str], list[str]]:
    """The gate's markdown lines and the names of the rows under their bar."""
    stamp = datetime.now(timezone.utc).strftime("%Y-%m-%d %H:%MZ")
    lines = [
        "# PSNR parity gate of the PyTorch port",
        "",
        f"Measured {stamp} on `{device}` (`python examples/torch/psnr_gate.py`).",
        f"Bars: >= {BAR_DB:.0f} dB (BASELINE.md); exact-pixel agreement >= {AGREE_BAR:.2f}; "
        f"Tetration >= {AGREE_BAR_CHAOTIC:.2f} with <= {STRAY_BAR:.0%} of flips off the "
        "escape boundary.",
        "",
        "| Check | Config | Value | Max u8 step | Oracle s | Passes |",
        "|---|---|---|---|---|---|",
    ]
    failed = []
    for kind, name, value, extra, seconds in rows:
        ok = passes(kind, name, value, extra)
        if kind == "oracle/agree":
            shown = f"{value:.2%} exact-pixel agreement"
            if name in CHAOTIC_CONFIGS:
                shown += f" ({extra if extra is not None else 1.0:.1%} of flips off-boundary)"
            step = None
        elif kind == "oracle/psnr":
            shown, step = f"{value:.1f} dB", None
        else:
            shown, step = f"{value:.1f} dB", extra
        if not ok:
            failed.append(name)
        lines.append(f"| {kind} | {name} | {shown} | {'—' if step is None else step} "
                     f"| {f'{seconds:.1f}' if kind.startswith('oracle') else '—'} "
                     f"| {'yes' if ok else '**NO**'} |")
    lines.append("")
    return lines, failed


@contextlib.contextmanager
def reference_route():
    """SHADERFLOW_NO_TAILFUSE=1 around the block: a tail on CPU tensors
    takes eval_reference and the plain final pass (switches.reference_tail)."""
    saved = os.environ.get("SHADERFLOW_NO_TAILFUSE")
    os.environ["SHADERFLOW_NO_TAILFUSE"] = "1"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("SHADERFLOW_NO_TAILFUSE")
        else:
            os.environ["SHADERFLOW_NO_TAILFUSE"] = saved


class TailCapture:
    """Keeps each tailfuse.run_tail_final call made while active (a frame's
    fused main tail), its spec's tensors copied to the CPU; reference()
    runs them through the reference route there. The two routes then read
    the same tail inputs: what differs is the tail and final pass alone,
    as in the JAX gate's rows, whose two sides share one device."""

    def __enter__(self):
        import torch
        from torch.utils._pytree import tree_map
        from shaderflow_tpu_torch.ops import tailfuse
        self.calls = []
        self._original = tailfuse.run_tail_final

        def capture(spec, *args, out=None):
            on_cpu = tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, spec)
            self.calls.append((on_cpu, args))
            return self._original(spec, *args, out=out)

        tailfuse.run_tail_final = capture
        return self

    def __exit__(self, *exc):
        from shaderflow_tpu_torch.ops import tailfuse
        tailfuse.run_tail_final = self._original

    def reference(self) -> np.ndarray:
        """The captured frames through the reference route on the CPU."""
        import torch
        with reference_route():
            frames = [self._original(spec, *args) for spec, args in self.calls]
        return torch.stack(frames).numpy()


def render_pairs(device: str) -> dict:
    """Each FUSED-vs-REF config rendered on `device` (K1-K3 on the card),
    and its frames' tails through the reference route on the CPU ->
    name -> (fused frames, reference frames); "visualizer bf16": the
    visualizer under SHADERFLOW_TAIL_BF16=1 (read where its tail is
    traced), with the float32 visualizer's reference."""
    pairs = {}
    for name, config in FUSED_CONFIGS.items():
        with TailCapture() as capture:
            frames = render_frames(*config, device=device)[0]
        if len(capture.calls) != len(frames):
            raise AssertionError(f"{name}: {len(capture.calls)} fused tails for "
                                 f"{len(frames)} frames")
        pairs[name] = (frames, capture.reference())
    saved = os.environ.get("SHADERFLOW_TAIL_BF16")
    os.environ["SHADERFLOW_TAIL_BF16"] = "1"
    try:
        bf16 = render_frames(*FUSED_CONFIGS["visualizer"], device=device)[0]
    finally:
        if saved is None:
            os.environ.pop("SHADERFLOW_TAIL_BF16")
        else:
            os.environ["SHADERFLOW_TAIL_BF16"] = saved
    pairs["visualizer bf16"] = (bf16, pairs["visualizer"][1])
    return pairs


def launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process."""
    from shaderflow_tpu_torch.ops import fractal, sampling, tailfuse
    return {"k3": fractal.escape_iterations_sep.launches,
            "k3p": fractal.escape_iterations.launches,
            "k2": sampling.expand_tables.launches,
            "k1": tailfuse.fused_tail_final.launches,
            "k1d": tailfuse.fused_tail_final.planes_launches,
            "k1h": tailfuse.fused_tail_final.bf16_launches}


def run(device: str) -> tuple[list, dict]:
    """Every row of the gate -> (rows, figures): oracle rows first, then
    FUSED-vs-REF, then bf16-tail-vs-ref. Each oracle frame goes to the
    pool as soon as it is rendered, the graded rows first, in STRIPS
    strips (the longest tasks)."""
    import torch
    from shaderflow_tpu_torch import switches
    switches.refuse("psnr_gate")
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("psnr_gate renders on a CUDA card: none is available "
                           "(pass --cpu for a smoke run on the CPU)")
    figures = {}
    started = time.perf_counter()
    order = sorted(ORACLE_CONFIGS, key=lambda name: -math.prod(ORACLE_CONFIGS[name][1:3])
                   * ORACLE_CONFIGS[name][4] ** 2)
    workers = max(1, min(8, os.cpu_count() or 1))
    with ProcessPoolExecutor(max_workers=workers, mp_context=get_context("spawn")) as pool:
        futures = []
        for name in order:
            frames, uniforms, scene = render_frames(*ORACLE_CONFIGS[name], device=device)
            strips = STRIPS if name in GRADED_CONFIGS else 1
            for task in oracle_tasks(name, frames, uniforms, scene):
                key, _, uniform, textures, render_size = task[1:6]
                futures.append((name, task, [
                    pool.submit(oracle_strip, key, uniform, textures, render_size, task[9], rows)
                    for rows in strip_rows(render_size[1], strips)]))
            scene.destroy()
        pairs = render_pairs(device)
        figures["render_s"] = time.perf_counter() - started
        figures["launches"] = launch_counts()
        results = [(name, oracle_frame(*task, strips=[future.result() for future in strips]))
                   for name, task, strips in futures]
    figures["wall_s"] = time.perf_counter() - started
    rows = [oracle_row(name, [result for row, result in results if row == name])
            for name in ORACLE_CONFIGS]
    rows += [pair_row("fused-vs-ref", name, *pairs[name]) for name in FUSED_CONFIGS]
    rows.append(pair_row("bf16-tail-vs-ref", "visualizer", *pairs["visualizer bf16"]))
    return rows, figures


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    parser.add_argument("--cpu", action="store_true", help="a smoke run on the CPU")
    parser.add_argument("--out", type=Path, default=REPO / "build" / "psnr_gate.md")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    rows, figures = run(device)
    return report(rows, "CPU (smoke)" if args.cpu else card_line(), args.out, figures)


def report(rows: list, device: str, out: Path, figures: dict = None) -> int:
    """Print the table (and write it to `out`) and a JSON line -> the exit
    code: 1 when any row is under its bar."""
    lines, failed = table(rows, device)
    text = "\n".join(lines)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    print(text)
    print(json.dumps({"psnr_gate": [{"check": kind, "config": name, "value": value,
                                     "extra": extra, "oracle_s": seconds}
                                    for kind, name, value, extra, seconds in rows],
                      "failed": failed, **(figures or {})}))
    if failed:
        print(f"GATE FAILED: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
