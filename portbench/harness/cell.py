"""
One run of one cell: set-up, the measured window, the readings and the
comparison with the plain reference.

Set-up, in order: the port and its scene imported (CUDA's context made
by the caller), the inputs made from the seed, the kernels built or
loaded from the checkout's caches and every shape warmed up by one short
export of the cell's own sizes (three full batches and the clip's last,
shorter one). The window then runs back-to-back exports of one clip each through
ShaderScene.main into the benchmark's sink (harness/window.py) until
`seconds` have passed; each export pays its own module set-up and audio
precompute, as a user's export does.
"""

from __future__ import annotations

import gc
import importlib.util
import os
import shutil
import sys
import tempfile
import time
import types
from pathlib import Path


from portbench.harness import compare, counting, registry, trace as tracing
from portbench.harness.inputs import make_inputs, rng_for
from portbench.harness.window import BenchSink, Window, bench_sink, export_fps

# Frames of a traced stretch: at least this many, over at least two flushes
STRETCH_FRAMES = 240


def import_scene_module(path: Path) -> types.ModuleType:
    """The scene's example module, imported from its file once a process."""
    name = path.stem
    if name in sys.modules:
        return sys.modules[name]
    sys.path.insert(0, str(path.parent))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def default_batch(width: int, height: int) -> int:
    """The batch an export of this output size flushes (the port's own
    ShaderScene.default_batch_size, asked without a scene)."""
    from shaderflow_tpu_torch.scene import ShaderScene
    return int(ShaderScene.default_batch_size(types.SimpleNamespace(_width=width,
                                                                    _height=height)))


class Cell:
    """A cell's configuration, traffic and inputs, and the scenes it makes."""

    def __init__(self, name: str, seed: int, root: Path, scratch: Path):
        self.benchmark = registry.load_benchmark(root)
        self.workload = registry.workload(name, self.benchmark)
        self.name = name
        self.seed = int(seed)
        self.root = root
        self.config = registry.config(self.workload["config"], root / "portbench")
        self.traffic = registry.traffic(self.workload["traffic"], root / "portbench")
        self.fps = float(self.config["fps"])
        self.clip_frames = int(round(self.traffic["clip_seconds"] * self.fps))
        self.inputs = make_inputs(self.config["inputs"], self.seed, scratch,
                                  float(self.traffic["clip_seconds"]), root / "portbench")
        self.module = import_scene_module(root / self.config["scene"]["file"])
        for name, item in self.config["inputs"].items():
            if "global" in item:
                setattr(self.module, item["global"], self.inputs[name][0])
        self.batch = int(self.traffic.get("batch") or default_batch(
            self.traffic["width"], self.traffic["height"]))

    def clip_of(self, job: int) -> int:
        clips = [len(self.inputs[name]) for name, item in self.config["inputs"].items()
                 if "attr" in item]
        return job % max(clips) if clips else 0

    def scene(self, job: int):
        attrs = {item["attr"]: self.inputs[name][self.clip_of(job) % len(self.inputs[name])]
                 for name, item in self.config["inputs"].items() if "attr" in item}
        return getattr(self.module, self.config["scene"]["class"])(**attrs)

    def main_options(self, device: str, frames: int) -> dict:
        return dict(width=int(self.traffic["width"]), height=int(self.traffic["height"]),
                    fps=self.fps, ssaa=float(self.traffic["ssaa"]),
                    quality=float(self.config["quality"]),
                    subsample=int(self.config["subsample"]),
                    time=frames / self.fps, output="null", batch=self.batch,
                    device=device)

    def keep(self, job: int) -> set:
        """The frames of job `job` the seed picks for the comparison: one of
        its first batch, so that every job that delivers is compared, and
        `compare_frames` more of the whole clip."""
        rng = rng_for(self.seed, 3, job)
        count = min(int(self.traffic["compare_frames"]), self.clip_frames)
        first = int(rng.integers(0, min(self.batch, self.clip_frames)))
        return {first, *(int(i) for i in rng.choice(self.clip_frames, count, replace=False))}


def run(name: str, seed: int, seconds: float, traced: bool, *, process_start: float,
        device: str = "cuda", root: Path = registry.ROOT, env: dict = None) -> dict:
    """One run -> {"result": the result line's object, "lines": the
    compared numbers beside their limits}."""
    import torch

    scratch = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        return _run(torch, name, seed, seconds, traced, process_start, device, root,
                    env or {}, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def _run(torch, name, seed, seconds, traced, process_start, device, root, env, scratch):
    from shaderflow_tpu_torch import exporting, logger

    cell = Cell(name, seed, root, scratch)
    os.environ.update(cell.config.get("env", {}))
    os.environ.update(env)
    logger.setLevel("WARNING")
    on_card = device != "cpu"

    # Warm-up: as many full batches as an export keeps in flight and the
    # clip's last, shorter one (its pinned host batches are made here)
    tail = cell.clip_frames % cell.batch
    warm = min(cell.clip_frames, 3 * cell.batch + tail)
    warm_window = Window(start=0.0, end=float("inf"))
    scene = cell.scene(0)
    with bench_sink(exporting, lambda helper: BenchSink(warm_window, -1, set(), scene)):
        scene.main(**cell.main_options(device, warm))
    del scene

    trace = tracing.Trace(frame_bytes=int(cell.traffic["width"]) * int(cell.traffic["height"]) * 3)
    spans = stretch = None
    if traced:
        import warnings
        from torch.profiler import ProfilerActivity, profile, record_function
        warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
        if on_card:   # the profiler's first start pays its own set-up here
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                torch.zeros(1, device=device).add_(1)
                torch.cuda.synchronize()
        spans = tracing.Spans(trace, record_function)
        per_layer = [m["name"] for m in registry.cell_metrics(name, cell.benchmark, "per_layer")]
        for label, (module_name, owner, attribute) in registry.spans(
                per_layer, root / "portbench").items():
            module = __import__(module_name, fromlist=["_"])
            spans.wrap(getattr(module, owner) if owner else module, attribute, label)
        if on_card:
            flushes = max(2, -(-STRETCH_FRAMES // cell.batch))
            stretch = tracing.DeviceStretch(torch, trace, 2, flushes, scratch)
            _hook_flush(spans, stretch)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # What set-up left is kept out of the window's collections: each one
    # then looks at the last export's objects alone
    gc.collect()
    gc.freeze()

    started = time.perf_counter()
    window = Window(start=started, end=started + seconds)
    setup_s = started - process_start
    job, errors = 0, []
    while time.perf_counter() < window.end:
        scene = cell.scene(job)
        begun = time.perf_counter()
        keep = cell.keep(job)
        with bench_sink(exporting, lambda helper: BenchSink(window, job, keep, scene)):
            try:
                scene.main(**cell.main_options(device, cell.clip_frames))
            except Exception as error:   # recorded; the run is then not correct
                errors.append(f"job {job}: {type(error).__name__}: {error}")
        window.jobs.append((job, cell.clip_of(job), begun, time.perf_counter()))
        # The scene's modules and engine hold each other: without a
        # collection the device batches of finished exports stay alive
        # and a run of several exports fills the card
        del scene
        gc.collect()
        job += 1
    if on_card:
        torch.cuda.synchronize()
    if stretch is not None:
        stretch.stop()
    if spans is not None:
        spans.restore()
    if stretch is not None:
        stretch.collect()
    fps = export_fps(window.deliveries, window.start, window.end)
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    reference = registry.reference(cell.workload["config"], root / "portbench")
    metrics = {}
    if traced:
        if hasattr(reference, "work"):
            trace.work = reference.work(cell.config, cell.traffic, cell.inputs, device)
        for metric in registry.cell_metrics(name, cell.benchmark, "per_layer"):
            value = registry.metric_reader(metric["name"], root / "portbench")(trace)
            if value is not None:
                metrics[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    else:
        measured = {"export_fps": fps, "setup_s": setup_s}
        for metric in registry.cell_metrics(name, cell.benchmark, "end_to_end"):
            if measured.get(metric["name"]) is not None:
                metrics[metric["name"]] = {"value": float(measured[metric["name"]]),
                                           "unit": metric["unit"]}

    # The comparison: every kept frame that was delivered, against the plain reference
    requests = sorted({(job, cell.clip_of(job), frame) for job, frame in window.kept})
    due = sorted((job, frame) for job, *_ in window.jobs for frame in cell.keep(job)
                 if any(d.job == job and d.first <= frame < d.first + d.count
                        for d in window.deliveries))
    expected = reference.render(cell.config, cell.traffic, cell.inputs, requests, device)
    pairs = [(window.kept[key], expected[key]) for key in due
             if key in window.kept and key in expected]
    values = compare.numbers(pairs)
    correct, lines = compare.judge(values, cell.config["compare"], len(due) - len(pairs))
    correct = correct and not errors and fps is not None and bool(pairs)
    lines = [f"compared_frames {len(pairs)}", *errors, *lines]

    result = {
        "correct": bool(correct),
        "attempted": len(window.jobs),
        "failed": len(errors),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name() if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": peak},
    }
    if traced and on_card:
        result["device"]["busy_s"] = trace.busy_seconds()
        result["device"]["window_s"] = trace.window_seconds()
        result["breakdown"] = tracing.breakdown(trace)
    result["compared"] = {"missing_frames": {"value": len(due) - len(pairs), "limit": 0},
                          **{name: {"value": values[name], "limit": limit}
                             for name, limit in cell.config["compare"].items()}}
    card = counting.card() if on_card else {}
    jobs = " ".join(f"{sum(d.count for d in window.deliveries if d.job == job)}/"
                    f"{finished - begun:.3f}" for job, _, begun, finished in window.jobs)
    return {"result": result, "lines": lines, "values": values, "trace": trace,
            "window": window,
            "notes": [f"card: {card.get('name')}, power limit {card.get('power_limit')}",
                      f"jobs frames/seconds: {jobs}"]}


def _hook_flush(spans: tracing.Spans, stretch: tracing.DeviceStretch) -> None:
    """Start and stop the device stretch around the window's flushes."""
    from shaderflow_tpu_torch import engine

    wrapped = engine.RenderEngine.flush

    def flush(self, count=None):
        stretch.before_flush()
        frames = wrapped(self, count)
        stretch.after_flush(0 if frames is None else int(frames.shape[0]))
        return frames

    engine.RenderEngine.flush = flush
    spans._restore.append((engine.RenderEngine, "flush", wrapped))
