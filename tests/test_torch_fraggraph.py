"""The fragment's CUDA graph (shaderflow_tpu_torch/fraggraph.py) on the
CPU: which engines record their fragment; exports whose graph is a
stand-in that replays by running the captured fragment again and writing
its outputs into the recorded ones, byte for byte the eager export, with
every Indexed input on the current flush's stack at the frame's step;
what the capture refuses; and the visualizer's fragment copying nothing
from the host once warm. The card's own graphs: tests/test_torch_cuda.py.

    python -m pytest tests/test_torch_fraggraph.py -q
"""

import itertools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_scene import _import_example  # noqa: E402

from shaderflow_tpu_torch import fraggraph  # noqa: E402
from shaderflow_tpu_torch.fraggraph import FragmentGraph  # noqa: E402
from shaderflow_tpu_torch.ops import tailfuse  # noqa: E402

# 11 frames in batches of 4: three flushes, the last one shorter
OPTIONS = dict(fps=10, time=1.1, batch=4)
SIZES = {"Visualizer": dict(width=128, height=72, ssaa=2),
         "Mandelbrot": dict(width=96, height=54, ssaa=2)}
MODULES = {"Visualizer": "torch_demo", "Mandelbrot": "torch_fractals",
           "Multipass": "torch_demo", "MotionBlur": "torch_demo"}


class ReplayedGraph:
    """A CUDA graph's stand-in on the CPU: a replay runs the captured
    fragment again, over fresh Frags of the recording's slots, and writes
    its outputs into the recorded result's tensors, as a replay does."""

    def __init__(self, draw, result):
        self.draw, self.result = draw, result

    def replay(self):
        for old, new in zip(fraggraph.result_tensors(self.result),
                            fraggraph.result_tensors(self.draw())):
            old.copy_(new)


def _capture(draw, device):
    result = draw()
    return ReplayedGraph(draw, result), result


@pytest.fixture
def recorded(monkeypatch):
    """Record on the CPU too, through ReplayedGraph; counters from 0."""
    monkeypatch.setattr(fraggraph, "RECORD_ON", ("cuda", "cpu"))
    monkeypatch.setattr(fraggraph, "capture", _capture)
    for name in ("calls", "replays", "captures", "refusals"):
        monkeypatch.setattr(FragmentGraph, name, 0)


def _counters() -> tuple:
    return (FragmentGraph.calls, FragmentGraph.replays, FragmentGraph.captures,
            FragmentGraph.refusals)


def _export(scene, path: Path, size: dict) -> np.ndarray:
    scene.main(output=str(path), device="cpu", **OPTIONS, **size)
    return np.fromfile(path, np.uint8).reshape(-1, size["height"], size["width"], 3)


def _engine(scene):
    """The scene's engine, built for a 64x36 ssaa 2 run on the CPU."""
    from shaderflow_tpu_torch.scene import WindowBackend
    scene.backend = WindowBackend.Headless
    scene._setup_run(width=64, height=36, fps=10, ssaa=2, device="cpu")
    scene.engine.begin_batch()
    return scene.engine


@pytest.mark.parametrize("name,expected", [("Visualizer", True), ("Mandelbrot", True),
                                           ("Multipass", False), ("MotionBlur", False),
                                           ("instanced", False), ("mesh", False)])
def test_recordable_by_structure(monkeypatch, name, expected):
    """Recorded: the visualizer's and Mandelbrot's engines. Not: Multipass
    (two layers), MotionBlur (a temporal ring), an instanced program, an
    engine on a mesh; nor any engine off the card."""
    monkeypatch.setattr(fraggraph, "RECORD_ON", ("cuda", "cpu"))
    cls = {"instanced": "Mandelbrot", "mesh": "Visualizer"}.get(name, name)
    engine = _engine(getattr(_import_example("torch", MODULES[cls]), cls)())
    if name == "instanced":
        engine.scene.shader.instances = 2
        engine.build()
    if name == "mesh":
        engine.mesh = [torch.device("cpu")] * 2
    assert fraggraph.recordable(engine) is expected
    # A mesh comes after the build: render_frame asks for it every frame
    assert (engine._recorder is not None) is (expected or name == "mesh")
    monkeypatch.setattr(fraggraph, "RECORD_ON", ("cuda",))
    assert not fraggraph.recordable(engine)


def _flat_frag(sf):
    return sf.tail(lambda tp: (tp.plane("a"),) * 3, a=sf.astuv[..., 0])


def _structure_scene(programs: int, layers: int, temporal: int, instances: int):
    """A scene of `programs` programs whose main one has `layers` layers,
    `temporal` slots and `instances` instances."""
    from shaderflow_tpu_torch.scene import ShaderScene
    from shaderflow_tpu_torch.shader import ShaderProgram

    class Structure(ShaderScene):
        def build(self):
            if programs == 2:
                ShaderProgram(scene=self, name="extra").fragment = _flat_frag
            self.shader.texture.layers = layers
            self.shader.texture.temporal = temporal
            self.shader.instances = instances
            self.shader.fragment = _flat_frag

    return Structure()


@pytest.mark.parametrize("programs,layers,temporal,instances",
                         list(itertools.product((1, 2), repeat=4)))
def test_recordable_by_structure_is_the_fuse_rule(monkeypatch, programs, layers, temporal,
                                                  instances):
    """Structural cases: the main program's tail fuses (engine.fuses)
    with one layer and temporal 1, and an engine records its fragment
    when it has one program, with one instance, whose tail fuses."""
    monkeypatch.setattr(fraggraph, "RECORD_ON", ("cuda", "cpu"))
    engine = _engine(_structure_scene(programs, layers, temporal, instances))
    fuses = engine.fuses(engine.scene.shader)
    assert fuses is (layers == 1 and temporal == 1)
    assert fraggraph.recordable(engine) is (programs == 1 and instances == 1 and fuses)
    assert (engine._recorder is not None) is fraggraph.recordable(engine)


def _own_texture_frag(sf):
    own = sf.texture("iScreen", sf.astuv)
    return sf.tail(lambda tp: (tp.plane("a"),) * 3, a=own[..., 0] + own[..., 3] + 0.25)


@pytest.mark.parametrize("mode", ["eager", "recorded"])
def test_fused_main_program_reads_its_own_zeros(request, monkeypatch, tmp_path, mode):
    """A main program whose tail fuses and which samples its own texture
    reads zeros every frame (the per-frame zero matrix, or the
    recording's): 0 + 0 + 0.25 is u8 64 everywhere, eagerly and through
    the recorded fragment."""
    if mode == "recorded":
        request.getfixturevalue("recorded")
    calls = []
    run_tail_final = tailfuse.run_tail_final

    def counted(*args, **kwargs):
        calls.append(1)
        return run_tail_final(*args, **kwargs)

    monkeypatch.setattr(tailfuse, "run_tail_final", counted)
    from shaderflow_tpu_torch.scene import ShaderScene

    class OwnTexture(ShaderScene):
        def build(self):
            self.shader.fragment = _own_texture_frag

    scene = OwnTexture()
    frames = _export(scene, tmp_path / "own.rgb", SIZES["Mandelbrot"])
    assert scene.engine.fuses(scene.shader) and len(calls) == len(frames) == 11
    assert (frames == 64).all()
    if mode == "recorded":
        assert _counters() == (11, 9, 1, 0)


@pytest.mark.parametrize("name", ["Visualizer", "Mandelbrot"])
def test_recorded_export_equals_eager(recorded, monkeypatch, tmp_path, name):
    """Three flushes: the first frame eager, the second captured, nine
    replays; the frames byte for byte the eager export's (where frames
    change, they change alike). Each replay's tail holds the recorded
    tensors, and each Indexed input the current flush's stack at the
    frame's step. The export's end drops the recording."""
    from shaderflow_tpu_torch import engine as engine_module
    module = _import_example("torch", MODULES[name])
    specs, stacks = [], []
    run_tail_final, run_preludes = tailfuse.run_tail_final, engine_module.RenderEngine._run_preludes

    def keep_spec(spec, *args, **kwargs):
        specs.append(spec)
        return run_tail_final(spec, *args, **kwargs)

    def keep_stacks(self, *args, **kwargs):
        per_batch, invariant = run_preludes(self, *args, **kwargs)
        stacks.append({**per_batch, **invariant})
        return per_batch, invariant

    monkeypatch.setattr(tailfuse, "run_tail_final", keep_spec)
    monkeypatch.setattr(engine_module.RenderEngine, "_run_preludes", keep_stacks)
    scene = getattr(module, name)()
    got = _export(scene, tmp_path / "graph.rgb", SIZES[name])
    assert _counters() == (11, 9, 1, 0)
    assert scene.engine._recorder.graph is scene.engine._recorder.ctx is None
    monkeypatch.setattr(fraggraph, "RECORD_ON", ("cuda",))
    want = _export(getattr(module, name)(), tmp_path / "eager.rgb", SIZES[name])
    assert _counters() == (22, 9, 1, 0)
    assert got.shape == (11, SIZES[name]["height"], SIZES[name]["width"], 3)
    assert np.array_equal(got, want)
    if name == "Visualizer":
        assert all((got[i] != got[i + 1]).any() for i in range(1, 10))

    replayed = specs[1:11]
    for frame, spec in enumerate(replayed, start=1):
        assert [id(t) for t in fraggraph.result_tensors(spec)] == \
            [id(t) for t in fraggraph.result_tensors(replayed[0])]
        flush, step = divmod(frame, 4)
        for key, indexed in spec.indexed.items():
            prelude = {"bar": "iBarField", "fscale": "iVizFscale", "rad0": "iVizRad",
                       "blinkp": "iVizBlink", "lvig": "iVizLvig"}[key]
            assert indexed.stack is stacks[flush][prelude] and indexed.index == step
    assert len(replayed[0].indexed) == (5 if name == "Visualizer" else 0)


_FOREIGN: dict = {}


def _prelude_frag(kind: str):
    """A fragment over a per-batch prelude "iRamp" (frame index times a
    ramp, (B, H, W)): "value" reads this frame's plane (a slot of the
    recording); "stack" indexes the stack itself inside the recording;
    "foreign" adds a column line cached outside the recording."""
    def frag(sf):
        if kind == "stack":
            stack, step = sf.prelude_indexed("iRamp")
            plane = stack[step] * 1.0
        else:
            plane = sf.prelude("iRamp") * 1.0
        inputs = dict(plane=plane, t=sf.iTime)
        if kind == "foreign":
            width = plane.shape[1]
            if width not in _FOREIGN:
                _FOREIGN[width] = torch.linspace(0.0, 1.0, width)
            inputs["line"] = tailfuse.Col(_FOREIGN[width])
            return sf.tail(lambda tp: (tp.plane("plane") * tp.col("line"),) * 3, **inputs)
        return sf.tail(lambda tp: (tp.plane("plane"), tp.scalar("t") * 0.1, 0.5), **inputs)
    return frag


def _ramp(ctx):
    height, width = ctx.render_size
    ramp = torch.arange(height * width, dtype=torch.float32).reshape(height, width)
    return (ctx.frames.to(torch.float32)[:, None, None] + 1.0) * ramp / (height * width * 12)


@pytest.mark.parametrize("kind,counters", [("value", (11, 9, 1, 0)),
                                           ("stack", (11, 0, 0, 1)),
                                           ("foreign", (11, 0, 0, 1))])
def test_capture_keeps_or_refuses(recorded, monkeypatch, tmp_path, kind, counters):
    """A per-batch prelude value read as a tensor is recorded through its
    slot; a read of the prelude stack inside the recording, or a tail
    holding a tensor made outside it, is refused: the program renders
    eagerly for the rest of the build. Either way the frames are the
    eager export's."""
    from shaderflow_tpu_torch.scene import ShaderScene

    class Ramp(ShaderScene):
        def build(self):
            self.shader.fragment = _prelude_frag(kind)
            self.batch_preludes["iRamp"] = _ramp

    size = dict(width=32, height=18, ssaa=2)
    got = _export(Ramp(), tmp_path / "graph.rgb", size)
    assert _counters() == counters
    monkeypatch.setattr(fraggraph, "RECORD_ON", ("cuda",))
    want = _export(Ramp(), tmp_path / "eager.rgb", size)
    assert np.array_equal(got, want) and len({frame.tobytes() for frame in got}) == 11


def _content(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random((6, 8, 3)).astype(np.float32)


@pytest.mark.parametrize("change", ["upload", "stream"])
def test_engine_records_anew_where_it_invalidates(recorded, monkeypatch, tmp_path, change):
    """A static texture read in place by the graph changes at frame 6, in
    the second flush: uploaded again (a new version, not written during
    the loop), or written every frame from then on (streamed). The engine
    drops the recording: the second flush's first frame runs eagerly, its
    second is captured, and every frame equals the eager export's (a graph
    still reading the first upload would not)."""
    from shaderflow_tpu_torch.ops import stdlib as sl
    from shaderflow_tpu_torch.scene import ShaderScene
    from shaderflow_tpu_torch.texture import ShaderTexture

    def frag(sf):
        color = sf.texture("pic", sf.astuv)
        return sl.vec4(color[..., 0] + sf.iTime * 0.05, color[..., 1], color[..., 2], 1.0)

    class Changing(ShaderScene):
        def build(self):
            self.pic = ShaderTexture(scene=self, name="pic", width=8, height=6, components=3,
                                     dtype=np.float32)
            self.pic.write(_content(0))
            self.shader.fragment = frag

        def update(self):
            frame = self._frame_counter
            if change == "upload" and frame == 6:
                self.pic.matrix = _content(1)[None, None]
                self.pic.make()   # a new version (same shape: the array kept)
            elif change == "stream" and frame >= 6:
                self.pic.write(_content(frame))

    size = dict(width=32, height=18, ssaa=2)
    got = _export(Changing(), tmp_path / "graph.rgb", size)
    assert _counters() == (11, 7, 2, 0)
    monkeypatch.setattr(fraggraph, "RECORD_ON", ("cuda",))
    want = _export(Changing(), tmp_path / "eager.rgb", size)
    assert np.array_equal(got, want) and len({frame.tobytes() for frame in got}) == 11


def test_walked_frames_render_eagerly(recorded):
    """Under the cost walker (tools/flopcount.py, which counts what runs)
    no frame is recorded or replayed: every frame's K3 is walked. After
    the walk the build records as usual."""
    from shaderflow_tpu_torch.tools import flopcount
    scene = getattr(_import_example("torch", "torch_fractals"), "Mandelbrot")()
    engine = _engine(scene)
    for _ in range(4):
        scene.next(dt=scene.frametime)
    with flopcount.Walker() as walker:
        engine.flush(4)
    assert _counters() == (4, 0, 0, 0) and walker.kernels["K3 lines"] == 4
    engine.flush(4)
    assert _counters() == (8, 2, 1, 0)


def test_rebuild_releases_the_recording(recorded):
    """A rebuild drops the last build's recording at once: its graph (and
    so its memory pool on the card) and the recorder are freed without a
    garbage collection."""
    import gc
    import weakref
    scene = getattr(_import_example("torch", "torch_fractals"), "Mandelbrot")()
    engine = _engine(scene)
    for _ in range(3):
        scene.next(dt=scene.frametime)
    engine.flush(3)
    assert _counters() == (3, 1, 1, 0)
    graph, recorder = weakref.ref(engine._recorder.graph), weakref.ref(engine._recorder)
    gc.disable()
    try:
        engine.build()
        assert graph() is None and recorder() is None and engine._recorder is not None
    finally:
        gc.enable()


class _Lifts(TorchDispatchMode):
    """Counts tensors made from host data (aten.lift_fresh)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is torch.ops.aten.lift_fresh:
            self.count += 1
        return func(*args, **(kwargs or {}))


def test_visualizer_frag_copies_nothing_from_host(monkeypatch, tmp_path):
    """After its first frame, two frames of the visualizer's fragment make
    no tensor from host data: no aten.lift_fresh, no torch.tensor call.
    (On the card such a copy synchronises the stream and cannot be
    captured.)"""
    torch_demo = _import_example("torch", "torch_demo")
    counts = []

    def frag(sf):
        if not counts:
            counts.append(None)
            return torch_demo.visualizer_frag(sf)
        lifts, calls = _Lifts(), []
        tensor = torch.tensor
        monkeypatch.setattr(torch, "tensor", lambda *a, **k: calls.append(a) or tensor(*a, **k))
        try:
            with lifts:
                out = torch_demo.visualizer_frag(sf)
        finally:
            monkeypatch.setattr(torch, "tensor", tensor)
        counts.append((lifts.count, len(calls)))
        return out

    class Counted(torch_demo.Visualizer):
        def build(self):
            super().build()
            self.shader.fragment = frag

    Counted().main(output="null", device="cpu", fps=10, time=0.3, batch=4,
                   **SIZES["Visualizer"])
    assert counts[1:] == [(0, 0), (0, 0)]
