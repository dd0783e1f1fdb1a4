"""Multi-device exports of the PyTorch port (shaderflow_tpu_torch/parallel/
mesh.py) on the CPU. A mesh of N times the CPU device (frame_mesh(devices=),
Scene.mesh_devices) stands in for the JAX package's 8 virtual XLA:CPU
devices. Mirrors tests/test_parallel.py and tests/test_parallel_scenes.py:
every sharded flush and export is bit-identical to the port's own
single-device one, on the frame path (scenes without temporal feedback)
and the row path (MotionBlur, Life, whose 192x108 simulation divides 4
shards and is rendered whole at 8); both are shown to shard. Also: resume
under the row path, `--devices` through the command line, the export
loop's messages word for word against the JAX package's, the ops that make
a program render whole rows, and each scene's sharded frames against the
JAX package's own devices=8 export.

The port's scene exports run in a child interpreter with jax and the JAX
package blocked; the in-process cases render with both blocked too
(`blocked`). The JAX package exports in a child on XLA:CPU capped at the
AVX ISA with 8 virtual devices and its fused tail in interpret mode (the
form the port's K1 follows at ssaa 1: tests/test_torch_piano.py)."""

import contextlib
import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_scene import _fix_reference_texture, _import_example

from shaderflow_tpu_torch.ops import stdlib as sl
from shaderflow_tpu_torch.parallel import frame_mesh, mesh, supports_frame_sharding
from shaderflow_tpu_torch.parallel.mesh import available_devices
from shaderflow_tpu_torch.scene import ShaderScene
from shaderflow_tpu_torch.shader import ShaderProgram
from shaderflow_tpu_torch.texture import ShaderTexture

REPO = Path(__file__).resolve().parent.parent
WIDTH, FPS, FRAMES = 96, 10, 11
# name -> (example module, height): the graded configurations of
# tests/test_parallel_scenes.py; 11 frames do not divide 4 or 8 shards;
# 56 rows divide both (Life's 108-row simulation divides 4, not 8)
SCENES = {"MusicBars": ("torch_demo", 54), "Visualizer": ("torch_demo", 54),
          "Mandelbrot": ("torch_fractals", 54), "RayMarch": ("torch_demo", 54),
          "MotionBlur": ("torch_demo", 56), "Life": ("torch_demo", 56)}
FRAME_SCENES = ["MusicBars", "Visualizer", "Mandelbrot", "RayMarch"]
ROW_SCENES = ["MotionBlur", "Life"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread beside the other test workers
    (tests/test_torch_scenes.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def blocked():
    """jax and the JAX package unimportable while the port renders."""
    saved = {name: sys.modules.get(name) for name in ("jax", "shaderflow_tpu")}
    sys.modules.update(dict.fromkeys(saved))
    try:
        yield
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module


PORT_SCRIPT = """
import json, sys
sys.modules["jax"] = None
sys.modules["shaderflow_tpu"] = None
sys.path.insert(0, REPO)
sys.path.insert(0, REPO + "/examples/torch")
import torch
torch.set_num_threads(1)
import torch_demo, torch_fractals
modules = {"torch_demo": torch_demo, "torch_fractals": torch_fractals}
shards = {}
for name, (module, height) in SCENES.items():
    for devices in (None, 4, 8):
        scene = getattr(modules[module], name)()
        scene.mesh_devices = ["cpu"] * 8
        scene.main(width=WIDTH, height=height, fps=FPS, time=FRAMES / FPS, device="cpu",
                   output=f"{TMP}/port_{name}_{devices}.rgb", devices=devices)
        if devices:
            shards[f"{name}/{devices}"] = [
                dict(frames=shard.frames, windows=shard.windows,
                     rows_rendered=shard.rows_rendered)
                for shard in scene.engine._shards]
loaded = [name for name, module in sys.modules.items() if module is not None
          and (name in ("jax", "shaderflow_tpu") or name.startswith(("jax.", "shaderflow_tpu.")))]
assert not loaded, loaded
json.dump(shards, open(f"{TMP}/shards.json", "w"))
"""

JAX_SCRIPT = """
import sys
import pytest
sys.path.insert(0, REPO)
sys.path.insert(0, REPO + "/tests")
from test_torch_scene import _fix_reference_texture, _import_example
_fix_reference_texture(pytest.MonkeyPatch())
modules = {"torch_demo": _import_example("basic", "demo"),
           "torch_fractals": _import_example("fractals", "fractals")}
import jax
assert len(jax.devices()) == 8
for name, (module, height) in SCENES.items():
    getattr(modules[module], name)().main(width=WIDTH, height=height, fps=FPS,
                                          time=FRAMES / FPS, devices=8,
                                          output=f"{TMP}/jax_{name}.rgb")
"""


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """Every scene exported by the port (single, devices 4 and 8) and by
    the JAX package (devices 8), the two children side by side."""
    tmp = tmp_path_factory.mktemp("mesh")
    header = (f"REPO, TMP = {str(REPO)!r}, {str(tmp)!r}\n"
              f"WIDTH, FPS, FRAMES, SCENES = {WIDTH}, {FPS}, {FRAMES}, {SCENES!r}\n")
    base = dict(os.environ, HOME=str(tmp), SHADERFLOW_LOGLEVEL="WARNING", OMP_NUM_THREADS="1")
    jax_env = dict(base, JAX_PLATFORMS="cpu", SHADERFLOW_NO_COMPILE_CACHE="1",
                   SHADERFLOW_TAILFUSE_INTERPRET="1",
                   XLA_FLAGS="--xla_cpu_max_isa=AVX --xla_force_host_platform_device_count=8")
    children = [subprocess.Popen([sys.executable, "-c", header + script], cwd=REPO, env=env,
                                 stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
                for script, env in ((PORT_SCRIPT, base), (JAX_SCRIPT, jax_env))]
    try:
        for child in children:
            _, err = child.communicate(timeout=600)
            assert child.returncode == 0, err[-4000:]
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()

    def read(stem: str, name: str) -> np.ndarray:
        return np.fromfile(tmp / f"{stem}.rgb", np.uint8).reshape(-1, SCENES[name][1], WIDTH, 3)
    port = {(name, devices): read(f"port_{name}_{devices}", name)
            for name in SCENES for devices in (None, 4, 8)}
    jax = {name: read(f"jax_{name}", name) for name in SCENES}
    return port, jax, json.loads((tmp / "shards.json").read_text())


# -- the engine's sharded flush ---------------------------------------------------

class Ramp(ShaderScene):
    def build(self):
        self.shader.fragment = lambda sf: sl.vec4(
            torch.broadcast_to(sf.iTime, sf.astuv.shape[:-1]),
            sf.astuv[..., 0], sf.astuv[..., 1], 1.0)


class Feedback(ShaderScene):
    def build(self):
        self.shader.texture.temporal = 2
        self.shader.fragment = lambda sf: sl.vec4(
            sf.texture(sf.tex("iScreen", 1, 0), sf.astuv)[..., 0] + 0.1, 0.0, 0.0, 1.0)


class FeedbackStream(ShaderScene):
    """A ring and a texture written by the host every frame (streamed)."""

    def build(self):
        self.noise = ShaderTexture(scene=self, name="noise", components=1, track=False)
        self.noise.size = (8, 8)
        self.shader.texture.temporal = 3

        def frag(sf):
            prev = sf.texture(sf.tex("iScreen", 1, 0), sf.astuv)
            noise = sf.texture("noise", sf.astuv)
            red = 0.5 * prev[..., 0] + 0.5 * noise[..., 0]
            return sl.vec4(red, noise[..., 0], prev[..., 0], 1.0)
        self.shader.fragment = frag

    def update(self):
        rng = np.random.default_rng(100 + self.frame)
        self.noise.write(rng.random((8, 8, 1)).astype(np.float32))


def cpu_mesh(shards: int):
    return frame_mesh(devices=["cpu"] * shards)


def flushed(frames) -> np.ndarray:
    return (frames if isinstance(frames, torch.Tensor) else frames.cpu()).numpy()


def capture(cls, frames: int, shards=None, width=64, height=32, time=1.0, batches=1):
    """`batches` flushes of `frames` frames each, on one device or a CPU
    mesh of `shards` -> (scene, each flush's result)."""
    scene = cls()
    scene._setup_run(width=width, height=height, fps=10, time=time, freewheel=True,
                     device="cpu")
    if shards:
        scene.engine.mesh = cpu_mesh(shards)
    results = []
    for _ in range(batches):
        scene.engine.begin_batch()
        for _ in range(frames):
            scene.next(dt=scene.frametime)
        results.append(scene.engine.flush(frames))
    return scene, results


def test_cpu_meshes():
    """The CPU stands in for N devices only when named N times; a mesh
    larger than its pool, or on a card that is not there, raises."""
    assert frame_mesh(devices=["cpu"] * 8).size == 8
    assert available_devices("cpu") == [torch.device("cpu")]
    assert frame_mesh(device="cpu") == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        frame_mesh(8, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            frame_mesh(devices=["cuda"] * 2)


def test_frame_sharded_flush_matches_single_device():
    with blocked():
        _, (single,) = capture(Ramp, 16)
        scene, (sharded,) = capture(Ramp, 16, shards=8)
    assert sharded.shape == (16, 32, 64, 3)
    np.testing.assert_array_equal(flushed(sharded), flushed(single))
    assert [shard.frames for shard in scene.engine._shards] == [[2 * k, 2 * k + 1]
                                                                for k in range(8)]


def test_supports_frame_sharding_detects_feedback():
    scene = Ramp()
    scene.initialize()
    assert supports_frame_sharding(scene)
    scene.shader.texture.temporal = 4
    assert not supports_frame_sharding(scene)


def test_output_is_frame_sharded():
    """Eight frames over eight shards: eight parts, one frame each, each
    left on its own shard."""
    with blocked():
        scene, (frames,) = capture(Ramp, 8, shards=8)
    shards = [part[0] for part in frames.parts]
    assert shards == scene.engine._shards and len(set(map(id, shards))) == 8
    assert [(part[1], part[2]) for part in frames.parts] == [
        (slice(k, k + 1), slice(None)) for k in range(8)]
    assert all(part[3].shape == (1, 32, 64, 3) for part in frames.parts)


def test_exported_video_identical_with_devices(tmp_path):
    """Scene.main(devices=8) writes the same bytes as one device (a final
    batch of 3 frames over 8 shards)."""
    single, sharded = tmp_path / "single.raw", tmp_path / "sharded.raw"
    with blocked():
        Ramp().main(width=64, height=32, fps=10, time=1.1, output=str(single), batch=8,
                    device="cpu")
        scene = Ramp()
        scene.mesh_devices = ["cpu"] * 8
        scene.main(width=64, height=32, fps=10, time=1.1, output=str(sharded), batch=8,
                   devices=8, device="cpu")
    assert scene.engine.mesh == cpu_mesh(8)
    assert single.read_bytes() == sharded.read_bytes()


def test_feedback_scene_row_sharded_on_eight_devices(tmp_path):
    """A feedback scene at 16x8 over 8 shards renders a row each and the
    frames' feedback adds up: 0.1, 0.2, 0.3."""
    out = tmp_path / "fb.raw"
    with blocked():
        scene = Feedback()
        scene.mesh_devices = ["cpu"] * 8
        scene.main(width=16, height=8, fps=10, time=0.3, output=str(out), devices=8,
                   device="cpu")
    frames = np.frombuffer(out.read_bytes(), np.uint8).reshape(3, 8, 16, 3)
    np.testing.assert_allclose(frames[:, 0, 0, 0] / 255, [0.1, 0.2, 0.3], atol=0.01)
    assert [shard.windows["iScreen"] for shard in scene.engine._shards] == [
        (k, k + 1) for k in range(8)]


def test_row_sharded_flush_actually_shards():
    """MotionBlur over 4 shards: each shard renders only its 8 of 32 rows
    (2 layers, 3 frames a flush), its part of the output is its rows, and
    each keeps its own ring, whole, for the next flush, which again equals
    the single device's."""
    with blocked():
        demo = _import_example("torch", "torch_demo")
        single, single_frames = capture(demo.MotionBlur, 3, batches=2)
        scene, frames = capture(demo.MotionBlur, 3, shards=4, batches=2)
    engine = scene.engine
    for got, want in zip(frames, single_frames):
        assert got.shape == (3, 32, 64, 3)
        np.testing.assert_array_equal(flushed(got), flushed(want))
    assert [(part[1], part[2]) for part in frames[-1].parts] == [
        (slice(0, 3), slice(8 * k, 8 * k + 8)) for k in range(4)]
    for index, shard in enumerate(engine._shards):
        assert shard.windows == {"iScreen": (8 * index, 8 * index + 8)}
        assert shard.rows_rendered == {"iScreen": 2 * 3 * 2 * 8}
    rings = [shard.carry["iScreen"] for shard in engine._shards]
    assert len({id(ring.data) for ring in rings}) == 4
    want = single.engine.carried()["iScreen"]
    for ring in rings:
        np.testing.assert_array_equal(ring.ordered().numpy(), want.numpy())
    np.testing.assert_array_equal(engine.carried()["iScreen"].numpy(), want.numpy())


def test_flush_of_five_over_four_shards():
    """5 frames over 4 shards need no padding: parts of 2, 1, 1, 1."""
    with blocked():
        _, (single,) = capture(Ramp, 5)
        scene, (sharded,) = capture(Ramp, 5, shards=4)
    np.testing.assert_array_equal(flushed(sharded), flushed(single))
    assert [len(shard.frames) for shard in scene.engine._shards] == [2, 1, 1, 1]


def test_row_sharded_with_streamed_texture_bit_identical():
    with blocked():
        scene, (sharded,) = capture(FeedbackStream, 7, shards=4, time=0.7)
        _, (single,) = capture(FeedbackStream, 7, time=0.7)
    assert "noise" in scene.engine._streamed_names
    assert sharded.shape == (7, 32, 64, 3)
    np.testing.assert_array_equal(flushed(sharded), flushed(single))


def test_resume_feedback_scene_row_sharded(tmp_path):
    """start= on MotionBlur over 4 shards replays its history through the
    row-sharded flush: the frames from 0.6 s on equal the full export's."""
    demo = _import_example("torch", "torch_demo")
    options = dict(width=64, height=32, fps=10, time=1.1, device="cpu", batch=4)
    full, resumed = tmp_path / "full.rgb", tmp_path / "resumed.rgb"
    with blocked():
        demo.MotionBlur().main(output=str(full), **options)
        scene = demo.MotionBlur()
        scene.mesh_devices = ["cpu"] * 4
        scene.main(output=str(resumed), devices=4, start=0.6, **options)
    assert scene.engine.mesh == cpu_mesh(4)
    frame = 32 * 64 * 3
    assert resumed.read_bytes() == full.read_bytes()[6 * frame:]


def test_devices_flag_reaches_the_export(tmp_path, monkeypatch):
    """`--devices 4` through cli.main shards the export (the frame path
    ran) and writes the single export's bytes."""
    from shaderflow_tpu_torch import cli
    calls = []
    flush_frames = mesh.flush_frames
    monkeypatch.setattr(mesh, "flush_frames",
                        lambda engine, count: calls.append(count) or flush_frames(engine,
                                                                                  count))
    monkeypatch.setattr(ShaderScene, "mesh_devices", ["cpu"] * 4)
    demo = REPO / "examples" / "torch" / "torch_glsl_demo.py"
    argv = [str(demo), "Plasma", "main", "-w", "32", "-h", "18", "-f", "10", "-t", "0.3",
            "--device", "cpu"]
    with blocked():
        cli.main([*argv, "-o", str(tmp_path / "single.rgb")])
        assert calls == []
        cli.main([*argv, "--devices", "4", "-o", str(tmp_path / "sharded.rgb")])
    assert calls == [3]
    assert (tmp_path / "single.rgb").read_bytes() == (tmp_path / "sharded.rgb").read_bytes()


# (scene, its height, devices asked, devices in the pool): the export loop's
# three messages, word for word as the JAX package's on 8 virtual devices
MESSAGES = {"fewer_devices": (Ramp, 8, 16, 8), "frame_sharded": (Ramp, 8, 4, 8),
            "rows_do_not_divide": (Feedback, 6, 4, 8)}


@pytest.mark.parametrize("case", sorted(MESSAGES))
def test_export_messages_match_jax(tmp_path, caplog, monkeypatch, case):
    """Fewer devices than asked and rows that do not divide warn and
    render on one device; a frame-sharded export says how it splits. Each
    message equals the JAX package's for the same scene and pool, and the
    output the single device's."""
    import jax.numpy as jnp

    from shaderflow_tpu import ops
    from shaderflow_tpu.scene import ShaderScene as JaxScene
    _fix_reference_texture(monkeypatch)
    cls, height, devices, pool = MESSAGES[case]

    class JaxRamp(JaxScene):
        def build(self):
            self.shader.fragment = lambda sf: ops.vec4(
                jnp.broadcast_to(sf.iTime, sf.astuv.shape[:-1]),
                sf.astuv[..., 0], sf.astuv[..., 1], 1.0)

    class JaxFeedback(JaxScene):
        def build(self):
            self.shader.texture.temporal = 2
            self.shader.fragment = lambda sf: ops.vec4(
                sf.texture(sf.tex("iScreen", 1, 0), sf.astuv)[..., 0] + 0.1, 0.0, 0.0, 1.0)

    options = dict(width=16, height=height, fps=10, time=0.3, batch=8)
    messages = []
    for name in ("shaderflow_tpu", "shaderflow_tpu_torch"):
        caplog.set_level(logging.INFO, logger=name)
    for package in ("jax", "port"):
        caplog.clear()
        if package == "jax":
            scene = (JaxRamp if cls is Ramp else JaxFeedback)()
            scene.main(output=str(tmp_path / "jax.rgb"), devices=devices, **options)
        else:
            with blocked():
                scene = cls()
                scene.mesh_devices = ["cpu"] * pool
                scene.main(output=str(tmp_path / "sharded.rgb"), devices=devices,
                           device="cpu", **options)
                cls().main(output=str(tmp_path / "single.rgb"), device="cpu", **options)
        messages.append([record.getMessage() for record in caplog.records
                         if "devices" in record.getMessage()][:1])
        sharded = scene.engine.mesh is not None
    assert messages[0] == messages[1] and messages[0], messages
    assert sharded == (case == "frame_sharded")
    assert (tmp_path / "sharded.rgb").read_bytes() == (tmp_path / "single.rgb").read_bytes()


class TailFeedback(ShaderScene):
    """A ring program and a main program ending in a fused tail."""

    def build(self):
        ring = ShaderProgram(scene=self, name="ring")
        ring.texture.temporal = 3
        ring.fragment = lambda sf: sl.vec4(
            0.5 * sf.texture(sf.tex("ring", 1, 0), sf.astuv)[..., 0]
            + 0.5 * sf.astuv[..., 0], sf.astuv[..., 1], 0.0, 1.0)

        def main(sf):
            red = sf.texture(sf.tex("ring", 0, 0), sf.astuv)[..., 0]
            return sf.tail(lambda tp: (tp.plane("r"), tp.astuv_y * tp.plane("r"),
                                       tp.astuv_x), r=red)
        self.shader.fragment = main


class BlurFeedback(ShaderScene):
    """A ring program that blurs the planes it computed (a convolution)."""

    def build(self):
        from shaderflow_tpu_torch.ops.sampling import convolve2d
        self.shader.texture.temporal = 2

        def frag(sf):
            prev = sf.texture(sf.tex("iScreen", 1, 0), sf.astuv)
            blurred = convolve2d(prev, torch.full((3, 3), 1.0 / 9.0))
            return sl.vec4(0.3 * blurred[..., 0] + 0.7 * sf.astuv[..., 0], sf.astuv[..., 1],
                           blurred[..., 2], 1.0)
        self.shader.fragment = frag


@pytest.mark.parametrize("cls, ssaa, whole", [
    (TailFeedback, 2, "iScreen"), (TailFeedback, 1, "iScreen"), (BlurFeedback, 1, "iScreen"),
], ids=["tail-ssaa2", "tail-ssaa1", "blur"])
def test_ops_across_rows_render_whole(tmp_path, cls, ssaa, whole):
    """Under the row path a fused tail and a convolution make their
    program render whole rows on every shard (the ring program of
    TailFeedback stays sharded), and the export equals the single one."""
    options = dict(width=48, height=32, fps=10, time=0.6, ssaa=ssaa, device="cpu")
    with blocked():
        cls().main(output=str(tmp_path / "single.rgb"), **options)
        scene = cls()
        scene.mesh_devices = ["cpu"] * 4
        scene.main(output=str(tmp_path / "sharded.rgb"), devices=4, **options)
    assert scene.engine._whole_rows == {whole}
    assert (tmp_path / "sharded.rgb").read_bytes() == (tmp_path / "single.rgb").read_bytes()
    if cls is TailFeedback:
        assert scene.engine._shards[1].windows["ring"] == (8 * ssaa, 16 * ssaa)


def test_convolution_on_a_slab_is_not_exact(tmp_path, monkeypatch):
    """Without the guard (every render whole-rows-blind) BlurFeedback's
    slabs blur across their edges with zeros: the export differs. The
    guard is what keeps the row path exact."""
    options = dict(width=48, height=32, fps=10, time=0.6, device="cpu")
    monkeypatch.setattr(mesh, "slab", lambda rows: contextlib.nullcontext())
    with blocked():
        BlurFeedback().main(output=str(tmp_path / "single.rgb"), **options)
        scene = BlurFeedback()
        scene.mesh_devices = ["cpu"] * 4
        scene.main(output=str(tmp_path / "sharded.rgb"), devices=4, **options)
    assert scene.engine._whole_rows == set()
    assert (tmp_path / "sharded.rgb").read_bytes() != (tmp_path / "single.rgb").read_bytes()


# -- the scenes ---------------------------------------------------------------------

@pytest.mark.parametrize("devices", [4, 8])
@pytest.mark.parametrize("name", FRAME_SCENES)
def test_graded_scene_sharded_export_bit_identical(exports, name, devices):
    """Frame path: 11 frames over 4 or 8 shards, bit-identical to one
    device; each shard rendered its contiguous part of the batch."""
    port, _, shards = exports
    single, sharded = port[(name, None)], port[(name, devices)]
    assert single.shape == sharded.shape == (FRAMES, 54, WIDTH, 3)
    np.testing.assert_array_equal(sharded, single)
    parts = [shard["frames"] for shard in shards[f"{name}/{devices}"]]
    assert len(parts) == devices and sum(parts, []) == list(range(FRAMES))
    assert [len(part) for part in parts] == [len(part) for part in np.array_split(
        np.arange(FRAMES), devices)]


@pytest.mark.parametrize("devices", [4, 8])
@pytest.mark.parametrize("name", ROW_SCENES)
def test_feedback_scene_row_sharded_export_bit_identical(exports, name, devices):
    """Row path: bit-identical to one device; each shard rendered its
    56 / N rows of the main program and its 108 / 4 rows of Life's
    simulation, which at 8 shards it rendered whole."""
    port, _, shards = exports
    single, sharded = port[(name, None)], port[(name, devices)]
    assert single.shape == sharded.shape == (FRAMES, 56, WIDTH, 3)
    np.testing.assert_array_equal(sharded, single)
    for index, shard in enumerate(shards[f"{name}/{devices}"]):
        rows = 56 // devices
        assert shard["windows"]["iScreen"] == [index * rows, (index + 1) * rows]
        if name == "Life":
            assert shard["windows"]["iLife"] == ([0, 108] if devices == 8 else
                                                 [index * 27, (index + 1) * 27])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sharded_export_matches_jax_sharded_export(exports, name):
    """The port's devices=8 export against the JAX package's on its 8
    virtual devices, at the bar tests/test_torch_scenes.py holds the
    scenes to: at most one u8 step on < 1 % of values (measured: equal)."""
    port, jax, _ = exports
    got, want = port[(name, 8)], jax[name]
    assert got.shape == want.shape and got.std() > 5
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"{name}: max {diff.max()} u8 steps on {(diff != 0).mean():.4%} of values")
    assert diff.max() <= 1 and (diff != 0).mean() < 0.01
