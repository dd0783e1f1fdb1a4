"""The PyTorch port's program loop (shaderflow_tpu_torch/engine.py) against
the JAX package's engine (shaderflow_tpu/engine.py:275-331, :442-492): a
scene of three programs — a temporal ring of 3 slots and 2 layers at its own
size, seeded by a texture.write into slot 2 before the first frame; a
program whose fragment returns a TailSpec that the plain tail evaluates
into its matrix, padded to 4 components; and the main program sampling
both — exported in flushes of 2 frames, so the ring is carried across
flushes; a program drawn as two instances, the second discarding half
the screen; and the built-in missing-texture program. Both packages export the same scenes (the JAX package in a
child on XLA:CPU capped at the AVX ISA); the fragments are arithmetic and
bilinear samples only, so the frames are held bit-equal."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
WIDTH, HEIGHT, FPS, SECONDS, BATCH = 64, 36, 10, 0.7, 2
RING_SIZE = (40, 24)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU frames are thousands of small torch ops (RayMarch:
    13,592 a frame). Beside the other test workers on one machine, torch's
    intra-op threads spin against theirs (a 7 s test took 497 s in a run
    of six workers): this file's tests run on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# The scenes, run as they stand by both packages: `ops`, `ShaderScene` and
# `ShaderProgram` are each package's own (port_scenes for the port)
SCENES = '''
def feedback_frag(sf):
    u, v = sf.astuv[..., 0], sf.astuv[..., 1]
    if sf.iLayer == 0:
        previous = sf.texture(sf.tex("feedback", 1, 1), sf.astuv)
        return ops.vec4(ops.fract(u + sf.iTime * 0.37), v * 0.5,
                        previous[..., 2] * 0.9 + 0.05, 1.0)
    now = sf.texture(sf.tex("feedback", 0, 0), sf.astuv)
    old = sf.texture(sf.tex("feedback", 2, 1), sf.astuv)
    return now * 0.5 + old * 0.5


def tailed_frag(sf):
    newest = sf.texture(sf.tex("feedback", 1, 1), sf.astuv)

    def tail(tp):
        a = tp.plane("a")
        return a, 1.0 - a, a * a

    return sf.tail(tail, a=newest[..., 0])


def main_frag(sf):
    tailed = sf.texture("tailed", sf.astuv)
    ring = sf.texture(sf.tex("feedback", 1, 0), sf.stuv)
    return ops.vec4(tailed[..., 0] * 0.6 + ring[..., 1] * 0.4, tailed[..., 1],
                    ring[..., 2] + tailed[..., 3] * 0.1, 1.0)


class Chain(ShaderScene):
    """Three programs: render order is the reverse of creation, so the
    ring renders first, then the tailed program, then the main one."""

    def setup(self):
        seed = np.random.default_rng(3).random((RING_SIZE[1], RING_SIZE[0], 4))
        self.feedback.texture.write(seed.astype(np.float32), temporal=2, layer=1)

    def build(self):
        self.tailed = ShaderProgram(scene=self, name="tailed")
        self.tailed.fragment = tailed_frag
        self.feedback = ShaderProgram(scene=self, name="feedback")
        self.feedback.texture.temporal = 3
        self.feedback.texture.layers = 2
        self.feedback.texture.track = False
        self.feedback.texture.size = RING_SIZE
        self.feedback.fragment = feedback_frag
        self.shader.fragment = main_frag


def instanced_frag(sf):
    u, v = sf.astuv[..., 0], sf.astuv[..., 1]
    if sf.instance == 1:
        sf.discard(u < 0.5)
        return ops.vec4(0.2, v, 0.7, 1.0)
    return ops.vec4(u, 0.3, 0.1, 1.0)


class Instanced(ShaderScene):
    def build(self):
        self.shader.instances = 2
        self.shader.fragment = instanced_frag


class Missing(ShaderScene):
    """The built-in missing-texture program (not a fallback in the port)."""

    def build(self):
        self.shader.fragment = missing_fragment
'''

JAX_SCRIPT = """
import sys
import numpy as np
import pytest
sys.path.insert(0, TESTS)
from test_torch_scene import _fix_reference_texture
_fix_reference_texture(pytest.MonkeyPatch())
from shaderflow_tpu import ops
from shaderflow_tpu.scene import ShaderScene
from shaderflow_tpu.shader import ShaderProgram, missing_fragment
exec(SCENES)
Chain().main(width=WIDTH, height=HEIGHT, fps=FPS, time=SECONDS, batch=BATCH,
             output=f"{TMP}/jax_chain.rgb")
Instanced().main(width=WIDTH, height=HEIGHT, fps=FPS, time=0.2, output=f"{TMP}/jax_instanced.rgb")
Missing().main(width=WIDTH, height=HEIGHT, fps=FPS, time=0.3, output=f"{TMP}/jax_missing.rgb")
"""


def port_scenes() -> dict:
    """The scenes of SCENES on the port's API."""
    from shaderflow_tpu_torch import ops
    from shaderflow_tpu_torch.scene import ShaderScene
    from shaderflow_tpu_torch.shader import ShaderProgram, missing_fragment
    namespace = dict(np=np, ops=ops, ShaderScene=ShaderScene, ShaderProgram=ShaderProgram,
                     missing_fragment=missing_fragment, RING_SIZE=RING_SIZE)
    exec(SCENES, namespace)
    return namespace


def _read(path: Path) -> np.ndarray:
    return np.fromfile(path, np.uint8).reshape(-1, HEIGHT, WIDTH, 3)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("programs")
    script = (f"TESTS, TMP = {str(REPO / 'tests')!r}, {str(tmp)!r}\n"
              f"WIDTH, HEIGHT, FPS, SECONDS, BATCH = {WIDTH}, {HEIGHT}, {FPS}, {SECONDS}, "
              f"{BATCH}\nRING_SIZE = {RING_SIZE!r}\nSCENES = {SCENES!r}\n" + JAX_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               SHADERFLOW_NO_COMPILE_CACHE="1", HOME=str(tmp))
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-4000:]
    scenes = port_scenes()
    out = {"jax": _read(tmp / "jax_chain.rgb"),
           "jax_instanced": _read(tmp / "jax_instanced.rgb"),
           "jax_missing": _read(tmp / "jax_missing.rgb")}
    for name, batch in (("flushes", BATCH), ("one_flush", None)):
        scene = scenes["Chain"]()
        scene.main(width=WIDTH, height=HEIGHT, fps=FPS, time=SECONDS, batch=batch,
                   output=str(tmp / f"{name}.rgb"), device="cpu")
        out[name] = _read(tmp / f"{name}.rgb")
    resumed = scenes["Chain"]()
    resumed.main(width=WIDTH, height=HEIGHT, fps=FPS, time=SECONDS, start=0.4, batch=BATCH,
                 output=str(tmp / "resumed.rgb"), device="cpu")
    out["resumed"] = _read(tmp / "resumed.rgb")
    scenes["Instanced"]().main(width=WIDTH, height=HEIGHT, fps=FPS, time=0.2,
                               output=str(tmp / "instanced.rgb"), device="cpu")
    out["instanced"] = _read(tmp / "instanced.rgb")
    scenes["Missing"]().main(width=WIDTH, height=HEIGHT, fps=FPS, time=0.3,
                             output=str(tmp / "missing.rgb"), device="cpu")
    out["missing"] = _read(tmp / "missing.rgb")
    return out


@pytest.mark.parametrize("run", ["flushes", "one_flush"])
def test_programs_layers_and_ring_match_jax(exports, run):
    """Seven frames of the three-program scene: exported in flushes of two
    frames (the ring carried across four flushes) and in one flush, both
    bit-equal to the JAX package's export in flushes of two."""
    want = exports["jax"]
    got = exports[run]
    assert got.shape == want.shape == (round(SECONDS * FPS), HEIGHT, WIDTH, 3)
    assert len({frame.tobytes() for frame in got}) == got.shape[0]   # every frame moves
    np.testing.assert_array_equal(got, want)


def test_seeded_ring_reaches_the_first_frame(exports, tmp_path):
    """The seed written into the ring's slot 2, layer 1 before the first
    frame is the carried ring's slot 2 when the engine is built, and frame
    0 shows it: the same scene without the seed renders another frame 0."""
    scenes = port_scenes()
    scene = scenes["Chain"]()
    scene._setup_run(width=WIDTH, height=HEIGHT, fps=FPS, time=0.1, freewheel=True,
                     device="cpu")
    scene.engine.begin_batch()
    seed = np.random.default_rng(3).random((RING_SIZE[1], RING_SIZE[0], 4))
    ring = scene.engine.carried()["feedback"]
    assert ring.shape == (3, 2, RING_SIZE[1], RING_SIZE[0], 4)
    # GL write order: data row 0 is the bottom row
    np.testing.assert_array_equal(ring[2, 1].numpy(), seed.astype(np.float32)[::-1])
    assert not ring[:2].any() and not ring[2, 0].any()

    class Unseeded(scenes["Chain"]):
        def setup(self):
            pass

    Unseeded().main(width=WIDTH, height=HEIGHT, fps=FPS, time=0.1,
                    output=str(tmp_path / "unseeded.rgb"), device="cpu")
    assert not np.array_equal(_read(tmp_path / "unseeded.rgb")[0], exports["one_flush"][0])


def test_resume_renders_the_ring_history(exports):
    """main(start=0.4) on a scene with a temporal ring renders the four
    replayed frames (dropped) to rebuild the ring: the frames it exports
    equal the last three of the whole export."""
    np.testing.assert_array_equal(exports["resumed"], exports["one_flush"][4:])


def test_instances_and_discard_match_jax(exports):
    """Two instances of the main program: the second discards the left half
    of the screen, where the first one's output shows (GL's no-blending
    draw order): bit-equal to the JAX package."""
    got, want = exports["instanced"], exports["jax_instanced"]
    assert got.shape == want.shape and got.std() > 5
    np.testing.assert_array_equal(got, want)


def test_missing_fragment_matches_jax(exports):
    """The magenta checkerboard (fragment/missing.glsl) scrolling with
    iTime, three frames: bit-equal to the JAX package's."""
    got, want = exports["missing"], exports["jax_missing"]
    assert got.shape == want.shape and got.std() > 5
    np.testing.assert_array_equal(got, want)


def test_ring_roll_is_np_roll():
    """engine.Ring: slot t after k rolls holds what np.roll(matrix, k,
    axis=0) holds at t, without moving data; writes land in slot 0."""
    from shaderflow_tpu_torch.engine import Ring
    data = torch.arange(5 * 2 * 3, dtype=torch.float32).reshape(5, 2, 3)
    ring = Ring(data.clone())
    reference = data.numpy().copy()
    for step in range(7):
        ring[0, 1] = torch.full((3,), -float(step))
        reference[0, 1] = -float(step)
        ring.roll()
        reference = np.roll(reference, 1, axis=0)
        for t in range(-5, 5):
            np.testing.assert_array_equal(ring[t].numpy(), reference[t])
        np.testing.assert_array_equal(ring.ordered().numpy(), reference)
