"""Mipmapped textures of the PyTorch port against the JAX package, on the
CPU: the pyramid (ops/sampling.py mip_pyramid, GL's NPOT floor), the level
from the uv field (auto_lod), trilinear sampling with a Python-scalar, a
tensor-scalar and a per-pixel level (sample_mip), anisotropic taps
(sample_mip_aniso), the mip branch of sample_separable, the anisotropy
warning of a texture without mipmaps (texture.py), the pyramid Frag.tex
hands out (once per static upload), and a mipmapped scene exported by
both packages: the background image at about 4 texels a pixel through
stexture, isotropic and with anisotropy=4.

Bars: float32 within 2e-5 of the JAX function (eager JAX, one rounding
per op; the level's log2 may sit an ulp apart); the scenes' u8 frames at
most one step on < 1 % of values, the JAX scenes run in a child
interpreter on XLA:CPU capped at the AVX ISA (tests/test_torch_scene.py)."""

import logging
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shaderflow_tpu.ops import sampling as jax_sampling
from shaderflow_tpu_torch.ops import sampling

REPO = Path(__file__).resolve().parent.parent
ATOL = 2e-5
WIDTH, HEIGHT = 96, 54


def _texture(shape, seed=0):
    data = np.random.default_rng(seed).random(shape, np.float32)
    return (sampling.Sampler2D(torch.from_numpy(data)),
            jax_sampling.Sampler2D(jnp.asarray(data)))


def _grid_uv(out_h, out_w, span_u=1.0, span_v=1.0, u0=0.0, v0=0.0):
    """An image-shaped (H, W, 2) uv field: out_w x out_h pixel centers over
    [u0, u0 + span_u] x [v0, v0 + span_v]."""
    u = u0 + (np.arange(out_w) + 0.5) / out_w * span_u
    v = v0 + (np.arange(out_h) + 0.5) / out_h * span_v
    return np.stack(np.meshgrid(u, v), -1).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape,max_levels", [((64, 64, 3), None), ((7, 5, 3), None),
                                              ((33, 20, 4), None), ((64, 48, 3), 3)],
                         ids=["pot", "npot-7x5", "npot-33x20", "max-levels"])
def test_mip_pyramid_matches_jax(shape, max_levels):
    """Level sizes (odd sides floor, GL's NPOT convention) and contents."""
    port, jax_tex = _texture(shape, seed=shape[0])
    got = sampling.mip_pyramid(port, max_levels)
    want = jax_sampling.mip_pyramid(jax_tex, max_levels)
    assert [(l.height, l.width) for l in got.levels] == [(l.height, l.width)
                                                         for l in want.levels]
    if shape[:2] == (7, 5):
        assert [(l.height, l.width) for l in got.levels] == [(7, 5), (3, 2), (1, 1)]
    for g, w in zip(got.levels, want.levels):
        _close(g.data, w.data)
    assert got.aniso == want.aniso == 1 and got.base is port and got.height == shape[0]


def test_auto_lod_matches_jax():
    """The per-pixel level of a zoom-out (8 texels a pixel: level 3), of a
    magnification (clamped at 0) and of a warped field."""
    rng = np.random.default_rng(4)
    warped = _grid_uv(24, 40, 3.0, 2.0) + rng.uniform(-0.01, 0.01, (24, 40, 2)).astype(np.float32)
    for uv, (h, w) in ((_grid_uv(32, 32), (256, 256)),
                       (_grid_uv(64, 64, 0.1, 0.1), (256, 256)), (warped, (128, 96))):
        got = sampling.auto_lod(torch.from_numpy(uv), h, w)
        want = jax_sampling.auto_lod(jnp.asarray(uv), h, w)
        _close(got, want)
    assert abs(float(sampling.auto_lod(torch.from_numpy(_grid_uv(32, 32)), 256, 256).mean())
               - 3.0) < 0.1


@pytest.mark.parametrize("lod", ["auto", "static", "static-integer", "tensor", "field"])
def test_sample_mip_matches_jax(lod):
    """sample_mip with the level from the uv field, a Python scalar (two
    levels), a tensor scalar and a per-pixel field (hat weights over every
    level)."""
    port, jax_tex = _texture((64, 48, 3), seed=7)
    mip, jax_mip = sampling.mip_pyramid(port), jax_sampling.mip_pyramid(jax_tex)
    uv = _grid_uv(16, 20, 2.0, 1.5, -0.3, 0.1)
    field = np.random.default_rng(8).uniform(-0.5, 6.0, (16, 20)).astype(np.float32)
    port_lod, jax_lod = {
        "auto": (None, None), "static": (1.5, 1.5), "static-integer": (2.0, 2.0),
        "tensor": (torch.tensor(2.25), jnp.float32(2.25)),
        "field": (torch.from_numpy(field), jnp.asarray(field))}[lod]
    got = sampling.sample_mip(mip, torch.from_numpy(uv), port_lod)
    want = jax_sampling.sample_mip(jax_mip, jnp.asarray(uv), jax_lod)
    assert tuple(got.shape) == want.shape == (16, 20, 3)
    _close(got, want)


def test_static_lod_two_level_matches_weighted():
    """A Python-scalar level samples exactly two levels; the same level as
    a tensor blends every level with hat weights: the same values."""
    port, _ = _texture((32, 32, 3))
    mip = sampling.mip_pyramid(port)
    uv = torch.from_numpy(_grid_uv(16, 16))
    np.testing.assert_allclose(sampling.sample_mip(mip, uv, lod=1.5).numpy(),
                               sampling.sample_mip(mip, uv, lod=torch.tensor(1.5)).numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("oblique", [True, False], ids=["oblique", "isotropic"])
def test_sample_mip_aniso_matches_jax(oblique):
    """Four anisotropic taps: an oblique footprint (8x along v, 1x along u)
    and an isotropic one (the ratio clamps to 1: plain trilinear)."""
    port, jax_tex = _texture((128, 96, 3), seed=11)
    mip = sampling.mip_pyramid(port, anisotropy=4)
    jax_mip = jax_sampling.mip_pyramid(jax_tex, anisotropy=4)
    uv = _grid_uv(32, 24, 24 / 96, 1.0) if oblique else _grid_uv(32, 24, 1.0, 1.0)
    got = sampling.sample_mip_aniso(mip, torch.from_numpy(uv), taps=4)
    want = jax_sampling.sample_mip_aniso(jax_mip, jnp.asarray(uv), taps=4)
    _close(got, want)
    # the sampler's own call takes the same taps (aniso > 1)
    _close(mip(torch.from_numpy(uv)), want)
    if not oblique:
        _close(got, sampling.sample_mip(sampling.mip_pyramid(port), torch.from_numpy(uv)))


def test_sample_separable_mip_branch_matches_jax():
    """sample_separable on a MipSampler: the levels' separable samples
    blended around one level from the line spacing; sample() on a
    MipSampler takes the per-pixel level."""
    port, jax_tex = _texture((80, 120, 3), seed=2)
    mip, jax_mip = sampling.mip_pyramid(port), jax_sampling.mip_pyramid(jax_tex)
    u = ((np.arange(30) + 0.5) / 30 * 2.2 - 0.4).astype(np.float32)
    v = (1.0 - (np.arange(20) + 0.5) / 20 * 1.7).astype(np.float32)
    got = sampling.sample_separable(mip, torch.from_numpy(u), torch.from_numpy(v))
    want = jax_sampling.sample_separable(jax_mip, jnp.asarray(u), jnp.asarray(v))
    assert tuple(got.shape) == want.shape == (20, 30, 3)
    _close(got, want)
    uv = _grid_uv(20, 30, 2.0, 1.5)
    _close(sampling.sample(mip, torch.from_numpy(uv)),
           jax_sampling.sample(jax_mip, jnp.asarray(uv)))


def test_single_level_fast_paths_reject_mips():
    """The banded single-level samplers refuse a MipSampler (its filtering
    would be lost), as the JAX package's do."""
    port, _ = _texture((16, 16, 3))
    mip = sampling.mip_pyramid(port)
    line = torch.linspace(0.1, 0.9, 8)
    with pytest.raises(TypeError, match="single-level"):
        sampling.sample_rows_planes_blocked(mip, line, 1.0)
    with pytest.raises(TypeError, match="single-level"):
        sampling.sample_separable_planes(mip, line, line)
    with pytest.raises(TypeError, match="single-level"):
        sampling.sample_separable_planes_blocked(mip, line, line, (1.0, 1.0))


def test_anisotropy_without_mipmaps_warns(caplog):
    """An explicit anisotropy on a texture without mipmaps warns (there is
    no pyramid to filter against); the default x16, anisotropy=1 and a
    mipmapped texture do not. The attribute reads 16 by default."""
    from shaderflow_tpu_torch.scene import ShaderScene
    from shaderflow_tpu_torch.texture import ShaderTexture

    class Empty(ShaderScene):
        def build(self):
            pass

    scene = Empty()
    with caplog.at_level(logging.WARNING, logger="shaderflow_tpu_torch"):
        ShaderTexture(scene=scene, name="iAniso", anisotropy=8)
    assert any("anisotropic filtering needs the mip pyramid" in r.message
               for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="shaderflow_tpu_torch"):
        default = ShaderTexture(scene=scene, name="iDefault")
        ShaderTexture(scene=scene, name="iOff", anisotropy=1)
        mipped = ShaderTexture(scene=scene, name="iMip", anisotropy=8, mipmaps=True)
    assert not any("anisotropic" in r.message for r in caplog.records)
    assert (default.anisotropy, default._aniso_explicit) == (16, False)
    assert (mipped.anisotropy, mipped._aniso_explicit, mipped.mipmaps) == (8, True, True)


# --------------------------------------------------------------------------- #
# The mipmapped scene, in both packages

def mip_scene(package: str, anisotropy=None):
    """The background image (1920x1080) with mipmaps=True, sampled through
    stexture at a zoom of 2 (the view spans 4 repeats: about 4 texels a
    pixel at 1080p, 80 at this test's 96x54), written the same way for
    either package."""
    import importlib
    scene_module = importlib.import_module(f"{package}.scene")
    texture_module = importlib.import_module(f"{package}.texture")
    ops = importlib.import_module(f"{package}.ops")
    background = REPO / "examples" / "assets" / "background.png"

    def frag(sf):
        anchor = ops.vec2(0.5, 0.5)
        if package == "shaderflow_tpu_torch":
            anchor = anchor.to(sf.device)
        return sf.stexture("background", ops.zoom(sf.stuv, 2.0, anchor))

    class MipBackground(scene_module.ShaderScene):
        def build(self):
            texture_module.ShaderTexture(scene=self, name="background", mipmaps=True,
                                         anisotropy=anisotropy).from_image(background)
            self.shader.fragment = frag

    return MipBackground


JAX_SCRIPT = """
import os, sys
import numpy as np
import pytest
sys.path.insert(0, TESTS)
from test_torch_scene import _fix_reference_texture
_fix_reference_texture(pytest.MonkeyPatch())
from test_torch_mipmaps import mip_scene
results = {}
for aniso in (None, 4):
    out = os.path.join(TMP, f"mip_{aniso}.rgb")
    mip_scene("shaderflow_tpu", aniso)().main(width=WIDTH, height=HEIGHT, fps=10, time=0.2,
                                              ssaa=1, subsample=1, output=out)
    results[f"mip/{aniso}"] = np.fromfile(out, np.uint8)
np.savez(OUTPUT, **results)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mipmaps")
    script = (f"TESTS, TMP, OUTPUT = {str(REPO / 'tests')!r}, {str(tmp)!r}, "
              f"{str(tmp / 'jax.npz')!r}\nWIDTH, HEIGHT = {WIDTH}, {HEIGHT}\n" + JAX_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               SHADERFLOW_NO_COMPILE_CACHE="1", HOME=str(tmp))
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=400)
    assert result.returncode == 0, result.stderr[-4000:]
    return dict(np.load(tmp / "jax.npz"))


@pytest.mark.parametrize("anisotropy", [None, 4], ids=["trilinear", "aniso4"])
def test_mipmapped_scene_matches_jax(reference, tmp_path, monkeypatch, anisotropy):
    """The mipmapped background exported by both packages (ssaa 1,
    subsample 1): at most one u8 step on < 1 % of values; Frag.tex hands
    out the pyramid (anisotropic only when asked for), built once for the
    export although each frame samples it."""
    builds = []
    original = sampling.mip_pyramid

    def counted(*args, **kwargs):
        builds.append(kwargs.get("anisotropy"))
        return original(*args, **kwargs)

    monkeypatch.setattr(sampling, "mip_pyramid", counted)
    out = tmp_path / "port.rgb"
    mip_scene("shaderflow_tpu_torch", anisotropy)().main(
        width=WIDTH, height=HEIGHT, fps=10, time=0.2, ssaa=1, subsample=1, output=str(out),
        batch=1, device="cpu")
    got = np.fromfile(out, np.uint8)
    want = reference[f"mip/{anisotropy}"]
    assert got.size == want.size == 2 * HEIGHT * WIDTH * 3
    assert builds == [anisotropy or 1]
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"mip scene anisotropy={anisotropy}: max {diff.max()} u8 steps on "
          f"{(diff != 0).mean():.4%}")
    assert diff.max() <= 1 and (diff != 0).mean() < 0.01
    # minification filtered: far smoother than level 0 sampled alone
    assert got.reshape(2, HEIGHT, WIDTH, 3)[0].std() > 5


def test_mipmapped_scene_differs_from_level_zero(tmp_path):
    """The mip path changes what a minifying view shows: the same view with
    mipmaps=False (level 0, bilinear) is not the same frame."""
    out_mip, out_flat = tmp_path / "mip.rgb", tmp_path / "flat.rgb"
    mip_scene("shaderflow_tpu_torch")().main(width=WIDTH, height=HEIGHT, fps=10, time=0.1,
                                             ssaa=1, subsample=1, output=str(out_mip),
                                             device="cpu")
    flat = mip_scene("shaderflow_tpu_torch")()
    flat.initialize()
    next(m for m in flat.modules if getattr(m, "name", None) == "background").mipmaps = False
    flat.main(width=WIDTH, height=HEIGHT, fps=10, time=0.1, ssaa=1, subsample=1,
              output=str(out_flat), device="cpu")
    mip, level0 = np.fromfile(out_mip, np.uint8), np.fromfile(out_flat, np.uint8)
    assert mip.size == level0.size and np.abs(mip.astype(int) - level0.astype(int)).max() > 10
