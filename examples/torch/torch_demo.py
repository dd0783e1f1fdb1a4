"""
The demo scenes on the PyTorch port (shaderflow_tpu_torch).

Ports of examples/basic/demo.py: Basic (the built-in welcome program) and
ShaderToy (config 1), Waveform and MusicBars (config 2, over the offline
audio sequences), RayMarch (config 4: 100 masked march steps over a
six-box SDF union from the camera's rays), Dynamics (a spring-smoothed
zoom), MultiShader and Multipass (programs and layers sampling each
other), MotionBlur and Life (temporal rings), each in plain PyTorch with
the reference's operation order; and the Visualizer below.

    python examples/torch/torch_demo.py [Scene] [width height fps seconds ssaa]
                                      # default: Visualizer 1920 1080 60 2 2, to null

The Visualizer is examples/basic/demo.py's music visualizer (radial bars
over a blurred, breathing background, waveform overlays, vignette and
snare blink) in its offline form: the audio file's spectrogram and waveform are precomputed
as device sequences, the bar field of the whole batch is one table expand
(kernel K2, ops/sampling.py) in a batch prelude, the frame-invariant
per-pixel fields are a cached batch-invariant prelude, and everything per
pixel after the background rows runs in the fused tail (kernel K1,
ops/tailfuse.py) with the background and blur columns sampled inside it.

Two environment variables select what the reference grades, read where
the reference reads them: SHADERFLOW_VIZ_BLUR_LEVEL (the pyramid level of
the radial blur, default 4; level 1 blurs the full-resolution background
with the literal 9 x 9 splat kernel) when the fragment is built, and
SHADERFLOW_TAIL_BF16=1 (the tail's color chain in bfloat16,
ops/tailfuse.py) when the tail is traced.

    SHADERFLOW_TAIL_BF16=1 SHADERFLOW_VIZ_BLUR_LEVEL=1 python examples/torch/torch_demo.py

The per-frame fallback the reference keeps for its realtime preview (no
sequences, camera-dependent geometry in the tail) is not ported yet: the
scene raises NotImplementedError without its offline preludes.
"""

import math
import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from shaderflow_tpu_torch.dynamics import ShaderDynamics  # noqa: E402
from shaderflow_tpu_torch.message import ShaderMessage  # noqa: E402
from shaderflow_tpu_torch.ops import TAU, PI, tailfuse  # noqa: E402
from shaderflow_tpu_torch.ops import stdlib as sl  # noqa: E402
from shaderflow_tpu_torch.ops.stdlib import reciprocal  # noqa: E402
from shaderflow_tpu_torch.scene import ShaderScene  # noqa: E402
from shaderflow_tpu_torch.shader import ShaderProgram  # noqa: E402
from shaderflow_tpu_torch.texture import ShaderTexture  # noqa: E402
from shaderflow_tpu_torch.variable import Uniform  # noqa: E402

ASSETS = Path(__file__).resolve().parent.parent / "assets"
MUSIC = ASSETS / "music.wav"
BACKGROUND = ASSETS / "background.png"


def blur_level() -> int:
    """The pyramid level the radial blur is computed on:
    SHADERFLOW_VIZ_BLUR_LEVEL, default 4 (examples/basic/demo.py:413-425).
    Level 1 is the literal 80 taps on the full-resolution background; the
    default costs about 1/16th of its convolution. Nothing the engine caches
    depends on it: the batch-invariant prelude fields are geometry, and the
    blur is built per frame in the fragment."""
    return int(os.environ.get("SHADERFLOW_VIZ_BLUR_LEVEL", "4"))


def _axis_line(count: int, device) -> torch.Tensor:
    """Pixel centers over [0, 1]: (i + 0.5) / count."""
    return (torch.arange(count, dtype=torch.float32, device=device) + 0.5) * reciprocal(count)


def _screen_lines(ctx):
    """The screen's gluv lines (x aspect-scaled, y up) at the render size."""
    height, width = ctx.render_size
    device = ctx.frames.device
    gx = (_axis_line(width, device) * 2.0 - 1.0) * ctx.aspect
    gy = 1.0 - _axis_line(height, device) * 2.0
    return gx, gy


def _angle_field(gx, gy):
    """|atan2(x, -y)| / pi over the screen: the bar's radial angle."""
    return torch.abs(tailfuse.atan2(gx[None, :], -gy[:, None]) * reciprocal(PI))


def bar_field_inputs(ctx):
    """What the bar field expands: the batch's spectrogram tables (B, bins,
    C), the angle field (H, W) it is indexed by and the half-plane channel
    select (1, W); None without the spectrogram sequence."""
    tables = ctx.rows("iSpectrogram")            # (B, bins, 1, C)
    if tables is None:
        return None
    gx, gy = _screen_lines(ctx)
    # music_uv = rotate2d(-pi/2) * gluv = (-y, x): GLSL's mat2 is
    # column-major, so rotate2d applies the TRANSPOSE of the textbook rotation
    return tables[:, :, 0, :], _angle_field(gx, gy), gx[None, :] < 0


def _visualizer_bar_prelude(ctx):
    """The whole batch's radial-bar field: the per-pixel index map (angle ->
    spectrogram bin, half-plane -> channel) is frame-invariant, so the batch
    is one expand of the per-frame tables over the static field (kernel K2),
    exact for this scene's static default 2D camera."""
    inputs = bar_field_inputs(ctx)
    if inputs is None:
        return None
    from shaderflow_tpu_torch.ops.sampling import lookup_nearest_1d_select_batched
    tables, circle, left = inputs
    return lookup_nearest_1d_select_batched(tables, circle, channel_where=left,
                                            out_dtype=torch.bfloat16)


def _visualizer_static_prelude(ctx):
    """Batch-invariant per-pixel fields (leading axis 1: computed once and
    cached by the engine):

      * fscale: the bar-length falloff 0.05 + 3*sstep01(circle/2)
      * rad0:   |camera-plane uv| (the per-frame radius is rad0 * scale)
      * lvig:   log of the vignette field (the tail keeps exp(p * lvig))
      * blink:  the snare-blink radial power ((clip(|agluv|-0.3))^2)^3, bf16

    None outside offline mode (no spectrogram sequence): a preview's
    pan/zoom must not freeze camera-dependent geometry."""
    if ctx.sequence("iSpectrogram") is None:
        return None
    height, width = ctx.render_size
    device = ctx.frames.device
    gx, gy = _screen_lines(ctx)
    t = torch.clamp(_angle_field(gx, gy) / 2.0, 0.0, 1.0)
    fscale = 0.05 + 3.0 * (t * t * (3.0 - 2.0 * t))
    rad0 = torch.sqrt(gx[None, :] ** 2 + gy[:, None] ** 2)
    ax = _axis_line(width, device) * 2.0 - 1.0
    ay = 1.0 - _axis_line(height, device) * 2.0
    alen = torch.sqrt(ax[None, :] ** 2 + ay[:, None] ** 2)
    t6 = torch.clamp(alen - 0.3, 0.0, 1.0) ** 2
    blink = t6 * t6 * t6
    sx = _axis_line(width, device)
    sy = 1.0 - _axis_line(height, device)
    vig = (sx * (1.0 - sx))[None, :] * (sy * (1.0 - sy))[:, None]
    lvig = torch.log(torch.clamp(vig * 20.0, min=1e-6))
    # fscale and rad0 gate HARD edges (the bar ring thresholds): kept f32,
    # like lvig; blink is a smooth multiplier, stored bf16
    return {"iVizFscale": fscale[None],
            "iVizRad": rad0[None],
            "iVizLvig": lvig[None],
            "iVizBlink": blink.to(torch.bfloat16)[None]}


def _static_prelude_field(key):
    """One batch_preludes entry per field."""
    def fn(ctx):
        fields = _visualizer_static_prelude(ctx)
        return None if fields is None else fields[key]
    return fn


def _sstep01(x):  # smoothstep(0, 1, x)
    t = torch.clamp(x, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def visualizer_tail(color_inv: float):
    """Everything per pixel after the samples (plane dialect, ops/tailfuse.py)."""
    space_rgb = (1.0 / 255.0, 11.0 / 255.0, 26.0 / 255.0)

    def tail(tp):
        vol = tp.scalar("vol")
        std = tp.scalar("std")
        rgb = [(base + blur) * color_inv
               for base, blur in zip(tp.vec("base"), tp.vec("blur"))]

        # Blink on snare/kick: the radial power is a static prelude field
        blink = tp.f(1.0 + 5.0 * std * tp.plane("blinkp"))
        rgb = [c * blink for c in rgb]

        # Music bars: the angle falloff and unit radius are frame-invariant
        # fields; only the scale multiply is per frame
        scale = 1.0 - 0.4 * torch.sqrt(torch.abs(vol))
        radius = 0.17
        fscale = tp.plane("fscale", dtype=torch.float32)
        rad0 = tp.plane("rad0", dtype=torch.float32)
        r = rad0 * scale
        bar = torch.sqrt(tailfuse.divide(tp.plane("bar", dtype=torch.float32), 1000.0)) * fscale
        ring = radius + 0.5 * bar
        inside = r < radius
        on_bar = r < ring
        smix = tp.f(_sstep01(0.5 + bar))
        fall = tp.f(tailfuse.powf(torch.clamp((r - ring) * 0.5, min=1e-6), 0.05))
        rgb = [torch.where(inside, c * 0.5,
                           torch.where(on_bar, c + (1.0 - c) * smix, c * fall))
               for c in rgb]

        # Fade to deep space with camera-plane distance (|uv| == rad0)
        dmix = tp.f(_sstep01(tailfuse.divide(rad0, 20.0)))
        rgb = [c + (s - c) * dmix for c, s in zip(rgb, space_rgb)]

        # Vignette: only exp(p * lvig) is per frame
        vpow = tp.f(torch.exp((0.1 + 0.15 * vol) * tp.plane("lvig", dtype=torch.float32)))
        rgb = [c * vpow for c in rgb]

        # Waveform overlay top and bottom (screen gluv y)
        gy = tp.gluv_y
        dark = tp.f(torch.where(1.0 - gy < tp.col("wave0"), 0.8, 1.0)
                    * torch.where(1.0 + gy < tp.col("wave1"), 0.8, 1.0))
        rgb = [c * dark for c in rgb]

        # Out of bounds -> deep space color, last (the reference's early
        # return: no other stage touches an out-of-bounds pixel)
        oob = tp.col("oob") > 0.5
        return [torch.where(oob, s, c) for c, s in zip(rgb, space_rgb)]

    return tail


def visualizer_frag(sf):
    """Radial bars music visualizer (visualizer.frag), offline form: the
    background's uv map is an axis-aligned scale + translate (default 2D
    camera), so its bilinear sample is a row interpolation here and a column
    interpolation inside the tail; the 80-tap radial blur is one small
    convolution of the texture (sampling is linear, so blur and sample
    commute) on a pyramid level (blur_level), sampled the same way."""
    from shaderflow_tpu_torch.ops.downsample import box_downsample
    from shaderflow_tpu_torch.ops.sampling import (
        Sampler2D, convolve2d, sample_rows_planes_blocked, sample_separable,
        splat_kernel)

    bar_stack = sf.prelude_indexed("iBarField")
    stacks = {name: sf.prelude_indexed(name)
              for name in ("iVizFscale", "iVizRad", "iVizBlink", "iVizLvig")}
    if bar_stack is None or None in stacks.values():
        raise NotImplementedError(
            "Visualizer without its offline preludes (the realtime preview's "
            "per-frame fallback) is not ported yet: export with an audio file")

    cam = sf.camera
    gx, gy = cam.line("gluv")     # axis lines of the camera-projected uv
    device = gx.device
    z = 0.95 + 0.01 * torch.sin(sf.iTime) - 0.02 * sf.iAudioVolume - 0.03
    qx = ((gx + 1.0) / 2.0 - 0.5) * z * z + 0.5 + 0.005 * torch.cos(sf.iTime * 3.25135)
    qy = ((gy + 1.0) / 2.0 - 0.5) * z * z + 0.5 + 0.005 * torch.sin(sf.iTime * 1.153469)

    # stexture = gtexture(stuv2gluv(q)): u scales by tex_h/tex_w around center
    tex = sf.tex("background")
    aspect_scale = tex.height / tex.width
    u_line = ((2.0 * qx - 1.0) * aspect_scale + 1.0) / 2.0
    v_line = qy
    # Texel rows per output row: z^2 * tex_h / render_h with z <= 0.934,
    # bounded with z <= 0.96 for margin; positions stay inside [0, n-1]
    render_h = gy.shape[0]
    base_tpp = 0.96 ** 2 * tex.height / render_h
    base_rows = sample_rows_planes_blocked(
        tex, v_line, texels_per_px=base_tpp,
        precision="bfloat16", out_dtype=torch.bfloat16)[:3]

    # Radial blur (8 directions x 10 walks) as one texture-space kernel on
    # pyramid level `level` (1: the texture itself)
    intensity = 0.01 * torch.clamp(
        torch.pow(torch.clamp(sf.iAudioVolume, min=0.0), 2.5), 0.0, 0.3)
    quality, directions = 10, 8
    taps = []
    for d in range(directions):
        angle = TAU * d / directions
        for s in range(1, quality + 1):
            walk = s / quality
            taps.append((math.cos(angle) * walk, math.sin(angle) * walk))
    taps = torch.tensor(taps, dtype=torch.float32, device=device) * intensity
    level = blur_level()
    quarter_h, quarter_w = tex.height // level, tex.width // level
    quarter = (box_downsample(tex.data[:quarter_h * level, :quarter_w * level], level)
               if level > 1 else tex.data)
    # stuv offsets -> level texel units: both axes scale by the level height
    # (gtexture aspect correction), v-up flips to row-down
    offsets = taps * torch.tensor([quarter_h, -quarter_h], dtype=torch.float32,
                                  device=device)
    # The kernel covers the largest tap offset: intensity <= 0.003 stuv is
    # about 3.5 texels at level 1 (size 9), at most one level texel from
    # level 2 up (size 5 leaves margin)
    kernel = splat_kernel(offsets, size=5 if level >= 2 else 9)
    blurred = convolve2d(quarter, kernel)
    blur_tex = Sampler2D(blurred, linear=True, repeat_x=tex.repeat_x, repeat_y=tex.repeat_y)
    blur_tpp = 0.96 ** 2 * blur_tex.height / render_h
    blur_rows = sample_rows_planes_blocked(
        blur_tex, v_line, texels_per_px=blur_tpp,
        precision="bfloat16", out_dtype=torch.bfloat16)[:3]
    color_inv = 1.0 / (quality * directions)

    # Waveform on top and bottom: sampled at v = 0 along x only
    astuv_u, _ = sf.lines
    wave_row = sample_separable(sf.tex("iWaveform"), astuv_u,
                                torch.zeros(1, device=device))      # (1, W', C)
    wave = 0.2 * wave_row[0]                                         # (W', C)

    def indexed(pair):
        return tailfuse.Indexed(pair[0], pair[1])

    return sf.tail(
        visualizer_tail(color_inv),
        base=tailfuse.ColSampled(base_rows, u_line, texels_per_px=base_tpp),
        blur=tailfuse.ColSampled(blur_rows, u_line, texels_per_px=blur_tpp),
        bar=indexed(bar_stack),
        oob=tailfuse.Col(cam.out_of_bounds_x.to(torch.float32)),
        wave0=tailfuse.Col(wave[:, 0].contiguous()),
        wave1=tailfuse.Col(wave[:, 1].contiguous()),
        vol=sf.iAudioVolume, std=sf.iAudioSTD,
        fscale=indexed(stacks["iVizFscale"]), rad0=indexed(stacks["iVizRad"]),
        blinkp=indexed(stacks["iVizBlink"]), lvig=indexed(stacks["iVizLvig"]))


class Visualizer(ShaderScene):
    """Radial Bars Music Visualizer Scene"""
    audio_file = None

    def build(self):
        from shaderflow_tpu_torch.audio import ShaderAudio
        from shaderflow_tpu_torch.audio.spectrogram import ShaderSpectrogram
        from shaderflow_tpu_torch.audio.waveform import ShaderWaveform
        from shaderflow_tpu_torch.piano import PianoNote
        self.audio = ShaderAudio(scene=self, name="iAudio", file=self.audio_file or MUSIC)
        self.waveform = ShaderWaveform(scene=self, audio=self.audio)
        self.spectrogram = ShaderSpectrogram(scene=self, length=0, audio=self.audio,
                                             smooth=False)
        self.spectrogram.from_notes(
            start=PianoNote.from_frequency(20.0),
            end=PianoNote.from_frequency(14000.0),
            piano=True,
        )
        self.back = ShaderTexture(scene=self, name="background").from_image(BACKGROUND)
        self.shader.fragment = visualizer_frag
        self.batch_preludes["iBarField"] = _visualizer_bar_prelude
        for key in ("iVizFscale", "iVizRad", "iVizBlink", "iVizLvig"):
            self.batch_preludes[key] = _static_prelude_field(key)

    def handle(self, message):
        ShaderScene.handle(self, message)
        if isinstance(message, ShaderMessage.Window.FileDrop):
            self.back.from_image(message.first)


# ---------------------------------------------------------------------------- #
# Config 1: the built-in welcome program and the ShaderToy default

class Basic(ShaderScene):
    """Simplest ShaderScene (default neon-ring shader)"""


def shadertoy_frag(sf):
    """The ShaderToy default: cosine rainbow (shadertoy.frag)."""
    uv = sf.stuv
    phase = sf.iTime + torch.stack([uv[..., 0], uv[..., 1], uv[..., 0]], dim=-1)
    # (0, 2, 4) filled on the device: no host copy in the frame loop
    col = 0.5 + 0.5 * torch.cos(phase + torch.arange(3, dtype=torch.float32,
                                                     device=sf.device) * 2.0)
    return sl.vec4(col, 1.0)


class ShaderToy(ShaderScene):
    """ShaderToy Default Shader"""

    def build(self):
        self.shader.fragment = shadertoy_frag


# ---------------------------------------------------------------------------- #
# Programs and layers

def child_frag(sf):
    # Left screen green fading out; composited over a red ramp
    return sl.vec4(0.0, 1.0 - sf.stuv[..., 0], 0.0, 1.0)


def multishader_frag(sf):
    color = sl.vec4(sf.stuv[..., 0], 0.0, 0.0, 1.0)
    color = color + sl.with_alpha(sf.texture("child", sf.astuv), 0.0)
    return sl.with_alpha(color, 1.0)


class MultiShader(ShaderScene):
    """Basic scene with two shaders acting together"""

    def build(self):
        self.child = ShaderProgram(scene=self, name="child")
        self.child.fragment = child_frag
        self.shader.fragment = multishader_frag


_BLUR_KERNELS: dict = {}


def _blur(sf, tex, radius: float, directions: int, steps: int):
    """Walk in circles around the pixel and integrate weighted samples
    (multipass.frag blur()): the constant tap pattern is one texture-space
    kernel and a convolution (the sample coordinate is astuv itself, so no
    resample is needed). The kernel depends on the texture's size only and
    is built once per size and device."""
    from shaderflow_tpu_torch.ops.sampling import convolve2d, splat_kernel
    key = (radius, directions, steps, tex.width, tex.height, str(tex.data.device))
    if key not in _BLUR_KERNELS:
        taps, weights = [], []
        for d in range(directions):
            direction = TAU * d / directions
            for s in range(1, steps):
                walk = s / steps
                offset_uv = (radius * walk / 2000.0)
                taps.append((math.cos(direction) * offset_uv * tex.width,
                             -math.sin(direction) * offset_uv * tex.height))
                weights.append(1.0 - offset_uv / radius)
        kernel = splat_kernel(torch.tensor(taps, dtype=torch.float32), size=13,
                              weights=torch.tensor(weights, dtype=torch.float32))
        _BLUR_KERNELS[key] = (kernel.to(tex.data.device), sum(weights))
    kernel, total = _BLUR_KERNELS[key]
    return convolve2d(tex.data, kernel) * reciprocal(total)


def multipass_frag(sf):
    if sf.iLayer == 0:
        return sf.stexture("background", sf.stuv)
    color = sf.texture(sf.tex("iScreen", 0, 0), sf.astuv)
    inverted = sl.with_rgb(color, torch.stack(
        [1.0 - color[..., 0], color[..., 1], color[..., 2]], dim=-1))
    blurred = _blur(sf, sf.tex("iScreen", 0, 0), 5.0, 8, 8)
    out = torch.where(sf.gluv[..., 0:1] < 0, inverted, blurred)
    return sl.with_alpha(out, 1.0)


class Multipass(ShaderScene):
    """Multi layers done on a single shader"""

    def build(self):
        ShaderTexture(scene=self, name="background").from_image(BACKGROUND)
        self.shader.texture.layers = 2
        self.shader.fragment = multipass_frag


MOTION_BLUR_TEMPORAL = 10


def motionblur_frag(sf):
    cam = sf.camera
    uv = cam.stuv
    if sf.iLayer == 0:
        return sf.stexture("background", uv)
    color = None
    for i in range(MOTION_BLUR_TEMPORAL):
        # smoothstep on python constants, kept out of the trace
        t = 1.0 - i / MOTION_BLUR_TEMPORAL
        factor = t * t * (3.0 - 2.0 * t)
        term = sf.texture(sf.tex("iScreen", i, 0), sf.astuv) * factor
        color = term if color is None else color + term   # 0 + x == x
    return sl.with_alpha(sl.scaled_quotient(color, 2.0, MOTION_BLUR_TEMPORAL), 1.0)


class MotionBlur(ShaderScene):
    """Poor man's Motion Blur (temporal texture ring average)"""

    def build(self):
        ShaderTexture(scene=self, name="background").from_image(BACKGROUND)
        self.shader.texture.temporal = MOTION_BLUR_TEMPORAL
        self.shader.texture.layers = 2
        self.shader.fragment = motionblur_frag


def dynamics_frag(sf):
    anchor = torch.full((2,), 0.5, dtype=torch.float32, device=sf.device)
    return sf.stexture("background", sl.zoom(sf.stuv, 0.85 + 0.1 * sf.iShaderDynamics, anchor))


class Dynamics(ShaderScene):
    """Second order system springing a zoom on a square wave"""

    def build(self):
        ShaderTexture(scene=self, name="background").from_image(BACKGROUND)
        self.dynamics = ShaderDynamics(scene=self, name="iShaderDynamics", frequency=4)
        self.shader.fragment = dynamics_frag

    def update(self):
        # This is how square waves are born in the digital world
        self.dynamics.target = 0.5 * (1 + np.sign(np.sin(2 * math.pi * self.time * 0.5)))


# ---------------------------------------------------------------------------- #
# Config 2: the waveform and the music bars

def waveform_frag(sf):
    """Oscilloscope bars (waveform.frag): the waveform sampled at v = 0
    along x, three thresholds on |gluv.y|."""
    from shaderflow_tpu_torch.ops.sampling import sample_separable
    u_line, _ = sf.lines
    row = sample_separable(sf.tex("iWaveform"), u_line,
                           torch.zeros(1, device=sf.device))          # (1, W', C)
    wave = row[0][None, :, 0:2]
    ay = torch.abs(sf.gluv[..., 1])
    r = torch.where(ay < wave[..., 0], 1.0, 0.2)
    g = torch.where(ay < wave[..., 1], 1.0, 0.2)
    b = torch.where(ay < (wave[..., 0] + wave[..., 1]) / 2, 1.0, 0.2)
    return sl.vec4(r, g, b, 1.0)


class Waveform(ShaderScene):
    """Audio Waveform Oscilloscope demo"""
    audio_file = None

    def build(self):
        from shaderflow_tpu_torch.audio import ShaderAudio
        from shaderflow_tpu_torch.audio.waveform import ShaderWaveform
        self.audio = ShaderAudio(scene=self, name="iAudio", file=self.audio_file or MUSIC)
        self.waveform = ShaderWaveform(scene=self, audio=self.audio, smooth=False)
        self.shader.fragment = waveform_frag


def bars_frag(sf):
    """Two-channel frequency bars (bars.frag). The swizzled sample at
    astuv.yx hits a single-column texture (length=0), so the lookup is a 1D
    line over x. The reference's .at[..., k].add updates on zeros are plain
    sums in the same order."""
    from shaderflow_tpu_torch.ops.sampling import sample_separable
    u_line, _ = sf.lines
    line = sample_separable(sf.tex("iSpectrogram"),
                            torch.full((1,), 0.5, device=sf.device), u_line)  # (W', 1, C)
    intensity = torch.sqrt(line[:, 0, 0:2])[None, :, :] * reciprocal(120.0)  # (1, W', 2)
    ay = sf.astuv[..., 1]
    zero = torch.zeros_like(ay)
    r = zero + torch.where(ay < intensity[..., 0], 1.0, 0.0)
    g = zero + torch.where(ay < intensity[..., 1], 1.0, 0.0)
    b = zero + torch.where(ay < (intensity[..., 0] + intensity[..., 1]) / 2, 1.0, 0.0)
    b = b + 0.4 * (intensity[..., 0] + intensity[..., 1]) * (1.0 - ay)
    return sl.vec4(torch.stack([r, g, b], dim=-1), 1.0)


class MusicBars(ShaderScene):
    """Basic music bars"""
    audio_file = None

    def build(self):
        from shaderflow_tpu_torch.audio import ShaderAudio
        from shaderflow_tpu_torch.audio.spectrogram import ShaderSpectrogram
        from shaderflow_tpu_torch.piano import PianoNote
        self.audio = ShaderAudio(scene=self, name="iAudio", file=self.audio_file or MUSIC)
        self.spectrogram = ShaderSpectrogram(scene=self, audio=self.audio, length=0)
        self.spectrogram.from_notes(
            start=PianoNote.from_frequency(20.0),
            end=PianoNote.from_frequency(18000.0),
            piano=True,
        )
        self.shader.fragment = bars_frag


# ---------------------------------------------------------------------------- #
# Config 4: the ray marcher

RAYMARCH_STEPS, RAYMARCH_MAX_DIST, RAYMARCH_MIN_DIST = 100, 100.0, 0.001


def raymarch_frag(sf):
    """Stacked boxes ray marcher (raymarch.frag): RAYMARCH_STEPS fixed,
    masked steps, no host sync and no early exit. The boxes are
    sd_box(point, (0, 0, i), vec3(i - 1)) for i in 2..7, written on the
    point's component planes (the box centers' x and y are 0, so |p - c|
    is |p| there); the scene distance is their union with 2 * MAX_DIST.
    GLSL break semantics: the breaking step's walk is added to `traveled`,
    but the step is not counted (break skips the loop's increment)."""
    cam = sf.camera
    origin = cam.origin
    forward = sl.normalize(cam.target - origin)
    ox, oy, oz = origin[..., 0], origin[..., 1], origin[..., 2]
    fx, fy, fz = forward[..., 0], forward[..., 1], forward[..., 2]

    traveled = torch.zeros_like(ox)
    steps = torch.zeros(ox.shape, dtype=torch.int32, device=ox.device)
    done = torch.zeros(ox.shape, dtype=torch.bool, device=ox.device)
    for _ in range(RAYMARCH_STEPS):
        px, py, pz = ox + fx * traveled, oy + fy * traveled, oz + fz * traveled
        ax, ay = torch.abs(px), torch.abs(py)
        walk = torch.full_like(px, 2 * RAYMARCH_MAX_DIST)
        for i in range(2, 8):
            half = (i - 1) / 2.0
            dx, dy, dz = ax - half, ay - half, torch.abs(pz - float(i)) - half
            inner = torch.clamp(torch.maximum(torch.maximum(dx, dy), dz), max=0.0)
            ex, ey, ez = (torch.clamp(d, min=0.0) for d in (dx, dy, dz))
            walk = torch.minimum(walk, inner + torch.sqrt(ex * ex + ey * ey + ez * ez))
        active = ~done
        traveled = traveled + torch.where(active, walk, 0.0)
        breaking = (walk < RAYMARCH_MIN_DIST) | (walk > RAYMARCH_MAX_DIST)
        steps = steps + (active & ~breaking).to(torch.int32)
        done = done | breaking

    col = 1.0 - torch.sqrt(steps.to(torch.float32)) * 0.1
    return sl.vec4(col, col, col, 1.0)


class RayMarch(ShaderScene):
    """Ray Marching demo"""

    def build(self):
        self.shader.fragment = raymarch_frag


# ---------------------------------------------------------------------------- #
# Conway's Life: a simulation program with a 10-deep temporal ring

def life_simulation_frag(sf):
    """Conway's Game of Life step (life/simulation.glsl): 3x3 neighborhood
    from the previous frame (temporal slot 1), gated to every iLifePeriod
    frames."""
    size = sf.uniform("iLifeSize")
    previous = sf.tex("iLife", 1, 0)
    pixel = (sf.astuv * size).to(torch.int32)

    near = torch.zeros(pixel.shape[:-1], dtype=torch.int32, device=pixel.device)
    current = near
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            offset = torch.stack([pixel[..., 0] + dx, pixel[..., 1] + dy], dim=-1)
            cell = (sf.texel_fetch(previous, offset)[..., 0] > 0.5).to(torch.int32)
            if dx == 0 and dy == 0:
                current = cell
            else:
                near = near + cell

    # Survival: 2-3 neighbors; birth: exactly 3
    alive = torch.where(current == 1, (near == 2) | (near == 3), near == 3)
    stepped = alive.to(torch.float32)

    hold = sf.texture(previous, sf.astuv)[..., 0]
    out = torch.where(torch.remainder(sf.iFrame, sf.uniform("iLifePeriod")) != 0,
                      hold, stepped)
    return out[..., None]


LIFE_COLORS = (sl.PALETTE_MAGMA_1, sl.PALETTE_MAGMA_2, sl.PALETTE_MAGMA_3,
               sl.PALETTE_MAGMA_4)
_LIFE_PALETTES: dict = {}


def life_visuals_frag(sf):
    """Temporal integration of the simulation states (life/visuals.glsl)."""
    cam = sf.camera
    uv = cam.stuv
    if sf.device not in _LIFE_PALETTES:   # the stops uploaded once per device
        _LIFE_PALETTES[sf.device] = [c.to(sf.device) for c in LIFE_COLORS]
    colors = _LIFE_PALETTES[sf.device]

    exponent = 1.3
    area = 1 / (exponent + 1)
    life = sf.stexture(sf.tex("iLife", 0, 0), uv)[..., 0]
    for i, factor in enumerate((0.8, 0.6, 0.4, 0.2), start=1):
        life = life + (sf.stexture(sf.tex("iLife", i, 0), uv)[..., 0]
                       * (factor ** exponent))
    life = life * reciprocal(5 * area)

    rgb = sl.palette(life, *colors)
    rgb = torch.where(cam.out_of_bounds[..., None], colors[0], rgb)
    return sl.vec4(rgb, 1.0)


class Life(ShaderScene):
    """Conway's Game of Life"""

    life_period: int = 6

    def setup(self):
        width, height = 192, 108
        random = np.random.default_rng(0).integers(0, 2, (height, width)).astype(np.float32)
        self.simulation.texture.size = (width, height)
        self.simulation.texture.write(random, temporal=1)

    def build(self):
        self.simulation = ShaderProgram(scene=self, name="iLife")
        self.simulation.texture.temporal = 10
        self.simulation.texture.filter = "nearest"
        self.simulation.texture.dtype = "f4"
        self.simulation.texture.components = 1
        self.simulation.texture.track = False
        self.simulation.fragment = life_simulation_frag
        self.shader.fragment = life_visuals_frag

    def pipeline(self):
        yield from ShaderScene.pipeline(self)
        yield Uniform("int", "iLifePeriod", self.life_period)


SCENES = [Basic, ShaderToy, MultiShader, Multipass, MotionBlur, Dynamics, Waveform,
          MusicBars, Visualizer, RayMarch, Life]

if __name__ == "__main__":
    scene = {cls.__name__: cls for cls in SCENES}[sys.argv[1] if len(sys.argv) > 1
                                                   else "Visualizer"]
    width, height, fps, seconds, ssaa = (
        float(value) for value in (sys.argv[2:7] or (1920, 1080, 60, 2, 2)))
    scene().main(width=int(width), height=int(height), fps=fps, ssaa=ssaa, time=seconds,
                 output="null")
