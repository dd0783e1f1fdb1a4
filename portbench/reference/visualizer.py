"""
Plain reference of the `visualizer` configuration: upstream ShaderFlow's
music visualizer (examples/basic/demo.py, visualizer.frag) in its offline
form, at blur level 1 (the literal 80 taps on the full-resolution
background) with a float32 color chain, rendered in PyTorch and NumPy
from the clip's WAV samples and the background's pixels alone.

Independent of shaderflow_tpu_torch: it imports nothing of it and reads
nothing it made. Every stage is worked out again from the inputs, in the
port's formulas and order, so that it agrees with a sound port to
rounding:
  * the scene clock: frame k at t = k additions of 1/60 (float64); the
    module updates of frame k see the previous frame's dt (0 at frame 0)
  * volume and std: RMS and standard deviation of the last 0.1 s of both
    channels at the frame's sample cursor, smoothed by the second-order
    system (f 2 and 10, zeta 1, float64; a step of dt 0 is none)
  * spectrogram: a Hann-windowed 4096-sample rFFT ending at each frame's
    cursor, |X|^2 through the piano band matrix (115 notes, 20 Hz-14 kHz,
    Gaussian interpolation), smoothed at 1/60 (f 4, zeta 1, float32)
  * waveform: the mean |x| of 735-sample chunks, square-rooted, the last
    180 chunks before the frame's chunk-aligned cursor
  * the bar field: the spectrogram bin under each pixel's radial angle,
    the channel by its half of the screen, rounded to bfloat16
  * the breathing zoom, the background and its radial blur (80 taps
    splatted into one 9 x 9 kernel) sampled bilinearly in bfloat16 as
    rows, then columns; the bars, the fade, the vignette, the waveform
    overlays, the blink; the 2 x 2 box; u8 = floor(clamp(c) * 255 + 0.5)
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi
TAU = 2 * math.pi
FFT_SIZE = 4096
SPACE = (1.0 / 255.0, 11.0 / 255.0, 26.0 / 255.0)


def recip(n: float) -> float:
    return float(np.float32(1.0) / np.float32(n))


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


# --------------------------------------------------------------------------- #
# The second-order smoother (f / zeta / r, semi-implicit Euler, k2 clamp)

def coefficients(frequency: float, zeta: float, response: float, dt: float) -> tuple:
    radians = math.tau * frequency
    k1 = zeta / (math.pi * frequency)
    k2 = 1.0 / (radians * radians)
    k3 = (response * zeta) / (math.tau * frequency)
    if radians * dt < zeta:
        k2 = max(k1 * dt, k2, 0.5 * (k1 + dt) * dt)
    else:
        damping = radians * abs(zeta * zeta - 1.0) ** 0.5
        t1 = math.exp(-zeta * radians * dt)
        a1 = 2.0 * t1 * (math.cos(damping * dt) if zeta <= 1 else math.cosh(damping * dt))
        t2 = dt / (1.0 + t1 * t1 - a1)
        k1 = t2 * (1.0 - t1 * t1)
        k2 = t2 * dt
    return k1, k2, k3


class Smoother:
    """Host float64 smoother of one value, stepped once a frame."""

    def __init__(self, frequency: float):
        self.frequency = frequency
        self.value = self.previous = self.derivative = np.float64(0.0)
        self.target = np.float64(0.0)

    def step(self, dt: float) -> None:
        if not dt:
            return
        if abs(self.target - self.value) < 1e-6:
            return
        k1, k2, k3 = coefficients(self.frequency, 1.0, 0.0, dt)
        velocity = (self.target - self.previous) / dt
        self.previous = np.float64(self.target)
        self.value = self.value + self.derivative * dt
        acceleration = (self.target + k3 * velocity - self.value - k1 * self.derivative) / k2
        self.derivative = self.derivative + acceleration * dt


def levels(samples: np.ndarray, frames: int, fps: float, samplerate: int) -> tuple:
    """Per frame (time float64, volume, std) as the scene's clock and its
    audio module produce them."""
    full = np.ascontiguousarray(samples.T)                     # (C, S)
    volume, std = Smoother(2.0), Smoother(10.0)
    times, volumes, stds = [], [], []
    time, dt = 0.0, 0.0
    for _ in range(frames):
        tell = min(int(round(time * samplerate)), full.shape[1])
        window = full[:, max(0, tell - int(0.1 * samplerate)):tell]
        rms = float(np.sqrt(np.mean(np.square(window)))) if np.size(window) else 0.0
        volume.target = np.float64(2 * rms * (2 ** 0.5))
        std.target = np.float64(float(np.std(window)) if np.size(window) else 0.0)
        volume.step(abs(dt))
        std.step(abs(dt))
        times.append(time)
        volumes.append(volume.value)
        stds.append(std.value)
        dt = 1.0 / fps
        time += dt
    return (np.array(times), np.array(volumes, np.float32), np.array(stds, np.float32))


# --------------------------------------------------------------------------- #
# Spectrogram and waveform sequences

def band_matrix(samplerate: float) -> np.ndarray:
    """(115, 2049) float32: Gaussian band-pass rows at the piano's notes."""
    low, high = 15, 129                       # the notes nearest 20 Hz and 14 kHz
    half = 2 ** (0.5 / 12)
    minimum = 440.0 * 2.0 ** ((low - 69) / 12) / half
    maximum = 440.0 * 2.0 ** ((high - 69) / 12) * half
    centers = 2.0 ** np.linspace(np.log2(minimum), np.log2(maximum), high - low + 1)
    bins = FFT_SIZE // 2 + 1
    df = float(np.fft.rfftfreq(FFT_SIZE, 1 / samplerate)[1])
    end = 1.2
    rows = [np.exp(-((2.0 * (i - np.arange(bins)) / end) ** 2)) / (end * math.sqrt(math.pi))
            for i in centers / df]
    matrix = np.stack(rows)
    matrix[np.abs(matrix) < 1e-5] = 0.0
    return matrix.astype(np.float32)


def spectrogram(audio: torch.Tensor, frames: int, fps: float, samplerate: int) -> torch.Tensor:
    """(F, bins, C) float32 smoothed band energies, row 0 the lowest note."""
    device = audio.device
    ends = np.round(np.arange(frames) * samplerate / fps).astype(np.int32)
    offsets = torch.from_numpy(ends - FFT_SIZE).to(device)
    idx = offsets[:, None].to(torch.int64) + torch.arange(FFT_SIZE, device=device)[None, :]
    valid = (idx >= 0) & (idx < audio.shape[1])
    idx = torch.clamp(idx, 0, audio.shape[1] - 1)
    chunks = torch.where(valid[None], audio[:, idx], 0.0).permute(1, 0, 2)
    window = torch.as_tensor(np.asarray(np.hanning(FFT_SIZE), np.float32), device=device)
    spectrum = torch.fft.rfft(chunks * window[None, None, :], dim=-1)
    power = (spectrum * torch.conj(spectrum)).real
    matrix = torch.as_tensor(band_matrix(samplerate), device=device)
    banded = torch.matmul(power.to(torch.float32), matrix.T)          # (F, C, bins)
    flat = banded.reshape(frames, -1)
    dt = 1.0 / fps
    k1, k2, k3 = coefficients(4.0, 1.0, 0.0, dt)
    value = torch.zeros(flat.shape[1], dtype=torch.float32, device=device)
    previous, derivative = value, torch.zeros_like(value)
    smoothed = torch.empty_like(flat)
    for index in range(frames):
        target = flat[index]
        velocity = (target - previous) / dt
        value = value + derivative * dt
        acceleration = (target + k3 * velocity - value - k1 * derivative) / k2
        derivative = derivative + acceleration * dt
        previous = target
        smoothed[index] = value
    return smoothed.reshape(banded.shape).permute(0, 2, 1)


def waveform(audio: torch.Tensor, frames: int, fps: float, samplerate: int,
             points: int = 180, seconds: float = 3.0) -> torch.Tensor:
    """(F, points, C) float32 oscilloscope bars."""
    device = audio.device
    chunk = max(1, int(seconds * samplerate / points))
    tells = np.round(np.arange(frames) * samplerate / fps).astype(np.int64)
    ends = torch.from_numpy(tells - (tells % chunk)).to(device)
    channels, samples = audio.shape
    count = max(1, samples // chunk)
    if samples < count * chunk:
        audio = torch.nn.functional.pad(audio, (0, count * chunk - samples))
    reduced = torch.sqrt(torch.mean(torch.abs(
        audio[:, :count * chunk].reshape(channels, count, chunk)), dim=-1))
    idx = torch.div(ends, chunk, rounding_mode="floor")[:, None] - points + torch.arange(
        points, device=device)[None, :]
    valid = (idx >= 0) & (idx < count)
    gathered = torch.where(valid[None], reduced[:, torch.clamp(idx, 0, count - 1)], 0.0)
    return gathered.permute(1, 2, 0)


# --------------------------------------------------------------------------- #
# One frame

def atan2(y, x):
    """The scene's polynomial atan2 (max error about 1e-5 rad)."""
    ax, ay = torch.abs(x), torch.abs(y)
    hi, lo = torch.maximum(ax, ay), torch.minimum(ax, ay)
    t = torch.where((hi == lo) & (hi > 0.0), 1.0, lo / torch.clamp(hi, min=1e-30))
    s = t * t
    r = t * (0.99997726 + s * (-0.33262347 + s * (0.19354346
             + s * (-0.11643287 + s * (0.05265332 + s * -0.01172120)))))
    r = torch.where(ay > ax, float(math.pi / 2) - r, r)
    r = torch.where(x < 0.0, float(math.pi) - r, r)
    return torch.where(y < 0.0, -r, r)


def sstep(x):
    t = torch.clamp(x, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def axis(count: int, device) -> torch.Tensor:
    return (torch.arange(count, dtype=torch.float32, device=device) + 0.5) * recip(count)


class Static:
    """The frame-invariant fields of one render size."""

    def __init__(self, height: int, width: int, aspect: float, device):
        # The screen's lines as the batch preludes make them
        px = (axis(width, device) * 2.0 - 1.0) * aspect
        py = 1.0 - axis(height, device) * 2.0
        self.circle = torch.abs(atan2(px[None, :], -py[:, None]) * recip(PI))
        self.left = px[None, :] < 0
        t = torch.clamp(self.circle / 2.0, 0.0, 1.0)
        self.fscale = 0.05 + 3.0 * (t * t * (3.0 - 2.0 * t))
        self.rad0 = torch.sqrt(px[None, :] ** 2 + py[:, None] ** 2)
        ax, ay = axis(width, device) * 2.0 - 1.0, 1.0 - axis(height, device) * 2.0
        t6 = torch.clamp(torch.sqrt(ax[None, :] ** 2 + ay[:, None] ** 2) - 0.3, 0.0, 1.0) ** 2
        self.blink = bf16(t6 * t6 * t6)
        sx, sy = axis(width, device), 1.0 - axis(height, device)
        vig = (sx * (1.0 - sx))[None, :] * (sy * (1.0 - sy))[:, None]
        self.lvig = torch.log(torch.clamp(vig * 20.0, min=1e-6))
        # The camera's lines (the trivial 2D camera: the screen itself)
        self.u_line = axis(width, device)
        self.v_line = 1.0 - axis(height, device)
        self.gx = (self.u_line * 2.0 - 1.0) * aspect
        self.gy = self.v_line * 2.0 - 1.0
        self.oob = (torch.abs(self.gx) > float(np.float32(aspect)))[None, :]
        row = torch.arange(height, dtype=torch.float32, device=device)[:, None]
        self.gluv_y = (1.0 - (row + 0.5) * recip(height)) * 2.0 - 1.0


def bar_plane(table: torch.Tensor, static: Static) -> torch.Tensor:
    """(bins, C) table -> (H, W): the bin under the radial angle, rounded
    to bfloat16."""
    bins, channels = table.shape
    rows = torch.clamp(torch.floor((1.0 - static.circle) * bins).to(torch.int64), 0, bins - 1)
    lane = torch.where(torch.broadcast_to(static.left, rows.shape), 0, 1)
    return bf16(table.flip(0).reshape(-1)[rows * channels + lane])


def row_planes(image: torch.Tensor, v_line: torch.Tensor) -> list:
    """(H, W, C) image sampled at rows v_line, bilinearly with clamped
    positions, weights and texels in bfloat16 -> C planes (len(v), W) bf16."""
    height = image.shape[0]
    position = torch.clamp((1.0 - v_line) * height - 0.5, 0.0, float(height - 1))
    x0 = torch.floor(position)
    w0 = bf16(torch.clamp(1.0 - torch.abs(position - x0), min=0.0))[:, None]
    w1 = bf16(torch.clamp(1.0 - torch.abs(position - (x0 + 1.0)), min=0.0))[:, None]
    i0 = x0.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=height - 1)
    data = bf16(image)
    return [(data[i0, :, c] * w0 + data[i1, :, c] * w1).to(torch.bfloat16)
            for c in range(image.shape[2])]


def col_sample(planes: list, u_line: torch.Tensor) -> list:
    """bf16 (H, W_in) planes at columns u_line -> float32 (H, Wr) planes."""
    w_in = planes[0].shape[1]
    position = torch.clamp(u_line * w_in - 0.5, 0.0, float(w_in - 1))
    x0 = torch.floor(position)
    w0 = bf16(torch.clamp(1.0 - torch.abs(position - x0), min=0.0))
    w1 = bf16(torch.clamp(1.0 - torch.abs(position - (x0 + 1.0)), min=0.0))
    i0 = x0.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=w_in - 1)
    return [plane[:, i0].to(torch.float32) * w0 + plane[:, i1].to(torch.float32) * w1
            for plane in planes]


def wave_cols(bars: torch.Tensor, u_line: torch.Tensor) -> torch.Tensor:
    """(points, C) bars sampled linearly (clamped) at u_line -> (Wr, C)."""
    points = bars.shape[0]
    texels = torch.arange(points, dtype=torch.float32, device=bars.device)
    position = torch.clamp(u_line * points - 0.5, 0.0, float(points - 1))
    weights = torch.clamp(1.0 - torch.abs(position[:, None] - texels), min=0.0)
    rows = torch.einsum("oh,hwc->owc", torch.ones(1, 1, device=bars.device), bars[None])
    return torch.einsum("pw,owc->opc", weights, rows)[0]


def blur_kernel(volume: torch.Tensor, height: int) -> torch.Tensor:
    """The 80-tap radial blur (8 directions x 10 walks) as one 9 x 9 kernel
    of bilinear splats, in texels of the full-resolution background."""
    device = volume.device
    intensity = 0.01 * torch.clamp(torch.pow(torch.clamp(volume, min=0.0), 2.5), 0.0, 0.3)
    taps = [(math.cos(TAU * d / 8) * (s / 10), math.sin(TAU * d / 8) * (s / 10))
            for d in range(8) for s in range(1, 11)]
    offsets = torch.tensor(taps, dtype=torch.float32, device=device) * intensity
    offsets = offsets * torch.tensor([height, -height], dtype=torch.float32, device=device)
    grid = torch.arange(-4, 5, dtype=torch.float32, device=device)
    hat_x = torch.clamp(1.0 - torch.abs(grid[None, :] - offsets[:, 0:1]), min=0.0)
    hat_y = torch.clamp(1.0 - torch.abs(grid[None, :] - offsets[:, 1:2]), min=0.0)
    return torch.einsum("ny,nx->yx", hat_y, hat_x)


def convolve(image: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    weight = kernel.expand(image.shape[2], 1, *kernel.shape).contiguous()
    out = torch.nn.functional.conv2d(image.permute(2, 0, 1)[None], weight,
                                     padding=(kernel.shape[0] // 2, kernel.shape[1] // 2),
                                     groups=image.shape[2])
    return out[0].permute(1, 2, 0)


def frame_planes(time: float, volume: float, std: float, table: torch.Tensor,
                 bars: torch.Tensor, image: torch.Tensor, static: Static) -> list:
    """The three float32 color planes of one frame at the render size."""
    device = image.device
    itime = torch.tensor(time, dtype=torch.float32, device=device)
    vol = torch.tensor(volume, dtype=torch.float32, device=device)
    std = torch.tensor(std, dtype=torch.float32, device=device)
    render_h, render_w = static.circle.shape
    tex_h, tex_w = image.shape[:2]

    z = 0.95 + 0.01 * torch.sin(itime) - 0.02 * vol - 0.03
    qx = ((static.gx + 1.0) / 2.0 - 0.5) * z * z + 0.5 + 0.005 * torch.cos(itime * 3.25135)
    qy = ((static.gy + 1.0) / 2.0 - 0.5) * z * z + 0.5 + 0.005 * torch.sin(itime * 1.153469)
    u_line = ((2.0 * qx - 1.0) * (tex_h / tex_w) + 1.0) / 2.0
    base = col_sample(row_planes(image, qy), u_line)
    blurred = convolve(image, blur_kernel(vol, tex_h))
    blur = col_sample(row_planes(blurred, qy), u_line)
    wave = 0.2 * wave_cols(bars, static.u_line)
    bar = bar_plane(table, static).to(torch.float32)
    return tail(vol, std, base, blur, bar, wave[:, 0][None, :], wave[:, 1][None, :], static)


def tail(vol, std, base, blur, bar, wave0, wave1, static: Static) -> list:
    """The per-pixel color formula after the samples (float32)."""
    rgb = [(b + r) * (1.0 / 80) for b, r in zip(base, blur)]
    blink = 1.0 + 5.0 * std * static.blink
    rgb = [c * blink for c in rgb]
    scale = 1.0 - 0.4 * torch.sqrt(torch.abs(vol))
    radius = 0.17
    r = static.rad0 * scale
    bar = torch.sqrt(bar * recip(1000.0)) * static.fscale
    ring = radius + 0.5 * bar
    inside = r < radius
    on_bar = r < ring
    smix = sstep(0.5 + bar)
    fall = torch.exp(0.05 * torch.log(torch.clamp((r - ring) * 0.5, min=1e-6)))
    rgb = [torch.where(inside, c * 0.5, torch.where(on_bar, c + (1.0 - c) * smix, c * fall))
           for c in rgb]
    dmix = sstep(static.rad0 * recip(20.0))
    rgb = [c + (s - c) * dmix for c, s in zip(rgb, SPACE)]
    vpow = torch.exp((0.1 + 0.15 * vol) * static.lvig)
    rgb = [c * vpow for c in rgb]
    gy = static.gluv_y
    dark = torch.where(1.0 - gy < wave0, 0.8, 1.0) * torch.where(1.0 + gy < wave1, 0.8, 1.0)
    rgb = [c * dark for c in rgb]
    return [torch.where(static.oob, s, c) for c, s in zip(rgb, SPACE)]


def pool(rgb: list, subsample: int) -> torch.Tensor:
    """2 x 2 box of the render -> (H, W, 3) u8."""
    height, width = rgb[0].shape
    out = [torch.broadcast_to(c, (height, width)).reshape(
        height // subsample, subsample, width // subsample, subsample).sum(dim=(1, 3))
        / float(subsample * subsample) for c in rgb]
    return torch.floor(torch.clamp(torch.stack(out, -1), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


# --------------------------------------------------------------------------- #
# What the harness calls

def check(config: dict) -> None:
    """The configuration's env is the one source of the port's options:
    this reference renders blur level 1 with the float32 tail."""
    env = config.get("env", {})
    if env.get("SHADERFLOW_VIZ_BLUR_LEVEL") != "1" or env.get("SHADERFLOW_TAIL_BF16", "0") != "0":
        raise ValueError("the visualizer reference renders blur level 1 and the float32 "
                         "tail only")


def clip_state(samples: np.ndarray, config: dict, traffic: dict, device) -> dict:
    fps = float(config["fps"])
    frames = int(round(traffic["clip_seconds"] * fps))
    rate = int(config["inputs"]["audio"]["samplerate"])
    audio = torch.from_numpy(np.ascontiguousarray(samples.T, np.float32)).to(device)
    times, volumes, stds = levels(samples, frames, fps, rate)
    return {"times": times, "volumes": volumes, "stds": stds,
            "spectrogram": spectrogram(audio, frames, fps, rate),
            "waveform": waveform(audio, frames, fps, rate)}


def render(config: dict, traffic: dict, inputs: dict, requests: list, device) -> dict:
    """{(job, frame): (H, W, 3) u8 numpy} for requests [(job, clip, frame)]."""
    check(config)
    width, height = int(traffic["width"]), int(traffic["height"])
    ssaa = int(traffic["ssaa"])
    out = {}
    with torch.no_grad():
        image = torch.from_numpy(inputs["background.data"][0].astype(np.float32) / 255.0).to(device)
        static = Static(height * ssaa, width * ssaa, width / height, device)
        for clip in sorted({clip for _, clip, _ in requests}):
            state = clip_state(inputs["audio.data"][clip], config, traffic, device)
            for job, _, index in (r for r in requests if r[1] == clip):
                planes = frame_planes(float(state["times"][index]), float(state["volumes"][index]),
                                      float(state["stds"][index]), state["spectrogram"][index],
                                      state["waveform"][index], image, static)
                out[(job, index)] = pool(planes, ssaa).cpu().numpy()
    return out


def work(config: dict, traffic: dict, inputs: dict, device) -> dict:
    """What the roofline readers count for one frame. The tail: its inputs
    read once (the base and blur rows, three bf16 planes each at the render
    height and the background's width; the bar field bf16; the static
    fields fscale, rad0, lvig f32 and blink bf16; three columns) and the u8
    frame written once; the operations the color formula needs, counted
    on the render's geometry at a sixteenth of its size, with samples and
    bars drawn at random. The bar field's prelude: the batch's tables read
    (bf16) and its field written (bf16), a frame's share."""
    from portbench.harness.counting import count_elementwise
    width, height = int(traffic["width"]), int(traffic["height"])
    ssaa = int(traffic["ssaa"])
    render_h, render_w = height * ssaa, width * ssaa
    tex_w = int(config["inputs"]["background"]["width"])
    pixels = render_h * render_w
    rows, cols = render_h // 16, render_w // 16
    static = Static(rows, cols, width / height, "cpu")
    generator = torch.Generator().manual_seed(0)
    planes = [torch.rand(rows, cols, generator=generator) for _ in range(3)]
    scalar = torch.tensor(0.5)
    line = torch.rand(1, cols, generator=generator)
    _, ops = count_elementwise(tail, scalar, scalar, planes, planes,
                               torch.rand(rows, cols, generator=generator), line, line, static)
    bins, channels = 115, 2
    return {
        "tail_ops": ops / (rows * cols) * pixels,
        "tail_bytes": (2 * 3 * render_h * tex_w * 2 + pixels * (2 + 4 + 4 + 4 + 2)
                       + 3 * render_w * 4 + width * height * 3),
        "barfield_bytes": bins * channels * 2 + pixels * 2,
    }
