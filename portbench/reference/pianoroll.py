"""
Plain reference of the `pianoroll` configuration: upstream ShaderFlow's
MIDI piano roll (examples/basic/piano_roll.py with ShaderPiano) in its
offline form at ssaa 1 and subsample 2, with a float32 color chain,
rendered in PyTorch and NumPy from the clip's MIDI bytes and WAV samples
alone.

Independent of shaderflow_tpu_torch: it imports nothing of it and reads
nothing it made. Every stage is worked out again from the inputs, in the
port's formulas and order, so that it agrees with a sound port to
rounding:
  * the SMF parse: type 0 or 1, running status, meta and sysex events, a
    note-on of velocity 0 as a note-off; the tempo map sorted by tick
    alone, so that a file's tempo at tick 0 replaces the default of 120
    bpm; each track's notes listed as they end, then sorted by (start,
    pitch), keeping that order between equal keys
  * the note scan, for every frame f at t = f / 60: per key, the notes
    whose whole seconds overlap those of [t, t + 4 s] and that start by
    t + 4 s, met second by second (upstream's buckets of a note under
    each second it spans), so that a note that ended earlier in the
    second is met too; the first 256 that start before t + 2 s fill the
    key's 256 roll slots, in that order; a note under t sets the key's
    channel, and its velocity where it does not end within 0.03 s (or
    lasts under 0.03 s); the keys met give the note range's target
  * the key-press smoother (f 4, zeta 0.4) and the note-range smoother
    (f 0.5 / 4 s, zeta 1/sqrt(2); it starts at the whole file's range),
    second-order systems stepped in float64 at dt 1/60, frame 0 with no
    step, a step skipped where the range is within 1e-6 of its target
  * the piano-band spectrogram: a Hann-windowed 4096-sample rFFT ending
    at each frame's sample, |X|^2 through Gaussian bands at the notes
    15-123 (20 Hz-10 kHz), smoothed at 1/60 (f 4, zeta 1, float32)
  * the 54 column lines of a frame: the key under each column of the
    note range (a range 6 keys wider on each side), the texels of the
    three per-frame textures there (zero outside the 128 keys), the
    keyboard's colour, the key's edge, eight slots of start, end,
    brightness and channel colour, the glow (the spectrogram sampled
    linearly at the column) and the octave mark
  * the piano tail in float32, the three planes rounded to bfloat16
  * the separable [1/8, 3/4, 1/8] stencil with edge replication, rows
    then columns, every product and sum rounded to bfloat16 but the last
    sum in float32; u8 = floor(clamp(c) * 255 + 0.5)

Departures from upstream, which are the port's too: the fragment reads
eight of a key's 256 slots (upstream's shader loops over all of them);
no FluidSynth is heard offline; upstream's GL texture filtering and the
spectrogram's texture layout are those of the port (a one-column
texture, its rows the bins, the highest at the top).
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

MAX_NOTE, MAX_ROLLING, SLOTS = 128, 256, 8
ROLL_TIME, LOOKAHEAD, HEIGHT, EXTRA_KEYS, RELEASE = 2.0, 2.0, 0.275, 6.0, 0.03
LOOKUP = ROLL_TIME + LOOKAHEAD
FFT_SIZE = 4096
# The spectrogram's notes: the nearest to 20 Hz and to 10 kHz
LOW_NOTE, HIGH_NOTE = 15, 123
COLORS = ((0.95, 0.45, 0.25), (0.30, 0.70, 0.95), (0.55, 0.90, 0.45),
          (0.90, 0.80, 0.30), (0.80, 0.40, 0.90), (0.40, 0.90, 0.80))
# The tail's compute dtype: the configuration's float32 (a lower one only
# for the precision control of PERF.md §2)
TAIL_DTYPE = torch.float32


def recip(n: float) -> float:
    """1 / n rounded once to float32: a division by a constant is a product
    with this value."""
    return float(np.float32(1.0) / np.float32(n))


# --------------------------------------------------------------------------- #
# Standard MIDI File

def _varlen(data: bytes, pos: int) -> tuple:
    value = 0
    while True:
        byte = data[pos]
        pos += 1
        value = (value << 7) | (byte & 0x7F)
        if not byte & 0x80:
            return value, pos


def _events(track: bytes):
    """(delta ticks, status, data bytes) of one track chunk; 0xFF00 | type
    for a meta event."""
    pos, status = 0, 0
    while pos < len(track):
        delta, pos = _varlen(track, pos)
        if track[pos] & 0x80:
            status = track[pos]
            pos += 1
        if status == 0xFF:
            kind = track[pos]
            length, pos = _varlen(track, pos + 1)
            yield delta, 0xFF00 | kind, track[pos:pos + length]
            pos += length
        elif status in (0xF0, 0xF7):
            length, pos = _varlen(track, pos)
            pos += length
        else:
            size = 1 if status & 0xF0 in (0xC0, 0xD0) else 2
            yield delta, status, track[pos:pos + size]
            pos += size


def parse_smf(data: bytes) -> list:
    """[(pitch, start s, end s, channel, velocity)] in the order a reader
    lists them (see the module note)."""
    if data[:4] != b"MThd":
        raise ValueError("not a Standard MIDI File")
    length, _, count, division = struct.unpack(">IHHH", data[4:14])
    tracks, pos = [], 8 + length
    while pos + 8 <= len(data) and len(tracks) < count:
        (size,) = struct.unpack(">I", data[pos + 4:pos + 8])
        if data[pos:pos + 4] == b"MTrk":
            tracks.append(data[pos + 8:pos + 8 + size])
        pos += 8 + size
    if division & 0x8000:
        per_tick = 1.0 / ((256 - (division >> 8)) * (division & 0xFF))

        def seconds(tick: int) -> float:
            return tick * per_tick
    else:
        ppqn = max(1, division)
        tempi = [(0, 500000)]
        for track in tracks:
            tick = 0
            for delta, status, payload in _events(track):
                tick += delta
                if status == 0xFF51 and len(payload) == 3:
                    tempi.append((tick, int.from_bytes(payload, "big")))
        tempi.sort(key=lambda item: item[0])
        anchors, total, last_tick, last_tempo = [], 0.0, 0, 500000
        for tick, tempo in tempi:
            total += (tick - last_tick) * last_tempo / (ppqn * 1e6)
            anchors.append((tick, total, tempo))
            last_tick, last_tempo = tick, tempo

        def seconds(tick: int) -> float:
            base = anchors[0]
            for anchor in anchors:
                if anchor[0] > tick:
                    break
                base = anchor
            return base[1] + (tick - base[0]) * base[2] / (ppqn * 1e6)
    notes = []
    for track in tracks:
        tick, sounding = 0, {}
        for delta, status, payload in _events(track):
            tick += delta
            kind, channel = status & 0xF0, status & 0x0F
            if status > 0xFF:
                continue
            if kind == 0x90 and payload[1] > 0:
                sounding[(channel, payload[0])] = (tick, payload[1])
            elif kind == 0x80 or kind == 0x90:
                begun = sounding.pop((channel, payload[0]), None)
                if begun is not None:
                    notes.append((payload[0], seconds(begun[0]), seconds(tick), channel,
                                  begun[1]))
    return sorted(notes, key=lambda note: (note[1], note[0]))


# --------------------------------------------------------------------------- #
# The note scan

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
    """A float64 second-order system of a vector, stepped once a frame."""

    def __init__(self, frequency: float, zeta: float, size: int, precision: float):
        self.frequency, self.zeta, self.precision = frequency, zeta, precision
        self.value = np.zeros(size)
        self.previous = np.zeros(size)
        self.derivative = np.zeros(size)

    def step(self, target: np.ndarray, dt: float) -> None:
        if not dt or np.abs(target - self.value).max() < self.precision:
            return
        k1, k2, k3 = coefficients(self.frequency, self.zeta, 0.0, dt)
        velocity = (target - self.previous) / dt
        self.previous = target.copy()
        self.value = self.value + self.derivative * dt
        acceleration = (target + k3 * velocity - self.value - k1 * self.derivative) / k2
        self.derivative = self.derivative + acceleration * dt


class Scan:
    """The whole clip's scan: per frame the smoothed key velocities and
    note range and the keys' channels, the count of roll slots filled,
    and a frame's first SLOTS roll slots on request."""

    def __init__(self, notes: list, frames: int, fps: float):
        self.pitch = np.array([n[0] for n in notes], np.int64)
        self.start = np.array([n[1] for n in notes], np.float64)
        self.end = np.array([n[2] for n in notes], np.float64)
        self.channel = np.array([n[3] for n in notes], np.int64)
        self.velocity = np.array([n[4] for n in notes], np.int64)
        self.first_second = np.floor(self.start).astype(np.int64)
        self.last_second = np.floor(self.end).astype(np.int64)
        self.fps = fps
        low, high = int(self.pitch.min()), int(self.pitch.max())
        self.keys = np.empty((frames, MAX_NOTE), np.float32)
        self.channels = np.empty((frames, MAX_NOTE), np.float32)
        self.ranges = np.empty((frames, 2), np.float32)
        self.slots_filled = 0
        dt = 1.0 / fps
        press = Smoother(4.0, 0.4, MAX_NOTE, 0.0)
        span = Smoother(0.5 / LOOKUP, 1 / (2 ** 0.5), 2, 1e-6)
        for f in range(frames):
            t = f / fps
            met = self.met(t)
            shown = met & (self.start < t + ROLL_TIME)
            self.slots_filled += int(np.minimum(
                np.bincount(self.pitch[shown], minlength=MAX_NOTE), MAX_ROLLING).sum())
            target = np.zeros(MAX_NOTE)
            channels = np.full(MAX_NOTE, -1.0, np.float32)
            # Notes under t were all met in t's own second, in file order
            for index in np.nonzero(met & (self.start <= t) & (t <= self.end))[0]:
                if t < self.end[index] - RELEASE or self.end[index] - self.start[index] < RELEASE:
                    target[self.pitch[index]] = self.velocity[index]
                channels[self.pitch[index]] = self.channel[index]
            if span.value.sum() == 0:
                span.value[:] = (low, high)
            keys = self.pitch[met]
            goal = np.array((keys.min() if keys.size else low,
                             keys.max() if keys.size else high), np.float32).astype(np.float64)
            span.step(goal, dt if f else 0.0)
            press.step(target, dt if f else 0.0)
            self.keys[f] = press.value
            self.channels[f] = channels
            self.ranges[f] = span.value

    def met(self, t: float) -> np.ndarray:
        """The notes the scan meets at time t."""
        return (self.last_second >= int(t)) & (self.start <= t + LOOKUP)

    def slots(self, f: int) -> np.ndarray:
        """(128, SLOTS, 4) float32: a frame's first roll slots of every key
        (start, end, channel, velocity; zeros where unfilled)."""
        t = f / self.fps
        out = np.zeros((MAX_NOTE, SLOTS, 4), np.float32)
        shown = np.nonzero(self.met(t) & (self.start < t + ROLL_TIME))[0]
        # Met second by second: a note first in the later of its first
        # second and t's, then in file order
        order = shown[np.lexsort((shown, np.maximum(self.first_second[shown], int(t))))]
        filled = np.zeros(MAX_NOTE, np.int64)
        for index in order:
            key = self.pitch[index]
            if filled[key] < SLOTS:
                out[key, filled[key]] = (self.start[index], self.end[index],
                                         self.channel[index], self.velocity[index])
                filled[key] += 1
        return out


# --------------------------------------------------------------------------- #
# The spectrogram

def band_matrix(samplerate: float) -> np.ndarray:
    """(bins, 2049) float32: Gaussian band-pass rows at the notes
    LOW_NOTE..HIGH_NOTE, the band edges half a semitone outside them."""
    half = 2 ** (0.5 / 12)
    minimum = 440.0 * 2.0 ** ((LOW_NOTE - 69) / 12) / half
    maximum = 440.0 * 2.0 ** ((HIGH_NOTE - 69) / 12) * half
    centers = 2.0 ** np.linspace(np.log2(minimum), np.log2(maximum), HIGH_NOTE - LOW_NOTE + 1)
    bins = FFT_SIZE // 2 + 1
    df = float(np.fft.rfftfreq(FFT_SIZE, 1 / samplerate)[1])
    end = 1.2
    rows = [np.exp(-((2.0 * (i - np.arange(bins)) / end) ** 2)) / (end * math.sqrt(math.pi))
            for i in centers / df]
    matrix = np.stack(rows)
    matrix[np.abs(matrix) < 1e-5] = 0.0
    return matrix.astype(np.float32)


def spectrogram(audio: torch.Tensor, frames: int, fps: float, samplerate: int) -> torch.Tensor:
    """(F, bins, 1, C) float32 smoothed band energies, row 0 the highest
    note: the texture's storage order and layout."""
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
    return smoothed.reshape(banded.shape).permute(0, 2, 1).flip(1)[:, :, None, :].contiguous()


def glow_line(table: torch.Tensor, ax: torch.Tensor) -> torch.Tensor:
    """(W,) glow: the (bins, 1, C) table (highest bin first) sampled
    linearly with clamped edges at each column's position, the channels
    summed, sqrt(max(., 0) / 1000)."""
    bins = table.shape[0]
    texels = torch.arange(bins, dtype=torch.float32, device=ax.device)
    position = torch.clamp((1.0 - ax) * bins - 0.5, 0.0, float(bins - 1))
    weights = torch.clamp(1.0 - torch.abs(position[:, None] - texels), min=0.0)
    rows = torch.einsum("oh,hwc->owc", weights, table)
    spec = torch.einsum("pw,owc->opc", torch.ones(1, 1, device=ax.device), rows)
    return torch.sqrt(torch.clamp(spec[:, 0, 0] + spec[:, 0, 1], min=0.0) * recip(1000.0))


# --------------------------------------------------------------------------- #
# One frame

def smoothstep(edge0: float, edge1: float, x: torch.Tensor) -> torch.Tensor:
    """GLSL smoothstep with constant edges: the division a product with the
    float32 reciprocal."""
    t = torch.clamp((x - edge0) * recip(edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def sstep(edge0, edge1, x):
    """The tail's smoothstep, its edges values of the frame."""
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def fetch(table: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """table[key] where 0 <= key < 128, else 0 (along the first axis)."""
    inside = (key >= 0) & (key < MAX_NOTE)
    values = table[torch.clamp(key, 0, MAX_NOTE - 1).to(torch.int64)]
    mask = inside.reshape(inside.shape + (1,) * (values.ndim - inside.ndim))
    return torch.where(mask, values, 0.0)


def columns(keys: torch.Tensor, channels: torch.Tensor, slots: torch.Tensor,
            note_range: torch.Tensor, table: torch.Tensor, width: int) -> dict:
    """The frame's column lines, each (1, W) float32: keys, channels (128,),
    slots (128, SLOTS, 4), note_range (2,), table (bins, 1, C)."""
    device = keys.device
    palette = torch.tensor(COLORS, dtype=torch.float32, device=device)
    extra = torch.tensor(EXTRA_KEYS, dtype=torch.float32, device=device)
    low = note_range[0] - extra
    span = note_range[1] + extra - low + 1.0
    ax = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) * recip(width)
    key_f = low + ax * span
    key = torch.floor(key_f).to(torch.int32)
    frac = key_f - key
    black = torch.remainder(key, 12)
    black = (black == 1) | (black == 3) | (black == 6) | (black == 8) | (black == 10)

    def colors(values):
        return palette[torch.clamp(values.to(torch.int32), 0, len(COLORS) - 1).to(torch.int64)]

    pressed = torch.clamp(fetch(keys, key) / 128.0, 0.0, 1.0)
    white = torch.where(black[:, None], 0.12, 0.92)
    border = smoothstep(0.0, 0.08, frac) * smoothstep(1.0, 0.92, frac)
    keyboard = white * border[:, None]
    keyboard = keyboard + (colors(fetch(channels, key)) - keyboard) * (pressed[:, None] * 0.85)
    edge = smoothstep(0.02, 0.12, frac) * smoothstep(0.98, 0.88, frac)
    data = fetch(slots, key).permute(2, 1, 0)                 # (4, SLOTS, W)
    start, end, channel, velocity = data
    color = colors(channel).permute(2, 0, 1)                   # (3, SLOTS, W)
    bright = torch.where(velocity > 0, 0.55 + 0.45 * torch.clamp(velocity / 128.0, 0.0, 1.0),
                         0.0)
    lines = {"edge": edge, "glow": glow_line(table, ax),
             "isc": ((torch.remainder(key, 12) == 0) & (frac < 0.06)).to(torch.float32)}
    for c in range(3):
        lines[f"kb{c}"] = keyboard[:, c]
    for slot in range(SLOTS):
        lines.update({f"s{slot}a": start[slot], f"s{slot}b": end[slot],
                      f"s{slot}v": bright[slot], f"s{slot}r": color[0, slot],
                      f"s{slot}g": color[1, slot], f"s{slot}c": color[2, slot]})
    return {name: line[None, :] for name, line in lines.items()}


def tail(cols: dict, ay: torch.Tensor, time, kbh, rolltime) -> list:
    """The per-pixel color formula (float32): the column lines, the row
    coordinate ay (H, 1) and three 0-d values -> three clamped planes."""
    t_row = time + (ay - kbh) / (1.0 - kbh) * rolltime
    ramp = 0.02 * rolltime
    note = [torch.zeros_like(ay), torch.zeros_like(ay), torch.zeros_like(ay)]
    hit = torch.zeros_like(ay)
    for slot in range(SLOTS):
        start, end, bright = cols[f"s{slot}a"], cols[f"s{slot}b"], cols[f"s{slot}v"]
        active = (bright > 0.0) & (start <= t_row) & (t_row <= end)
        body = cols["edge"] * sstep(0.0, ramp, t_row - start) * sstep(0.0, ramp, end - t_row)
        contrib = torch.where(active, body * bright, 0.0)
        note[0] = note[0] + cols[f"s{slot}r"] * contrib
        note[1] = note[1] + cols[f"s{slot}g"] * contrib
        note[2] = note[2] + cols[f"s{slot}c"] * contrib
        hit = torch.maximum(hit, torch.where(active, body, 0.0))
    glow = cols["glow"] * (1.0 - ay) * 0.5
    background = [0.02 + 0.05 * (1.0 - ay) + 0.10 * glow,
                  0.03 + 0.07 * (1.0 - ay) + 0.05 * glow,
                  0.05 + 0.12 * (1.0 - ay) + 0.20 * glow]
    octave = cols["isc"] * 0.03
    background = [b + octave for b in background]
    felt = sstep(kbh - 0.012, kbh - 0.008, ay) * sstep(kbh, kbh - 0.004, ay)
    out = []
    for c, felt_color in enumerate((0.8, 0.1, 0.15)):
        roll = torch.where(hit > 0.0, note[c] + background[c] * 0.3, background[c] + note[c])
        board = cols[f"kb{c}"] * (1.0 - felt) + felt_color * felt
        out.append(torch.clamp(torch.where(ay < kbh, board, roll), 0.0, 1.0))
    return out


def stencil(planes: torch.Tensor) -> torch.Tensor:
    """(3, H, W) bfloat16 -> (H, W, 3) u8: the [m, 1 - 2m, m] stencil (m =
    1/8, subsample 2) with edge replication, rows then columns, each
    product and sum in bfloat16 but the last sum in float32; the quantize."""
    m, center = 0.125, 0.75
    up = torch.cat([planes[:, :1], planes[:, :-1]], dim=1)
    down = torch.cat([planes[:, 1:], planes[:, -1:]], dim=1)
    rows = center * planes + m * (up + down)
    left = torch.cat([rows[..., :1], rows[..., :-1]], dim=2)
    right = torch.cat([rows[..., 1:], rows[..., -1:]], dim=2)
    mixed = (center * rows).to(torch.float32) + (m * (left + right)).to(torch.float32)
    return torch.floor(torch.clamp(mixed, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).permute(1, 2, 0)


def frame_planes(scan: Scan, table: torch.Tensor, f: int, time: float, height: int,
                 width: int, device) -> torch.Tensor:
    """(3, H, W) bfloat16: frame f's tail at iTime `time`."""
    cols = columns(torch.from_numpy(scan.keys[f]).to(device),
                   torch.from_numpy(scan.channels[f]).to(device),
                   torch.from_numpy(scan.slots(f)).to(device),
                   torch.from_numpy(scan.ranges[f]).to(device), table, width)
    rows = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    ay = 1.0 - (rows + 0.5) * recip(height)

    def scalar(value):
        return torch.tensor(value, dtype=torch.float32, device=device).to(TAIL_DTYPE)

    cols = {name: line.to(TAIL_DTYPE) for name, line in cols.items()}
    planes = tail(cols, ay.to(TAIL_DTYPE), scalar(time), scalar(HEIGHT), scalar(ROLL_TIME))
    return torch.stack([torch.broadcast_to(p, (height, width)) for p in planes]).to(
        torch.bfloat16)


# --------------------------------------------------------------------------- #
# What the harness calls

def check(config: dict) -> None:
    """The configuration's env is the one source of the port's options:
    this reference renders the float32 tail at subsample 2."""
    if config.get("env", {}).get("SHADERFLOW_TAIL_BF16", "0") != "0" or \
            int(config["subsample"]) != 2:
        raise ValueError("the piano-roll reference renders the float32 tail at subsample 2")


def clip_state(midi: bytes, samples: np.ndarray, config: dict, traffic: dict, device) -> dict:
    fps = float(config["fps"])
    frames = int(round(traffic["clip_seconds"] * fps))
    rate = int(config["inputs"]["audio"]["samplerate"])
    audio = torch.from_numpy(np.ascontiguousarray(samples.T, np.float32)).to(device)
    times, time = [], 0.0
    for _ in range(frames):
        times.append(time)
        time += 1.0 / fps
    return {"scan": Scan(parse_smf(midi), frames, fps), "times": times,
            "spectrogram": spectrogram(audio, frames, fps, rate)}


def render(config: dict, traffic: dict, inputs: dict, requests: list, device) -> dict:
    """{(job, frame): (H, W, 3) u8 numpy} for requests [(job, clip, frame)]."""
    check(config)
    if float(traffic["ssaa"]) != 1:
        raise ValueError("the piano-roll reference renders at ssaa 1")
    width, height = int(traffic["width"]), int(traffic["height"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    with torch.no_grad():
        for clip in sorted({clip for _, clip, _ in requests}):
            midi = inputs["midi"][clip % len(inputs["midi"])].read_bytes()
            samples = inputs["audio.data"][clip % len(inputs["audio.data"])]
            state = clip_state(midi, samples, config, traffic, device)
            for job, _, index in (r for r in requests if r[1] == clip):
                planes = frame_planes(state["scan"], state["spectrogram"][index], index,
                                      state["times"][index], height, width, device)
                out[(job, index)] = stencil(planes).cpu().numpy()
    return out


def work(config: dict, traffic: dict, inputs: dict, device) -> dict:
    """What the roofline readers count for one frame. The tail and final
    pass (K1's planes form and the stencil, as one stage): its inputs read
    once (the 54 column lines, float32, and three values) and the u8 frame
    written once; the operations of the color formula and of the stencil
    and quantize, each needed element once, counted with the columns'
    and rows' own work apart (two counts at 8 and 16 rows of the frame's
    width, extended in rows). The stencil alone: its three bfloat16 planes
    read once and the u8 frame written once, and its operations."""
    from portbench.harness.counting import count_elementwise
    width, height = int(traffic["width"]), int(traffic["height"])
    generator = torch.Generator().manual_seed(0)
    counts = {}
    for rows in (8, 16):
        cols = {name: torch.rand(1, width, generator=generator) for name in
                ("edge", "glow", "isc", "kb0", "kb1", "kb2",
                 *(f"s{s}{k}" for s in range(SLOTS) for k in "abvrgc"))}
        ay = 1.0 - (torch.arange(rows, dtype=torch.float32)[:, None] + 0.5) * recip(rows)

        def frame(cols, ay):
            planes = tail(cols, ay, torch.tensor(0.5), torch.tensor(HEIGHT),
                          torch.tensor(ROLL_TIME))
            return stencil(torch.stack([torch.broadcast_to(p, (rows, width))
                                        for p in planes]).to(torch.bfloat16))

        _, counts[("tail", rows)] = count_elementwise(frame, cols, ay)
        planes = torch.rand(3, rows, width, generator=generator).to(torch.bfloat16)
        _, counts[("stencil", rows)] = count_elementwise(stencil, planes)

    def extended(stage: str) -> float:
        per_row = (counts[(stage, 16)] - counts[(stage, 8)]) / 8
        return counts[(stage, 8)] + per_row * (height - 8)

    pixels = width * height
    columns_bytes = (6 + 6 * SLOTS) * width * 4 + 3 * 4
    return {"tail_ops": extended("tail"), "tail_bytes": columns_bytes + pixels * 3,
            "stencil_ops": extended("stencil"), "stencil_bytes": pixels * (3 * 2 + 3)}
