"""
The piano-roll MIDI visualizer on the PyTorch port (shaderflow_tpu_torch).

Port of examples/basic/piano_roll.py: falling notes over a keyboard band
lit by the smoothed key-press velocities, coloured per MIDI channel, with
a faint audio-spectrogram glow behind. The data arrives through the
ShaderPiano textures (iPianoRoll / iPianoKeys / iPianoChan, precomputed as
device sequences) and the offline audio stack. Every texture read depends
on the column only (the key under x) and every time term on the row only,
so the fragment builds 54 column lines and the whole 2D image is one fused
tail (kernel K1, ops/tailfuse.py). At the scene default ssaa=1 the render
is the output size: K1 runs its quantize=False form (bf16 planes), then the
3-tap stencil and the u8 quantize.

    python examples/torch/torch_piano_roll.py        # 4K60, ssaa=1, 2 s, to null
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from shaderflow_tpu_torch.ops import clamp, is_black_key, mix, smoothstep, tailfuse  # noqa: E402
from shaderflow_tpu_torch.ops.sampling import sample_separable  # noqa: E402
from shaderflow_tpu_torch.ops.stdlib import reciprocal  # noqa: E402
from shaderflow_tpu_torch.scene import ShaderScene  # noqa: E402

ASSETS = Path(__file__).resolve().parent.parent / "assets"
MIDI = ASSETS / "arpeggio.mid"
MUSIC = ASSETS / "music.wav"
MAX_SLOTS = 8   # simultaneous notes per key checked per pixel

CHANNEL_COLORS = [
    (0.95, 0.45, 0.25), (0.30, 0.70, 0.95), (0.55, 0.90, 0.45),
    (0.90, 0.80, 0.30), (0.80, 0.40, 0.90), (0.40, 0.90, 0.80),
]


def piano_roll_tail(tp):
    """The 2D image from the column lines, the row coordinate and three
    scalars (plane dialect, ops/tailfuse.py)."""
    def sstep(edge0, edge1, x):
        t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)

    ay = tp.astuv_y
    kbh = tp.scalar("kbh")
    rolltime = tp.scalar("rolltime")
    t_row = tp.scalar("time") + (ay - kbh) / (1.0 - kbh) * rolltime
    ramp = 0.02 * rolltime
    edge_c = tp.col("edge")

    note = [torch.zeros_like(ay), torch.zeros_like(ay), torch.zeros_like(ay)]
    hit = torch.zeros_like(ay)
    for slot in range(MAX_SLOTS):
        start = tp.col(f"s{slot}a")
        end = tp.col(f"s{slot}b")
        bright = tp.col(f"s{slot}v")
        active = (bright > 0.0) & (start <= t_row) & (t_row <= end)
        body = edge_c * sstep(0.0, ramp, t_row - start) \
            * sstep(0.0, ramp, end - t_row)
        contrib = torch.where(active, body * bright, 0.0)
        note[0] = note[0] + tp.col(f"s{slot}r") * contrib
        note[1] = note[1] + tp.col(f"s{slot}g") * contrib
        note[2] = note[2] + tp.col(f"s{slot}c") * contrib
        hit = torch.maximum(hit, torch.where(active, body, 0.0))

    glow_term = tp.col("glow") * (1.0 - ay) * 0.5
    bg = [0.02 + 0.05 * (1.0 - ay) + 0.10 * glow_term,
          0.03 + 0.07 * (1.0 - ay) + 0.05 * glow_term,
          0.05 + 0.12 * (1.0 - ay) + 0.20 * glow_term]
    octave = tp.col("isc") * 0.03
    bg = [b + octave for b in bg]

    felt = (sstep(kbh - 0.012, kbh - 0.008, ay)
            * sstep(kbh, kbh - 0.004, ay))
    felt_rgb = (0.8, 0.1, 0.15)
    in_keyboard = ay < kbh
    out = []
    for c in range(3):
        roll_c = torch.where(hit > 0.0, note[c] + bg[c] * 0.3, bg[c] + note[c])
        kb_c = tp.col(f"kb{c}") * (1.0 - felt) + felt_rgb[c] * felt
        out.append(torch.clamp(torch.where(in_keyboard, kb_c, roll_c), 0.0, 1.0))
    return out


_PALETTES: dict = {}


def _palette(device) -> torch.Tensor:
    """CHANNEL_COLORS on the device, uploaded once per device: a per-frame
    upload of a pageable host list would wait for the stream."""
    key = str(device)
    if key not in _PALETTES:
        _PALETTES[key] = torch.tensor(CHANNEL_COLORS, dtype=torch.float32, device=device)
    return _PALETTES[key]


def piano_roll_columns(sf) -> dict:
    """The tail's 54 column lines (W,) and three scalars for one frame, from
    the piano textures, the spectrogram and the piano uniforms."""
    dynamic = sf.iPianoDynamic                      # smoothed (min, max) note
    extra = sf.iPianoExtra
    lo = dynamic[0] - extra
    hi = dynamic[1] + extra
    span = hi - lo + 1.0

    ax = sf.lines[0]                                # (W,) column line
    key_f = lo + ax * span                          # (W,) fractional note
    key = torch.floor(key_f).to(torch.int32)
    key_frac = key_f - key

    black = is_black_key(key)
    keys_tex = sf.tex("iPianoKeys")
    chan_tex = sf.tex("iPianoChan")
    roll_tex = sf.tex("iPianoRoll")

    zero = torch.zeros_like(key)
    velocity = sf.texel_fetch(keys_tex, torch.stack([key, zero], dim=-1))[..., 0]
    channel = sf.texel_fetch(chan_tex, torch.stack([key, zero], dim=-1))[..., 0]
    pressed = clamp(velocity / 128.0, 0.0, 1.0)     # (W,)

    palette = _palette(sf.device)
    last = len(CHANNEL_COLORS) - 1

    def colors(channels):
        return palette[torch.clamp(channels.to(torch.int32), 0, last).to(torch.int64)]

    # Keyboard band line (per-column colour; the felt strip is in the tail)
    white_color = torch.where(black[..., None], 0.12, 0.92)        # (W, 1)
    border = smoothstep(0.0, 0.08, key_frac) * smoothstep(1.0, 0.92, key_frac)
    kb_line = white_color * border[..., None]
    kb_line = mix(kb_line, colors(channel), pressed[..., None] * 0.85)  # (W, 3)
    edge = smoothstep(0.02, 0.12, key_frac) * smoothstep(0.98, 0.88, key_frac)

    # Per-slot note lines: start/end times, masked brightness, colour. The
    # eight slots go through each op together, the reference's per-slot
    # loop batched (the same elementwise math on the same texels), and land
    # slot-minor, so each of the 48 lines is a contiguous row
    slots = torch.arange(MAX_SLOTS, dtype=torch.int32, device=sf.device)[:, None]
    xy = torch.stack(torch.broadcast_tensors(slots, key[None, :]), dim=-1)    # (8, W, 2)
    data = sf.texel_fetch(roll_tex, xy).permute(2, 0, 1).contiguous()      # (4, 8, W)
    start, end, chan, vel = data
    color = colors(chan).permute(2, 0, 1).contiguous()                     # (3, 8, W)
    # vel > 0 gating folds into the brightness line (0 = inactive slot)
    brightness = torch.where(vel > 0, 0.55 + 0.45 * clamp(vel / 128.0, 0.0, 1.0), 0.0)
    inputs = {}
    for slot in range(MAX_SLOTS):
        inputs[f"s{slot}a"] = tailfuse.Col(start[slot])
        inputs[f"s{slot}b"] = tailfuse.Col(end[slot])
        inputs[f"s{slot}v"] = tailfuse.Col(brightness[slot])
        inputs[f"s{slot}r"] = tailfuse.Col(color[0, slot])
        inputs[f"s{slot}g"] = tailfuse.Col(color[1, slot])
        inputs[f"s{slot}c"] = tailfuse.Col(color[2, slot])

    # Background glow and octave guide lines
    half = torch.full((1,), 0.5, dtype=torch.float32, device=sf.device)
    spec = sample_separable(sf.tex("iSpectrogram"), half, ax)      # (W, 1, C)
    glow = torch.sqrt(torch.clamp(spec[:, 0, 0] + spec[:, 0, 1], min=0.0) * reciprocal(1000.0))
    is_c = ((torch.remainder(key, 12) == 0) & (key_frac < 0.06)).to(torch.float32)
    kb_rows = kb_line.t().contiguous()                               # (3, W)
    return dict(
        edge=tailfuse.Col(edge), glow=tailfuse.Col(glow), isc=tailfuse.Col(is_c),
        kb0=tailfuse.Col(kb_rows[0]), kb1=tailfuse.Col(kb_rows[1]),
        kb2=tailfuse.Col(kb_rows[2]),
        kbh=sf.iPianoHeight, rolltime=sf.iPianoRollTime, time=sf.iTime,
        **inputs)


def piano_roll_frag(sf):
    return sf.tail(piano_roll_tail, **piano_roll_columns(sf))


class PianoRoll(ShaderScene):
    """Falling-notes MIDI piano visualizer with audio spectrogram glow"""
    midi_file = None
    audio_file = None

    def build(self):
        from shaderflow_tpu_torch.audio import ShaderAudio
        from shaderflow_tpu_torch.audio.spectrogram import ShaderSpectrogram
        from shaderflow_tpu_torch.piano import PianoNote, ShaderPiano

        self.piano = ShaderPiano(scene=self)
        self.piano.load_midi(self.midi_file or MIDI)
        self.audio = ShaderAudio(scene=self, name="iAudio",
                                 file=self.audio_file or MUSIC)
        self.spectrogram = ShaderSpectrogram(scene=self, length=0, audio=self.audio,
                                             smooth=True)
        self.spectrogram.from_notes(
            start=PianoNote.from_frequency(20.0),
            end=PianoNote.from_frequency(10000.0),
            piano=True,
        )
        self.shader.fragment = piano_roll_frag


SCENES = [PianoRoll]

if __name__ == "__main__":
    PianoRoll().main(width=3840, height=2160, fps=60, ssaa=1, time=2, output="null")
