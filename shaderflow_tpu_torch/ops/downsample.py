"""
SSAA downsample + uint8 quantization — the "final pass", plain PyTorch.

Same math as shaderflow_tpu/ops/downsample.py (the reference's final.glsl
box of subsample x subsample bilinear taps). This is the plain version
that kernel K1 (ops/tailfuse.py) is held against; the export path runs it
on CPU tensors.
"""

from __future__ import annotations

import torch


def box_downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Exact factor x factor average pooling of (H, W, C) (VALID windows:
    trailing rows/columns that do not fill a window are dropped)."""
    height, width = x.shape[0] // factor, x.shape[1] // factor
    x = x[:height * factor, :width * factor]
    windows = x.reshape(height, factor, width, factor, x.shape[2])
    return windows.sum(dim=(1, 3)) / float(factor * factor)


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """GL UNSIGNED_BYTE conversion: floor(clamp(c, 0, 1) * 255 + 0.5).
    Half-away rounding (GL hardware), not round-half-even; always f32."""
    x = x.to(torch.float32)
    return torch.floor(torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def ssaa_downsample(
    render: torch.Tensor,
    out_height: int,
    out_width: int,
    subsample: int = 2,
    components: int = 3,
) -> torch.Tensor:
    """Downsample a supersampled (Hr, Wr, C) float render to
    (out_height, out_width, components) float in [0, 1]."""
    rh, rw = render.shape[0], render.shape[1]
    render = render[..., :components]

    # Equal resolution: the subsample^2 bilinear taps of a clamp-to-edge
    # texture collapse to a separable 3-tap stencil [m, 1-2m, m] per axis
    if (rh, rw) == (out_height, out_width) and subsample >= 1:
        if subsample == 1:
            return render
        m = sum(max(0.0, -0.5 + (k + 0.5) / subsample)
                for k in range(subsample)) / subsample
        padded = torch.nn.functional.pad(
            render.permute(2, 0, 1)[None], (1, 1, 1, 1),
            mode="replicate")[0].permute(1, 2, 0)
        rows = ((1.0 - 2.0 * m) * padded[1:1 + out_height]
                + m * (padded[0:out_height] + padded[2:2 + out_height]))
        return ((1.0 - 2.0 * m) * rows[:, 1:1 + out_width]
                + m * (rows[:, 0:out_width] + rows[:, 2:2 + out_width]))

    # Exact average pooling when taps align with texel centers
    if rh == out_height * subsample and rw == out_width * subsample and subsample > 1:
        return box_downsample(render, subsample)

    raise NotImplementedError(
        f"ssaa_downsample {rw}x{rh} -> {out_width}x{out_height} subsample "
        f"{subsample}: the general bilinear-tap path needs "
        "resample_separable_blocked (ops/sampling.py), not ported yet")


def final_pass(render: torch.Tensor, out_height: int, out_width: int,
               subsample: int = 2) -> torch.Tensor:
    """Full final pass: SSAA downsample + u8 quantize -> (H, W, 3) uint8."""
    return quantize_u8(ssaa_downsample(render, out_height, out_width,
                                       subsample, components=3))
