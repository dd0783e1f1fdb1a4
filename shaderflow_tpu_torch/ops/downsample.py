"""
SSAA downsample + uint8 quantization — the "final pass", plain PyTorch.

Same math as shaderflow_tpu/ops/downsample.py (the reference's final.glsl
box of subsample x subsample bilinear taps), by regime: equal resolution
(a separable 3-tap stencil), exact pooling (render = output x subsample)
and the general path for any other pair of sizes (ssaa 1.5, 3, 4 with
subsample 2, realtime ssaa < 1: a banded separable resample). It is the
plain version that kernel K1 (ops/tailfuse.py) is held against, and the
final pass of every regime K1 does not take, on the CPU and on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from shaderflow_tpu_torch.ops.rows import require_whole_rows
from shaderflow_tpu_torch.ops.sampling import apply_resample, resample_plan


def box_downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Exact factor x factor average pooling of (H, W, C) (VALID windows:
    trailing rows/columns that do not fill a window are dropped)."""
    require_whole_rows("box_downsample")
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
    rows: Optional[tuple] = None,
) -> torch.Tensor:
    """Downsample a supersampled (Hr, Wr, C) float render to
    (out_height, out_width, components) float in [0, 1]. `rows` =
    (first, end) computes those output rows only, each equal to the whole
    pass's: the identity and the exact pooling read only the render rows
    under them (the rest of `render` may hold anything), the stencil one
    row more on each side, the general path the whole render."""
    require_whole_rows("ssaa_downsample")
    rh, rw = render.shape[0], render.shape[1]
    render = render[..., :components]
    first, end = rows if rows is not None else (0, out_height)

    # Equal resolution: the subsample^2 bilinear taps of a clamp-to-edge
    # texture collapse to a separable 3-tap stencil [m, 1-2m, m] per axis
    if (rh, rw) == (out_height, out_width) and subsample >= 1:
        if subsample == 1:
            return render[first:end]
        m = sum(max(0.0, -0.5 + (k + 0.5) / subsample)
                for k in range(subsample)) / subsample
        padded = torch.nn.functional.pad(
            render.permute(2, 0, 1)[None], (1, 1, 1, 1),
            mode="replicate")[0].permute(1, 2, 0)
        vertical = ((1.0 - 2.0 * m) * padded[1 + first:1 + end]
                    + m * (padded[first:end] + padded[2 + first:2 + end]))
        return ((1.0 - 2.0 * m) * vertical[:, 1:1 + out_width]
                + m * (vertical[:, 0:out_width] + vertical[:, 2:2 + out_width]))

    # Exact average pooling when taps align with texel centers
    if rh == out_height * subsample and rw == out_width * subsample and subsample > 1:
        return box_downsample(render[first * subsample:end * subsample], subsample)

    # General path: subsample^2 bilinear taps an output pixel
    # (final.glsl:21-29). The tap grid is axis-aligned, so by linearity the
    # s^2-tap average factors into one separable resample whose per-axis
    # weights are the tap-averaged hat bands (summation order aside, the
    # same math), contracted block by block (resample_separable_blocked).
    # The weights depend on the sizes only: made once, on the host
    plan = _general_plan(rh, rw, out_height, out_width, int(subsample), render.device)
    return apply_resample(render, plan)[first:end, :, :components]


_PLANS: dict = {}


def _general_plan(render_height: int, render_width: int, out_height: int,
                  out_width: int, subsample: int, device: torch.device):
    """The general path's resample plan for these sizes on `device`, made
    once (a few per process: the sizes a run renders at). Its taps sit at
    the output pixel centers moved by each tap's offset, as texel
    positions (sampling.sample_separable's conventions)."""
    key = (render_height, render_width, out_height, out_width, subsample, str(device))
    if key not in _PLANS:
        if len(_PLANS) >= 8:
            _PLANS.pop(next(iter(_PLANS)))
        u_centers = (torch.arange(out_width, dtype=torch.float32) + 0.5) / out_width
        v_centers = 1.0 - (torch.arange(out_height, dtype=torch.float32) + 0.5) / out_height
        pixel_u, pixel_v = 1.0 / out_width, 1.0 / out_height
        pos_rows, pos_cols = [], []
        for k in range(subsample):
            du = -pixel_u / 2.0 + (pixel_u / subsample) * (0.5 + k)
            dv = -pixel_v / 2.0 + (pixel_v / subsample) * (0.5 + k)
            pos_cols.append((u_centers + du) * render_width - 0.5)
            pos_rows.append((1.0 - (v_centers + dv)) * render_height - 0.5)
        _PLANS[key] = resample_plan(torch.stack(pos_rows), torch.stack(pos_cols),
                                    render_height, render_width, render_height / out_height,
                                    render_width / out_width, device)
    return _PLANS[key]


def final_pass(render: torch.Tensor, out_height: int, out_width: int,
               subsample: int = 2, rows: Optional[tuple] = None) -> torch.Tensor:
    """Full final pass: SSAA downsample + u8 quantize -> (H, W, 3) uint8,
    or its output rows `rows` (ssaa_downsample)."""
    return quantize_u8(ssaa_downsample(render, out_height, out_width,
                                       subsample, components=3, rows=rows))
