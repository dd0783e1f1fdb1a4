"""
Texture sampling: the GL sampler and the separable forms the scenes call.

Port of shaderflow_tpu/ops/sampling.py. Textures are (H, W, C) float32
tensors sampled with GL semantics: texel centers at (i + 0.5)/N, GL_REPEAT
wraps, CLAMP_TO_EDGE clamps, row 0 = the top of the image (v = 1).

  Sampler2D, sample                   GL texture(): bilinear or nearest,
                                      repeat or clamp, v up
  astexture, stexture, gtexture,      the coordinate-space accessors
  gmtexture, agtexture
  MipSampler, mip_pyramid, auto_lod,  mipmaps: the 2x2 box pyramid (GL's
  sample_mip, sample_mip_aniso        NPOT floor), trilinear sampling with
                                      a level from the uv field's
                                      derivatives, anisotropic taps along
                                      the footprint's major axis
  sample_separable                    axis-aligned grid sampling (mip-aware)
  sample_separable_planes(_blocked)   the same, one (H', W') plane per
                                      channel; banded: each block of output
                                      rows/columns contracts a window
  resample_separable_blocked          the banded separable resample of a
                                      channel-last render with tap-averaged
                                      weights: the general final pass
                                      (ops/downsample.py)
  texel_fetch                         GLSL texelFetch (bottom-left origin)
  sample_rows_planes_blocked          banded row interpolation (the
                                      background and blur rows the tail
                                      column-samples in kernel K1)
  splat_kernel, convolve2d            the radial blur as one small kernel
  lookup_nearest_1d_select_batched    kernel K2 (csrc/lookup.cu): per-frame
                                      tables expanded over a static index
                                      field; the exact gather on CPU tensors
  lookup_nearest_1d_select            one frame's table over an index field
                                      (the realtime bar field): K2 at B = 1
  lookup_nearest_1d(_planes)          the plain nearest table lookups
                                      (a gather of the bf16-rounded table)

Linear filtering is a product with a hat-weight matrix (two nonzeros per
row), in float32 (no TF32: shaderflow_tpu_torch.resolve_device), with
bf16 rounding of operands and results wherever the reference rounds
(precision="bfloat16").
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from shaderflow_tpu_torch.ops import stdlib as sl
from shaderflow_tpu_torch.ops.rows import require_whole_rows
from shaderflow_tpu_torch.tools import flopcount


class Sampler2D(NamedTuple):
    """A texture bound for sampling: (H, W, C) float32 data and its sampler
    state (filter, wrap modes)."""

    data: torch.Tensor     # (H, W, C) float32
    linear: bool = True    # GL_LINEAR vs GL_NEAREST
    repeat_x: bool = True  # GL_REPEAT vs CLAMP_TO_EDGE
    repeat_y: bool = True

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def components(self) -> int:
        return self.data.shape[2]


def _wrap(i: torch.Tensor, n: int, repeat: bool) -> torch.Tensor:
    if repeat:
        return torch.remainder(i, n)
    return torch.clamp(i, 0, n - 1)


def sample(tex: Sampler2D, uv: torch.Tensor) -> torch.Tensor:
    """Sample at GL texture coordinates uv (..., 2), u right / v up in [0, 1]
    -> (..., C): GLSL texture(sampler2D, uv), the workhorse behind the
    astexture / stexture / gtexture family (shaderflow.glsl:162-208).
    GL_NEAREST rounds to the nearest texel center; GL_LINEAR fetches the
    four texels around the position and lerps per channel in the
    reference's order (x on the top and bottom rows, then y). A
    MipSampler samples trilinearly with a level from the uv field
    (sample_mip), so every coordinate-space accessor honours mipmaps."""
    if isinstance(tex, MipSampler):
        return sample_mip(tex, uv)
    h, w = tex.height, tex.width
    u = uv[..., 0] * w - 0.5
    # v up -> rows top-down: row = (1 - v) * H - 0.5
    v = (1.0 - uv[..., 1]) * h - 0.5
    # Texels are fetched by (row, column) index pairs: one gather for every
    # channel and corner. (A flat row index into an (H * W, 4) view takes
    # torch's vectorized row gather on the card, 30x slower here.)
    data = tex.data.to(torch.float32)
    if not tex.linear:
        ix = _wrap(torch.floor(u + 0.5).to(torch.int64), w, tex.repeat_x)
        iy = _wrap(torch.floor(v + 0.5).to(torch.int64), h, tex.repeat_y)
        return data[iy, ix]
    x0f = torch.floor(u)
    y0f = torch.floor(v)
    fx = u - x0f
    fy = v - y0f
    x0i, y0i = x0f.to(torch.int64), y0f.to(torch.int64)
    x0 = _wrap(x0i, w, tex.repeat_x)
    x1 = _wrap(x0i + 1, w, tex.repeat_x)
    y0 = _wrap(y0i, h, tex.repeat_y)
    y1 = _wrap(y0i + 1, h, tex.repeat_y)
    texels = data[torch.stack([y0, y0, y1, y1]), torch.stack([x0, x1, x0, x1])]
    if data.ndim == 3:       # channels on the last axis: the weights broadcast
        fx, fy = fx[..., None], fy[..., None]
    top = texels[0] + (texels[1] - texels[0]) * fx
    bottom = texels[2] + (texels[3] - texels[2]) * fx
    return top + (bottom - top) * fy


# --------------------------------------------------------------------------- #
# Mipmaps: minification anti-aliasing. The pyramid is 2x2 mean pooling per
# level; the level comes from the uv field's finite differences, the
# per-pixel analogue of GL's quad derivatives (samplers see whole
# coordinate fields). A static texture keeps its pyramid between frames
# (shader.Frag.tex with the engine's cache).


class MipSampler:
    """A texture bound with its mip pyramid: `levels[0]` is the
    full-resolution Sampler2D, each next level halves (floor) both sides.
    Calling it samples with a level from the uv field; `lod=` takes a
    Python scalar, a tensor scalar or a per-pixel field. `aniso` > 1 takes
    that many trilinear taps along the footprint's major axis, the level
    from the minor axis (sample_mip_aniso). Level 0's data and sampler
    state stand for the texture's own (texel_fetch, sizes)."""

    def __init__(self, levels: tuple, aniso: int = 1):
        self.levels = tuple(levels)
        self.aniso = int(aniso)

    @property
    def base(self) -> Sampler2D:
        return self.levels[0]

    @property
    def data(self) -> torch.Tensor:
        return self.levels[0].data

    @property
    def height(self) -> int:
        return self.levels[0].height

    @property
    def width(self) -> int:
        return self.levels[0].width

    @property
    def components(self) -> int:
        return self.levels[0].components

    @property
    def linear(self) -> bool:
        return self.levels[0].linear

    @property
    def repeat_x(self) -> bool:
        return self.levels[0].repeat_x

    @property
    def repeat_y(self) -> bool:
        return self.levels[0].repeat_y

    def __call__(self, uv: torch.Tensor, lod=None) -> torch.Tensor:
        return sample_mip(self, uv, lod)


def mip_pyramid(tex: Sampler2D, max_levels: int = None,
                anisotropy: int = 1) -> MipSampler:
    """The 2x2 box pyramid down to 1x1 (or max_levels). An odd side drops
    its last row or column at each level (GL's NPOT floor convention)."""
    levels = [tex]
    data = tex.data.to(torch.float32)
    total = 1 + int(math.floor(math.log2(max(tex.height, tex.width, 1))))
    if max_levels is not None:
        total = min(total, int(max_levels))
    for _ in range(1, total):
        h, w, c = data.shape
        nh, nw = max(h // 2, 1), max(w // 2, 1)
        trimmed = data[: nh * 2 if h > 1 else 1, : nw * 2 if w > 1 else 1]
        if h > 1:
            trimmed = trimmed.reshape(nh, 2, -1, c).mean(dim=1)
        if w > 1:
            trimmed = trimmed.reshape(nh, nw, 2, c).mean(dim=2)
        data = trimmed
        levels.append(Sampler2D(data, tex.linear, tex.repeat_x, tex.repeat_y))
    return MipSampler(tuple(levels), max(1, int(anisotropy)))


def _screen_diff(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Forward difference along a screen axis, the last pixel reusing its
    neighbour's (GL quads behave the same way)."""
    require_whole_rows("screen-space derivatives")
    diff = torch.diff(a, dim=dim)
    return torch.cat([diff, diff.narrow(dim, diff.shape[dim] - 1, 1)], dim=dim)


def auto_lod(uv: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Per-pixel mip level from the uv field's screen-space derivatives:
    log2 of the largest texel footprint, clamped at 0 (magnification).
    uv is an image-shaped (..., H, W, 2) field."""
    tx = uv[..., 0] * width
    ty = uv[..., 1] * height
    footprint = torch.maximum(
        torch.maximum(torch.abs(_screen_diff(tx, -1)), torch.abs(_screen_diff(ty, -1))),
        torch.maximum(torch.abs(_screen_diff(tx, -2)), torch.abs(_screen_diff(ty, -2))))
    return torch.clamp(torch.log2(torch.clamp(footprint, min=1e-12)), min=0.0)


def _level_weight(lod: torch.Tensor, k: int) -> torch.Tensor:
    """Level k's hat weight at `lod`: clip(1 - |lod - k|, 0, 1)."""
    return torch.clamp(1.0 - torch.abs(lod - k), 0.0, 1.0)


def sample_mip(mip: MipSampler, uv: torch.Tensor, lod=None) -> torch.Tensor:
    """Trilinear mipmap sampling (GL LINEAR_MIPMAP_LINEAR). lod=None takes
    the per-pixel level from the uv field (auto_lod; anisotropic taps when
    the sampler asks for them); a Python scalar samples exactly two
    levels; a tensor (a scalar or per pixel) blends every level with hat
    weights."""
    levels = mip.levels
    n = len(levels)
    if n == 1:
        return sample(levels[0], uv)
    if lod is None:
        if mip.aniso > 1 and uv.ndim >= 3:
            return sample_mip_aniso(mip, uv)
        lod = auto_lod(uv, levels[0].height, levels[0].width)
    if not hasattr(lod, "shape") and not hasattr(lod, "dtype"):
        # A Python scalar: exactly two levels
        lod = float(min(max(lod, 0.0), n - 1))
        k = int(math.floor(lod))
        if k >= n - 1:
            return sample(levels[-1], uv)
        frac = lod - k
        lo = sample(levels[k], uv)
        if frac == 0.0:
            return lo
        hi = sample(levels[k + 1], uv)
        return lo + (hi - lo) * frac
    lod = torch.clamp(torch.as_tensor(lod, dtype=torch.float32, device=uv.device),
                      0.0, float(n - 1))
    out = None
    for k, level in enumerate(levels):
        term = sample(level, uv) * _level_weight(lod, k)[..., None]
        out = term if out is None else out + term
    return out


def sample_mip_aniso(mip: MipSampler, uv: torch.Tensor, taps: int = None) -> torch.Tensor:
    """Anisotropic trilinear sampling (GL EXT_texture_filter_anisotropic):
    `taps` samples spread along the screen footprint's major axis, each
    blending every level at the level of the footprint divided by the
    (clamped) anisotropy ratio: sharp along the compressed direction,
    filtered along the long one. uv is an image-shaped (..., H, W, 2)
    field; the cost is taps x levels bilinear samples a pixel."""
    taps = int(taps or mip.aniso)
    levels = mip.levels
    n = len(levels)
    h0, w0 = levels[0].height, levels[0].width
    tx = uv[..., 0] * w0
    ty = uv[..., 1] * h0
    dtx_dx, dty_dx = _screen_diff(tx, -1), _screen_diff(ty, -1)
    dtx_dy, dty_dy = _screen_diff(tx, -2), _screen_diff(ty, -2)
    len_x = torch.sqrt(dtx_dx * dtx_dx + dty_dx * dty_dx)
    len_y = torch.sqrt(dtx_dy * dtx_dy + dty_dy * dty_dy)
    major_is_x = len_x >= len_y
    major = torch.maximum(len_x, len_y)
    minor = torch.minimum(len_x, len_y)
    ratio = torch.clamp(major / torch.clamp(minor, min=1e-12), 1.0, float(taps))
    # GL: log2(Pmax / N), clamped at 0 so magnification stays bilinear
    lod = torch.clamp(torch.clamp(torch.log2(torch.clamp(major / ratio, min=1e-12)),
                                  min=0.0), 0.0, float(n - 1))
    # The major axis in uv units; the taps cover the footprint less one
    # sample's own width (ratio 1: no spread), none at magnification
    vx = torch.where(major_is_x, dtx_dx, dtx_dy) / w0
    vy = torch.where(major_is_x, dty_dx, dty_dy) / h0
    spread = torch.where(major > 1.0, 1.0 - 1.0 / ratio, 0.0)
    level_w = [_level_weight(lod, k)[..., None] for k in range(n)]
    axis = torch.stack([vx, vy], dim=-1)
    acc = None
    for k in range(taps):
        frac = (k + 0.5) / taps - 0.5
        tap_uv = uv + axis * (spread * frac)[..., None]
        tap = None
        for j, level in enumerate(levels):
            term = sample(level, tap_uv) * level_w[j]
            tap = term if tap is None else tap + term
        acc = tap if acc is None else acc + tap
    return acc / taps


def _separable_lod(mip: MipSampler, u_line: torch.Tensor,
                   v_line: torch.Tensor) -> torch.Tensor:
    """One level for axis-aligned grid sampling, a 0-d tensor: log2 of the
    largest line spacing in texels (uniform up to animation), in place of
    auto_lod's per-pixel field."""
    require_whole_rows("mip level selection")
    zero = torch.zeros((), dtype=torch.float32, device=u_line.device)
    fu = torch.abs(torch.diff(u_line)).max() * mip.width if u_line.shape[0] > 1 else zero
    fv = torch.abs(torch.diff(v_line)).max() * mip.height if v_line.shape[0] > 1 else zero
    foot = torch.clamp(torch.maximum(fu, fv), min=1e-12)
    return torch.clamp(torch.log2(foot), min=0.0)


def _reject_mip(tex, who: str) -> None:
    if isinstance(tex, MipSampler):
        raise TypeError(
            f"{who} is a single-level fast path: a mipmapped texture would "
            "lose its minification filtering. Pass sampler.base to sample "
            "level 0, or use sample() / sample_separable(), which select "
            "mip levels.")


def _interp_matrix(positions: torch.Tensor, n: int, repeat: bool) -> torch.Tensor:
    """(M, n) linear-interpolation weights: row m holds the hat weights of
    continuous texel position positions[m] (two nonzeros; REPEAT folds the
    weights across the wrap seam, CLAMP clamps the position to [0, n-1]).
    (T, M) positions give the mean of their T rows of hat weights: the
    factored tap sum of the SSAA box (ops/downsample.py)."""
    texels = torch.arange(n, dtype=torch.float32, device=positions.device)
    if repeat:
        delta = positions[..., None] - texels
        delta = torch.remainder(delta + n / 2.0, float(n)) - n / 2.0
    else:
        delta = torch.clamp(positions, 0.0, float(n - 1))[..., None] - texels
    weights = torch.clamp(1.0 - torch.abs(delta), min=0.0)
    return weights.mean(dim=0) if positions.ndim == 2 else weights


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back: the value a bf16 operand holds."""
    return x.to(torch.bfloat16).to(torch.float32)


def sample_separable(tex: Sampler2D, u_line: torch.Tensor, v_line: torch.Tensor,
                     precision: str = "float32") -> torch.Tensor:
    """Axis-aligned grid sampling: u varies along columns only, v along rows
    only -> (len(v), len(u), C), as two 1D interpolations (two products
    with hat-weight matrices; nearest filtering gathers rows and columns).
    precision="bfloat16" rounds the weights, the texels and the row pass
    to bf16 (sums in f32). A MipSampler blends the levels' separable
    samples with hat weights around one level from the line spacing
    (_separable_lod)."""
    if isinstance(tex, MipSampler):
        lod = torch.clamp(_separable_lod(tex, u_line, v_line), 0.0, float(len(tex.levels) - 1))
        out = None
        for k, level in enumerate(tex.levels):
            term = sample_separable(level, u_line, v_line, precision) * _level_weight(lod, k)
            out = term if out is None else out + term
        return out
    h, w = tex.height, tex.width
    u = u_line * w - 0.5
    v = (1.0 - v_line) * h - 0.5
    if not tex.linear:
        iy = _wrap(torch.floor(v + 0.5).to(torch.int64), h, tex.repeat_y)
        ix = _wrap(torch.floor(u + 0.5).to(torch.int64), w, tex.repeat_x)
        return tex.data[iy][:, ix]
    require_whole_rows("sample_separable")
    w_rows = _interp_matrix(v, h, tex.repeat_y)               # (H', H)
    w_cols = _interp_matrix(u, w, tex.repeat_x)               # (W', W)
    data = tex.data.to(torch.float32)
    if precision == "bfloat16":
        w_rows, w_cols, data = _bf16(w_rows), _bf16(w_cols), _bf16(data)
    rows = torch.einsum("oh,hwc->owc", w_rows, data)
    if precision == "bfloat16":
        rows = _bf16(rows)
    return torch.einsum("pw,owc->opc", w_cols, rows)          # (H', W', C)


def sample_separable_planes(tex: Sampler2D, u_line: torch.Tensor, v_line: torch.Tensor,
                            precision: str = "float32", out_dtype=None) -> tuple:
    """sample_separable as one (len(v), len(u)) plane per channel (out_dtype,
    float32 by default): per channel, the row product then the column
    product."""
    _reject_mip(tex, "sample_separable_planes")
    h, w = tex.height, tex.width
    u = u_line * w - 0.5
    v = (1.0 - v_line) * h - 0.5
    out_dtype = out_dtype or torch.float32
    if not tex.linear:
        iy = _wrap(torch.floor(v + 0.5).to(torch.int64), h, tex.repeat_y)
        ix = _wrap(torch.floor(u + 0.5).to(torch.int64), w, tex.repeat_x)
        data = tex.data[iy][:, ix]
        return tuple(data[..., c] for c in range(data.shape[-1]))
    require_whole_rows("sample_separable_planes")
    w_rows = _interp_matrix(v, h, tex.repeat_y)               # (H', H)
    w_cols = _interp_matrix(u, w, tex.repeat_x)               # (W', W)
    planes = tex.data.to(torch.float32).permute(2, 0, 1)      # (C, H, W)
    if precision == "bfloat16":
        w_rows, w_cols, planes = _bf16(w_rows), _bf16(w_cols), _bf16(planes)
    rows = torch.matmul(w_rows, planes)                       # (C, H', W)
    if precision == "bfloat16":
        rows = _bf16(rows)
    return tuple(plane.to(out_dtype) for plane in torch.matmul(rows, w_cols.T))


def texel_fetch(tex: Sampler2D, xy: torch.Tensor) -> torch.Tensor:
    """GLSL texelFetch: integer texel coordinates (..., 2), x right / y up
    from the bottom-left (GL convention), no filtering, zero outside the
    texture -> (..., C)."""
    h, w = tex.height, tex.width
    x = xy[..., 0].to(torch.int64)
    y = xy[..., 1].to(torch.int64)
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    row = torch.clamp((h - 1) - y, 0, h - 1)
    texels = tex.data[row, torch.clamp(x, 0, w - 1)]
    return torch.where(inside[..., None], texels, 0.0)


def _blocked_axis(pos: torch.Tensor, out_len: int, n: int, block: int,
                  in_block: int) -> tuple:
    """Per-block window offsets and block-local hat-weight matrices for 1D
    linear filtering of monotone positions -> (offs (nb,) int64, weights
    (nb, block, in_block) f32, nb): block b of the output interpolates
    texels [offs[b], offs[b] + in_block) with weights[b]. `pos` is
    (out_len,), or (T, out_len) for T tap positions an output pixel whose
    hat weights are averaged (the factored SSAA box, ops/downsample.py).
    Positions clip to [0, n-1] (CLAMP semantics)."""
    if pos.ndim == 1:
        pos = pos[None, :]
    taps = pos.shape[0]
    nb = -(-out_len // block)
    pad = nb * block - out_len
    if pad:
        pos = torch.cat([pos, pos[:, -1:].expand(taps, pad)], dim=1)
    blocks = torch.clamp(pos, 0.0, float(n - 1)).reshape(taps, nb, block)
    offs = torch.clamp(torch.floor(blocks.amin(dim=(0, 2))).to(torch.int64) - 1, 0, n - in_block)
    texels = torch.arange(in_block, dtype=torch.float32, device=pos.device)
    delta = blocks[:, :, :, None] - offs[None, :, None, None].to(torch.float32) - texels
    return offs, torch.clamp(1.0 - torch.abs(delta), min=0.0).mean(dim=0), nb


def _window(span: float, n: int) -> int:
    """The texels of a block's window for outputs spanning `span` texels:
    rounded up to a multiple of 64, at least 64, at most n."""
    need = int(math.ceil(span)) + 3
    return min(n, max(64, -(-need // 64) * 64))


def sample_rows_planes_blocked(
        tex: Sampler2D, v_line: torch.Tensor, texels_per_px: float,
        precision: str = "float32", out_dtype=None,
        block: int = 240) -> tuple:
    """Row interpolation at v_line only -> one (len(v_line), W) plane per
    channel, row-filtered but not column-sampled (the form tailfuse.
    ColSampled consumes). Each `block` of output rows contracts a window of
    in_rows texel rows sized from `texels_per_px` (an upper bound on texel
    rows per output row): positions must be monotone and stay inside
    [0, H-1] (CLAMP semantics; no REPEAT seam). precision="bfloat16" rounds
    the weights and texels to bf16 (products are exact in f32, sums f32)."""
    _reject_mip(tex, "sample_rows_planes_blocked")
    require_whole_rows("sample_rows_planes_blocked")
    h, w = tex.height, tex.width
    v = (1.0 - v_line) * h - 0.5
    out_h = v.shape[0]
    in_rows = _window(block * texels_per_px, h)
    out_dtype = out_dtype or torch.float32
    data = tex.data.to(torch.float32).permute(2, 0, 1)        # (C, H, W)
    if precision == "bfloat16":
        data = _bf16(data)

    if in_rows >= h:
        w_rows = _interp_matrix(v, h, tex.repeat_y)
        if precision == "bfloat16":
            w_rows = _bf16(w_rows)
        planes = torch.matmul(w_rows, data)                   # (C, H', W)
        return tuple(plane.to(out_dtype) for plane in planes)
    planes = _gathered_rows(data, v, h, block, in_rows, precision)
    return tuple(plane.to(out_dtype) for plane in planes)


def _gathered_rows(planes: torch.Tensor, pos: torch.Tensor, n: int, block: int,
                   in_rows: int, precision: str) -> torch.Tensor:
    """(C, n, W) planes interpolated at the (out,) row positions `pos`,
    block by block -> (C, out, W). Every block's window of in_rows rows is
    gathered at once (the offsets stay on the device: no host sync), then
    one batched product per channel."""
    offs, weights, nb = _blocked_axis(pos, pos.shape[0], n, block, in_rows)
    if precision == "bfloat16":
        weights = _bf16(weights)
    rows = offs[:, None] + torch.arange(in_rows, device=offs.device)[None, :]
    windows = planes[:, rows]                                 # (C, nb, in_rows, W)
    out = torch.matmul(weights, windows)                      # (C, nb, block, W)
    return out.reshape(planes.shape[0], nb * block, planes.shape[2])[:, :pos.shape[0]]


def sample_separable_planes_blocked(
        tex: Sampler2D, u_line: torch.Tensor, v_line: torch.Tensor,
        texels_per_px: tuple, precision: str = "float32",
        out_dtype=None, block: int = 240) -> tuple:
    """sample_separable_planes on the band structure of its weights: each
    `block` of output rows (then columns) contracts only a window of the
    texture sized from texels_per_px = (du, dv), upper bounds on texels
    per output pixel along u (columns) and v (rows). Positions must be
    monotone and stay inside [0, n-1] (CLAMP semantics; no REPEAT seam).
    The dense products when the windows would cover the texture."""
    _reject_mip(tex, "sample_separable_planes_blocked")
    require_whole_rows("sample_separable_planes_blocked")
    h, w = tex.height, tex.width
    du, dv = texels_per_px
    in_rows = _window(block * dv, h)
    in_cols = _window(block * du, w)
    if in_rows >= h and in_cols >= w:
        return sample_separable_planes(tex, u_line, v_line, precision=precision,
                                       out_dtype=out_dtype)
    u = u_line * w - 0.5
    v = (1.0 - v_line) * h - 0.5
    out_dtype = out_dtype or torch.float32
    planes = tex.data.to(torch.float32).permute(2, 0, 1)      # (C, H, W)
    if precision == "bfloat16":
        planes = _bf16(planes)
    rows = _gathered_rows(planes, v, h, block, in_rows, precision)   # (C, H', W)
    if precision == "bfloat16":
        rows = _bf16(rows)
    # The columns as rows of the transposed intermediate
    out = _gathered_rows(rows.transpose(1, 2), u, w, block, in_cols, precision)
    return tuple(plane.T.to(out_dtype) for plane in out)


class ResamplePlan(NamedTuple):
    """The weights of a banded separable resample, made once per
    configuration on the host (resample_plan): per axis the windows'
    offsets as host ints and their (nb, block, window) weights on the
    device, or, where the windows would cover the texture, the dense
    (out, n) weights (offsets None)."""

    out_height: int
    out_width: int
    row_offsets: Optional[tuple]
    row_weights: torch.Tensor
    col_offsets: Optional[tuple]
    col_weights: torch.Tensor


def resample_plan(pos_rows, pos_cols, height: int, width: int, rows_per_px: float,
                  cols_per_px: float, device, block: int = 240) -> ResamplePlan:
    """The plan of resample_separable_blocked for (T, Ho) / (T, Wo) host
    positions over an (height, width) texture, its weights on `device`.
    The windows' offsets come from the positions on the host, so applying
    the plan never reads the device."""
    pos_rows = torch.as_tensor(pos_rows, dtype=torch.float32, device="cpu")
    pos_cols = torch.as_tensor(pos_cols, dtype=torch.float32, device="cpu")
    pos_rows = pos_rows if pos_rows.ndim == 2 else pos_rows[None]
    pos_cols = pos_cols if pos_cols.ndim == 2 else pos_cols[None]
    # Each window also spans the tap spread: one output pixel more
    in_rows = _window(block * rows_per_px + rows_per_px, height)
    in_cols = _window(block * cols_per_px + cols_per_px, width)
    out_h, out_w = pos_rows.shape[1], pos_cols.shape[1]
    if in_rows >= height and in_cols >= width:
        return ResamplePlan(out_h, out_w, None,
                            _interp_matrix(pos_rows, height, False).to(device), None,
                            _interp_matrix(pos_cols, width, False).to(device))
    roffs, rweights, _ = _blocked_axis(pos_rows, out_h, height, block, in_rows)
    coffs, cweights, _ = _blocked_axis(pos_cols, out_w, width, block, in_cols)
    return ResamplePlan(out_h, out_w, tuple(roffs.tolist()), rweights.to(device),
                        tuple(coffs.tolist()), cweights.to(device))


def apply_resample(data: torch.Tensor, plan: ResamplePlan) -> torch.Tensor:
    """A channel-last (H, W, C) texture resampled by `plan` ->
    (Ho, Wo, C) float32: rows, then the columns of the row-filtered
    intermediate, each block of outputs contracting its window (a narrow()
    view at a host offset) with one product for every channel."""
    require_whole_rows("apply_resample")
    planes = data.to(torch.float32).permute(2, 0, 1)            # (C, H, W)
    if plan.row_offsets is None:
        rows = torch.matmul(plan.row_weights, planes)            # (C, Ho, W)
        out = torch.matmul(rows, plan.col_weights.T)             # (C, Ho, Wo)
        return out.permute(1, 2, 0)
    in_rows = plan.row_weights.shape[2]
    rows = torch.cat([torch.matmul(weights, planes.narrow(1, offset, in_rows))
                      for offset, weights in zip(plan.row_offsets, plan.row_weights)],
                     dim=1)[:, :plan.out_height]                 # (C, Ho, W)
    in_cols = plan.col_weights.shape[2]
    out = torch.cat([torch.matmul(rows.narrow(2, offset, in_cols), weights.T)
                     for offset, weights in zip(plan.col_offsets, plan.col_weights)],
                    dim=2)[:, :, :plan.out_width]                # (C, Ho, Wo)
    return out.permute(1, 2, 0)


def resample_separable_blocked(data: torch.Tensor, pos_rows, pos_cols,
                               rows_per_px: float, cols_per_px: float,
                               block: int = 240) -> torch.Tensor:
    """Banded separable resample of channel-last (H, W, C) data: the
    general path of the SSAA final pass -> (Ho, Wo, C) float32.

    pos_rows (T, Ho) / pos_cols (T, Wo): continuous texel positions an
    output pixel, on the host (T >= 1 taps, their hat weights averaged:
    the factored SSAA box filter). rows_per_px / cols_per_px: upper bounds
    on |d position / d output pixel|, the tap spread included. Each
    `block` of output rows / columns contracts only a window of about
    block * bound texels instead of the dense (Ho, H) x (H, W) product;
    CLAMP semantics; the dense products where the windows would span the
    texture. Equal to the dense band product up to summation order."""
    plan = resample_plan(pos_rows, pos_cols, data.shape[0], data.shape[1], rows_per_px,
                         cols_per_px, data.device, block)
    return apply_resample(data, plan)


def splat_kernel(offsets: torch.Tensor, size: int, weights=None) -> torch.Tensor:
    """A tap kernel from N continuous offsets by bilinear splatting:
    K = sum_j hat(x - dx_j) (x) hat(y - dy_j). Sampling at p + d_j for all j
    and summing equals applying K around p and sampling once. Offsets are
    (N, 2) (dx, dy) in texel units, y down; `size` odd and >= 2*ceil(max
    |offset|) + 3."""
    half = size // 2
    grid = torch.arange(-half, half + 1, dtype=torch.float32, device=offsets.device)
    dx = offsets[:, 0:1]
    dy = offsets[:, 1:2]
    hat_x = torch.clamp(1.0 - torch.abs(grid[None, :] - dx), min=0.0)   # (N, size)
    hat_y = torch.clamp(1.0 - torch.abs(grid[None, :] - dy), min=0.0)
    if weights is not None:
        hat_x = hat_x * torch.as_tensor(weights, dtype=torch.float32,
                                        device=offsets.device)[:, None]
    return torch.einsum("ny,nx->yx", hat_y, hat_x)           # (size, size)


def convolve2d(image: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise tap application, zero padding: out[y, x] = sum_{dy,dx}
    kernel[h2+dy, w2+dx] * image[y+dy, x+dx] (cross-correlation, the
    splat_kernel orientation). (H, W, C) -> (H, W, C); one depthwise
    conv2d (float32, no TF32)."""
    require_whole_rows("convolve2d")
    channels = image.shape[2]
    kh, kw = kernel.shape
    weight = kernel.to(torch.float32).expand(channels, 1, kh, kw).contiguous()
    out = torch.nn.functional.conv2d(image.permute(2, 0, 1)[None], weight,
                                     padding=(kh // 2, kw // 2), groups=channels)
    return out[0].permute(1, 2, 0)


# --------------------------------------------------------------------------- #
# Kernel K2: batched nearest lookup (the visualizer's bar field)

def _lookup_library() -> ctypes.CDLL:
    from shaderflow_tpu_torch.build import cuda_library
    library = cuda_library(Path(__file__).parent.parent / "csrc" / "lookup.cu")
    function = library.lookup_expand
    if function.argtypes is None:
        function.restype = ctypes.c_int
        function.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    return library


def lookup_index(v_field: torch.Tensor, bins: int, channels: int,
                 channel_where=None, channel: int = 0,
                 repeat_y: bool = False) -> torch.Tensor:
    """Flat table index of every pixel, (H*W,) int32: row = floor((1 - v) *
    bins), clamped (mod bins with repeat_y), then row * C + (channel_where
    ? 0 : 1) — the reference's expression order."""
    rows = torch.floor((1.0 - v_field) * bins).to(torch.int32)
    rows = torch.remainder(rows, bins) if repeat_y else torch.clamp(rows, 0, bins - 1)
    if channel_where is not None:
        lane = torch.where(torch.broadcast_to(torch.as_tensor(
            channel_where, device=rows.device), rows.shape), 0, 1)
        flat = rows * channels + lane.to(torch.int32)
    else:
        flat = rows * channels + channel
    return flat.reshape(-1).to(torch.int32).contiguous()


def expand_plain(flat16: torch.Tensor, index: torch.Tensor,
                 out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of kernel K2: the exact gather flat16[:, index]."""
    return flat16[:, index.to(torch.int64)].to(out_dtype)


def _expand_cost(flat16: torch.Tensor, npx: int, out_dtype) -> flopcount.Cost:
    """One pixel's share of a K2 launch for the cost walker: its index
    read, its value of every frame written, the tables read once."""
    out_size = torch.empty((), dtype=out_dtype).element_size()
    return flopcount.Cost(kernel_bytes=4 + flat16.shape[0] * out_size + flat16.numel() * 2 / npx)


def expand_tables(flat16: torch.Tensor, index: torch.Tensor,
                  out_dtype=torch.float32) -> torch.Tensor:
    """(B, n) bf16 tables expanded over an (npx,) int32 index in [0, n) ->
    (B, npx) of out_dtype (bfloat16 or float32). Kernel K2 (csrc/lookup.cu)
    for CUDA tensors — built at first use, launched on the current stream;
    expand_plain for CPU tensors. Either is declared to the cost walker as
    one launch of `npx` pixels (_expand_cost). `expand_tables.launches`
    counts kernel launches."""
    if flat16.device.type == "cpu":
        with flopcount.kernel("K2", index.shape[0],
                              lambda: _expand_cost(flat16, index.shape[0], out_dtype)):
            return expand_plain(flat16, index, out_dtype)
    if flat16.device.type != "cuda" or index.device != flat16.device:
        raise ValueError(f"K2 takes tables and index on one CUDA device, got "
                         f"{flat16.device} and {index.device}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K2 writes bfloat16 or float32, not {out_dtype}")
    if (flat16.dtype != torch.bfloat16 or flat16.ndim != 2 or not flat16.is_contiguous()
            or index.dtype != torch.int32 or index.ndim != 1 or not index.is_contiguous()):
        raise ValueError(
            f"K2 takes contiguous (B, n) bfloat16 tables and an (npx,) int32 index, "
            f"got {flat16.dtype} {tuple(flat16.shape)} and {index.dtype} "
            f"{tuple(index.shape)}")
    batch, n = flat16.shape
    out = torch.empty((batch, index.shape[0]), dtype=out_dtype, device=flat16.device)
    library = _lookup_library()
    npx = index.shape[0]
    cost = lambda: _expand_cost(flat16, npx, out_dtype)
    with flopcount.kernel("K2", npx, cost), torch.cuda.device(flat16.device):
        status = library.lookup_expand(
            index.data_ptr(), flat16.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.float32), batch, n, index.shape[0],
            torch.cuda.current_stream(flat16.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"lookup_expand launch failed: cudaError {status}")
    expand_tables.launches += 1
    return out


expand_tables.launches = 0


def lookup_nearest_1d_select_batched(
        tables: torch.Tensor, v_field: torch.Tensor, channel_where=None,
        channel: int = 0, repeat_y: bool = False, out_dtype=None) -> torch.Tensor:
    """Expand per-frame tables over ONE static index field -> (B, H, W):
    out[b, y, x] = bf16(tables[b, row, ch]) with row = floor((1 - v) * bins)
    clamped (mod bins with repeat_y) and ch = 0 where channel_where else 1
    (or `channel`). tables (B, bins, C); v_field (H, W). Values round
    through bf16 once (the reference's precision). Kernel K2 on the card,
    the exact gather on CPU tensors (expand_tables)."""
    batch, bins, channels = tables.shape
    height, width = v_field.shape
    index = lookup_index(v_field, bins, channels, channel_where, channel, repeat_y)
    flat16 = tables.reshape(batch, bins * channels).to(torch.bfloat16).contiguous()
    out = expand_tables(flat16, index, out_dtype or torch.float32)
    return out.reshape(batch, height, width)


def _nearest_rows(tex: Sampler2D, v_field: torch.Tensor) -> torch.Tensor:
    """The table row of every pixel (lookup_index with one channel), in
    v_field's shape, as int64 for indexing."""
    rows = lookup_index(v_field, tex.height, 1, repeat_y=tex.repeat_y)
    return rows.reshape(v_field.shape).to(torch.int64)


def lookup_nearest_1d(tex: Sampler2D, v_field: torch.Tensor, mode: str = "onehot",
                      precision: str = "float32") -> torch.Tensor:
    """Per-pixel NEAREST lookup along a texture's v axis (u at its first
    column) -> (..., C): the radial spectrogram's access pattern. The
    reference's default ("onehot") contracts a bf16 one-hot against the
    bf16-rounded table with float32 accumulation: one nonzero term a
    pixel, so it equals a gather of the bf16 table, which is what runs
    here; precision="bfloat16" returns it as bfloat16. mode="select" is
    the exact float32 gather."""
    rows = _nearest_rows(tex, v_field)
    table = tex.data[:, 0, :]                                 # (H, C)
    if mode == "select":
        return table[rows]
    out_dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
    return table.to(torch.bfloat16)[rows].to(out_dtype)


def lookup_nearest_1d_planes(tex: Sampler2D, v_field: torch.Tensor,
                             precision: str = "bfloat16") -> tuple:
    """lookup_nearest_1d as one plane per channel (each the shape of
    v_field), the bf16-rounded table's values, in bfloat16 by default."""
    rows = _nearest_rows(tex, v_field)
    table = tex.data[:, 0, :].to(torch.bfloat16)
    out_dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
    return tuple(table[:, c][rows].to(out_dtype) for c in range(table.shape[1]))


def lookup_nearest_1d_select(tex: Sampler2D, v_field: torch.Tensor,
                             channel_where=None, channel: int = 0,
                             out_dtype=None) -> torch.Tensor:
    """One (H, W) plane of NEAREST table lookups from a (bins, 1, C)
    texture (shaderflow_tpu/ops/sampling.py:795): row = floor((1 - v) *
    tex.height), clamped (mod tex.height when the texture repeats in y),
    channel 0 where channel_where else 1 (or `channel`), and the table's
    value rounded to bfloat16 selected exactly. What
    lookup_nearest_1d_select_batched computes for a batch of one: kernel K2
    at B = 1 on the card, the plain gather on CPU tensors."""
    table = tex.data[:, 0, :]                                 # (bins, C)
    bins, channels = table.shape
    index = lookup_index(v_field, bins, channels, channel_where, channel, tex.repeat_y)
    flat16 = table.reshape(1, bins * channels).to(torch.bfloat16).contiguous()
    out = expand_tables(flat16, index, out_dtype or torch.float32)
    return out.reshape(v_field.shape)


# --------------------------------------------------------------------------- #
# GLSL-style coordinate-space texture accessors (shaderflow.glsl:165-208).
# These take the scene aspect explicitly where the GLSL reads the
# iAspectRatio uniform; the Frag context binds them.

def astexture(tex: Sampler2D, astuv: torch.Tensor) -> torch.Tensor:
    return sample(tex, astuv)


def gtexture(tex: Sampler2D, gluv: torch.Tensor, mirror: bool = False) -> torch.Tensor:
    if mirror:
        return gmtexture(tex, gluv)
    scale = sl.vec2(torch.full((), tex.height / tex.width, dtype=torch.float32,
                               device=gluv.device), 1.0)
    return sample(tex, sl.gluv2stuv(gluv * scale))


def gmtexture(tex: Sampler2D, gluv: torch.Tensor, want_aspect: float = 1.0) -> torch.Tensor:
    return gtexture(tex, sl.gluv_mirrored_repeat(gluv, want_aspect))


def agtexture(tex: Sampler2D, agluv: torch.Tensor, aspect,
              mirror: bool = False) -> torch.Tensor:
    if mirror:
        return agtexture(tex, sl.agluv_mirrored_repeat(agluv), aspect)
    return gtexture(tex, sl.agluv2gluv(agluv, aspect))


def stexture(tex: Sampler2D, stuv: torch.Tensor) -> torch.Tensor:
    return gtexture(tex, sl.stuv2gluv(stuv))
