"""
Texture sampling: the GL sampler and the separable forms the scenes call.

Port of shaderflow_tpu/ops/sampling.py. Textures are (H, W, C) float32
tensors sampled with GL semantics: texel centers at (i + 0.5)/N, GL_REPEAT
wraps, CLAMP_TO_EDGE clamps, row 0 = the top of the image (v = 1).

  Sampler2D, sample                   GL texture(): bilinear or nearest,
                                      repeat or clamp, v up
  astexture, stexture, gtexture,      the coordinate-space accessors
  gmtexture, agtexture
  MipSampler                          mipmaps: not ported, raises
  sample_separable                    axis-aligned grid sampling
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

Linear filtering is a product with a hat-weight matrix (two nonzeros per
row), in float32 (no TF32: shaderflow_tpu_torch.resolve_device), with
bf16 rounding of operands and results wherever the reference rounds
(precision="bfloat16").
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple

import torch

from shaderflow_tpu_torch.ops import stdlib as sl
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


class MipSampler:
    """A texture bound with its mip pyramid (shaderflow_tpu/ops/sampling.py:
    MipSampler). Mip pyramids and trilinear / anisotropic sampling are not
    ported yet: building one raises NotImplementedError."""

    def __init__(self, levels: tuple, aniso: int = 1):
        raise NotImplementedError(
            "Mipmapped textures (texture.mipmaps=True) are not ported yet: "
            "sample the texture without mipmaps")


def sample(tex: Sampler2D, uv: torch.Tensor) -> torch.Tensor:
    """Sample at GL texture coordinates uv (..., 2), u right / v up in [0, 1]
    -> (..., C): GLSL texture(sampler2D, uv), the workhorse behind the
    astexture / stexture / gtexture family (shaderflow.glsl:162-208).
    GL_NEAREST rounds to the nearest texel center; GL_LINEAR fetches the
    four texels around the position and lerps per channel in the
    reference's order (x on the top and bottom rows, then y)."""
    if isinstance(tex, MipSampler):
        raise NotImplementedError("mipmapped sampling is not ported yet")
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


def _interp_matrix(positions: torch.Tensor, n: int, repeat: bool) -> torch.Tensor:
    """(M, n) linear-interpolation weights: row m holds the hat weights of
    continuous texel position positions[m] (two nonzeros; REPEAT folds the
    weights across the wrap seam, CLAMP clamps the position to [0, n-1])."""
    texels = torch.arange(n, dtype=torch.float32, device=positions.device)
    if repeat:
        delta = positions[:, None] - texels[None, :]
        delta = torch.remainder(delta + n / 2.0, float(n)) - n / 2.0
        return torch.clamp(1.0 - torch.abs(delta), min=0.0)
    positions = torch.clamp(positions, 0.0, float(n - 1))
    delta = positions[:, None] - texels[None, :]
    return torch.clamp(1.0 - torch.abs(delta), min=0.0)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back: the value a bf16 operand holds."""
    return x.to(torch.bfloat16).to(torch.float32)


def sample_separable(tex: Sampler2D, u_line: torch.Tensor,
                     v_line: torch.Tensor) -> torch.Tensor:
    """Axis-aligned grid sampling: u varies along columns only, v along rows
    only -> (len(v), len(u), C), as two 1D interpolations (two products
    with hat-weight matrices; nearest filtering gathers rows and columns)."""
    h, w = tex.height, tex.width
    u = u_line * w - 0.5
    v = (1.0 - v_line) * h - 0.5
    if not tex.linear:
        iy = _wrap(torch.floor(v + 0.5).to(torch.int64), h, tex.repeat_y)
        ix = _wrap(torch.floor(u + 0.5).to(torch.int64), w, tex.repeat_x)
        return tex.data[iy][:, ix]
    w_rows = _interp_matrix(v, h, tex.repeat_y)               # (H', H)
    w_cols = _interp_matrix(u, w, tex.repeat_x)               # (W', W)
    rows = torch.einsum("oh,hwc->owc", w_rows, tex.data.to(torch.float32))
    return torch.einsum("pw,owc->opc", w_cols, rows)          # (H', W', C)


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
    linear filtering of monotone (out_len,) positions -> (offs (nb,) int64,
    weights (nb, block, in_block) f32, nb): block b of the output
    interpolates texels [offs[b], offs[b] + in_block). Positions clip to
    [0, n-1]."""
    nb = -(-out_len // block)
    pad = nb * block - out_len
    if pad:
        pos = torch.cat([pos, pos[-1:].expand(pad)])
    blocks = torch.clamp(pos, 0.0, float(n - 1)).reshape(nb, block)
    offs = torch.clamp(torch.floor(blocks.amin(dim=1)).to(torch.int64) - 1, 0, n - in_block)
    texels = torch.arange(in_block, dtype=torch.float32, device=pos.device)
    delta = blocks[:, :, None] - offs[:, None, None].to(torch.float32) - texels
    return offs, torch.clamp(1.0 - torch.abs(delta), min=0.0), nb


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
    h, w = tex.height, tex.width
    v = (1.0 - v_line) * h - 0.5
    out_h = v.shape[0]
    need = int(math.ceil(block * texels_per_px)) + 3
    in_rows = min(h, max(64, -(-need // 64) * 64))
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

    offs, weights, nb = _blocked_axis(v, out_h, h, block, in_rows)
    if precision == "bfloat16":
        weights = _bf16(weights)
    # Every block's texel-row window gathered at once (offsets stay on the
    # device: no host sync), then one batched product per channel
    rows = offs[:, None] + torch.arange(in_rows, device=offs.device)[None, :]
    windows = data[:, rows]                                   # (C, nb, in_rows, W)
    planes = torch.matmul(weights, windows)                   # (C, nb, block, W)
    planes = planes.reshape(data.shape[0], nb * block, w)[:, :out_h]
    return tuple(plane.to(out_dtype) for plane in planes)


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


def expand_tables(flat16: torch.Tensor, index: torch.Tensor,
                  out_dtype=torch.float32) -> torch.Tensor:
    """(B, n) bf16 tables expanded over an (npx,) int32 index in [0, n) ->
    (B, npx) of out_dtype (bfloat16 or float32). Kernel K2 (csrc/lookup.cu)
    for CUDA tensors — built at first use, launched on the current stream;
    expand_plain for CPU tensors. `expand_tables.launches` counts kernel
    launches."""
    if flat16.device.type == "cpu":
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
    # per pixel for the cost walker: its index read, its value of every
    # frame written, the tables read once
    cost = lambda: flopcount.Cost(kernel_bytes=4 + batch * out.element_size()
                                  + flat16.numel() * 2 / npx)
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
