"""
Input kind `background_png`: a painterly background image made from the
seed, its size fixed by the configuration.

    "background": {"kind": "background_png", "width": 1920, "height": 1080, ...}
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from portbench.harness.inputs import rng_for


def background_pixels(seed: int, width: int, height: int) -> np.ndarray:
    """(height, width, 3) uint8: layered gradients and sinusoidal bands,
    four soft blobs and a star field."""
    rng = rng_for(seed, 2)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    u, v = x / width, y / height
    a, b, c = rng.uniform(1.5, 4.0, 3)
    r = 0.25 + 0.3 * np.sin(a * u + 1.5) * np.cos(2 * v) + 0.25 * v
    g = 0.15 + 0.25 * np.sin(b * u + 4.0) * np.sin(3 * v + 1.0) + 0.15 * (1 - v)
    bl = 0.35 + 0.3 * np.cos(c * u * v * 4.0) + 0.25 * np.sin(5 * v + 2.0) * 0.3
    rgb = np.stack([r, g, bl], axis=-1)
    for _ in range(4):
        cx, cy = rng.uniform(0.1, 0.9, 2)
        radius = rng.uniform(0.1, 0.35)
        color = rng.uniform(0.0, 0.5, 3).astype(np.float32)
        dist = np.sqrt(((u - cx) * (width / height)) ** 2 + (v - cy) ** 2)
        rgb += color * np.exp(-(dist / radius) ** 2)[..., None]
    rgb[rng.random((height, width)) > 0.9995] = 1.0
    return (np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8)


def write_png(path: Path, pixels: np.ndarray) -> Path:
    from PIL import Image
    Image.fromarray(pixels).save(path, compress_level=1)
    return path


def make(name: str, item: dict, seed: int, directory: Path, clip_seconds: float) -> tuple:
    """([the PNG's path], [its (height, width, 3) u8 pixels])."""
    pixels = background_pixels(seed, int(item["width"]), int(item["height"]))
    return [write_png(directory / f"{name}.png", pixels)], [pixels]
