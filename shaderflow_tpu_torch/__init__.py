"""
shaderflow_tpu_torch: the PyTorch + CUDA port of shaderflow_tpu.

The JAX package (shaderflow_tpu) stays the reference; this package mirrors
its module names so each counterpart is easy to find, and is held against it
by the tests in tests/test_torch_*.py. It imports torch, never jax, and
nothing of the JAX package: the JAX-free pieces it needs (logger, message,
variable, resolution, io/ffmpeg, io/sinks) are its own copies.

Idiom: plain functions on tensors with an explicit `device` — no global
device state. The device is chosen once per run (`Scene.main(device=...)`,
"cuda" by default); asking for "cuda" without a card raises instead of
moving to the CPU. The CPU path runs every kernel's plain PyTorch version.

Hand-written Hopper kernels (built from the sources in this checkout at
first use, into BUILD_DIR):
  ops/fractal.py   K3 escape-time counts, CUDA C++ (csrc/escape.cu): the
                   lines form (trivial camera) and the planes form
  ops/sampling.py  K2 bar-field table expand, CUDA C++ (csrc/lookup.cu)
  ops/tailfuse.py  K1 fused tail + SSAA pool + u8 quantize, Triton
                   (generated per tail by ops/tailgen.py), and its
                   quantize=False form (bf16 planes, equal resolution)
"""

import logging as _logging
import os
from pathlib import Path

import torch

__version__ = "0.1.0"

package: Path = Path(__file__).parent

BUILD_DIR: Path = package.parent / "build" / "shaderflow_tpu_torch"
"""Kernel build outputs (nvcc shared libraries, generated Triton sources);
listed in .gitignore, rebuilt when a source is newer."""


# The reference's logger helper names (info/warn/error/debug), on the
# standard logging module
logger = _logging.getLogger("shaderflow_tpu_torch")

if not logger.handlers:
    _handler = _logging.StreamHandler()
    _handler.setFormatter(_logging.Formatter("%(asctime)s %(levelname)-7s %(message)s", "%H:%M:%S"))
    logger.addHandler(_handler)
    logger.setLevel(os.environ.get("SHADERFLOW_LOGLEVEL", "INFO").upper())
    logger.warn = logger.warning  # type: ignore[method-assign]


def resolve_device(device) -> torch.device:
    """The run's device. "cuda" without a usable card raises: the port never
    falls back to the CPU on its own — CPU runs ask for device="cpu"."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
        if device.index is None:   # pin "cuda" to the current card
            device = torch.device("cuda", torch.cuda.current_device())
        # f32 parity with the reference: no f32 matrix product or
        # convolution of the port runs in TF32 (about three decimal
        # digits) — the band matmuls, the spectrogram's band matrix and the
        # sinc upsampler's convolution all run in full f32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"Unsupported device {device}; use 'cuda' or 'cpu'")
    return device
