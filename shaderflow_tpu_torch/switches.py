"""
The JAX package's run-time switches, read here and nowhere else in the port.

  SHADERFLOW_PIPELINE_DEPTH  batches an export keeps in flight
                             (ShaderScene.pipeline_depth)
  SHADERFLOW_BATCH_TRACE=1   one BATCH_TRACE line a flush on stderr
                             (ShaderScene._export_loop)
  SHADERFLOW_NO_TAILFUSE=1   the reference tail and final pass in place of
                             kernel K1, on CPU tensors; a run on the card
                             refuses it (reference_tail)
  SKIP_TPU=1                 every flush returns black frames on the host
                             and does no device work (RenderEngine.flush)
  SHADERFLOW_REF_SLOT0=1     a temporal main program's final pass reads
                             slot 0 (RenderEngine.build)

Each is read when it is used, so a test may set it with monkeypatch (the
JAX package reads SKIP_TPU at import). The two that change what runs,
SKIP_TPU and SHADERFLOW_NO_TAILFUSE, are announced with a warning at the
start of every export and realtime run (announce); a script that measures
the default path refuses all five (refuse).
"""

from __future__ import annotations

import os

import torch

from shaderflow_tpu_torch import logger

NAMES = ("SHADERFLOW_PIPELINE_DEPTH", "SHADERFLOW_BATCH_TRACE", "SHADERFLOW_NO_TAILFUSE",
         "SKIP_TPU", "SHADERFLOW_REF_SLOT0")


def _on(name: str) -> bool:
    return os.environ.get(name) == "1"


def pipeline_depth(default: int) -> int:
    """SHADERFLOW_PIPELINE_DEPTH, else `default`; at least 1."""
    return max(1, int(os.environ.get("SHADERFLOW_PIPELINE_DEPTH", str(default))))


def batch_trace() -> bool:
    return _on("SHADERFLOW_BATCH_TRACE")


def skip_device() -> bool:
    """SKIP_TPU=1: the host loop alone (the JAX package's switch,
    shaderflow_tpu/engine.py:32-35; the reference's SKIP_GPU)."""
    return _on("SKIP_TPU")


def ref_slot0() -> bool:
    """SHADERFLOW_REF_SLOT0=1: the reference's literal slot for parity
    checks on temporal scenes (shaderflow_tpu/engine.py:318-330)."""
    return _on("SHADERFLOW_REF_SLOT0")


def no_tailfuse() -> bool:
    return _on("SHADERFLOW_NO_TAILFUSE")


def reference_tail(device) -> bool:
    """Whether the tail of a frame on `device` takes the reference route
    (eval_reference and the plain final pass) in place of K1: under
    SHADERFLOW_NO_TAILFUSE=1, for CPU tensors. On the card a wrapper
    launches its kernel or raises, so there the switch raises: the
    reference tail stays callable directly (tailfuse.tail_plain)."""
    if not no_tailfuse():
        return False
    if torch.device(device).type != "cpu":
        raise RuntimeError(
            f"SHADERFLOW_NO_TAILFUSE=1 selects the reference tail, which the port runs "
            f"on CPU tensors only; on {torch.device(device)} the tail runs kernel K1. "
            f"Unset it, or run with device='cpu'")
    return True


def announce(device) -> None:
    """At the start of an export or a realtime run on `device`: refuses
    SHADERFLOW_NO_TAILFUSE=1 on the card before anything runs, and warns
    of each switch that changes what runs."""
    if reference_tail(device):
        logger.warning("SHADERFLOW_NO_TAILFUSE=1: the reference tail and final pass run "
                       "in place of kernel K1")
    if skip_device():
        logger.warning("SKIP_TPU=1: no device work; every frame is black and the rate is "
                       "the host loop's alone")


def refuse(entry: str) -> None:
    """For a script that measures the default path: exit if any switch is
    set in its environment."""
    inherited = [name for name in NAMES if name in os.environ]
    if inherited:
        raise SystemExit(f"{entry}: {', '.join(inherited)} set in the environment; "
                         "it measures the default path")
