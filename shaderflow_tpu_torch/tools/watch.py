"""
Two witnesses that a piece of host code does no work on the card, for
checks of paths that must leave it alone (SKIP_TPU=1's flush):

  profiled_activities  the CUDA kernels and copies torch.profiler records
                       while it runs
  cuda_ops             the torch ops it runs on a CUDA tensor

The port's hand-written kernels launch outside torch: their wrappers'
launch counters are the third witness. Needs a CUDA card for the profile.
"""

from __future__ import annotations

import torch

# The marker's empty kernels launched after the watched call, and the
# profiles taken before giving up on the marker
MARKER_LAUNCHES, PROFILE_TRIES = 10, 5


def profiled_activities(fn, device="cuda") -> list[str]:
    """The names of the CUDA activities (kernels, copies) torch.profiler
    records while fn() runs. An empty list means something only if the
    profile records at all, so MARKER_LAUNCHES empty kernels
    (flopcount.empty_launch) follow fn() inside the profile, and their
    records are left out of the result. torch.profiler on the H100 has
    delivered a profile that lacked records of a run it watched, late in
    a long process: a session first runs empty, to take any record left
    from an earlier one, and a profile without the marker is taken again,
    PROFILE_TRIES in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from shaderflow_tpu_torch.tools import flopcount
    flopcount.empty_launch(device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            for _ in range(MARKER_LAUNCHES):
                flopcount.empty_launch(device)
            torch.cuda.synchronize()
        names = [event.name for event in prof.events() if event.device_type == DeviceType.CUDA]
        if any("empty_kernel" in name for name in names):
            return [name for name in names if "empty_kernel" not in name]
    raise AssertionError(f"torch.profiler recorded no marker kernel in {PROFILE_TRIES} "
                         "profiles")


def cuda_ops(fn) -> list[str]:
    """The torch ops fn() runs with a CUDA tensor among their inputs or
    outputs (a TorchDispatchMode sees every aten op: kernels and copies
    alike)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    seen = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            flat, _ = tree_flatten((args, kwargs, out))
            if any(isinstance(value, torch.Tensor) and value.is_cuda for value in flat):
                seen.append(str(func))
            return out

    with Watch():
        fn()
    return seen
