"""
The yardstick of the roofline metrics: the H100's published peaks and the
functions that count a stage's operations and bytes from shapes and
inputs, never from the port's own declared costs.

Peaks (NVIDIA H100 SXM data sheet, at its 700 W limit): HBM3 at
3.35 TB/s; float32 outside the tensor cores at 66.9 TFLOP/s, which is
128 lanes x 132 SMs x 1.98 GHz x 2, a fused multiply-add counted as two.
An operation of a formula (a product, a sum, a compare, a select) counts
one: a kernel that fuses no pair of them reaches half of this peak at
most, one that fuses every product with a sum reaches it, and none can
pass it. The card's power limit is reported beside every roofline.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 2 * 128 * 132 * 1.98e9

# One useful escape step of z <- z^2 + c and its test |z|^2 > r^2, with
# the squares of z computed once and reused by the next step: zx*zx,
# zy*zy, zx*zy (3 products), zx^2 - zy^2, + cx, 2 zx zy as a sum, + cy
# (4 sums), |z|^2 (1 sum) and the compare
ESCAPE_OPS_PER_STEP = 9


def least_seconds(ops: float, nbytes: float) -> tuple:
    """(seconds, "operations" or "bytes"): the larger of the two bounds."""
    compute, memory = ops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (compute, "operations") if compute >= memory else (memory, "bytes")


def share_pct(least: float, measured: float):
    """least / measured in percent; None without a measured time."""
    if not measured or measured <= 0 or not least:
        return None
    return 100.0 * least / measured


# Aten ops that move, copy, cast or make values and compute none
FREE = ("view", "_unsafe_view", "expand", "reshape", "permute", "select", "slice",
        "unsqueeze", "squeeze", "clone", "copy", "_to_copy", "to", "detach", "alias",
        "empty", "zeros", "ones", "full", "fill", "lift", "scalar_tensor", "arange",
        "broadcast", "contiguous", "stack", "cat", "index", "gather", "lift_fresh", "t")
# Of those, the ones that keep each element where it is
SAME_PLACE = ("clone", "copy", "_to_copy", "to", "detach", "alias", "contiguous",
              "lift", "lift_fresh")


def _is(base: str, words: tuple) -> bool:
    return any(base == word or base.startswith(word + "_") for word in words)


def count_elementwise(fn, *args, **kwargs) -> tuple:
    """(result, ops): run fn and count the operations its result needs.

    Every arithmetic, comparison, select or transcendental aten op counts
    one for each of its output elements that is needed; views, copies,
    casts and fills count nothing. Need is found backward from the
    result, whose every element is needed: an elementwise op needs the
    elements of its inputs that its needed elements read, a select
    (torch.where) its condition and, element by element, only the branch
    it takes, and a view or a gather the elements it moves. So the branch
    a select drops is not counted, and an op that several uses share
    counts once. An op of another form (a reduction, a product of
    matrices) needs every input element once any output element is
    needed."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    calls = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            calls.append((func, args, kwargs or {}, out))
            return out

    with Record():
        result = fn(*args, **kwargs)

    need: dict = {}
    alive = []     # every tensor marked, so that no id is reused

    def tensors(tree) -> list:
        return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]

    def mark(tensor, mask) -> None:
        if tensor.shape != mask.shape:
            try:
                mask = mask.to(torch.int64).sum_to_size(tensor.shape) > 0
            except RuntimeError:
                mask = torch.full(tensor.shape, bool(mask.any()))
        prior = need.get(id(tensor))
        need[id(tensor)] = mask if prior is None else prior | mask
        alive.append(tensor)

    def mark_all(inputs) -> None:
        for tensor in inputs:
            mark(tensor, torch.ones(tensor.shape, dtype=torch.bool))

    def moved(func, args, kwargs, mask) -> bool:
        """A view or gather: run it on element numbers in place of its
        data, and mark the elements its needed outputs came from."""
        first, placed = 0, []
        data_only_first = _is(func.__name__.split(".")[0], ("index", "gather"))

        def number(x):
            nonlocal first
            if not isinstance(x, torch.Tensor):
                return x
            numbers = torch.arange(first, first + x.numel(), dtype=torch.float64).reshape(x.shape)
            placed.append((x, first))
            first += x.numel()
            return numbers

        if data_only_first:
            swapped = (number(args[0]), *args[1:])
        else:
            swapped = tuple([number(y) for y in x] if isinstance(x, (list, tuple)) else number(x)
                            for x in args)
        try:
            source = func(*swapped, **kwargs)
        except Exception:
            return False
        if not isinstance(source, torch.Tensor) or source.shape != mask.shape:
            return False
        wanted = source[mask].to(torch.int64)
        for tensor, start in placed:
            local = wanted - start
            local = local[(local >= 0) & (local < tensor.numel())]
            hit = torch.zeros(tensor.numel(), dtype=torch.bool)
            hit[local] = True
            mark(tensor, hit.reshape(tensor.shape))
        return True

    for tensor in tensors(result):
        mark(tensor, torch.ones(tensor.shape, dtype=torch.bool))
    ops = 0
    for func, args, kwargs, out in reversed(calls):
        outs = tensors(out)
        masks = [need.pop(id(t)) for t in outs if id(t) in need]
        if not masks:
            continue
        base = func.__name__.split(".")[0].rstrip("_")
        inputs = tensors((args, kwargs))
        free = _is(base, FREE)
        if len(outs) != 1:
            ops += 0 if free else sum(t.numel() for t in outs)
            mark_all(inputs)
            continue
        mask, shape = masks[0], outs[0].shape
        ops += 0 if free else int(mask.sum())
        if base == "where" and len(args) == 3:
            condition = torch.broadcast_to(args[0], shape)
            mark(args[0], mask)
            for branch, taken in ((args[1], condition), (args[2], ~condition)):
                if isinstance(branch, torch.Tensor):
                    mark(branch, mask & taken)
        elif free and not _is(base, SAME_PLACE):
            if not moved(func, args, kwargs, mask):
                mark_all(inputs)
        elif all(torch.broadcast_shapes(t.shape, shape) == shape for t in inputs):
            for tensor in inputs:
                mark(tensor, mask)
        else:
            mark_all(inputs)
    return result, ops

def card() -> dict:
    """The card's name and power limit from nvidia-smi (empty without it)."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
    name, _, limit = line.partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}
