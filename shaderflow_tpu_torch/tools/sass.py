"""
What the compiler made of a CUDA C++ kernel of the port: its registers and
spills from ptxas's report (nvcc's `-Xptxas -v` output, which
`build.ptxas_report` reads), and the instructions a step of its hottest loop
from its SASS (`cuobjdump -sass` on the built library).

    python -m shaderflow_tpu_torch.tools.sass LIBRARY.so NAME-PART [NAME-PART ...]

The hottest loop of a kernel is the innermost loop (a backward branch with
no other backward branch inside it) that touches no memory and holds the
most instructions of its work opcodes; its steps are those instructions
over a step's count. By default the work is float products and sums and a
step is K3's escape step (ESCAPE_STEP_FLOPS: 4 products, 4 sums); T2's
chain counts MUFU (one square root an element and round) over the
elements a thread holds, so a step is a round (bench_dtype.compiled). The
loop's packed bfloat16 arithmetic (HADD2, HMUL2, HFMA2 with a BF16
modifier) is counted apart. The parsing is plain text: the CPU tests feed
it recorded text, the tools run it where the CUDA toolkit is.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ESCAPE_STEP_FLOPS = 8
SASS_BYTES = 16          # one Hopper instruction
_MEMORY = {"LDG", "STG", "LD", "ST", "LDL", "STL", "ATOM", "ATOMG", "RED"}
_FLOPS = ("FADD", "FMUL")
_PACKED = {"HADD2", "HMUL2", "HFMA2"}


def _matching(names, parts: tuple[str, ...]) -> str:
    found = [name for name in names if all(part in name for part in parts)]
    if len(found) != 1:
        raise ValueError(f"{len(found)} functions match {parts}: {found or sorted(names)}")
    return found[0]


def ptxas_figures(log: str, *parts: str) -> dict:
    """ptxas's report for the one entry function whose mangled name holds
    every part -> {function, n_regs, spill_stores, spill_loads} (bytes)."""
    blocks = {}
    for block in re.split(r"(?=ptxas info\s*: Compiling entry function )", log):
        match = re.match(r"ptxas info\s*: Compiling entry function '([^']+)'", block)
        if match:
            blocks[match.group(1)] = block
    name = _matching(blocks, parts)
    regs = re.search(r"Used (\d+) registers", blocks[name])
    spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", blocks[name])
    if regs is None or spills is None:
        raise ValueError(f"no register or spill line for {name} in the ptxas report")
    return {"function": name, "n_regs": int(regs.group(1)),
            "spill_stores": int(spills.group(1)), "spill_loads": int(spills.group(2))}


def functions(sass: str) -> dict[str, list[tuple[int, str]]]:
    """`cuobjdump -sass` text -> {mangled function name: [(address,
    instruction), ...]}."""
    found: dict[str, list[tuple[int, str]]] = {}
    current = None
    for line in sass.splitlines():
        header = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if header:
            current = found.setdefault(header.group(1), [])
            continue
        instruction = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;", line)
        if instruction and current is not None:
            current.append((int(instruction.group(1), 16), instruction.group(2).strip()))
    return found


def _mnemonic(instruction: str) -> str:
    """The opcode with its modifiers: `@!P0 FSETP.GT.AND P0, ...` -> FSETP.GT.AND."""
    words = instruction.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0] if words else ""


def _opcode(instruction: str) -> str:
    """The base opcode: `@!P0 FSETP.GT.AND P0, ...` -> FSETP."""
    return _mnemonic(instruction).split(".")[0]


def bf16x2(instruction: str) -> bool:
    """Packed bfloat16 arithmetic: `HFMA2.BF16_V2 R0, R1, R2, -RZ`."""
    opcode, *modifiers = _mnemonic(instruction).split(".")
    return opcode in _PACKED and any(modifier.startswith("BF16") for modifier in modifiers)


def hot_loop(instructions: list[tuple[int, str]], work=_FLOPS,
             per_step: float = ESCAPE_STEP_FLOPS) -> dict:
    """The hottest loop of one function's instructions (the most `work`
    opcodes) -> {loop_instructions, loop_steps (its work over per_step),
    instructions_per_step, bf16x2 (packed bfloat16 arithmetic in the loop),
    ops (opcode counts in the loop)}."""
    loops = []
    for address, instruction in instructions:
        if _opcode(instruction) == "BRA":
            targets = re.findall(r"0x[0-9a-f]+", instruction)
            if targets and int(targets[-1], 16) <= address:
                loops.append((int(targets[-1], 16), address))
    innermost = [(start, end) for start, end in loops
                 if not any((s, e) != (start, end) and start <= s and e <= end
                            for s, e in loops)]
    best = None
    for start, end in innermost:
        body = [text for address, text in instructions if start <= address <= end]
        ops = Counter(_opcode(text) for text in body)
        amount = sum(ops[op] for op in work)
        if amount and not any(ops[op] for op in _MEMORY) and (best is None or amount > best[0]):
            best = (amount, (end - start) // SASS_BYTES + 1, ops, sum(map(bf16x2, body)))
    if best is None:
        raise ValueError(f"no memory-free innermost loop with {'/'.join(work)}")
    amount, count, ops, packed = best
    steps = amount / per_step
    return {"loop_instructions": count, "loop_steps": steps,
            "instructions_per_step": count / steps, "bf16x2": packed,
            "ops": dict(sorted(ops.items()))}


def cuobjdump() -> str:
    from shaderflow_tpu_torch.build import nvcc
    return str(Path(nvcc()).with_name("cuobjdump"))


def dump(library: Path) -> str:
    """`cuobjdump -sass` of a built library."""
    return subprocess.run([cuobjdump(), "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def step_figures(sass: str, *parts: str, work=_FLOPS,
                 per_step: float = ESCAPE_STEP_FLOPS) -> dict:
    """The hot loop of the one function whose mangled name holds every part."""
    table = functions(sass)
    name = _matching(table, parts)
    return {"function": name, **hot_loop(table[name], work, per_step)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("library")
    parser.add_argument("parts", nargs="+")
    args = parser.parse_args()
    print(json.dumps(step_figures(dump(Path(args.library)), *args.parts)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
