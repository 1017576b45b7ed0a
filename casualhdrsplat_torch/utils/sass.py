"""What a built kernel executes, read from its SASS (`cuobjdump -sass`).

`functions(path)` lists every kernel of a shared library or a cubin with
its instructions; `element_mix` counts the instruction classes that bound
an elementwise kernel (the special-function unit's MUFU.EX2, .RCP and .LG2;
FFMA, FMUL, FADD; SHFL; LDS; and all instructions) over one pass of its
hot loop, per element the pass serves.  `floors_ms` turns such a mix into
the least time the SMs' MUFU pipes and issue slots need for a number of
elements.  Used by chip_smoke.py and casualhdrsplat_torch/crf_compare.py
on the card's machine, where the CUDA toolkit is installed.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from collections import Counter

_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTRUCTION = re.compile(
    r"^\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")
CLASSES = ("MUFU.EX2", "MUFU.RCP", "MUFU.LG2", "FFMA", "FMUL", "FADD", "SHFL", "LDS", "all")
# per SM and clock on compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput): MUFU results, and warp instructions
# issued (one per sub-partition) times 32 threads
MUFU_PER_CLOCK, ISSUE_PER_CLOCK = 16, 4 * 32


def find_cuobjdump() -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found: reading SASS needs the CUDA toolkit")
    return tool


def parse(listing: str) -> dict:
    """{function: [(address, predicated, opcode, operands), ...]} of a
    `cuobjdump -sass` listing."""
    out, current = {}, None
    for line in listing.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = _INSTRUCTION.match(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), bool(m.group(2)), m.group(3),
                            m.group(4).strip()))
    return out


def functions(path) -> dict:
    """Every kernel's instructions in a shared library or cubin at `path`."""
    proc = subprocess.run([find_cuobjdump(), "-sass", str(path)], capture_output=True,
                          text=True, check=True)
    return parse(proc.stdout)


def _loops(instrs):
    """(first, last) address of every loop: a predicated branch back."""
    loops = []
    for addr, predicated, op, operands in instrs:
        if op.startswith("BRA") and not op.startswith("BRA.DIV") and predicated:
            target = _TARGET.findall(operands)
            if target and int(target[-1], 16) < addr:
                loops.append((int(target[-1], 16), addr))
    return loops


def _class(op: str):
    if op.startswith("MUFU."):
        return op if op in CLASSES else "MUFU"
    head = op.split(".")[0]
    return head if head in CLASSES else None


def element_mix(instrs, elements_per_pass: float, inner_trips: int = 1) -> dict:
    """Instructions a thread executes per element, by class: the widest
    loop's body (the whole function if it has none), an instruction inside
    m loops nested in it counted inner_trips^m times, over the elements
    one thread's pass serves (a fraction where lanes share an element)."""
    loops = _loops(instrs)
    weights = {}
    if loops:
        lo, hi = max(loops, key=lambda r: r[1] - r[0])
        inner = [r for r in loops if r != (lo, hi) and lo <= r[0] and r[1] <= hi]
        for addr, *_ in instrs:
            if lo <= addr <= hi:
                weights[addr] = inner_trips ** sum(a <= addr <= b for a, b in inner)
    else:
        weights = {addr: 1 for addr, *_ in instrs}
    counts = Counter()
    for addr, _, op, _ in instrs:
        if addr in weights:
            counts["all"] += weights[addr]
            cls = _class(op)
            if cls:
                counts[cls] += weights[addr]
    return {cls: counts[cls] / elements_per_pass for cls in CLASSES}


def find(funcs: dict, *parts: str):
    """The one function whose (mangled) name holds every string of parts."""
    hits = [name for name in funcs if all(p in name for p in parts)]
    if len(hits) != 1:
        raise KeyError(f"{parts}: {len(hits)} functions match of {sorted(funcs)}")
    return funcs[hits[0]]


def floors_ms(mix: dict, elements: int, sms: int, clock_hz: float) -> dict:
    """The least time for `elements` at this mix: MUFU operations over the
    SMs' special-function rate, and all instructions over their issue
    rate."""
    mufu = sum(v for k, v in mix.items() if k.startswith("MUFU"))
    return {"mufu_floor_ms": mufu * elements / (MUFU_PER_CLOCK * sms * clock_hz) * 1e3,
            "issue_floor_ms": mix["all"] * elements / (ISSUE_PER_CLOCK * sms * clock_hz) * 1e3}
