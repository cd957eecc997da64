"""Read an optimised HLO module: which buffers leave a fusion.

`unfused_buffers` lists the instructions outside fusion computations (so in
the entry computation, loop bodies and other called computations) whose
result holds at least ``min_elements`` elements: the arrays that are written
to device memory between kernels. A bank correlator that XLA fuses fully has
none of ``[K, N]`` size.
"""

from __future__ import annotations

import math
import re

_COMP = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.+?)\s+([\w\-]+)\(")
_SHAPE = re.compile(r"[a-z]+\d*\[([\d,]*)\]")
_CALLS = re.compile(r"calls=%?([\w.\-]+)")
_SKIP = {"parameter", "get-tuple-element", "tuple", "bitcast", "constant",
         "while", "conditional", "call"}


def unfused_buffers(hlo_text: str, min_elements: int) -> list[tuple[str, str, str]]:
    """``(computation, instruction, shape)`` of each large unfused buffer."""
    computations: dict[str, list[tuple[str, str, str]]] = {}
    fused: set[str] = set()
    current = None
    for line in hlo_text.splitlines():
        m = _COMP.match(line)
        if m and not line[:1].isspace():
            current = m.group(1)
            computations[current] = []
            continue
        if current is None:
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        name, shape, op = m.groups()
        computations[current].append((name, shape, op))
        if op == "fusion":
            fused.update(_CALLS.findall(line))
    found = []
    for comp, instrs in computations.items():
        if comp in fused:
            continue
        for name, shape, op in instrs:
            if op in _SKIP:
                continue
            for dims in _SHAPE.findall(shape):
                size = math.prod(int(d) for d in dims.split(",") if d)
                if size >= min_elements:
                    found.append((comp, name, shape))
                    break
    return found
