"""Instructions per operand pair, read from a kernel's machine code (SASS).

The bound of an approximate body counts the integer instructions that
depend on both operands of a multiply-accumulate: the work that no reuse
of a staged operand removes. The program ``kernels/codegen.py`` records
counts two-input operations, but nvcc merges them (three-input ``LOP3``
and ``IADD3``, ``LEA``, ``IMAD`` with an addend) and may add others, so
the count is taken from what the compiler emitted.

``pair_ops`` takes the kernel's loop that reads shared memory most often
(one contraction step of the register tile, or one rank-1 factor), tags
the value of every shared-memory load in it, carries the tags through
registers and predicates, and counts the arithmetic instructions whose
inputs carry the tags of two or more loads: those that combine an x
operand with a w operand. A shared load whose address already combines
two loads is a table lookup: it is counted apart, and its value keeps the
tags of its address. A load issued for the next trip is followed by
reading the loop twice and counting the second trip; between the two, the
tags of values derived from one load are kept and those of loop-carried
sums (the accumulators) dropped.

The listing comes from the CUDA toolkit's ``cuobjdump -sass`` of the
built library (``dump``).
"""
from __future__ import annotations

import dataclasses
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Tuple

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_REG = re.compile(r"\bU?R\d+\b|\bU?P\d\b")
_PRED = re.compile(r"U?P\d|U?PT")
_CONST_REGS = ("RZ", "PT", "URZ", "UPT")

# opcodes that write no register
_NO_DEST = ("ST", "BRA", "BAR", "NOP", "EXIT", "RET", "CALL", "BSSY",
            "BSYNC", "WARPSYNC", "DEPBAR", "RED", "MEMBAR", "YIELD")
# opcodes that move data or steer control rather than compute
_NOT_ALU = _NO_DEST + ("LD", "ATOM", "S2R", "S2UR", "CS2R")
# comparisons write a predicate pair; every later predicate is an input
_TWO_PRED_DEST = ("ISETP", "FSETP", "PLOP3", "DSETP", "HSETP2")


@dataclasses.dataclass(frozen=True)
class Instr:
    addr: int
    opcode: str                 # with modifiers, e.g. "LOP3.LUT"
    dests: Tuple[str, ...]
    srcs: Tuple[str, ...]
    guarded: bool               # written only where its predicate holds
    target: Optional[int]       # a branch's target address


def _nvbin(tool: str) -> str:
    found = shutil.which(tool)
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / tool
    if not path.exists():
        raise RuntimeError(f"{tool} not found: reading SASS needs the CUDA "
                           "toolkit")
    return str(path)


def dump(lib: Path) -> str:
    """``cuobjdump -sass`` of a built library."""
    proc = subprocess.run([_nvbin("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True)
    return proc.stdout


def _split_operands(text: str) -> List[str]:
    out, depth, cur = [], 0, ""
    for ch in text:
        depth += (ch in "[(") - (ch in "])")
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return out + [cur.strip()] if cur.strip() else out


def _widen(reg: str, opcode: str) -> List[str]:
    """A destination register and those a 64- or 128-bit result adds."""
    n = (4 if ".128" in opcode
         else 2 if ".64" in opcode or ".WIDE" in opcode else 1)
    m = re.fullmatch(r"(U?R)(\d+)", reg)
    if n == 1 or not m:
        return [reg]
    return [f"{m.group(1)}{int(m.group(2)) + i}" for i in range(n)]


def parse_instr(addr: int, text: str) -> Instr:
    """One instruction of the listing, e.g. ``@!P0 IMAD.MOV R27, RZ, RZ,
    R36``: its written registers and predicates and the ones it reads."""
    guard: List[str] = []
    if text.startswith("@"):
        g, text = text.split(None, 1)
        guard = _REG.findall(g)
    opcode, _, rest = text.partition(" ")
    ops = _split_operands(rest)
    target = None
    if opcode.startswith("BRA"):
        m = re.search(r"0x[0-9a-f]+", rest)
        target = int(m.group(0), 16) if m else None
    n_dest = 0
    if ops and not opcode.startswith(_NO_DEST):
        # the first operand, then the predicates (carry or comparison
        # outputs) that directly follow it
        n_dest = 1
        limit = 2 if opcode.startswith(_TWO_PRED_DEST) else len(ops)
        while (n_dest < min(limit, len(ops))
               and _PRED.fullmatch(ops[n_dest])):
            n_dest += 1
    dests = [r for op in ops[:n_dest] for r in _widen(op, opcode)
             if _REG.fullmatch(r)]
    srcs = guard + [r for op in ops[n_dest:] for r in _REG.findall(op)]
    return Instr(addr, opcode, tuple(dests), tuple(srcs), bool(guard),
                 target)


def functions(sass: str) -> Dict[str, List[Instr]]:
    """Each kernel of a ``cuobjdump -sass`` listing, by mangled name."""
    out: Dict[str, List[Instr]] = {}
    cur: Optional[List[Instr]] = None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSTR.match(line)
        if m and cur is not None:
            cur.append(parse_instr(int(m.group(1), 16), m.group(2)))
    return out


def inner_loop(instrs: List[Instr]) -> List[Instr]:
    """The loop (the span of a backward branch) without a barrier that
    reads shared memory most often, the shortest of those: the contraction
    step, not an epilogue's loop over a few staged sums."""
    loops = []
    for br in instrs:
        if br.target is not None and br.target <= br.addr:
            body = [x for x in instrs if br.target <= x.addr <= br.addr]
            ops = [x.opcode for x in body]
            if (any(o.startswith("LDS") for o in ops)
                    and not any(o.startswith("BAR") for o in ops)):
                loops.append(body)
    if not loops:
        raise ValueError("no loop over shared-memory loads found")
    return min(loops, key=lambda body: (
        -sum(x.opcode.startswith("LDS") for x in body), len(body)))


def _width(opcode: str) -> int:
    """32-bit values a shared load brings: 4 for LDS.128, 2 for LDS.64."""
    return 4 if ".128" in opcode else 2 if ".64" in opcode else 1


def pair_ops(loop: List[Instr]) -> Tuple[int, int, int]:
    """(arithmetic instructions that combine two loaded values, 32-bit
    operand values loaded from shared memory, table lookups) in one trip
    of ``loop``."""
    tags: Dict[str, FrozenSet[int]] = {}
    count = loads = lookups = 0
    for trip in (0, 1):
        if trip:
            tags = {r: t for r, t in tags.items() if len(t) == 1}
        for i, ins in enumerate(loop):
            srcs = frozenset().union(*(tags.get(r, frozenset())
                                       for r in ins.srcs))
            if ins.opcode.startswith("LDS") and len(srcs) >= 2:
                tag: FrozenSet[int] = srcs
                lookups += trip
            elif ins.opcode.startswith("LDS"):
                tag = frozenset((i,))
                loads += trip * _width(ins.opcode)
            else:
                tag = srcs
                count += (trip and len(srcs) >= 2
                          and not ins.opcode.startswith(_NOT_ALU))
            for r in ins.dests:
                if r in _CONST_REGS:
                    continue
                # a predicated write may keep the old value
                tags[r] = tag | tags.get(r, frozenset()) if ins.guarded \
                    else tag
    return count, loads, lookups


def ops_per_pair(loop: List[Instr], tile: Tuple[int, int],
                 loads_per_operand: int = 1) -> Tuple[float, float]:
    """(arithmetic instructions, table lookups) per (x, w) pair: a step of
    a TM x TN register tile loads ``loads_per_operand`` values of each of
    its TM + TN operands and covers TM * TN pairs; an unrolled loop covers
    several steps."""
    count, loads, lookups = pair_ops(loop)
    tm, tn = tile
    per_step = (tm + tn) * loads_per_operand
    if loads == 0 or loads % per_step:
        raise ValueError(f"{loads} shared values per trip is not a whole "
                         f"number of {tm}x{tn} tile steps")
    pairs = loads // per_step * tm * tn
    return count / pairs, lookups / pairs
