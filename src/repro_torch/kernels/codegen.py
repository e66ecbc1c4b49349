"""Generate straight-line CUDA for ``deficit_sum``, one function per design,
and for the stage-1 window features of ``core.factor.STAGE1_SITES``.

The paper's circuit as integer bit operations, as the TPU kernel evaluates
it; the CUDA-core kernel (csrc/approx_matmul.cu) reads the same function
from a table (``kernels.approx_matmul.correction_table``), and this module
is the circuit's record and check. Rather than transcribe the reduction
tree by hand, it runs the port's own ``core.deficit.deficit_sum``
on a symbolic integer class that records every ``>>``, ``&``, ``|``, ``^``,
``+``, ``-``, ``*`` and comparison into a program, then prints the program
as a ``__device__`` function. Identical sub-expressions are shared, nodes
that do not reach the result are dropped, and a shift by a constant is
printed as a multiplication (a left shift of a negative value is undefined
in C++; some designs have negative deficits).

``interpret`` evaluates a recorded program with numpy under C's int32
semantics, so the CPU tests can hold the emitted code to ``deficit_sum``
over all 2^16 operand pairs without a CUDA compiler.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np

from repro_torch.core import compressors as C
from repro_torch.core import deficit as D
from repro_torch.core.factor import STAGE1_SITES

# operand of a node: ("v", node index) or ("k", python int constant)
Operand = Tuple[str, int]

_C_OPS = {"add": "+", "sub": "-", "mul": "*", "and": "&", "or": "|",
          "xor": "^", "shr": ">>", "ge": ">=", "eq": "=="}
_NP_OPS = {
    "add": np.add, "sub": np.subtract, "mul": np.multiply,
    "and": np.bitwise_and, "or": np.bitwise_or, "xor": np.bitwise_xor,
    "shr": np.right_shift,
    "ge": lambda a, b: (a >= b).astype(np.int32),
    "eq": lambda a, b: (a == b).astype(np.int32),
}


class Program:
    """Nodes 0 and 1 are the inputs ``a`` and ``b``; every later node is
    ``(op, lhs, rhs)``."""

    def __init__(self):
        self.nodes: List[Tuple[str, Operand, Operand]] = [
            ("in", ("k", 0), ("k", 0)), ("in", ("k", 1), ("k", 1))]
        self._memo: Dict[Tuple[str, Operand, Operand], int] = {}
        self.out: Operand = ("k", 0)

    def node(self, op: str, lhs: Operand, rhs: Operand) -> Operand:
        key = (op, lhs, rhs)
        if key not in self._memo:
            self._memo[key] = len(self.nodes)
            self.nodes.append(key)
        return ("v", self._memo[key])

    def live(self) -> List[int]:
        """Indices of the non-input nodes the result depends on, in order."""
        seen = set()
        stack = [self.out]
        while stack:
            kind, i = stack.pop()
            if kind != "v" or i in seen or i < 2:
                continue
            seen.add(i)
            _, lhs, rhs = self.nodes[i]
            stack += [lhs, rhs]
        return sorted(seen)

    @property
    def n_ops(self) -> int:
        return len(self.live())


Value = Union["Sym", int]


class Sym:
    """A symbolic int that records the operations applied to it."""
    __slots__ = ("prog", "ref")

    def __init__(self, prog: Program, ref: Operand):
        self.prog = prog
        self.ref = ref

    def _bin(self, op: str, other: Value, swap: bool = False) -> Value:
        rhs = other.ref if isinstance(other, Sym) else ("k", int(other))
        lhs = self.ref
        if swap:
            lhs, rhs = rhs, lhs
        if op == "mul" and ("k", 0) in (lhs, rhs):
            return 0
        if op == "mul" and rhs == ("k", 1):
            return Sym(self.prog, lhs)
        if op in ("add", "sub", "shr") and rhs == ("k", 0):
            return Sym(self.prog, lhs)
        return Sym(self.prog, self.prog.node(op, lhs, rhs))

    def __add__(self, o): return self._bin("add", o)
    def __radd__(self, o): return self._bin("add", o, True)
    def __sub__(self, o): return self._bin("sub", o)
    def __rsub__(self, o): return self._bin("sub", o, True)
    def __mul__(self, o): return self._bin("mul", o)
    def __rmul__(self, o): return self._bin("mul", o, True)
    def __and__(self, o): return self._bin("and", o)
    def __rand__(self, o): return self._bin("and", o, True)
    def __or__(self, o): return self._bin("or", o)
    def __ror__(self, o): return self._bin("or", o, True)
    def __xor__(self, o): return self._bin("xor", o)
    def __rxor__(self, o): return self._bin("xor", o, True)
    def __rshift__(self, o): return self._bin("shr", o)
    def __ge__(self, o): return self._bin("ge", o)

    def __lshift__(self, o: int):
        return self._bin("mul", 1 << int(o))

    def __eq__(self, o):  # comparisons yield a 0/1 int, as in C
        return self._bin("eq", o)

    __hash__ = None


def record(design: str) -> Program:
    """Run ``deficit_sum`` symbolically and return its program."""
    if design not in C.DESIGNS:
        raise KeyError(f"unknown design {design!r}")
    prog = Program()
    out = D.deficit_sum(Sym(prog, ("v", 0)), Sym(prog, ("v", 1)), design)
    prog.out = out.ref if isinstance(out, Sym) else ("k", int(out))
    return prog


def interpret(prog: Program, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Evaluate ``prog`` elementwise in int32, as the emitted C does."""
    vals: Dict[int, np.ndarray] = {0: np.asarray(a, np.int32),
                                   1: np.asarray(b, np.int32)}

    def get(opnd: Operand):
        kind, i = opnd
        return vals[i] if kind == "v" else np.int32(i)

    for i in prog.live():
        op, lhs, rhs = prog.nodes[i]
        vals[i] = _NP_OPS[op](get(lhs), get(rhs)).astype(np.int32)
    out = get(prog.out)
    return np.broadcast_to(out, np.broadcast(a, b).shape).astype(np.int32)


def emit_function(name: str, prog: Program) -> str:
    def ref(opnd: Operand) -> str:
        kind, i = opnd
        if kind == "k":
            return str(i)
        return "a" if i == 0 else "b" if i == 1 else f"t{i}"

    lines = [f"__device__ __forceinline__ int {name}(int a, int b) {{"]
    for i in prog.live():
        op, lhs, rhs = prog.nodes[i]
        lines.append(f"  const int t{i} = {ref(lhs)} {_C_OPS[op]} "
                     f"{ref(rhs)};")
    lines.append(f"  return {ref(prog.out)};")
    lines.append("}")
    return "\n".join(lines)


def designs() -> Tuple[str, ...]:
    """Design order; a design's index is its id in the generated header."""
    return tuple(C.DESIGNS)


def emit_stage1() -> str:
    """Bit s of a feature mask is the AND of the 4-bit window of site s;
    the correction of a pair is the sum of 2^col over the sites where both
    operands' windows are all ones (bit s of ``fx & fw``)."""
    def feats(side: int) -> str:
        return " | ".join(f"((((m >> {site[side]}) & 15) == 15) << {s})"
                          for s, site in enumerate(STAGE1_SITES))
    corr = " + ".join(f"(((f >> {s}) & 1) << {col})"
                      for s, (col, _, _) in enumerate(STAGE1_SITES))
    return "\n".join([
        "__device__ __forceinline__ int stage1_x_features(int m) {",
        f"  return {feats(1)};", "}",
        "__device__ __forceinline__ int stage1_w_features(int m) {",
        f"  return {feats(2)};", "}",
        "__device__ __forceinline__ int stage1_correction(int f) {",
        f"  return {corr};", "}"])


def emit_header() -> str:
    """``deficit_gen.cuh``: ``deficit_fn<D>(a, b)`` for every design D and
    the stage-1 feature functions."""
    parts = ["// Generated by repro_torch/kernels/codegen.py from "
             "core/deficit.py; do not edit.",
             "#pragma once",
             f"#define DEFICIT_N_DESIGNS {len(designs())}",
             "template <int D> __device__ __forceinline__ int "
             "deficit_fn(int a, int b);"]
    for idx, name in enumerate(designs()):
        prog = record(name)
        parts.append(f"// design {idx}: {name} ({prog.n_ops} integer ops)")
        parts.append(emit_function(f"deficit_{name}", prog))
        parts.append(f"template <> __device__ __forceinline__ int "
                     f"deficit_fn<{idx}>(int a, int b) {{ "
                     f"return deficit_{name}(a, b); }}")
    parts.append(emit_stage1())
    return "\n".join(parts) + "\n"


def write_header(directory: Path) -> Path:
    path = Path(directory) / "deficit_gen.cuh"
    text = emit_header()
    if not path.exists() or path.read_text() != text:
        path.write_text(text)
    return path
