"""Unit-gate hardware proxy for paper Tables 3/4 (a numpy copy of the JAX
package's ``core/hwproxy.py``).

The paper's numbers come from Cadence Genus at 90 nm, which this
reproduction does not run, so Tables 3 and 4 are reproduced with a
standard unit-gate model (area/energy units per gate, delay = weighted
critical-path depth). The model's job is to recover the
paper's *orderings and relative deltas* (e.g. proposed vs exact compressor
energy); benchmarks print proxy and paper values side by side and report
rank correlation. Constants below are the conventional unit-gate weights
(Strollo et al. use the same style of analysis).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

# gate -> (area, delay, energy) in unit-gate units
GATE = {
    "INV":   (0.5, 0.5, 0.5),
    "NAND2": (1.0, 1.0, 1.0),
    "NOR2":  (1.0, 1.0, 1.0),
    "AND2":  (1.5, 1.5, 1.5),
    "OR2":   (1.5, 1.5, 1.5),
    "XOR2":  (2.0, 2.0, 2.0),
    "XNOR2": (2.0, 2.0, 2.0),
    "AO222": (2.5, 1.5, 2.5),   # AND-OR compound (paper Fig. 3)
    "AOI22": (2.0, 1.5, 2.0),
    "MUX2":  (2.0, 1.5, 2.0),
    "NAND3": (1.5, 1.2, 1.5),
}


@dataclasses.dataclass(frozen=True)
class Netlist:
    name: str
    gates: Dict[str, int]            # gate type -> count
    critical_path: Tuple[str, ...]   # gate types along the critical path

    @property
    def area(self) -> float:
        return sum(GATE[g][0] * n for g, n in self.gates.items())

    @property
    def delay(self) -> float:
        return sum(GATE[g][1] for g in self.critical_path)

    @property
    def energy(self) -> float:
        # switching-energy proxy: total gate energy weighted by activity 0.5
        return 0.5 * sum(GATE[g][2] * n for g, n in self.gates.items())

    @property
    def pdp(self) -> float:
        return self.energy * self.delay


FA = Netlist("FA", {"XOR2": 2, "AND2": 2, "OR2": 1}, ("XOR2", "XOR2"))
HA = Netlist("HA", {"XOR2": 1, "AND2": 1}, ("XOR2",))

# 4:2 compressor netlists. Gate inventories follow each paper's description;
# where the paper gives only the critical path, the inventory is the minimal
# cover of the published equations.
COMPRESSORS: Dict[str, Netlist] = {
    # two chained FAs + cin/cout wiring (paper Fig. 1)
    "exact": Netlist("exact", {"XOR2": 4, "AND2": 4, "OR2": 2},
                     ("XOR2", "XOR2", "XOR2")),
    # paper Fig. 3: A,C = NOR; B,D = NAND; carry = NAND(B,D) | NOR(A,C);
    # sum = AO222 network; critical path NOR2-NAND2-INV-INV-AO222.
    "proposed": Netlist("proposed",
                        {"NOR2": 3, "NAND2": 3, "INV": 3, "AO222": 2,
                         "OR2": 1},
                        ("NOR2", "NAND2", "INV", "INV", "AO222")),
    # [18]-D1: single-error, XOR-heavy (Yang/Han/Lombardi DFTS'15)
    "single_error_18": Netlist("single_error_18",
                               {"XOR2": 3, "AND2": 3, "OR2": 2, "INV": 1},
                               ("XOR2", "XOR2", "OR2")),
    # [19]-D1 Kong&Li: single-error, mux-based
    "single_error_19d1": Netlist("single_error_19d1",
                                 {"XOR2": 2, "MUX2": 2, "AND2": 2, "OR2": 1},
                                 ("XOR2", "MUX2", "MUX2")),
    # [19]-D5 Kong&Li: optimized single-error
    "single_error_19d5": Netlist("single_error_19d5",
                                 {"XOR2": 1, "MUX2": 1, "NAND2": 2, "NOR2": 2,
                                  "INV": 1},
                                 ("XOR2", "MUX2",)),
    # [16]-D1 Kumari: single-error, NAND-based
    "single_error_16d1": Netlist("single_error_16d1",
                                 {"NAND2": 4, "NOR2": 2, "INV": 2, "AO222": 1,
                                  "OR2": 1},
                                 ("NAND2", "NOR2", "INV", "AO222")),
    # [17]-D3 Strollo: single-error, larger but fast carry
    "single_error_17d3": Netlist("single_error_17d3",
                                 {"XOR2": 4, "MUX2": 2, "AND2": 3, "OR2": 2,
                                  "INV": 2},
                                 ("XOR2", "MUX2", "OR2")),
    # [12]: parity sum + (x1|x2)(x3|x4) carry, input reordering
    "design12": Netlist("design12",
                        {"XOR2": 3, "OR2": 2, "AND2": 1, "INV": 1},
                        ("XOR2", "XOR2", "OR2")),
    # [15] CAAM: two XORs + OR/AND carry
    "design15": Netlist("design15",
                        {"XOR2": 2, "OR2": 2, "AND2": 2},
                        ("XOR2", "OR2")),
    # [16]-D2: OR/AND only
    "design16_d2": Netlist("design16_d2",
                           {"OR2": 3, "AND2": 2},
                           ("OR2", "AND2")),
    # [17]-D2
    "design17_d2": Netlist("design17_d2",
                           {"XOR2": 2, "AND2": 2, "OR2": 2},
                           ("XOR2", "OR2", "OR2")),
    # [13]: XOR + NOR critical path, minimal area
    "design13": Netlist("design13",
                        {"XOR2": 1, "NOR2": 2, "NAND2": 1, "INV": 1},
                        ("XOR2", "NOR2")),
}

# Paper Table 3 values for side-by-side reporting: (area um^2, power uW,
# delay ps, pdp fJ, error numerator /256)
PAPER_TABLE3 = {
    "exact":             (43.90, 1.99, 436, 0.867, 0),
    "single_error_18":   (50.17, 2.39, 469, 0.852, 1),
    "single_error_19d1": (44.68, 1.86, 383, 0.713, 1),
    "single_error_19d5": (28.22, 1.17, 297, 0.347, 1),
    "single_error_16d1": (34.49, 1.20, 226, 0.291, 1),
    "single_error_17d3": (76.82, 3.02, 307, 0.827, 1),
    "design12":          (49.74, 1.83, 374, 0.684, 19),
    "design15":          (25.87, 1.02, 175, 0.179, 16),
    "design16_d2":       (19.60, 0.71, 104, 0.074, 55),
    "design17_d2":       (31.36, 1.37, 308, 0.422, 4),
    "design13":          (14.11, 0.52, 139, 0.072, 70),
    "proposed":          (30.57, 1.12, 237, 0.265, 1),
}


# functional alias: generic single-error compressors share a netlist class
COMPRESSORS["single_error"] = COMPRESSORS["single_error_16d1"]


def multiplier_proxy(compressor: str) -> Dict[str, float]:
    """Unit-gate metrics for the all-approximate 8x8 multiplier built from
    `compressor`: 15 compressors (7 stage-1 + 8 stage-2), 2 FA + 5 HA in the
    tree, 64 AND pp generators, and a 12-position final carry-propagate
    adder (10 FA + 2 HA)."""
    comp = COMPRESSORS[compressor]
    n_comp, n_fa, n_ha = 15, 2 + 10, 5 + 2
    area = (n_comp * comp.area + n_fa * FA.area + n_ha * HA.area
            + 64 * GATE["AND2"][0])
    energy = (n_comp * comp.energy + n_fa * FA.energy + n_ha * HA.energy
              + 0.5 * 64 * GATE["AND2"][2])
    # delay: pp AND -> stage1 comp -> stage2 comp -> ripple (~10 FA)
    delay = (GATE["AND2"][1] + 2 * comp.delay + 10 * FA.delay)
    return {"area": area, "energy": energy, "delay": delay,
            "pdp": energy * delay}


# ---------------------------------------------------------------------------
# MSR/truncation-family proxies (core/truncation.py backends)
# ---------------------------------------------------------------------------

# 8-bit leading-one detector: priority chain (inverted higher bits ANDed
# into each position, OR-encoded). Unit-gate inventory of the classic
# LOD-8 cell.
LOD8 = Netlist("LOD8", {"INV": 8, "AND2": 8, "OR2": 7},
               ("INV", "AND2", "OR2", "OR2", "OR2"))


def _mux_bank(n_bits: int, stages: int) -> Dict[str, float]:
    """Barrel-shifter proxy: `stages` MUX2 levels over an `n_bits` word."""
    n = n_bits * stages
    return {"area": n * GATE["MUX2"][0],
            "energy": 0.5 * n * GATE["MUX2"][2],
            "delay": stages * GATE["MUX2"][1]}


def array_multiplier_proxy(bits_a: int, bits_b: int) -> Dict[str, float]:
    """Unit-gate metrics for an exact `bits_a` x `bits_b` array
    multiplier: bits_a*bits_b AND pp generators, (bits_a-1)(bits_b-1) FA
    + (bits_a-1) HA in the array, ripple critical path of
    bits_a + bits_b - 2 FAs after the pp AND."""
    n_fa = (bits_a - 1) * (bits_b - 1)
    n_ha = bits_a - 1
    n_and = bits_a * bits_b
    area = n_fa * FA.area + n_ha * HA.area + n_and * GATE["AND2"][0]
    energy = (n_fa * FA.energy + n_ha * HA.energy
              + 0.5 * n_and * GATE["AND2"][2])
    delay = GATE["AND2"][1] + (bits_a + bits_b - 2) * FA.delay
    return {"area": area, "energy": energy, "delay": delay,
            "pdp": energy * delay}


def truncation_proxy(kind: str) -> Dict[str, float]:
    """Unit-gate metrics for one MSR/truncation-family datapath.

    Like `multiplier_proxy`, these recover orderings and relative deltas,
    not absolute silicon numbers:

      msr4    5x8 array core (5-bit decoded weight x exact activation)
              plus a 2-stage output barrel shifter over the 13-bit
              product. MSR detection/encode runs once per weight tensor
              offline, so it is amortized out of the per-MAC figure.
      drum6   two LOD8 + 2-stage operand shifters feeding a 6x6 core,
              plus a 3-stage output shifter restoring the 2*t scale.
      posneg  LOD/shift on both operands, a 4x4 core for positive product
              classes and a 6x6 core for negative ones; only one core
              switches per product (activity-weighted 0.5 each), plus the
              sign-class select (sign XOR + output mux).
    """
    if kind == "msr4":
        core = array_multiplier_proxy(5, 8)
        shift = _mux_bank(13, 2)
        area = core["area"] + shift["area"]
        energy = core["energy"] + shift["energy"]
        delay = core["delay"] + shift["delay"]
    elif kind == "drum6":
        core = array_multiplier_proxy(6, 6)
        op = {k: 2 * (getattr(LOD8, k) + _mux_bank(6, 2)[k])
              for k in ("area", "energy")}
        out = _mux_bank(12, 3)
        area = core["area"] + op["area"] + out["area"]
        energy = core["energy"] + op["energy"] + out["energy"]
        # the two operand paths run in parallel: one LOD+shift in the path
        delay = (LOD8.delay + _mux_bank(6, 2)["delay"]
                 + core["delay"] + out["delay"])
    elif kind == "posneg":
        core4 = array_multiplier_proxy(4, 4)
        core6 = array_multiplier_proxy(6, 6)
        op = {k: 2 * (getattr(LOD8, k) + _mux_bank(6, 2)[k])
              for k in ("area", "energy")}
        sel = {"area": GATE["XOR2"][0] + 12 * GATE["MUX2"][0],
               "energy": 0.5 * (GATE["XOR2"][2] + 12 * GATE["MUX2"][2]),
               "delay": GATE["MUX2"][1]}
        area = core4["area"] + core6["area"] + op["area"] + sel["area"]
        energy = (0.5 * (core4["energy"] + core6["energy"])
                  + op["energy"] + sel["energy"])
        delay = (LOD8.delay + _mux_bank(6, 2)["delay"]
                 + core6["delay"] + sel["delay"])
    else:
        raise KeyError(f"unknown truncation proxy kind {kind!r}")
    return {"area": area, "energy": energy, "delay": delay,
            "pdp": energy * delay}
