#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printing its seconds:

1. device   require CUDA, print the card's name and power limit, and turn
            TF32 off for float32 matmuls and cuDNN convolutions;
2. build    compile the CUDA kernels with nvcc for sm_90a from the
            repository's sources (src/repro_torch/kernels/csrc, one nvcc
            per source, in parallel), read from their SASS the
            integer instructions and table lookups the CUDA-core body
            spends per operand pair (the operation counts of its bound),
            and require int8 tensor-core instructions in the tensor-core
            kernel's SASS;
3. kernels  hold every kernel entry and variant to its plain PyTorch
            version on the card, bitwise: all 256 x 256 int8 byte pairs at
            K = 1 against the numpy product tables (rank1 for the proposed
            design and design13, deficit under all 7 designs), ragged and
            batched shapes across the tile seams of both kernels (K past
            one staged x slab of the tensor-core kernel too; rows across
            the CUDA-core kernel's row tiles, K split into slices with a
            ragged last one, ragged N), an int32 sum past 2^31 through a
            67-slice split of K, and the LeNet-5, Keras CNN and FFDNet
            layer shapes (the suites' FFDNet too) and smollm-135m's
            decode (4 slots of one row) and prefill shapes; hold every backend's
            int32 output to the JAX
            package's (src/repro_torch/testdata/reference.npz); time each
            entry (fused_matmul[exact] in turns with torch._int_mm), its
            kernel's device time under torch.profiler, for the CUDA-core
            entries the plan (tiles, K slices), and for the tensor-core
            entries the build of their weight operands; K2[deficit]'s
            device time on uniform, constant and post-ReLU operands (what
            the table lookups' bank conflicts cost);
4. lenet5   eval_classifier on 500 synthetic digits with the fixture's
            JAX-trained weights under bf16, int8_exact and every approx
            backend: each CUDA backend's accuracy equals its oracle's, the
            deficit kernel's logits equal approx_lut's bit for bit, the
            unfused route (kernels K1, K3) equals the fused one bit for bit,
            and the oracles' accuracies equal the JAX package's; one
            batch's forward timed and traced as in phase 5; the Keras CNN
            (random weights) under each CUDA backend equals its oracle;
5. ffdnet   eval_denoiser on 16 64x64 textures at sigma 25 with the
            full-width FFDNet (depth 8, width 64) under the three CUDA
            backends, fused and unfused, and their oracles: outputs equal
            bit for bit; each forward timed FORWARD_REPS times, and one
            traced with torch.profiler for its device time;
6. suites   the paper's four result suites through repro_torch.eval's
            runners at their paper-scale budgets: metrics and hw equal the
            committed experiments/eval tables; mnist (LeNet-5, 300 QAT
            steps on 5,000 digits, 500 test digits) and denoise (FFDNet
            depth 6, width 32, 150 QAT steps on 64x64 textures, 16 images
            at sigma 25 and 50) train on the card and sweep bf16, all 15
            backends and two multiplier variants: the training loss falls,
            bf16 LeNet-5 scores at least 90 %, every *_pallas row equals
            its oracle's and every MSR core row its *_lut row, and each
            CUDA backend's logits and denoised images from the trained
            weights at the suites' sizes equal its oracle's bit for bit;
            one LeNet-5
            train_step through the deficit kernel (STE, qat=False) gives
            the gradients of the same step under approx_lut, bit for bit;
            ms per training step (CUDA events at each batch), one profiled
            step, cuDNN deterministic against not, and each sweep point's
            seconds; the artifacts are written to build/torch_eval/;
7. serve    full-width smollm-135m (30 layers, d_model 576, vocab
            49152, 134.5 M bf16 parameters from the port's own init at
            seed 0) through repro_torch.serve.Engine, continuous batching
            with the paged prefix cache, on the JAX package's serve-suite
            workload (8 requests into 4 slots, max_len 112, an 8-token
            shared prefix): under bf16, int8_exact, the oracles approx_lut
            and approx_stage1 and the three CUDA backends. Each CUDA
            backend's served tokens and every logits row it sampled from
            equal its oracle's bit for bit; approx_stage1_pallas unfused
            (kernel K1) equals its fused run; the probe request (admitted
            mid-decode on a prefix-cache hit) served alone on a cold engine
            gives the same tokens; the prefix hit rate is above 0; one
            decode step launches 211 kernels (7 projections x 30 layers +
            the head). Each backend serves the workload twice (the tokens
            must agree); per run, ms per decode step (median, host clock
            around each step, synchronized), TTFT and tokens/s. Per
            backend, a fixed-shape decode step of the 4-slot pool timed
            over 20 calls (median and quartiles) and one profiled call's
            busy ms, port-kernel ms and idle share; the rank1 operand
            build at the head. Then ``python -m
            repro_torch.serve --backend approx_deficit_pallas`` runs once;
8. launch counts, set to 0 before each of phases 4, 5 and 6 (the suite
   runners' calls) and 7 (the served runs) and read after it: LeNet-5 and
   FFDNet each launch every entry but fused_matmul[exact], the suites
   every fused entry, the serve path K2[deficit], K2[stage1], K4 and
   (unfused) K1[stage1];
9. one JSON line each ``{"suites": {...}}``, ``{"serve": {...}}`` and
   ``{"kernels": [...]}``;
then the ``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "src" / "repro_torch" / "testdata" / "reference.npz"
DETAIL = ROOT / "build" / "chip_smoke_detail.json"
EVAL_OUT = ROOT / "build" / "torch_eval"
COMMITTED_EVAL = ROOT / "experiments" / "eval"
CUDA_CORE_SOURCE = "src/repro_torch/kernels/csrc/approx_matmul.cu"
TC_SOURCE = "src/repro_torch/kernels/csrc/tc_matmul.cu"

# Published H100 SXM rates, at the 700 W limit (NVIDIA data sheet): device
# memory, int8 tensor cores. The data sheet gives no rate for 32-bit
# integer work on the CUDA cores. Each SM has 64
# INT32 lanes, but IMAD issues on the FP32 pipe, so integer work is capped
# only by issue: 4 schedulers x 32 lanes per clock per SM. 132 SMs x 128
# lanes x 1.98 GHz (the boost clock behind the data sheet's 67 TFLOP/s
# float32) = 33.5 T operations/s, which keeps the bound a lower bound.
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12
INT_ISSUE_OPS_PER_S = 132 * 128 * 1.98e9
# Shared memory answers 32 lanes (one 4-byte bank each) per clock per SM:
# at most one table lookup per lane per clock, at the same clock.
LDS_LOOKUPS_PER_S = 132 * 32 * 1.98e9

# Logits of the two stacks agree within this share of their range: the
# int8 codes and int32 accumulators are bitwise equal, the float32 pools
# and epilogues may round differently in the last place (same bound as
# tests/test_torch_fixture.py).
LOGIT_RTOL = 2e-3

# (entry, variant, Pallas entry it replaces, file:line of its pallas_call)
ROWS = (
    ("approx_matmul", "deficit", "src/repro/kernels/approx_matmul.py:265"),
    ("approx_matmul", "stage1", "src/repro/kernels/approx_matmul.py:265"),
    ("fused_matmul", "deficit", "src/repro/kernels/approx_matmul.py:317"),
    ("fused_matmul", "stage1", "src/repro/kernels/approx_matmul.py:317"),
    ("fused_matmul", "exact", "src/repro/kernels/approx_matmul.py:317"),
    ("rank1_matmul", "rank1", "src/repro/kernels/approx_matmul.py:382"),
    ("rank1_fused_matmul", "rank1",
     "src/repro/kernels/approx_matmul.py:428"),
)
TC_VARIANTS = ("exact", "rank1")      # bodies of the tensor-core kernel
# Tile seams of the tensor-core kernel: 64-row warpgroups in 128-row
# blocks, 8-column MMA tiles and block widths 8/16/32/64, 32-byte MMA steps
# over K and over K * R, K past one staged x slab (1,024 columns), and
# rows of 1, 4 and 16-byte multiples (its three copy widths).
TC_SEAMS = {"seam(65,25,4)": (1, 65, 25, 4), "seam(129,45,9)": (1, 129, 45, 9),
            "seam(2x65,150,8)": (2, 65, 150, 8),
            "seam(129,25,33)": (1, 129, 25, 33),
            "seam(129,2051,9)": (1, 129, 2051, 9),
            "seam(65,1300,17)": (1, 65, 1300, 17)}
# Seams of the CUDA-core kernel's plans: rows across its row tiles (4, 8,
# 16, 32, 64), K across its split slices (whole steps of 32, the last
# ragged), N across its column tiles (16, 32, 64) and ragged.
CUDA_CORE_SEAMS = {"cc(1,577,65)": (1, 1, 577, 65),
                   "cc(5,31,4)": (1, 5, 31, 4),
                   "cc(9,1536,192)": (1, 9, 1536, 192),
                   "cc(17,3136,10)": (1, 17, 3136, 10),
                   "cc(2x33,575,17)": (2, 33, 575, 17),
                   "cc(63,33,1)": (1, 63, 33, 1),
                   "cc(65,1,576)": (1, 65, 1, 576),
                   "cc(3,4100,33)": (1, 3, 4100, 33)}
# an int32 sum that passes 2^31 (every operand 127) through a split of K
WRAP_SHAPE = (1, 140_000, 65)
# The variants the LeNet-5 and FFDNet paths (phases 4, 5) must each launch:
# no caller of the JAX package (nor of the port) selects fused_matmul's
# "exact" variant.
PATH_VARIANTS = [r[:2] for r in ROWS if r[1] != "exact"]
# the suites' sweeps take the fused route of each CUDA backend
SUITE_VARIANTS = [("fused_matmul", "deficit"), ("fused_matmul", "stage1"),
                  ("rank1_fused_matmul", "rank1")]
# the serve phase: per-token (for_lm) routes of the CUDA backends, fused,
# and approx_stage1_pallas once unfused
SERVE_VARIANTS = SUITE_VARIANTS + [("approx_matmul", "stage1")]

LENET_LAYERS = {  # (B, M, K, N) of each quantized matmul at batch 50
    "lenet5.c1": (50, 784, 25, 6), "lenet5.c2": (50, 196, 150, 16),
    "lenet5.fc1": (1, 50, 784, 120), "lenet5.fc2": (1, 50, 120, 84),
    "lenet5.fc3": (1, 50, 84, 10)}
KERAS_LAYERS = {  # the Keras CNN (models/cnn.py) at batch 50
    "keras.c1": (50, 784, 9, 32), "keras.c2": (50, 196, 288, 64),
    "keras.fc1": (1, 50, 3136, 128), "keras.fc2": (1, 50, 128, 10)}
FFDNET_LAYERS = {  # 16 images of 64x64 -> 32x32 after pixel_unshuffle
    "ffdnet.in": (16, 1024, 45, 64), "ffdnet.mid": (16, 1024, 576, 64),
    "ffdnet.out": (16, 1024, 576, 4)}
LAYERS = {**LENET_LAYERS, **KERAS_LAYERS, **FFDNET_LAYERS}
SUITE_LAYERS = {  # the denoise suite's FFDNet (depth 6, width 32), 16 images
    "suite.ffdnet.in": (16, 1024, 45, 32),
    "suite.ffdnet.mid": (16, 1024, 288, 32),
    "suite.ffdnet.out": (16, 1024, 288, 4)}
SERVE_LAYERS = {  # smollm-135m: a decode step of 4 slots, one prefill
    "smollm.decode.q": (4, 1, 576, 576), "smollm.decode.kv": (4, 1, 576, 192),
    "smollm.decode.up": (4, 1, 576, 1536),
    "smollm.decode.down": (4, 1, 1536, 576),
    "smollm.decode.head": (4, 1, 576, 49152),
    "smollm.prefill.up": (1, 32, 576, 1536)}
TIMED_LAYER = "ffdnet.mid"
FORWARD_REPS = 10


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(msg)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"== phase {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"phase {self.name}: {time.perf_counter() - self.t0:.1f} s",
                  flush=True)
        return False


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise RuntimeError("run chip_smoke.py from a checkout of the "
                           "repository (src/repro_torch is missing)")
    sys.path.insert(0, str(ROOT / "src"))
    detail: dict = {}

    with Phase("device"):
        smi = smi_line()
        print(f"card: {smi}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print("TF32 off for float32 matmuls and cuDNN convolutions")
        detail["card"] = smi

    from repro_torch.kernels import approx_matmul as K
    with Phase("build"):
        t0 = time.perf_counter()
        lib, log = K.build()
        K._lib()
        print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        for ln in regs:
            print(f"  {ln}")
        detail["ptxas"] = regs
        from repro_torch.kernels import sass as SASS
        sass = SASS.dump(lib)
        ops = sass_ops_per_pair(K, sass)
        detail["ops_per_pair_sass"] = ops
        print("per pair, instructions that combine x and w and table "
              "lookups (SASS): " + ", ".join(
                  f"{k} {v['alu']:g} + {v['lookups']:g}"
                  for k, v in ops.items()))
        detail["tc_mma_sass"] = tc_mma_count(sass)
        print("int8 tensor-core instructions in tc_mm_kernel (SASS): "
              + ", ".join(f"{k} {v}" for k, v in
                          detail["tc_mma_sass"].items()))

    with Phase("kernels"):
        rows = kernels_phase(torch, K, detail, ops)

    paths = {}          # each path's own launch counts
    for name, run in (("lenet5", lenet5_phase), ("ffdnet", ffdnet_phase)):
        K.reset_launch_counts()
        with Phase(name):
            run(torch, detail)
        paths[name] = launch_counts(K)
    with Phase("suites"):
        suites, paths["suites"] = suites_phase(torch, detail, "cuda",
                                               smoke=False)
    with Phase("serve"):
        serve, paths["serve"] = serve_phase(torch, detail, "cuda", full=True,
                                            ops=ops)

    with Phase("launches"):
        for name, var, _ in ROWS:
            print(f"launches {name}[{var}]: " + ", ".join(
                f"{path} {c[(name, var)]}" for path, c in paths.items()))
        for path, counts in paths.items():
            need = {"suites": SUITE_VARIANTS, "serve": SERVE_VARIANTS}.get(
                path, PATH_VARIANTS)
            for name, var in need:
                check(counts[(name, var)] > 0,
                      f"{name}[{var}] was not launched on the {path} path")
        detail["launches"] = {
            path: {f"{name}[{var}]": n for (name, var), n in c.items()}
            for path, c in paths.items()}
        for row in rows:
            key = (row.pop("_entry"), row.pop("_variant"))
            row["launches_by_path"] = {p: c[key] for p, c in paths.items()}
            row["launches"] = sum(row["launches_by_path"].values())
        detail["launches_per_forward"] = per_forward_launches(torch, K)
        for key, n in detail["launches_per_forward"].items():
            print(f"launches per forward {key}: {n}")

    DETAIL.parent.mkdir(parents=True, exist_ok=True)
    DETAIL.write_text(json.dumps(detail, indent=1))
    print(json.dumps({"suites": suites}, separators=(",", ":")))
    print(json.dumps({"serve": serve}, separators=(",", ":")))
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def launch_counts(K) -> dict:
    return {(name, var): getattr(K, name).variant_launches[var]
            for name, var, _ in ROWS}


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _call(K, name, variant, x, w, scale, bias, relu, plain,
          design="proposed"):
    """One entry/variant, kernel or plain version (same arguments)."""
    fn = getattr(K, f"{name}_plain" if plain else name)
    if name == "approx_matmul":
        return fn(x.reshape(-1, x.shape[-1]), w, design, kernel=variant)
    if name == "fused_matmul":
        return fn(x, w, scale, bias, design, variant=variant, relu=relu)
    if name == "rank1_matmul":
        return fn(x.reshape(-1, x.shape[-1]), w, design)
    return fn(x, w, scale, bias, design, relu=relu)   # rank1_fused_matmul


def _operands(torch, gen, b, m, k, n, dev):
    x = torch.randint(-127, 128, (b, m, k), generator=gen,
                      dtype=torch.int8).to(dev)
    w = torch.randint(-127, 128, (k, n), generator=gen,
                      dtype=torch.int8).to(dev)
    scale = (torch.rand((1, n), generator=gen) * 1e-3).to(dev)
    bias = torch.randn((1, n), generator=gen).to(dev)
    return x, w, scale, bias


def _ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _ms_turns(torch, f, g, reps: int) -> tuple:
    """Kernel-event ms of ``f`` and ``g`` timed in turns (f, g, g, f),
    each the mean of its two turns."""
    a1, b1, b2, a2 = (_ms(torch, h, reps) for h in (f, g, g, f))
    return (a1 + a2) / 2, (b1 + b2) / 2


def _device_ms(torch, calls, reps: int) -> list:
    """Mean device ms of the port's kernel in ``reps`` runs of each of
    ``calls``, from one torch.profiler session; each run must launch
    exactly one. One stream runs the kernels in launch order, so the
    session's spans fall into the calls' groups in order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA and _ours(e.name))
    check(len(spans) == reps * len(calls),
          f"{len(spans)} kernel spans in {reps * len(calls)} calls")
    return [sum(hi - lo for lo, hi in spans[i:i + reps]) / reps / 1e3
            for i in range(0, len(spans), reps)]


def _ours(name: str) -> bool:
    return "approx_mm_kernel" in name or "tc_mm_kernel" in name


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.


def _bound(name, variant, rows, k, n, fac, ops) -> tuple:
    """(bound_ms, bound_by): the larger of the entry's operand/result
    bytes (x and w read once, the output written once) over the memory
    rate and the operations over the card's rate for them. EXACT is one
    int8 MAC per pair and RANK1 1 + R * nd (the exact dot and one per
    factor and digit plane), on the int8 tensor cores. The weight planes
    RANK1's wrapper builds (nd * K * R * N bytes) are its own choice of
    operand, not the function's work: their build is timed apart
    (``operands_ms``) and their stream given as ``_planes_ms``. The
    CUDA-core bodies count their SASS per pair: the integer instructions
    over the issue rate, or the table lookups over shared memory's lookup
    rate, whichever takes longer."""
    fused = name in ("fused_matmul", "rank1_fused_matmul")
    nbytes = rows * k + k * n + rows * n * 4 + (2 * n * 4 if fused else 0)
    macs = rows * k * n
    if variant == "exact":
        t_ops = 2 * macs / INT8_TC_OPS_PER_S
    elif variant == "rank1":
        t_ops = 2 * macs * (1 + fac.R * fac.n_digits) / INT8_TC_OPS_PER_S
    else:
        t_ops = macs * max(ops[variant]["alu"] / INT_ISSUE_OPS_PER_S,
                           ops[variant]["lookups"] / LDS_LOOKUPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _planes_ms(k, n, fac) -> float:
    """Milliseconds to stream RANK1's weight planes (nd * K * R * N int8)
    once from memory: what the wrapper's choice of operand adds on top of
    the function's bound."""
    return fac.n_digits * k * fac.R * n / HBM_BYTES_PER_S * 1e3


def sass_ops_per_pair(K, sass) -> dict:
    """Per CUDA-core function, the integer instructions and the table
    lookups per (x, w) pair that combine the two operands, counted in the
    SASS of the kernel's full 64 x 64 tile (kernels/sass.py): the work per
    multiply-accumulate that no operand reuse removes. The kernel stages
    three values per operand; both functions run its one body."""
    from repro_torch.kernels import sass as SASS
    src = K.SOURCE.read_text()
    tm, tx = (int(re.search(rf"constexpr int {t} = (\d+);", src).group(1))
              for t in ("TM", "TX"))
    fns = SASS.functions(sass)
    tag = "approx_mm_kernelILi64ELi64EE"
    name = [f for f in fns if tag in f]
    check(len(name) == 1, f"no single kernel {tag} in the SASS")
    alu, lookups = SASS.ops_per_pair(SASS.inner_loop(fns[name[0]]),
                                     (tm, 64 // tx), 3)
    check(lookups == 1, f"{lookups} table lookups a pair in {tag}")
    return {var: {"alu": alu, "lookups": lookups} for var in K.CUDA_CORE}


def tc_mma_count(sass) -> dict:
    """Int8 tensor-core instructions (IGMMA, the int8 wgmma; IMMA under
    mma.sync) in each instantiation of tc_mm_kernel; fails unless every
    one has some."""
    from repro_torch.kernels import sass as SASS
    fns = {f: ins for f, ins in SASS.functions(sass).items()
           if "tc_mm_kernel" in f}
    check(len(fns) > 0, "no tc_mm_kernel in the SASS")
    out = {}
    for f, ins in sorted(fns.items()):
        n = sum(i.opcode.startswith(("IMMA", "IGMMA")) for i in ins)
        check(n > 0, f"{f}: no int8 tensor-core instruction in its SASS")
        body, bn = re.search(r"tc_mm_kernelILi(\d+)ELi(\d+)E", f).groups()
        out[f"tc_mm_kernel<{body},{bn}>"] = n
    return out


def kernels_phase(torch, K, detail, ops):
    from repro_torch.core import luts
    from repro_torch.core import factor as F
    from repro_torch.core.multiplier import proposed_multiplier
    from repro_torch.kernels import codegen
    from repro_torch.quant import matmul as QM
    from repro_torch.quant.quantize import QuantConfig

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    fac = F.factorize("proposed")

    # all 256 x 256 byte pairs at K = 1 against the numpy tables
    b = torch.arange(256, dtype=torch.int32).to(torch.int8)
    xs, ws = b.reshape(256, 1).to(dev), b.reshape(1, 256).to(dev)
    lut = luts.signed_product_lut(proposed_multiplier())
    sv = np.where(np.arange(256) < 128, np.arange(256), np.arange(256) - 256)
    sgn = np.sign(sv)[:, None] * np.sign(sv)[None, :]
    st1 = QM.stage1_exhaustive_products()[np.abs(sv)[:, None],
                                          np.abs(sv)[None, :]] * sgn
    tables = {"deficit": lut, "rank1": lut, "stage1": st1,
              "exact": sv[:, None] * sv[None, :]}
    one = torch.ones((1, 256), device=dev)
    zero = torch.zeros((1, 256), device=dev)
    pairs_ok = {}
    for name, var, _ in ROWS:
        out = _call(K, name, var, xs, ws, one, zero, False, plain=False)
        want = torch.as_tensor(tables[var].astype(np.float64))
        check(torch.equal(out.double().cpu(), want),
              f"{name}[{var}] differs from the product table on 2^16 pairs")
        pairs_ok[(name, var)] = True
    lut13 = luts.signed_product_lut(proposed_multiplier("design13"))
    for name in ("rank1_matmul", "rank1_fused_matmul"):
        out = _call(K, name, "rank1", xs, ws, one, zero, False, False,
                    design="design13")
        check(torch.equal(out.double().cpu(),
                          torch.as_tensor(lut13.astype(np.float64))),
              f"{name}[design13] differs from its product table on 2^16 "
              "pairs")
    for design in codegen.designs():      # each design's correction table
        lut_d = torch.as_tensor(luts.signed_product_lut(
            proposed_multiplier(design)).astype(np.float64))
        for name in ("approx_matmul", "fused_matmul"):
            out = _call(K, name, "deficit", xs, ws, one, zero, False, False,
                        design=design)
            check(torch.equal(out.double().cpu(), lut_d),
                  f"{name}[deficit] {design} differs from its product table "
                  "on 2^16 pairs")
    print("all 2^16 byte pairs match the product tables for every entry "
          "(rank1 under design13 too, deficit under every design)")

    # fixture: every backend's int32 output equals the JAX package's
    with np.load(FIXTURE) as data:
        i = 0
        while f"x{i}" in data.files:
            x = torch.from_numpy(data[f"x{i}"]).to(dev)
            w = torch.from_numpy(data[f"w{i}"]).to(dev)
            for be in QM.list_backends():
                got = QM.integer_matmul(x, w, QuantConfig(backend=be))
                check(np.array_equal(got.cpu().numpy(),
                                     data[f"out{i}_{be}"]),
                      f"{be} differs from the JAX fixture at shape "
                      f"{tuple(x.shape)}x{tuple(w.shape)}")
            i += 1
    print(f"fixture: {len(QM.list_backends())} backends x {i} shapes "
          "bitwise equal to the JAX package")

    # ragged, batched and real layer shapes: kernel == plain, bitwise
    shapes = {"ragged(1000,577,65)": (1, 1000, 577, 65),
              "ragged(3,1,1)": (1, 3, 1, 1),
              "batched(4,333,150,70)": (4, 333, 150, 70),
              **TC_SEAMS, **CUDA_CORE_SEAMS, **LAYERS, **SUITE_LAYERS,
              **SERVE_LAYERS}
    errs = {r[:2]: 0.0 for r in ROWS}
    per_layer, timed = [], []
    for label, (bb, m, k, n) in shapes.items():
        x, w, scale, bias = _operands(torch, gen, bb, m, k, n, dev)
        for name, var, _ in ROWS:
            designs = (("proposed", "design13") if var == "rank1"
                       and label in TC_SEAMS else ("proposed",))
            for relu in ((False, True) if "fused" in name else (False,)):
                for design in designs:
                    args = (K, name, var, x, w, scale, bias, relu)
                    got = _call(*args, False, design)
                    want = _call(*args, True, design)
                    err = _max_err(got, want)
                    errs[(name, var)] = max(errs[(name, var)], err)
                    check(got.dtype == want.dtype and torch.equal(got, want),
                          f"{name}[{var}] {design} relu={relu} differs from "
                          f"its plain version at {label}: max |diff| {err}")
            if label in LAYERS or label in SERVE_LAYERS:
                kern = functools.partial(_call, K, name, var, x, w, scale,
                                         bias, False, False)
                pms = _ms(torch, lambda: _call(K, name, var, x, w, scale,
                                               bias, False, True), 2)
                lib = operands_ms = None
                if var == "exact" and k % 8 == 0 and n % 8 == 0 \
                        and bb * m > 16:
                    x2 = x.reshape(-1, k)
                    ref = torch._int_mm(x2, w)
                    acc = K.fused_matmul(x2, w, torch.ones_like(scale),
                                         torch.zeros_like(bias),
                                         variant="exact")
                    check(torch.equal(acc, ref.float()),
                          f"fused_matmul[exact] differs from torch._int_mm "
                          f"at {label}")
                    kms, lib = _ms_turns(torch, kern,
                                         lambda: torch._int_mm(x2, w), 5)
                else:
                    kms = _ms(torch, kern, 5)
                if var == "exact":
                    operands_ms = _ms(torch,
                                      lambda: K.exact_weight_operand(w), 5)
                elif var == "rank1":
                    operands_ms = _ms(torch, lambda: (
                        K.exact_weight_operand(w),
                        K.rank1_weight_planes(w)), 5)
                bound, by = _bound(name, var, bb * m, k, n, fac, ops)
                timed.append(kern)
                per_layer.append({
                    "layer": label, "entry": name, "variant": var,
                    "shape": [bb, m, k, n], "kernel_ms": kms,
                    "plain_ms": pms, "library_ms": lib,
                    "operands_ms": operands_ms,
                    "bound_ms": bound, "bound_by": by,
                    **({"planes_ms": _planes_ms(k, n, fac)}
                       if var == "rank1" else {}),
                    **({"plan": dataclasses.asdict(K.plan(bb * m, k, n))}
                       if var in K.CUDA_CORE else {})})
        print(f"  {label}: every entry equals its plain version")
        del x, w, scale, bias
        torch.cuda.empty_cache()       # the head's plain rank1 takes ~22 GB
    wrap_check(torch, K, dev)
    data_rows, data_calls = table_data_calls(torch, K, gen)
    # one profiler session: later sessions in one process may see no
    # device events
    for row, ms in zip(per_layer + data_rows,
                       _device_ms(torch, timed + data_calls, 5)):
        row["device_ms"] = ms
    detail["table_data"] = data_rows
    for r in data_rows:
        print(f"  table lookups, {r['layer']} {r['data']}: device "
              f"{r['device_ms']:.4f} ms")
    detail["per_layer"] = per_layer
    for row in per_layer:
        print(f"  {row['layer']:12s} {row['entry']}[{row['variant']}] "
              f"kernel {row['kernel_ms']:.4f} ms  plain "
              f"{row['plain_ms']:.2f} ms  library {row['library_ms']}  "
              f"device {row['device_ms']:.4f} ms  "
              f"operands {row['operands_ms']}  "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
              + (f"  planes {row['planes_ms']:.4f} ms"
                 if "planes_ms" in row else "")
              + (" plan {bm}x{bn}, k slice {k_slice}, {splits} splits"
                 .format(**row["plan"]) if "plan" in row else ""))

    rows = []
    for name, var, replaces in ROWS:
        t = next(r for r in per_layer if r["layer"] == TIMED_LAYER
                 and r["entry"] == name and r["variant"] == var)
        rows.append({
            "name": f"{name}[{var}]", "route": "cuda",
            "source": TC_SOURCE if var in TC_VARIANTS else CUDA_CORE_SOURCE,
            "replaces": replaces, "launches": None,
            "max_abs_err": errs[(name, var)], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"], "pairs_2e16_ok": pairs_ok[(name, var)],
            "device_ms": t["device_ms"],
            **({"operands_ms": t["operands_ms"]}
               if var in TC_VARIANTS else {}),
            "_entry": name, "_variant": var})
    return rows


def wrap_check(torch, K, dev):
    """K1 and K2 (with ReLU and without) of both CUDA-core functions equal
    their plain versions where the int32 sum passes 2^31 and K is split."""
    m, k, n = WRAP_SHAPE
    check(K.plan(m, k, n).splits > 1, f"no split at {WRAP_SHAPE}")
    x = torch.full((m, k), 127, dtype=torch.int8, device=dev)
    w = torch.full((k, n), 127, dtype=torch.int8, device=dev)
    scale = torch.full((1, n), 1e-3, device=dev)
    bias = torch.ones((1, n), device=dev)
    for var in K.CUDA_CORE:
        want = K.approx_matmul_plain(x, w, kernel=var)
        check(bool((want < 0).all()),
              f"{var}: the sum at {WRAP_SHAPE} does not pass 2^31")
        check(torch.equal(K.approx_matmul(x, w, kernel=var), want),
              f"approx_matmul[{var}] differs past 2^31")
        for relu in (False, True):
            check(torch.equal(
                K.fused_matmul(x, w, scale, bias, variant=var, relu=relu),
                K.fused_matmul_plain(x, w, scale, bias, variant=var,
                                     relu=relu)),
                f"fused_matmul[{var}] relu={relu} differs past 2^31")
    print(f"  wrap{WRAP_SHAPE}: sums past 2^31 through {K.plan(m, k, n).splits}"
          " K slices equal the plain versions")


TABLE_DATA_LAYERS = ("ffdnet.mid", "smollm.decode.q")


def table_data_calls(torch, K, gen) -> tuple:
    """Rows and calls for the device ms of K2[deficit] on three kinds of
    operands at each of TABLE_DATA_LAYERS: uniform in [-127, 127]
    (the phase's own), constant (x = w = 77: every lane of a warp reads
    one table word, so no lookup conflicts in the banks), and post-ReLU
    activations against centred weights (x = |N(0, 48)| on half the
    entries, 0 on the rest; w = N(0, 24); both rounded and clipped to
    127)."""
    dev = torch.device("cuda")
    calls, rows = [], []
    for layer in TABLE_DATA_LAYERS:
        bb, m, k, n = LAYERS.get(layer) or SERVE_LAYERS[layer]
        x, w, scale, bias = _operands(torch, gen, bb, m, k, n, dev)
        act = (torch.randn((bb, m, k), generator=gen) * 48).abs() * (
            torch.rand((bb, m, k), generator=gen) < 0.5)
        wgt = torch.randn((k, n), generator=gen) * 24
        data = {
            "uniform": (x, w),
            "constant": (torch.full_like(x, 77), torch.full_like(w, 77)),
            "relu_gauss": tuple(t.round().clamp(-127, 127).to(torch.int8)
                                .to(dev) for t in (act, wgt))}
        for kind, (xd, wd) in data.items():
            calls.append(functools.partial(K.fused_matmul, xd, wd, scale,
                                           bias))
            rows.append({"layer": layer, "data": kind})
    return rows, calls


# ---------------------------------------------------------------------------
# Forward times (phases 4-5)
# ---------------------------------------------------------------------------

def _forward_ms(torch, run, reps: int) -> list:
    """Host milliseconds of ``reps`` calls of ``run``, each ended by a
    synchronize."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _profile_ms(torch, run) -> dict:
    """One call of ``run`` under torch.profiler: its host ms (profiler on),
    the ms in which the card ran anything (kernels, copies, fills; the
    union of their spans) and the ms of the port's kernels (approx_mm and
    tc_mm)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    check(bool(spans), "torch.profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    for lo, hi, _ in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    ours = sum(hi - lo for lo, hi, name in spans if _ours(name))
    return {"wall_ms": wall, "device_busy_ms": busy / 1e3,
            "kernels_ms": ours / 1e3}


def _time_forward(torch, forward, label: str) -> dict:
    """FORWARD_REPS host-timed calls of ``forward`` and one profiled call;
    prints and returns their numbers."""
    ms = _forward_ms(torch, forward, FORWARD_REPS)
    prof = _profile_ms(torch, forward)
    med = statistics.median(ms)
    print(f"    {label}: median {med:.3f} ms, min {min(ms):.3f}, max "
          f"{max(ms):.3f} over {FORWARD_REPS}; profiled: card busy "
          f"{prof['device_busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms, "
          f"port kernels {prof['kernels_ms']:.3f} ms")
    return {"forward_ms": ms, "forward_ms_median": med, **prof}


# ---------------------------------------------------------------------------
# Phase 4: LeNet-5 through eval_classifier
# ---------------------------------------------------------------------------

def fixture_lenet5(dev):
    """The fixture's JAX-trained LeNet-5 weights on ``dev``."""
    from repro_torch.convert import params_from_jax
    tree: dict = {}
    with np.load(FIXTURE) as data:
        for key in data.files:
            if key.startswith("lenet5/"):
                _, layer, leaf = key.split("/")
                tree.setdefault(layer, {})[leaf] = data[key]
    return params_from_jax(tree, device=dev)


CUDA_BACKENDS = ("approx_deficit_pallas", "approx_stage1_pallas",
                 "approx_rank1_pallas")


def lenet5_phase(torch, detail):
    import dataclasses
    from repro_torch.data import synthetic
    from repro_torch.models import cnn as CNN
    from repro_torch.quant import matmul as QM
    from repro_torch.quant.quantize import QuantConfig
    from repro_torch.train import cnn_train as T

    with np.load(FIXTURE) as data:
        jax_ref = {k: data[k] for k in data.files
                   if k.startswith(("logits_", "acc_"))}
    params = fixture_lenet5("cuda")
    batch = torch.from_numpy(synthetic.digits(500, seed=1)[0][:50]).cuda()
    backends = ["bf16"] + list(QM.list_backends())
    logits, acc, times = {}, {}, {}
    for be in backends:
        q = QuantConfig(backend=be)
        lg, labels = T.classifier_logits(params, CNN.lenet5_apply, q)
        logits[be] = lg
        acc[be] = 100.0 * int((lg.argmax(-1) == labels).sum()) / 500
        check(bool(torch.isfinite(lg).all()) and lg.shape == (500, 10),
              f"{be}: bad logits")
        check(acc[be] == T.eval_classifier(params, CNN.lenet5_apply, q),
              f"{be}: eval_classifier disagrees with its logits")
        print(f"  lenet5 {be:22s} acc {acc[be]:.1f}%")

        def forward():
            with torch.inference_mode():
                CNN.lenet5_apply(params, batch, q)

        times[be] = _time_forward(torch, forward, "batch of 50")
    for be in CUDA_BACKENDS:
        oracle = QM.get_backend(be).oracle
        check(acc[be] == acc[oracle],
              f"{be} accuracy {acc[be]} != {oracle} {acc[oracle]}")
        q = dataclasses.replace(QuantConfig(backend=be), fuse_epilogue=False)
        unfused, _ = T.classifier_logits(params, CNN.lenet5_apply, q)
        check(torch.equal(unfused, logits[be]),
              f"{be}: unfused logits differ from fused")
    check(torch.equal(logits["approx_deficit_pallas"], logits["approx_lut"]),
          "approx_deficit_pallas logits differ from approx_lut")
    check(torch.equal(logits["approx_rank1_pallas"], logits["approx_lut"]),
          "approx_rank1_pallas logits differ from approx_lut")
    check(torch.equal(logits["approx_stage1_pallas"],
                      logits["approx_stage1"]),
          "approx_stage1_pallas logits differ from approx_stage1")
    for be in ("int8_exact", "approx_lut", "approx_stage1"):
        want = jax_ref[f"logits_{be}"]
        err = float(np.abs(logits[be][:50].cpu().numpy() - want).max())
        bound = LOGIT_RTOL * float(np.abs(want).max())
        check(err <= bound, f"{be}: logits differ from JAX by {err} > "
                            f"{bound}")
        check(acc[be] == float(jax_ref[f"acc_{be}"]),
              f"{be}: accuracy {acc[be]} != JAX {jax_ref[f'acc_{be}']}")
        print(f"  {be}: max |logit - JAX| {err:.3g} (bound {bound:.3g}), "
              f"accuracy equals JAX's {acc[be]:.1f}%")
    print("  CUDA backends: accuracy equals the oracle's; logits bitwise "
          "equal to the oracle's; unfused (K1, K3) == fused (K2, K4)")
    # the Keras CNN (random weights from a seed): its fc1 contracts over
    # K = 3,136, more than one x slab of the tensor-core kernel
    from repro_torch.nn.module import init_params
    keras = init_params(CNN.keras_cnn_descs(),
                        torch.Generator().manual_seed(0), device="cuda")
    with torch.inference_mode():
        for be in CUDA_BACKENDS:
            q = QuantConfig(backend=be)
            got = CNN.keras_cnn_apply(keras, batch, q)
            want = CNN.keras_cnn_apply(
                keras, batch, QuantConfig(backend=QM.get_backend(be).oracle))
            check(got.shape == (50, 10) and torch.equal(got, want),
                  f"{be}: Keras CNN logits differ from its oracle's")
    print("  Keras CNN, batch of 50: every CUDA backend's logits bitwise "
          "equal to its oracle's")
    detail["lenet5_acc"] = acc
    detail["lenet5_forward"] = times


def per_forward_launches(torch, K) -> dict:
    """Kernel launches of one forward (a LeNet-5 batch of 50, an FFDNet
    batch of 16), per CUDA backend, fused and unfused; read after the main
    path's counts."""
    import dataclasses
    from repro_torch.models import cnn as CNN
    from repro_torch.nn.module import init_params
    from repro_torch.quant.quantize import QuantConfig

    gen = torch.Generator().manual_seed(0)
    lenet = init_params(CNN.lenet5_descs(), gen, device="cuda")
    ffd = init_params(CNN.ffdnet_descs(), gen, device="cuda")
    digits = torch.rand((50, 28, 28, 1), generator=gen).cuda()
    noisy = torch.rand((16, 64, 64, 1), generator=gen).cuda()
    out = {}
    for be in CUDA_BACKENDS:
        for fuse in (True, False):
            q = dataclasses.replace(QuantConfig(backend=be),
                                    fuse_epilogue=fuse)
            for model, run in (
                    ("lenet5", lambda: CNN.lenet5_apply(lenet, digits, q)),
                    ("ffdnet", lambda: CNN.ffdnet_apply(ffd, noisy, 0.1,
                                                        quant=q))):
                K.reset_launch_counts()
                with torch.inference_mode():
                    run()
                n = sum(getattr(K, name).launches for name in
                        ("approx_matmul", "fused_matmul", "rank1_matmul",
                         "rank1_fused_matmul"))
                out[f"{model}/{be}/{'fused' if fuse else 'unfused'}"] = n
    return out


# ---------------------------------------------------------------------------
# Phase 5: full-width FFDNet through eval_denoiser
# ---------------------------------------------------------------------------

def ffdnet_phase(torch, detail):
    import dataclasses
    from repro_torch.eval import image as IQ
    from repro_torch.models import cnn as CNN
    from repro_torch.nn.module import init_params
    from repro_torch.quant import matmul as QM
    from repro_torch.quant.quantize import QuantConfig
    from repro_torch.train import cnn_train as T

    cfg = CNN.FFDNetConfig()
    check((cfg.depth, cfg.width, cfg.channels) == (8, 64, 1),
          f"unexpected FFDNet config {cfg}")
    params = init_params(CNN.ffdnet_descs(cfg),
                         torch.Generator().manual_seed(0), device="cuda")
    sigma = 25.0
    outs, rows = {}, {}
    for be in ("approx_lut", "approx_stage1") + CUDA_BACKENDS:
        q = QuantConfig(backend=be)
        clean, noisy, out = T.denoise(params, cfg, q, sigma=sigma)
        check(out.shape == (16, 64, 64, 1) and bool(torch.isfinite(out)
                                                     .all()),
              f"{be}: bad denoiser output")
        outs[be] = out
        p, s, pn = T.eval_denoiser(params, cfg, q, sigma=sigma)
        check(p == float(IQ.psnr(out, clean)), f"{be}: eval_denoiser "
                                               "disagrees with its output")

        def forward():
            with torch.inference_mode():
                CNN.ffdnet_apply(params, noisy, sigma / 255.0, cfg, q)

        print(f"  ffdnet {be:22s} PSNR {p:.3f} dB  SSIM {s:.4f}  "
              f"(noisy {pn:.3f} dB)")
        rows[be] = {"psnr": p, "ssim": s, "noisy_psnr": pn,
                    **_time_forward(torch, forward, "forward of 16")}
    for be in CUDA_BACKENDS:
        oracle = QM.get_backend(be).oracle
        check(torch.equal(outs[be], outs[oracle]),
              f"{be}: FFDNet output differs from {oracle}")
        q = dataclasses.replace(QuantConfig(backend=be), fuse_epilogue=False)
        _, _, unfused = T.denoise(params, cfg, q, sigma=sigma)
        check(torch.equal(unfused, outs[be]),
              f"{be}: unfused FFDNet output differs from fused")
    print("  CUDA backends: FFDNet outputs bitwise equal to their oracle's, "
          "fused and unfused")
    detail["ffdnet"] = rows


# ---------------------------------------------------------------------------
# Phase 6: the paper's result suites, with QAT training on the card
# ---------------------------------------------------------------------------

SUITE_RUNS = ("metrics", "hw", "mnist", "denoise")
TASK_KEYS = {"mnist": ("acc",), "denoise": ("psnr", "ssim", "noisy_psnr")}
MSR_CORES = ("msr4", "drum6", "posneg")
TIMED_STEPS = 40        # train_step calls per timing turn
WARM_STEPS = 5          # first steps of a run left out of its median


def _sync(torch, dev: str):
    if dev == "cuda":
        torch.cuda.synchronize()


class SuiteRecorder:
    """For the length of a ``with``, wraps the functions of
    repro_torch.train.cnn_train that the suite runners call: each ``fit``
    records its losses and the milliseconds between the batches its loop
    draws (on the card the gaps between CUDA events recorded at each draw,
    so device time with the host's gaps; on the CPU the host clock), and
    each eval call its seconds under its sweep label and its arguments."""

    NAMES = ("fit", "eval_classifier", "eval_denoiser")

    def __init__(self, torch, T, dev: str):
        self.torch, self.T, self.dev = torch, T, dev
        self.fits, self.evals, self.calls = [], {}, []

    def __enter__(self):
        self.saved = {n: getattr(self.T, n) for n in self.NAMES}
        self.T.fit = self._fit
        self.T.eval_classifier = self._timed("eval_classifier")
        self.T.eval_denoiser = self._timed("eval_denoiser")
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.T, n, fn)
        return False

    def _stamp(self):
        if self.dev == "cuda":
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _gaps_ms(self, stamps) -> list:
        if self.dev == "cuda":
            self.torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])]
        return [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]

    def _fit(self, descs, loss_fn, batches, **kw):
        stamps = []

        def drawn():
            for batch in batches:
                stamps.append(self._stamp())
                yield batch

        params, losses = self.saved["fit"](descs, loss_fn, drawn(), **kw)
        stamps.append(self._stamp())
        self.fits.append({"losses": losses,
                          "step_ms": self._gaps_ms(stamps)})
        return params, losses

    def _timed(self, name):
        def run(params, model, quant, **kw):
            _sync(self.torch, self.dev)
            t0 = time.perf_counter()
            out = self.saved[name](params, model, quant, **kw)
            _sync(self.torch, self.dev)
            label = (quant.backend if quant.multiplier == "proposed" else
                     f"{quant.backend}[{quant.multiplier}]")
            if "sigma" in kw:
                label += f" sigma={kw['sigma']:g}"
            self.evals[label] = time.perf_counter() - t0
            self.calls.append((params, model, quant, kw))
            return out
        return run


def check_sweep_rows(name: str, rows: list, QM):
    """Every row finite; every *_pallas row equal to its oracle's row and
    every MSR core row to its *_lut row, in the task columns; bf16
    LeNet-5 at 90 % or more."""
    keys = TASK_KEYS[name]
    sigmas = sorted({r.get("sigma") for r in rows}, key=str)
    check(len(rows) == 18 * len(sigmas), f"{name}: {len(rows)} rows")
    for r in rows:
        check(all(np.isfinite(r[k]) for k in keys), f"{name}: bad row {r}")
    by = {(r["backend"], r.get("sigma")): r for r in rows}
    pairs = [(be, QM.get_backend(be).oracle) for be in QM.list_backends()
             if be.endswith("_pallas") or be in MSR_CORES]
    check(len(pairs) == 6, f"{name}: {len(pairs)} backends with an oracle")
    for be, oracle in pairs:
        for sig in sigmas:
            got = [by[(be, sig)][k] for k in keys]
            want = [by[(oracle, sig)][k] for k in keys]
            check(got == want, f"{name}: {be} row {got} != {oracle} "
                               f"row {want} (sigma {sig})")
    if name == "mnist":
        check(by[("bf16", None)]["acc"] >= 90.0,
              f"bf16 LeNet-5 accuracy {by[('bf16', None)]['acc']} < 90 %")


def check_suite_outputs(torch, name: str, rec: SuiteRecorder, QM) -> int:
    """Replays each of the suite's eval calls under a CUDA backend, with
    the trained weights and the suite's own data and sizes, and under the
    backend's oracle: the logits (mnist) or the unclipped FFDNet output
    (denoise) must be equal bit for bit. Returns the calls compared."""
    import dataclasses
    from repro_torch.models import cnn as CNN
    T = rec.T

    def raw(params, model, quant, kw):
        if name == "mnist":
            return T.classifier_logits(params, model, quant, **kw)[0]
        _, noisy, _ = T.denoise(params, model, quant, **kw)
        with torch.inference_mode():
            return CNN.ffdnet_apply(params, noisy, kw["sigma"] / 255.0,
                                    model, quant)

    n = 0
    for params, model, quant, kw in rec.calls:
        if quant.backend not in CUDA_BACKENDS:
            continue
        oracle = dataclasses.replace(
            quant, backend=QM.get_backend(quant.backend).oracle)
        got, want = raw(params, model, quant, kw), raw(params, model,
                                                      oracle, kw)
        check(got.shape == want.shape and torch.equal(got, want),
              f"{name}: {quant.backend} output differs from "
              f"{oracle.backend}'s at {kw}")
        n += 1
    want_n = len(CUDA_BACKENDS) * (2 if name == "denoise" else 1)
    check(n == want_n, f"{name}: {n} CUDA backend evals, expected {want_n}")
    return n


@contextlib.contextmanager
def cudnn_free(T, torch):
    """Inside, ``T.train_step`` runs under its training numerics with
    cuDNN free to pick its algorithms (deterministic off)."""
    numerics = T.training_numerics

    @contextlib.contextmanager
    def free():
        with numerics():
            torch.backends.cudnn.deterministic = False
            yield

    T.training_numerics = free
    try:
        yield
    finally:
        T.training_numerics = numerics


def _step_ms(torch, dev, step, reps: int) -> list:
    """Host milliseconds of ``reps`` calls of ``step``, each ended by a
    synchronize on the card."""
    out = []
    for _ in range(reps):
        _sync(torch, dev)
        t0 = time.perf_counter()
        step()
        _sync(torch, dev)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def training_checks(torch, detail, dev: str, smoke: bool) -> dict:
    """One LeNet-5 train_step through the deficit kernel (STE, qat=False)
    against the same step under approx_lut, bitwise; then the QAT
    train_step of each suite's model at its batch: ms per step with
    cuDNN deterministic and not (in turns: on, off, off, on), and one
    profiled step's device busy time."""
    import warnings
    from repro_torch.data import synthetic
    from repro_torch.models import cnn as CNN
    from repro_torch.nn.module import init_params
    from repro_torch.optim import adamw as A
    from repro_torch.quant.quantize import BF16, QuantConfig
    from repro_torch.train import cnn_train as T

    imgs, labels = synthetic.digits(64, seed=0)
    lenet_batch = (torch.from_numpy(imgs).to(dev),
                   torch.from_numpy(labels).to(dev))
    params = fixture_lenet5(dev)
    ocfg = A.AdamWConfig(lr=2e-3, weight_decay=0.0)
    got = {}
    # cuDNN runs nothing on this path (im2col + the quantized matmul);
    # deterministic algorithms fix the order of im2col's backward sums
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for be in ("approx_deficit_pallas", "approx_lut"):
                loss_fn = T.classifier_loss(CNN.lenet5_apply,
                                            QuantConfig(backend=be))
                with T.training_numerics():
                    loss, grads = T.value_and_grad(loss_fn, params,
                                                   *lenet_batch)
                new_p, _, _ = T.train_step(params, A.init(params, ocfg),
                                           lenet_batch, loss_fn, ocfg)
                got[be] = [loss] + [t for _, t in A.flatten(grads)
                                    + A.flatten(new_p)]
        finally:
            torch.use_deterministic_algorithms(False)
    check(all(torch.equal(a, b) for a, b in
              zip(got["approx_deficit_pallas"], got["approx_lut"])),
          "train_step through the deficit kernel differs from approx_lut")
    print("  STE train_step through the deficit kernel: loss, gradients "
          "and updated weights bitwise equal to approx_lut's")

    cfg = (CNN.FFDNetConfig(depth=3, width=8) if smoke
           else CNN.FFDNetConfig(depth=6, width=32))
    size = 32 if smoke else 64
    clean = synthetic.textures(16, size=size, seed=0)
    ffd_batch = tuple(torch.from_numpy(b).to(dev) for b in next(
        T.denoiser_batches(clean, batch=8, sigmas=(15., 25., 50.), seed=0)))
    models = {
        "lenet5 (batch 64)": (CNN.lenet5_descs(), T.classifier_loss(
            CNN.lenet5_apply, BF16, qat=True), lenet_batch, 2e-3),
        f"ffdnet d{cfg.depth} w{cfg.width} (batch 8, {size}x{size})": (
            CNN.ffdnet_descs(cfg), T.denoiser_loss(cfg, BF16, qat=True),
            ffd_batch, 1e-3)}
    gen = torch.Generator().manual_seed(0)
    out = {"ste_kernel_step_equals_oracle": True}
    for label, (descs, loss_fn, batch, lr) in models.items():
        ocfg = A.AdamWConfig(lr=lr, weight_decay=0.0)
        params = init_params(descs, gen, dev)
        state = {"p": params, "o": A.init(params, ocfg)}

        def step(det=True):
            with contextlib.nullcontext() if det else cudnn_free(T, torch):
                state["p"], state["o"], _ = T.train_step(
                    state["p"], state["o"], batch, loss_fn, ocfg)

        ms = {True: [], False: []}
        for det in (True, False, False, True):
            ms[det] += _step_ms(torch, dev, lambda: step(det),
                                TIMED_STEPS)[WARM_STEPS:]
        row = {"ms_deterministic": statistics.median(ms[True]),
               "ms_nondeterministic": statistics.median(ms[False])}
        detail[f"train_step_ms {label}"] = {"deterministic": ms[True],
                                            "nondeterministic": ms[False]}
        if dev == "cuda":
            prof = _profile_ms(torch, step)
            row.update(prof)
            row["idle_share"] = 1 - prof["device_busy_ms"] / \
                row["ms_deterministic"]
        out[label] = row
        print(f"  train_step {label}: {row['ms_deterministic']:.3f} ms "
              f"(cuDNN deterministic), {row['ms_nondeterministic']:.3f} ms "
              f"(not); profiled: " + (
                  f"card busy {row['device_busy_ms']:.3f} ms of "
                  f"{row['wall_ms']:.3f} ms, idle share "
                  f"{row['idle_share']:.2f}" if dev == "cuda" else "n/a"))
    return out


def suites_phase(torch, detail, dev: str, smoke: bool) -> dict:
    """Run the four suites through the runners on ``dev``, check them, and
    write their artifacts to build/torch_eval/. Returns the suites line and
    the kernel launches of the runners' calls (counts set to 0 before each
    and read after it, so the checks' launches are left out)."""
    from repro_torch.eval import artifacts
    from repro_torch.eval import runners as R
    from repro_torch.kernels import approx_matmul as K
    from repro_torch.quant import matmul as QM
    from repro_torch.train import cnn_train as T

    EVAL_OUT.mkdir(parents=True, exist_ok=True)
    out = {}
    launches = {key: 0 for key in launch_counts(K)}
    for name in SUITE_RUNS:
        rec = SuiteRecorder(torch, T, dev)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with rec:
            art = R.SUITES[name].run(smoke=smoke, seed=0, device=dev)
        wall = time.perf_counter() - t0
        for key, n in launch_counts(K).items():
            launches[key] += n
        artifacts.save(EVAL_OUT / f"{name}.json", art)
        (EVAL_OUT / f"{name}.md").write_text(R.render_artifact(art))
        entry = {"wall_s": wall, "config": art["config"],
                 "tables": art["tables"]}
        if name in TASK_KEYS:
            (table,) = art["tables"].values()
            check_sweep_rows(name, table, QM)
            check(len(rec.fits) == 1, f"{name}: {len(rec.fits)} fits")
            losses = rec.fits[0]["losses"]
            first = statistics.mean(losses[:10])
            last = statistics.mean(losses[-10:])
            check(last < 0.5 * first, f"{name}: training loss {first:.4g} "
                                      f"-> {last:.4g} did not halve")
            n = check_suite_outputs(torch, name, rec, QM)
            print(f"  {name}: {n} CUDA backend evals replayed, outputs "
                  "bitwise equal to their oracle's")
            step_ms = rec.fits[0]["step_ms"]
            slowest = sorted(rec.evals.items(), key=lambda kv: -kv[1])[:3]
            entry.update({
                "steps": len(losses), "loss_first10": first,
                "loss_last10": last,
                "ms_per_step": statistics.median(step_ms[WARM_STEPS:]),
                "eval_s": sum(rec.evals.values()),
                "slowest_points_s": dict(slowest)})
            detail[f"suite_{name}_points_s"] = rec.evals
            detail[f"suite_{name}_step_ms"] = step_ms
            detail[f"suite_{name}_losses"] = losses
            print(f"  {name}: {len(losses)} QAT steps, loss {first:.4g} -> "
                  f"{last:.4g}, {entry['ms_per_step']:.3f} ms per step; "
                  f"sweep {entry['eval_s']:.1f} s, slowest "
                  + ", ".join(f"{k} {v:.2f} s" for k, v in slowest))
        else:
            committed = json.loads(
                (COMMITTED_EVAL / f"{name}.json").read_text())
            check(art["tables"] == committed["tables"],
                  f"{name}: tables differ from experiments/eval/{name}.json")
            print(f"  {name}: tables equal experiments/eval/{name}.json")
        print(f"  {name}: {wall:.1f} s -> {EVAL_OUT / name}.json")
        out[name] = entry
    out["training"] = training_checks(torch, detail, dev, smoke)
    print("  every *_pallas row equals its oracle's and every MSR core row "
          "its *_lut row, in both task suites")
    return out, launches


# ---------------------------------------------------------------------------
# Phase 7: serving smollm-135m at full width
# ---------------------------------------------------------------------------

SERVE_ORACLES = ("bf16", "int8_exact", "approx_lut", "approx_stage1")
SERVE_KERNEL = {"approx_deficit_pallas": "deficit",   # the body each CUDA
                "approx_stage1_pallas": "stage1",     # backend's fused
                "approx_rank1_pallas": "rank1"}       # route launches
SERVE_UNFUSED = "approx_stage1_pallas"
SHARED_PREFIX = 8        # one full page at the engine's page_size 8
PROJECTIONS_PER_LAYER = 7   # q, k, v, o, gate, up, down
SERVE_REPS = 2           # the workload served this many times per backend
STEP_REPS = 20           # timed calls of a fixed-shape decode step


def serve_workload(vocab: int, smoke: bool, seed: int):
    """The JAX package's serve-suite workload (src/repro/eval/serve.py,
    ``workload``): mixed prompt lengths and budgets behind a shared system
    prefix, more requests than slots, so that the last request is admitted
    mid-decode on a prefix-cache hit. Returns (requests, slots, max_len)
    with requests = [(rid, prompt, max_new), ...]."""
    rng = np.random.default_rng(seed + 11)
    if smoke:
        n_req, slots, max_len = 4, 3, 48
        lens, news = rng.integers(2, 9, n_req), rng.integers(3, 7, n_req)
    else:
        n_req, slots, max_len = 8, 4, 112
        lens, news = rng.integers(4, 25, n_req), rng.integers(8, 17, n_req)
    shared = rng.integers(0, vocab, SHARED_PREFIX).astype(np.int32)
    reqs = [(rid,
             np.concatenate([shared, rng.integers(0, vocab, int(lens[rid]))
                             .astype(np.int32)]),
             int(news[rid])) for rid in range(n_req)]
    return reqs, slots, max_len


class ServeRecorder:
    """For the length of a ``with``: records every logits row the serving
    engine samples from, keyed by (rid, step), and the host milliseconds of
    each decode step of ``engine`` (synchronized before and after)."""

    def __init__(self, torch, PE, engine, dev: str):
        self.torch, self.PE, self.engine, self.dev = torch, PE, engine, dev
        self.rows, self.step_ms = {}, []

    def __enter__(self):
        self.sample = self.PE.sample_token
        self.decode = decode = self.engine._decode

        def record(logits, scfg, rid, step):
            self.rows[(rid, step)] = np.array(logits, np.float32)
            return self.sample(logits, scfg, rid, step)

        def timed(*args):
            _sync(self.torch, self.dev)
            t0 = time.perf_counter()
            out = decode(*args)
            _sync(self.torch, self.dev)
            self.step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        self.PE.sample_token = record
        self.engine._decode = timed
        return self

    def __exit__(self, *exc):
        self.PE.sample_token = self.sample
        self.engine._decode = self.decode
        return False


def _serve_shapes(cfg) -> list:
    """(K, N) of every projection launch of one forward, in order."""
    d, f, kvd = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.dh
    qd = cfg.n_heads * cfg.dh
    layer = [(d, qd), (d, kvd), (d, kvd), (qd, d), (d, f), (d, f), (f, d)]
    return layer * cfg.n_layers + [(d, cfg.padded_vocab)]


def _serve_bound_ms(cfg, rows: int, variant: str, ops, fac) -> float:
    """Least time of one forward's kernel launches at ``rows`` rows each:
    the sum of each launch's bound (the launches run one after another)."""
    name = "rank1_fused_matmul" if variant == "rank1" else "fused_matmul"
    return sum(_bound(name, variant, rows, k, n, fac, ops)[0]
               for k, n in _serve_shapes(cfg))


def serve_phase(torch, detail, dev: str, full: bool, ops=None) -> tuple:
    """Serve the workload under each backend on ``dev`` and check it (see
    the module docstring, phase 7). ``full`` is the card's run at
    smollm-135m's published width; without it a 2-layer, 64-wide smollm
    on the serve suite's smoke workload (the CPU rehearsal). Returns the
    serve line and the kernel launches of the served runs (counts set to 0
    before each run and read after it)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.core import factor as F
    from repro_torch.kernels import approx_matmul as K
    from repro_torch.models import transformer_lm as TLM
    from repro_torch.nn.module import n_params
    from repro_torch.quant import matmul as QM
    from repro_torch.quant.quantize import for_lm, quantize_dynamic
    from repro_torch.serve import engine as PE

    if full:
        cfg0 = registry.get("smollm-135m")
        check((cfg0.n_layers, cfg0.d_model, cfg0.n_heads, cfg0.n_kv_heads,
               cfg0.d_ff, cfg0.vocab, cfg0.param_dtype) ==
              (30, 576, 9, 3, 1536, 49152, torch.bfloat16)
              and n_params(TLM.descs(cfg0)) == 134_515_008,
              f"unexpected smollm-135m config {cfg0}")
    else:
        cfg0 = registry.reduced("smollm-135m", n_layers=2, d_model=64,
                                n_heads=4, n_kv_heads=2, d_ff=128, vocab=64,
                                vocab_pad=64, head_dim=16,
                                param_dtype=torch.bfloat16)
    params = TLM.init(cfg0, torch.Generator().manual_seed(0), device=dev)
    reqs, slots, max_len = serve_workload(cfg0.vocab, smoke=not full, seed=0)
    probe = reqs[-1]
    launches = {key: 0 for key in launch_counts(K)}

    def engine(cfg):
        return PE.Engine(cfg, params, slots=slots, max_len=max_len,
                         device=dev)

    def served(cfg):
        eng = engine(cfg)
        with torch.no_grad():          # warm the backend's tables
            c = TLM.init_cache(cfg, 1, 16, torch.float32, dev)
            _, c = TLM.prefill(params, torch.zeros((1, 8), dtype=torch.int64,
                                                   device=dev), cfg, c)
            TLM.decode_step(params, torch.zeros((1, 1), dtype=torch.int64,
                                                device=dev), 8, cfg, c)
        for rid, prompt, max_new in reqs:
            eng.submit(PE.ServeRequest(rid=rid, prompt=prompt,
                                       max_new=max_new))
        K.reset_launch_counts()
        with ServeRecorder(torch, PE, eng, dev) as rec:
            stats = eng.run()
        for key, n in launch_counts(K).items():
            launches[key] += n
        toks = {r.rid: list(r.output) for r in eng.completed}
        return eng, toks, rec, stats

    fac = F.factorize("proposed")
    runs, out = {}, {}
    for be in SERVE_ORACLES + CUDA_BACKENDS:
        cfg = dataclasses.replace(cfg0, quant=for_lm(be))
        reps = []
        for rep in range(SERVE_REPS):
            eng, toks, rec, stats = served(cfg)
            check(len(toks) == len(reqs) and all(toks.values()),
                  f"{be}: not every request was served")
            check(all(np.isfinite(r).all() and r.shape == (cfg0.padded_vocab,)
                      for r in rec.rows.values()), f"{be}: bad logits rows")
            check(stats["prefix_hit_rate"] > 0, f"{be}: no prefix-cache hit")
            check(stats["waves"] >= 2, f"{be}: no mid-decode admission")
            if rep == 0:
                runs[be] = (toks, rec.rows)
            check(toks == runs[be][0],
                  f"{be}: the workload served again gave other tokens")
            reps.append({
                "decode_step_ms_median": statistics.median(rec.step_ms),
                "decode_steps": stats["decode_steps"],
                "ttft_ms_mean": stats["ttft_ms_mean"],
                "ttft_ms_max": stats["ttft_ms_max"],
                "tok_per_s": stats["tok_per_s"],
                "new_tokens": stats["new_tokens"],
                "elapsed_s": stats["elapsed_s"]})
            detail[f"serve_step_ms {be} rep {rep}"] = rec.step_ms
        row = {"reps": reps, "prefix_hit_rate": stats["prefix_hit_rate"]}
        if dev == "cuda":
            tok = torch.arange(1, slots + 1, device=dev)[:, None]
            pos = torch.arange(slots, device=dev) * 10 + 40

            def step():
                with torch.no_grad():
                    eng._decode(params, eng.pool, tok, pos)

            step()
            fixed = _forward_ms(torch, step, STEP_REPS)
            q1, _, q3 = statistics.quantiles(fixed, n=4)
            row["fixed_step_ms"] = {"median": statistics.median(fixed),
                                    "q1": q1, "q3": q3, "n": STEP_REPS}
            detail[f"serve_fixed_step_ms {be}"] = fixed
            prof = _profile_ms(torch, step)
            row.update(prof)
            row["idle_share"] = 1 - prof["device_busy_ms"] / row[
                "fixed_step_ms"]["median"]
            if be in CUDA_BACKENDS:
                row["step_bound_ms"] = _serve_bound_ms(
                    cfg0, slots, SERVE_KERNEL[be], ops, fac)
                if SERVE_KERNEL[be] == "rank1":
                    row["step_planes_ms"] = sum(
                        _planes_ms(k, n, fac) for k, n in _serve_shapes(cfg0))
                K.reset_launch_counts()
                step()
                n = sum(getattr(K, name).launches for name in
                        ("approx_matmul", "fused_matmul", "rank1_matmul",
                         "rank1_fused_matmul"))
                check(n == PROJECTIONS_PER_LAYER * cfg0.n_layers + 1,
                      f"{be}: {n} kernel launches in one decode step")
                row["launches_per_step"] = n
        out[be] = row
        print(f"  serve {be:22s} served {SERVE_REPS}x: decode step median "
              + " / ".join(f"{r['decode_step_ms_median']:.3f}" for r in reps)
              + f" ms (of {len(rec.step_ms)}), TTFT mean "
              + " / ".join(f"{r['ttft_ms_mean']:.1f}" for r in reps)
              + " ms, " + " / ".join(f"{r['tok_per_s']:.2f}" for r in reps)
              + " tok/s"
              + (f"; fixed step {row['fixed_step_ms']['median']:.3f} ms "
                 f"({row['fixed_step_ms']['q1']:.3f}-"
                 f"{row['fixed_step_ms']['q3']:.3f}, {STEP_REPS} calls), "
                 f"profiled: busy {row['device_busy_ms']:.3f} ms, "
                 f"port kernels {row['kernels_ms']:.3f} ms, idle share "
                 f"{row['idle_share']:.2f}" if dev == "cuda" else "")
              + (f", bound {row['step_bound_ms']:.3f} ms"
                 if "step_bound_ms" in row else "")
              + (f" (+ planes {row['step_planes_ms']:.3f} ms)"
                 if "step_planes_ms" in row else ""), flush=True)
        # the probe, alone on a cold engine of the same pool shape
        if be in CUDA_BACKENDS:
            solo = engine(cfg)
            solo.submit(PE.ServeRequest(rid=probe[0], prompt=probe[1],
                                        max_new=probe[2]))
            K.reset_launch_counts()
            solo.run()
            for key, n in launch_counts(K).items():
                launches[key] += n
            check(list(solo.completed[0].output) == toks[probe[0]],
                  f"{be}: the probe served alone differs from batched")
            row["solo_match"] = True
        del eng

    for be in CUDA_BACKENDS:
        oracle = QM.get_backend(be).oracle
        (toks, rows), (otoks, orows) = runs[be], runs[oracle]
        check(toks == otoks, f"{be}: served tokens differ from {oracle}'s")
        check(rows.keys() == orows.keys(),
              f"{be}: sampled at other steps than {oracle}")
        for key, r in rows.items():
            check(np.array_equal(r, orows[key]),
                  f"{be}: logits at (rid, step) {key} differ from "
                  f"{oracle}'s")
        out[be]["oracle_bitwise_rows"] = len(rows)
    print("  CUDA backends: served tokens and every sampled logits row "
          "bitwise equal to the oracle's; probe alone == batched")
    cfg = dataclasses.replace(cfg0, quant=dataclasses.replace(
        for_lm(SERVE_UNFUSED), fuse_epilogue=False))
    _, toks, rec, _ = served(cfg)
    check(toks == runs[SERVE_UNFUSED][0] and all(
        np.array_equal(r, runs[SERVE_UNFUSED][1][k])
        for k, r in rec.rows.items()),
        f"{SERVE_UNFUSED} unfused (K1) differs from fused")
    print(f"  {SERVE_UNFUSED} unfused (K1): tokens and logits bitwise equal "
          "to the fused run")
    out["config"] = {"arch": cfg0.name, "n_layers": cfg0.n_layers,
                     "d_model": cfg0.d_model, "vocab": cfg0.vocab,
                     "params": n_params(TLM.descs(cfg0)),
                     "param_dtype": str(cfg0.param_dtype), "slots": slots,
                     "max_len": max_len, "requests": len(reqs),
                     "cache_dtype": "float32", "seed": 0}
    if dev == "cuda":
        table = params["embed"]["table"]
        w_q = quantize_dynamic(table.t(), axis=0)[0].contiguous()
        out["rank1_operand_build_ms_head"] = _ms(torch, lambda: (
            K.exact_weight_operand(w_q), K.rank1_weight_planes(w_q)), 3)
        print(f"  rank1 operand build at the head (576 x 49152): "
              f"{out['rank1_operand_build_ms_head']:.3f} ms")
        del runs
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.serve", "--backend",
             "approx_deficit_pallas"], cwd=ROOT, capture_output=True,
            text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        check(cli.returncode == 0, "python -m repro_torch.serve failed:\n"
              + cli.stdout[-2000:] + cli.stderr[-4000:])
        last = cli.stdout.strip().splitlines()
        check(any("backend=approx_deficit_pallas" in ln for ln in last),
              "python -m repro_torch.serve printed no summary")
        out["cli_s"] = time.perf_counter() - t0
        print(f"  python -m repro_torch.serve --backend "
              f"approx_deficit_pallas ({out['cli_s']:.1f} s): {last[0]}; "
              f"{last[-1]}")
    return out, launches


if __name__ == "__main__":
    sys.exit(main())
