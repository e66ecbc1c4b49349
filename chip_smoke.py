#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printing its seconds:

1. device   require CUDA, print the card's name and power limit, and turn
            TF32 off for float32 matmuls and cuDNN convolutions;
2. build    compile the CUDA kernels with nvcc for sm_90a from the
            repository's sources (src/repro_torch/kernels/csrc), and read
            from their SASS the instructions each body spends per operand
            pair (the operation counts of the bounds);
3. kernels  hold every kernel entry and variant to its plain PyTorch
            version on the card, bitwise: all 256 x 256 int8 byte pairs at
            K = 1 against the numpy product tables, ragged and batched
            shapes across the tile seams, and the LeNet-5 and FFDNet layer
            shapes; hold every backend's int32 output to the JAX package's
            (src/repro_torch/testdata/reference.npz); time each entry;
4. lenet5   eval_classifier on 500 synthetic digits with the fixture's
            JAX-trained weights under bf16, int8_exact and every approx
            backend: each CUDA backend's accuracy equals its oracle's, the
            deficit kernel's logits equal approx_lut's bit for bit, the
            unfused route (kernels K1, K3) equals the fused one bit for bit,
            and the oracles' accuracies equal the JAX package's; one
            batch's forward timed and traced as in phase 5;
5. ffdnet   eval_denoiser on 16 64x64 textures at sigma 25 with the
            full-width FFDNet (depth 8, width 64) under the three CUDA
            backends, fused and unfused, and their oracles: outputs equal
            bit for bit; each forward timed FORWARD_REPS times, and one
            traced with torch.profiler for its device time;
6. launch counts of phases 4-5: every kernel entry launched;
7. one JSON line ``{"kernels": [...]}``;
then the ``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import json
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
SOURCE = "src/repro_torch/kernels/csrc/approx_matmul.cu"

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
# The variants the main path (phases 4-5) must launch: no caller of the
# JAX package (nor of the port) selects fused_matmul's "exact" variant.
PATH_VARIANTS = [r[:2] for r in ROWS if r[1] != "exact"]

LENET_LAYERS = {  # (B, M, K, N) of each quantized matmul at batch 50
    "lenet5.c1": (50, 784, 25, 6), "lenet5.c2": (50, 196, 150, 16),
    "lenet5.fc1": (1, 50, 784, 120), "lenet5.fc2": (1, 50, 120, 84),
    "lenet5.fc3": (1, 50, 84, 10)}
FFDNET_LAYERS = {  # 16 images of 64x64 -> 32x32 after pixel_unshuffle
    "ffdnet.in": (16, 1024, 45, 64), "ffdnet.mid": (16, 1024, 576, 64),
    "ffdnet.out": (16, 1024, 576, 4)}
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
        ops = sass_ops_per_pair(K, lib)
        detail["ops_per_pair_sass"] = ops
        print("instructions per pair that combine x and w (SASS): "
              + ", ".join(f"{k} {v:g}" for k, v in ops.items()))

    with Phase("kernels"):
        rows = kernels_phase(torch, K, detail, ops)

    K.reset_launch_counts()
    with Phase("lenet5"):
        lenet5_phase(torch, detail)
    with Phase("ffdnet"):
        ffdnet_phase(torch, detail)
    counts = {(name, var): getattr(K, name).variant_launches[var]
              for name, var, _ in ROWS}

    with Phase("launches"):
        for (name, var), n in counts.items():
            print(f"launches {name}[{var}]: {n}")
        for name, var in PATH_VARIANTS:
            check(counts[(name, var)] > 0,
                  f"{name}[{var}] was not launched on the main path")
        for row in rows:
            row["launches"] = counts[(row.pop("_entry"), row.pop("_variant"))]
        detail["launches_per_forward"] = per_forward_launches(torch, K)
        for key, n in detail["launches_per_forward"].items():
            print(f"launches per forward {key}: {n}")

    DETAIL.parent.mkdir(parents=True, exist_ok=True)
    DETAIL.write_text(json.dumps(detail, indent=1))
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _call(K, name, variant, x, w, scale, bias, relu, plain):
    """One entry/variant, kernel or plain version (same arguments)."""
    fn = getattr(K, f"{name}_plain" if plain else name)
    if name == "approx_matmul":
        return fn(x.reshape(-1, x.shape[-1]), w, kernel=variant)
    if name == "fused_matmul":
        return fn(x, w, scale, bias, variant=variant, relu=relu)
    if name == "rank1_matmul":
        return fn(x.reshape(-1, x.shape[-1]), w)
    return fn(x, w, scale, bias, relu=relu)           # rank1_fused_matmul


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


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.


def _bound(name, variant, rows, k, n, r1, ops) -> tuple:
    """(bound_ms, bound_by): the larger of the operand/result bytes over
    the memory rate and the operations over the card's rate for them."""
    fused = name in ("fused_matmul", "rank1_fused_matmul")
    nbytes = rows * k + k * n + rows * n * 4 + (2 * n * 4 if fused else 0)
    macs = rows * k * n
    if variant == "exact":
        t_ops = 2 * macs / INT8_TC_OPS_PER_S
    else:
        t_ops = macs * ops[variant] / INT_ISSUE_OPS_PER_S
    if variant == "rank1":
        nbytes += 256 * r1 * 5          # the factor tables
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sass_ops_per_pair(K, lib) -> dict:
    """Per body, the integer instructions per (x, w) pair that combine the
    two operands, counted in the built kernels' SASS (kernels/sass.py):
    the work per multiply-accumulate no operand reuse removes. Deficit is
    the proposed design's instantiation; rank1 is the exact product plus
    R factors of its inner loop."""
    from repro_torch.core import factor as F
    from repro_torch.kernels import codegen
    from repro_torch.kernels import sass as SASS
    src = K.SOURCE.read_text()
    tile = tuple(int(re.search(rf"constexpr int {t} = (\d+);", src)
                     .group(1)) for t in ("TM", "TN"))
    fns = SASS.functions(SASS.dump(lib))

    def per_pair(body, design=0, loads_per_operand=1):
        tag = f"approx_mm_kernelILi{body}ELi{design}EE"
        name = [f for f in fns if tag in f]
        check(len(name) == 1, f"no single kernel {tag} in the SASS")
        return SASS.ops_per_pair(SASS.inner_loop(fns[name[0]]), tile,
                                 loads_per_operand)

    exact = per_pair(K._BODY["exact"])
    return {
        "exact": exact,
        "deficit": per_pair(K._BODY["deficit"],
                            codegen.designs().index("proposed")),
        "stage1": per_pair(K._BODY["stage1"], loads_per_operand=2),
        "rank1": exact + F.factorize("proposed").R
        * per_pair(K._BODY["rank1"])}


def kernels_phase(torch, K, detail, ops):
    from repro_torch.core import luts
    from repro_torch.core import factor as F
    from repro_torch.core.multiplier import proposed_multiplier
    from repro_torch.quant import matmul as QM
    from repro_torch.quant.quantize import QuantConfig

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    r1 = F.factorize("proposed").R

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
    print("all 2^16 byte pairs match the product tables for every entry")

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
              **LENET_LAYERS, **FFDNET_LAYERS}
    errs = {r[:2]: 0.0 for r in ROWS}
    per_layer = []
    for label, (bb, m, k, n) in shapes.items():
        x, w, scale, bias = _operands(torch, gen, bb, m, k, n, dev)
        for name, var, _ in ROWS:
            for relu in ((False, True) if "fused" in name else (False,)):
                got = _call(K, name, var, x, w, scale, bias, relu, False)
                want = _call(K, name, var, x, w, scale, bias, relu, True)
                err = _max_err(got, want)
                errs[(name, var)] = max(errs[(name, var)], err)
                check(got.dtype == want.dtype and torch.equal(got, want),
                      f"{name}[{var}] relu={relu} differs from its plain "
                      f"version at {label}: max |diff| {err}")
            if label in LENET_LAYERS or label in FFDNET_LAYERS:
                kms = _ms(torch, lambda: _call(K, name, var, x, w, scale,
                                               bias, False, False), 5)
                pms = _ms(torch, lambda: _call(K, name, var, x, w, scale,
                                               bias, False, True), 2)
                lib = None
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
                    lib = _ms(torch, lambda: torch._int_mm(x2, w), 5)
                bound, by = _bound(name, var, bb * m, k, n, r1, ops)
                per_layer.append({
                    "layer": label, "entry": name, "variant": var,
                    "shape": [bb, m, k, n], "kernel_ms": kms,
                    "plain_ms": pms, "library_ms": lib,
                    "bound_ms": bound, "bound_by": by})
        print(f"  {label}: every entry equals its plain version")
    detail["per_layer"] = per_layer
    for row in per_layer:
        print(f"  {row['layer']:12s} {row['entry']}[{row['variant']}] "
              f"kernel {row['kernel_ms']:.4f} ms  plain "
              f"{row['plain_ms']:.2f} ms  library {row['library_ms']}  "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")

    rows = []
    for name, var, replaces in ROWS:
        t = next(r for r in per_layer if r["layer"] == TIMED_LAYER
                 and r["entry"] == name and r["variant"] == var)
        rows.append({
            "name": f"{name}[{var}]", "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": None,
            "max_abs_err": errs[(name, var)], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"], "pairs_2e16_ok": pairs_ok[(name, var)],
            "_entry": name, "_variant": var})
    return rows


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
    union of their spans) and the ms of the approx_mm kernels."""
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
    ours = sum(hi - lo for lo, hi, name in spans if "approx_mm_kernel" in name)
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
          f"approx_mm kernels {prof['kernels_ms']:.3f} ms")
    return {"forward_ms": ms, "forward_ms_median": med, **prof}


# ---------------------------------------------------------------------------
# Phase 4: LeNet-5 through eval_classifier
# ---------------------------------------------------------------------------

CUDA_BACKENDS = ("approx_deficit_pallas", "approx_stage1_pallas",
                 "approx_rank1_pallas")


def lenet5_phase(torch, detail):
    import dataclasses
    from repro_torch.convert import params_from_jax
    from repro_torch.data import synthetic
    from repro_torch.models import cnn as CNN
    from repro_torch.quant import matmul as QM
    from repro_torch.quant.quantize import QuantConfig
    from repro_torch.train import cnn_train as T

    with np.load(FIXTURE) as data:
        tree: dict = {}
        for key in data.files:
            if key.startswith("lenet5/"):
                _, layer, leaf = key.split("/")
                tree.setdefault(layer, {})[leaf] = data[key]
        jax_ref = {k: data[k] for k in data.files
                   if k.startswith(("logits_", "acc_"))}
    params = params_from_jax(tree)
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


if __name__ == "__main__":
    sys.exit(main())
