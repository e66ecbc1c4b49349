"""CUDA kernels for approximate-multiplier matmuls, with their plain versions.

Four entries, one per Pallas entry of the JAX package
(src/repro/kernels/approx_matmul.py), all served by the one kernel template
in csrc/approx_matmul.cu:

``approx_matmul``        K1: (M, K) x (K, N) int8 -> (M, N) int32;
                         ``kernel`` = 'deficit' | 'stage1'.
``fused_matmul``         K2: (B, M, K) or (M, K) int8 -> float32
                         relu?(acc * scale + bias); ``variant`` =
                         'deficit' | 'stage1' | 'exact'.
``rank1_matmul``         K3: the rank-factored body, int32 out.
``rank1_fused_matmul``   K4: the rank-factored body with K2's epilogue.

A wrapper given CPU tensors computes its ``*_plain`` version; given CUDA
tensors it launches the kernel or raises. Each wrapper counts its launches
in ``launches`` (an int) and ``variant_launches`` (per body variant); the
plain versions count nothing.

The kernel library is built with nvcc for sm_90a at first use, into
``build/kernels/`` at the repository root, from csrc/ and the deficit
functions that codegen.py writes beside it.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import deficit as D
from repro_torch.core import factor as F
from repro_torch.core.factor import STAGE1_SITES
from repro_torch.kernels import codegen
from repro_torch.kernels.ref import int8_matmul

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "approx_matmul.cu"
BUILD_DIR = _HERE.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_BODY = {"exact": 0, "deficit": 1, "stage1": 2, "rank1": 3}
_OUT_INT32, _OUT_F32, _OUT_F32_RELU = 0, 1, 2


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return str(path)


def build() -> Tuple[Path, str]:
    """Compile the kernel library if its sources changed; returns the
    library's path and the compiler's report (registers, shared memory)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    header = codegen.write_header(BUILD_DIR)
    digest = hashlib.sha256(SOURCE.read_bytes() + header.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libapprox_matmul_{digest}.so"
    log = BUILD_DIR / f"libapprox_matmul_{digest}.log"
    if not lib.exists():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(BUILD_DIR), "-o", str(tmp),
               str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return lib, log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.approx_mm_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, p, p, i, i, i, p, p, i, p, p, i, p, p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=32)
def _rank1_tables(design: str, device: str):
    """(u (256, R) int8, v (256, R) int32) on ``device``: the sign-folded
    factor tables, both indexed by the operand's byte, R contiguous."""
    fac = F.factorize(design)
    u = torch.as_tensor(np.ascontiguousarray(fac.u_signed), device=device)
    v = torch.as_tensor(np.ascontiguousarray(fac.v_signed.T),
                        device=device)
    return u, v, fac.R


def _launch(body: str, design: str, x: torch.Tensor, w: torch.Tensor,
            out: torch.Tensor, scale: Optional[torch.Tensor] = None,
            bias: Optional[torch.Tensor] = None, relu: bool = False):
    rows, k = x.numel() // x.shape[-1], x.shape[-1]
    n = w.shape[1]
    design_id = codegen.designs().index(design) if body == "deficit" else 0
    u = v = None
    r = 0
    if body == "rank1":
        u, v, r = _rank1_tables(design, str(x.device))
    out_kind = (_OUT_INT32 if scale is None
                else _OUT_F32_RELU if relu else _OUT_F32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        err = _lib().approx_mm_launch(
            _BODY[body], design_id, ptr(x), ptr(w), rows, k, n, ptr(u),
            ptr(v), r, ptr(scale), ptr(bias), out_kind, ptr(out),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"approx_mm_launch({body}) failed: CUDA error "
                           f"{err}")


def _count(fn, variant: str):
    fn.launches += 1
    fn.variant_launches[variant] += 1


def reset_launch_counts():
    for fn in (approx_matmul, fused_matmul, rank1_matmul,
               rank1_fused_matmul):
        fn.launches = 0
        fn.variant_launches = collections.Counter()


# ---------------------------------------------------------------------------
# Input checks
# ---------------------------------------------------------------------------

def _on_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _check_operands(x, w, x_ndims=(2,)):
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"operands must be int8, got {x.dtype}, {w.dtype}")
    if x.ndim not in x_ndims or w.ndim != 2:
        raise ValueError(f"bad operand ranks: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if x.shape[-1] == 0:
        raise ValueError("empty contraction (K = 0): the kernels need K >= 1")


def _check_cuda(x, w, scale=None, bias=None):
    for t in (x, w, scale, bias):
        if t is not None and not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors only")
    n = w.shape[1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (1, n)):
            raise ValueError(f"{name} must be float32 of shape (1, {n}), "
                             f"got {t.dtype} {tuple(t.shape)}")
    if x.numel() // x.shape[-1] >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError("operand too large for the kernel's int indexing")


def _check_epilogue(w, scale, bias):
    n = w.shape[1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape[-1] != n:
            raise ValueError(f"{name} must have {n} columns, got "
                             f"{tuple(t.shape)}")


def _check_design(design: str):
    if design not in codegen.designs():
        raise KeyError(f"unknown design {design!r}; known: "
                       f"{codegen.designs()}")


# ---------------------------------------------------------------------------
# Plain versions (PyTorch; run on the CPU and, for comparisons, on the card)
# ---------------------------------------------------------------------------

def chunk_rows(k: int, n: int, device: torch.device) -> int:
    """Rows per chunk so that an (rows, K, N) int32 intermediate stays near
    4 MB on the CPU and 32 MB on the card."""
    budget = 1 << 20 if device.type == "cpu" else 1 << 23
    return max(1, budget // max(1, k * n))


def _deficit_corr(x32, w32, design):
    """sum_k sign(x) sign(w) deficit_sum(|x|, |w|), chunked over rows."""
    m, k = x32.shape
    n = w32.shape[1]
    wmag, wsgn = w32.abs()[None], w32.sign()[None]
    out = []
    step = chunk_rows(k, n, x32.device)
    for r0 in range(0, m, step):
        xc = x32[r0:r0 + step, :, None]
        d = D.deficit_sum(xc.abs(), wmag, design)
        s = xc.sign() * wsgn
        out.append((d * s).sum(dim=1, dtype=torch.int64))
    if not out:
        return torch.zeros((0, n), dtype=torch.int64, device=x32.device)
    return torch.cat(out)


def window_and(mag, start):
    """AND of bits [start, start+4) of a magnitude, as 0/1 int32."""
    return ((mag >> start) & 15).eq(15).to(torch.int32)


def _stage1_corr(x32, w32):
    """sum over STAGE1_SITES of (window(x) . window(w)) << col, signed."""
    xm, xs = x32.abs(), x32.sign()
    wm, ws = w32.abs(), w32.sign()
    corr = torch.zeros((x32.shape[0], w32.shape[1]), dtype=torch.int64,
                       device=x32.device)
    for col, ra, rb in STAGE1_SITES:
        u = window_and(xm, ra) * xs
        v = window_and(wm, rb) * ws
        corr += int8_matmul(u, v).to(torch.int64) << col
    return corr


def approx_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                        design: str = "proposed",
                        kernel: str = "deficit") -> torch.Tensor:
    """Plain version of K1: x (M,K) int8, w (K,N) int8 -> (M,N) int32."""
    x32, w32 = x.to(torch.int32), w.to(torch.int32)
    if kernel == "deficit":
        corr = _deficit_corr(x32, w32, design)
    elif kernel == "stage1":
        corr = _stage1_corr(x32, w32)
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    return (int8_matmul(x, w).to(torch.int64) - corr).to(torch.int32)


def rank1_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                       design: str = "proposed") -> torch.Tensor:
    """Plain version of K3: exact dot minus the factored correction
    sum_{k,r} u[x & 0xFF, r] v[r, w & 0xFF], in float64 (exact: every
    partial sum is an integer far below 2^53)."""
    fac = F.factorize(design)
    dev = x.device
    u = torch.as_tensor(fac.u_signed, device=dev).to(torch.float64)
    v = torch.as_tensor(fac.v_signed, device=dev).to(torch.float64)
    m, k = x.shape
    n = w.shape[1]
    iw = w.to(torch.int64) & 0xFF
    wf = v[:, iw].permute(1, 0, 2).reshape(k * fac.R, n)   # (K*R, N)
    ix = x.to(torch.int64) & 0xFF
    step = chunk_rows(k * fac.R, 1, dev)
    corr = [torch.matmul(u[ix[r0:r0 + step]].reshape(-1, k * fac.R), wf)
            for r0 in range(0, m, step)]
    corr = (torch.cat(corr) if corr else
            torch.zeros((0, n), dtype=torch.float64, device=dev))
    return (int8_matmul(x, w).to(torch.int64)
            - corr.to(torch.int64)).to(torch.int32)


def _epilogue_plain(acc, scale, bias, relu):
    """float32(acc) * scale, then + bias, as two separately rounded ops."""
    y = torch.add(torch.mul(acc.to(torch.float32), scale), bias)
    return torch.clamp_min(y, 0.0) if relu else y


def _fused_plain(matmul, x, w, scale, bias, relu):
    acc = matmul(x.reshape(-1, x.shape[-1]), w)
    y = _epilogue_plain(acc, scale.reshape(1, -1).to(torch.float32),
                        bias.reshape(1, -1).to(torch.float32), relu)
    return y.reshape(*x.shape[:-1], w.shape[1])


def fused_matmul_plain(x, w, scale, bias, design: str = "proposed",
                       variant: str = "deficit",
                       relu: bool = False) -> torch.Tensor:
    """Plain version of K2 (leading batch dim allowed)."""
    if variant == "exact":
        mm = int8_matmul
    elif variant in ("deficit", "stage1"):
        def mm(a, b):
            return approx_matmul_plain(a, b, design, variant)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return _fused_plain(mm, x, w, scale, bias, relu)


def rank1_fused_matmul_plain(x, w, scale, bias, design: str = "proposed",
                             relu: bool = False) -> torch.Tensor:
    """Plain version of K4 (leading batch dim allowed)."""
    return _fused_plain(lambda a, b: rank1_matmul_plain(a, b, design),
                        x, w, scale, bias, relu)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def approx_matmul(x: torch.Tensor, w: torch.Tensor,
                  design: str = "proposed",
                  kernel: str = "deficit") -> torch.Tensor:
    """K1 (replaces ``approx_matmul_pallas``): (M,K) x (K,N) int8 -> int32."""
    _check_operands(x, w)
    if kernel not in ("deficit", "stage1"):
        raise ValueError(f"unknown kernel {kernel!r}")
    _check_design(design)
    if _on_cpu(x, w):
        return approx_matmul_plain(x, w, design, kernel)
    _check_cuda(x, w)
    out = torch.empty((x.shape[0], w.shape[1]), dtype=torch.int32,
                      device=x.device)
    _launch(kernel, design, x, w, out)
    _count(approx_matmul, kernel)
    return out


def fused_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, design: str = "proposed",
                 variant: str = "deficit",
                 relu: bool = False) -> torch.Tensor:
    """K2 (replaces ``fused_matmul_pallas``): x (B,M,K) or (M,K) int8,
    w (K,N) int8, scale and bias (1,N) float32 -> float32
    relu?(acc * scale + bias)."""
    _check_operands(x, w, (2, 3))
    if variant not in ("deficit", "stage1", "exact"):
        raise ValueError(f"unknown variant {variant!r}")
    _check_design(design)
    _check_epilogue(w, scale, bias)
    if _on_cpu(x, w, scale, bias):
        return fused_matmul_plain(x, w, scale, bias, design, variant, relu)
    _check_cuda(x, w, scale, bias)
    out = torch.empty((*x.shape[:-1], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    _launch(variant, design, x, w, out, scale, bias, relu)
    _count(fused_matmul, variant)
    return out


def rank1_matmul(x: torch.Tensor, w: torch.Tensor,
                 design: str = "proposed") -> torch.Tensor:
    """K3 (replaces ``rank1_matmul_pallas``): (M,K) x (K,N) int8 -> int32,
    bit-identical to the paper multiplier's signed LUT."""
    _check_operands(x, w)
    _check_design(design)
    if _on_cpu(x, w):
        return rank1_matmul_plain(x, w, design)
    _check_cuda(x, w)
    out = torch.empty((x.shape[0], w.shape[1]), dtype=torch.int32,
                      device=x.device)
    _launch("rank1", design, x, w, out)
    _count(rank1_matmul, "rank1")
    return out


def rank1_fused_matmul(x: torch.Tensor, w: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor,
                       design: str = "proposed",
                       relu: bool = False) -> torch.Tensor:
    """K4 (replaces ``rank1_fused_matmul_pallas``): K3 with K2's epilogue."""
    _check_operands(x, w, (2, 3))
    _check_design(design)
    _check_epilogue(w, scale, bias)
    if _on_cpu(x, w, scale, bias):
        return rank1_fused_matmul_plain(x, w, scale, bias, design, relu)
    _check_cuda(x, w, scale, bias)
    out = torch.empty((*x.shape[:-1], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    _launch("rank1", design, x, w, out, scale, bias, relu)
    _count(rank1_fused_matmul, "rank1")
    return out


reset_launch_counts()
