"""CUDA kernels for approximate-multiplier matmuls, with their plain versions.

Four entries, one per Pallas entry of the JAX package
(src/repro/kernels/approx_matmul.py). The DEFICIT and STAGE1 bodies run on
the CUDA cores (csrc/approx_matmul.cu); the EXACT and RANK1 bodies on the
int8 tensor cores (csrc/tc_matmul.cu):

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
``build/kernels/`` at the repository root, from every source in csrc/.

The CUDA-core kernel takes a ``plan`` (tile sizes and a split of K, a
function of the shapes alone) and the correction table of its function
and design, which ``correction_table`` builds once per device; the
wrapper allocates the split's partial sums and keeps a zeroed counter
buffer per device.

The tensor-core kernel takes its B operands K-major;
``exact_weight_operand`` and ``rank1_weight_planes`` build them per call
with plain torch ops, as the reference gathers its features per call
outside its ``pallas_call``. The kernel pads them to its tiles itself.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import compressors as CMP
from repro_torch.core import deficit as D
from repro_torch.core import factor as F
from repro_torch.core.factor import STAGE1_SITES
from repro_torch.kernels.ref import int8_matmul

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "approx_matmul.cu"
BUILD_DIR = _HERE.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

CUDA_CORE = ("deficit", "stage1")    # the functions of approx_mm_launch
_TC_BODY = {"exact": 0, "rank1": 1}          # tc_mm_launch
_OUT_INT32, _OUT_F32, _OUT_F32_RELU = 0, 1, 2

# csrc/approx_matmul.cu: its contraction step, the correction table's
# layout (rows |x| in [0, 128] at a stride of 130 int16, padded to 16
# bytes; the kernel refuses another), and the tiles it is compiled for.
BK = 32
TABLE_ROWS = 129
TABLE_STRIDE = 130
TABLE_BYTES = -(-TABLE_ROWS * TABLE_STRIDE * 2 // 16) * 16
ROW_TILES = (4, 8, 16, 32, 64)
COL_TILES = (16, 32, 64)
SMS = 132                  # streaming multiprocessors of an H100 SXM


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
    library's path and the compiler's report (registers, shared memory).
    One nvcc per source, all started together, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = sorted((_HERE / "csrc").glob("*.cu"))
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in srcs)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libapprox_matmul_{digest}.so"
    log = BUILD_DIR / f"libapprox_matmul_{digest}.log"
    if not lib.exists():
        tag = f"{digest}.{os.getpid()}"
        objs = [BUILD_DIR / f"{p.stem}.{tag}.o" for p in srcs]
        procs = [subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for p, o in zip(srcs, objs)]
        outs = [pr.communicate()[0] for pr in procs]
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        if all(pr.returncode == 0 for pr in procs):
            link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                                   *map(str, objs)],
                                  capture_output=True, text=True)
            outs.append(link.stdout + link.stderr)
            failed = link.returncode
        else:
            failed = next(pr.returncode for pr in procs if pr.returncode)
        for o in objs:
            o.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed ({failed}):\n"
                               + "\n".join(outs))
        log.write_text("\n".join(outs))
        os.replace(tmp, lib)
    return lib, log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.approx_mm_launch.argtypes = [p, p, i, i, i, i, i, i, i, i, i, p, i,
                                     i, p, p, i, p, p, p, i, p]
    lib.approx_mm_launch.restype = ctypes.c_int
    lib.tc_mm_launch.argtypes = [i, p, p, p, p, i, i, i, i, i, i, p, p, i,
                                 p, p]
    lib.tc_mm_launch.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# The CUDA-core kernel's plan and correction tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch of the CUDA-core kernel: bm x bn output tiles, K cut into
    ``splits`` slices of ``k_slice`` columns (the last one ragged), one
    block per (tile, slice)."""
    bm: int
    bn: int
    k_slice: int
    row_tiles: int
    col_tiles: int
    splits: int

    @property
    def blocks(self) -> int:
        return self.row_tiles * self.col_tiles * self.splits

    def block(self, b: int) -> Tuple[int, int, int]:
        """(first row, first column, first k) of block ``b``, as the kernel
        reads its block index."""
        ct, b = b % self.col_tiles, b // self.col_tiles
        rt, s = b % self.row_tiles, b // self.row_tiles
        return rt * self.bm, ct * self.bn, s * self.k_slice


@functools.lru_cache(maxsize=4096)
def plan(rows: int, k: int, n: int) -> Plan:
    """The tiles and split-K of an (rows, K) x (K, N) product. The row tile
    is the smallest that holds the rows (64 past that). The column tile is
    the narrowest that holds N (64 past that), halved while the tiles and
    every possible slice of BK columns together give fewer blocks than the
    card has SMs. K is then cut into as many slices of whole BK steps as
    bring the blocks to at least one per SM, where the tiles alone do not."""
    if rows < 1 or k < 1 or n < 1:
        raise ValueError(f"no plan for an empty product {(rows, k, n)}")
    bm = next((t for t in ROW_TILES if t >= rows), ROW_TILES[-1])
    row_tiles = -(-rows // bm)
    steps = -(-k // BK)
    bn = next((t for t in COL_TILES if t >= n), COL_TILES[-1])
    while bn > COL_TILES[0] and row_tiles * -(-n // bn) * steps < SMS:
        bn //= 2
    col_tiles = -(-n // bn)
    need = -(-SMS // (row_tiles * col_tiles))
    slice_steps = steps if need <= 1 else max(1, steps // need)
    k_slice = slice_steps * BK
    return Plan(bm, bn, k_slice, row_tiles, col_tiles, -(-k // k_slice))


def correction_matrix(kernel: str, design: str = "proposed") -> torch.Tensor:
    """(129, 129) int32 on the CPU: C(|x|, |w|) for magnitudes in [0, 128],
    the term P(x, w) = x w - sign(x) sign(w) C subtracts: deficit_sum for
    'deficit', the stage-1 site correction for 'stage1'."""
    mag = torch.arange(TABLE_ROWS, dtype=torch.int32)
    a, b = mag[:, None], mag[None, :]
    if kernel == "deficit":
        return D.deficit_sum(a, b, design).to(torch.int32)
    if kernel == "stage1":
        corr = torch.zeros((TABLE_ROWS, TABLE_ROWS), dtype=torch.int32)
        for col, ra, rb in STAGE1_SITES:
            corr += (window_and(a, ra) * window_and(b, rb)) << col
        return corr
    raise ValueError(f"unknown kernel {kernel!r}")


@functools.lru_cache(maxsize=32)
def correction_table(kernel: str, design: str, device: str) -> torch.Tensor:
    """The kernel's table on ``device``: (TABLE_BYTES / 2,) int16, row |x|
    at |x| * TABLE_STRIDE, zero past column 128."""
    corr = correction_matrix(kernel, design)
    if corr.min() < -2 ** 15 or corr.max() >= 2 ** 15:
        raise ValueError(f"{kernel}/{design}: correction outside int16")
    flat = torch.zeros(TABLE_BYTES // 2, dtype=torch.int16)
    flat[:TABLE_ROWS * TABLE_STRIDE].view(
        TABLE_ROWS, TABLE_STRIDE)[:, :TABLE_ROWS] = corr.to(torch.int16)
    return flat.to(device)


_COUNTERS = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """A zeroed int32 counter per output tile, kept per device: each split
    launch leaves its counters at 0 again."""
    key = str(device)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                         device=device)
    return c


# ---------------------------------------------------------------------------
# Tensor-core operands (plain torch; built per call on the operand's device)
# ---------------------------------------------------------------------------

def rank1_r_pad(r: int) -> int:
    """R padded to a multiple of 4: a fragment register's 4 features are
    then 4 factors of one operand."""
    return -(-r // 4) * 4


def exact_weight_operand(w: torch.Tensor) -> torch.Tensor:
    """(N, K) int8: w (K, N) transposed to K-major, the only layout in which
    the int8 tensor cores take B."""
    return w.t().contiguous()


@functools.lru_cache(maxsize=32)
def _rank1_tables(design: str, device: str):
    """(u (256, Rp) int8, planes (nd, 257, Rp) int8) on ``device``: the
    sign-folded factor table u_signed and the base-128 digit planes of
    v_signed, both indexed by the operand's byte, zero past R; the planes'
    row 256 is zero, the index of padding."""
    fac = F.factorize(design)
    rp = rank1_r_pad(fac.R)
    u = np.zeros((256, rp), np.int8)
    u[:, :fac.R] = fac.u_signed
    planes = np.zeros((fac.n_digits, 257, rp), np.int8)
    for d, plane in enumerate(F.v_digit_planes(fac)):
        planes[d, :256, :fac.R] = plane.T
    return (torch.as_tensor(u, device=device),
            torch.as_tensor(planes, device=device))


def rank1_weight_planes(w: torch.Tensor, design: str = "proposed"
                        ) -> torch.Tensor:
    """(nd * N, Kp * Rp) int8, the weight side of the rank-factored
    correction: row d * N + n holds digit plane d of
    v_signed[:, w[:, n] & 0xFF] in feature order k * Rp + r, so that
    sum_d plane_d * 128^d is v; zero for r >= R and k >= K. K is padded to
    Kp, a multiple of 4, so that a row is a multiple of 16 bytes, the
    kernel's widest copy."""
    k, n = w.shape
    _, planes = _rank1_tables(design, str(w.device))
    nd, _, rp = planes.shape
    kp = -(-k // 4) * 4
    wb = w.view(torch.uint8).t()
    if kp == k:
        idx = wb.to(torch.int64, memory_format=torch.contiguous_format)
    else:
        idx = torch.full((n, kp), 256, dtype=torch.int64, device=w.device)
        idx[:, :k] = wb
    # index_select rather than advanced indexing: the same gather at a
    # fraction of the host time per call
    feats = torch.index_select(planes, 1, idx.reshape(-1))  # (nd, N*Kp, Rp)
    return feats.reshape(nd * n, kp * rp)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _out_kind(scale, relu):
    return (_OUT_INT32 if scale is None
            else _OUT_F32_RELU if relu else _OUT_F32)


def _launch(kernel: str, design: str, x: torch.Tensor, w: torch.Tensor,
            out: torch.Tensor, scale: Optional[torch.Tensor] = None,
            bias: Optional[torch.Tensor] = None, relu: bool = False):
    rows, k = x.numel() // x.shape[-1], x.shape[-1]
    n = w.shape[1]
    if rows == 0 or n == 0:
        return
    p = plan(rows, k, n)
    table = correction_table(kernel, design, str(x.device))
    partial = counters = None
    if p.splits > 1:
        partial = torch.empty((p.splits, rows, n), dtype=torch.int32,
                              device=x.device)
        counters = _counters(x.device, p.row_tiles * p.col_tiles)
    with torch.cuda.device(x.device):
        err = _lib().approx_mm_launch(
            _ptr(x), _ptr(w), rows, k, n, p.bm, p.bn,
            p.k_slice, p.row_tiles, p.col_tiles, p.splits, _ptr(table),
            TABLE_STRIDE, TABLE_BYTES, _ptr(scale), _ptr(bias),
            _out_kind(scale, relu), _ptr(out), _ptr(partial),
            _ptr(counters), 0 if counters is None else counters.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"approx_mm_launch({kernel}) failed: CUDA error "
                           f"{err}")


def _launch_tc(body: str, design: str, x: torch.Tensor, w: torch.Tensor,
               out: torch.Tensor, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, relu: bool = False):
    rows, k = x.numel() // x.shape[-1], x.shape[-1]
    n = w.shape[1]
    w_op, planes, u = exact_weight_operand(w), None, None
    if body == "rank1":
        u, table = _rank1_tables(design, str(w.device))
        planes = rank1_weight_planes(w, design)
    nd, rp, f_ld = ((0, 0, 0) if u is None else
                    (table.shape[0], u.shape[1], planes.shape[1]))
    with torch.cuda.device(x.device):
        err = _lib().tc_mm_launch(
            _TC_BODY[body], _ptr(x), _ptr(w_op), _ptr(planes), _ptr(u),
            rows, k, n, nd, rp, f_ld, _ptr(scale), _ptr(bias),
            _out_kind(scale, relu), _ptr(out),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tc_mm_launch({body}) failed: CUDA error {err}")


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
    if design not in CMP.DESIGNS:
        raise KeyError(f"unknown design {design!r}; known: "
                       f"{tuple(CMP.DESIGNS)}")


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
    launch = _launch_tc if variant == "exact" else _launch
    launch(variant, design, x, w, out, scale, bias, relu)
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
    _launch_tc("rank1", design, x, w, out)
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
    _launch_tc("rank1", design, x, w, out, scale, bias, relu)
    _count(rank1_fused_matmul, "rank1")
    return out


reset_launch_counts()
