"""Quickstart: the paper's approximate multiplier in five minutes, the twin
of the JAX package's ``examples/quickstart.py``.

Builds the proposed 4:2 compressor and 8x8 multiplier, reproduces the
Table-2 error metrics, shows the deficit identity that the CUDA-core
kernel subtracts, and runs an approximate int8 matmul through the public
API on the card (``--device cpu`` runs it on the CPU).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import compressors as C
from repro_torch.core import deficit as D
from repro_torch.core import luts
from repro_torch.core import metrics as X
from repro_torch.core import multiplier as M
from repro_torch.nn.module import resolve_device
from repro_torch.quant.matmul import quantized_matmul
from repro_torch.quant.quantize import QuantConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device of the matmul (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. the proposed compressor: min(x1+x2+x3+x4, 3) -- one error
    # combination
    for idx in (0b0111, 0b1111):
        x = [(idx >> k) & 1 for k in range(4)]
        s, c = C.compress("proposed", *x)
        print(f"inputs={x} exact={sum(x)} approx={int(s) + 2 * int(c)}")

    # 2. the all-approximate 8x8 multiplier reproduces paper Table 2
    cfg = M.proposed_multiplier("proposed")
    m = X.evaluate(M.exhaustive_products(cfg), X.exhaustive_exact())
    print(f"multiplier: {m.row()}  (paper: ER 6.994 NMED 0.046 MRED 0.109)")

    # 3. deficit identity: approx(a,b) = a*b - sum of compressor-site
    # deficits
    E = luts.error_lut(cfg)
    a, b = map(int, np.unravel_index(np.argmin(E), E.shape))  # worst pair
    approx = int(M.multiply(np.int64(a), np.int64(b), cfg))
    err = int(D.deficit_sum(np.int64(a), np.int64(b)))
    ok = approx == a * b - err
    print(f"{a}*{b} = {a * b} exact, {approx} approx, deficit={err} -> "
          f"identity {'OK' if ok else 'FAIL'}")

    # 4. an approximate-multiplier matmul through the quantized layer API
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(4, 64)),
                        dtype=torch.float32, device=dev)
    w = torch.as_tensor(np.random.default_rng(1).normal(size=(64, 8)),
                        dtype=torch.float32, device=dev)
    y_exact = x @ w
    y_approx = quantized_matmul(x, w, QuantConfig(backend="approx_lut"))
    rel = float(torch.linalg.norm(y_approx - y_exact)
                / torch.linalg.norm(y_exact))
    print(f"approx matmul relative error vs float: {rel:.4f} "
          f"(quantization + approximate products)")
    return {"metrics": m, "identity_ok": ok, "pair": (a, b), "rel": rel}


if __name__ == "__main__":
    main()
