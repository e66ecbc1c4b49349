"""Digit recognition with the custom approximate convolution layer (paper
Table 5), the twin of the JAX package's ``examples/mnist_train.py``.

Thin wrapper over the evaluation harness: trains LeNet-5 with QAT on the
synthetic digit set and sweeps every registered quant backend, printing
the accuracy comparison table. Writes to the scratch dir
experiments/torch/scratch/; the committed artifacts under
experiments/torch/eval/ are only written by ``python -m repro_torch.eval
run``. On the card unless ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.examples.mnist_train [--smoke]
Same as:  PYTHONPATH=src python -m repro_torch.eval run --suite mnist
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.eval.cli import SCRATCH_OUT, main as eval_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="minute-scale budget (few steps, small eval set)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rc = eval_main(["run", "--suite", "mnist", "--out", str(SCRATCH_OUT),
                    "--device", args.device]
                   + (["--smoke"] if args.smoke else []))
    if rc == 0:                 # don't mask a failure with a stale table
        print((SCRATCH_OUT / "mnist.md").read_text())
        print("paper Table 5 (LeNet-5): exact 98.24, proposed 96.45, "
              "[13] 91.66")
    return rc


if __name__ == "__main__":
    sys.exit(main())
