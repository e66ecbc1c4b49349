"""Image denoising with approximate convolutions (paper §5.2, Figs 7-8),
the twin of the JAX package's ``examples/denoise.py``.

Thin wrapper over the evaluation harness: trains a small FFDNet on
synthetic textures and sweeps every registered quant backend, printing the
PSNR/SSIM comparison table. Writes to the scratch dir
experiments/torch/scratch/; the committed artifacts under
experiments/torch/eval/ are only written by ``python -m repro_torch.eval
run``. On the card unless ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.examples.denoise [--smoke]
Same as:  PYTHONPATH=src python -m repro_torch.eval run --suite denoise
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.eval.cli import SCRATCH_OUT, main as eval_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="minute-scale budget (tiny model, few steps)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rc = eval_main(["run", "--suite", "denoise", "--out", str(SCRATCH_OUT),
                    "--device", args.device]
                   + (["--smoke"] if args.smoke else []))
    if rc == 0:                 # don't mask a failure with a stale table
        print((SCRATCH_OUT / "denoise.md").read_text())
    return rc


if __name__ == "__main__":
    sys.exit(main())
