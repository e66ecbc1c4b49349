"""Train a small LM end to end with fault tolerance (checkpoint and
restart): the twin of the JAX package's ``examples/lm_train.py``.

AdamW with int8 optimizer states, two microbatches, atomic checkpoints
every 10 steps, an injected crash at step 2/3 of the run (``--crash``) and
the automatic resume. ``--model-scale 100m`` trains the published
smollm-135m at batch 32 x 1,024; the default ``tiny`` (4 layers, 128 wide,
batch 8 x 64) also fits the CPU.

Run:  PYTHONPATH=src python -m repro_torch.examples.lm_train \\
          [--steps 60] [--crash] [--model-scale tiny|100m] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.optim import adamw
from repro_torch.train.train_loop import TrainConfig, train


def config(scale: str):
    """(ArchConfig, batch, seq) of a model scale."""
    if scale == "tiny":
        return registry.reduced("smollm-135m", n_layers=4, d_model=128,
                                d_ff=256, vocab=512, vocab_pad=512), 8, 64
    return registry.get("smollm-135m"), 32, 1024


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--crash", action="store_true",
                    help="inject a failure at step 2/3 of the run, then "
                         "resume")
    ap.add_argument("--model-scale", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg, batch, seq = config(args.model_scale)
    toks = synthetic.token_stream(512, seq + 1, cfg.vocab)

    def batches():
        i = 0
        while True:
            sl = toks[(i * batch) % 500:(i * batch) % 500 + batch]
            yield {"tokens": torch.from_numpy(sl[:, :-1]),
                   "labels": torch.from_numpy(sl[:, 1:])}
            i += 1

    tc = TrainConfig(steps=args.steps, ckpt_every=10, ckpt_dir=args.ckpt_dir,
                     log_every=10, microbatches=2,
                     fail_at_step=(2 * args.steps // 3) if args.crash else -1)
    ocfg = adamw.AdamWConfig(lr=2e-3, quantized_state=True)
    try:
        out = train(cfg, ocfg, tc, batches(), device=args.device)
    except RuntimeError as e:
        print(f"crashed as requested ({e}); resuming ...")
        tc2 = TrainConfig(steps=args.steps, ckpt_every=10,
                          ckpt_dir=args.ckpt_dir, log_every=10,
                          microbatches=2)
        out = train(cfg, ocfg, tc2, batches(), device=args.device)
    print(f"final loss {out['losses'][-1]:.4f} "
          f"(resumed_from={out['resumed_from']})")
    return out


if __name__ == "__main__":
    main()
