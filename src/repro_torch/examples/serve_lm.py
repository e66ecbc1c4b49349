"""Serve a small LM with continuous batching, the twin of the JAX package's
``examples/serve_lm.py``.

A thin wrapper over ``python -m repro_torch.serve`` at the example's
reduced config (smollm-135m's family at 4 layers, d_model 128, d_ff 256):
a mixed-length request queue is served through the fixed-slot KV pool,
with the paper's technique as the quant backend of every projection (QKV,
attention output, MLP, LM head) under per-token activation scales. Freed
slots are refilled mid-decode; ``--policy drain`` switches to the
batch-synchronous baseline. ``--spec-k K`` serves speculatively, tokens
unchanged. On the card unless ``--device cpu``. ``--mesh data,model``
serves over a mesh of the ranks that ``python -m torch.distributed.run``
starts, with the process group's backend named by ``--dist-backend``
(``nccl``: one rank per card; ``gloo``: ranks may share a card or run on
the CPU); without a process group it exits with an error.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
          [--backend approx_deficit_pallas] [--sampling top_k --top-k 8]
      PYTHONPATH=src python -m repro_torch.examples.serve_lm --spec-k 4 \\
          --draft-backend approx_stage1       # speculative, tokens unchanged
      PYTHONPATH=src python -m torch.distributed.run --standalone \
          --nproc-per-node 4 -m repro_torch.examples.serve_lm \
          --mesh data,model --dist-backend gloo --device cpu
"""
from __future__ import annotations

import sys

from repro_torch.serve import __main__ as CLI


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    return CLI.main(["--reduced"] + argv)


if __name__ == "__main__":
    main()
