"""Serve an LM with continuous batching from the command line.

    python -m repro_torch.serve [--backend approx_deficit_pallas]
    python -m repro_torch.serve --device cpu --reduced
    python -m repro_torch.serve --sampling top_k --top-k 8
    python -m repro_torch.serve --arch rwkv6-3b [--device cpu --reduced]

The port's counterpart of the JAX package's ``examples/serve_lm.py``: a
mixed-length request queue is served through the fixed-slot KV pool, with
the approximate multiplier as the quant backend of every projection (QKV,
attention output, MLP, LM head) under per-token activation scales. The
model is full-width smollm-135m by default (``--arch``), with random
weights from ``--seed``; ``--reduced`` serves the example's 4-layer,
128-wide config instead; a windowed arch's prompts are drawn no longer
than its ring (hymba's reduced window is 8). It runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.models import transformer_lm as TLM
from repro_torch.quant.matmul import list_backends
from repro_torch.quant.quantize import for_lm
from repro_torch.serve import Engine, SamplingConfig, ServeRequest


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve")
    ap.add_argument("--arch", default="smollm-135m",
                    help="architecture (configs/registry.py)")
    ap.add_argument("--reduced", action="store_true",
                    help="the 4-layer, 128-wide config of the arch's family")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default: the card)")
    ap.add_argument("--backend", default="bf16",
                    choices=["bf16", *list_backends()])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--policy", default="continuous",
                    choices=["continuous", "drain"])
    ap.add_argument("--sampling", default="greedy",
                    choices=["greedy", "temperature", "top_k"])
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend a common prefix of this many tokens to "
                         "every prompt (requests after the first "
                         "retirement hit the paged prefix cache)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable the paged KV prefix cache")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are emitted")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.reduced:
        cfg = registry.reduced(args.arch, n_layers=4, d_model=128, d_ff=256)
    else:
        cfg = registry.get(args.arch)
    cfg = dataclasses.replace(cfg, quant=for_lm(args.backend))
    params = TLM.init(cfg, torch.Generator().manual_seed(args.seed),
                      device=args.device)
    scfg = SamplingConfig(kind=args.sampling, temperature=args.temperature,
                          top_k=args.top_k, seed=args.seed)
    stream = ((lambda rid, tok: print(f"  rid {rid} -> {tok}"))
              if args.stream else None)
    eng = Engine(cfg, params, slots=args.slots, max_len=64,
                 admission=args.policy, stream=stream,
                 prefix_caching=not args.no_prefix_cache, device=args.device)
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, cfg.vocab, args.shared_prefix).astype(np.int32)
    # a windowed ring takes a prompt of at most its window
    limit = TLM.prefill_limit(cfg, eng.max_len)
    for rid in range(args.requests):
        plen = int(rng.integers(4, 17))          # mixed-length workload
        if limit is not None:
            plen = max(1, min(plen, limit - len(shared)))
        prompt = np.concatenate(
            [shared, rng.integers(0, cfg.vocab, plen).astype(np.int32)])
        eng.submit(ServeRequest(
            rid=rid, prompt=prompt,
            max_new=int(rng.integers(min(4, args.max_new),
                                     args.max_new + 1)),
            sampling=scfg))
    stats = eng.run()
    dev = eng.device
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab}, on {name}")
    for r in sorted(eng.completed, key=lambda r: r.rid):
        ttft = (f"{r.timing.ttft_s * 1e3:7.1f} ms"
                if r.timing.ttft_s is not None else "      —")
        print(f"rid {r.rid}: {len(r.output):2d} tokens ({r.finish_reason}), "
              f"ttft {ttft}")
    print(f"backend={args.backend} policy={args.policy}: "
          f"{stats['requests']} requests in {stats['decode_steps']} decode "
          f"steps / {stats['waves']} admission waves, {stats['new_tokens']} "
          f"tokens, {stats['tok_per_s']:.1f} tok/s, "
          f"occupancy {stats['occupancy']:.2f}, "
          f"prefix hit rate {stats['prefix_hit_rate']:.2f} "
          f"({stats['prefix_hit_tokens']} of "
          f"{stats['prefix_hit_tokens'] + stats['prefill_tokens']} prompt "
          f"tokens from cache)")
    return stats


if __name__ == "__main__":
    main()
