"""Serve an LM with continuous batching from the command line.

    python -m repro_torch.serve [--backend approx_deficit_pallas]
    python -m repro_torch.serve --device cpu --reduced
    python -m repro_torch.serve --sampling top_k --top-k 8
    python -m repro_torch.serve --arch rwkv6-3b [--device cpu --reduced]
    python -m repro_torch.serve --spec-k 4 --draft-backend approx_stage1
    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.serve --mesh data,model --dist-backend gloo

The port's counterpart of the JAX package's ``examples/serve_lm.py``: a
mixed-length request queue is served through the fixed-slot KV pool, with
the approximate multiplier as the quant backend of every projection (QKV,
attention output, MLP, LM head) under per-token activation scales. The
model is full-width smollm-135m by default (``--arch``), with random
weights from ``--seed``; ``--reduced`` serves the example's 4-layer,
128-wide config instead; a windowed arch's prompts are drawn no longer
than its ring (hymba's reduced window is 8). It runs on the card unless
``--device cpu``. The engine serves token models only:
``--arch llama-3.2-vision-11b`` (cross-attention) and ``--arch
musicgen-large`` (stub embeddings) exit with its ``ValueError`` before any
weight is drawn. ``--spec-k K`` serves with draft-model speculation
(``serve/speculative.py``): the served tokens are bitwise those of
``--spec-k 0``, only the number of passes changes.

``--mesh data,model`` serves over a ('data', 'model') ``DeviceMesh`` of
the ranks that ``python -m torch.distributed.run`` starts, one rank per
mesh position, each running this script (``Engine(mesh=)``); the backend
of their process group is ``--dist-backend``, named explicitly: ``nccl``
takes one rank per card, ``gloo`` lets several ranks share one card (or
the CPU). Without a process group to join, ``--mesh`` exits with an error
rather than serving unsharded. Rank 0 prints; every rank returns the
stats.
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
from repro_torch.serve import (Engine, SamplingConfig, ServeRequest,
                               SpecConfig)
from repro_torch.serve.engine import check_servable


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        epilog="Sharded serving: python -m torch.distributed.run "
        "--standalone --nproc-per-node N -m repro_torch.serve --mesh "
        "data,model --dist-backend {nccl,gloo}")
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
    ap.add_argument("--spec-k", type=int, default=0, metavar="K",
                    help="speculative decoding with a K-wide verify window "
                         "(serve/speculative.py): served tokens are bitwise "
                         "identical to sequential decode, only the number "
                         "of passes changes; 0 disables")
    ap.add_argument("--draft-backend", default="bf16",
                    choices=["bf16", *list_backends()],
                    help="backend the draft model proposes on (same "
                         "params)")
    ap.add_argument("--mesh", default=None, metavar="AXES",
                    help="serve over a mesh with these axis names (e.g. "
                         "data,model) of the torch.distributed.run ranks, "
                         "the world split as evenly as it goes, the larger "
                         "factor last")
    ap.add_argument("--dist-backend", default=None,
                    choices=["nccl", "gloo"],
                    help="the process group's backend (required with "
                         "--mesh)")
    return ap.parse_args(argv)


def join_mesh(args):
    """The mesh of ``--mesh`` over the ranks of ``torch.distributed.run``;
    exits with an error where there is no process group to join."""
    from repro_torch.launch.mesh import join_mesh as join
    return join(args.mesh, args.dist_backend, torch.device(args.device).type)


def main(argv=None) -> dict:
    """Serve the workload; returns the engine's stats with the served
    ``tokens`` ({rid: [token, ...]})."""
    args = parse_args(argv)
    mesh = join_mesh(args) if args.mesh else None
    try:
        return serve(args, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def serve(args, mesh) -> dict:
    import torch.distributed as dist
    say = (print if mesh is None or dist.get_rank() == 0
           else (lambda *a, **k: None))
    if args.reduced:
        cfg = registry.reduced(args.arch, n_layers=4, d_model=128, d_ff=256)
    else:
        cfg = registry.get(args.arch)
    check_servable(cfg)
    cfg = dataclasses.replace(cfg, quant=for_lm(args.backend))
    params = TLM.init(cfg, torch.Generator().manual_seed(args.seed),
                      device=args.device)
    scfg = SamplingConfig(kind=args.sampling, temperature=args.temperature,
                          top_k=args.top_k, seed=args.seed)
    stream = ((lambda rid, tok: say(f"  rid {rid} -> {tok}"))
              if args.stream else None)
    spec = (SpecConfig(k=args.spec_k, draft_backend=args.draft_backend)
            if args.spec_k > 0 else None)
    eng = Engine(cfg, params, slots=args.slots, max_len=64,
                 admission=args.policy, stream=stream,
                 prefix_caching=not args.no_prefix_cache, spec=spec,
                 mesh=mesh, device=args.device)
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
    say(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab}, on {name}" + (
            "" if mesh is None else
            f", mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
            f"{dist.get_backend()}"))
    for r in sorted(eng.completed, key=lambda r: r.rid):
        ttft = (f"{r.timing.ttft_s * 1e3:7.1f} ms"
                if r.timing.ttft_s is not None else "      —")
        say(f"rid {r.rid}: {len(r.output):2d} tokens ({r.finish_reason}), "
            f"ttft {ttft}")
    say(f"backend={args.backend} policy={args.policy}: "
        f"{stats['requests']} requests in {stats['decode_steps']} decode "
        f"steps / {stats['waves']} admission waves, {stats['new_tokens']} "
        f"tokens, {stats['tok_per_s']:.1f} tok/s, "
        f"occupancy {stats['occupancy']:.2f}, "
        f"prefix hit rate {stats['prefix_hit_rate']:.2f} "
        f"({stats['prefix_hit_tokens']} of "
        f"{stats['prefix_hit_tokens'] + stats['prefill_tokens']} prompt "
        f"tokens from cache)")
    if spec is not None:
        say(f"speculative K={args.spec_k} draft={args.draft_backend}: "
            f"{stats['spec_passes']} verify passes, "
            f"{stats['spec_committed']} committed "
            f"({stats['spec_accept_mean']:.2f} drafts accepted/pass, "
            f"hist {stats['spec_accept_hist']}) — tokens bitwise "
            f"identical to --spec-k 0")
    return {**stats, "tokens": {r.rid: [int(t) for t in r.output]
                                for r in eng.completed}}


if __name__ == "__main__":
    main()
