"""JAX reference results that several of the port's test modules share,
computed once per process: the jitted integer core of every registered
backend (one compile per shape and backend; an eager call compiles each
of its operations apart), the reduced smollm's draw at key 0 of the JAX
serving tests, and the JAX engine's serving of their workload. Integer
results are exact, so a jitted call returns the eager call's sums bit for
bit."""
import dataclasses
import functools
import importlib

import jax
import numpy as np

from repro.configs import registry as RR
from repro.models import transformer_lm as RT
from repro.quant import matmul as RQM
from repro.serve import engine as RE

RQ = importlib.import_module("repro.quant.quantize")

# the JAX package's serving tests' reduced smollm
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=64, vocab_pad=64, head_dim=16)
MAX_LEN = 32

integer_matmul = jax.jit(RQM.integer_matmul, static_argnums=2)
_init = jax.jit(RT.init, static_argnums=0)


@functools.lru_cache(maxsize=None)
def init(rcfg):
    """The JAX package's ``TLM.init`` of ``rcfg`` at key 0, jitted."""
    return _init(rcfg, jax.random.PRNGKey(0))


def tiny_cfg(**overrides):
    return RR.reduced("smollm-135m", **TINY, **overrides)


# (suffix length, max_new) behind a 4-token shared prefix (one page at
# page_size 4): cold prompts and the suffixes of cache hits both prefill in
# the 8-token bucket, so the JAX engine compiles one prefill shape
WORKLOAD_SUFFIXES = ((3, 3), (2, 6), (4, 4), (1, 5))


def workload():
    rng = np.random.default_rng(31)
    shared = rng.integers(0, TINY["vocab"], 4).astype(np.int32)
    return [(rid, np.concatenate([shared, rng.integers(0, TINY["vocab"], n)
                                  .astype(np.int32)]), m)
            for rid, (n, m) in enumerate(WORKLOAD_SUFFIXES)]


def recorded_serve(module, engine):
    """Serve the workload through ``engine`` while recording every logits
    row ``module.sample_token`` sees -> ({rid: tokens}, {(rid, step):
    row}, stats)."""
    rows = {}
    inner = module.sample_token

    def record(logits, scfg, rid, step):
        rows[(rid, step)] = np.asarray(logits, np.float32).copy()
        return inner(logits, scfg, rid, step)

    module.sample_token = record
    try:
        for rid, prompt, max_new in workload():
            engine.submit(module.ServeRequest(rid=rid, prompt=prompt,
                                              max_new=max_new))
        stats = engine.run()
    finally:
        module.sample_token = inner
    return {r.rid: list(r.output) for r in engine.completed}, rows, stats


@functools.lru_cache(maxsize=None)
def jax_served(backend):
    """The JAX engine's serving of the workload on the reduced smollm under
    ``backend`` (2 slots, page size 4)."""
    rcfg = tiny_cfg()
    cfg = dataclasses.replace(rcfg, quant=RQ.for_lm(backend))
    return recorded_serve(RE, RE.Engine(cfg, init(rcfg), slots=2,
                                        max_len=MAX_LEN, page_size=4))
