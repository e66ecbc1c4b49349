"""Rank functions of the port's mesh-training tests: each runs in every rank
of a spawned world (``repro_torch.parallel.collectives.run_world``) and
returns host objects to the test. This module imports no JAX, so that a
spawned rank does not import it."""
import dataclasses
from pathlib import Path

import torch

from repro_torch.configs import registry
from repro_torch.launch.mesh import make_production_mesh, make_serving_mesh
from repro_torch.models import transformer_lm as TLM
from repro_torch.optim import adamw as A
from repro_torch.parallel.collectives import gather_tree
from repro_torch.parallel.pipeline import pipeline_apply
from repro_torch.parallel.sharding import map_specs, slice_leaf
from repro_torch.quant.quantize import for_lm
from repro_torch.train import steps as ST
from repro_torch.train.cnn_train import value_and_grad
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_loop import TrainConfig, train

# tests/test_torch_lm_train.py's reduced smollm (vocab 256)
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=256, vocab_pad=256, head_dim=16)
MOE = dict(n_layers=1)             # the reduced deepseek-v2: MLA and experts
STEPS = 3
# (qat, backend) of each mode: float products, fake-quant, and the STE
# through the deficit kernel's plain version
MODES = {"float32": (False, "bf16"), "qat": (True, "bf16"),
         "deficit": (False, "approx_deficit_pallas")}
LR = 2e-3
U = 2.0 ** -24                     # float32's unit roundoff


def gamma(k: int) -> float:
    return k * U / (1 - k * U)


def smollm(backend="bf16"):
    return dataclasses.replace(registry.reduced("smollm-135m", **TINY),
                               quant=for_lm(backend))


def moe(backend="bf16"):
    return dataclasses.replace(registry.reduced("deepseek-v2-236b", **MOE),
                               quant=for_lm(backend))


def _tensors(batch_np):
    return {k: torch.from_numpy(v) for k, v in batch_np.items()}


def _differing(a, b) -> list:
    """Paths of the leaves of two trees that differ in dtype or bits."""
    return ["/".join(map(str, p)) for (p, x), (_, y) in
            zip(A.flatten(a), A.flatten(b))
            if x.dtype != y.dtype or x.shape != y.shape
            or not torch.equal(x, y)]


def steps_against_one_device(mesh, cfg, params, batches, qat: bool,
                             ocfg) -> dict:
    """STEPS sharded steps against make_train_step(num_microbatches=2) on
    one device from the same params: the leaves that differ after each
    step (params, AdamW state), the two runs' losses, and the shard
    shapes."""
    one = ST.make_train_step(cfg, ocfg, num_microbatches=2, qat=qat)
    step = ST.make_train_step(cfg, ocfg, qat=qat, mesh=mesh)
    plan = step.plan
    p1, s1 = params, A.init(params, ocfg)
    pm, sm = plan.shard_params(params), plan.init_state("cpu")
    shapes = [tuple(t.shape) for _, t in A.flatten(pm)]
    out = {"differ": [], "losses": [], "losses_one": [],
           "shapes": shapes, "by_shard": plan.by_shard}
    for b in batches:
        b = _tensors(b)
        p1, s1, m1 = one(p1, s1, b)
        pm, sm, mm = step(pm, sm, b)
        out["losses"].append(mm["loss"].item())
        out["losses_one"].append(m1["loss"].item())
        out["differ"].append(
            _differing(plan.full_params(pm), p1)
            + _differing(plan.full_state(sm), s1)
            + ([] if torch.equal(mm["loss"], m1["loss"]) else ["loss"]))
    return out


def grads_within_bound(mesh, cfg, params, batch, qat: bool) -> dict:
    """Two microbatches per rank: ``mesh_grads`` against the single-device
    sum of all four microbatches, each element within the bound of
    ``train.steps`` (2 gamma(3) sum_i |g_i| / 4); the largest gap over its
    bound, and whether any element differs at all."""
    def loss_fn(p, b):
        return TLM.forward_loss(p, b, cfg, qat=qat, training=True)

    b = _tensors(batch)
    loss, grads = ST.mesh_grads(loss_fn, params, b, mesh, 2)
    chunks = {k: torch.chunk(v, 4) for k, v in b.items()}
    parts = [{k: v[i] for k, v in chunks.items()} for i in range(4)]
    per = [A.flatten(value_and_grad(loss_fn, params, mb)[1]) for mb in parts]
    worst, differs = 0.0, False
    for j, (path, g) in enumerate(A.flatten(grads)):
        terms = [pm[j][1].to(torch.float32) for pm in per]
        seq = terms[0]
        for t in terms[1:]:
            seq = seq + t
        seq = seq / 4
        bound = 2 * gamma(3) * sum(t.abs() for t in terms) / 4
        gap = (g - seq).abs()
        differs |= bool((gap > 0).any())
        ok = gap <= bound
        if not bool(ok.all()):
            return {"within": False, "path": path}
        nz = bound > 0
        if bool(nz.any()):
            worst = max(worst, float((gap[nz] / bound[nz]).max()))
    return {"within": True, "worst_over_bound": worst, "differs": differs,
            "loss": float(loss)}


def loop_runs(mesh, cfg, batches, tmp: Path, rank: int) -> dict:
    """The loop on the mesh: an uninterrupted run, a run that fails after
    step 2 and its rerun, the single-device loop (rank 0; two
    microbatches), and a restore of the mesh's step-4 checkpoint onto a
    (1, 4) mesh."""
    ocfg = A.AdamWConfig(lr=LR, quantized_state=True)
    base = dict(steps=4, ckpt_every=2, log_every=100)

    def feed(start):
        return iter([batches[i % len(batches)]
                     for i in range(start, base["steps"])])

    whole = train(cfg, ocfg, TrainConfig(ckpt_dir=str(tmp / "whole"), **base),
                  feed(0), seed=0, device="cpu", mesh=mesh)
    crash = TrainConfig(ckpt_dir=str(tmp / "crash"), fail_at_step=2, **base)
    try:
        train(cfg, ocfg, crash, feed(0), seed=0, device="cpu", mesh=mesh)
        raised = False
    except RuntimeError as e:
        raised = "injected failure at step 2" in str(e)
    again = train(cfg, ocfg, dataclasses.replace(crash, fail_at_step=-1),
                  feed(2), seed=0, device="cpu", mesh=mesh)
    specs = whole["specs"]
    full = gather_tree({"params": whole["params"], "opt": whole["opt_state"]},
                       specs, mesh)
    resumed = gather_tree({"params": again["params"],
                           "opt": again["opt_state"]}, specs, mesh)
    out = {"raised": raised, "resumed_from": again["resumed_from"],
           "losses": whole["losses"], "losses_resumed": again["losses"],
           "resume_differs": _differing(resumed, full)}
    if rank == 0:
        single = TrainConfig(ckpt_dir=str(tmp / "single"), microbatches=2,
                             **base)
        one = train(cfg, ocfg, single, feed(0), seed=0, device="cpu")
        out["single_losses"] = one["losses"]
        out["single_differs"] = _differing(
            {"params": one["params"], "opt": one["opt_state"]}, full)
    # restore step 4 onto a (1, 4) mesh: each rank its slice
    mesh14 = make_serving_mesh((1, 4), device_type="cpu")
    plan = ST.TrainPlan(cfg, ocfg, mesh14)
    params = TLM.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    like = {"params": plan.shard_params(params),
            "opt": plan.init_state("cpu")}
    got = CheckpointManager(tmp / "whole").restore(4, like, plan.specs,
                                                   mesh14)
    want = map_specs(lambda t, s: slice_leaf(t, s, mesh14), full, plan.specs)
    out["remesh_differs"] = _differing(got, want)
    out["remesh_sharded"] = sorted(
        "/".join(map(str, p)) for (p, g), (_, f) in
        zip(A.flatten(got), A.flatten(full)) if g.shape != f.shape)
    # and onto one device: the whole leaves
    one_dev = CheckpointManager(tmp / "whole").restore(4, full)
    out["one_device_differs"] = _differing(one_dev, full)
    return out


def pipeline_runs(ws, micro: dict) -> dict:
    """``pipeline_apply`` of tanh(x @ w) over a 4-rank ('stage',) mesh for
    each microbatch count, with the port's sequential loop (microbatch by
    microbatch, stage by stage) on this rank."""
    mesh = make_serving_mesh((4,), ("stage",), device_type="cpu")
    w = torch.from_numpy(ws)

    def fn(wi, x):
        return torch.tanh(x @ wi)

    out = {}
    for m, mb in micro.items():
        x = torch.from_numpy(mb)
        got = pipeline_apply(fn, mesh, w, x)
        seq = []
        for i in range(x.shape[0]):
            y = x[i]
            for s in range(w.shape[0]):
                y = fn(w[s], y)
            seq.append(y)
        out[m] = (got.numpy(), torch.equal(got, torch.stack(seq)))
    return out


def train_rank(rank: int, params_np, batches, ws, micro, tmp: str) -> dict:
    """Every mesh-training check of tests/test_torch_train_mesh.py on one
    rank of a 2 x 2 ('data', 'model') mesh."""
    torch.set_num_threads(1)
    mesh = make_serving_mesh((2, 2), device_type="cpu")
    tmp = Path(tmp)
    params = TLM.map_leaves(torch.from_numpy, params_np)
    qocfg = A.AdamWConfig(lr=LR, quantized_state=True)
    res = {"coords": mesh.get_coordinate()}
    for mode, (qat, backend) in MODES.items():
        res[("smollm", mode)] = steps_against_one_device(
            mesh, smollm(backend), params, batches, qat, qocfg)
        mparams = TLM.init(moe(backend), torch.Generator().manual_seed(0),
                           device="cpu")
        res[("moe", mode)] = steps_against_one_device(
            mesh, moe(backend), mparams, batches, qat, qocfg)
    res["bound"] = grads_within_bound(mesh, smollm(), params, batches[0],
                                      True)
    # one QAT step with float32 moments, for the JAX package's step
    focfg = A.AdamWConfig(lr=LR)
    step = ST.make_train_step(smollm(), focfg, qat=True, mesh=mesh)
    pm, sm, mm = step(step.plan.shard_params(params),
                      step.plan.init_state("cpu"), _tensors(batches[0]))
    res["jax_step"] = {
        "loss": mm["loss"].item(),
        "params": TLM.map_leaves(lambda t: t.numpy(),
                                 step.plan.full_params(pm)),
        "m": [t.numpy() for _, t in
              A.flatten(step.plan.full_state(sm)["params"])][0::2]}
    res["loop"] = loop_runs(mesh, smollm(), batches, tmp / "loop", rank)
    res["pipeline"] = pipeline_runs(ws, micro)
    try:
        make_production_mesh(device_type="cpu")
        res["production"] = None
    except ValueError as e:
        res["production"] = str(e)
    return res
