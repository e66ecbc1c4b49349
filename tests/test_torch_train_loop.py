"""The port's fault-tolerant LM training loop (``repro_torch.train.
train_loop``) and its example (``python -m repro_torch.examples.lm_train``)
against the JAX package's, on the CPU.

  * crash and resume, as the JAX package's ``tests/test_train.py`` holds
    its own loop;
  * parity across the packages: the JAX ``train()`` runs 4 steps of a
    reduced smollm (two microbatches, int8 optimizer state, a checkpoint
    every 2 steps); the port resumes from a copy of its step-2 checkpoint
    and runs steps 2-3 on the batches the JAX run took there. Its two
    losses and its parameters after step 4 match the JAX step-4
    checkpoint within STEP_RTOL (tests/test_torch_lm_train.py's; a CPU
    run's largest gap in brackets: losses [0], parameters [4.0e-7]), and
    so do its moments, as far as their storage allows: the bf16 first
    moment within STEP_RTOL of its largest magnitude plus one bf16 place of
    the element for each of the two steps [two places], since each step
    rounds it to bf16, and two float32 values that differ in their last
    places may round to neighbouring bf16 values (the next step carries
    that place on, times b1); the int8 second-moment codes within one
    code for the same reason [0]; their float32 scales within STEP_RTOL
    [1.5e-7]. The run does not fake-quantize (``qat`` off, the loop's
    default): under ``qat`` the two packages' straight-through masks
    differ at channel maxima (tests/test_torch_lm_train.py), and over two
    steps that difference reaches every weight through the loss;
  * the same under ``qat`` for one step: the JAX run checkpoints every
    step, the port resumes from its step 2 and runs step 2, and matches
    its step-3 checkpoint as above, except at each output channel's
    largest weight of the step-2 layer matrices and each vocab row's of
    the tied head (the masks differ there, as that file finds;
    a step's forward does not depend on the mask, so one step cannot
    carry the gap elsewhere: a CPU run's largest gap elsewhere, loss
    [1.2e-7], parameters [6.3e-8], m [one bf16 place], v codes [0],
    scales [2.7e-7]);
  * AdamW's update by row slices equals the whole-leaf update bit for bit.
"""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RR
from repro.data import synthetic as RD
from repro.optim import adamw as RA
from repro.train import train_loop as RL

from repro_torch.configs import registry as PR
from repro_torch.examples import lm_train as EX
from repro_torch.optim import adamw as A
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_loop import TrainConfig, train

torch.set_num_threads(1)

TINY = dict(n_layers=2, d_model=64, d_ff=128, vocab=64, vocab_pad=64)
STEP_RTOL = 1e-4


def _batches(start=0, b=4, s=16, seed=0, to=torch.from_numpy):
    """test_train.py's stream: batch i is rows (i * b) % 60 onwards."""
    toks = RD.token_stream(64, s + 1, TINY["vocab"], seed)
    i = start
    while True:
        sl = toks[(i * b) % 60:(i * b) % 60 + b]
        yield {"tokens": to(sl[:, :-1]), "labels": to(sl[:, 1:])}
        i += 1


def test_crash_and_resume(tmp_path):
    cfg = PR.reduced("smollm-135m", **TINY)
    tc = TrainConfig(steps=20, ckpt_every=5, ckpt_dir=str(tmp_path),
                     log_every=100, fail_at_step=12)
    with pytest.raises(RuntimeError, match="injected failure at step 12"):
        train(cfg, A.AdamWConfig(lr=1e-2), tc, _batches(), device="cpu")
    assert CheckpointManager(tmp_path).all_steps() == [5, 10]
    tc2 = TrainConfig(steps=20, ckpt_every=5, ckpt_dir=str(tmp_path),
                      log_every=100)
    out = train(cfg, A.AdamWConfig(lr=1e-2), tc2, _batches(), device="cpu")
    assert out["resumed_from"] == 10
    assert len(out["losses"]) == 10 and np.isfinite(out["losses"]).all()
    assert CheckpointManager(tmp_path).all_steps() == [10, 15, 20]
    assert int(out["opt_state"]["count"][0]) == 20


def _within_bf16_places(got, want, places, name):
    got = got.double().numpy()
    want = want.double().numpy()
    bound = (STEP_RTOL * np.abs(want).max()
             + places * np.abs(want) * 2.0 ** -7)
    assert (np.abs(got - want) <= bound).all(), name


def _resume_the_reference_run(tmp_path, steps, qat, **kw):
    """The JAX ``train()`` of ``steps`` steps, then the port's resumed
    from a copy of its step-2 checkpoint; returns the port's output, the
    JAX losses and the JAX checkpoints' manager."""
    rcfg = RR.reduced("smollm-135m", **TINY)
    pcfg = PR.reduced("smollm-135m", **TINY)
    kw = dict(steps=steps, log_every=100, microbatches=2, qat=qat, **kw)
    ref = RL.train(rcfg, RA.AdamWConfig(lr=1e-2, quantized_state=True),
                   RL.TrainConfig(ckpt_dir=str(tmp_path / "jax"), **kw),
                   _batches(to=jnp.asarray))
    shutil.copytree(tmp_path / "jax" / "step_0000000002",
                    tmp_path / "port" / "step_0000000002")
    out = train(pcfg, A.AdamWConfig(lr=1e-2, quantized_state=True),
                TrainConfig(ckpt_dir=str(tmp_path / "port"), **kw),
                _batches(start=2), device="cpu")
    assert out["resumed_from"] == 2
    np.testing.assert_allclose(out["losses"], ref["losses"][2:], rtol=0,
                               atol=STEP_RTOL * max(ref["losses"][2:]))
    return out, CheckpointManager(tmp_path / "jax")


def _matches_checkpoint(out, mgr, step, keep_of=lambda path: None):
    """The port's params and optimizer state after ``step`` steps against
    the JAX checkpoint of that step, over the elements ``keep_of(path)``
    selects (all if None)."""
    like = {"params": out["params"], "opt": out["opt_state"]}
    want = mgr.restore(step, like)
    for (path, got), (_, w) in zip(A.flatten(like), A.flatten(want)):
        name = "/".join(map(str, path))
        assert got.dtype == w.dtype and got.shape == w.shape, name
        keep = keep_of(path)
        if keep is not None:
            got, w = got[keep], w[keep]
        if path[-1] == "m":
            _within_bf16_places(got, w, len(out["losses"]), name)
        elif path[-1] == "v_q":
            assert (got.int() - w.int()).abs().max() <= 1, name
        elif name == "opt/count":
            assert int(got[0]) == int(w[0]) == step
        else:
            scale = float(w.double().abs().max())
            np.testing.assert_allclose(got.double().numpy(),
                                       w.double().numpy(), rtol=0,
                                       atol=STEP_RTOL * scale, err_msg=name)


def test_port_resumes_the_reference_run_and_matches_it(tmp_path):
    out, mgr = _resume_the_reference_run(tmp_path, 4, False, ckpt_every=2)
    _matches_checkpoint(out, mgr, 4)


def test_port_resumes_the_reference_qat_run_for_one_step(tmp_path):
    out, mgr = _resume_the_reference_run(tmp_path, 3, True, ckpt_every=1)
    start = {path: w.abs() for path, w in A.flatten(
        mgr.restore(2, {"params": out["params"]})["params"])}

    def keep_of(path):
        """Not at a fake-quantized channel maximum of the step-2 weights,
        for a weight, its first moment and its v codes: each output
        channel's of a layer matrix (``blocks``' (layers, d_in, d_out)
        leaves), each vocab row's of the tied head."""
        if path[-1] == "v_scale" or path == ("opt", "count"):
            return None
        w = start[path[1 + (path[0] == "opt"):len(path) - (path[0] == "opt")]]
        if path[-2 + (path[0] == "params")] == "table" or (
                "blocks" in path and w.ndim == 3):
            return w != w.amax(dim=1, keepdim=True)
        return None

    _matches_checkpoint(out, mgr, 3, keep_of)


def test_example_crashes_and_resumes_on_the_cpu(tmp_path, capsys):
    out = EX.main(["--model-scale", "tiny", "--crash", "--steps", "15",
                   "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "crashed as requested (injected failure at step 10)" in text
    assert out["resumed_from"] == 10 and len(out["losses"]) == 5
    assert np.isfinite(out["losses"]).all()
    assert "(resumed_from=10)" in text


def test_adamw_update_by_row_slices_equals_the_whole_leaf(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((3, 70, 300), generator=gen)
              .to(torch.bfloat16),
              "b": torch.randn((300,), generator=gen),
              "t": torch.randn((5000, 7), generator=gen)}
    grads = A.unflatten((p, torch.randn(t.shape, generator=gen))
                        for p, t in A.flatten(params))
    for quantized in (False, True):
        cfg = A.AdamWConfig(lr=1e-3, quantized_state=quantized)
        runs = []
        for slice_ in (1 << 30, 1000):
            monkeypatch.setattr(A, "UPDATE_SLICE", slice_)
            p, s = params, A.init(params, cfg)
            for _ in range(2):
                p, s = A.update(grads, s, p, cfg)
            runs.append(A.flatten({"p": p, "s": s}))
        for (path, a), (_, b) in zip(*runs):
            assert torch.equal(a, b), path
