"""The port's training path against the JAX package's: fake-quant and its
straight-through gradient, the STE backward of quantized_matmul, AdamW
(float32 and int8 second-moment state), one QAT train_step of LeNet-5 and
of a small FFDNet, and five steps of fit — on the same numpy inputs and
starting weights.

Tolerances, each relative to the largest magnitude of the reference
leaf it bounds (the largest gap of a CPU run in brackets):
  * fake-quant: bitwise, forward and gradient (the same divide, round half
    to even, clip and compare in float32);
  * STE gradients: GRAD_RTOL [1.7e-7]. dx and db are float32 sums of the
    same terms; dw = x.T @ g sums over every row, in another order in the
    two libraries' matmuls.
  * AdamW: the int8 v codes exact; the first update's moments bitwise;
    everything else within UPDATE_RTOL [1.2e-7]: under jit XLA contracts
    the moments' multiply-adds into FMAs, and with clipping on the global
    norm is a sum in another order. The bfloat16 first moment of the
    int8-state mode is held to UPDATE_RTOL absolute [4.8e-7, one bfloat16
    rounding step at 1.2e-4]: one FMA can flip its rounding.
  * a training step: STEP_RTOL for loss and gradients [8.3e-6 LeNet-5,
    1.7e-6 FFDNet] (the float convolutions and matmuls of the two
    libraries sum in other orders). The updated weights are held to
    STEP_RTOL absolute [7.1e-6]: their error is lr times that of Adam's
    first update, which divides each gradient element by its own
    magnitude, so it scales with lr and not with the weights.
  * five fit steps: FIT_RTOL on the losses [5.9e-4]. Adam's first steps
    divide each gradient element by its own magnitude, so an element whose
    gradient is float noise near zero takes a full step of either sign;
    five steps carry that to about 1e-3 of the loss.
"""
import functools
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic
from repro.models import cnn as RCNN
from repro.nn import module as RM
from repro.optim import adamw as RA
from repro.quant import matmul as RQM
from repro.train import cnn_train as RT

from repro_torch.convert import params_from_jax
from repro_torch.models import cnn as CNN
from repro_torch.optim import adamw as A
from repro_torch.quant import matmul as QM
from repro_torch.quant import quantize as Q
from repro_torch.train import cnn_train as T

# The suite runs in parallel worker processes: one intra-op thread per
# worker keeps torch from oversubscribing the CPU.
torch.set_num_threads(1)

RQ = importlib.import_module("repro.quant.quantize")
FIXTURE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "testdata" / "reference.npz")
GRAD_RTOL = 1e-6
UPDATE_RTOL = 1e-6
STEP_RTOL = 1e-4
FIT_RTOL = 2e-3
STE_BACKENDS = ("int8_exact", "approx_lut", "msr4", "approx_deficit_pallas",
                "approx_stage1_pallas", "approx_rank1_pallas")
RNG = np.random.default_rng(17)


def _close(got, want, rtol, absolute=False):
    """|got - want| <= rtol * max|want| (float32's smallest normal for an
    all-zero ``want``); with ``absolute``, <= rtol * max(1, max|want|)."""
    want = np.asarray(want).astype(np.float64)
    if isinstance(got, torch.Tensor):
        got = got.detach().double().numpy()
    scale = float(np.abs(want).max())
    bound = rtol * (max(1.0, scale) if absolute else scale)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=max(bound, np.finfo(np.float32).tiny))


def _tree_close(got, want, rtol, absolute=False):
    """Leaves within rtol of their own largest magnitude (bfloat16 leaves,
    and all leaves with ``absolute``, of max(1, that)); the int8 v codes
    exactly."""
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], dict):
            _tree_close(got[key], want[key], rtol, absolute)
        elif key == "v_q":
            assert got[key].dtype == torch.int8
            np.testing.assert_array_equal(got[key].numpy(), want[key])
        else:
            _close(got[key], want[key], rtol,
                   absolute or got[key].dtype == torch.bfloat16)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# fake-quant
# ---------------------------------------------------------------------------

def test_fake_quant_bitwise_on_ties():
    """Exact .5 ties round half to even in both; values past the range
    clip, and their gradient is masked."""
    scale = np.float32(0.25)
    k = np.arange(-140, 140, dtype=np.float32)
    x = ((k + 0.5) * scale).astype(np.float32)
    r = RNG.normal(size=x.shape).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.tensor(scale, requires_grad=True)
    y = Q.fake_quant(tx, ts)
    (y * torch.from_numpy(r)).sum().backward()
    ry = RQ.fake_quant(jnp.asarray(x), jnp.asarray(scale))
    gx, gs = jax.grad(lambda a, s: jnp.sum(RQ.fake_quant(a, s) * r),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(ry))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(gx))
    assert float(ts.grad) == float(gs) == 0.0
    assert 0 < int((tx.grad == 0).sum()) < x.size   # the mask bites


@pytest.mark.parametrize("axis", [-1, 0])
def test_fake_quant_per_channel_bitwise(axis):
    """A conv weight (k, k, Cin, Cout): one scale per index of ``axis``."""
    w = (RNG.normal(size=(3, 3, 4, 5)) * 0.2).astype(np.float32)
    w[0, 0, 0] = 0.0                      # a zero column's scale is 1e-8/127
    r = RNG.normal(size=w.shape).astype(np.float32)
    tw = torch.from_numpy(w).requires_grad_(True)
    y = Q.fake_quant_per_channel(tw, axis=axis)
    (y * torch.from_numpy(r)).sum().backward()
    ry, rg = jax.value_and_grad(
        lambda a: jnp.sum(RQ.fake_quant_per_channel(a, axis=axis) * r))(
            jnp.asarray(w))
    ry = RQ.fake_quant_per_channel(jnp.asarray(w), axis=axis)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(ry))
    np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(rg))


# ---------------------------------------------------------------------------
# STE backward of quantized_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias_relu", [False, True])
@pytest.mark.parametrize("act_scale", ["per_tensor", "per_token"])
@pytest.mark.parametrize("backend", STE_BACKENDS)
def test_quantized_matmul_ste_grads_match_jax(backend, act_scale,
                                              bias_relu):
    """dx, dw, db against jax.grad of the JAX quantized_matmul (its
    *_pallas entries in interpret mode), at 2 x 5 x 24 -> 6."""
    x = RNG.normal(size=(2, 5, 24)).astype(np.float32)
    w = (RNG.normal(size=(24, 6)) * 0.2).astype(np.float32)
    b = RNG.normal(size=(6,)).astype(np.float32)
    g = RNG.normal(size=(2, 5, 6)).astype(np.float32)
    act = "relu" if bias_relu else None
    cfg = Q.QuantConfig(backend=backend, act_scale=act_scale)
    rcfg = RQ.QuantConfig(backend=backend, act_scale=act_scale)
    tx, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    y = QM.quantized_matmul(tx, tw, cfg, bias=tb if bias_relu else None,
                            activation=act)
    (y * torch.from_numpy(g)).sum().backward()

    def f(a, c, d):
        return jnp.sum(g * RQM.quantized_matmul(
            a, c, rcfg, bias=d if bias_relu else None, activation=act))

    rx, rw, rb = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(tx.grad, rx, GRAD_RTOL)
    _close(tw.grad, rw, GRAD_RTOL)
    if bias_relu:
        _close(tb.grad, rb, GRAD_RTOL)
        assert tb.grad.dtype == tb.dtype and tb.grad.shape == tb.shape
    else:
        assert tb.grad is None


def test_quantized_matmul_grad_dtypes_and_relu_mask():
    x = torch.randn(7, 9, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    w = torch.randn(9, 4, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    y = QM.quantized_matmul(x, w, Q.INT8, activation="relu")
    y.sum().backward()
    mask = (y > 0).float()
    assert torch.equal(x.grad, mask @ w.detach().t())
    assert torch.equal(w.grad, x.detach().t() @ mask)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _lenet_jax_params(seed):
    return _numpy_tree(RM.init_params(RCNN.lenet5_descs(),
                                      jax.random.PRNGKey(seed)))


def _grads_like(params, scale, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.normal(size=p.shape) * scale)
                        .astype(np.float32), params)


@pytest.mark.parametrize("quantized", [False, True])
def test_adamw_two_updates_match_jax(quantized):
    """Two updates from the zero state, fed the same gradients, with the
    global norm under the clip (clip factor exactly 1): the first update's
    moments bitwise, the int8 v codes exact, the rest within
    UPDATE_RTOL."""
    params = _lenet_jax_params(0)
    rcfg = RA.AdamWConfig(lr=2e-3, weight_decay=0.1, quantized_state=quantized)
    cfg = A.AdamWConfig(lr=2e-3, weight_decay=0.1, quantized_state=quantized)
    rstate = RA.init(RCNN.lenet5_descs(), rcfg)
    tp = params_from_jax(params, device="cpu")
    state = A.init(tp, cfg)
    _tree_close(state["params"], _numpy_tree(rstate["params"]), 0.0)
    rp = jax.tree.map(jnp.asarray, params)
    ref_update = jax.jit(functools.partial(RA.update, cfg=rcfg))
    for step in range(2):
        grads = _grads_like(params, 1e-3, seed=step)
        rp, rstate = ref_update(jax.tree.map(jnp.asarray, grads), rstate, rp)
        tp, state = A.update(params_from_jax(grads, device="cpu"), state, tp,
                             cfg)
        want_p, want_s = _numpy_tree(rp), _numpy_tree(rstate)
        assert int(state["count"][0]) == int(want_s["count"][0]) == step + 1
        _tree_close(tp, want_p, UPDATE_RTOL)
        _tree_close(state["params"], want_s["params"],
                    0.0 if step == 0 else UPDATE_RTOL)
        if quantized:
            assert state["params"]["fc1"]["w"]["v_q"].dtype == torch.int8
            assert state["params"]["fc1"]["w"]["m"].dtype == torch.bfloat16


@pytest.mark.parametrize("quantized", [False, True])
def test_adamw_update_with_clipping_matches_jax(quantized):
    """Gradients above the clip norm: the global norm sums in another
    order, so floats agree within UPDATE_RTOL; v codes stay exact."""
    params = _lenet_jax_params(1)
    grads = _grads_like(params, 0.5, seed=7)
    rcfg = RA.AdamWConfig(quantized_state=quantized)
    cfg = A.AdamWConfig(quantized_state=quantized)
    rp, rstate = jax.jit(functools.partial(RA.update, cfg=rcfg))(
        jax.tree.map(jnp.asarray, grads), RA.init(RCNN.lenet5_descs(), rcfg),
        jax.tree.map(jnp.asarray, params))
    tp = params_from_jax(params, device="cpu")
    tp, state = A.update(params_from_jax(grads, device="cpu"),
                         A.init(tp, cfg), tp, cfg)
    _tree_close(tp, _numpy_tree(rp), UPDATE_RTOL)
    _tree_close(state["params"], _numpy_tree(rstate["params"]), UPDATE_RTOL)


def test_adamw_decays_matrices_only():
    p = {"w": torch.ones(3, 2), "b": torch.ones(2)}
    g = {"w": torch.zeros(3, 2), "b": torch.zeros(2)}
    cfg = A.AdamWConfig(lr=0.5, weight_decay=0.1)
    new, _ = A.update(g, A.init(p, cfg), p, cfg)
    assert torch.equal(new["b"], p["b"])
    assert torch.allclose(new["w"], torch.full((3, 2), 0.95))


# ---------------------------------------------------------------------------
# One training step, and five steps of fit
# ---------------------------------------------------------------------------

def _fixture_lenet():
    tree: dict = {}
    with np.load(FIXTURE) as data:
        for key in data.files:
            if key.startswith("lenet5/"):
                _, layer, leaf = key.split("/")
                tree.setdefault(layer, {})[leaf] = data[key]
    return tree


def _jax_classifier_loss(quant, qat):
    def loss_fn(p, x, y):
        logits = RCNN.lenet5_apply(p, x, quant, qat)
        one = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.take_along_axis(one, y[:, None], 1).mean()
    return loss_fn


def _jax_denoiser_loss(cfg, quant, qat):
    def loss_fn(p, noisy, target, sg):
        out = RCNN.ffdnet_apply(p, noisy, sg, cfg, quant, qat)
        return jnp.mean((out - target) ** 2)
    return loss_fn


def _jax_step(loss_fn, params, batch, ocfg):
    """The body of the JAX package's fit step."""
    @jax.jit
    def step(p, o, *b):
        l, g = jax.value_and_grad(loss_fn)(p, *b)
        p, o = RA.update(g, o, p, ocfg)
        return p, o, l, g
    return step(params, RA.init(_descs_of(params), ocfg),
                *(jnp.asarray(b) for b in batch))


def _jax_classifier_batches(imgs, labels, batch, seed):
    """The batch stream of the JAX package's train_classifier (a closure
    there, so written out here)."""
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.integers(0, imgs.shape[0], batch)
        yield imgs[idx], labels[idx]


def _jax_denoiser_batches(clean, batch, sigmas, seed):
    """The batch stream of the JAX package's train_denoiser."""
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.integers(0, clean.shape[0], batch)
        sig = rng.choice(sigmas, batch).astype(np.float32)
        tgt = clean[idx]
        noisy = tgt + (sig[:, None, None, None] / 255.0) * \
            rng.standard_normal(tgt.shape).astype(np.float32)
        yield noisy, tgt, sig / 255.0


def test_batch_streams_match_reference():
    imgs, labels = synthetic.digits(100, seed=4)
    clean = synthetic.textures(12, size=16, seed=4)
    for ours, ref in (
            (T.classifier_batches(imgs, labels, batch=16, seed=3),
             _jax_classifier_batches(imgs, labels, 16, 3)),
            (T.denoiser_batches(clean, batch=4, sigmas=(15., 25., 50.),
                                seed=3),
             _jax_denoiser_batches(clean, 4, (15., 25., 50.), 3))):
        for _ in range(3):
            for a, b in zip(next(ours), next(ref)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def _descs_of(params):
    return jax.tree.map(lambda a: RM.ParamDesc(a.shape, (None,) * a.ndim),
                        params)


def _check_step(params, batch, ours_loss, ref_loss, lr):
    """value_and_grad and one train_step of the port against JAX."""
    ocfg = A.AdamWConfig(lr=lr, weight_decay=0.0)
    rocfg = RA.AdamWConfig(lr=lr, weight_decay=0.0)
    rp, rstate, rl, rg = _jax_step(ref_loss, jax.tree.map(jnp.asarray,
                                                          params), batch,
                                   rocfg)
    tp = params_from_jax(params, device="cpu")
    tbatch = tuple(torch.from_numpy(np.asarray(b)) for b in batch)
    loss, grads = T.value_and_grad(ours_loss, tp, *tbatch)
    _close(loss, rl, STEP_RTOL)
    _tree_close(grads, _numpy_tree(rg), STEP_RTOL)
    new_p, new_s, loss2 = T.train_step(tp, A.init(tp, ocfg), tbatch,
                                       ours_loss, ocfg)
    assert torch.equal(loss, loss2)
    _tree_close(new_p, _numpy_tree(rp), STEP_RTOL, absolute=True)
    assert int(new_s["count"][0]) == 1


def test_qat_train_step_lenet5_matches_jax():
    """From the fixture's JAX-trained weights, one batch of 64 digits."""
    params = _fixture_lenet()
    imgs, labels = synthetic.digits(64, seed=5)
    _check_step(params, (imgs, labels),
                T.classifier_loss(CNN.lenet5_apply, Q.BF16, qat=True),
                _jax_classifier_loss(RQ.BF16, True), lr=2e-3)


def test_qat_train_step_ffdnet_matches_jax():
    """A depth-3, width-8 FFDNet from JAX's init, one batch of 8 textures
    of 32x32 from the JAX package's noise stream."""
    rcfg = RCNN.FFDNetConfig(depth=3, width=8)
    params = _numpy_tree(RM.init_params(RCNN.ffdnet_descs(rcfg),
                                        jax.random.PRNGKey(3)))
    clean = synthetic.textures(16, size=32, seed=0)
    batch = next(T.denoiser_batches(clean, batch=8, sigmas=(15., 25., 50.),
                                    seed=0))
    _check_step(params, batch,
                T.denoiser_loss(CNN.FFDNetConfig(depth=3, width=8), Q.BF16,
                                qat=True),
                _jax_denoiser_loss(rcfg, RQ.BF16, True), lr=1e-3)


def test_fit_five_steps_matches_jax(monkeypatch):
    """train_classifier's recipe for five steps, both packages starting
    from JAX's initial weights (the port's init_params draws from a
    torch.Generator, so the test hands it JAX's draw)."""
    descs, seed, n_train = RCNN.lenet5_descs(), 0, 300
    start = _numpy_tree(RM.init_params(descs, jax.random.PRNGKey(seed)))
    monkeypatch.setattr(T, "init_params",
                        lambda d, gen, dev: params_from_jax(start, dev))
    imgs, labels = synthetic.digits(n_train, seed=seed)
    rp, rlosses = RT.fit(descs, _jax_classifier_loss(RQ.BF16, True),
                         _jax_classifier_batches(imgs, labels, 64, seed),
                         steps=5, lr=2e-3, seed=seed)
    tp, losses = T.fit(CNN.lenet5_descs(),
                       T.classifier_loss(CNN.lenet5_apply, Q.BF16, qat=True),
                       T.classifier_batches(imgs, labels, batch=64,
                                            seed=seed),
                       steps=5, lr=2e-3, seed=seed, device="cpu")
    assert len(losses) == 5 and losses[-1] < losses[0]
    assert losses[0] == pytest.approx(rlosses[0], rel=STEP_RTOL)
    _close(np.asarray(losses), np.asarray(rlosses), FIT_RTOL)
    assert [path for path, _ in A.flatten(tp)] == \
        [path for path, _ in A.flatten(_numpy_tree(rp))]


def test_ste_step_through_kernel_equals_oracle():
    """One LeNet-5 train_step with quant=approx_deficit_pallas and
    qat=False (the STE backward through the kernel's forward) gives the
    same gradients and parameters as under approx_lut, bitwise (the check
    chip_smoke.py makes on the card)."""
    tp = params_from_jax(_fixture_lenet(), device="cpu")
    imgs, labels = synthetic.digits(8, seed=2)
    batch = (torch.from_numpy(imgs), torch.from_numpy(labels))
    ocfg = A.AdamWConfig(lr=2e-3, weight_decay=0.0)
    out = {}
    for be in ("approx_deficit_pallas", "approx_lut"):
        loss_fn = T.classifier_loss(CNN.lenet5_apply,
                                    Q.QuantConfig(backend=be))
        loss, grads = T.value_and_grad(loss_fn, tp, *batch)
        new_p, _, _ = T.train_step(tp, A.init(tp, ocfg), batch, loss_fn,
                                   ocfg)
        out[be] = (loss, A.flatten(grads), A.flatten(new_p))
    (la, ga, pa), (lb, gb, pb) = out.values()
    assert torch.equal(la, lb)
    for (_, a), (_, b) in zip(ga + pa, gb + pb):
        assert torch.equal(a, b)


def test_training_numerics_restores_flags():
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (cuda.allow_tf32, cudnn.allow_tf32, cudnn.deterministic,
              cudnn.benchmark)
    with T.training_numerics():
        assert not cuda.allow_tf32 and not cudnn.allow_tf32
        assert cudnn.deterministic and not cudnn.benchmark
    assert (cuda.allow_tf32, cudnn.allow_tf32, cudnn.deterministic,
            cudnn.benchmark) == before
    # restored after a step that raises, from the opposite settings too
    cuda.allow_tf32 = cudnn.allow_tf32 = cudnn.benchmark = True
    cudnn.deterministic = False
    try:
        with pytest.raises(ZeroDivisionError):
            with T.training_numerics():
                assert cudnn.deterministic and not cuda.allow_tf32
                1 / 0
        assert (cuda.allow_tf32, cudnn.allow_tf32, cudnn.deterministic,
                cudnn.benchmark) == (True, True, False, True)
    finally:
        (cuda.allow_tf32, cudnn.allow_tf32, cudnn.deterministic,
         cudnn.benchmark) = before


def test_train_functions_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.train_classifier(CNN.lenet5_descs(), CNN.lenet5_apply, steps=1,
                           n_train=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.train_denoiser(CNN.FFDNetConfig(depth=3, width=8), steps=1,
                         size=32)
