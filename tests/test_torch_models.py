"""The port's layers, models, metrics and eval loops against the JAX
package's, on the same numpy inputs and weights (passed through
repro_torch.convert.params_from_jax).

Tolerances: im2col, pooling and pixel (un)shuffle move values and are
exact. The first quantized layer's int8 codes and int32 accumulators are
compared bitwise. Float outputs agree within FLOAT_RTOL of their range for
one layer, MODEL_RTOL for whole models: the float32 pools and epilogues of
the two stacks may round differently in the last place, and a later
layer's int8 code can then move by one step. Under the JAX package the
``*_pallas`` backends are replaced by their oracles (bit-identical by
contract) so that no Pallas kernel is interpreted at model size.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_refs as REFS
import torch

from repro.eval import image as RIQ
from repro.models import cnn as RCNN
from repro.nn import conv as RCV
from repro.nn import layers as RL
from repro.quant import matmul as RQM

from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.eval import image as IQ
from repro_torch.models import cnn as CNN
from repro_torch.nn import conv as CV
from repro_torch.nn import layers as L
from repro_torch.nn.module import init_params
from repro_torch.quant import matmul as QM
from repro_torch.quant.quantize import QuantConfig, abs_max_scale, quantize
from repro_torch.train import cnn_train as T

# The suite runs in parallel worker processes: one intra-op thread per
# worker keeps torch from oversubscribing the CPU.
torch.set_num_threads(1)

RQ = importlib.import_module("repro.quant.quantize")

FLOAT_RTOL = 1e-5
MODEL_RTOL = 2e-3
BACKENDS = ("bf16",) + QM.list_backends()
RNG = np.random.default_rng(9)


def _ref_backend(name: str) -> str:
    """The JAX backend a port backend is compared with: its oracle where it
    has one (the JAX package's own tests hold each backend to its oracle
    bitwise), so only four distinct reference paths run at model size."""
    if name == "bf16":
        return name
    return RQM.get_backend(name).oracle or name


@functools.lru_cache(maxsize=None)
def _jax_model(model: str, ref_backend: str) -> np.ndarray:
    """The JAX package's output for the shared model inputs below."""
    q = RQ.QuantConfig(backend=ref_backend)
    if model == "lenet5":
        params, imgs = _lenet_inputs()
        fn = jax.jit(functools.partial(RCNN.lenet5_apply, quant=q))
        return np.asarray(fn(params, jnp.asarray(imgs)))
    params, noisy = _ffdnet_inputs()
    fn = jax.jit(functools.partial(
        RCNN.ffdnet_apply, cfg=RCNN.FFDNetConfig(depth=3, width=8), quant=q))
    return np.asarray(fn(params, jnp.asarray(noisy),
                         jnp.float32(25.0 / 255.0)))


def _close(got, want, rtol):
    want = np.asarray(want)
    bound = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=bound)


def _jax_params(descs, seed):
    """Weights for a JAX descriptor tree, drawn with numpy: fan-in scaled
    normals, and small random biases so that the bias path is exercised."""
    rng = np.random.default_rng(seed)

    def one(d):
        if d.init == "zeros":
            return (rng.normal(size=d.shape) * 0.1).astype(np.float32)
        fan_in = int(np.prod(d.shape[:-1]))
        return (rng.normal(size=d.shape) * fan_in ** -0.5).astype(np.float32)

    return {layer: {leaf: one(d) for leaf, d in leaves.items()}
            for layer, leaves in descs.items()}


@pytest.mark.parametrize("k,stride,padding", [(3, 1, "SAME"), (5, 1, "SAME"),
                                              (3, 2, "VALID")])
def test_im2col_matches_reference(k, stride, padding):
    x = RNG.normal(size=(2, 9, 11, 3)).astype(np.float32)
    got, hw = CV.im2col(torch.from_numpy(x), k, stride, padding)
    want, rhw = RCV.im2col(jnp.asarray(x), k, stride, padding)
    assert hw == rhw
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", BACKENDS)
def test_conv2d_matches_reference(backend):
    x = RNG.normal(size=(2, 8, 8, 3)).astype(np.float32)
    p = {"w": (RNG.normal(size=(3, 3, 3, 5)) * 0.3).astype(np.float32),
         "b": RNG.normal(size=(5,)).astype(np.float32)}
    got = CV.conv2d(params_from_jax(p, device="cpu"), torch.from_numpy(x),
                    QuantConfig(backend=backend), activation="relu")
    want = jax.jit(functools.partial(
        RCV.conv2d, quant=RQ.QuantConfig(backend=_ref_backend(backend)),
        activation="relu"))(p, jnp.asarray(x))
    _close(got, want, FLOAT_RTOL)


def test_float_conv_same_padding_with_stride():
    x = RNG.normal(size=(1, 9, 10, 2)).astype(np.float32)
    p = {"w": RNG.normal(size=(3, 3, 2, 4)).astype(np.float32)}
    got = CV.conv2d(params_from_jax(p, device="cpu"), torch.from_numpy(x),
                    QuantConfig(), stride=2)
    want = RCV.conv2d(p, jnp.asarray(x), RQ.QuantConfig(), stride=2)
    _close(got, want, FLOAT_RTOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_dense_matches_reference(backend):
    x = RNG.normal(size=(3, 4, 16)).astype(np.float32)
    p = {"w": (RNG.normal(size=(16, 7)) * 0.3).astype(np.float32),
         "b": RNG.normal(size=(7,)).astype(np.float32)}
    got = L.dense(params_from_jax(p, device="cpu"), torch.from_numpy(x),
                  QuantConfig(backend=backend), activation="relu")
    want = jax.jit(functools.partial(
        RL.dense, quant=RQ.QuantConfig(backend=_ref_backend(backend)),
        activation="relu"))(p, jnp.asarray(x))
    _close(got, want, FLOAT_RTOL)


def test_pools_and_pixel_shuffle_match_reference():
    x = RNG.normal(size=(2, 8, 6, 4)).astype(np.float32)
    tx = torch.from_numpy(x)
    for ours, ref in ((CV.maxpool2, RCV.maxpool2),
                      (CNN.pixel_unshuffle, RCNN.pixel_unshuffle),
                      (CNN.pixel_shuffle, RCNN.pixel_shuffle)):
        np.testing.assert_array_equal(ours(tx).numpy(),
                                      np.asarray(ref(jnp.asarray(x))))
    _close(CV.avgpool2(tx), RCV.avgpool2(jnp.asarray(x)), FLOAT_RTOL)
    assert torch.equal(CNN.pixel_shuffle(CNN.pixel_unshuffle(tx)), tx)


def test_psnr_ssim_match_reference():
    a = RNG.random((2, 16, 16, 1)).astype(np.float32)
    b = np.clip(a + 0.1 * RNG.normal(size=a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _close(IQ.psnr(ta, tb), RIQ.psnr(jnp.asarray(a), jnp.asarray(b)),
           FLOAT_RTOL)
    _close(IQ.ssim(ta, tb), RIQ.ssim(jnp.asarray(a), jnp.asarray(b)),
           FLOAT_RTOL)
    _close(IQ.ssim(ta[0, :7, :7, 0], tb[0, :7, :7, 0]),
           RIQ.ssim(jnp.asarray(a[0, :7, :7, 0]), jnp.asarray(b[0, :7, :7, 0])),
           FLOAT_RTOL)


@functools.lru_cache(maxsize=None)
def _lenet_inputs():
    params = _jax_params(RCNN.lenet5_descs(), seed=4)
    imgs = np.random.default_rng(1).random((2, 28, 28, 1)).astype(np.float32)
    return params, imgs


@functools.lru_cache(maxsize=None)
def _ffdnet_inputs():
    params = _jax_params(RCNN.ffdnet_descs(RCNN.FFDNetConfig(depth=3,
                                                             width=8)),
                         seed=2)
    noisy = np.random.default_rng(2).random((2, 16, 16, 1)).astype(
        np.float32)
    return params, noisy


@pytest.fixture(scope="module")
def lenet():
    return _lenet_inputs()


@pytest.mark.parametrize("backend", BACKENDS)
def test_lenet5_forward_matches_reference(lenet, backend):
    params, imgs = lenet
    tp = params_from_jax(params, device="cpu")
    got = CNN.lenet5_apply(tp, torch.from_numpy(imgs),
                           QuantConfig(backend=backend))
    assert got.shape == (2, 10)
    _close(got, _jax_model("lenet5", _ref_backend(backend)), MODEL_RTOL)


def test_lenet5_first_layer_codes_and_accumulators_bitwise(lenet):
    """The first conv's int8 codes and int32 accumulators equal the
    reference's under every quantized backend."""
    params, imgs = lenet
    cols, _ = CV.im2col(torch.from_numpy(imgs), 5)
    w = params["c1"]["w"].reshape(25, 6).copy()
    xq = quantize(cols, abs_max_scale(cols))
    wq = quantize(torch.from_numpy(w), abs_max_scale(torch.from_numpy(w),
                                                     axis=0))

    @jax.jit
    def ref_codes(x, w):
        rcols, _ = RCV.im2col(x, 5)
        return (RQ.quantize(rcols, RQ.abs_max_scale(rcols)),
                RQ.quantize(w, RQ.abs_max_scale(w, axis=0)))

    rxq, rwq = ref_codes(jnp.asarray(imgs), jnp.asarray(w))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(rxq))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(rwq))
    rows = slice(300, 428)          # 128 patch rows, across the digit
    ref = {name: np.asarray(REFS.integer_matmul(
        rxq[rows], rwq, RQ.QuantConfig(backend=name)))
        for name in {_ref_backend(b) for b in QM.list_backends()}}
    for backend in QM.list_backends():
        acc = QM.integer_matmul(xq[rows], wq, QuantConfig(backend=backend))
        np.testing.assert_array_equal(acc.numpy(), ref[_ref_backend(backend)])


@pytest.mark.parametrize("backend", BACKENDS)
def test_ffdnet_forward_matches_reference(backend):
    params, noisy = _ffdnet_inputs()
    got = CNN.ffdnet_apply(params_from_jax(params, device="cpu"),
                           torch.from_numpy(noisy), 25.0 / 255.0,
                           CNN.FFDNetConfig(depth=3, width=8),
                           QuantConfig(backend=backend))
    assert got.shape == noisy.shape
    _close(got, _jax_model("ffdnet", _ref_backend(backend)), MODEL_RTOL)


def test_modules_wrap_the_functional_models(lenet):
    params, imgs = lenet
    model = CNN.LeNet5.from_jax(params, device="cpu")
    x = torch.from_numpy(imgs)
    q = QuantConfig(backend="approx_deficit_pallas")
    assert torch.equal(model(x, q), CNN.lenet5_apply(
        params_from_jax(params, device="cpu"), x, q))
    roundtrip = params_to_numpy(model.params)
    for layer in params:
        for leaf in params[layer]:
            np.testing.assert_array_equal(roundtrip[layer][leaf],
                                          params[layer][leaf])
    cfg = CNN.FFDNetConfig(depth=3, width=8)
    ff = CNN.FFDNet(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert ff(torch.zeros(1, 8, 8, 1), 0.1).shape == (1, 8, 8, 1)
    assert CNN.KerasCNN(device="cpu")(torch.zeros(1, 28, 28, 1)).shape \
        == (1, 10)


def test_init_params_is_seeded_and_scaled():
    descs = CNN.lenet5_descs()
    a = init_params(descs, torch.Generator().manual_seed(3), device="cpu")
    b = init_params(descs, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(a["fc1"]["w"], b["fc1"]["w"])
    assert torch.count_nonzero(a["fc1"]["b"]) == 0
    std = float(a["fc1"]["w"].std())
    assert abs(std - (7 * 7 * 16) ** -0.5) < 0.1 * std


def test_eval_classifier_deficit_kernel_equals_lut(lenet):
    params, _ = lenet
    tp = params_from_jax(params, device="cpu")
    accs = [T.eval_classifier(tp, CNN.lenet5_apply,
                              QuantConfig(backend=name), n_test=10, batch=5,
                              device="cpu")
            for name in ("approx_deficit_pallas", "approx_lut")]
    assert accs[0] == accs[1]


def test_eval_denoiser_matches_reference():
    rcfg = RCNN.FFDNetConfig(depth=3, width=8)
    params = _jax_params(RCNN.ffdnet_descs(rcfg), seed=5)
    got = T.eval_denoiser(params_from_jax(params, device="cpu"),
                          CNN.FFDNetConfig(depth=3, width=8),
                          QuantConfig(backend="approx_stage1_pallas"), n=2,
                          size=16, device="cpu")
    from repro.train import cnn_train as RT
    want = RT.eval_denoiser(params, rcfg,
                            RQ.QuantConfig(backend="approx_stage1"), n=2,
                            size=16)
    np.testing.assert_allclose(got, want, rtol=MODEL_RTOL)


def test_entry_points_default_to_cuda():
    """Without device= every entry point asks for the card; on a machine
    without one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    params = _jax_params(RCNN.lenet5_descs(), seed=0)
    tp = params_from_jax(params, device="cpu")
    calls = [
        lambda: init_params(CNN.lenet5_descs(), torch.Generator()),
        lambda: params_from_jax(params),
        lambda: CNN.LeNet5(),
        lambda: CNN.LeNet5.from_jax(params),
        lambda: T.eval_classifier(tp, CNN.lenet5_apply, QuantConfig(),
                                  n_test=2, batch=2),
        lambda: T.eval_denoiser(tp, CNN.FFDNetConfig(), QuantConfig(), n=1,
                                size=8),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

