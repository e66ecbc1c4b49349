"""The port's transformer LM (layers, attention, model, configs, convert)
against the JAX package's, on the same numpy inputs and weights.

The model is the reduced smollm of the JAX package's serving tests: 2
layers, d_model 64, 4 heads / 2 KV heads of 16, d_ff 128, vocab 64; its
weights are the JAX package's ``TLM.init`` at key 0, carried across by
``repro_torch.convert``. Where the JAX function reaches a Pallas backend
(or any backend with an oracle), the JAX side runs that backend's oracle
(``approx_lut``, ``approx_stage1``, an MSR ``*_lut``), which the JAX
package's own tests hold it equal to bit for bit; the port's side runs the
backend itself (for ``*_pallas``, on the CPU, its kernels' plain
versions).

Tolerances: int8 codes and int32 accumulators are compared bitwise. One
float layer agrees within FLOAT_RTOL of its range; logits within
LOGIT_RTOL of their range: the float32 norms, attention and epilogues of
the two stacks may round differently in the last place, and a later
layer's int8 code can then move by one step.
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_refs as REFS
import torch

from repro.configs import registry as RR
from repro.models import transformer_lm as RT
from repro.nn import attention as RA
from repro.nn import layers as RL
from repro.nn import module as RM
from repro.parallel.sharding import DEFAULT_RULES
from repro.quant import matmul as RQM

from repro_torch.configs import registry as PR
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.models import transformer_lm as PT
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import module as M
from repro_torch.quant import matmul as QM
from repro_torch.quant.quantize import QuantConfig, for_lm, quantize_dynamic

# The suite runs in parallel worker processes: one intra-op thread per
# worker keeps torch from oversubscribing the CPU.
torch.set_num_threads(1)

RQ = importlib.import_module("repro.quant.quantize")

FLOAT_RTOL = 1e-5
LOGIT_RTOL = 2e-3
# With bf16 params (and a bf16 cache) every activation is rounded to 8
# significant bits in both stacks, and XLA may keep fused intermediates in
# float32 between them: values move by a bf16 ulp (0.4 % of the value) at
# places, and the quantized head's bf16 logits by one or two ulps (the
# measured gap is 1.5 % of the logits' range).
BF16_LOGIT_RTOL = 3e-2
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=64, vocab_pad=64, head_dim=16)
PORTED = ("smollm-135m", "qwen1.5-32b", "deepseek-coder-33b", "gemma3-27b",
          "deepseek-v2-236b", "kimi-k2-1t-a32b", "rwkv6-3b", "hymba-1.5b",
          "llama-3.2-vision-11b", "musicgen-large")
LOGIT_BACKENDS = ("bf16", "int8_exact", "approx_lut", "approx_stage1",
                  "msr4", "approx_deficit_pallas", "approx_stage1_pallas",
                  "approx_rank1_pallas")
RNG = np.random.default_rng(14)
# qwen1.5's q, k and v biases are zeros at init in both packages; the
# parity tests draw them normal x BIAS_SCALE from BIAS_SEED, the same
# values on both sides, so that the biases reach the logits
BIAS_SEED, BIAS_SCALE = 1, 0.5


def _ref_backend(name: str) -> str:
    """The JAX backend a port backend is compared with: its oracle where it
    has one (the JAX package's own tests hold each backend, its Pallas
    entries included, to its oracle bitwise), else the same name."""
    if name == "bf16":
        return name
    return RQM.get_backend(name).oracle or name


def _close(got, want, rtol):
    """|got - want| <= rtol * the range of ``want`` (at least 1)."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    bound = rtol * max(1.0, float(np.ptp(want)))
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


@functools.lru_cache(maxsize=None)
def _tiny(arch="smollm-135m", param_dtype="float32", biased=False):
    """(JAX cfg, port cfg, JAX params, port params) of the reduced arch;
    ``biased``: with its q, k and v biases drawn (``_with_biases``)."""
    rcfg = RR.reduced(arch, **TINY, param_dtype=getattr(jnp, param_dtype))
    pcfg = PR.reduced(arch, **TINY, param_dtype=getattr(torch, param_dtype))
    rparams = REFS.init(rcfg)
    if biased:
        rparams = _with_biases(rparams)
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams),
                              device="cpu")
    return rcfg, pcfg, rparams, pparams


def _with_biases(rparams):
    """The JAX params with every ``bq``, ``bk`` and ``bv`` leaf drawn
    normal x BIAS_SCALE by numpy from BIAS_SEED (in the tree's order)."""
    rng = np.random.default_rng(BIAS_SEED)

    def draw(path, leaf):
        if getattr(path[-1], "key", None) not in ("bq", "bk", "bv"):
            return leaf
        return jnp.asarray(rng.normal(size=leaf.shape) * BIAS_SCALE,
                           leaf.dtype)

    out = jax.tree_util.tree_map_with_path(draw, rparams)
    assert any(getattr(p[-1], "key", None) == "bq" for p, _ in
               jax.tree_util.tree_leaves_with_path(out)), "no bias leaves"
    return out


def _tokens(b=2, s=8, seed=3):
    return np.random.default_rng(seed).integers(0, TINY["vocab"], (b, s)
                                                ).astype(np.int32)


# ---------------------------------------------------------------------------
# Configs, descriptors, init, convert
# ---------------------------------------------------------------------------

def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "param_dtype":
            v = _dtype_name(v)
        elif f.name == "quant":
            v = dataclasses.asdict(v)
        out[f.name] = v
    return out


@pytest.mark.parametrize("arch", PORTED)
def test_configs_match_reference(arch):
    assert PR.ARCH_NAMES == RR.ARCH_NAMES
    assert _fields(PR.get(arch)) == _fields(RR.get(arch))
    assert _fields(PR.reduced(arch, **TINY)) == _fields(
        RR.reduced(arch, **TINY))
    assert PR._pad_vocab(49153) == RR._pad_vocab(49153) == 49408


def test_unported_archs_raise_naming_their_roadmap_item():
    """Every name of ARCH_NAMES is ported (PORTED); an unknown name raises
    KeyError."""
    assert set(PORTED) == set(PR.ARCH_NAMES)
    with pytest.raises(KeyError):
        PR.get("no-such-arch")


def _desc_tree(tree, ref: bool):
    mod = RM if ref else M
    return mod.tree_map(lambda d: (d.shape, d.logical, d.init, d.scale,
                                   _dtype_name(d.dtype)), tree)


@pytest.mark.parametrize("arch", PORTED)
def test_descs_match_reference(arch):
    want = _desc_tree(RT.descs(RR.get(arch)), ref=True)
    got = _desc_tree(PT.descs(PR.get(arch)), ref=False)
    assert got == want
    assert M.n_params(PT.descs(PR.get(arch))) == RM.n_params(
        RT.descs(RR.get(arch)))
    full = {"smollm-135m": 134_515_008, "rwkv6-3b": 3_099_527_680,
            "hymba-1.5b": 1_345_537_600,
            "llama-3.2-vision-11b": 9_255_063_552,
            "musicgen-large": 2_432_894_976}
    if arch in full:
        assert M.n_params(PT.descs(PR.get(arch))) == full[arch]


def test_stacked_init_scale_follows_the_reference():
    """Both stacks take the fan-in of a stacked weight over every dim but
    the last, the layer axis included (ROADMAP queue C): the port mirrors
    it."""
    desc = M.stack({"w": M.ParamDesc((64, 32), ("embed", "mlp"))}, 8)
    w = M.init_params(desc, torch.Generator().manual_seed(0), "cpu")["w"]
    rdesc = RM.stack({"w": RM.ParamDesc((64, 32), ("embed", "mlp"))}, 8)
    rw = np.asarray(RM.init_params(rdesc, jax.random.PRNGKey(0))["w"])
    want = (8 * 64) ** -0.5
    assert w.shape == (8, 64, 32)
    assert abs(float(w.std()) / want - 1) < 0.05
    assert abs(float(rw.std()) / want - 1) < 0.05


@pytest.mark.parametrize("shape", [(8, 64, 32), (5, 3, 7)])
def test_sliced_host_draw_equals_one_draw(monkeypatch, shape):
    """A leaf over HOST_SLICE elements is drawn slice by slice along its
    leading axis: the same numbers as one draw where a row holds a
    multiple of 16 elements; other shapes are drawn whole."""
    desc = {"a": M.ParamDesc(shape, ("layers", "embed", "mlp")),
            "b": M.ParamDesc((4, 16), ("embed", "mlp"))}
    want = M.init_params(desc, torch.Generator().manual_seed(0), "cpu")
    monkeypatch.setattr(M, "HOST_SLICE", 2 * shape[1] * shape[2] - 1)
    got = M.init_params(desc, torch.Generator().manual_seed(0), "cpu")
    for k in desc:
        assert torch.equal(got[k], want[k]), k


def test_device_draw_of_large_leaves():
    """The card's draw of a large leaf (``_init_on_device``, here on the
    CPU's device generator): seeded from one draw of the host generator,
    deterministic, sliced under its limit, at the descriptor's scale."""
    d = M.stack({"w": M.ParamDesc((64, 48), ("embed", "mlp"))}, 6)["w"]

    def draw(limit):
        return M._init_on_device(d, torch.Generator().manual_seed(0),
                                 torch.device("cpu"), limit)

    a = draw(64 * 48)
    assert torch.equal(a, draw(64 * 48)) and a.shape == (6, 64, 48)
    assert abs(float(a.std()) / (6 * 64) ** -0.5 - 1) < 0.05
    host = M.init_params({"w": d}, torch.Generator().manual_seed(0),
                         "cpu")["w"]
    assert not torch.equal(a, host)
    assert M.DEVICE_DRAW > 49152 * 576, "smollm-135m's numbers would move"


def test_device_draw_slices_a_row_over_its_limit(monkeypatch):
    """A leaf whose one leading row holds more than the limit (kimi-k2's
    expert stack at depth 1: 1 x 384 x 7,168 x 2,048) is drawn in float32
    slices of at most the limit along its next axes; a leaf whose rows fit
    is drawn in leading-axis ranges, as before."""
    sizes = []
    randn = torch.randn

    def spy(shape, **kw):
        sizes.append(int(np.prod(shape)))
        return randn(shape, **kw)

    monkeypatch.setattr(torch, "randn", spy)
    wide = M.ParamDesc((1, 6, 64, 48), ("layers", "experts", "embed", "mlp"))

    def draw(d, limit):
        sizes.clear()
        return M._init_on_device(d, torch.Generator().manual_seed(0),
                                 torch.device("cpu"), limit)

    a = draw(wide, 2 * 64 * 48)
    assert sizes == [2 * 64 * 48] * 3
    assert torch.equal(a, draw(wide, 2 * 64 * 48))
    assert abs(float(a.std()) / (6 * 64) ** -0.5 - 1) < 0.05
    draw(wide, 64 * 48 - 1)
    assert max(sizes) <= 64 * 48 - 1 and sum(sizes) == 6 * 64 * 48
    rows = M.stack({"w": M.ParamDesc((64, 48), ("embed", "mlp"))}, 6)["w"]
    draw(rows, 2 * 64 * 48)
    assert sizes == [2 * 64 * 48] * 3


def test_init_and_cache_trees_match_reference_shapes():
    rcfg, pcfg, rparams, _ = _tiny(param_dtype="bfloat16")
    got = PT.init(pcfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree: jax.tree.map(  # noqa: E731
        lambda t: (tuple(t.shape), _dtype_name(t.dtype)), tree)
    assert shapes(got) == shapes(rparams)
    want = RT.init_cache(rcfg, 3, 16, jnp.float32)
    cache = PT.init_cache(pcfg, 3, 16, torch.float32, device="cpu")
    assert shapes(cache) == shapes(want)
    assert all(not bool(t.any()) for t in jax.tree.leaves(cache))


def test_entry_points_default_to_the_card():
    _, pcfg, _, _ = _tiny()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    for call in (lambda: PT.init(pcfg, torch.Generator()),
                 lambda: PT.init_cache(pcfg, 1, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_convert_round_trips_blocks_list_and_bf16_bitwise():
    _, _, rparams, pparams = _tiny(param_dtype="bfloat16")
    np_tree = jax.tree.map(np.asarray, rparams)
    assert isinstance(pparams["blocks"], list)
    w = np_tree["blocks"][0]["k0_self"]["attn"]["wq"]
    assert w.dtype.name == "bfloat16"
    t = pparams["blocks"][0]["k0_self"]["attn"]["wq"]
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == w.shape
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  w.view(np.int16))
    back = params_to_numpy(pparams)
    assert isinstance(back["blocks"], list)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree)):
        np.testing.assert_array_equal(a, b.astype(np.float32))
    again = params_from_jax(back, device="cpu")
    np.testing.assert_array_equal(
        again["blocks"][0]["k0_self"]["attn"]["wq"].numpy(),
        w.astype(np.float32))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(dtype):
    x = RNG.normal(size=(3, 5, 48)).astype(np.float32) * 3
    p = {"scale": RNG.normal(size=48).astype(np.float32),
         "bias": RNG.normal(size=48).astype(np.float32)}
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tp = params_from_jax(p, device="cpu")
    for ours, ref in ((L.rmsnorm, RL.rmsnorm), (L.layernorm, RL.layernorm)):
        got = ours(tp, tx)
        want = ref(p, jx)
        assert str(got.dtype).endswith(dtype)
        # bf16 outputs may round to neighbouring bf16 values
        _close(_np(got), want, FLOAT_RTOL if dtype == "float32" else 1e-2)


def test_rope_matches_reference():
    x = RNG.normal(size=(2, 5, 3, 16)).astype(np.float32)
    for pos in (None, 7, np.array([2, 9], np.int32)):
        want_pos = RA.q_positions(None if pos is None else jnp.asarray(pos),
                                  2, 5)
        got_pos = A.q_positions(pos, 2, 5, "cpu")
        np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
        got = A.rope(torch.from_numpy(x), got_pos, 10000.0)
        want = RA.rope(jnp.asarray(x), want_pos, 10000.0)
        _close(got.numpy(), want, FLOAT_RTOL)


def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    got = L.gelu(torch.from_numpy(x)).numpy()
    _close(got, jax.nn.gelu(jnp.asarray(x)), 1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - erf).max() > 1e-4


def test_swiglu_embed_and_cross_entropy_match_reference():
    g = RNG.normal(size=(4, 9)).astype(np.float32)
    u = RNG.normal(size=(4, 9)).astype(np.float32)
    _close(L.swiglu(torch.from_numpy(g), torch.from_numpy(u)).numpy(),
           RL.swiglu(jnp.asarray(g), jnp.asarray(u)), FLOAT_RTOL)
    table = {"table": RNG.normal(size=(20, 6)).astype(np.float32)}
    ids = np.array([[0, 5, 19], [3, 3, 1]], np.int32)
    np.testing.assert_array_equal(
        L.embed(params_from_jax(table, device="cpu"),
                torch.from_numpy(ids)).numpy(),
        np.asarray(RL.embed(table, jnp.asarray(ids))))
    lg = RNG.normal(size=(2, 3, 20)).astype(np.float32) * 4
    labels = np.array([[1, -1, 19], [0, 7, -1]], np.int32)
    _close(L.softmax_cross_entropy(torch.from_numpy(lg),
                                   torch.from_numpy(labels)).numpy(),
           RL.softmax_cross_entropy(jnp.asarray(lg), jnp.asarray(labels)),
           FLOAT_RTOL)


@pytest.mark.parametrize("backend", ["bf16", "int8_exact", "approx_lut"])
def test_logits_mask_the_padded_vocab(backend):
    table = {"table": (RNG.normal(size=(80, 16)) * 0.3).astype(np.float32)}
    x = RNG.normal(size=(2, 3, 16)).astype(np.float32)
    tt = params_from_jax(table, device="cpu")
    got = L.logits(tt, torch.from_numpy(x), true_vocab=70,
                   quant=for_lm(backend))
    want = RL.logits(table, jnp.asarray(x), true_vocab=70,
                     quant=RQ.for_lm(backend))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 80)
    assert bool((got[..., 70:] == torch.finfo(torch.float32).min).all())
    _close(got.numpy(), want, FLOAT_RTOL)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_chunk", [1024, 3])
def test_sdpa_matches_reference(kv_chunk):
    q = RNG.normal(size=(2, 4, 4, 8)).astype(np.float32)
    k = RNG.normal(size=(2, 10, 2, 8)).astype(np.float32)
    v = RNG.normal(size=(2, 10, 2, 8)).astype(np.float32)
    q_pos = np.array([[3, 4, 5, 6], [5, 6, 7, 8]], np.int32)
    k_pos = np.where(np.arange(10)[None] < np.array([[7], [9]]),
                     np.arange(10)[None], -1).astype(np.int32)
    got = A._sdpa(*(torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)),
                  0, kv_chunk=kv_chunk)
    want = RA._sdpa(*(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)), 0,
                    DEFAULT_RULES, kv_chunk=kv_chunk)
    _close(got.numpy(), want, FLOAT_RTOL)


@pytest.mark.parametrize("backend", ["bf16", "int8_exact"])
def test_attention_prefill_then_vector_pos_decode(backend):
    rcfg, pcfg, rparams, pparams = _tiny()
    acfg = pcfg.attn_cfg()
    racfg = rcfg.attn_cfg("self")
    rp = jax.tree.map(lambda t: t[0], rparams["blocks"][0])["k0_self"]["attn"]
    pp = {k: t[0] for k, t in
          pparams["blocks"][0]["k0_self"]["attn"].items()}
    x = RNG.normal(size=(2, 5, 64)).astype(np.float32)
    xd = RNG.normal(size=(2, 1, 64)).astype(np.float32)
    pos = np.array([5, 3], np.int32)        # each row at its own depth
    rq, pq = RQ.for_lm(backend), for_lm(backend)
    rc = RA.init_cache(racfg, 2, 12, jnp.float32)
    pc = A.init_cache(acfg, 2, 12, torch.float32, "cpu")
    ref = jax.jit(lambda x, c, pos: RA.apply(
        rp, x, racfg, DEFAULT_RULES, rq, cache=c, pos=pos))
    want, rc = ref(jnp.asarray(x), rc, None)
    got, pc = A.apply(pp, torch.from_numpy(x), acfg, pq, cache=pc)
    _close(got.numpy(), want, FLOAT_RTOL)
    want, rc = ref(jnp.asarray(xd), rc, jnp.asarray(pos))
    got, pc = A.apply(pp, torch.from_numpy(xd), acfg, pq, cache=pc,
                      pos=torch.from_numpy(pos))
    _close(got.numpy(), want, FLOAT_RTOL)
    for key in ("k", "v"):
        _close(pc[key].numpy(), rc[key], FLOAT_RTOL)


# ---------------------------------------------------------------------------
# Quantized projections: codes and accumulators bitwise
# ---------------------------------------------------------------------------

def _jax_layer(p, x, cfg):
    """The seven projection inputs and weights of one layer (params ``p``,
    its q, k and v biases where it has them) in a cacheless forward from
    the residual stream ``x``, and the layer's output, composed from the
    JAX package's own functions in the order of its ``_layer``."""
    a, m, q = p["attn"], p["mlp"], cfg.quant
    ac = cfg.attn_cfg("self")
    h = RL.rmsnorm(p["ln1"], x)
    b, s, _ = h.shape

    def proj(w, bias, heads):
        y = RL.dense({"w": a[w], **({"b": a[bias]} if bias in a else {})},
                     h, q)
        return y.reshape(b, s, heads, ac.head_dim)

    qh = proj("wq", "bq", ac.n_heads)
    kh = proj("wk", "bk", ac.n_kv_heads)
    vh = proj("wv", "bv", ac.n_kv_heads)
    pos = RA.q_positions(None, b, s)
    out = RA._sdpa(RA.rope(qh, pos, ac.rope_theta),
                   RA.rope(kh, pos, ac.rope_theta), vh, pos, pos, 0,
                   DEFAULT_RULES)
    x2 = x + RL.dense({"w": a["wo"]}, out, q)
    h2 = RL.rmsnorm(p["ln2"], x2)
    hid = jax.nn.silu(RL.dense({"w": m["wg"]}, h2, q)) * RL.dense(
        {"w": m["wu"]}, h2, q)
    return ((h, a["wq"]), (h, a["wk"]), (h, a["wv"]), (out, a["wo"]),
            (h2, m["wg"]), (h2, m["wu"]), (hid, m["wd"])), \
        x2 + RL.dense({"w": m["wd"]}, hid, q)


def _jax_layer0(rparams, toks, cfg):
    """Layer 0's seven projection inputs and weights (``_jax_layer``)."""
    p = jax.tree.map(lambda t: t[0], rparams["blocks"][0])["k0_self"]
    return _jax_layer(p, RT.embed_tokens(rparams, toks, cfg), cfg)[0]


def _jax_projections(rparams, toks, cfg):
    """Every projection of a cacheless forward, layer by layer
    (``_jax_layer``), then the untied head's (final norm, table.T)."""
    stack = rparams["blocks"][0]["k0_self"]
    x = RT.embed_tokens(rparams, toks, cfg)
    pairs = []
    for i in range(cfg.n_layers):
        layer, x = _jax_layer(jax.tree.map(lambda t: t[i], stack), x, cfg)
        pairs += layer
    h = RL.rmsnorm(rparams["final_ln"], x)
    return pairs + [(h, rparams["lm_head"]["table"].T)]


def _jax_codes_of(projections, rparams, cfg):
    """int8 codes and int32 sums of each (x, w) ``projections`` gives."""
    def run(params, toks):
        res = []
        for x, w in projections(params, toks, cfg):
            xq, _ = RQ.quantize_dynamic(x.reshape(-1, x.shape[-1]), axis=-1)
            wq, _ = RQ.quantize_dynamic(w, axis=0)
            res.append((xq, RQM.integer_matmul(xq, wq, cfg.quant)))
        return res

    out = jax.jit(run)(rparams, jnp.asarray(_tokens()))
    return [(np.asarray(xq), np.asarray(acc)) for xq, acc in out]


@functools.lru_cache(maxsize=None)
def _jax_layer0_codes(backend: str, param_dtype: str = "float32"):
    rcfg, _, rparams, _ = _tiny(param_dtype=param_dtype)
    return _jax_codes_of(_jax_layer0, rparams,
                         dataclasses.replace(rcfg,
                                             quant=RQ.for_lm(backend)))


@functools.lru_cache(maxsize=None)
def _jax_every_code(backend: str, arch: str):
    """The codes and sums of every projection of ``arch`` with its biases
    drawn (``_tiny(arch, biased=True)``)."""
    rcfg, _, rparams, _ = _tiny(arch, biased=True)
    return _jax_codes_of(_jax_projections, rparams,
                         dataclasses.replace(rcfg,
                                             quant=RQ.for_lm(backend)))


class _Spy:
    """Records the (x, w) of every ``quantized_matmul`` the port's layers
    make, in call order."""

    def __init__(self, monkeypatch):
        self.calls = []
        inner = L.quantized_matmul

        def spy(x, w, cfg, bias=None, activation=None):
            self.calls.append((x.detach().clone(), w.detach().clone()))
            return inner(x, w, cfg, bias=bias, activation=activation)

        monkeypatch.setattr(L, "quantized_matmul", spy)


def _port_codes(x, w, backend):
    xq, _ = quantize_dynamic(x.reshape(-1, x.shape[-1]), axis=-1)
    wq, _ = quantize_dynamic(w, axis=0)
    return xq, QM.integer_matmul(xq, wq.contiguous(), QuantConfig(backend))


@pytest.mark.parametrize("backend", QM.list_backends())
def test_layer0_projection_codes_and_accumulators_bitwise(monkeypatch,
                                                          backend):
    """Layer 0's seven projections (QKV, attention output, gate, up,
    down): the port's int8 activation codes and int32 accumulators equal
    the JAX package's, bit for bit."""
    _, pcfg, _, pparams = _tiny()
    cfg = dataclasses.replace(pcfg, quant=for_lm(backend))
    spy = _Spy(monkeypatch)
    PT.backbone(pparams, PT.embed_tokens(
        pparams, torch.from_numpy(_tokens()), cfg), cfg)
    want = _jax_layer0_codes(_ref_backend(backend))
    assert len(spy.calls) == 2 * 7
    for i, ((x, w), (wxq, wacc)) in enumerate(zip(spy.calls[:7], want)):
        xq, acc = _port_codes(x, w, backend)
        np.testing.assert_array_equal(xq.numpy(), wxq,
                                      err_msg=f"{backend} projection {i}")
        np.testing.assert_array_equal(acc.numpy(), wacc,
                                      err_msg=f"{backend} projection {i}")


def test_bf16_params_codes_bitwise_and_logits_close(monkeypatch):
    """param_dtype bfloat16: the embedding's bf16 cast and the bf16
    per-token scales give the JAX package's int8 codes bit for bit, and
    the logits agree within BF16_LOGIT_RTOL."""
    _, pcfg, _, pparams = _tiny(param_dtype="bfloat16")
    cfg = dataclasses.replace(pcfg, quant=for_lm("int8_exact"))
    x = PT.embed_tokens(pparams, torch.from_numpy(_tokens()), cfg)
    assert x.dtype == torch.bfloat16
    spy = _Spy(monkeypatch)
    PT.backbone(pparams, x, cfg)
    want = _jax_layer0_codes("int8_exact", "bfloat16")
    for (x, w), (wxq, wacc) in zip(spy.calls[:3], want[:3]):
        xq, acc = _port_codes(x, w, "int8_exact")
        np.testing.assert_array_equal(xq.numpy(), wxq)
        np.testing.assert_array_equal(acc.numpy(), wacc)
    for backend in ("bf16", "int8_exact"):
        got = _port_logits(backend, param_dtype="bfloat16")
        want = _jax_logits(backend, param_dtype="bfloat16")
        for g, w in zip(got, want):
            _close(g, w, BF16_LOGIT_RTOL)


# ---------------------------------------------------------------------------
# Whole model: prefill and decode logits against the JAX package
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_logits(backend: str, arch="smollm-135m", param_dtype="float32",
                biased=False):
    """JAX prefill of tokens[:, :-1] into a fresh cache, then a decode step
    of tokens[:, -1] at a (B,) position vector: both logits."""
    rcfg, _, rparams, _ = _tiny(arch, param_dtype, biased)
    cfg = dataclasses.replace(rcfg, quant=RQ.for_lm(backend))
    toks = jnp.asarray(_tokens())

    def run(params):
        # the cache in the params' dtype: the JAX package's scan over
        # layers refuses bf16 params with a float32 cache (ROADMAP queue C)
        c = RT.init_cache(cfg, 2, 16, getattr(jnp, param_dtype))
        a, c = RT.prefill(params, toks[:, :-1], cfg, c)
        b, _ = RT.decode_step(params, toks[:, -1:], jnp.asarray([7, 7]),
                              cfg, c)
        return a, b

    return tuple(np.asarray(t) for t in jax.jit(run)(rparams))


def _port_logits(backend: str, arch="smollm-135m", param_dtype="float32",
                 biased=False):
    _, pcfg, _, pparams = _tiny(arch, param_dtype, biased)
    cfg = dataclasses.replace(pcfg, quant=for_lm(backend))
    toks = torch.from_numpy(_tokens())
    c = PT.init_cache(cfg, 2, 16, getattr(torch, param_dtype), device="cpu")
    a, c = PT.prefill(pparams, toks[:, :-1], cfg, c)
    b, _ = PT.decode_step(pparams, toks[:, -1:], torch.tensor([7, 7]), cfg, c)
    return a.numpy(), b.numpy()


@pytest.mark.parametrize("backend", LOGIT_BACKENDS)
def test_prefill_decode_logits_match_reference(backend):
    got = _port_logits(backend)
    want = _jax_logits(_ref_backend(backend))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 1, TINY["vocab"])
        assert np.isfinite(g).all()
        _close(g, w, LOGIT_RTOL)


@pytest.mark.parametrize("backend", ["bf16", "approx_lut",
                                     "approx_deficit_pallas"])
@pytest.mark.parametrize("arch", ["qwen1.5-32b", "deepseek-coder-33b"])
def test_other_dense_archs_match_reference(monkeypatch, arch, backend):
    """The two other dense global-attention configs run the same code:
    qwen1.5 with QKV biases, deepseek-coder with rope_theta 1e5 and an
    untied head. qwen's biases are drawn nonzero (``_with_biases``), the
    same values in both packages' params: prefill and decode logits agree
    within LOGIT_RTOL of their range, and the biases move them by more
    than ten times that. Under a quantized backend every projection of a
    cacheless forward (both layers' q, k, v, o, gate, up, down and the
    head) has the JAX package's int8 codes and int32 sums, bit for bit."""
    biased = arch == "qwen1.5-32b"
    got = _port_logits(backend, arch, biased=biased)
    for g, w in zip(got, _jax_logits(_ref_backend(backend), arch,
                                     biased=biased)):
        _close(g, w, LOGIT_RTOL)
    if not biased:
        return
    moved = max(float(np.abs(g - z).max() / np.ptp(z))
                for g, z in zip(got, _port_logits(backend, arch)))
    assert moved > 10 * LOGIT_RTOL, moved
    if backend == "bf16":
        return
    _, pcfg, _, pparams = _tiny(arch, biased=True)
    cfg = dataclasses.replace(pcfg, quant=for_lm(backend))
    spy = _Spy(monkeypatch)
    h, _, _ = PT.backbone(pparams, PT.embed_tokens(
        pparams, torch.from_numpy(_tokens()), cfg), cfg)
    PT.lm_logits(pparams, h, cfg)
    want = _jax_every_code(_ref_backend(backend), arch)
    assert len(spy.calls) == len(want) == 2 * 7 + 1
    for i, ((x, w), (wxq, wacc)) in enumerate(zip(spy.calls, want)):
        xq, acc = _port_codes(x, w, backend)
        np.testing.assert_array_equal(xq.numpy(), wxq,
                                      err_msg=f"{backend} projection {i}")
        np.testing.assert_array_equal(acc.numpy(), wacc,
                                      err_msg=f"{backend} projection {i}")


def test_forward_loss_matches_reference():
    rcfg, pcfg, rparams, pparams = _tiny()
    toks = _tokens(seed=5)
    for backend in ("bf16", "approx_lut"):
        got = PT.forward_loss(
            pparams, {"tokens": torch.from_numpy(toks[:, :-1]),
                      "labels": torch.from_numpy(toks[:, 1:])},
            dataclasses.replace(pcfg, quant=for_lm(backend)))
        cfg = dataclasses.replace(rcfg, quant=RQ.for_lm(backend))
        want = jax.jit(lambda p, b: RT.forward_loss(p, b, cfg,
                                                    training=False))(
            rparams, {"tokens": jnp.asarray(toks[:, :-1]),
                      "labels": jnp.asarray(toks[:, 1:])})
        _close(got.numpy(), want, FLOAT_RTOL)


@pytest.mark.parametrize("backend", QM.list_backends())
def test_prefill_equals_decode_accumulators(monkeypatch, backend):
    """The port's own claim (the JAX package's ``test_lm_backends``
    contract, held here at the integer level): prefill of T tokens and
    prefill of T - 1 followed by a decode step give the last token the same
    int8 codes and int32 accumulators in every projection."""
    _, pcfg, _, pparams = _tiny()
    cfg = dataclasses.replace(pcfg, quant=for_lm(backend))
    toks = torch.from_numpy(_tokens())
    spy = _Spy(monkeypatch)
    PT.prefill(pparams, toks, cfg, PT.init_cache(cfg, 2, 16, torch.float32,
                                                 device="cpu"))
    full = spy.calls
    spy.calls = []
    c = PT.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    _, c = PT.prefill(pparams, toks[:, :-1], cfg, c)
    spy.calls = []
    PT.decode_step(pparams, toks[:, -1:], 7, cfg, c)
    step = spy.calls
    assert len(full) == len(step) == 2 * 7 + 1
    for i, ((xf, w), (xs, _)) in enumerate(zip(full, step)):
        qf, af = _port_codes(xf[:, -1:], w, backend)
        qs, as_ = _port_codes(xs, w, backend)
        assert torch.equal(qf, qs), f"{backend} projection {i}: codes"
        assert torch.equal(af, as_), f"{backend} projection {i}: int32"


# ---------------------------------------------------------------------------
# The quantized matmul's operands, and the page store
# ---------------------------------------------------------------------------

@pytest.fixture
def spy_backend():
    """A registered backend that records its operands' contiguity; taken
    out of the registry again after the test."""
    seen = []

    def fn(x_q, w_q, cfg):
        seen.append((x_q.is_contiguous(), w_q.is_contiguous()))
        return QM.integer_matmul(x_q, w_q, QuantConfig("int8_exact"))

    def fused(x_q, w_q, cfg, scale, bias, relu=False):
        seen.append((x_q.is_contiguous(), w_q.is_contiguous()))
        acc = QM.integer_matmul(x_q.reshape(-1, x_q.shape[-1]), w_q,
                                QuantConfig("int8_exact")).float()
        return (acc * scale + bias).reshape(*x_q.shape[:-1], w_q.shape[1])

    QM.register_backend("spy_contiguity", fn, fused=fused)
    try:
        yield seen
    finally:
        QM._REGISTRY.pop("spy_contiguity")


def test_backends_get_contiguous_codes_of_a_transposed_weight(spy_backend):
    """The tied LM head quantizes ``table.T``; its codes reach every
    backend contiguous (the CUDA kernels take nothing else), fused and
    unfused."""
    table = {"table": torch.randn(40, 16, generator=torch.Generator()
                                  .manual_seed(0))}
    x = torch.randn(2, 3, 16, generator=torch.Generator().manual_seed(1))
    assert not table["table"].t().is_contiguous()
    outs = []
    for fuse in (True, False):
        q = dataclasses.replace(for_lm("spy_contiguity"), fuse_epilogue=fuse)
        outs.append(L.logits(table, x, quant=q))
    assert spy_backend == [(True, True), (True, True)]
    want = L.logits(table, x, quant=for_lm("int8_exact"))
    for out in outs:
        torch.testing.assert_close(out, want, rtol=0, atol=1e-6)


def test_page_gather_and_store_match_reference():
    rcfg, pcfg, _, _ = _tiny()
    pool = RNG.normal(size=(2, 3, 16, 2, 16)).astype(np.float32)
    pages = RNG.normal(size=(2, 6, 4, 2, 16)).astype(np.float32)
    row = RNG.normal(size=(2, 1, 16, 2, 16)).astype(np.float32)

    def tree(a):
        return {"blocks": [{"k0_self": {"k": jnp.asarray(a),
                                        "v": jnp.asarray(a + 1)}}]}

    def torch_tree(a):
        return jax.tree.map(lambda t: torch.from_numpy(np.array(t)), tree(a))


    want = RT.store_pages(tree(pages), tree(pool), 1, [5, 0], [2, 1])
    got = PT.store_pages(torch_tree(pages), torch_tree(pool), 1, [5, 0],
                         [2, 1])
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = RT.gather_pages(tree(row), tree(pages), [3, 1, 4])
    got = PT.gather_pages(torch_tree(row), torch_tree(pages), [3, 1, 4])
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
