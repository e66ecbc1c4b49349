"""State-space mixers: RWKV6 (Finch) time and channel mix, and Mamba-lite
(hymba's SSM branch), after the JAX package's ``repro.nn.ssm``.

Both decode with an O(1) state per sequence row. The projections (r, k, v,
g, o and the channel mix's; Mamba's in / x / out) go through the quantized
dense path, and so through the backend registry: the approximate
multiplier's CUDA kernels on the card under the ``*_pallas`` backends. The
decay path stays exact (float32), as in the reference, and so do the float
side products that it leaves to XLA outside any Pallas kernel: the token-
shift LoRA (``tm_w1`` / ``tm_w2``), the decay LoRA (``wd_a`` / ``wd_b``)
and Mamba's ``dt_proj``. The recurrences are plain PyTorch: the reference's
``lax.scan`` over chunks or time steps becomes a Python loop whose tensors
stay on the device (no host sync inside it).

Each projection's input is made contiguous before it is quantized: the
five token-shift mixes are slices of one (B, S, 5, D) tensor, and a
strided input may take another float path than a decode step's contiguous
one.

The port mirrors two quirks of the reference (ROADMAP queue C): ``ln_x`` is
an RMS norm over the full width, not a group norm per head, and Mamba's
``d_inner`` equals ``d_model`` (``models/transformer_lm.ArchConfig``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.nn import layers as L
from repro_torch.nn.module import ParamDesc
from repro_torch.quant.quantize import QuantConfig

F32 = torch.float32


def _promoted(*ts):
    """The tensors in their promoted dtype: a float side product takes
    mixed operands (hymba's residual stream turns float32 after an
    attention over a float32 cache, its weights stay bfloat16), which
    ``jnp.einsum`` promotes and ``torch.einsum`` / ``matmul`` refuse."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


# ---------------------------------------------------------------------------
# RWKV6 time mix
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    d_model: int
    n_heads: int                   # head_dim = d_model // n_heads
    decay_lora: int = 64
    tmix_lora: int = 32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def rwkv_tmix_desc(cfg: RWKVConfig, dtype=torch.float32):
    D, H, N = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "mu": ParamDesc((5, D), (None, "embed"), "zeros", dtype=dtype),
        "tm_w1": ParamDesc((D, 5 * cfg.tmix_lora), ("embed", None),
                           scale=0.01, dtype=dtype),
        "tm_w2": ParamDesc((5, cfg.tmix_lora, D), (None, None, "embed"),
                           scale=0.01, dtype=dtype),
        "wr": ParamDesc((D, D), ("embed", "heads"), dtype=dtype),
        "wk": ParamDesc((D, D), ("embed", "heads"), dtype=dtype),
        "wv": ParamDesc((D, D), ("embed", "heads"), dtype=dtype),
        "wg": ParamDesc((D, D), ("embed", "heads"), dtype=dtype),
        "wo": ParamDesc((D, D), ("heads", "embed"), dtype=dtype),
        "w0": ParamDesc((D,), ("embed",), "zeros", dtype=dtype),
        "wd_a": ParamDesc((D, cfg.decay_lora), ("embed", None), scale=0.01,
                          dtype=dtype),
        "wd_b": ParamDesc((cfg.decay_lora, D), (None, "embed"), scale=0.01,
                          dtype=dtype),
        "bonus": ParamDesc((H, N), ("heads", None), "zeros", dtype=dtype),
        "ln_x": ParamDesc((D,), ("embed",), "ones", dtype=dtype),
    }


def wkv_step(S, r, k, v, w, u):
    """One step of the WKV recurrence; r, k, v, w: (B, H, N), u: (H, N),
    S: (B, H, N, N), all float32. Returns (S', y (B, H, N)):
        y  = r (S + diag(u) k^T v)
        S' = diag(w) S + k^T v"""
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhn,bhnm->bhm", r, S + u[None, :, :, None] * kv)
    return w[..., :, None] * S + kv, y


def wkv_sequential(r, k, v, w, u, S0):
    """:func:`wkv_step` over time. r, k, v, w: (B, T, H, N) float32.
    Returns (y (B, T, H, N), S_final)."""
    S, ys = S0, []
    for t in range(r.shape[1]):
        S, y = wkv_step(S, r[:, t], k[:, t], v[:, t], w[:, t], u)
        ys.append(y)
    return torch.stack(ys, dim=1), S


def wkv_chunked(r, k, v, w, u, S0, chunk: int = 64):
    """Chunk-parallel WKV recurrence, the reference's ``_wkv_chunked``.

    Within a chunk the pairwise decay factorizes per channel,
    A[t, tau] = (r_t . P^ex_t) . (k_tau / P_tau) with P the in-chunk
    cumulative product of w, so each chunk is a few (C, C) / (C, N)
    products instead of C sequential steps. Every exponent is <= 0 (the
    log-decays are cumulated within a chunk, ``exp(min(diff, 0))`` on the
    pairwise ones), so underflow gives an exact 0 and nothing divides. The
    time axis is padded to whole chunks with w = 1 (no decay) and r = k =
    v = 0, which leaves the state unchanged.

    r, k, v, w: (B, T, H, N) float32 with w in (0, 1]; u: (H, N);
    S0: (B, H, N, N). Returns (y (B, T, H, N), S_final).
    """
    b, t, h, n = r.shape
    c = min(chunk, t)
    pad = (-t) % c
    if pad:
        r, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    nc = (t + pad) // c
    rc, kc, vc, wc = (x.reshape(b, nc, c, h, n).transpose(0, 1)
                      for x in (r, k, v, w))         # (nc, B, C, H, N)

    lw = torch.log(torch.clamp_min(wc, 1e-30))
    cum = torch.cumsum(lw, dim=2)                    # inclusive, <= 0
    cumex = cum - lw                                 # decay up to t-1
    ptot = torch.exp(cum[:, :, -1])                  # (nc, B, H, N)
    rp = rc * torch.exp(cumex)                       # inter-chunk queries
    ks = kc * torch.exp(cum[:, :, -1:] - cum)        # state-update keys

    mask = torch.tril(torch.ones((c, c), dtype=F32, device=r.device), -1)
    nb = max(1, min(8, n))                           # channel block of E
    if n % nb:
        raise ValueError(f"head_dim {n} is not a multiple of the channel "
                         f"block {nb}")
    S, ys = S0, []
    for i in range(nc):
        y_inter = torch.einsum("bchn,bhnm->bchm", rp[i], S)
        # intra-chunk pairwise decays, exact per (t, tau, channel):
        #   E[t, tau, n] = exp(cumex[t, n] - cum[tau, n])  (<= 1 on the mask)
        A = 0.0
        for n0 in range(0, n, nb):
            sl = slice(n0, n0 + nb)
            diff = (cumex[i][:, :, None, :, sl]
                    - cum[i][:, None, :, :, sl])     # (B, C, C, H, nb)
            E = torch.exp(torch.clamp_max(diff, 0.0))
            A = A + torch.einsum("bthn,bdhn,btdhn->bhtd", rc[i][..., sl],
                                 kc[i][..., sl], E)
        A = A * mask[None, None]
        diag = torch.einsum("bchn,bchn->bch", rc[i], kc[i] * u[None, None])
        y_intra = (torch.einsum("bhcd,bdhn->bchn", A, vc[i])
                   + diag[..., None] * vc[i])
        S = ptot[i][..., None] * S + torch.einsum("bchn,bchm->bhnm", ks[i],
                                                  vc[i])
        ys.append(y_inter + y_intra)
    y = torch.stack(ys, dim=1).reshape(b, t + pad, h, n)[:, :t]
    return y, S


def rwkv_tmix(params, x: torch.Tensor, cfg: RWKVConfig, quant: QuantConfig,
              state=None, qat: bool = False, chunked: bool = False):
    """x: (B, S, D). state: {S: (B, H, N, N), xprev: (B, D)} float32, or
    None for a zero state. Returns (out, new state); the WKV runs chunked
    when ``chunked`` and S > 1, sequentially otherwise (decode)."""
    b, s, d = x.shape
    H, N = cfg.n_heads, cfg.head_dim
    xprev = (torch.zeros((b, d), dtype=x.dtype, device=x.device)
             if state is None else state["xprev"].to(x.dtype))
    xx = torch.cat([xprev[:, None], x[:, :-1]], dim=1) - x

    # data-dependent lerp (ddlerp) of the five mixes; mu: (5, D)
    lora = torch.tanh(torch.matmul(*_promoted(x, params["tm_w1"])))
    dd = torch.einsum("bsfl,fld->bsfd", *_promoted(
        lora.reshape(b, s, 5, cfg.tmix_lora), params["tm_w2"]))
    mixed = x[:, :, None] + xx[:, :, None] * (params["mu"][None, None] + dd)
    xr, xk, xv, xw, xg = [mixed[:, :, i].contiguous() for i in range(5)]

    r = L.dense({"w": params["wr"]}, xr, quant, qat).reshape(b, s, H, N)
    k = L.dense({"w": params["wk"]}, xk, quant, qat).reshape(b, s, H, N)
    v = L.dense({"w": params["wv"]}, xv, quant, qat).reshape(b, s, H, N)
    g = F.silu(L.dense({"w": params["wg"]}, xg, quant, qat))

    # data-dependent decay (Finch): w = exp(-exp(w0 + lora(xw)))
    lw = torch.tanh(torch.matmul(*_promoted(xw, params["wd_a"])))
    wlog = params["w0"][None, None] + torch.matmul(*_promoted(
        lw, params["wd_b"]))
    w = torch.exp(-torch.exp(wlog.to(F32))).reshape(b, s, H, N)
    u = params["bonus"].to(F32)
    S0 = (torch.zeros((b, H, N, N), dtype=F32, device=x.device)
          if state is None else state["S"])
    wkv = wkv_chunked if chunked and s > 1 else wkv_sequential
    y4, S_fin = wkv(r.to(F32), k.to(F32), v.to(F32), w, u, S0)
    y = y4.reshape(b, s, d).to(x.dtype)

    # the reference's "group norm per head": an RMS norm over the full width
    y = L.rmsnorm({"scale": params["ln_x"]}, y) * g
    out = L.dense({"w": params["wo"]}, y, quant, qat)
    return out, {"S": S_fin, "xprev": x[:, -1].to(F32)}


# ---------------------------------------------------------------------------
# RWKV6 channel mix
# ---------------------------------------------------------------------------

def rwkv_cmix_desc(d_model: int, d_ff: int, dtype=torch.float32):
    return {
        "mu_k": ParamDesc((d_model,), ("embed",), "zeros", dtype=dtype),
        "mu_r": ParamDesc((d_model,), ("embed",), "zeros", dtype=dtype),
        "wk": ParamDesc((d_model, d_ff), ("embed", "mlp"), dtype=dtype),
        "wr": ParamDesc((d_model, d_model), ("embed", "heads"), dtype=dtype),
        "wv": ParamDesc((d_ff, d_model), ("mlp", "embed"), dtype=dtype),
    }


def rwkv_cmix(params, x: torch.Tensor, quant: QuantConfig, xprev=None,
              qat: bool = False):
    """x: (B, S, D); xprev: (B, D) float32, or None for zeros. Returns
    (out, the last column of x in float32: the next call's xprev)."""
    b, s, d = x.shape
    xp = (torch.zeros((b, d), dtype=x.dtype, device=x.device)
          if xprev is None else xprev.to(x.dtype))
    xx = torch.cat([xp[:, None], x[:, :-1]], dim=1) - x
    xk = x + xx * params["mu_k"]
    xr = x + xx * params["mu_r"]
    k = torch.square(torch.relu(L.dense({"w": params["wk"]}, xk, quant,
                                        qat)))
    kv = L.dense({"w": params["wv"]}, k, quant, qat)
    out = torch.sigmoid(L.dense({"w": params["wr"]}, xr, quant, qat)) * kv
    return out, x[:, -1].to(F32)


# ---------------------------------------------------------------------------
# Mamba-lite (hymba's SSM branch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_inner: int
    n_state: int = 16
    conv_k: int = 4
    dt_rank: int = 32


def mamba_desc(cfg: MambaConfig, dtype=torch.float32):
    Di, Ns = cfg.d_inner, cfg.n_state
    return {
        "in_proj": ParamDesc((cfg.d_model, 2 * Di), ("embed", "heads"),
                             dtype=dtype),
        "conv_w": ParamDesc((cfg.conv_k, Di), (None, "heads"), scale=0.5,
                            dtype=dtype),
        "x_proj": ParamDesc((Di, cfg.dt_rank + 2 * Ns), ("heads", None),
                            dtype=dtype),
        "dt_proj": ParamDesc((cfg.dt_rank, Di), (None, "heads"), scale=0.01,
                             dtype=dtype),
        "dt_bias": ParamDesc((Di,), ("heads",), "zeros", dtype=dtype),
        "a_log": ParamDesc((Di, Ns), ("heads", None), "zeros", dtype=dtype),
        "d_skip": ParamDesc((Di,), ("heads",), "ones", dtype=dtype),
        "out_proj": ParamDesc((Di, cfg.d_model), ("heads", "embed"),
                              dtype=dtype),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)).
    (``F.softplus`` computes log1p(exp(x)), and returns x above 20, where
    the other term is below 2.1e-9: under half a float32 ulp of x.)"""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mamba(params, x: torch.Tensor, cfg: MambaConfig, quant: QuantConfig,
          state=None, qat: bool = False):
    """x: (B, S, D). state: {h: (B, Di, Ns), conv: (B, K-1, Di)} float32,
    or None for a zero state. Returns (out, new state).

    The depthwise causal conv reads index windows over the previous K-1
    inputs and the call's; the selective scan runs one step per token
    (prefill too), each step two elementwise launches on the (B, Di, Ns)
    state, with the decays and inputs of all steps computed before the
    loop and the read-out after it."""
    b, s, _ = x.shape
    Di, Ns, K = cfg.d_inner, cfg.n_state, cfg.conv_k
    xz = L.dense({"w": params["in_proj"]}, x.contiguous(), quant, qat)
    xi, z = torch.chunk(xz, 2, dim=-1)                        # (B, S, Di)

    conv_prev = (torch.zeros((b, K - 1, Di), dtype=x.dtype, device=x.device)
                 if state is None else state["conv"].to(x.dtype))
    xin = torch.cat([conv_prev, xi], dim=1)                   # (B, S+K-1, Di)
    idx = (torch.arange(s, device=x.device)[:, None]
           + torch.arange(K, device=x.device)[None, :])
    xc = F.silu(torch.einsum("bskd,kd->bsd", *_promoted(
        xin[:, idx], params["conv_w"])))

    proj = L.dense({"w": params["x_proj"]}, xc.contiguous(), quant, qat)
    dt_in, Bm, Cm = torch.split(proj, [cfg.dt_rank, Ns, Ns], dim=-1)
    dt = softplus(torch.matmul(*_promoted(dt_in, params["dt_proj"]))
                  + params["dt_bias"])
    A = -torch.exp(params["a_log"].to(F32))                   # (Di, Ns)

    h = (torch.zeros((b, Di, Ns), dtype=F32, device=x.device)
         if state is None else state["h"])
    xs, dts, Bs, Cs = (t.to(F32).transpose(0, 1) for t in (xc, dt, Bm, Cm))
    dA = torch.exp(dts[..., None] * A)                        # (S, B, Di, Ns)
    dBx = (dts * xs)[..., None] * Bs[:, :, None, :]
    hs = []
    for t in range(s):
        h = h * dA[t] + dBx[t]
        hs.append(h)
    ys = torch.einsum("sbdn,sbn->sbd", torch.stack(hs), Cs)
    y = ys.transpose(0, 1).to(x.dtype)
    y = y + xc * params["d_skip"]
    y = y * F.silu(z)
    out = L.dense({"w": params["out_proj"]}, y.contiguous(), quant, qat)
    return out, {"h": h, "conv": xin[:, -(K - 1):].to(F32)}
