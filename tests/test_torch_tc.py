"""The tensor-core kernel's operands (csrc/tc_matmul.cu) and its arithmetic,
on the CPU. The kernel runs only on the card; here its operands are built
by the port's plain functions and multiplied as the kernel multiplies them:
per accumulator set, an int8 dot accumulated modulo 2^32 (s32 MMA
fragments without .satfinite), the correction added with the table
negated, and the digit planes combined as acc0 + (acc1 << 7) in uint32.
That product must equal the plain versions and the JAX package's Pallas
entries (interpret mode, block (8, 8, 8)) bitwise, on ragged shapes: M not
a multiple of the 64-row tile, N not a multiple of 8, K and K * R not
multiples of the 32-byte MMA step. The operands are not padded to the
kernel's tiles: the kernel zero-fills past N and K itself."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import approx_matmul as RK

from repro_torch.core import factor as F
from repro_torch.kernels import approx_matmul as K
from repro_torch.kernels.ref import int8_matmul

torch.set_num_threads(1)

BLOCK = (8, 8, 8)
RNG = np.random.default_rng(12)
# (M, K, N): M = 70 spans two 64-row tiles; K * 52 and K * 124 are not
# multiples of 32; N = 4, 9 and 17 leave part of an 8-column MMA tile
# padding
RAGGED = [(70, 5, 4), (70, 13, 9), (3, 1, 1), (9, 40, 17)]


def _int8(*shape):
    return RNG.integers(-127, 128, shape).astype(np.int8)


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value modulo 2^32, still as int64."""
    return ((v + 2 ** 31) % 2 ** 32) - 2 ** 31


def tc_product(x: torch.Tensor, w: torch.Tensor, design=None):
    """What tc_mm_kernel computes from the prepared operands: the exact dot
    (body EXACT), plus the negated-table correction (body RANK1)."""
    m, k = x.shape
    n = w.shape[1]
    w_op = K.exact_weight_operand(w).long()              # (N, K)
    acc0 = _wrap32(x.long() @ w_op.t())
    if design is not None:
        u, _ = K._rank1_tables(design, "cpu")
        rp = u.shape[1]
        planes = K.rank1_weight_planes(w, design).long()
        planes = planes.reshape(2, n, -1)      # the kernel's digit planes
        xf = torch.zeros((m, planes.shape[2]), dtype=torch.int64)
        xf[:, :k * rp] = (-u.long())[x.long() & 0xFF].reshape(m, k * rp)
        acc0 = _wrap32(acc0 + xf @ planes[0].t())
        acc1 = _wrap32(xf @ planes[1].t())
        acc0 = _wrap32(acc0 + (acc1 << 7))
    return acc0.to(torch.int32)


@pytest.mark.parametrize("r, rp", [(49, 52), (54, 56), (120, 120),
                                   (122, 124)])
def test_rank1_r_pad(r, rp):
    assert K.rank1_r_pad(r) == rp


@pytest.mark.parametrize("k, n", [(5, 4), (64, 8), (65, 9), (1, 1),
                                  (25, 6), (3136, 128)])
def test_exact_weight_operand(k, n):
    w = torch.from_numpy(_int8(k, n))
    op = K.exact_weight_operand(w)
    assert op.dtype == torch.int8 and op.is_contiguous()
    assert torch.equal(op, w.t())


@pytest.mark.parametrize("design", ["proposed", "design13"])
def test_rank1_tables(design):
    fac = F.factorize(design)
    u, planes = K._rank1_tables(design, "cpu")
    rp = K.rank1_r_pad(fac.R)
    assert u.shape == (256, rp) and planes.shape == (fac.n_digits, 257, rp)
    assert not planes[:, 256].any()           # the padding index
    np.testing.assert_array_equal(u[:, :fac.R].numpy(), fac.u_signed)
    v = planes[0, :256].long() + 128 * planes[1, :256].long()
    np.testing.assert_array_equal(v[:, :fac.R].numpy().T, fac.v_signed)
    assert not u[:, fac.R:].any() and not planes[..., fac.R:].any()


@pytest.mark.parametrize("design", ["proposed", "design13"])
@pytest.mark.parametrize("k, n", [(5, 4), (13, 9), (8, 3)])
def test_rank1_weight_planes_recompose_v(design, k, n):
    """sum_d plane_d * 128^d is v_signed[:, w & 0xFF] in feature order
    k * Rp + r, zero for r >= R and for k past K up to the next multiple of
    4 (rows of a multiple of 16 bytes); without the padding the planes are
    the JAX package's per-digit features."""
    fac = F.factorize(design)
    rp = K.rank1_r_pad(fac.R)
    kp = -(-k // 4) * 4
    w = _int8(k, n)
    planes = K.rank1_weight_planes(torch.from_numpy(w), design)
    assert planes.shape == (fac.n_digits * n, kp * rp)
    assert planes.shape[1] % 16 == 0
    assert planes.dtype == torch.int8 and planes.is_contiguous()
    p = planes.reshape(fac.n_digits, n, kp, rp).long()
    assert not p[:, :, k:].any() and not p[..., fac.R:].any()
    p = p[:, :, :k]
    v = (p[0] + 128 * p[1]).numpy()
    gathered = fac.v_signed[:, w.astype(np.uint8)]        # (R, K, N)
    np.testing.assert_array_equal(v[..., :fac.R],
                                  gathered.transpose(2, 1, 0))

    _, wfs = RK._rank1_features(jnp.zeros((1, k), jnp.int8), jnp.asarray(w),
                                design)
    ours = p[..., :fac.R]
    for d, wf in enumerate(wfs):
        np.testing.assert_array_equal(
            ours[d].reshape(n, k * fac.R).numpy().T, np.asarray(wf))


@pytest.mark.parametrize("design", ["proposed", "design13"])
@pytest.mark.parametrize("shape", RAGGED)
def test_tc_rank1_product_matches_plain_and_pallas(shape, design):
    m, k, n = shape
    x, w = _int8(m, k), _int8(k, n)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = tc_product(tx, tw, design)
    assert torch.equal(got, K.rank1_matmul_plain(tx, tw, design))
    want = RK.rank1_matmul_pallas(jnp.asarray(x), jnp.asarray(w),
                                  block=BLOCK, design=design,
                                  interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", RAGGED)
def test_tc_exact_product_matches_plain_and_pallas(shape):
    m, k, n = shape
    x, w = _int8(m, k), _int8(k, n)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = tc_product(tx, tw)
    assert torch.equal(got, int8_matmul(tx, tw))
    ones = jnp.ones((1, n), jnp.float32)
    want = RK.fused_matmul_pallas(jnp.asarray(x), jnp.asarray(w), ones,
                                  jnp.zeros((1, n), jnp.float32),
                                  block=BLOCK, variant="exact",
                                  interpret=True)
    # |acc| <= K * 127^2 < 2^24: float32(acc) * 1 + 0 is exact
    np.testing.assert_array_equal(got.numpy().astype(np.float32),
                                  np.asarray(want))
