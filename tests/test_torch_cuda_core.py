"""The CUDA-core kernel's (csrc/approx_matmul.cu) host-side design on the
CPU: its correction tables against both packages' deficit and stage-1
functions, the table body's arithmetic over all 2^16 byte pairs, the plan
(tiles and split-K) and the split sum's exactness. The kernel itself runs
only on the card: chip_smoke.py holds it to its plain version there.

Everything here is integer arithmetic and compared exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deficit as RD
from repro.core import luts as RL
from repro.core.multiplier import proposed_multiplier as r_multiplier
from repro.kernels import approx_matmul as RK

from repro_torch.core import deficit as D
from repro_torch.kernels import approx_matmul as K
from repro_torch.kernels import codegen

torch.set_num_threads(1)

MAG = np.arange(K.TABLE_ROWS)              # |x|, |w| in [0, 128]
BYTES = np.arange(256).astype(np.uint8).view(np.int8)   # every int8

# the plan's seams: rows across the row tiles, K across the slices, N
# across the column tiles
PLAN_ROWS = list(range(1, 18)) + [63, 64, 65, 16384]
PLAN_K = [1, 31, 33, 575, 577, 1536, 3136]
PLAN_N = [1, 4, 64, 65, 192, 576, 1536, 49152]
# smollm-135m's serve shapes (rows, K, N): a decode step of 4 slots, one
# 32-token prefill (PERF.md)
SERVE_SHAPES = {"head": (4, 576, 49152), "q/o": (4, 576, 576),
                "k/v": (4, 576, 192), "gate/up": (4, 576, 1536),
                "down": (4, 1536, 576), "prefill up": (32, 576, 1536),
                "prefill k/v": (32, 576, 192)}
FFDNET_MID = (16 * 1024, 576, 64)


def _table_matrix(kernel, design="proposed"):
    """The kernel's flat table read back as its 129 x 129 matrix."""
    flat = K.correction_table(kernel, design, "cpu")
    assert flat.dtype == torch.int16 and flat.numel() * 2 == K.TABLE_BYTES
    assert K.TABLE_BYTES % 16 == 0
    rows = flat[:K.TABLE_ROWS * K.TABLE_STRIDE].view(K.TABLE_ROWS,
                                                      K.TABLE_STRIDE)
    assert not rows[:, K.TABLE_ROWS:].any()
    assert not flat[K.TABLE_ROWS * K.TABLE_STRIDE:].any()
    return rows[:, :K.TABLE_ROWS].to(torch.int64).numpy()


@pytest.mark.parametrize("design", codegen.designs())
def test_deficit_table_equals_both_packages_deficit_sum(design):
    """All 129^2 magnitude pairs (the 2^14 of [0, 127]^2 and |x| or |w| =
    128, which -128 reaches): the table == repro_torch's deficit_sum ==
    repro's."""
    a, b = MAG[:, None], MAG[None, :]
    port = D.deficit_sum(torch.from_numpy(a).to(torch.int32),
                         torch.from_numpy(b).to(torch.int32), design)
    ref = RD.deficit_sum(a, b, design)
    table = _table_matrix("deficit", design)
    np.testing.assert_array_equal(table, port.numpy())
    np.testing.assert_array_equal(table, np.asarray(ref))


def test_stage1_table_equals_both_packages_stage1_corrections():
    """Per magnitude pair, the single-k product of the port's _stage1_corr
    and of the JAX kernel's _stage1_tile_corr."""
    a = torch.arange(K.TABLE_ROWS, dtype=torch.int32)
    port = K._stage1_corr(a[:, None], a[None, :])
    ref = RK._stage1_tile_corr(jnp.asarray(MAG[:, None], jnp.int32),
                               jnp.asarray(MAG[None, :], jnp.int32))
    table = _table_matrix("stage1")
    np.testing.assert_array_equal(table, port.numpy())
    np.testing.assert_array_equal(table, np.asarray(ref))
    assert table.min() == 0 and table.max() == 96


@pytest.mark.parametrize("kernel, design",
                         [("deficit", d) for d in codegen.designs()]
                         + [("stage1", "proposed")])
def test_table_body_arithmetic_on_all_byte_pairs(kernel, design):
    """The body's pair, x w - sign(x) sign(w) C[|x|][|w|] read from the
    flat table at |x| * TABLE_STRIDE + |w|, wrapped to int32 as the kernel's
    uint32 sums are, equals the plain version on all 2^16 int8 pairs; for
    the deficit, the JAX package's signed product table too."""
    x = torch.from_numpy(BYTES.astype(np.int64))[:, None]
    w = torch.from_numpy(BYTES.astype(np.int64))[None, :]
    flat = K.correction_table(kernel, design, "cpu").to(torch.int64)
    corr = flat[x.abs() * K.TABLE_STRIDE + w.abs()]
    body = (x * w - x.sign() * w.sign() * corr).to(torch.int32)
    xs = torch.from_numpy(BYTES).reshape(256, 1)
    plain = K.approx_matmul_plain(xs, xs.reshape(1, 256), design, kernel)
    assert torch.equal(body, plain)
    if kernel == "deficit":
        lut = RL.signed_product_lut(r_multiplier(design))
        np.testing.assert_array_equal(body.numpy(), lut)


def _check_plan(rows, k, n):
    p = K.plan(rows, k, n)
    assert p.bm in K.ROW_TILES and p.bn in K.COL_TILES
    assert p.k_slice % K.BK == 0
    # the tiles and slices the kernel's launcher checks
    assert p.row_tiles == -(-rows // p.bm)
    assert p.col_tiles == -(-n // p.bn)
    assert p.splits == -(-k // p.k_slice)
    # every block, as the kernel reads its index
    b = np.arange(p.blocks)
    r0, c0, k0 = p.block(b)
    for first, size, extent in ((r0, p.bm, rows), (c0, p.bn, n),
                                (k0, p.k_slice, k)):
        starts = np.unique(first)
        # the ranges [start, min(start + size, extent)) tile [0, extent)
        np.testing.assert_array_equal(starts, np.arange(len(starts)) * size)
        assert starts[-1] < extent <= starts[-1] + size
    # each (tile, slice) exactly once
    key = (r0 // p.bm * p.col_tiles + c0 // p.bn) * p.splits + k0 // p.k_slice
    assert np.array_equal(np.sort(key), b)
    # the grid: at least one block per SM wherever the K slices can
    # still be cut, and no split where the tiles alone fill the card
    if p.row_tiles * p.col_tiles >= K.SMS:
        assert p.splits == 1
    else:
        assert p.blocks >= K.SMS or p.k_slice == K.BK
    return p


@pytest.mark.parametrize("rows", PLAN_ROWS)
def test_plan_covers_every_output_and_k_exactly_once(rows):
    for k in PLAN_K:
        for n in PLAN_N:
            _check_plan(rows, k, n)


def test_plan_fills_the_card_at_serve_shapes_and_splits_no_full_tiles():
    for label, shape in SERVE_SHAPES.items():
        p = _check_plan(*shape)
        assert p.blocks >= K.SMS, (label, p)
    mid = _check_plan(*FFDNET_MID)
    assert (mid.bm, mid.splits, mid.blocks) == (64, 1, 256)
    # decode's rows take the 4-row tile: no 64-row waste
    assert K.plan(4, 576, 576).bm == 4


def test_plan_rejects_empty_products():
    for shape in ((0, 4, 4), (4, 0, 4), (4, 4, 0)):
        with pytest.raises(ValueError, match="empty"):
            K.plan(*shape)


def _split_sum(x, w, kernel, p):
    """The kernel's split: each K slice's int32 partial sums, added in
    slice order in int32 (torch's int32 addition wraps, as the kernel's
    uint32 does)."""
    total = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int32)
    for s in range(p.splits):
        ks = slice(s * p.k_slice, (s + 1) * p.k_slice)
        total += K.approx_matmul_plain(x[:, ks], w[ks], kernel=kernel)
    return total


@pytest.mark.parametrize("kernel", ["deficit", "stage1"])
def test_split_sum_equals_unsplit_sum(kernel):
    rng = np.random.default_rng(15)
    for rows, k, n in ((4, 577, 65), (17, 3136, 10), (5, 100, 3)):
        x = torch.from_numpy(rng.integers(-128, 128, (rows, k))
                             .astype(np.int8))
        w = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
        p = K.plan(rows, k, n)
        assert p.splits > 1
        assert torch.equal(_split_sum(x, w, kernel, p),
                           K.approx_matmul_plain(x, w, kernel=kernel))


@pytest.mark.parametrize("kernel", ["deficit", "stage1"])
def test_split_sum_wraps_past_2_31_as_the_unsplit_sum(kernel):
    """Every operand 127 over K = 140,000: the sum passes 2^31 and wraps
    to a negative int32, in the unsplit plain version and through the
    plan's 133 int32 partials alike."""
    rows, k, n = 1, 140_000, 3
    x = torch.full((rows, k), 127, dtype=torch.int8)
    w = torch.full((k, n), 127, dtype=torch.int8)
    p = K.plan(rows, k, n)
    want = K.approx_matmul_plain(x, w, kernel=kernel)
    exact = k * (127 * 127 - int(K.correction_matrix(kernel)[127, 127]))
    assert exact >= 2 ** 31
    assert torch.equal(want, torch.full_like(want, exact - 2 ** 32))
    assert p.splits == 133
    assert torch.equal(_split_sum(x, w, kernel, p), want)
