"""The CUDA kernels' plain versions against the JAX package's Pallas entries
(interpret mode, block (8, 8, 8), shapes <= 32 that cross blocks), and the
wrappers' contract on the CPU. The kernels themselves run only on the card:
chip_smoke.py holds each to its plain version there.

int32 outputs are compared bitwise. Fused float32 outputs within
FLOAT_RTOL of their range: the port rounds the epilogue's multiply and add
separately; XLA may contract them into one FMA."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import approx_matmul as RK

from repro_torch.kernels import approx_matmul as K
from repro_torch.kernels import codegen
from repro_torch.kernels import sass as SASS

# The suite runs in parallel worker processes: one intra-op thread per
# worker keeps torch from oversubscribing the CPU.
torch.set_num_threads(1)

FLOAT_RTOL = 1e-6
BLOCK = (8, 8, 8)
SHAPES = [(9, 20, 17), (3, 1, 1), (16, 24, 8)]
RNG = np.random.default_rng(3)


def _operands(m, k, n, batch=None):
    xs = (batch, m, k) if batch else (m, k)
    x = RNG.integers(-127, 128, xs).astype(np.int8)
    w = RNG.integers(-127, 128, (k, n)).astype(np.int8)
    scale = (RNG.random((1, n)) * 1e-2).astype(np.float32)
    bias = RNG.normal(size=(1, n)).astype(np.float32)
    return x, w, scale, bias


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want):
    want = np.asarray(want)
    bound = FLOAT_RTOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=bound)


@pytest.mark.parametrize("kernel", ["deficit", "stage1"])
@pytest.mark.parametrize("shape", SHAPES)
def test_approx_matmul_plain_matches_pallas(shape, kernel):
    x, w, _, _ = _operands(*shape)
    want = RK.approx_matmul_pallas(jnp.asarray(x), jnp.asarray(w),
                                   block=BLOCK, kernel=kernel,
                                   interpret=True)
    tx, tw = _t(x, w)
    got = K.approx_matmul_plain(tx, tw, kernel=kernel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(K.approx_matmul(tx, tw, kernel=kernel), got)


@pytest.mark.parametrize("design", ["design15", "design16_d2"])
def test_approx_matmul_plain_designs_match_pallas(design):
    x, w, _, _ = _operands(9, 20, 17)
    want = RK.approx_matmul_pallas(jnp.asarray(x), jnp.asarray(w),
                                   block=BLOCK, design=design,
                                   interpret=True)
    got = K.approx_matmul_plain(*_t(x, w), design=design)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("variant", ["deficit", "stage1", "exact"])
def test_fused_matmul_plain_matches_pallas(variant, relu):
    """Batched (B, M, K) operands, every variant of the fused entry."""
    x, w, scale, bias = _operands(9, 20, 17, batch=2)
    want = RK.fused_matmul_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        jnp.asarray(bias), block=BLOCK, variant=variant, relu=relu,
        interpret=True)
    tx, tw, ts, tb = _t(x, w, scale, bias)
    got = K.fused_matmul_plain(tx, tw, ts, tb, variant=variant, relu=relu)
    assert got.shape == (2, 9, 17) and got.dtype == torch.float32
    _close(got, want)
    assert torch.equal(K.fused_matmul(tx, tw, ts, tb, variant=variant,
                                      relu=relu), got)
    flat = K.fused_matmul_plain(tx.reshape(18, 20), tw, ts, tb,
                                variant=variant, relu=relu)
    assert torch.equal(flat.reshape(2, 9, 17), got)


@pytest.mark.parametrize("shape", SHAPES)
def test_rank1_matmul_plain_matches_pallas(shape):
    x, w, _, _ = _operands(*shape)
    want = RK.rank1_matmul_pallas(jnp.asarray(x), jnp.asarray(w),
                                  block=BLOCK, interpret=True)
    tx, tw = _t(x, w)
    got = K.rank1_matmul_plain(tx, tw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(K.rank1_matmul(tx, tw), got)


@pytest.mark.parametrize("relu", [False, True])
def test_rank1_fused_matmul_plain_matches_pallas(relu):
    x, w, scale, bias = _operands(9, 20, 17, batch=2)
    want = RK.rank1_fused_matmul_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        jnp.asarray(bias), block=BLOCK, relu=relu, interpret=True)
    tx, tw, ts, tb = _t(x, w, scale, bias)
    got = K.rank1_fused_matmul_plain(tx, tw, ts, tb, relu=relu)
    _close(got, want)
    assert torch.equal(K.rank1_fused_matmul(tx, tw, ts, tb, relu=relu), got)


def test_fused_epilogue_rounds_twice():
    """float32(acc) * scale, then + bias, each rounded: the stated
    rounding of the CUDA epilogue, bit for bit on the CPU."""
    x, w, scale, bias = _operands(5, 12, 7)
    tx, tw, ts, tb = _t(x, w, scale, bias)
    acc = K.approx_matmul_plain(tx, tw)
    want = (acc.to(torch.float32) * ts) + tb
    got = K.fused_matmul_plain(tx, tw, ts, tb)
    assert torch.equal(got, want)
    assert torch.equal(K.fused_matmul_plain(tx, tw, ts, tb, relu=True),
                       torch.clamp_min(want, 0.0))


def test_wrappers_reject_bad_inputs():
    x = torch.zeros((4, 8), dtype=torch.int8)
    w = torch.zeros((8, 3), dtype=torch.int8)
    s, b = torch.ones((1, 3)), torch.zeros((1, 3))
    with pytest.raises(TypeError, match="int8"):
        K.approx_matmul(x.float(), w)
    with pytest.raises(ValueError, match="contraction"):
        K.rank1_matmul(x, w[:7])
    with pytest.raises(ValueError, match="ranks"):
        K.approx_matmul(x[None], w)
    with pytest.raises(ValueError, match="unknown kernel"):
        K.approx_matmul(x, w, kernel="exact")
    with pytest.raises(ValueError, match="unknown variant"):
        K.fused_matmul(x, w, s, b, variant="rank1")
    with pytest.raises(KeyError, match="unknown design"):
        K.rank1_matmul(x, w, design="nope")
    with pytest.raises(ValueError, match="columns"):
        K.rank1_fused_matmul(x, w, torch.ones((1, 4)), b)
    with pytest.raises(ValueError, match="devices"):
        K.approx_matmul(x, w.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        K.approx_matmul(x.to("meta"), w.to("meta"))
    # the checks the CUDA path adds before a launch
    with pytest.raises(ValueError, match="contiguous"):
        K._check_cuda(x.t().contiguous().t(), w)
    with pytest.raises(ValueError, match="float32 of shape"):
        K._check_cuda(x, w, s.double(), b)
    with pytest.raises(ValueError, match="float32 of shape"):
        K._check_cuda(x, w, s, b.reshape(3))


@pytest.mark.parametrize("entry", ["approx_matmul", "fused_matmul",
                                   "rank1_matmul", "rank1_fused_matmul"])
def test_wrappers_reject_empty_contraction(entry):
    """K = 0 is refused before any launch, batched input included."""
    x = torch.zeros((2, 4, 0), dtype=torch.int8)
    w = torch.zeros((0, 3), dtype=torch.int8)
    s, b = torch.ones((1, 3)), torch.zeros((1, 3))
    fn = getattr(K, entry)
    with pytest.raises(ValueError, match="K = 0"):
        if "fused" in entry:
            fn(x, w, s, b)
        else:
            fn(x[0], w)


def test_launch_counters_stay_zero_on_cpu():
    K.reset_launch_counts()
    x, w, s, b = _t(*_operands(4, 8, 3))
    K.approx_matmul(x, w)
    K.fused_matmul(x, w, s, b, variant="stage1")
    K.rank1_matmul(x, w)
    K.rank1_fused_matmul(x, w, s, b)
    for fn in (K.approx_matmul, K.fused_matmul, K.rank1_matmul,
               K.rank1_fused_matmul):
        assert fn.launches == 0 and sum(fn.variant_launches.values()) == 0


def test_build_writes_generated_header_and_needs_nvcc(tmp_path, monkeypatch):
    """Without a CUDA compiler the build raises instead of falling back.
    It compiles the sources in csrc/ alone: none includes the generated
    deficit header (codegen.emit_header, the circuit's record), since the
    CUDA-core kernel reads each design's deficits from a table, and the
    build writes none."""
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.build()
    assert not (tmp_path / "deficit_gen.cuh").exists()
    for src in K.SOURCE.parent.glob("*.cu"):
        assert "deficit_gen.cuh" not in src.read_text()
    assert "deficit_proposed" in codegen.emit_header()


def test_port_oracles_match_reference_oracles():
    """repro_torch.kernels.ref against repro.kernels.ref, and the plain
    versions against those oracles."""
    from repro.kernels import ref as RR
    from repro_torch.kernels import ref as PR
    x, w, _, _ = _operands(9, 20, 17)
    tx, tw = _t(x, w)
    lut = PR.approx_matmul_ref(tx, tw)
    np.testing.assert_array_equal(
        lut.numpy(), np.asarray(RR.approx_matmul_ref(jnp.asarray(x),
                                                     jnp.asarray(w))))
    st1 = PR.stage1_matmul_ref(tx, tw)
    np.testing.assert_array_equal(
        st1.numpy(), np.asarray(RR.stage1_matmul_ref(jnp.asarray(x),
                                                     jnp.asarray(w))))
    assert torch.equal(K.approx_matmul_plain(tx, tw), lut)
    assert torch.equal(K.rank1_matmul_plain(tx, tw), lut)
    assert torch.equal(K.approx_matmul_plain(tx, tw, kernel="stage1"), st1)
    assert torch.equal(PR.int8_matmul(tx, tw),
                       tx.long().matmul(tw.long()).int())


# A loop in the layout of ``cuobjdump -sass``: x and w loaded from shared
# memory, one per-operand instruction, four that combine both (the last
# two through a predicate), loop control, and a barrier-free back edge.
SASS_LISTING = """
\t\tFunction : _Z6kernelv
        /*0000*/                   S2R R0, SR_TID.X ;            /* 0x0000000000007919 */
                                                                 /* 0x000e220000002100 */
        /*0010*/                   LDS R4, [R2] ;                /* 0x0000000002047984 */
                                                                 /* 0x000e280000000800 */
        /*0020*/                   LDS R5, [R3+0x40] ;           /* 0x0000400003057984 */
        /*0030*/                   IABS R6, R4 ;                 /* 0x0000000400067213 */
        /*0040*/                   IMAD R10, R4, R5.reuse, R10 ; /* 0x000000050a0a7224 */
        /*0050*/                   LOP3.LUT R7, R6, R5, RZ, 0xc0, !PT ;
        /*0060*/                   ISETP.GT.AND P0, PT, R7, RZ, PT ;
        /*0070*/              @P0 IADD3 R10, R10, -0x1, RZ ;
        /*0080*/                   VIADD R2, R2, 0x4 ;
        /*0090*/                   ISETP.NE.AND P1, PT, R2, 0x80, PT ;
        /*00a0*/              @P1 BRA 0x10 ;
        /*00b0*/                   STG.E [R8.64], R10 ;
        /*00c0*/                   EXIT ;
"""


@pytest.mark.parametrize("line, dests, srcs, guarded", [
    ("ISETP.GT.AND P0, PT, R44.reuse, RZ, PT", ("P0",), ("R44",), False),
    ("IADD3 R10, P0, R5.reuse, UR4, RZ", ("R10", "P0"), ("R5", "UR4"),
     False),
    ("@!P0 IMAD.MOV R27, RZ, RZ, R36", ("R27",), ("P0", "R36"), True),
    ("LDS R44, [R39+0x40]", ("R44",), ("R39",), False),
    ("STS [R3], R7", (), ("R3", "R7"), False),
    ("IMAD.WIDE.U32 R2, R4, 0x4, R6", ("R2", "R3"), ("R4", "R6"), False),
    ("ISETP.EQ.OR P1, PT, R2, 0x3, !P0", ("P1",), ("R2", "P0"), False),
])
def test_sass_parse_instr(line, dests, srcs, guarded):
    ins = SASS.parse_instr(0x40, line)
    assert (ins.dests, ins.srcs, ins.guarded) == (dests, srcs, guarded)


def test_sass_counts_instructions_that_combine_both_operands():
    fns = SASS.functions(SASS_LISTING)
    assert list(fns) == ["_Z6kernelv"] and len(fns["_Z6kernelv"]) == 13
    loop = SASS.inner_loop(fns["_Z6kernelv"])
    assert (loop[0].addr, loop[-1].addr) == (0x10, 0xa0)
    assert loop[-1].target == 0x10
    assert SASS.pair_ops(loop) == (4, 2, 0)
    # one 1x1 tile step per trip: 4 per pair; a 2x2 tile would load 4
    assert SASS.ops_per_pair(loop, (1, 1)) == (4.0, 0.0)
    with pytest.raises(ValueError, match="tile steps"):
        SASS.ops_per_pair(loop, (2, 2))


def test_sass_follows_loads_issued_for_the_next_trip():
    """Operands loaded at the end of a trip are used in the next one; the
    accumulator's tags do not carry over."""
    listing = "\n".join(f"        /*{a:04x}*/  {t} ;" for a, t in [
        (0x10, "IMAD R10, R4, R5, R10"),
        (0x20, "IADD3 R10, R10, R6, RZ"),
        (0x30, "LDS R4, [R2]"),
        (0x40, "LDS R5, [R3]"),
        (0x50, "IABS R6, R4"),
        (0x60, "BRA 0x10")])
    fns = SASS.functions("\tFunction : f\n" + listing)
    assert SASS.pair_ops(SASS.inner_loop(fns["f"])) == (2, 2, 0)


def test_sass_inner_loop_is_the_loop_with_most_shared_loads():
    """An epilogue's short loop over one staged sum is not the contraction
    step."""
    listing = "\n".join(f"        /*{a:04x}*/  {t} ;" for a, t in [
        (0x10, "LDS R4, [R2]"),
        (0x20, "LDS R5, [R3]"),
        (0x30, "IMAD R10, R4, R5, R10"),
        (0x40, "@P0 BRA 0x10"),
        (0x50, "LDS R6, [R7]"),
        (0x60, "IADD3 R11, R11, R6, RZ"),
        (0x70, "@P1 BRA 0x50")])
    loop = SASS.inner_loop(SASS.functions("\tFunction : f\n" + listing)["f"])
    assert (loop[0].addr, loop[-1].addr) == (0x10, 0x40)


def test_sass_counts_table_lookups_apart():
    """A shared load whose address combines an x and a w value is a table
    lookup, counted apart from the operand loads; what uses its value
    combines both operands. A vector load counts each 32-bit value."""
    listing = "\n".join(f"        /*{a:04x}*/  {t} ;" for a, t in [
        (0x10, "LDS.64 R4, [R2]"),
        (0x20, "LDS.64 R8, [R3+0x100]"),
        (0x30, "IMAD R20, R4, R8, R20"),
        (0x40, "IADD3 R11, R5, R9, RZ"),
        (0x50, "LDS.S16 R12, [R11+0x40]"),
        (0x60, "IADD3 R20, R20, -R12, RZ"),
        (0x70, "VIADD R2, R2, 0x8"),
        (0x80, "ISETP.NE.AND P0, PT, R2, 0x80, PT"),
        (0x90, "@P0 BRA 0x10")])
    loop = SASS.inner_loop(SASS.functions("\tFunction : f\n" + listing)["f"])
    assert SASS.pair_ops(loop) == (3, 4, 1)
    # a 1x1 tile step loading two values per operand
    assert SASS.ops_per_pair(loop, (1, 1), 2) == (3.0, 1.0)
    with pytest.raises(ValueError, match="tile steps"):
        SASS.ops_per_pair(loop, (2, 2), 2)
