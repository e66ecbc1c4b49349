"""The port's gate-level core against the JAX package's (repro.core).

Tables, deficits and factorizations are integers: every comparison here
is exact."""
import numpy as np
import pytest
import torch

from repro.core import compressors as RC
from repro.core import deficit as RD
from repro.core import factor as RF
from repro.core import luts as RL
from repro.core import metrics as RM
from repro.core import multiplier as RMu

from repro_torch.core import compressors as C
from repro_torch.core import deficit as D
from repro_torch.core import factor as F
from repro_torch.core import luts as L
from repro_torch.core import metrics as M
from repro_torch.core import multiplier as Mu
from repro_torch.kernels import codegen

# The suite runs in parallel worker processes: one intra-op thread per
# worker keeps torch from oversubscribing the CPU.
torch.set_num_threads(1)

DESIGNS = tuple(C.DESIGNS)
A = np.arange(256)[:, None] * np.ones((1, 256), np.int64)
B = A.T.copy()


def test_design_registry_matches():
    assert DESIGNS == tuple(RC.DESIGNS)
    for name in DESIGNS:
        ours, ref = C.DESIGNS[name], RC.DESIGNS[name]
        np.testing.assert_array_equal(ours.table, ref.table)
        assert (ours.error_prob_num, ours.input_perm) == (
            ref.error_prob_num, ref.input_perm)


@pytest.mark.parametrize("design", DESIGNS)
def test_compress_torch_matches_numpy(design):
    idx = np.arange(16)
    bits = [(idx >> t) & 1 for t in range(4)]
    want = RC.compress(design, *bits)
    got = C.compress(design, *[torch.from_numpy(b) for b in bits])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("structure", ["proposed", "design1", "design2"])
@pytest.mark.parametrize("design", DESIGNS)
def test_product_error_signed_tables_match(design, structure):
    ours = Mu.MultiplierConfig(name="t", compressor=design,
                               structure=structure)
    ref = RMu.MultiplierConfig(name="t", compressor=design,
                               structure=structure)
    np.testing.assert_array_equal(L.product_lut(ours), RL.product_lut(ref))
    np.testing.assert_array_equal(L.error_lut(ours), RL.error_lut(ref))
    np.testing.assert_array_equal(L.signed_product_lut(ours),
                                  RL.signed_product_lut(ref))


@pytest.mark.parametrize("design", ["proposed", "design13"])
def test_gate_level_multiply_on_torch(design):
    cfg = Mu.proposed_multiplier(design)
    got = Mu.multiply(torch.from_numpy(A), torch.from_numpy(B), cfg)
    np.testing.assert_array_equal(got.numpy(), L.product_lut(cfg))


@pytest.mark.parametrize("design", DESIGNS)
def test_deficit_sum_torch_matches_reference(design):
    """All 2^16 unsigned pairs; torch, numpy and the reference agree."""
    want = RD.deficit_sum(A, B, design)
    np.testing.assert_array_equal(D.deficit_sum(A, B, design), want)
    got = D.deficit_sum(torch.from_numpy(A).int(),
                        torch.from_numpy(B).int(), design)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    cfg = Mu.proposed_multiplier(design)
    prod = D.approx_product(torch.from_numpy(A).int(),
                            torch.from_numpy(B).int(), cfg)
    np.testing.assert_array_equal(prod.numpy(), L.product_lut(cfg))


@pytest.mark.parametrize("design", DESIGNS)
def test_factorize_matches_reference(design):
    ours, ref = F.factorize(design), RF.factorize(design)
    assert (ours.R, ours.rank, ours.n_digits, ours.k_exact_f32,
            ours.subsets) == (ref.R, ref.rank, ref.n_digits,
                              ref.k_exact_f32, ref.subsets)
    for field in ("U", "V", "u_signed", "v_signed"):
        np.testing.assert_array_equal(getattr(ours, field),
                                      getattr(ref, field))
    assert ours.stage1 == tuple(
        F.Stage1Term(t.col, t.a_mask, t.b_mask, t.coeff) for t in ref.stage1)
    for p, q in zip(F.v_digit_planes(ours), RF.v_digit_planes(ref),
                    strict=True):
        np.testing.assert_array_equal(p, q)


def test_factorize_proposed_constants():
    fac = F.factorize("proposed")
    assert (fac.R, fac.n_digits, fac.k_exact_f32) == (49, 2, 2614)
    assert F.STAGE1_SITES == RF.STAGE1_SITES


def test_metrics_match_reference():
    cfg = Mu.proposed_multiplier()
    ours = M.evaluate(L.product_lut(cfg), M.exhaustive_exact())
    ref = RM.evaluate(RL.product_lut(RMu.proposed_multiplier()),
                      RM.exhaustive_exact())
    assert ours == M.ErrorMetrics(**ref.to_dict())
    # paper Table 2 (proposed): NMED 0.046 %, MRED 0.109 %
    assert round(ours.nmed_pct, 3) == 0.046
    assert round(ours.mred_pct, 3) == 0.109
    s_ours = M.evaluate_signed(L.signed_product_lut(cfg),
                               M.exhaustive_exact_signed())
    s_ref = RM.evaluate_signed(
        RL.signed_product_lut(RMu.proposed_multiplier()),
        RM.exhaustive_exact_signed())
    assert s_ours.to_dict() == s_ref.to_dict()


@pytest.mark.parametrize("design", DESIGNS)
def test_codegen_program_matches_deficit_sum(design):
    """The straight-line program the CUDA kernel compiles, interpreted with
    numpy in int32, equals the reference deficit over all 2^16 pairs."""
    prog = codegen.record(design)
    np.testing.assert_array_equal(codegen.interpret(prog, A, B),
                                  RD.deficit_sum(A, B, design))
    text = codegen.emit_function(f"deficit_{design}", prog)
    assert text.count("const int t") == prog.n_ops
    assert "<<" not in text           # shifts left are emitted as products


def test_codegen_header_lists_every_design():
    header = codegen.emit_header()
    assert f"#define DEFICIT_N_DESIGNS {len(DESIGNS)}" in header
    for idx, name in enumerate(DESIGNS):
        assert f"deficit_fn<{idx}>(int a, int b) {{ return deficit_{name}" \
            in header


def test_codegen_stage1_functions_match_sites():
    """The emitted stage-1 expressions are also valid Python: evaluate them
    over every magnitude and pair of feature masks."""
    body = {}
    for line in codegen.emit_stage1().splitlines():
        if line.startswith("__device__"):
            name = line.split("int ")[1].split("(")[0]
        elif line.strip().startswith("return"):
            body[name] = line.strip()[len("return "):-1]
    mags = range(129)

    def window(v, s):
        return int(((v >> s) & 15) == 15)

    for m in mags:
        fx = eval(body["stage1_x_features"], {"m": m})
        fw = eval(body["stage1_w_features"], {"m": m})
        for s, (col, ra, rb) in enumerate(F.STAGE1_SITES):
            assert (fx >> s) & 1 == window(m, ra)
            assert (fw >> s) & 1 == window(m, rb)
    for f in range(128):
        want = sum(1 << col for s, (col, _, _) in enumerate(F.STAGE1_SITES)
                   if (f >> s) & 1)
        assert eval(body["stage1_correction"], {"f": f}) == want
