#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printing its seconds:

1. device   require CUDA, print the card's name and power limit, and turn
            TF32 off for float32 matmuls and cuDNN convolutions;
2. build    compile the CUDA kernels with nvcc for sm_90a from the
            repository's sources (src/repro_torch/kernels/csrc, one nvcc
            per source, in parallel), read from their SASS the
            integer instructions and table lookups the CUDA-core body
            spends per operand pair (the operation counts of its bound),
            and require int8 tensor-core instructions in the tensor-core
            kernel's SASS;
3. kernels  hold every kernel entry and variant to its plain PyTorch
            version on the card, bitwise: all 256 x 256 int8 byte pairs at
            K = 1 against the numpy product tables (rank1 for the proposed
            design and design13, deficit under all 7 designs), ragged and
            batched shapes across the tile seams of both kernels (K past
            one staged x slab of the tensor-core kernel too; rows across
            the CUDA-core kernel's row tiles, K split into slices with a
            ragged last one, ragged N), an int32 sum past 2^31 through a
            67-slice split of K, and the LeNet-5, Keras CNN and FFDNet
            layer shapes (the suites' FFDNet too), smollm-135m's
            decode (4 slots of one row), verify (4 slots of a K = 4
            window) and prefill shapes, the lm suite's eval shapes
            (32 x 64 rows, d_model 128) and the serve suite's decode,
            verify and prefill shapes; K2 and K4 (the LM routes) at
            gemma3-27b's and deepseek-v2's decode shapes (the gemma3 head,
            5,376 x 262,144, in 37 column tiles of RANK1) and gemma3's
            1,000-token prefill, and at rwkv6-3b's and hymba-1.5b's decode
            shapes (SSM_LAYERS), and at the train path's shapes
            (TRAIN_LAYERS: every projection and head of the five trained
            archs at 8 x 64 tokens, each entry and plain version timed
            over the one call checked); K3 and
            K4 in 24 column tiles of a small
            budget; printing the CUDA-core plan
            (tile, K slices) of each; hold every backend's
            int32 output to the JAX
            package's (src/repro_torch/testdata/reference.npz); time each
            entry (fused_matmul[exact] in turns with torch._int_mm), its
            kernel's device time under torch.profiler, for the CUDA-core
            entries the plan (tiles, K slices), and for the tensor-core
            entries the build of their weight operands; K2[deficit]'s
            device time on uniform, constant and post-ReLU operands (what
            the table lookups' bank conflicts cost);
4. lenet5   eval_classifier on 500 synthetic digits with the fixture's
            JAX-trained weights under bf16, int8_exact and every approx
            backend: each CUDA backend's accuracy equals its oracle's, the
            deficit kernel's logits equal approx_lut's bit for bit, the
            unfused route (kernels K1, K3) equals the fused one bit for bit,
            and the oracles' accuracies equal the JAX package's; one
            batch's forward timed and traced as in phase 5; the Keras CNN
            (random weights) under each CUDA backend equals its oracle;
5. ffdnet   eval_denoiser on 16 64x64 textures at sigma 25 with the
            full-width FFDNet (depth 8, width 64) under the three CUDA
            backends, fused and unfused, and their oracles: outputs equal
            bit for bit; each forward timed FORWARD_REPS times, and one
            traced with torch.profiler for its device time;
6. suites   the six result suites through repro_torch.eval's
            runners at their paper-scale budgets: metrics and hw equal the
            committed experiments/eval tables; lm (a 4-layer, 128-wide
            smollm QAT-trained 300 steps, 32 x 64 eval tokens) and serve
            (its random-init weights on the 8-request workload, each point
            served sequentially, alone and speculatively): every *_pallas
            row equals its oracle's, every serve row has solo == batched
            and spec == sequential; mnist (LeNet-5, 300 QAT
            steps on 5,000 digits, 500 test digits) and denoise (FFDNet
            depth 6, width 32, 150 QAT steps on 64x64 textures, 16 images
            at sigma 25 and 50) train on the card and sweep bf16, all 15
            backends and two multiplier variants: the training loss falls,
            bf16 LeNet-5 scores at least 90 %, every *_pallas row equals
            its oracle's and every MSR core row its *_lut row, and each
            CUDA backend's logits and denoised images from the trained
            weights at the suites' sizes equal its oracle's bit for bit;
            one LeNet-5
            train_step through the deficit kernel (STE, qat=False) gives
            the gradients of the same step under approx_lut, bit for bit;
            ms per training step (CUDA events at each batch), one profiled
            step, cuDNN deterministic against not, and each sweep point's
            seconds; the artifacts are written to build/torch_eval/;
7. serve    smollm-135m at its published width, its first SERVE_DEPTH
            (15) of 30 layers (d_model 576, vocab 49152, bf16 parameters
            from the port's own init at seed 0; the depth is cut to keep
            the script inside its time limit) through
            repro_torch.serve.Engine, continuous batching
            with the paged prefix cache, on the JAX package's serve-suite
            workload (8 requests into 4 slots, max_len 112, an 8-token
            shared prefix): under bf16, int8_exact, the oracles approx_lut
            and approx_stage1 and the three CUDA backends. Each CUDA
            backend's served tokens and every logits row it sampled from
            equal its oracle's bit for bit; approx_stage1_pallas unfused
            (kernel K1) equals its fused run; the probe request (admitted
            mid-decode on a prefix-cache hit) served alone on a cold engine
            gives the same tokens; the prefix hit rate is above 0; one
            decode step launches 106 kernels (7 projections x 15 layers +
            the head). Each backend serves the workload twice (the tokens
            must agree); per run, ms per decode step (median, host clock
            around each step, synchronized), TTFT and tokens/s. Per
            backend, a fixed-shape decode step of the 4-slot pool timed
            over 20 calls (median and quartiles) and one profiled call's
            busy ms, port-kernel ms and idle share; the rank1 operand
            build at the head. Then ``python -m
            repro_torch.serve --backend approx_deficit_pallas`` runs once;
8. spec     the same workload served again with speculative decoding
            (SpecConfig(k=4, draft_backend="approx_stage1_pallas"), which
            is bitwise the approx_stage1 draft the serve suite names)
            under the three CUDA backends and bf16: the tokens equal the
            backend's sequential serving's; on a probe of 4 slots, verify
            rows j = 0..3 equal the four sequential decode steps' rows and
            cache writes bit for bit for the CUDA backends (bf16: within
            BF16_VERIFY_RTOL of their range), and the same readings for
            each of VERIFY_FORMS are printed; accepted drafts per pass and
            their histogram, ms per decoded token (the draft's admission
            prefills in and out) against the sequential serving's, and for
            a fixed verify pass
            and draft step their ms, busy, kernel and idle share and
            kernel launches (per pass: verify + 4 draft steps);
9. gemma   gemma3-27b at its published widths (bf16 parameters from seed
            0, the large leaves drawn on the card): all 62 layers
            (27.0 B parameters, block program [(10, local x 5 + global),
            (1, global x 2)]) serve the serve suite's workload under
            approx_deficit_pallas, unpaged at exact prompt lengths
            (max_len 112: the window of 1,024 masks, no ring wraps), with
            the peak memory; then its first 6 layers (one 5:1 group, the
            window as published) serve 4 requests of 1,000-1,020 prompt
            tokens and 32-48 new into 2 slots at max_len 1,088, so that
            decode wraps the rings, under bf16 and the three CUDA
            backends: deficit's and rank1's tokens and every sampled logits
            row bitwise equal; each CUDA backend equal to its oracle
            (approx_lut / approx_stage1) on the workload's first 2
            requests cut to 48 prompt tokens and 6 new (ORACLE_PREFIX);
            bf16's rows past position 1,024 within RING_RTOL of a
            cache-free forward over the whole sequence; per backend the
            serving's step ms and a fixed step's ms, busy, kernels and
            idle share;
10. deepseek deepseek-v2-236b at its published widths (d_model 5,120, 128
            heads, kv_lora 512, 160 experts top-6, 2 shared) at depth 4
            (17.3 B parameters, seed 0) on the serve suite's workload with
            the prefix cache, under bf16, the oracles and the three CUDA
            backends (each bitwise equal to its oracle, tokens and rows),
            and one speculative serving (K = 4, approx_stage1_pallas
            draft, approx_deficit_pallas target) equal to sequential
            decode;
11. ssm   rwkv6-3b (32 layers of RWKV6 time and channel mix, d_model
            2,560, 40 heads of 64, d_ff 8,960, vocab 65,536, the chunked
            WKV; 3,099,527,680 bf16 parameters) and hymba-1.5b (32 layers
            of windowed attention beside Mamba, d_model 1,600, 25 / 5 heads
            of 64, state 16, window 1,024, SwiGLU d_ff 5,504; 1,345,537,600)
            at their published widths from seed 0: first the chunked WKV
            against the sequential recurrence at rwkv6's layer shape (150
            steps, three chunks); then each whole model serves the serve
            suite's workload (rwkv6 with one more request of a 150-token
            prompt: three WKV chunks, the last ragged, at max_len 192)
            unpaged at exact prompt lengths under bf16 and
            approx_deficit_pallas, with each serving's step ms, TTFT, ms
            per decoded token, peak memory, a timed prefill of the longest
            prompt, and a fixed decode step's ms, busy, kernels, idle share
            and launches; bf16's sampled rows within SSM_RTOL of their
            range of a cache-free forward over the same tokens; then the
            first SSM_DEPTH layers of the same draw (the head whole) serve
            the workload under the oracles approx_lut and approx_stage1
            and the three CUDA backends: each CUDA backend's tokens and
            every sampled logits row bitwise equal to its oracle's, and
            deficit's to rank1's;
12. train  the LM training path. (a) The fault-tolerant loop
            (repro_torch.train.train_loop) on smollm-135m at its
            published width: QAT, AdamW with int8 second moments, two
            microbatches, batch 8 x 64, a checkpoint every 4 steps and a
            failure injected after step 9 of 12; the rerun resumes from
            step 8 and runs 4 steps; every leaf restored from step 8
            (params, bf16 m, int8 v codes, v scales, the step count)
            equals the host copy that was saved, bit for bit; the loss is
            finite and falls; ms per step, the seconds and bytes of one
            save and one restore; then ``python -m
            repro_torch.examples.lm_train --model-scale 100m --crash
            --steps 1`` runs once in a subprocess and exits 0. (b)
            smollm-135m whole, gemma3-27b at depth 6 (one 5:1 group, 3.9 B
            parameters), deepseek-v2-236b at depth 1 (5.1 B), rwkv6-3b
            and hymba-1.5b whole, at their published widths (bf16 from
            seed 0, remat on): three
            make_train_step(qat=True) steps with quantized AdamW on one
            token_stream batch of 8 x 64, a finite and falling loss,
            the MoE aux loss, ms per step, one profiled step's busy and
            idle share, the peak memory; then the loss and every gradient
            of one STE step (qat off) under approx_deficit_pallas equal
            approx_rank1_pallas's bit for bit (deterministic algorithms),
            and on a cut batch of 1 x 16 tokens approx_deficit_pallas's
            equal approx_lut's and approx_stage1_pallas's
            approx_stage1's;
13. launch counts, set to 0 before each of phases 4, 5 and 6 (the suite
   runners' calls), 7 (the served runs), 8 (the speculative runs), the
   served runs of 9, 10 and 11 and the STE steps of 12, and read after
   it: LeNet-5 and FFDNet each launch every entry but
   fused_matmul[exact], the suites, spec, train and the ring, deepseek
   and ssm paths every fused entry, the serve path K2[deficit],
   K2[stage1], K4 and (unfused) K1[stage1], full-depth gemma3
   K2[deficit];
14. one JSON line each ``{"suites": {...}}``, ``{"serve": {...}}``,
   ``{"spec": {...}}``, ``{"gemma": {...}}``,
   ``{"deepseek": {...}}``, ``{"ssm": {...}}``, ``{"train": {...}}`` and
   ``{"kernels": [...]}``;
then the ``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "src" / "repro_torch" / "testdata" / "reference.npz"
DETAIL = ROOT / "build" / "chip_smoke_detail.json"
EVAL_OUT = ROOT / "build" / "torch_eval"
COMMITTED_EVAL = ROOT / "experiments" / "eval"
CUDA_CORE_SOURCE = "src/repro_torch/kernels/csrc/approx_matmul.cu"
TC_SOURCE = "src/repro_torch/kernels/csrc/tc_matmul.cu"

# Published H100 SXM rates, at the 700 W limit (NVIDIA data sheet): device
# memory, int8 tensor cores. The data sheet gives no rate for 32-bit
# integer work on the CUDA cores. Each SM has 64
# INT32 lanes, but IMAD issues on the FP32 pipe, so integer work is capped
# only by issue: 4 schedulers x 32 lanes per clock per SM. 132 SMs x 128
# lanes x 1.98 GHz (the boost clock behind the data sheet's 67 TFLOP/s
# float32) = 33.5 T operations/s, which keeps the bound a lower bound.
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12
INT_ISSUE_OPS_PER_S = 132 * 128 * 1.98e9
# Shared memory answers 32 lanes (one 4-byte bank each) per clock per SM:
# at most one table lookup per lane per clock, at the same clock.
LDS_LOOKUPS_PER_S = 132 * 32 * 1.98e9

# Logits of the two stacks agree within this share of their range: the
# int8 codes and int32 accumulators are bitwise equal, the float32 pools
# and epilogues may round differently in the last place (same bound as
# tests/test_torch_fixture.py).
LOGIT_RTOL = 2e-3

# (entry, variant, Pallas entry it replaces, file:line of its pallas_call)
ROWS = (
    ("approx_matmul", "deficit", "src/repro/kernels/approx_matmul.py:265"),
    ("approx_matmul", "stage1", "src/repro/kernels/approx_matmul.py:265"),
    ("fused_matmul", "deficit", "src/repro/kernels/approx_matmul.py:317"),
    ("fused_matmul", "stage1", "src/repro/kernels/approx_matmul.py:317"),
    ("fused_matmul", "exact", "src/repro/kernels/approx_matmul.py:317"),
    ("rank1_matmul", "rank1", "src/repro/kernels/approx_matmul.py:382"),
    ("rank1_fused_matmul", "rank1",
     "src/repro/kernels/approx_matmul.py:428"),
)
TC_VARIANTS = ("exact", "rank1")      # bodies of the tensor-core kernel
# Tile seams of the tensor-core kernel: 64-row warpgroups in 128-row
# blocks, 8-column MMA tiles and block widths 8/16/32/64, 32-byte MMA steps
# over K and over K * R, K past one staged x slab (1,024 columns), and
# rows of 1, 4 and 16-byte multiples (its three copy widths).
TC_SEAMS = {"seam(65,25,4)": (1, 65, 25, 4), "seam(129,45,9)": (1, 129, 45, 9),
            "seam(2x65,150,8)": (2, 65, 150, 8),
            "seam(129,25,33)": (1, 129, 25, 33),
            "seam(129,2051,9)": (1, 129, 2051, 9),
            "seam(65,1300,17)": (1, 65, 1300, 17)}
# Seams of the CUDA-core kernel's plans: rows across its row tiles (4, 8,
# 16, 32, 64), K across its split slices (whole steps of 32, the last
# ragged), N across its column tiles (16, 32, 64) and ragged.
CUDA_CORE_SEAMS = {"cc(1,577,65)": (1, 1, 577, 65),
                   "cc(5,31,4)": (1, 5, 31, 4),
                   "cc(9,1536,192)": (1, 9, 1536, 192),
                   "cc(17,3136,10)": (1, 17, 3136, 10),
                   "cc(2x33,575,17)": (2, 33, 575, 17),
                   "cc(63,33,1)": (1, 63, 33, 1),
                   "cc(65,1,576)": (1, 65, 1, 576),
                   "cc(3,4100,33)": (1, 3, 4100, 33)}
# an int32 sum that passes 2^31 (every operand 127) through a split of K
WRAP_SHAPE = (1, 140_000, 65)
# The variants the LeNet-5 and FFDNet paths (phases 4, 5) must each launch:
# no caller of the JAX package (nor of the port) selects fused_matmul's
# "exact" variant.
PATH_VARIANTS = [r[:2] for r in ROWS if r[1] != "exact"]
# the suites' sweeps take the fused route of each CUDA backend
SUITE_VARIANTS = [("fused_matmul", "deficit"), ("fused_matmul", "stage1"),
                  ("rank1_fused_matmul", "rank1")]
# the serve phase: per-token (for_lm) routes of the CUDA backends, fused,
# and approx_stage1_pallas once unfused
SERVE_VARIANTS = SUITE_VARIANTS + [("approx_matmul", "stage1")]
# the new archs' paths run the fused per-token routes; the full-depth
# gemma3 path serves bf16 and approx_deficit_pallas only
ARCH_VARIANTS = SUITE_VARIANTS
# the train path's STE steps (qat off): K2 under deficit and stage1 and K4,
# the fused per-token routes
PATH_NEEDS = {"suites": SUITE_VARIANTS, "serve": SERVE_VARIANTS,
              "spec": SUITE_VARIANTS, "gemma": [("fused_matmul", "deficit")],
              "gemma_ring": ARCH_VARIANTS, "deepseek": ARCH_VARIANTS,
              "ssm": ARCH_VARIANTS, "train": ARCH_VARIANTS}

LENET_LAYERS = {  # (B, M, K, N) of each quantized matmul at batch 50
    "lenet5.c1": (50, 784, 25, 6), "lenet5.c2": (50, 196, 150, 16),
    "lenet5.fc1": (1, 50, 784, 120), "lenet5.fc2": (1, 50, 120, 84),
    "lenet5.fc3": (1, 50, 84, 10)}
KERAS_LAYERS = {  # the Keras CNN (models/cnn.py) at batch 50
    "keras.c1": (50, 784, 9, 32), "keras.c2": (50, 196, 288, 64),
    "keras.fc1": (1, 50, 3136, 128), "keras.fc2": (1, 50, 128, 10)}
FFDNET_LAYERS = {  # 16 images of 64x64 -> 32x32 after pixel_unshuffle
    "ffdnet.in": (16, 1024, 45, 64), "ffdnet.mid": (16, 1024, 576, 64),
    "ffdnet.out": (16, 1024, 576, 4)}
LAYERS = {**LENET_LAYERS, **KERAS_LAYERS, **FFDNET_LAYERS}
SUITE_LAYERS = {  # the denoise suite's FFDNet (depth 6, width 32), 16 images
    "suite.ffdnet.in": (16, 1024, 45, 32),
    "suite.ffdnet.mid": (16, 1024, 288, 32),
    "suite.ffdnet.out": (16, 1024, 288, 4)}
SERVE_LAYERS = {  # smollm-135m: a decode step of 4 slots, one prefill
    "smollm.decode.q": (4, 1, 576, 576), "smollm.decode.kv": (4, 1, 576, 192),
    "smollm.decode.up": (4, 1, 576, 1536),
    "smollm.decode.down": (4, 1, 1536, 576),
    "smollm.decode.head": (4, 1, 576, 49152),
    "smollm.prefill.up": (1, 32, 576, 1536)}
VERIFY_LAYERS = {  # smollm-135m: a K = 4 verify window of 4 slots
    "smollm.verify.q": (4, 4, 576, 576), "smollm.verify.kv": (4, 4, 576, 192),
    "smollm.verify.up": (4, 4, 576, 1536),
    "smollm.verify.down": (4, 4, 1536, 576),
    "smollm.verify.head": (4, 4, 576, 49152)}
LM_SUITE_LAYERS = {  # the lm suite's full eval: 32 x 64 tokens, d_model 128
    "lm.q": (32, 64, 128, 128), "lm.kv": (32, 64, 128, 32),
    "lm.up": (32, 64, 128, 256), "lm.down": (32, 64, 256, 128),
    "lm.head": (32, 64, 128, 512)}
SERVE_SUITE_LAYERS = {  # the serve suite's full arch (4 slots, d_model 128)
    "ss.decode.q": (4, 1, 128, 128), "ss.decode.kv": (4, 1, 128, 32),
    "ss.decode.up": (4, 1, 128, 256), "ss.decode.down": (4, 1, 256, 128),
    "ss.decode.head": (4, 1, 128, 512),
    "ss.verify.q": (4, 4, 128, 128), "ss.verify.kv": (4, 4, 128, 32),
    "ss.verify.up": (4, 4, 128, 256), "ss.verify.down": (4, 4, 256, 128),
    "ss.verify.head": (4, 4, 128, 512),
    "ss.prefill.up": (1, 32, 128, 256)}
ARCH_LAYERS = {  # gemma3-27b and deepseek-v2-236b: decode of 4 slots, and
    # gemma3's long-context prefill (the depth-6 ring workload's ~1,000-
    # token prompts); held for the LM routes only (ARCH_VARIANTS)
    "gemma.decode.q": (4, 1, 5376, 4096),
    "gemma.decode.kv": (4, 1, 5376, 2048),
    "gemma.decode.o": (4, 1, 4096, 5376),
    "gemma.decode.gu": (4, 1, 5376, 21504),
    "gemma.decode.d": (4, 1, 21504, 5376),
    "gemma.decode.head": (4, 1, 5376, 262144),
    "gemma.prefill.gu": (1, 1000, 5376, 21504),
    "dsv2.decode.wq": (4, 1, 5120, 24576),
    "dsv2.decode.wdkv": (4, 1, 5120, 576),
    "dsv2.decode.wo": (4, 1, 16384, 5120),
    "dsv2.decode.head": (4, 1, 5120, 102400)}
SSM_LAYERS = {  # rwkv6-3b and hymba-1.5b: decode of 4 slots; held for the
    # LM routes only, as ARCH_LAYERS
    "rwkv6.decode.d": (4, 1, 2560, 2560),      # r, k, v, g, o; cmix wr
    "rwkv6.decode.k": (4, 1, 2560, 8960),      # cmix wk
    "rwkv6.decode.v": (4, 1, 8960, 2560),      # cmix wv
    "rwkv6.decode.head": (4, 1, 2560, 65536),
    "hymba.decode.d": (4, 1, 1600, 1600),      # q, o; Mamba out_proj
    "hymba.decode.kv": (4, 1, 1600, 320),
    "hymba.decode.in": (4, 1, 1600, 3200),     # Mamba in_proj
    "hymba.decode.x": (4, 1, 1600, 64),        # Mamba x_proj (split K)
    "hymba.decode.gu": (4, 1, 1600, 5504),
    "hymba.decode.down": (4, 1, 5504, 1600),
    "hymba.decode.head": (4, 1, 1600, 32256)}
# The train path (phase 12): the STE step's batch of 8 x 64 tokens
# through each trained arch's projections and head, the (K, N) of the
# decode shapes above (smollm-135m's o is its q's; deepseek-v2's experts
# run as float products). Their plain versions take up to 24 s a call:
# the kernel, its plain version and RANK1's operand build are each timed
# over the one call that is checked, and TRAIN_REPS runs of the kernel
# profiled.
TRAIN_ROWS = (8, 64)
TRAIN_LAYERS = {
    label.replace(".decode.", ".train."): (*TRAIN_ROWS, k, n)
    for label, (_, _, k, n) in {**SERVE_LAYERS, **ARCH_LAYERS,
                                **SSM_LAYERS}.items()
    if ".decode." in label}
TRAIN_REPS = 1
LM_ROUTE_LAYERS = {**ARCH_LAYERS, **SSM_LAYERS, **TRAIN_LAYERS}
# RANK1's column tiles under a small budget (rank1_column_tiles): 24 tiles
TILED_LAYER = ("smollm.decode.up", 576 * (8 + 104) * 64)
TIMED_LAYERS = {**LAYERS, **SERVE_LAYERS, **VERIFY_LAYERS, **LM_SUITE_LAYERS,
                **SERVE_SUITE_LAYERS, **LM_ROUTE_LAYERS}
TIMED_LAYER = "ffdnet.mid"
FORWARD_REPS = 10


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(msg)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"== phase {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"phase {self.name}: {time.perf_counter() - self.t0:.1f} s",
                  flush=True)
        return False


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise RuntimeError("run chip_smoke.py from a checkout of the "
                           "repository (src/repro_torch is missing)")
    sys.path.insert(0, str(ROOT / "src"))
    detail: dict = {}

    with Phase("device"):
        smi = smi_line()
        print(f"card: {smi}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print("TF32 off for float32 matmuls and cuDNN convolutions")
        detail["card"] = smi

    from repro_torch.kernels import approx_matmul as K
    with Phase("build"):
        t0 = time.perf_counter()
        lib, log = K.build()
        K._lib()
        print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        for ln in regs:
            print(f"  {ln}")
        detail["ptxas"] = regs
        from repro_torch.kernels import sass as SASS
        sass = SASS.dump(lib)
        ops = sass_ops_per_pair(K, sass)
        detail["ops_per_pair_sass"] = ops
        print("per pair, instructions that combine x and w and table "
              "lookups (SASS): " + ", ".join(
                  f"{k} {v['alu']:g} + {v['lookups']:g}"
                  for k, v in ops.items()))
        detail["tc_mma_sass"] = tc_mma_count(sass)
        print("int8 tensor-core instructions in tc_mm_kernel (SASS): "
              + ", ".join(f"{k} {v}" for k, v in
                          detail["tc_mma_sass"].items()))

    with Phase("kernels"):
        rows = kernels_phase(torch, K, detail, ops)

    paths = {}          # each path's own launch counts
    lines = {}          # the result lines, by phase
    for name, run in (("lenet5", lenet5_phase), ("ffdnet", ffdnet_phase)):
        K.reset_launch_counts()
        with Phase(name):
            run(torch, detail)
        paths[name] = launch_counts(K)
    with Phase("suites"):
        lines["suites"], paths["suites"] = suites_phase(torch, detail, "cuda",
                                                        smoke=False)
    with Phase("serve"):
        lines["serve"], paths["serve"], state = serve_phase(
            torch, detail, "cuda", full=True, ops=ops)
    with Phase("spec"):
        lines["spec"], paths["spec"] = spec_phase(torch, detail, "cuda",
                                                  state)
    del state
    torch.cuda.empty_cache()
    with Phase("gemma"):
        lines["gemma"], gemma_paths = gemma_phase(torch, detail, "cuda",
                                                  full=True, ops=ops)
        paths.update(gemma_paths)
    torch.cuda.empty_cache()
    with Phase("deepseek"):
        lines["deepseek"], paths["deepseek"] = deepseek_phase(
            torch, detail, "cuda", full=True, ops=ops)
    torch.cuda.empty_cache()
    with Phase("ssm"):
        lines["ssm"], paths["ssm"] = ssm_phase(torch, detail, "cuda",
                                               full=True, ops=ops)
    torch.cuda.empty_cache()
    with Phase("train"):
        lines["train"], paths["train"] = train_phase(torch, detail, "cuda",
                                                     full=True)

    with Phase("launches"):
        for name, var, _ in ROWS:
            print(f"launches {name}[{var}]: " + ", ".join(
                f"{path} {c[(name, var)]}" for path, c in paths.items()))
        for path, counts in paths.items():
            for name, var in PATH_NEEDS.get(path, PATH_VARIANTS):
                check(counts[(name, var)] > 0,
                      f"{name}[{var}] was not launched on the {path} path")
        detail["launches"] = {
            path: {f"{name}[{var}]": n for (name, var), n in c.items()}
            for path, c in paths.items()}
        for row in rows:
            key = (row.pop("_entry"), row.pop("_variant"))
            row["launches_by_path"] = {p: c[key] for p, c in paths.items()}
            row["launches"] = sum(row["launches_by_path"].values())
        detail["launches_per_forward"] = per_forward_launches(torch, K)
        for key, n in detail["launches_per_forward"].items():
            print(f"launches per forward {key}: {n}")

    DETAIL.parent.mkdir(parents=True, exist_ok=True)
    DETAIL.write_text(json.dumps(detail, indent=1))
    for name, line in lines.items():
        print(json.dumps({name: line}, separators=(",", ":")))
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def launch_counts(K) -> dict:
    return {(name, var): getattr(K, name).variant_launches[var]
            for name, var, _ in ROWS}


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _call(K, name, variant, x, w, scale, bias, relu, plain,
          design="proposed"):
    """One entry/variant, kernel or plain version (same arguments)."""
    fn = getattr(K, f"{name}_plain" if plain else name)
    if name == "approx_matmul":
        return fn(x.reshape(-1, x.shape[-1]), w, design, kernel=variant)
    if name == "fused_matmul":
        return fn(x, w, scale, bias, design, variant=variant, relu=relu)
    if name == "rank1_matmul":
        return fn(x.reshape(-1, x.shape[-1]), w, design)
    return fn(x, w, scale, bias, design, relu=relu)   # rank1_fused_matmul


def _operands(torch, gen, b, m, k, n, dev, wgen=None):
    """Random int8 x (b, m, k) and w (k, n), a float32 scale and bias of
    n: drawn by ``gen`` on the host, w by ``wgen`` on ``dev`` if given."""
    x = torch.randint(-127, 128, (b, m, k), generator=gen,
                      dtype=torch.int8).to(dev)
    if wgen is None:
        w = torch.randint(-127, 128, (k, n), generator=gen,
                          dtype=torch.int8).to(dev)
    else:
        w = torch.randint(-127, 128, (k, n), generator=wgen,
                          dtype=torch.int8, device=dev)
    scale = (torch.rand((1, n), generator=gen) * 1e-3).to(dev)
    bias = torch.randn((1, n), generator=gen).to(dev)
    return x, w, scale, bias


def _ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed_once(torch, fn) -> tuple:
    """(fn(), its ms from CUDA events around the one call)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _ms_turns(torch, f, g, reps: int) -> tuple:
    """Kernel-event ms of ``f`` and ``g`` timed in turns (f, g, g, f),
    each the mean of its two turns."""
    a1, b1, b2, a2 = (_ms(torch, h, reps) for h in (f, g, g, f))
    return (a1 + a2) / 2, (b1 + b2) / 2


def _device_ms(torch, calls) -> list:
    """Mean device ms of the port's kernels in each of ``calls`` (triples
    of a function, the launches one run must make: 1, or RANK1's column
    tiles, and its runs), from one torch.profiler session. One stream runs
    the kernels in launch order, so the session's spans fall into the
    calls' groups in order."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn, _, reps in calls:
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    spans = [(lo, hi) for lo, hi, name in _device_spans(torch, prof)
             if _ours(name)]
    want = sum(n * reps for _, n, reps in calls)
    check(len(spans) == want, f"{len(spans)} kernel spans, {want} launches")
    out, i = [], 0
    for _, n, reps in calls:
        out.append(sum(hi - lo for lo, hi in spans[i:i + reps * n])
                   / reps / 1e6)
        i += reps * n
    return out


def _launches_per_call(K, variant: str, k: int, n: int) -> int:
    """Kernel launches of one call: RANK1 launches once per column tile."""
    return len(K.rank1_column_tiles(k, n)) if variant == "rank1" else 1


def _rank1_operands(K, w):
    """The operands RANK1's wrapper builds in one call: the K-major exact
    operand, and the plane operand of each column tile (each dropped
    before the next, as the wrapper does)."""
    K.exact_weight_operand(w)
    for n0, n1 in K.rank1_column_tiles(*w.shape):
        K.rank1_weight_planes(w[:, n0:n1])


def _ours(name: str) -> bool:
    return "approx_mm_kernel" in name or "tc_mm_kernel" in name


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.


def _bound(name, variant, rows, k, n, fac, ops) -> tuple:
    """(bound_ms, bound_by): the larger of the entry's operand/result
    bytes (x and w read once, the output written once) over the memory
    rate and the operations over the card's rate for them. EXACT is one
    int8 MAC per pair and RANK1 1 + R * nd (the exact dot and one per
    factor and digit plane), on the int8 tensor cores. The weight planes
    RANK1's wrapper builds (nd * K * R * N bytes) are its own choice of
    operand, not the function's work: their build is timed apart
    (``operands_ms``) and their stream given as ``_planes_ms``. The
    CUDA-core bodies count their SASS per pair: the integer instructions
    over the issue rate, or the table lookups over shared memory's lookup
    rate, whichever takes longer."""
    fused = name in ("fused_matmul", "rank1_fused_matmul")
    nbytes = rows * k + k * n + rows * n * 4 + (2 * n * 4 if fused else 0)
    macs = rows * k * n
    if variant == "exact":
        t_ops = 2 * macs / INT8_TC_OPS_PER_S
    elif variant == "rank1":
        t_ops = 2 * macs * (1 + fac.R * fac.n_digits) / INT8_TC_OPS_PER_S
    else:
        t_ops = macs * max(ops[variant]["alu"] / INT_ISSUE_OPS_PER_S,
                           ops[variant]["lookups"] / LDS_LOOKUPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _planes_ms(k, n, fac) -> float:
    """Milliseconds to stream RANK1's weight planes (nd * K * R * N int8)
    once from memory: what the wrapper's choice of operand adds on top of
    the function's bound."""
    return fac.n_digits * k * fac.R * n / HBM_BYTES_PER_S * 1e3


def sass_ops_per_pair(K, sass) -> dict:
    """Per CUDA-core function, the integer instructions and the table
    lookups per (x, w) pair that combine the two operands, counted in the
    SASS of the kernel's full 64 x 64 tile (kernels/sass.py): the work per
    multiply-accumulate that no operand reuse removes. The kernel stages
    three values per operand; both functions run its one body."""
    from repro_torch.kernels import sass as SASS
    src = K.SOURCE.read_text()
    tm, tx = (int(re.search(rf"constexpr int {t} = (\d+);", src).group(1))
              for t in ("TM", "TX"))
    fns = SASS.functions(sass)
    tag = "approx_mm_kernelILi64ELi64EE"
    name = [f for f in fns if tag in f]
    check(len(name) == 1, f"no single kernel {tag} in the SASS")
    alu, lookups = SASS.ops_per_pair(SASS.inner_loop(fns[name[0]]),
                                     (tm, 64 // tx), 3)
    check(lookups == 1, f"{lookups} table lookups a pair in {tag}")
    return {var: {"alu": alu, "lookups": lookups} for var in K.CUDA_CORE}


def tc_mma_count(sass) -> dict:
    """Int8 tensor-core instructions (IGMMA, the int8 wgmma; IMMA under
    mma.sync) in each instantiation of tc_mm_kernel; fails unless every
    one has some."""
    from repro_torch.kernels import sass as SASS
    fns = {f: ins for f, ins in SASS.functions(sass).items()
           if "tc_mm_kernel" in f}
    check(len(fns) > 0, "no tc_mm_kernel in the SASS")
    out = {}
    for f, ins in sorted(fns.items()):
        n = sum(i.opcode.startswith(("IMMA", "IGMMA")) for i in ins)
        check(n > 0, f"{f}: no int8 tensor-core instruction in its SASS")
        body, bn = re.search(r"tc_mm_kernelILi(\d+)ELi(\d+)E", f).groups()
        out[f"tc_mm_kernel<{body},{bn}>"] = n
    return out


def kernels_phase(torch, K, detail, ops):
    from repro_torch.core import luts
    from repro_torch.core import factor as F
    from repro_torch.core.multiplier import proposed_multiplier
    from repro_torch.kernels import codegen
    from repro_torch.quant import matmul as QM
    from repro_torch.quant.quantize import QuantConfig

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    fac = F.factorize("proposed")

    # all 256 x 256 byte pairs at K = 1 against the numpy tables
    b = torch.arange(256, dtype=torch.int32).to(torch.int8)
    xs, ws = b.reshape(256, 1).to(dev), b.reshape(1, 256).to(dev)
    lut = luts.signed_product_lut(proposed_multiplier())
    sv = np.where(np.arange(256) < 128, np.arange(256), np.arange(256) - 256)
    sgn = np.sign(sv)[:, None] * np.sign(sv)[None, :]
    st1 = QM.stage1_exhaustive_products()[np.abs(sv)[:, None],
                                          np.abs(sv)[None, :]] * sgn
    tables = {"deficit": lut, "rank1": lut, "stage1": st1,
              "exact": sv[:, None] * sv[None, :]}
    one = torch.ones((1, 256), device=dev)
    zero = torch.zeros((1, 256), device=dev)
    pairs_ok = {}
    for name, var, _ in ROWS:
        out = _call(K, name, var, xs, ws, one, zero, False, plain=False)
        want = torch.as_tensor(tables[var].astype(np.float64))
        check(torch.equal(out.double().cpu(), want),
              f"{name}[{var}] differs from the product table on 2^16 pairs")
        pairs_ok[(name, var)] = True
    lut13 = luts.signed_product_lut(proposed_multiplier("design13"))
    for name in ("rank1_matmul", "rank1_fused_matmul"):
        out = _call(K, name, "rank1", xs, ws, one, zero, False, False,
                    design="design13")
        check(torch.equal(out.double().cpu(),
                          torch.as_tensor(lut13.astype(np.float64))),
              f"{name}[design13] differs from its product table on 2^16 "
              "pairs")
    for design in codegen.designs():      # each design's correction table
        lut_d = torch.as_tensor(luts.signed_product_lut(
            proposed_multiplier(design)).astype(np.float64))
        for name in ("approx_matmul", "fused_matmul"):
            out = _call(K, name, "deficit", xs, ws, one, zero, False, False,
                        design=design)
            check(torch.equal(out.double().cpu(), lut_d),
                  f"{name}[deficit] {design} differs from its product table "
                  "on 2^16 pairs")
    print("all 2^16 byte pairs match the product tables for every entry "
          "(rank1 under design13 too, deficit under every design)")

    # fixture: every backend's int32 output equals the JAX package's
    with np.load(FIXTURE) as data:
        i = 0
        while f"x{i}" in data.files:
            x = torch.from_numpy(data[f"x{i}"]).to(dev)
            w = torch.from_numpy(data[f"w{i}"]).to(dev)
            for be in QM.list_backends():
                got = QM.integer_matmul(x, w, QuantConfig(backend=be))
                check(np.array_equal(got.cpu().numpy(),
                                     data[f"out{i}_{be}"]),
                      f"{be} differs from the JAX fixture at shape "
                      f"{tuple(x.shape)}x{tuple(w.shape)}")
            i += 1
    print(f"fixture: {len(QM.list_backends())} backends x {i} shapes "
          "bitwise equal to the JAX package")

    # ragged, batched and real layer shapes: kernel == plain, bitwise
    shapes = {"ragged(1000,577,65)": (1, 1000, 577, 65),
              "ragged(3,1,1)": (1, 3, 1, 1),
              "batched(4,333,150,70)": (4, 333, 150, 70),
              **TC_SEAMS, **CUDA_CORE_SEAMS, **LAYERS, **SUITE_LAYERS,
              **SERVE_LAYERS, **VERIFY_LAYERS, **LM_SUITE_LAYERS,
              **SERVE_SUITE_LAYERS, **LM_ROUTE_LAYERS}
    errs = {r[:2]: 0.0 for r in ROWS}
    per_layer, timed = [], []
    wgen = torch.Generator(device=dev).manual_seed(0)
    for label, (bb, m, k, n) in shapes.items():
        train = label in TRAIN_LAYERS
        x, w, scale, bias = _operands(torch, gen, bb, m, k, n, dev,
                                      wgen if train else None)
        arch = label in LM_ROUTE_LAYERS
        reps = TRAIN_REPS if train else 5
        for name, var, _ in ROWS:
            if arch and (name, var) not in ARCH_VARIANTS:
                continue
            designs = (("proposed", "design13") if var == "rank1"
                       and label in TC_SEAMS else ("proposed",))
            relus = (False, True) if "fused" in name and not arch else \
                (False,)
            for relu in relus:
                for design in designs:
                    args = (K, name, var, x, w, scale, bias, relu)
                    got, kern_once = _timed_once(
                        torch, lambda: _call(*args, False, design))
                    want, plain_once = _timed_once(
                        torch, lambda: _call(*args, True, design))
                    err = _max_err(got, want)
                    errs[(name, var)] = max(errs[(name, var)], err)
                    check(got.dtype == want.dtype and torch.equal(got, want),
                          f"{name}[{var}] {design} relu={relu} differs from "
                          f"its plain version at {label}: max |diff| {err}")
            if label in TIMED_LAYERS:
                kern = functools.partial(_call, K, name, var, x, w, scale,
                                         bias, False, False)
                pms = plain_once if train else _ms(
                    torch, lambda: _call(K, name, var, x, w, scale, bias,
                                         False, True), 2)
                lib = operands_ms = None
                if var == "exact" and k % 8 == 0 and n % 8 == 0 \
                        and bb * m > 16:
                    x2 = x.reshape(-1, k)
                    ref = torch._int_mm(x2, w)
                    acc = K.fused_matmul(x2, w, torch.ones_like(scale),
                                         torch.zeros_like(bias),
                                         variant="exact")
                    check(torch.equal(acc, ref.float()),
                          f"fused_matmul[exact] differs from torch._int_mm "
                          f"at {label}")
                    kms, lib = _ms_turns(torch, kern,
                                         lambda: torch._int_mm(x2, w), 5)
                else:
                    kms = kern_once if train else _ms(torch, kern, 5)
                if var == "exact":
                    operands_ms = _ms(torch,
                                      lambda: K.exact_weight_operand(w), 5)
                elif var == "rank1":
                    build = functools.partial(_rank1_operands, K, w)
                    operands_ms = (_timed_once(torch, build)[1] if train
                                   else _ms(torch, build, 5))
                bound, by = _bound(name, var, bb * m, k, n, fac, ops)
                timed.append((kern, _launches_per_call(K, var, k, n), reps))
                per_layer.append({
                    "layer": label, "entry": name, "variant": var,
                    "shape": [bb, m, k, n], "kernel_ms": kms,
                    "plain_ms": pms, "library_ms": lib,
                    "operands_ms": operands_ms,
                    "bound_ms": bound, "bound_by": by,
                    **({"planes_ms": _planes_ms(k, n, fac),
                        "tiles": len(K.rank1_column_tiles(k, n))}
                       if var == "rank1" else {}),
                    **({"plan": dataclasses.asdict(K.plan(bb * m, k, n))}
                       if var in K.CUDA_CORE else {})})
        print(f"  {label}: every "
              + ("LM route (K2 deficit / stage1, K4) " if arch else "entry ")
              + "equals its plain version", flush=True)
        del x, w, scale, bias
        torch.cuda.empty_cache()       # the head's plain rank1 takes ~22 GB
    wrap_check(torch, K, dev)
    tiles_check(torch, K, dev, gen)
    data_rows, data_calls = table_data_calls(torch, K, gen)
    # one profiler session: later sessions in one process may see no
    # device events
    for row, ms in zip(per_layer + data_rows,
                       _device_ms(torch,
                                  timed + [(c, 1, 5) for c in data_calls])):
        row["device_ms"] = ms
    detail["table_data"] = data_rows
    for r in data_rows:
        print(f"  table lookups, {r['layer']} {r['data']}: device "
              f"{r['device_ms']:.4f} ms")
    detail["per_layer"] = per_layer
    for row in per_layer:
        print(f"  {row['layer']:12s} {row['entry']}[{row['variant']}] "
              f"kernel {row['kernel_ms']:.4f} ms  plain "
              f"{row['plain_ms']:.2f} ms  library {row['library_ms']}  "
              f"device {row['device_ms']:.4f} ms  "
              f"operands {row['operands_ms']}  "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
              + (f"  planes {row['planes_ms']:.4f} ms in "
                 f"{row['tiles']} tiles" if "planes_ms" in row else "")
              + (" plan {bm}x{bn}, k slice {k_slice}, {splits} splits"
                 .format(**row["plan"]) if "plan" in row else ""))

    rows = []
    for name, var, replaces in ROWS:
        t = next(r for r in per_layer if r["layer"] == TIMED_LAYER
                 and r["entry"] == name and r["variant"] == var)
        rows.append({
            "name": f"{name}[{var}]", "route": "cuda",
            "source": TC_SOURCE if var in TC_VARIANTS else CUDA_CORE_SOURCE,
            "replaces": replaces, "launches": None,
            "max_abs_err": errs[(name, var)], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"], "pairs_2e16_ok": pairs_ok[(name, var)],
            "device_ms": t["device_ms"],
            "verify_device_ms": {
                r["layer"]: r["device_ms"] for r in per_layer
                if r["layer"] in VERIFY_LAYERS and r["entry"] == name
                and r["variant"] == var},
            "train_device_ms": {
                r["layer"]: [r["device_ms"], r["bound_ms"]]
                for r in per_layer if r["layer"] in TRAIN_LAYERS
                and r["entry"] == name and r["variant"] == var},
            **({"operands_ms": t["operands_ms"]}
               if var in TC_VARIANTS else {}),
            "_entry": name, "_variant": var})
    return rows


def wrap_check(torch, K, dev):
    """K1 and K2 (with ReLU and without) of both CUDA-core functions equal
    their plain versions where the int32 sum passes 2^31 and K is split."""
    m, k, n = WRAP_SHAPE
    check(K.plan(m, k, n).splits > 1, f"no split at {WRAP_SHAPE}")
    x = torch.full((m, k), 127, dtype=torch.int8, device=dev)
    w = torch.full((k, n), 127, dtype=torch.int8, device=dev)
    scale = torch.full((1, n), 1e-3, device=dev)
    bias = torch.ones((1, n), device=dev)
    for var in K.CUDA_CORE:
        want = K.approx_matmul_plain(x, w, kernel=var)
        check(bool((want < 0).all()),
              f"{var}: the sum at {WRAP_SHAPE} does not pass 2^31")
        check(torch.equal(K.approx_matmul(x, w, kernel=var), want),
              f"approx_matmul[{var}] differs past 2^31")
        for relu in (False, True):
            check(torch.equal(
                K.fused_matmul(x, w, scale, bias, variant=var, relu=relu),
                K.fused_matmul_plain(x, w, scale, bias, variant=var,
                                     relu=relu)),
                f"fused_matmul[{var}] relu={relu} differs past 2^31")
    print(f"  wrap{WRAP_SHAPE}: sums past 2^31 through {K.plan(m, k, n).splits}"
          " K slices equal the plain versions")


def tiles_check(torch, K, dev, gen):
    """K3 and K4 launched in RANK1's column tiles under a small budget
    (TILED_LAYER: 24 tiles) equal their plain versions bit for bit."""
    label, budget = TILED_LAYER
    bb, m, k, n = SERVE_LAYERS[label]
    x, w, scale, bias = _operands(torch, gen, bb, m, k, n, dev)
    tiles = K.rank1_column_tiles(k, n, tile_bytes=budget)
    check(len(tiles) > 1, f"one tile at {label} under {budget} bytes")
    x2 = x.reshape(-1, k)
    check(torch.equal(K.rank1_matmul(x2, w, tile_bytes=budget),
                      K.rank1_matmul_plain(x2, w)),
          f"rank1_matmul in {len(tiles)} tiles differs at {label}")
    check(torch.equal(
        K.rank1_fused_matmul(x, w, scale, bias, tile_bytes=budget),
        K.rank1_fused_matmul_plain(x, w, scale, bias)),
        f"rank1_fused_matmul in {len(tiles)} tiles differs at {label}")
    print(f"  {label} in {len(tiles)} column tiles of {budget} bytes: K3 "
          "and K4 equal their plain versions")


TABLE_DATA_LAYERS = ("ffdnet.mid", "smollm.decode.q")


def table_data_calls(torch, K, gen) -> tuple:
    """Rows and calls for the device ms of K2[deficit] on three kinds of
    operands at each of TABLE_DATA_LAYERS: uniform in [-127, 127]
    (the phase's own), constant (x = w = 77: every lane of a warp reads
    one table word, so no lookup conflicts in the banks), and post-ReLU
    activations against centred weights (x = |N(0, 48)| on half the
    entries, 0 on the rest; w = N(0, 24); both rounded and clipped to
    127)."""
    dev = torch.device("cuda")
    calls, rows = [], []
    for layer in TABLE_DATA_LAYERS:
        bb, m, k, n = LAYERS.get(layer) or SERVE_LAYERS[layer]
        x, w, scale, bias = _operands(torch, gen, bb, m, k, n, dev)
        act = (torch.randn((bb, m, k), generator=gen) * 48).abs() * (
            torch.rand((bb, m, k), generator=gen) < 0.5)
        wgt = torch.randn((k, n), generator=gen) * 24
        data = {
            "uniform": (x, w),
            "constant": (torch.full_like(x, 77), torch.full_like(w, 77)),
            "relu_gauss": tuple(t.round().clamp(-127, 127).to(torch.int8)
                                .to(dev) for t in (act, wgt))}
        for kind, (xd, wd) in data.items():
            calls.append(functools.partial(K.fused_matmul, xd, wd, scale,
                                           bias))
            rows.append({"layer": layer, "data": kind})
    return rows, calls


# ---------------------------------------------------------------------------
# Forward times (phases 4-5)
# ---------------------------------------------------------------------------

def _forward_ms(torch, run, reps: int) -> list:
    """Host milliseconds of ``reps`` calls of ``run``, each ended by a
    synchronize."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _profile_ms(torch, run) -> dict:
    """One call of ``run`` under torch.profiler: its host ms (profiler on),
    the ms in which the card ran anything (kernels, copies, fills; the
    union of their spans), the ms of the port's kernels (approx_mm and
    tc_mm), and the count of device spans (every kernel, copy and fill)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = _device_spans(torch, prof)
    check(bool(spans), "torch.profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    for lo, hi, _ in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    ours = sum(hi - lo for lo, hi, name in spans if _ours(name))
    return {"wall_ms": wall, "device_busy_ms": busy / 1e6,
            "kernels_ms": ours / 1e6, "device_ops": len(spans)}


def _device_spans(torch, prof) -> list:
    """(start ns, end ns, name) of every device span (kernel, copy, fill)
    of a profile, sorted, read from the profiler's raw events:
    ``prof.events()`` builds a tree of every host and device event first,
    which takes seconds a step of some 10^4 device ops."""
    from torch.autograd import DeviceType
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA
                  and not e.is_user_annotation())


def _time_forward(torch, forward, label: str) -> dict:
    """FORWARD_REPS host-timed calls of ``forward`` and one profiled call;
    prints and returns their numbers."""
    ms = _forward_ms(torch, forward, FORWARD_REPS)
    prof = _profile_ms(torch, forward)
    med = statistics.median(ms)
    print(f"    {label}: median {med:.3f} ms, min {min(ms):.3f}, max "
          f"{max(ms):.3f} over {FORWARD_REPS}; profiled: card busy "
          f"{prof['device_busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms, "
          f"port kernels {prof['kernels_ms']:.3f} ms")
    return {"forward_ms": ms, "forward_ms_median": med, **prof}


# ---------------------------------------------------------------------------
# Phase 4: LeNet-5 through eval_classifier
# ---------------------------------------------------------------------------

def fixture_lenet5(dev):
    """The fixture's JAX-trained LeNet-5 weights on ``dev``."""
    from repro_torch.convert import params_from_jax
    tree: dict = {}
    with np.load(FIXTURE) as data:
        for key in data.files:
            if key.startswith("lenet5/"):
                _, layer, leaf = key.split("/")
                tree.setdefault(layer, {})[leaf] = data[key]
    return params_from_jax(tree, device=dev)


CUDA_BACKENDS = ("approx_deficit_pallas", "approx_stage1_pallas",
                 "approx_rank1_pallas")


def lenet5_phase(torch, detail):
    import dataclasses
    from repro_torch.data import synthetic
    from repro_torch.models import cnn as CNN
    from repro_torch.quant import matmul as QM
    from repro_torch.quant.quantize import QuantConfig
    from repro_torch.train import cnn_train as T

    with np.load(FIXTURE) as data:
        jax_ref = {k: data[k] for k in data.files
                   if k.startswith(("logits_", "acc_"))}
    params = fixture_lenet5("cuda")
    batch = torch.from_numpy(synthetic.digits(500, seed=1)[0][:50]).cuda()
    backends = ["bf16"] + list(QM.list_backends())
    logits, acc, times = {}, {}, {}
    for be in backends:
        q = QuantConfig(backend=be)
        lg, labels = T.classifier_logits(params, CNN.lenet5_apply, q)
        logits[be] = lg
        acc[be] = 100.0 * int((lg.argmax(-1) == labels).sum()) / 500
        check(bool(torch.isfinite(lg).all()) and lg.shape == (500, 10),
              f"{be}: bad logits")
        check(acc[be] == T.eval_classifier(params, CNN.lenet5_apply, q),
              f"{be}: eval_classifier disagrees with its logits")
        print(f"  lenet5 {be:22s} acc {acc[be]:.1f}%")

        def forward():
            with torch.inference_mode():
                CNN.lenet5_apply(params, batch, q)

        times[be] = _time_forward(torch, forward, "batch of 50")
    for be in CUDA_BACKENDS:
        oracle = QM.get_backend(be).oracle
        check(acc[be] == acc[oracle],
              f"{be} accuracy {acc[be]} != {oracle} {acc[oracle]}")
        q = dataclasses.replace(QuantConfig(backend=be), fuse_epilogue=False)
        unfused, _ = T.classifier_logits(params, CNN.lenet5_apply, q)
        check(torch.equal(unfused, logits[be]),
              f"{be}: unfused logits differ from fused")
    check(torch.equal(logits["approx_deficit_pallas"], logits["approx_lut"]),
          "approx_deficit_pallas logits differ from approx_lut")
    check(torch.equal(logits["approx_rank1_pallas"], logits["approx_lut"]),
          "approx_rank1_pallas logits differ from approx_lut")
    check(torch.equal(logits["approx_stage1_pallas"],
                      logits["approx_stage1"]),
          "approx_stage1_pallas logits differ from approx_stage1")
    for be in ("int8_exact", "approx_lut", "approx_stage1"):
        want = jax_ref[f"logits_{be}"]
        err = float(np.abs(logits[be][:50].cpu().numpy() - want).max())
        bound = LOGIT_RTOL * float(np.abs(want).max())
        check(err <= bound, f"{be}: logits differ from JAX by {err} > "
                            f"{bound}")
        check(acc[be] == float(jax_ref[f"acc_{be}"]),
              f"{be}: accuracy {acc[be]} != JAX {jax_ref[f'acc_{be}']}")
        print(f"  {be}: max |logit - JAX| {err:.3g} (bound {bound:.3g}), "
              f"accuracy equals JAX's {acc[be]:.1f}%")
    print("  CUDA backends: accuracy equals the oracle's; logits bitwise "
          "equal to the oracle's; unfused (K1, K3) == fused (K2, K4)")
    # the Keras CNN (random weights from a seed): its fc1 contracts over
    # K = 3,136, more than one x slab of the tensor-core kernel
    from repro_torch.nn.module import init_params
    keras = init_params(CNN.keras_cnn_descs(),
                        torch.Generator().manual_seed(0), device="cuda")
    with torch.inference_mode():
        for be in CUDA_BACKENDS:
            q = QuantConfig(backend=be)
            got = CNN.keras_cnn_apply(keras, batch, q)
            want = CNN.keras_cnn_apply(
                keras, batch, QuantConfig(backend=QM.get_backend(be).oracle))
            check(got.shape == (50, 10) and torch.equal(got, want),
                  f"{be}: Keras CNN logits differ from its oracle's")
    print("  Keras CNN, batch of 50: every CUDA backend's logits bitwise "
          "equal to its oracle's")
    detail["lenet5_acc"] = acc
    detail["lenet5_forward"] = times


def per_forward_launches(torch, K) -> dict:
    """Kernel launches of one forward (a LeNet-5 batch of 50, an FFDNet
    batch of 16), per CUDA backend, fused and unfused; read after the main
    path's counts."""
    import dataclasses
    from repro_torch.models import cnn as CNN
    from repro_torch.nn.module import init_params
    from repro_torch.quant.quantize import QuantConfig

    gen = torch.Generator().manual_seed(0)
    lenet = init_params(CNN.lenet5_descs(), gen, device="cuda")
    ffd = init_params(CNN.ffdnet_descs(), gen, device="cuda")
    digits = torch.rand((50, 28, 28, 1), generator=gen).cuda()
    noisy = torch.rand((16, 64, 64, 1), generator=gen).cuda()
    out = {}
    for be in CUDA_BACKENDS:
        for fuse in (True, False):
            q = dataclasses.replace(QuantConfig(backend=be),
                                    fuse_epilogue=fuse)
            for model, run in (
                    ("lenet5", lambda: CNN.lenet5_apply(lenet, digits, q)),
                    ("ffdnet", lambda: CNN.ffdnet_apply(ffd, noisy, 0.1,
                                                        quant=q))):
                K.reset_launch_counts()
                with torch.inference_mode():
                    run()
                n = _launches(K)
                out[f"{model}/{be}/{'fused' if fuse else 'unfused'}"] = n
    return out


# ---------------------------------------------------------------------------
# Phase 5: full-width FFDNet through eval_denoiser
# ---------------------------------------------------------------------------

def ffdnet_phase(torch, detail):
    import dataclasses
    from repro_torch.eval import image as IQ
    from repro_torch.models import cnn as CNN
    from repro_torch.nn.module import init_params
    from repro_torch.quant import matmul as QM
    from repro_torch.quant.quantize import QuantConfig
    from repro_torch.train import cnn_train as T

    cfg = CNN.FFDNetConfig()
    check((cfg.depth, cfg.width, cfg.channels) == (8, 64, 1),
          f"unexpected FFDNet config {cfg}")
    params = init_params(CNN.ffdnet_descs(cfg),
                         torch.Generator().manual_seed(0), device="cuda")
    sigma = 25.0
    outs, rows = {}, {}
    for be in ("approx_lut", "approx_stage1") + CUDA_BACKENDS:
        q = QuantConfig(backend=be)
        clean, noisy, out = T.denoise(params, cfg, q, sigma=sigma)
        check(out.shape == (16, 64, 64, 1) and bool(torch.isfinite(out)
                                                     .all()),
              f"{be}: bad denoiser output")
        outs[be] = out
        p, s, pn = T.eval_denoiser(params, cfg, q, sigma=sigma)
        check(p == float(IQ.psnr(out, clean)), f"{be}: eval_denoiser "
                                               "disagrees with its output")

        def forward():
            with torch.inference_mode():
                CNN.ffdnet_apply(params, noisy, sigma / 255.0, cfg, q)

        print(f"  ffdnet {be:22s} PSNR {p:.3f} dB  SSIM {s:.4f}  "
              f"(noisy {pn:.3f} dB)")
        rows[be] = {"psnr": p, "ssim": s, "noisy_psnr": pn,
                    **_time_forward(torch, forward, "forward of 16")}
    for be in CUDA_BACKENDS:
        oracle = QM.get_backend(be).oracle
        check(torch.equal(outs[be], outs[oracle]),
              f"{be}: FFDNet output differs from {oracle}")
        q = dataclasses.replace(QuantConfig(backend=be), fuse_epilogue=False)
        _, _, unfused = T.denoise(params, cfg, q, sigma=sigma)
        check(torch.equal(unfused, outs[be]),
              f"{be}: unfused FFDNet output differs from fused")
    print("  CUDA backends: FFDNet outputs bitwise equal to their oracle's, "
          "fused and unfused")
    detail["ffdnet"] = rows


# ---------------------------------------------------------------------------
# Phase 6: the paper's result suites, with QAT training on the card
# ---------------------------------------------------------------------------

SUITE_RUNS = ("metrics", "hw", "mnist", "denoise", "lm", "serve")
TASK_KEYS = {"mnist": ("acc",), "denoise": ("psnr", "ssim", "noisy_psnr")}
MSR_CORES = ("msr4", "drum6", "posneg")
TIMED_STEPS = 40        # train_step calls per timing turn
WARM_STEPS = 5          # first steps of a run left out of its median


def _sync(torch, dev: str):
    if dev == "cuda":
        torch.cuda.synchronize()


def _stamp(torch, dev: str):
    """A CUDA event recorded now on the card, else the host clock."""
    if dev == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _gaps_ms(torch, dev: str, stamps) -> list:
    """Milliseconds between successive ``_stamp``s."""
    if dev == "cuda":
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])]
    return [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]


class SuiteRecorder:
    """For the length of a ``with``, wraps the functions of
    repro_torch.train.cnn_train that the suite runners call: each ``fit``
    records its losses and the milliseconds between the batches its loop
    draws (on the card the gaps between CUDA events recorded at each draw,
    so device time with the host's gaps; on the CPU the host clock), and
    each eval call its seconds under its sweep label and its arguments."""

    NAMES = ("fit", "eval_classifier", "eval_denoiser")

    def __init__(self, torch, T, dev: str):
        self.torch, self.T, self.dev = torch, T, dev
        self.fits, self.evals, self.calls = [], {}, []

    def __enter__(self):
        self.saved = {n: getattr(self.T, n) for n in self.NAMES}
        self.T.fit = self._fit
        self.T.eval_classifier = self._timed("eval_classifier")
        self.T.eval_denoiser = self._timed("eval_denoiser")
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.T, n, fn)
        return False

    def _fit(self, descs, loss_fn, batches, **kw):
        stamps = []

        def drawn():
            for batch in batches:
                stamps.append(_stamp(self.torch, self.dev))
                yield batch

        params, losses = self.saved["fit"](descs, loss_fn, drawn(), **kw)
        stamps.append(_stamp(self.torch, self.dev))
        self.fits.append({"losses": losses,
                          "step_ms": _gaps_ms(self.torch, self.dev,
                                              stamps)})
        return params, losses

    def _timed(self, name):
        def run(params, model, quant, **kw):
            _sync(self.torch, self.dev)
            t0 = time.perf_counter()
            out = self.saved[name](params, model, quant, **kw)
            _sync(self.torch, self.dev)
            label = (quant.backend if quant.multiplier == "proposed" else
                     f"{quant.backend}[{quant.multiplier}]")
            if "sigma" in kw:
                label += f" sigma={kw['sigma']:g}"
            self.evals[label] = time.perf_counter() - t0
            self.calls.append((params, model, quant, kw))
            return out
        return run


def check_sweep_rows(name: str, rows: list, QM):
    """Every row finite; every *_pallas row equal to its oracle's row and
    every MSR core row to its *_lut row, in the task columns; bf16
    LeNet-5 at 90 % or more."""
    keys = TASK_KEYS[name]
    sigmas = sorted({r.get("sigma") for r in rows}, key=str)
    check(len(rows) == 18 * len(sigmas), f"{name}: {len(rows)} rows")
    for r in rows:
        check(all(np.isfinite(r[k]) for k in keys), f"{name}: bad row {r}")
    by = {(r["backend"], r.get("sigma")): r for r in rows}
    pairs = [(be, QM.get_backend(be).oracle) for be in QM.list_backends()
             if be.endswith("_pallas") or be in MSR_CORES]
    check(len(pairs) == 6, f"{name}: {len(pairs)} backends with an oracle")
    for be, oracle in pairs:
        for sig in sigmas:
            got = [by[(be, sig)][k] for k in keys]
            want = [by[(oracle, sig)][k] for k in keys]
            check(got == want, f"{name}: {be} row {got} != {oracle} "
                               f"row {want} (sigma {sig})")
    if name == "mnist":
        check(by[("bf16", None)]["acc"] >= 90.0,
              f"bf16 LeNet-5 accuracy {by[('bf16', None)]['acc']} < 90 %")


# the columns of the LM suites that each *_pallas row shares with its
# oracle's row
LM_SUITE_KEYS = {"lm": ("ppl", "d_ppl", "logit_nmed"),
                 "serve": ("requests", "new_tokens", "hit_rate",
                           "solo_match", "match_bf16", "prefix_bf16",
                           "spec_match", "spec_accept")}


def check_lm_suite_rows(name: str, art: dict, QM):
    """The lm and serve artifacts: 18 finite rows; every *_pallas row equal
    to its oracle's in LM_SUITE_KEYS; serve: every row's solo and spec
    checks true; lm: the QAT loss finite and below a uniform guess's.
    The lm rows are the port's own training (not gated against
    experiments/eval/lm.json: the two stacks' init RNGs differ)."""
    (rows,) = art["tables"].values()
    keys = LM_SUITE_KEYS[name]
    check(len(rows) == 18, f"{name}: {len(rows)} rows")
    by = {r["backend"]: r for r in rows}
    for r in rows:
        check(all(np.isfinite(float(r[k])) for k in keys),
              f"{name}: bad row {r}")
        if name == "serve":
            check(r["solo_match"] and r["spec_match"],
                  f"serve: {r['backend']} solo/spec check failed: {r}")
    for be in QM.list_backends():
        if be.endswith("_pallas"):
            oracle = QM.get_backend(be).oracle
            got = [by[be][k] for k in keys]
            want = [by[oracle][k] for k in keys]
            check(got == want, f"{name}: {be} row {got} != {oracle} row "
                               f"{want}")
    if name == "lm":
        loss = art["config"]["train_loss"]
        check(np.isfinite(loss) and loss < np.log(art["config"]["vocab"]),
              f"lm: QAT training loss {loss}")
        print(f"  lm: QAT train loss {loss}, bf16 ppl {by['bf16']['ppl']}, "
              f"design13 d_ppl {by['approx_lut[design13]']['d_ppl']}")
    else:
        print("  serve: every row solo == batched and spec == sequential; "
              "accepted drafts/pass " + ", ".join(
                  f"{r['backend']} {r['spec_accept']}" for r in rows[:10]))
    print(f"  {name}: every *_pallas row equals its oracle's")


def check_suite_outputs(torch, name: str, rec: SuiteRecorder, QM) -> int:
    """Replays each of the suite's eval calls under a CUDA backend, with
    the trained weights and the suite's own data and sizes, and under the
    backend's oracle: the logits (mnist) or the unclipped FFDNet output
    (denoise) must be equal bit for bit. Returns the calls compared."""
    import dataclasses
    from repro_torch.models import cnn as CNN
    T = rec.T

    def raw(params, model, quant, kw):
        if name == "mnist":
            return T.classifier_logits(params, model, quant, **kw)[0]
        _, noisy, _ = T.denoise(params, model, quant, **kw)
        with torch.inference_mode():
            return CNN.ffdnet_apply(params, noisy, kw["sigma"] / 255.0,
                                    model, quant)

    n = 0
    for params, model, quant, kw in rec.calls:
        if quant.backend not in CUDA_BACKENDS:
            continue
        oracle = dataclasses.replace(
            quant, backend=QM.get_backend(quant.backend).oracle)
        got, want = raw(params, model, quant, kw), raw(params, model,
                                                      oracle, kw)
        check(got.shape == want.shape and torch.equal(got, want),
              f"{name}: {quant.backend} output differs from "
              f"{oracle.backend}'s at {kw}")
        n += 1
    want_n = len(CUDA_BACKENDS) * (2 if name == "denoise" else 1)
    check(n == want_n, f"{name}: {n} CUDA backend evals, expected {want_n}")
    return n


@contextlib.contextmanager
def cudnn_free(T, torch):
    """Inside, ``T.train_step`` runs under its training numerics with
    cuDNN free to pick its algorithms (deterministic off)."""
    numerics = T.training_numerics

    @contextlib.contextmanager
    def free():
        with numerics():
            torch.backends.cudnn.deterministic = False
            yield

    T.training_numerics = free
    try:
        yield
    finally:
        T.training_numerics = numerics


def _step_ms(torch, dev, step, reps: int) -> list:
    """Host milliseconds of ``reps`` calls of ``step``, each ended by a
    synchronize on the card."""
    out = []
    for _ in range(reps):
        _sync(torch, dev)
        t0 = time.perf_counter()
        step()
        _sync(torch, dev)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def training_checks(torch, detail, dev: str, smoke: bool) -> dict:
    """One LeNet-5 train_step through the deficit kernel (STE, qat=False)
    against the same step under approx_lut, bitwise; then the QAT
    train_step of each suite's model at its batch: ms per step with
    cuDNN deterministic and not (in turns: on, off, off, on), and one
    profiled step's device busy time."""
    import warnings
    from repro_torch.data import synthetic
    from repro_torch.models import cnn as CNN
    from repro_torch.nn.module import init_params
    from repro_torch.optim import adamw as A
    from repro_torch.quant.quantize import BF16, QuantConfig
    from repro_torch.train import cnn_train as T

    imgs, labels = synthetic.digits(64, seed=0)
    lenet_batch = (torch.from_numpy(imgs).to(dev),
                   torch.from_numpy(labels).to(dev))
    params = fixture_lenet5(dev)
    ocfg = A.AdamWConfig(lr=2e-3, weight_decay=0.0)
    got = {}
    # cuDNN runs nothing on this path (im2col + the quantized matmul);
    # deterministic algorithms fix the order of im2col's backward sums
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for be in ("approx_deficit_pallas", "approx_lut"):
                loss_fn = T.classifier_loss(CNN.lenet5_apply,
                                            QuantConfig(backend=be))
                with T.training_numerics():
                    loss, grads = T.value_and_grad(loss_fn, params,
                                                   *lenet_batch)
                new_p, _, _ = T.train_step(params, A.init(params, ocfg),
                                           lenet_batch, loss_fn, ocfg)
                got[be] = [loss] + [t for _, t in A.flatten(grads)
                                    + A.flatten(new_p)]
        finally:
            torch.use_deterministic_algorithms(False)
    check(all(torch.equal(a, b) for a, b in
              zip(got["approx_deficit_pallas"], got["approx_lut"])),
          "train_step through the deficit kernel differs from approx_lut")
    print("  STE train_step through the deficit kernel: loss, gradients "
          "and updated weights bitwise equal to approx_lut's")

    cfg = (CNN.FFDNetConfig(depth=3, width=8) if smoke
           else CNN.FFDNetConfig(depth=6, width=32))
    size = 32 if smoke else 64
    clean = synthetic.textures(16, size=size, seed=0)
    ffd_batch = tuple(torch.from_numpy(b).to(dev) for b in next(
        T.denoiser_batches(clean, batch=8, sigmas=(15., 25., 50.), seed=0)))
    models = {
        "lenet5 (batch 64)": (CNN.lenet5_descs(), T.classifier_loss(
            CNN.lenet5_apply, BF16, qat=True), lenet_batch, 2e-3),
        f"ffdnet d{cfg.depth} w{cfg.width} (batch 8, {size}x{size})": (
            CNN.ffdnet_descs(cfg), T.denoiser_loss(cfg, BF16, qat=True),
            ffd_batch, 1e-3)}
    gen = torch.Generator().manual_seed(0)
    out = {"ste_kernel_step_equals_oracle": True}
    for label, (descs, loss_fn, batch, lr) in models.items():
        ocfg = A.AdamWConfig(lr=lr, weight_decay=0.0)
        params = init_params(descs, gen, dev)
        state = {"p": params, "o": A.init(params, ocfg)}

        def step(det=True):
            with contextlib.nullcontext() if det else cudnn_free(T, torch):
                state["p"], state["o"], _ = T.train_step(
                    state["p"], state["o"], batch, loss_fn, ocfg)

        ms = {True: [], False: []}
        for det in (True, False, False, True):
            ms[det] += _step_ms(torch, dev, lambda: step(det),
                                TIMED_STEPS)[WARM_STEPS:]
        row = {"ms_deterministic": statistics.median(ms[True]),
               "ms_nondeterministic": statistics.median(ms[False])}
        detail[f"train_step_ms {label}"] = {"deterministic": ms[True],
                                            "nondeterministic": ms[False]}
        if dev == "cuda":
            prof = _profile_ms(torch, step)
            row.update(prof)
            row["idle_share"] = 1 - prof["device_busy_ms"] / \
                row["ms_deterministic"]
        out[label] = row
        print(f"  train_step {label}: {row['ms_deterministic']:.3f} ms "
              f"(cuDNN deterministic), {row['ms_nondeterministic']:.3f} ms "
              f"(not); profiled: " + (
                  f"card busy {row['device_busy_ms']:.3f} ms of "
                  f"{row['wall_ms']:.3f} ms, idle share "
                  f"{row['idle_share']:.2f}" if dev == "cuda" else "n/a"))
    return out


def suites_phase(torch, detail, dev: str, smoke: bool) -> dict:
    """Run the four suites through the runners on ``dev``, check them, and
    write their artifacts to build/torch_eval/. Returns the suites line and
    the kernel launches of the runners' calls (counts set to 0 before each
    and read after it, so the checks' launches are left out)."""
    from repro_torch.eval import artifacts
    from repro_torch.eval import runners as R
    from repro_torch.kernels import approx_matmul as K
    from repro_torch.quant import matmul as QM
    from repro_torch.train import cnn_train as T

    EVAL_OUT.mkdir(parents=True, exist_ok=True)
    out = {}
    launches = {key: 0 for key in launch_counts(K)}
    for name in SUITE_RUNS:
        rec = SuiteRecorder(torch, T, dev)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with rec:
            art = R.SUITES[name].run(smoke=smoke, seed=0, device=dev)
        wall = time.perf_counter() - t0
        for key, n in launch_counts(K).items():
            launches[key] += n
        artifacts.save(EVAL_OUT / f"{name}.json", art)
        (EVAL_OUT / f"{name}.md").write_text(R.render_artifact(art))
        entry = {"wall_s": wall, "config": art["config"],
                 "tables": art["tables"]}
        if name in TASK_KEYS:
            (table,) = art["tables"].values()
            check_sweep_rows(name, table, QM)
            check(len(rec.fits) == 1, f"{name}: {len(rec.fits)} fits")
            losses = rec.fits[0]["losses"]
            first = statistics.mean(losses[:10])
            last = statistics.mean(losses[-10:])
            check(last < 0.5 * first, f"{name}: training loss {first:.4g} "
                                      f"-> {last:.4g} did not halve")
            n = check_suite_outputs(torch, name, rec, QM)
            print(f"  {name}: {n} CUDA backend evals replayed, outputs "
                  "bitwise equal to their oracle's")
            step_ms = rec.fits[0]["step_ms"]
            slowest = sorted(rec.evals.items(), key=lambda kv: -kv[1])[:3]
            entry.update({
                "steps": len(losses), "loss_first10": first,
                "loss_last10": last,
                "ms_per_step": statistics.median(step_ms[WARM_STEPS:]),
                "eval_s": sum(rec.evals.values()),
                "slowest_points_s": dict(slowest)})
            detail[f"suite_{name}_points_s"] = rec.evals
            detail[f"suite_{name}_step_ms"] = step_ms
            detail[f"suite_{name}_losses"] = losses
            print(f"  {name}: {len(losses)} QAT steps, loss {first:.4g} -> "
                  f"{last:.4g}, {entry['ms_per_step']:.3f} ms per step; "
                  f"sweep {entry['eval_s']:.1f} s, slowest "
                  + ", ".join(f"{k} {v:.2f} s" for k, v in slowest))
        elif name in LM_SUITE_KEYS:
            check_lm_suite_rows(name, art, QM)
        else:
            committed = json.loads(
                (COMMITTED_EVAL / f"{name}.json").read_text())
            check(art["tables"] == committed["tables"],
                  f"{name}: tables differ from experiments/eval/{name}.json")
            print(f"  {name}: tables equal experiments/eval/{name}.json")
        print(f"  {name}: {wall:.1f} s -> {EVAL_OUT / name}.json")
        out[name] = entry
    out["training"] = training_checks(torch, detail, dev, smoke)
    print("  every *_pallas row equals its oracle's and every MSR core row "
          "its *_lut row, in both task suites")
    return out, launches


# ---------------------------------------------------------------------------
# Phase 7: serving smollm-135m at full width
# ---------------------------------------------------------------------------

SERVE_ORACLES = ("bf16", "int8_exact", "approx_lut", "approx_stage1")
SERVE_KERNEL = {"approx_deficit_pallas": "deficit",   # the body each CUDA
                "approx_stage1_pallas": "stage1",     # backend's fused
                "approx_rank1_pallas": "rank1"}       # route launches
SERVE_UNFUSED = "approx_stage1_pallas"
SHARED_PREFIX = 8        # one full page at the engine's page_size 8
PROJECTIONS_PER_LAYER = 7   # q, k, v, o, gate, up, down
SERVE_REPS = 2           # the workload served this many times per backend
SERVE_DEPTH = 15         # smollm-135m's layers served in phases 7-8 (of 30)
STEP_REPS = 20           # timed calls of a fixed-shape decode step


def serve_workload(vocab: int, smoke: bool, seed: int):
    """The JAX package's serve-suite workload (src/repro/eval/serve.py,
    ``workload``): mixed prompt lengths and budgets behind a shared system
    prefix, more requests than slots, so that the last request is admitted
    mid-decode on a prefix-cache hit. Returns (requests, slots, max_len)
    with requests = [(rid, prompt, max_new), ...]."""
    rng = np.random.default_rng(seed + 11)
    if smoke:
        n_req, slots, max_len = 4, 3, 48
        lens, news = rng.integers(2, 9, n_req), rng.integers(3, 7, n_req)
    else:
        n_req, slots, max_len = 8, 4, 112
        lens, news = rng.integers(4, 25, n_req), rng.integers(8, 17, n_req)
    shared = rng.integers(0, vocab, SHARED_PREFIX).astype(np.int32)
    reqs = [(rid,
             np.concatenate([shared, rng.integers(0, vocab, int(lens[rid]))
                             .astype(np.int32)]),
             int(news[rid])) for rid in range(n_req)]
    return reqs, slots, max_len


class ServeRecorder:
    """For the length of a ``with``: records every logits row the serving
    engine samples from, keyed by (rid, step), and the host milliseconds of
    each decode step of ``engine`` (synchronized before and after)."""

    def __init__(self, torch, PE, engine, dev: str):
        self.torch, self.PE, self.engine, self.dev = torch, PE, engine, dev
        self.rows, self.step_ms = {}, []

    def __enter__(self):
        self.sample = self.PE.sample_token
        self.decode = decode = self.engine._decode

        def record(logits, scfg, rid, step):
            self.rows[(rid, step)] = np.array(logits, np.float32)
            return self.sample(logits, scfg, rid, step)

        def timed(*args):
            _sync(self.torch, self.dev)
            t0 = time.perf_counter()
            out = decode(*args)
            _sync(self.torch, self.dev)
            self.step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        self.PE.sample_token = record
        self.engine._decode = timed
        return self

    def __exit__(self, *exc):
        self.PE.sample_token = self.sample
        self.engine._decode = self.decode
        return False


def _serve_shapes(cfg) -> list:
    """(K, N) of every projection launch of one forward, in order: the
    attention's (GQA q, k, v, o; MLA wq, wdkv, wo), the dense MLP's (gate,
    up, down; a mixture-of-experts layer's products are float), and the
    head; RWKV6's time mix (r, k, v, g, o) and channel mix (k, v, r);
    hymba's attention, Mamba (in, x, out) and MLP."""
    d, f, kvd = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.dh
    qd = cfg.n_heads * cfg.dh
    if cfg.ssm == "rwkv6":
        layer = [(d, d)] * 5 + [(d, f), (f, d), (d, d)]
        return layer * cfg.n_layers + [(d, cfg.padded_vocab)]
    if cfg.ssm == "hymba":
        mc = cfg.mamba_cfg()
        layer = [(d, qd), (d, kvd), (d, kvd), (qd, d),
                 (d, 2 * mc.d_inner),
                 (mc.d_inner, mc.dt_rank + 2 * mc.n_state), (mc.d_inner, d),
                 (d, f), (d, f), (f, d)]
        return layer * cfg.n_layers + [(d, cfg.padded_vocab)]
    if cfg.kv_lora:
        layer = [(d, cfg.n_heads * (cfg.qk_nope + cfg.qk_rope)),
                 (d, cfg.kv_lora + cfg.qk_rope),
                 (cfg.n_heads * cfg.v_head_dim, d)]
    else:
        layer = [(d, qd), (d, kvd), (d, kvd), (qd, d)]
    if not cfg.n_experts:
        layer += [(d, f), (d, f), (f, d)]
    return layer * cfg.n_layers + [(d, cfg.padded_vocab)]


def _step_launches(K, cfg, variant: str) -> int:
    """Kernel launches of one decode step under ``variant``."""
    return sum(_launches_per_call(K, variant, k, n)
               for k, n in _serve_shapes(cfg))


def _serve_bound_ms(cfg, rows: int, variant: str, ops, fac) -> float:
    """Least time of one forward's kernel launches at ``rows`` rows each:
    the sum of each launch's bound (the launches run one after another)."""
    name = "rank1_fused_matmul" if variant == "rank1" else "fused_matmul"
    return sum(_bound(name, variant, rows, k, n, fac, ops)[0]
               for k, n in _serve_shapes(cfg))


def serve_phase(torch, detail, dev: str, full: bool, ops=None) -> tuple:
    """Serve the workload under each backend on ``dev`` and check it (see
    the module docstring, phase 7). ``full`` is the card's run at
    smollm-135m's published width; without it a 2-layer, 64-wide smollm
    on the serve suite's smoke workload (the CPU rehearsal). Returns the
    serve line, the kernel launches of the served runs (counts set to 0
    before each run and read after it), and what the spec phase starts
    from: the config, params, workload, and each backend's tokens and ms
    per decoded token."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.core import factor as F
    from repro_torch.kernels import approx_matmul as K
    from repro_torch.models import transformer_lm as TLM
    from repro_torch.nn.module import n_params
    from repro_torch.quant import matmul as QM
    from repro_torch.quant.quantize import for_lm, quantize_dynamic
    from repro_torch.serve import engine as PE

    if full:
        cfg0 = registry.get("smollm-135m")
        check((cfg0.n_layers, cfg0.d_model, cfg0.n_heads, cfg0.n_kv_heads,
               cfg0.d_ff, cfg0.vocab, cfg0.param_dtype) ==
              (30, 576, 9, 3, 1536, 49152, torch.bfloat16)
              and n_params(TLM.descs(cfg0)) == 134_515_008,
              f"unexpected smollm-135m config {cfg0}")
        cfg0 = dataclasses.replace(cfg0, n_layers=SERVE_DEPTH)
    else:
        cfg0 = registry.reduced("smollm-135m", n_layers=2, d_model=64,
                                n_heads=4, n_kv_heads=2, d_ff=128, vocab=64,
                                vocab_pad=64, head_dim=16,
                                param_dtype=torch.bfloat16)
    params = TLM.init(cfg0, torch.Generator().manual_seed(0), device=dev)
    reqs, slots, max_len = serve_workload(cfg0.vocab, smoke=not full, seed=0)
    probe = reqs[-1]
    launches = {key: 0 for key in launch_counts(K)}

    def engine(cfg):
        return PE.Engine(cfg, params, slots=slots, max_len=max_len,
                         device=dev)

    def served(cfg):
        eng = engine(cfg)
        with torch.no_grad():          # warm the backend's tables
            c = TLM.init_cache(cfg, 1, 16, torch.float32, dev)
            _, c = TLM.prefill(params, torch.zeros((1, 8), dtype=torch.int64,
                                                   device=dev), cfg, c)
            TLM.decode_step(params, torch.zeros((1, 1), dtype=torch.int64,
                                                device=dev), 8, cfg, c)
        for rid, prompt, max_new in reqs:
            eng.submit(PE.ServeRequest(rid=rid, prompt=prompt,
                                       max_new=max_new))
        K.reset_launch_counts()
        with ServeRecorder(torch, PE, eng, dev) as rec:
            stats = eng.run()
        for key, n in launch_counts(K).items():
            launches[key] += n
        toks = {r.rid: list(r.output) for r in eng.completed}
        return eng, toks, rec, stats

    fac = F.factorize("proposed")
    runs, out = {}, {}
    for be in SERVE_ORACLES + CUDA_BACKENDS:
        cfg = dataclasses.replace(cfg0, quant=for_lm(be))
        reps = []
        for rep in range(SERVE_REPS):
            eng, toks, rec, stats = served(cfg)
            check(len(toks) == len(reqs) and all(toks.values()),
                  f"{be}: not every request was served")
            check(all(np.isfinite(r).all() and r.shape == (cfg0.padded_vocab,)
                      for r in rec.rows.values()), f"{be}: bad logits rows")
            check(stats["prefix_hit_rate"] > 0, f"{be}: no prefix-cache hit")
            check(stats["waves"] >= 2, f"{be}: no mid-decode admission")
            if rep == 0:
                runs[be] = (toks, rec.rows)
            check(toks == runs[be][0],
                  f"{be}: the workload served again gave other tokens")
            reps.append({
                "decode_step_ms_median": statistics.median(rec.step_ms),
                "ms_per_token": sum(rec.step_ms) / (
                    stats["new_tokens"] - len(reqs)),
                "decode_steps": stats["decode_steps"],
                "ttft_ms_mean": stats["ttft_ms_mean"],
                "ttft_ms_max": stats["ttft_ms_max"],
                "tok_per_s": stats["tok_per_s"],
                "new_tokens": stats["new_tokens"],
                "elapsed_s": stats["elapsed_s"]})
            detail[f"serve_step_ms {be} rep {rep}"] = rec.step_ms
        row = {"reps": reps, "prefix_hit_rate": stats["prefix_hit_rate"]}
        if dev == "cuda":
            tok = torch.arange(1, slots + 1, device=dev)[:, None]
            pos = torch.arange(slots, device=dev) * 10 + 40

            def step():
                with torch.no_grad():
                    eng._decode(params, eng.pool, tok, pos)

            step()
            fixed = _forward_ms(torch, step, STEP_REPS)
            q1, _, q3 = statistics.quantiles(fixed, n=4)
            row["fixed_step_ms"] = {"median": statistics.median(fixed),
                                    "q1": q1, "q3": q3, "n": STEP_REPS}
            detail[f"serve_fixed_step_ms {be}"] = fixed
            prof = _profile_ms(torch, step)
            row.update(prof)
            row["idle_share"] = 1 - prof["device_busy_ms"] / row[
                "fixed_step_ms"]["median"]
            if be in CUDA_BACKENDS:
                row["step_bound_ms"] = _serve_bound_ms(
                    cfg0, slots, SERVE_KERNEL[be], ops, fac)
                if SERVE_KERNEL[be] == "rank1":
                    row["step_planes_ms"] = sum(
                        _planes_ms(k, n, fac) for k, n in _serve_shapes(cfg0))
                K.reset_launch_counts()
                step()
                n = sum(getattr(K, name).launches for name in
                        ("approx_matmul", "fused_matmul", "rank1_matmul",
                         "rank1_fused_matmul"))
                check(n == PROJECTIONS_PER_LAYER * cfg0.n_layers + 1,
                      f"{be}: {n} kernel launches in one decode step")
                row["launches_per_step"] = n
        out[be] = row
        print(f"  serve {be:22s} served {SERVE_REPS}x: decode step median "
              + " / ".join(f"{r['decode_step_ms_median']:.3f}" for r in reps)
              + f" ms (of {len(rec.step_ms)}), TTFT mean "
              + " / ".join(f"{r['ttft_ms_mean']:.1f}" for r in reps)
              + " ms, " + " / ".join(f"{r['tok_per_s']:.2f}" for r in reps)
              + " tok/s"
              + (f"; fixed step {row['fixed_step_ms']['median']:.3f} ms "
                 f"({row['fixed_step_ms']['q1']:.3f}-"
                 f"{row['fixed_step_ms']['q3']:.3f}, {STEP_REPS} calls), "
                 f"profiled: busy {row['device_busy_ms']:.3f} ms, "
                 f"port kernels {row['kernels_ms']:.3f} ms, idle share "
                 f"{row['idle_share']:.2f}" if dev == "cuda" else "")
              + (f", bound {row['step_bound_ms']:.3f} ms"
                 if "step_bound_ms" in row else "")
              + (f" (+ planes {row['step_planes_ms']:.3f} ms)"
                 if "step_planes_ms" in row else ""), flush=True)
        # the probe, alone on a cold engine of the same pool shape
        if be in CUDA_BACKENDS:
            solo = engine(cfg)
            solo.submit(PE.ServeRequest(rid=probe[0], prompt=probe[1],
                                        max_new=probe[2]))
            K.reset_launch_counts()
            solo.run()
            for key, n in launch_counts(K).items():
                launches[key] += n
            check(list(solo.completed[0].output) == toks[probe[0]],
                  f"{be}: the probe served alone differs from batched")
            row["solo_match"] = True
        del eng

    tokens = {be: runs[be][0] for be in SPEC_BACKENDS}
    for be in CUDA_BACKENDS:
        out[be]["oracle_bitwise_rows"] = _bitwise_runs(
            "serve", runs, be, QM.get_backend(be).oracle)
    print("  CUDA backends: served tokens and every sampled logits row "
          "bitwise equal to the oracle's; probe alone == batched")
    cfg = dataclasses.replace(cfg0, quant=dataclasses.replace(
        for_lm(SERVE_UNFUSED), fuse_epilogue=False))
    _, toks, rec, _ = served(cfg)
    check(toks == runs[SERVE_UNFUSED][0] and all(
        np.array_equal(r, runs[SERVE_UNFUSED][1][k])
        for k, r in rec.rows.items()),
        f"{SERVE_UNFUSED} unfused (K1) differs from fused")
    print(f"  {SERVE_UNFUSED} unfused (K1): tokens and logits bitwise equal "
          "to the fused run")
    out["config"] = {"arch": cfg0.name, "n_layers": cfg0.n_layers,
                     "d_model": cfg0.d_model, "vocab": cfg0.vocab,
                     "params": n_params(TLM.descs(cfg0)),
                     "param_dtype": str(cfg0.param_dtype), "slots": slots,
                     "max_len": max_len, "requests": len(reqs),
                     "cache_dtype": "float32", "seed": 0}
    if dev == "cuda":
        table = params["embed"]["table"]
        w_q = quantize_dynamic(table.t(), axis=0)[0].contiguous()
        out["rank1_operand_build_ms_head"] = _ms(torch, lambda: (
            K.exact_weight_operand(w_q), K.rank1_weight_planes(w_q)), 3)
        print(f"  rank1 operand build at the head (576 x 49152): "
              f"{out['rank1_operand_build_ms_head']:.3f} ms")
        del runs
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.serve", "--backend",
             "approx_deficit_pallas"], cwd=ROOT, capture_output=True,
            text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        check(cli.returncode == 0, "python -m repro_torch.serve failed:\n"
              + cli.stdout[-2000:] + cli.stderr[-4000:])
        last = cli.stdout.strip().splitlines()
        check(any("backend=approx_deficit_pallas" in ln for ln in last),
              "python -m repro_torch.serve printed no summary")
        out["cli_s"] = time.perf_counter() - t0
        print(f"  python -m repro_torch.serve --backend "
              f"approx_deficit_pallas ({out['cli_s']:.1f} s): {last[0]}; "
              f"{last[-1]}")
    state = {"cfg": cfg0, "params": params, "reqs": reqs, "slots": slots,
             "max_len": max_len, "tokens": tokens,
             "ms_per_token": {be: statistics.median(
                 r["ms_per_token"] for r in row["reps"])
                 for be, row in out.items() if be in SPEC_BACKENDS}}
    return out, launches, state


# ---------------------------------------------------------------------------
# Phase 8: speculative serving of smollm-135m at full width
# ---------------------------------------------------------------------------

SPEC_BACKENDS = CUDA_BACKENDS + ("bf16",)
SPEC_K = 4
SPEC_DRAFT = "approx_stage1_pallas"    # bitwise the suite's approx_stage1
# the backends whose verify rows are claimed bitwise equal to sequential
# decode's; bf16's float projections are not row-local (PERF.md)
SPEC_BITWISE = CUDA_BACKENDS
PROBE_PROMPT = 20        # tokens of each slot's prompt in the verify probe
PROBE_REPS = 10          # timed calls of the fixed verify pass, draft step
# the verify probe's forms of a window pass (see _verify_forms); the
# engine's verify_step is "norm_columns"
VERIFY_FORMS = ("width_k", "norm_columns", "norm_attn_columns")
# bf16's verify rows and cache writes against sequential decode, over their
# range: tests/test_torch_spec.py's BF16_ROW_RTOL
BF16_VERIFY_RTOL = 1e-5


class SpecRecorder:
    """For the length of a ``with``: the host milliseconds of each pass of
    ``engine`` (speculative passes and plain fallback steps) and of each
    draft admission prefill, synchronized before and after, and the tokens
    each pass committed."""

    def __init__(self, torch, engine, dev: str):
        self.torch, self.engine, self.dev = torch, engine, dev
        self.pass_ms, self.pass_tokens, self.step_ms = [], [], []
        self.admit_ms = []

    def __enter__(self):
        eng = self.engine
        self.spec_step, self.decode = eng._spec_step, eng._decode
        self.admit = eng.speculator.admit
        metrics = eng.speculator.metrics

        def admit(*args):
            _sync(self.torch, self.dev)
            t0 = time.perf_counter()
            self.admit(*args)
            _sync(self.torch, self.dev)
            self.admit_ms.append((time.perf_counter() - t0) * 1e3)

        def spec_step(active):
            before = metrics.committed
            _sync(self.torch, self.dev)
            t0 = time.perf_counter()
            self.spec_step(active)
            _sync(self.torch, self.dev)
            self.pass_ms.append((time.perf_counter() - t0) * 1e3)
            self.pass_tokens.append(metrics.committed - before)

        def decode(*args):
            _sync(self.torch, self.dev)
            t0 = time.perf_counter()
            out = self.decode(*args)
            _sync(self.torch, self.dev)
            self.step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        eng._spec_step, eng._decode = spec_step, decode
        eng.speculator.admit = admit
        return self

    def __exit__(self, *exc):
        self.engine._spec_step = self.spec_step
        self.engine._decode = self.decode
        self.engine.speculator.admit = self.admit
        return False


def _launches(K) -> int:
    return sum(getattr(K, name).launches for name in
               ("approx_matmul", "fused_matmul", "rank1_matmul",
                "rank1_fused_matmul"))


def _verify_forms(torch, TLM, params, win, pos, cfg, cache) -> dict:
    """One verify pass over ``win`` from copies of ``cache``, in each of
    VERIFY_FORMS -> {form: (logits, cache)}. ``width_k`` is decode_step at
    width K (nothing per column); ``norm_columns`` is verify_step as
    shipped (the RMS norms per column); ``norm_attn_columns`` is verify_step
    with the attention run once per column too (each an Sq = 1 query at its
    own position)."""
    from repro_torch.nn import attention as A
    sdpa = A._sdpa

    def columns(q, k, v, q_pos, k_pos, window, p_bf16=False):
        return torch.cat([sdpa(q[:, j:j + 1], k, v, q_pos[:, j:j + 1], k_pos,
                               window, p_bf16=p_bf16)
                          for j in range(q.shape[1])], dim=1)

    out = {}
    for form in VERIFY_FORMS:
        c = TLM.map_leaves(lambda t: t.clone(), cache)
        if form == "width_k":
            out[form] = TLM.decode_step(params, win, pos, cfg, c)
            continue
        A._sdpa = columns if form == "norm_attn_columns" else sdpa
        try:
            out[form] = TLM.verify_step(params, win, pos, cfg, c)
        finally:
            A._sdpa = sdpa
    return out


def _over_range(a, b) -> float:
    return float((a - b).abs().max() / max(float(b.max() - b.min()), 1e-30))


def verify_probe(torch, TLM, params, cfg, draft_cfg, dev: str, gen) -> dict:
    """One verify pass against the K sequential decode steps it stands for,
    on 4 slots of PROBE_PROMPT-token prompts, in each of VERIFY_FORMS: the
    logits rows (equal bit for bit, and their largest difference over the
    row's range) and the cache writes (likewise, over each leaf's range).
    The shipped form's readings are also the top-level keys. Then the fixed
    verify pass and one draft step, each timed over PROBE_REPS calls and
    profiled once, and the kernel launches of each."""
    from repro_torch.kernels import approx_matmul as K
    slots = 4
    prompt = torch.randint(0, cfg.vocab, (slots, PROBE_PROMPT),
                           generator=gen).to(dev)
    pos = torch.full((slots,), PROBE_PROMPT, device=dev)
    with torch.no_grad():
        cache = TLM.init_cache(cfg, slots, 112, torch.float32, dev)
        logits, cache = TLM.prefill(params, prompt, cfg, cache)
        vcache = TLM.map_leaves(lambda t: t.clone(), cache)
        toks, seq = [logits[:, -1].argmax(-1)], []
        for j in range(SPEC_K):
            lg, cache = TLM.decode_step(params, toks[-1][:, None], pos + j,
                                        cfg, cache)
            seq.append(lg[:, 0])
            toks.append(lg[:, 0].argmax(-1))
        win = torch.stack(toks[:SPEC_K], 1)
        forms = _verify_forms(torch, TLM, params, win, pos, cfg, vcache)
        dcache = TLM.init_cache(draft_cfg, slots, 112, torch.float32, dev)
        TLM.prefill(params, prompt, draft_cfg, dcache)
    want = []
    TLM.map_leaves(want.append, cache)
    out = {"forms": {}}
    for form, (vlg, vc) in forms.items():
        got = []
        TLM.map_leaves(got.append, vc)
        out["forms"][form] = {
            "rows_bitwise": [bool(torch.equal(vlg[:, j], seq[j]))
                             for j in range(SPEC_K)],
            "row_max_diff_over_range": max(_over_range(vlg[:, j], seq[j])
                                           for j in range(SPEC_K)),
            "cache_bitwise": all(torch.equal(a, b)
                                 for a, b in zip(got, want)),
            "cache_max_diff_over_range": max(_over_range(a, b)
                                             for a, b in zip(got, want))}
    out.update(out["forms"]["norm_columns"])

    def verify():
        with torch.no_grad():
            TLM.verify_step(params, win, pos, cfg, vcache)

    def draft():
        with torch.no_grad():
            TLM.decode_step(params, win[:, :1], pos, draft_cfg, dcache)

    for name, fn in (("verify", verify), ("draft_step", draft)):
        fn()
        ms = _forward_ms(torch, fn, PROBE_REPS) if dev == "cuda" else []
        row = {"launches": 0}
        if dev == "cuda":
            med = statistics.median(ms)
            prof = _profile_ms(torch, fn)
            row.update({"ms_median": med, **prof,
                        "kernels_share": prof["kernels_ms"] / med,
                        "idle_share": 1 - prof["device_busy_ms"] / med})
            K.reset_launch_counts()
            fn()
            row["launches"] = _launches(K)
        out[name] = row
    out["launches_per_pass"] = (out["verify"]["launches"]
                                + SPEC_K * out["draft_step"]["launches"])
    return out


def spec_phase(torch, detail, dev: str, state: dict) -> tuple:
    """Serve the serve phase's workload again with speculative decoding
    (SpecConfig(k=4, draft_backend=SPEC_DRAFT)) under SPEC_BACKENDS; the
    tokens must be those of the backend's sequential serving, verify rows
    those of sequential decode (bit for bit for SPEC_BITWISE). Returns the
    spec line and the kernel launches of the speculative servings (counts
    set to 0 before each and read after it)."""
    import dataclasses
    from repro_torch.kernels import approx_matmul as K
    from repro_torch.models import transformer_lm as TLM
    from repro_torch.quant.quantize import for_lm
    from repro_torch.serve import engine as PE
    from repro_torch.serve.speculative import SpecConfig

    cfg0, params, reqs = state["cfg"], state["params"], state["reqs"]
    spec = SpecConfig(k=SPEC_K, draft_backend=SPEC_DRAFT)
    draft_cfg = spec.draft_arch(cfg0)
    gen = torch.Generator().manual_seed(1)
    launches = {key: 0 for key in launch_counts(K)}
    out = {}
    for be in SPEC_BACKENDS:
        cfg = dataclasses.replace(cfg0, quant=for_lm(be))
        eng = PE.Engine(cfg, params, slots=state["slots"],
                        max_len=state["max_len"], spec=spec, device=dev)
        for rid, prompt, max_new in reqs:
            eng.submit(PE.ServeRequest(rid=rid, prompt=prompt,
                                       max_new=max_new))
        K.reset_launch_counts()
        with SpecRecorder(torch, eng, dev) as rec:
            stats = eng.run()
        for key, n in launch_counts(K).items():
            launches[key] += n
        toks = {r.rid: list(r.output) for r in eng.completed}
        check(toks == state["tokens"][be],
              f"{be}: speculative tokens differ from its sequential "
              "serving's")
        hist = stats["spec_accept_hist"]
        check(stats["spec_passes"] > 0, f"{be}: no speculative pass")
        check(stats["spec_committed"] == sum((a + 1) * n for a, n in
                                             enumerate(hist)),
              f"{be}: committed tokens != accepted + outcomes")
        probe = verify_probe(torch, TLM, params, cfg, draft_cfg, dev, gen)
        if be in SPEC_BITWISE:
            check(all(probe["rows_bitwise"]) and probe["cache_bitwise"],
                  f"{be}: verify rows or cache writes differ from "
                  f"sequential decode's: {probe}")
        else:
            check(probe["row_max_diff_over_range"] <= BF16_VERIFY_RTOL
                  and probe["cache_max_diff_over_range"]
                  <= BF16_VERIFY_RTOL,
                  f"{be}: verify rows or cache writes differ from "
                  f"sequential decode's by more than {BF16_VERIFY_RTOL} of "
                  f"their range: {probe['forms']['norm_columns']}")
        decoded = stats["new_tokens"] - len(reqs)
        row = {"accept_mean": stats["spec_accept_mean"],
               "accept_hist": hist, "passes": stats["spec_passes"],
               "fallback_steps": len(rec.step_ms),
               "committed": stats["spec_committed"],
               "pass_ms_median": statistics.median(rec.pass_ms),
               "draft_admit_ms": rec.admit_ms,
               "ms_per_token": (sum(rec.pass_ms) + sum(rec.step_ms)
                                + sum(rec.admit_ms)) / decoded,
               "ms_per_token_without_admit": (sum(rec.pass_ms)
                                              + sum(rec.step_ms)) / decoded,
               "sequential_ms_per_token": state["ms_per_token"][be],
               "tokens_equal_sequential": True, "probe": probe}
        out[be] = row
        print(f"  spec {be:22s} tokens == sequential; {row['passes']} passes"
              f" (+{row['fallback_steps']} plain), accepted drafts/pass "
              f"{row['accept_mean']:.3f}, histogram {hist}; "
              f"{row['ms_per_token']:.3f} ms per decoded token with the "
              f"draft's admission prefills ({sum(rec.admit_ms):.3f} ms "
              f"over {len(rec.admit_ms)}), "
              f"{row['ms_per_token_without_admit']:.3f} without "
              f"(sequential {row['sequential_ms_per_token']:.3f}), pass "
              f"median {row['pass_ms_median']:.3f} ms; verify forms "
              "(rows bitwise, max diff/range; cache bitwise, max "
              "diff/range): "
              + ", ".join(f"{f} {all(r['rows_bitwise'])} "
                          f"{r['row_max_diff_over_range']:.3g}; "
                          f"{r['cache_bitwise']} "
                          f"{r['cache_max_diff_over_range']:.3g}"
                          for f, r in probe["forms"].items())
              + "".join(f"; {n}: {probe[n]['ms_median']:.3f} ms, busy "
                        f"{probe[n]['device_busy_ms']:.3f}, kernels "
                        f"{probe[n]['kernels_ms']:.3f}, idle "
                        f"{probe[n]['idle_share']:.2f}, "
                        f"{probe[n]['launches']} launches"
                        for n in ("verify", "draft_step")
                        if "ms_median" in probe[n])
              + f"; {probe['launches_per_pass']} launches per pass",
              flush=True)
        del eng
    out["config"] = {"k": SPEC_K, "draft_backend": SPEC_DRAFT,
                     "bitwise_claimed": list(SPEC_BITWISE)}
    return out, launches


# ---------------------------------------------------------------------------
# Phases 9-10: the windowed, MLA and mixture-of-experts archs
# ---------------------------------------------------------------------------

ARCH_SEED = 0
ARCH_STEP_REPS = 3           # timed calls of a fixed-shape decode step
GEMMA_BACKENDS = ("approx_deficit_pallas",)   # all 62 layers
RING_BACKENDS = ("bf16",) + CUDA_BACKENDS
RING_DEPTH = 6               # one whole 5:1 local:global group
# bf16 served rows against a cache-free forward over the whole sequence:
# both round every activation to bf16, at other GEMM shapes (2 rows a
# decode step, ~1,050 a forward), so the rows drift by bf16 last places
# through the six layers; a ring that lost or misplaced keys moves a row
# by a share of its range. The rows before the window, where no ring has
# wrapped, give the drift's own size beside it.
RING_RTOL = 5e-2
# the oracles' share of the ring workload: the first ORACLE_PREFIX[0]
# requests, their first ORACLE_PREFIX[1] prompt tokens and
# ORACLE_PREFIX[2] new tokens (the plain LUT gathers every (x, w) pair of
# the 27-billion-weight-wide layers: 48 prompt tokens take it ~4 s a
# backend on the card)
ORACLE_PREFIX = (2, 48, 6)
DSV2_DEPTH = 4
DSV2_BACKENDS = ("bf16", "approx_lut", "approx_stage1") + CUDA_BACKENDS
DSV2_SPEC = ("approx_deficit_pallas", 4, "approx_stage1_pallas")


def ring_workload(vocab: int, full: bool, seed: int = 0):
    """Long prompts from the seeded ``token_stream`` whose decode wraps the
    local layers' rings: 4 requests into 2 slots (admission mid-decode),
    prompts of 1,000-1,020 tokens, 32-48 new tokens each, max_len 1,088
    (so that the rings hold the whole window of 1,024). Without ``full``
    the same shape for the reduced gemma3's window of 8: prompts of 5-8
    tokens, 8-12 new, max_len 24. Returns (requests, slots, max_len)."""
    from repro_torch.data import synthetic
    rng = np.random.default_rng(seed + 13)
    n, slots = 4, 2
    if full:
        (lo, hi), (nlo, nhi), max_len = (1000, 1021), (32, 49), 1088
    else:
        (lo, hi), (nlo, nhi), max_len = (5, 9), (8, 13), 24
    stream = synthetic.token_stream(n, hi, vocab, seed=seed)
    lens, news = rng.integers(lo, hi, n), rng.integers(nlo, nhi, n)
    return [(rid, stream[rid, :int(lens[rid])], int(news[rid]))
            for rid in range(n)], slots, max_len


def _serve_arch(torch, PE, K, cfg, params, reqs, slots, max_len, dev,
                launches, **kw):
    """Serve ``reqs`` on a fresh engine, counting the kernel launches into
    ``launches``. Returns (engine, {rid: tokens}, recorder, stats, peak
    device GiB of the serving)."""
    eng = PE.Engine(cfg, params, slots=slots, max_len=max_len, device=dev,
                    **kw)
    for rid, prompt, max_new in reqs:
        eng.submit(PE.ServeRequest(rid=rid, prompt=prompt, max_new=max_new))
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    with ServeRecorder(torch, PE, eng, dev) as rec:
        stats = eng.run()
    for key, n in launch_counts(K).items():
        launches[key] += n
    toks = {r.rid: list(r.output) for r in eng.completed}
    label = f"{cfg.name} {cfg.quant.backend}"
    check(len(toks) == len(reqs) and all(toks.values()),
          f"{label}: not every request was served")
    check(all(np.isfinite(r).all() and r.shape == (cfg.padded_vocab,)
              for r in rec.rows.values()), f"{label}: bad logits rows")
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30 if dev == "cuda"
            else None)
    return eng, toks, rec, stats, peak


def _serving_row(rec, stats, peak, reqs) -> dict:
    return {"decode_step_ms_median": statistics.median(rec.step_ms),
            "ms_per_token": sum(rec.step_ms) / max(
                1, stats["new_tokens"] - len(reqs)),
            "decode_steps": stats["decode_steps"],
            "ttft_ms_mean": stats["ttft_ms_mean"],
            "tok_per_s": stats["tok_per_s"],
            "new_tokens": stats["new_tokens"], "waves": stats["waves"],
            "prefix_hit_rate": stats["prefix_hit_rate"],
            "peak_memory_gb": peak}


def _arch_step(torch, K, eng, params, cfg, pos, backend, ops, fac) -> dict:
    """A fixed-shape decode step of ``eng``'s pool at positions ``pos``:
    ARCH_STEP_REPS host-timed calls, one profiled (busy, port kernels,
    idle share), its kernel launches against the config's projections and
    tiles, and, for a CUDA backend, the bound of its launches."""
    dev = "cuda"
    tok = torch.arange(1, eng.slots + 1, device=dev)[:, None]
    pos = torch.as_tensor(pos, device=dev)

    def step():
        with torch.no_grad():
            eng._decode(params, eng.pool, tok, pos)

    step()
    ms = _forward_ms(torch, step, ARCH_STEP_REPS)
    K.reset_launch_counts()
    prof = _profile_ms(torch, step)
    n = _launches(K)
    med = statistics.median(ms)
    row = {"fixed_step_ms": {"median": med, "min": min(ms), "max": max(ms),
                             "n": ARCH_STEP_REPS}, **prof,
           "idle_share": 1 - prof["device_busy_ms"] / med}
    if backend in CUDA_BACKENDS:
        var = SERVE_KERNEL[backend]
        check(n == _step_launches(K, cfg, var),
              f"{cfg.name} {backend}: {n} launches in one decode step, "
              f"{_step_launches(K, cfg, var)} expected")
        row["launches_per_step"] = n
        row["step_bound_ms"] = _serve_bound_ms(cfg, eng.slots, var, ops, fac)
    return row


def _print_arch(label: str, be: str, row: dict) -> None:
    print(f"  {label} {be:22s} decode step median "
          f"{row['decode_step_ms_median']:.3f} ms ({row['decode_steps']} "
          f"steps, {row['new_tokens']} tokens, TTFT mean "
          f"{row['ttft_ms_mean']:.1f} ms), peak "
          + (f"{row['peak_memory_gb']:.2f} GiB" if row["peak_memory_gb"]
             is not None else "n/a")
          + (f"; fixed step {row['fixed_step_ms']['median']:.3f} ms, busy "
             f"{row['device_busy_ms']:.3f}, port kernels "
             f"{row['kernels_ms']:.3f}, idle {row['idle_share']:.2f}, "
             f"{row['device_ops']} device ops"
             if "fixed_step_ms" in row else "")
          + (f", {row['launches_per_step']} launches, bound "
             f"{row['step_bound_ms']:.3f} ms" if "step_bound_ms" in row
             else ""), flush=True)


def _init_arch(torch, TLM, cfg, dev: str) -> tuple:
    """Seeded random parameters on ``dev`` (on the card its generator
    draws the large leaves, ``nn/module.init_params``), with the seconds
    and the peak device GiB of the draw."""
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = TLM.init(cfg, torch.Generator().manual_seed(ARCH_SEED),
                      device=dev)
    _sync(torch, dev)
    return params, {
        "init_s": time.perf_counter() - t0,
        "init_peak_gb": (torch.cuda.max_memory_allocated() / 2 ** 30
                         if dev == "cuda" else None)}


def _bitwise_runs(label, runs, a, b):
    """Tokens and every sampled logits row of run ``a`` equal run ``b``'s."""
    (ta, ra), (tb, rb) = runs[a], runs[b]
    check(ta == tb, f"{label}: {a}'s tokens differ from {b}'s")
    check(ra.keys() == rb.keys(), f"{label}: {a} sampled at other steps "
          f"than {b}")
    for key, r in ra.items():
        check(np.array_equal(r, rb[key]),
              f"{label}: {a}'s logits at (rid, step) {key} differ from "
              f"{b}'s")
    return len(ra)


def gemma_phase(torch, detail, dev: str, full: bool, ops=None) -> tuple:
    """gemma3-27b (see the module docstring, phase 9). ``full``: the
    published config, 62 layers from seed 0 (27.0 B bf16 parameters),
    then its first RING_DEPTH layers; without it the reduced gemma3 (one
    5:1 group and a remainder group of 2) on the CPU, with a window of 64
    for the whole model (longer than the smoke workload's cache, as 1,024
    is than the full one's) and of 8 for the ring workload. Returns
    the gemma line and the kernel launches of the 'gemma' (full depth)
    and 'gemma_ring' paths."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.core import factor as F
    from repro_torch.kernels import approx_matmul as K
    from repro_torch.models import transformer_lm as TLM
    from repro_torch.nn.module import n_params
    from repro_torch.quant.quantize import for_lm
    from repro_torch.serve import engine as PE

    fac = F.factorize("proposed")
    if full:
        cfg0 = registry.get("gemma3-27b")
        check((cfg0.n_layers, cfg0.d_model, cfg0.n_heads, cfg0.n_kv_heads,
               cfg0.d_ff, cfg0.vocab, cfg0.local_window, cfg0.local_ratio)
              == (62, 5376, 32, 16, 21504, 262144, 1024, 5)
              and n_params(TLM.descs(cfg0)) == 27_008_319_744,
              f"unexpected gemma3-27b config {cfg0}")
    else:
        cfg0 = registry.reduced("gemma3-27b", n_layers=8, local_window=64,
                                param_dtype=torch.bfloat16)
    check(cfg0.blocks()[-1][1] == ("global", "global"),
          "no remainder group in the block program")
    params, init = _init_arch(torch, TLM, cfg0, dev)
    out = {"config": {"arch": cfg0.name, "n_layers": cfg0.n_layers,
                      "blocks": cfg0.blocks(), "d_model": cfg0.d_model,
                      "vocab": cfg0.vocab, "window": cfg0.local_window,
                      "params": n_params(TLM.descs(cfg0)),
                      "param_dtype": str(cfg0.param_dtype),
                      "seed": ARCH_SEED}, **init}
    print(f"  gemma3 {out['config']['params']:,} parameters drawn in "
          f"{init['init_s']:.1f} s (peak {init['init_peak_gb']} GiB)",
          flush=True)
    paths = {p: {key: 0 for key in launch_counts(K)}
             for p in ("gemma", "gemma_ring")}

    # --- the whole model on the serve suite's workload: unpaged, exact
    # prompt lengths (rings longer than max_len: the window masks only)
    reqs, slots, max_len = serve_workload(cfg0.vocab, smoke=not full, seed=0)
    out["full"] = {}
    for be in GEMMA_BACKENDS:
        cfg = dataclasses.replace(cfg0, quant=for_lm(be))
        eng, toks, rec, stats, peak = _serve_arch(
            torch, PE, K, cfg, params, reqs, slots, max_len, dev,
            paths["gemma"])
        check(eng.prefix is None, "gemma3 served with the prefix cache")
        row = _serving_row(rec, stats, peak, reqs)
        if dev == "cuda":
            row.update(_arch_step(torch, K, eng, params, cfg,
                                  [40, 50, 60, 70], be, ops, fac))
        out["full"][be] = row
        _print_arch(f"gemma3 L{cfg0.n_layers}", be, row)
        del eng, rec        # the recorder holds the engine, and its params

    # --- the first RING_DEPTH layers on the ring workload
    cfg6 = dataclasses.replace(cfg0, n_layers=RING_DEPTH,
                               local_window=1024 if full else 8)
    check(cfg6.blocks() == [(1, ("local",) * 5 + ("global",))],
          f"unexpected depth-{RING_DEPTH} program {cfg6.blocks()}")
    params = {"embed": params["embed"], "final_ln": params["final_ln"],
              "blocks": [TLM.map_leaves(lambda t: t[:1].clone(),
                                        params["blocks"][0])]}
    if dev == "cuda":
        torch.cuda.empty_cache()
    reqs, slots, max_len = ring_workload(cfg0.vocab, full)
    window = cfg6.local_window
    runs, out["ring"] = {}, {}
    for be in RING_BACKENDS:
        cfg = dataclasses.replace(cfg6, quant=for_lm(be))
        eng, toks, rec, stats, peak = _serve_arch(
            torch, PE, K, cfg, params, reqs, slots, max_len, dev,
            paths["gemma_ring"])
        check(eng.pool["blocks"][0]["k0_local"]["k"].shape[2] == window,
              "the local layers' caches are not rings of the window")
        check(stats["waves"] >= 2, f"ring {be}: no mid-decode admission")
        last = max(len(p) + len(toks[rid]) - 2 for rid, p, _ in reqs)
        check(last >= window, f"ring {be}: decode ended at position {last},"
              f" before the ring wraps at {window}")
        runs[be] = (toks, rec.rows)
        row = _serving_row(rec, stats, peak, reqs)
        row["last_position"] = last
        if dev == "cuda":
            row.update(_arch_step(
                torch, K, eng, params, cfg,
                [window + 7 + 11 * i for i in range(slots)], be, ops, fac))
        out["ring"][be] = row
        _print_arch(f"gemma3 L{RING_DEPTH} ring", be, row)
        del eng, rec
    n = _bitwise_runs("ring", runs, "approx_deficit_pallas",
                      "approx_rank1_pallas")
    out["ring"]["deficit_rank1_bitwise_rows"] = n
    print(f"  ring: approx_deficit_pallas and approx_rank1_pallas served "
          f"tokens and all {n} sampled logits rows bitwise equal")

    # the oracles, on the workload's first requests, cut short
    n_req, n_prompt, n_new = ORACLE_PREFIX if full else (2, 4, 4)
    short = [(rid, p[:n_prompt], n_new) for rid, p, _ in reqs[:n_req]]
    oruns, t0 = {}, time.perf_counter()
    for be in ("approx_lut", "approx_stage1") + CUDA_BACKENDS:
        cfg = dataclasses.replace(cfg6, quant=for_lm(be))
        t1 = time.perf_counter()
        _, toks, rec, _, _ = _serve_arch(torch, PE, K, cfg, params, short,
                                         slots, max_len, dev,
                                         paths["gemma_ring"])
        oruns[be] = (toks, rec.rows)
        out["ring"].setdefault("oracle_prefix_s", {})[be] = \
            time.perf_counter() - t1
    for be in CUDA_BACKENDS:
        oracle = "approx_stage1" if be == "approx_stage1_pallas" else \
            "approx_lut"
        n = _bitwise_runs("ring prefix", oruns, be, oracle)
        out["ring"].setdefault("oracle_bitwise_rows", {})[be] = n
    out["ring"]["oracle_prefix"] = {"requests": n_req, "prompt": n_prompt,
                                    "new": n_new}
    print(f"  ring prefix ({n_req} requests, {n_prompt} prompt tokens, "
          f"{n_new} new; {time.perf_counter() - t0:.1f} s): each CUDA "
          "backend's tokens and logits rows bitwise equal to its oracle's")

    # the ring itself: bf16 rows against the cache-free forward
    cfg = dataclasses.replace(cfg6, quant=for_lm("bf16"))
    toks, rows = runs["bf16"]
    worst = {"wrapped": 0.0, "before": 0.0}
    n_wrapped = 0
    with torch.no_grad():
        for rid, prompt, _ in reqs:
            seq = np.concatenate([prompt, np.asarray(toks[rid][:-1],
                                                     np.int32)])
            x = TLM.embed_tokens(params, torch.as_tensor(
                seq[None], dtype=torch.int64, device=dev), cfg)
            h, _, _ = TLM.backbone(params, x, cfg)
            pos = [len(prompt) - 1 + j for j in range(len(toks[rid]))]
            ref = TLM.lm_logits(params, h[:, pos], cfg)[0].float().cpu()
            for j, p in enumerate(pos):
                want = ref[j].numpy()
                err = float(np.abs(rows[(rid, j)] - want).max()
                            / max(float(np.ptp(want)), 1e-30))
                kind = "wrapped" if p >= window else "before"
                worst[kind] = max(worst[kind], err)
                n_wrapped += p >= window
            del h, x
    check(n_wrapped > 0, "no served row past the window")
    check(worst["wrapped"] <= RING_RTOL,
          f"ring: served bf16 rows past the window differ from the "
          f"cache-free forward by {worst['wrapped']:.3g} of their range "
          f"(tolerance {RING_RTOL})")
    out["ring"]["bf16_vs_cache_free"] = {
        "rows_past_window": n_wrapped, "max_over_range": worst,
        "rtol": RING_RTOL}
    print(f"  ring: {n_wrapped} bf16 rows past position {window} within "
          f"{worst['wrapped']:.3g} of their range of the cache-free "
          f"forward (tolerance {RING_RTOL}; rows before the window: "
          f"{worst['before']:.3g})", flush=True)
    out["ring"]["config"] = {"n_layers": RING_DEPTH, "slots": slots,
                             "max_len": max_len, "requests": len(reqs),
                             "prompt_lens": [len(p) for _, p, _ in reqs],
                             "max_new": [m for _, _, m in reqs]}
    detail["gemma"] = out
    return out, paths


def _verify_rows(torch, TLM, params, cfg, dev: str, k: int) -> dict:
    """One verify pass of a (4, k) window against k sequential decode
    steps from the same prefilled cache (greedy tokens of 4 random
    6-token prompts): whether each logits row and the cache writes are
    bitwise equal."""
    rng = np.random.default_rng(3)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 6)), device=dev)
    pos = torch.full((4,), 6, device=dev)
    with torch.no_grad():
        cache = TLM.init_cache(cfg, 4, 64, torch.float32, dev)
        logits, cache = TLM.prefill(params, prompt, cfg, cache)
        vcache = TLM.map_leaves(lambda t: t.clone(), cache)
        toks, seq = [logits[:, -1].argmax(-1)], []
        for j in range(k):
            lg, cache = TLM.decode_step(params, toks[-1][:, None], pos + j,
                                        cfg, cache)
            seq.append(lg[:, 0])
            toks.append(lg[:, 0].argmax(-1))
        vlg, vcache = TLM.verify_step(params, torch.stack(toks[:k], 1), pos,
                                      cfg, vcache)
    a, b = [], []
    TLM.map_leaves(a.append, vcache)
    TLM.map_leaves(b.append, cache)
    return {"rows_bitwise": [bool(torch.equal(vlg[:, j], seq[j]))
                             for j in range(k)],
            "cache_bitwise": all(bool(torch.equal(x, y))
                                 for x, y in zip(a, b))}


def deepseek_phase(torch, detail, dev: str, full: bool, ops=None) -> tuple:
    """deepseek-v2-236b (see the module docstring, phase 10): the
    published widths at depth DSV2_DEPTH (seed 0, bf16) when ``full``,
    else the reduced config on the CPU, on the serve suite's workload with
    the prefix cache; each CUDA backend bitwise to its oracle, and one
    speculative serving equal to sequential decode. Returns the deepseek
    line and the path's kernel launches."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.core import factor as F
    from repro_torch.kernels import approx_matmul as K
    from repro_torch.models import transformer_lm as TLM
    from repro_torch.nn.module import n_params
    from repro_torch.quant import matmul as QM
    from repro_torch.quant.quantize import for_lm
    from repro_torch.serve import engine as PE
    from repro_torch.serve.speculative import SpecConfig

    fac = F.factorize("proposed")
    if full:
        cfg0 = registry.get("deepseek-v2-236b", n_layers=DSV2_DEPTH)
        check((cfg0.d_model, cfg0.n_heads, cfg0.kv_lora, cfg0.n_experts,
               cfg0.top_k, cfg0.n_shared, cfg0.moe_d_ff, cfg0.vocab) ==
              (5120, 128, 512, 160, 6, 2, 1536, 102400),
              f"unexpected deepseek-v2-236b config {cfg0}")
    else:
        cfg0 = registry.reduced("deepseek-v2-236b",
                                param_dtype=torch.bfloat16)
    params, init = _init_arch(torch, TLM, cfg0, dev)
    out = {"config": {"arch": cfg0.name, "n_layers": cfg0.n_layers,
                      "d_model": cfg0.d_model, "vocab": cfg0.vocab,
                      "n_experts": cfg0.n_experts, "top_k": cfg0.top_k,
                      "params": n_params(TLM.descs(cfg0)),
                      "param_dtype": str(cfg0.param_dtype),
                      "seed": ARCH_SEED}, **init}
    print(f"  deepseek-v2 {out['config']['params']:,} parameters drawn in "
          f"{init['init_s']:.1f} s (peak {init['init_peak_gb']} GiB)",
          flush=True)
    launches = {key: 0 for key in launch_counts(K)}
    reqs, slots, max_len = serve_workload(cfg0.vocab, smoke=not full, seed=0)
    runs = {}
    for be in DSV2_BACKENDS:
        cfg = dataclasses.replace(cfg0, quant=for_lm(be))
        eng, toks, rec, stats, peak = _serve_arch(
            torch, PE, K, cfg, params, reqs, slots, max_len, dev, launches)
        check(eng.prefix is not None and stats["prefix_hit_rate"] > 0,
              f"deepseek-v2 {be}: no prefix-cache hit")
        check(stats["waves"] >= 2, f"deepseek-v2 {be}: no mid-decode "
              "admission")
        runs[be] = (toks, rec.rows)
        row = _serving_row(rec, stats, peak, reqs)
        if dev == "cuda" and be not in ("approx_lut", "approx_stage1"):
            row.update(_arch_step(torch, K, eng, params, cfg,
                                  [40, 50, 60, 70], be, ops, fac))
        out[be] = row
        _print_arch(f"deepseek-v2 L{cfg0.n_layers}", be, row)
        del eng, rec
    for be in CUDA_BACKENDS:
        out[be]["oracle_bitwise_rows"] = _bitwise_runs(
            "deepseek-v2", runs, be, QM.get_backend(be).oracle)
    print("  deepseek-v2: each CUDA backend's served tokens and every "
          "sampled logits row bitwise equal to its oracle's")
    target, k, draft = DSV2_SPEC
    cfg = dataclasses.replace(cfg0, quant=for_lm(target))
    probe = _verify_rows(torch, TLM, params, cfg, dev, k)
    check(all(probe["rows_bitwise"]) and probe["cache_bitwise"],
          f"deepseek-v2 {target}: verify rows or cache writes differ from "
          f"sequential decode's: {probe}")
    _, toks, rec, stats, _ = _serve_arch(
        torch, PE, K, cfg, params, reqs, slots, max_len, dev, launches,
        spec=SpecConfig(k=k, draft_backend=draft))
    diff = [(rid, next(i for i, (a, b) in enumerate(zip(t, runs[target][0][
        rid])) if a != b) if len(t) == len(runs[target][0][rid]) else -1)
        for rid, t in toks.items() if t != runs[target][0][rid]]
    check(not diff, "deepseek-v2: speculative tokens differ from "
          f"sequential decode's at (rid, index) {diff}")
    check(stats["spec_passes"] > 0, "deepseek-v2: no speculative pass")
    out["spec"] = {"target": target, "k": k, "draft": draft,
                   "tokens_equal_sequential": True, "verify_probe": probe,
                   "accept_mean": stats["spec_accept_mean"],
                   "accept_hist": stats["spec_accept_hist"],
                   "passes": stats["spec_passes"]}
    print(f"  deepseek-v2 spec (K={k}, {draft} draft, {target} target): "
          f"verify rows and cache writes bitwise == {k} sequential decode "
          f"steps; tokens == sequential, {stats['spec_passes']} passes, "
          "accepted "
          f"drafts/pass {stats['spec_accept_mean']:.3f}", flush=True)
    out["serving"] = {"slots": slots, "max_len": max_len,
                      "requests": len(reqs), "cache_dtype": "float32"}
    detail["deepseek"] = out
    return out, launches


# ---------------------------------------------------------------------------
# Phase 11: the SSM archs, rwkv6-3b and hymba-1.5b
# ---------------------------------------------------------------------------

# (n_layers, d_model, n_heads, n_kv_heads, d_ff, vocab, window) and the
# parameters of each published config
SSM_ARCHS = {"rwkv6-3b": ((32, 2560, 40, 40, 8960, 65536, 0), 3_099_527_680),
             "hymba-1.5b": ((32, 1600, 25, 5, 5504, 32001, 1024),
                            1_345_537_600)}
SSM_BACKENDS = ("bf16", "approx_deficit_pallas")
SSM_DEPTH = 4                # the oracle checks' depth (the head whole)
SSM_ORACLES = ("approx_lut", "approx_stage1")
# rwkv6's extra request: a prompt of three WKV chunks of 64, the last one
# ragged (22 tokens), served at max_len 192
SSM_LONG = (150, 12, 192)    # prompt tokens, new tokens, max_len
SSM_PREFILL_REPS = 3         # timed prefills of the workload's longest prompt
# Served rows under the bf16 backend against a cache-free forward over the
# whole sequence, with float32 weights (the seed-0 draw cast): the served
# rows went through the recurrent states in the pool (prefill, decode, slot
# reuse); a state carried wrongly moves a row by a share of its range. With
# the bfloat16 weights the figure is printed, not held: at 32 layers the
# bf16 model's own two forward forms (the chunked and the sequential WKV)
# disagree by more than this (7.3e-2 on a 32-layer reduced rwkv6 on the
# CPU), and the served rows are no further from either.
SSM_RTOL = 5e-2
WKV_SHAPE = (1, 150, 40, 64)     # rwkv6's layer: 40 heads of 64, 150 steps
WKV_TOL = 2e-4


def ssm_workload(arch: str, vocab: int, full: bool, seed: int = 0):
    """The serve suite's workload (``serve_workload``); for rwkv6 one more
    request with a SSM_LONG prompt, served at its max_len."""
    reqs, slots, max_len = serve_workload(vocab, smoke=not full, seed=seed)
    if arch == "rwkv6-3b":
        n, new, max_len = SSM_LONG
        rng = np.random.default_rng(seed + 17)
        reqs = reqs + [(len(reqs), rng.integers(0, vocab, n).astype(np.int32),
                        new)]
    return reqs, slots, max_len


def wkv_check(torch, SSM, dev: str, full: bool) -> dict:
    """The chunked WKV against the sequential recurrence at rwkv6's layer
    shape (without ``full``: 4 heads of 32) on random float32 inputs with
    a non-zero incoming state, within WKV_TOL (rtol and atol) in y and in
    the final state."""
    b, t, h, n = WKV_SHAPE if full else (1, 150, 4, 32)
    gen = torch.Generator().manual_seed(7)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    r, k, v = rnd(b, t, h, n), rnd(b, t, h, n), rnd(b, t, h, n)
    w = torch.sigmoid(rnd(b, t, h, n)) * 0.98 + 0.01
    u, S0 = rnd(h, n, scale=0.1), rnd(b, h, n, n, scale=0.5)
    with torch.no_grad():
        yc, Sc = SSM.wkv_chunked(r, k, v, w, u, S0)
        ys, Ss = SSM.wkv_sequential(r, k, v, w, u, S0)
    out = {"shape": [b, t, h, n], "chunks": -(-t // 64), "tol": WKV_TOL}
    for name, a, c in (("y", yc, ys), ("S", Sc, Ss)):
        excess = float(((a - c).abs() - WKV_TOL * c.abs()).max())
        out[f"{name}_max_abs_diff"] = float((a - c).abs().max())
        check(excess <= WKV_TOL, f"chunked WKV {name} differs from the "
              f"sequential recurrence past rtol = atol = {WKV_TOL}: "
              f"{out[f'{name}_max_abs_diff']:.3g}")
    print(f"  WKV {out['shape']} ({out['chunks']} chunks, the last ragged): "
          f"chunked == sequential within {WKV_TOL} (y "
          f"{out['y_max_abs_diff']:.3g}, S {out['S_max_abs_diff']:.3g})",
          flush=True)
    return out


def _prefill_ms(torch, TLM, params, cfg, prompt, max_len, dev) -> list:
    """Host ms of SSM_PREFILL_REPS prefills of ``prompt`` into a fresh
    batch-1 cache (the engine's admission prefill without the queue)."""
    toks = torch.as_tensor(prompt[None], dtype=torch.int64, device=dev)
    out = []
    for _ in range(SSM_PREFILL_REPS):
        with torch.no_grad():
            cache = TLM.init_cache(cfg, 1, max_len, torch.float32, dev)
            _sync(torch, dev)
            t0 = time.perf_counter()
            TLM.prefill(params, toks, cfg, cache)
            _sync(torch, dev)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _cache_free_rows(torch, TLM, params, cfg, reqs, run, dev) -> dict:
    """Every logits row a serving sampled against a cache-free forward over
    the same tokens (one prefill of the whole sequence: the chunked WKV,
    Mamba's scan and the attention over all of it): the largest difference
    over the row's range. For rwkv6, the same against a forward with the
    sequential WKV, and the two forwards against each other: the rounding
    of the forms themselves. Rows are compared over the true vocab (the
    padded entries hold the float32 minimum)."""
    toks, rows = run
    v = cfg.vocab
    forms = {"forward": cfg}
    if cfg.rwkv_chunked:
        forms["sequential_wkv"] = dataclasses.replace(cfg, rwkv_chunked=False)
    out = {"rows": 0, **{f"served_vs_{k}": 0.0 for k in forms}}
    if len(forms) > 1:
        out["forward_vs_sequential_wkv"] = 0.0

    def over(a, b):
        return float(np.abs(a - b).max() / max(float(np.ptp(b)), 1e-30))

    with torch.no_grad():
        for rid, prompt, _ in reqs:
            seq = np.concatenate([prompt, np.asarray(toks[rid][:-1],
                                                     np.int32)])
            x = TLM.embed_tokens(params, torch.as_tensor(
                seq[None], dtype=torch.int64, device=dev), cfg)
            pos = [len(prompt) - 1 + j for j in range(len(toks[rid]))]
            refs = {}
            for key, c in forms.items():
                h, _, _ = TLM.backbone(params, x, c)
                refs[key] = TLM.lm_logits(params, h[:, pos],
                                          c)[0].float().cpu().numpy()
                del h
            for j in range(len(pos)):
                for key, ref in refs.items():
                    out[f"served_vs_{key}"] = max(
                        out[f"served_vs_{key}"],
                        over(rows[(rid, j)][:v], ref[j, :v]))
                if len(refs) > 1:
                    out["forward_vs_sequential_wkv"] = max(
                        out["forward_vs_sequential_wkv"],
                        over(refs["forward"][j, :v],
                             refs["sequential_wkv"][j, :v]))
            out["rows"] += len(pos)
    return out


def _ssm_arch(torch, dev, full, ops, arch, launches) -> dict:
    """One SSM arch (see the module docstring, phase 11)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.core import factor as F
    from repro_torch.kernels import approx_matmul as K
    from repro_torch.models import transformer_lm as TLM
    from repro_torch.nn.module import n_params
    from repro_torch.quant import matmul as QM
    from repro_torch.quant.quantize import for_lm
    from repro_torch.serve import engine as PE

    fac = F.factorize("proposed")
    if full:
        cfg0 = registry.get(arch)
        fields, count = SSM_ARCHS[arch]
        check((cfg0.n_layers, cfg0.d_model, cfg0.n_heads, cfg0.n_kv_heads,
               cfg0.d_ff, cfg0.vocab, cfg0.local_window) == fields
              and n_params(TLM.descs(cfg0)) == count
              and cfg0.param_dtype == torch.bfloat16,
              f"unexpected {arch} config {cfg0}")
    else:       # a window longer than the smoke workload's cache, as 1,024
        cfg0 = registry.reduced(arch, n_layers=6, param_dtype=torch.bfloat16,
                                local_window=64 if arch == "hymba-1.5b"
                                else 0)
    label = f"{arch} L{cfg0.n_layers}"
    params, init = _init_arch(torch, TLM, cfg0, dev)
    out = {"config": {"arch": arch, "n_layers": cfg0.n_layers,
                      "blocks": cfg0.blocks(), "d_model": cfg0.d_model,
                      "vocab": cfg0.vocab, "window": cfg0.local_window,
                      "params": n_params(TLM.descs(cfg0)),
                      "param_dtype": str(cfg0.param_dtype),
                      "seed": ARCH_SEED}, **init}
    print(f"  {arch} {out['config']['params']:,} parameters drawn in "
          f"{init['init_s']:.1f} s (peak {init['init_peak_gb']} GiB)",
          flush=True)
    reqs, slots, max_len = ssm_workload(arch, cfg0.vocab, full)
    longest = max(reqs, key=lambda r: len(r[1]))[1]

    # --- the whole model, unpaged at exact prompt lengths
    runs, out["whole"] = {}, {}
    for be in SSM_BACKENDS:
        cfg = dataclasses.replace(cfg0, quant=for_lm(be))
        eng, toks, rec, stats, peak = _serve_arch(
            torch, PE, K, cfg, params, reqs, slots, max_len, dev, launches)
        check(eng.prefix is None and not PE.padded_prefill_ok(cfg),
              f"{label} served with the prefix cache")
        check(stats["waves"] >= 2, f"{label} {be}: no mid-decode admission")
        runs[be] = (toks, rec.rows)
        row = _serving_row(rec, stats, peak, reqs)
        row["prefill_ms"] = _prefill_ms(torch, TLM, params, cfg, longest,
                                        max_len, dev)
        row["prefill_tokens"] = len(longest)
        if dev == "cuda":
            row.update(_arch_step(torch, K, eng, params, cfg,
                                  [40, 50, 60, 70], be, ops, fac))
        out["whole"][be] = row
        _print_arch(label, be, row)
        print(f"  {label} {be:22s} prefill of {len(longest)} tokens: median "
              f"{statistics.median(row['prefill_ms']):.1f} ms", flush=True)
        del eng, rec
    cfg = dataclasses.replace(cfg0, quant=for_lm("bf16"))
    free = {"bfloat16_weights": _cache_free_rows(
        torch, TLM, params, cfg, reqs, runs["bf16"], dev)}
    # the same draw in float32: served under bf16 again, and held
    cfg = dataclasses.replace(cfg, param_dtype=torch.float32)
    params32 = TLM.map_leaves(lambda t: t.float(), params)
    _, toks, rec, _, _ = _serve_arch(torch, PE, K, cfg, params32, reqs, slots,
                                     max_len, dev, launches)
    free["float32_weights"] = _cache_free_rows(
        torch, TLM, params32, cfg, reqs, (toks, rec.rows), dev)
    del rec, params32
    free["rtol"] = SSM_RTOL
    worst = free["float32_weights"]["served_vs_forward"]
    check(worst <= SSM_RTOL,
          f"{label}: served rows (float32 weights) differ from the "
          f"cache-free forward by {worst:.3g} of their range (tolerance "
          f"{SSM_RTOL})")
    out["whole"]["bf16_vs_cache_free"] = free
    print(f"  {label} bf16: all {free['float32_weights']['rows']} sampled "
          f"rows within {worst:.3g} of their range of the cache-free forward "
          f"with float32 weights (tolerance {SSM_RTOL}); with bfloat16 "
          "weights " + ", ".join(f"{k} {v:.3g}" for k, v in
                                 free["bfloat16_weights"].items()
                                 if k != "rows"), flush=True)

    # --- the first SSM_DEPTH layers: each CUDA backend == its oracle
    cfg4 = dataclasses.replace(cfg0, n_layers=SSM_DEPTH)
    params4 = {**params, "blocks": [TLM.map_leaves(
        lambda t: t[:SSM_DEPTH], params["blocks"][0])]}
    oruns, out["depth"] = {}, {"n_layers": SSM_DEPTH}
    for be in SSM_ORACLES + CUDA_BACKENDS:
        cfg = dataclasses.replace(cfg4, quant=for_lm(be))
        t0 = time.perf_counter()
        _, toks, rec, stats, _ = _serve_arch(
            torch, PE, K, cfg, params4, reqs, slots, max_len, dev, launches)
        oruns[be] = (toks, rec.rows)
        out["depth"].setdefault("serving_s", {})[be] = \
            time.perf_counter() - t0
        out["depth"].setdefault("decode_step_ms_median", {})[be] = \
            statistics.median(rec.step_ms)
        del rec
    for be in CUDA_BACKENDS:
        out["depth"].setdefault("oracle_bitwise_rows", {})[be] = \
            _bitwise_runs(f"{arch} L{SSM_DEPTH}", oruns, be,
                          QM.get_backend(be).oracle)
    out["depth"]["deficit_rank1_bitwise_rows"] = _bitwise_runs(
        f"{arch} L{SSM_DEPTH}", oruns, "approx_deficit_pallas",
        "approx_rank1_pallas")
    print(f"  {arch} L{SSM_DEPTH}: each CUDA backend's tokens and all "
          f"{out['depth']['deficit_rank1_bitwise_rows']} sampled logits rows "
          "bitwise equal to its oracle's; deficit == rank1", flush=True)
    out["serving"] = {"slots": slots, "max_len": max_len,
                      "requests": len(reqs),
                      "prompt_lens": [len(p) for _, p, _ in reqs],
                      "max_new": [m for _, _, m in reqs],
                      "cache_dtype": "float32"}
    return out


def ssm_phase(torch, detail, dev: str, full: bool, ops=None) -> tuple:
    """rwkv6-3b and hymba-1.5b (see the module docstring, phase 11):
    ``full`` serves the published configs from seed 0 on the card; without
    it the reduced ones (6 layers, hymba's window 64) on the CPU. Returns
    the ssm line and the path's kernel launches."""
    from repro_torch.kernels import approx_matmul as K
    from repro_torch.nn import ssm as SSM

    launches = {key: 0 for key in launch_counts(K)}
    out = {"wkv": wkv_check(torch, SSM, dev, full)}
    for arch in SSM_ARCHS:
        out[arch] = _ssm_arch(torch, dev, full, ops, arch, launches)
        if dev == "cuda":
            torch.cuda.empty_cache()
    detail["ssm"] = out
    return out, launches


# ---------------------------------------------------------------------------
# Phase 12: the LM training path
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = TRAIN_ROWS
# (a) the fault-tolerant loop: a checkpoint every TRAIN_CKPT steps, a
# failure injected after step TRAIN_FAIL, the rerun resumes from step 8
TRAIN_STEPS, TRAIN_CKPT, TRAIN_FAIL = 12, 4, 9
TRAIN_CKPT_DIR = ROOT / "build" / "train_ckpt"
# the example's run: it crashes after step 0 (2 * 1 // 3), before its
# first checkpoint (every 10 steps), so its rerun starts from step 0 (a
# step at 32 x 1,024 takes seconds)
EXAMPLE_STEPS = 1
# (b) each arch's depth (None: whole) and parameter count at it
TRAIN_ARCHS = {"smollm-135m": (None, 134_515_008),
               "gemma3-27b": (6, 3_886_616_832),
               "deepseek-v2-236b": (1, 5_100_911_616),
               "rwkv6-3b": (None, 3_099_527_680),
               "hymba-1.5b": (None, 1_345_537_600)}
ARCH_TRAIN_STEPS = 3         # on one batch
# quantized AdamW damps its first updates (its v starts at 0.25: ROADMAP
# queue C), so that at 1e-3 gemma3's bf16 weights barely move in 3 steps
TRAIN_LR = 1e-2
# the STE steps held against each other and their oracles: full width on
# the batch, and each CUDA backend against its oracle on a cut batch
STE_PAIR = ("approx_deficit_pallas", "approx_rank1_pallas")
ORACLE_PAIRS = (("approx_deficit_pallas", "approx_lut"),
                ("approx_stage1_pallas", "approx_stage1"))
CUT_BATCH = (1, 16)


class CheckpointRecorder:
    """For the length of a ``with``, wraps repro_torch.train.checkpoint's
    ``CheckpointManager.save`` and ``_write``: each save's blocking seconds
    (the host copy, after waiting on the previous save), and each write's
    seconds, bytes and host copies (the tensors as saved), by step."""

    def __init__(self, CK):
        self.CK = CK
        self.save_s, self.write_s, self.bytes, self.host = {}, {}, {}, {}

    def __enter__(self):
        M = self.CK.CheckpointManager
        self.saved = (M.save, M._write)
        rec = self

        def save(mgr, step, tree):
            t0 = time.perf_counter()
            rec.saved[0](mgr, step, tree)
            rec.save_s[step] = time.perf_counter() - t0

        def write(mgr, step, host):
            t0 = time.perf_counter()
            rec.saved[1](mgr, step, host)
            rec.write_s[step] = time.perf_counter() - t0
            rec.bytes[step] = sum(a.nbytes for _, a, _ in host)
            rec.host[step] = host

        M.save, M._write = save, write
        return self

    def __exit__(self, *exc):
        M = self.CK.CheckpointManager
        M.save, M._write = self.saved
        return False


def _train_batches(toks, stamps):
    """Batches of TRAIN_BATCH rows of ``toks`` in turn, stamping the host
    clock at each draw: a step of the loop ends with its loss on the
    host, so the gaps are whole steps."""
    i = 0
    while True:
        stamps.append(time.perf_counter())
        rows = toks[(i * TRAIN_BATCH) % len(toks):][:TRAIN_BATCH]
        yield {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
        i += 1


def train_loop_check(torch, dev: str, full: bool) -> dict:
    """Part (a): the fault-tolerant loop on smollm-135m at its published
    width (``full``; else the 2-layer, 64-wide smollm on the CPU): QAT,
    quantized AdamW, two microbatches. The first run raises after step
    TRAIN_FAIL; the rerun resumes from step 8 and runs 4 steps; every
    leaf restored from step 8 equals the host copy that was saved, bit
    for bit; the loss is finite and falls. Then the example
    (``python -m repro_torch.examples.lm_train``) crashes and reruns once
    in a subprocess."""
    import io
    import shutil
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.models import transformer_lm as TLM
    from repro_torch.nn.module import n_params
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import train_loop as TL

    if full:
        cfg = registry.get("smollm-135m")
        check(n_params(TLM.descs(cfg)) == 134_515_008,
              f"unexpected smollm-135m config {cfg}")
    else:
        cfg = registry.reduced("smollm-135m", n_layers=2, d_model=64,
                               n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                               vocab_pad=256, head_dim=16)
    ocfg = adamw.AdamWConfig(lr=2e-3, quantized_state=True)
    toks = synthetic.token_stream(8 * TRAIN_BATCH, TRAIN_SEQ + 1, cfg.vocab,
                                  seed=0)
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    tc = TL.TrainConfig(steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT,
                        ckpt_dir=str(TRAIN_CKPT_DIR), log_every=1,
                        microbatches=2, qat=True, fail_at_step=TRAIN_FAIL)
    first = []
    log = io.StringIO()
    with CheckpointRecorder(CK) as rec:
        try:
            with contextlib.redirect_stdout(log):
                TL.train(cfg, ocfg, tc, _train_batches(toks, first),
                         seed=0, device=dev)
        except RuntimeError as e:
            check(f"injected failure at step {TRAIN_FAIL}" in str(e),
                  f"train loop: unexpected failure {e}")
        else:
            check(False, "train loop: the injected failure did not raise")
        out = TL.train(cfg, ocfg, dataclasses.replace(tc, fail_at_step=-1),
                       _train_batches(toks, []), seed=0, device=dev)
    first_losses = [float(v) for v in re.findall(
        r"\[train\] step +\d+ loss (\S+)", log.getvalue())]
    check(len(first_losses) == TRAIN_FAIL,
          f"train loop: {len(first_losses)} logged losses before the crash")
    check(sorted(rec.write_s) == [4, 8, 12],
          f"train loop: saved steps {sorted(rec.write_s)}")
    check(out["resumed_from"] == 8 and len(out["losses"]) == 4,
          f"train loop: resumed from {out['resumed_from']} with "
          f"{len(out['losses'])} losses")
    losses = first_losses + out["losses"]
    check(all(np.isfinite(losses)), f"train loop: loss not finite {losses}")
    check(out["losses"][-1] < first_losses[0],
          f"train loop: loss did not fall {losses}")

    # every leaf of step 8, restored onto the device, against its host copy
    like = {"params": out["params"], "opt": out["opt_state"]}
    _sync(torch, dev)
    t0 = time.perf_counter()
    restored = CK.CheckpointManager(TRAIN_CKPT_DIR).restore(8, like)
    _sync(torch, dev)
    restore_s = time.perf_counter() - t0
    from repro_torch.optim.adamw import flatten
    pairs = flatten(restored)
    saved = rec.host[8]
    check([n for n, _, _ in saved] == ["/".join(map(str, p))
                                       for p, _ in pairs],
          "train loop: the restored leaves are not the saved ones")
    dtypes = set()
    for (path, t), (name, arr, dtype) in zip(pairs, saved):
        check(t.device.type == dev, f"{name} restored on {t.device}")
        got, got_dtype = CK._to_numpy(t)
        check(got_dtype == dtype and got.shape == arr.shape
              and np.array_equal(got.view(np.uint8), arr.view(np.uint8)),
              f"train loop: {name} restored from step 8 differs from the "
              "tensor saved")
        dtypes.add(dtype)
    check({"bfloat16", "int8", "int32", "float32"} <= dtypes,
          f"train loop: the checkpoint holds only {sorted(dtypes)}")
    del restored, like
    gaps = [(b - a) * 1e3 for a, b in zip(first, first[1:])]
    line = {"config": {"arch": cfg.name, "params": n_params(TLM.descs(cfg)),
                       "param_dtype": str(cfg.param_dtype),
                       "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                       "microbatches": 2, "qat": True, "lr": ocfg.lr,
                       "quantized_state": True, "steps": TRAIN_STEPS,
                       "ckpt_every": TRAIN_CKPT, "fail_at_step": TRAIN_FAIL},
            "losses_before_crash": first_losses,
            "losses_after_resume": out["losses"],
            "resumed_from": out["resumed_from"],
            "step_ms_host": gaps, "ms_per_step": statistics.median(gaps),
            "save": {"step": 8, "blocking_s": rec.save_s[8],
                     "write_s": rec.write_s[8], "bytes": rec.bytes[8]},
            "restore": {"step": 8, "s": restore_s, "bytes": rec.bytes[8],
                        "leaves": len(pairs), "bitwise": True,
                        "dtypes": sorted(dtypes)}}
    print(f"  train loop {cfg.name}: crashed after step {TRAIN_FAIL}, "
          f"resumed from step {out['resumed_from']}; loss "
          f"{first_losses[0]:.4f} -> {out['losses'][-1]:.4f}; "
          f"{line['ms_per_step']:.1f} ms per step (host, median of "
          f"{len(gaps)}); save of step 8: {rec.bytes[8]:,} bytes, "
          f"{rec.save_s[8]:.3f} s blocking + {rec.write_s[8]:.3f} s "
          f"written; restore {restore_s:.3f} s; all {len(pairs)} leaves "
          f"({', '.join(sorted(dtypes))}) bitwise the saved ones",
          flush=True)
    del out
    if dev == "cuda":
        torch.cuda.empty_cache()

    # the example, once, in a subprocess
    ex_dir = ROOT / "build" / "lm_train_example"
    shutil.rmtree(ex_dir, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.examples.lm_train",
           "--model-scale", "100m" if full else "tiny", "--crash",
           "--steps", str(EXAMPLE_STEPS), "--ckpt-dir", str(ex_dir),
           "--device", dev]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         env=env, cwd=ROOT)
    ex_s = time.perf_counter() - t0
    m = re.search(r"final loss (\S+) \(resumed_from=(\w+)\)", res.stdout)
    check(res.returncode == 0 and m is not None
          and "crashed as requested" in res.stdout,
          f"lm_train example failed (exit {res.returncode}): "
          f"{res.stdout[-2000:]} {res.stderr[-2000:]}")
    check(np.isfinite(float(m.group(1))) and m.group(2) == "None",
          f"lm_train example: {m.group(0)}")
    line["example"] = {"cmd": " ".join(cmd[1:]), "s": ex_s,
                       "final_loss": float(m.group(1)),
                       "resumed_from": m.group(2)}
    print(f"  python {' '.join(cmd[1:3])} --model-scale "
          f"{'100m' if full else 'tiny'} --crash --steps {EXAMPLE_STEPS}: "
          f"exit 0 in {ex_s:.1f} s, {m.group(0)}", flush=True)
    return line


def _grads_equal(torch, label: str, a: tuple, b: tuple, names: tuple) -> int:
    """The loss and every gradient leaf of run ``a`` equal run ``b``'s, bit
    for bit; returns the number of leaves."""
    from repro_torch.optim.adamw import flatten
    (la, ga), (lb, gb) = a, b
    check(torch.equal(la, lb), f"{label}: {names[0]}'s loss {float(la)!r} "
          f"differs from {names[1]}'s {float(lb)!r}")
    fa, fb = flatten(ga), flatten(gb)
    bad = ["/".join(map(str, p)) for (p, x), (_, y) in zip(fa, fb)
           if x.dtype != y.dtype or not torch.equal(x, y)]
    check(not bad, f"{label}: {names[0]}'s gradients differ from "
          f"{names[1]}'s at {bad}")
    return len(fa)


def train_arch_check(torch, dev: str, full: bool, arch: str,
                     launches: dict) -> dict:
    """Part (b), one arch: ARCH_TRAIN_STEPS ``make_train_step(qat=True)``
    steps (quantized AdamW, bf16 parameters from seed 0) with a finite,
    falling loss, their ms, one profiled step, the peak memory and (MoE)
    the aux loss; then the loss and gradients of one STE step (qat off)
    under approx_deficit_pallas and approx_rank1_pallas on the same batch,
    bitwise equal, and on a cut batch each CUDA backend against its
    oracle, bitwise; the kernel launches of the STE steps counted into
    ``launches``."""
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.kernels import approx_matmul as K
    from repro_torch.models import transformer_lm as TLM
    from repro_torch.nn.module import n_params
    from repro_torch.optim import adamw
    from repro_torch.quant.quantize import for_lm
    from repro_torch.train import steps as ST
    from repro_torch.train.cnn_train import training_numerics, value_and_grad

    depth, n_want = TRAIN_ARCHS[arch]
    if full:
        cfg = registry.get(arch)
        if depth:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        check(n_params(TLM.descs(cfg)) == n_want and cfg.remat
              and cfg.param_dtype == torch.bfloat16,
              f"unexpected {arch} training config {cfg}")
    else:
        cfg = registry.reduced(arch, param_dtype=torch.bfloat16, remat=True)
    label = f"{arch} L{cfg.n_layers}"
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params, init = _init_arch(torch, TLM, cfg, dev)
    ocfg = adamw.AdamWConfig(lr=TRAIN_LR, quantized_state=True)
    opt = adamw.init(params, ocfg)
    step = ST.make_train_step(cfg, ocfg, qat=True)
    toks = synthetic.token_stream(4 * TRAIN_BATCH, TRAIN_SEQ + 1, cfg.vocab,
                                  seed=0)

    def batch(i, rows=TRAIN_BATCH, seq=TRAIN_SEQ):
        t = toks[i * TRAIN_BATCH:i * TRAIN_BATCH + rows]
        return {"tokens": torch.as_tensor(t[:, :seq], device=dev),
                "labels": torch.as_tensor(t[:, 1:seq + 1], device=dev)}

    losses, stamps = [], []
    b = batch(0)        # one batch: the loss falls with no batch noise
    for _ in range(ARCH_TRAIN_STEPS):
        stamps.append(_stamp(torch, dev))
        params, opt, metrics = step(params, opt, b)
        losses.append(metrics["loss"])
    stamps.append(_stamp(torch, dev))
    step_ms = _gaps_ms(torch, dev, stamps)
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"{label}: loss not finite {losses}")
    check(losses[-1] < losses[0], f"{label}: loss did not fall {losses}")
    row = {"config": {"arch": arch, "n_layers": cfg.n_layers,
                      "blocks": cfg.blocks(), "d_model": cfg.d_model,
                      "vocab": cfg.vocab, "params": n_params(TLM.descs(cfg)),
                      "param_dtype": str(cfg.param_dtype),
                      "remat": cfg.remat, "batch": TRAIN_BATCH,
                      "seq": TRAIN_SEQ, "lr": ocfg.lr,
                      "quantized_state": True, "seed": ARCH_SEED},
           **init, "losses": losses, "step_ms": step_ms}
    if cfg.n_experts:
        with torch.no_grad():
            b = batch(0)
            _, _, aux = TLM.backbone(params, TLM.embed_tokens(
                params, b["tokens"], cfg), cfg, qat=True)
        row["moe_aux_loss"] = float(aux)
    if dev == "cuda":
        b = batch(ARCH_TRAIN_STEPS)
        prof = _profile_ms(torch, lambda: step(params, opt, b))
        med = statistics.median(step_ms)
        row.update({"ms_per_step": med, **prof,
                    "idle_share": 1 - prof["device_busy_ms"] / med,
                    "peak_memory_gb":
                        torch.cuda.max_memory_allocated() / 2 ** 30})
    print(f"  {label} ({row['config']['params']:,} params, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, QAT): loss "
          + " -> ".join(f"{v:.4f}" for v in losses)
          + (f", MoE aux {row['moe_aux_loss']:.6f}" if cfg.n_experts
             else "")
          + (f"; steps {', '.join(f'{v:.1f}' for v in step_ms)} ms; "
             f"profiled step: busy {row['device_busy_ms']:.1f} ms, idle "
             f"{row['idle_share']:.2f}, {row['device_ops']} device ops; "
             f"peak {row['peak_memory_gb']:.2f} GiB" if dev == "cuda"
             else ""), flush=True)
    del opt, step
    if dev == "cuda":
        torch.cuda.empty_cache()

    # the STE steps: qat off, the projections through the backends
    def ste(backend, b):
        c = dataclasses.replace(cfg, quant=for_lm(backend))
        _sync(torch, dev)
        t0 = time.perf_counter()
        with training_numerics():
            out = value_and_grad(
                lambda p, bb: TLM.forward_loss(p, bb, c, qat=False,
                                               training=True), params, b)
        _sync(torch, dev)
        return out, time.perf_counter() - t0

    ste_s = {}
    K.reset_launch_counts()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        b = batch(0)
        runs = {}
        for be in STE_PAIR:
            runs[be], ste_s[be] = ste(be, b)
        n_leaves = _grads_equal(torch, label, runs[STE_PAIR[0]],
                                runs[STE_PAIR[1]], STE_PAIR)
        row["ste"] = {"loss": float(runs[STE_PAIR[0]][0]),
                      "leaves_bitwise": n_leaves, "s": dict(ste_s)}
        del runs
        cut = batch(0, *CUT_BATCH)
        for be, oracle in ORACLE_PAIRS:
            a, ste_s[be + " cut"] = ste(be, cut)
            o, ste_s[oracle + " cut"] = ste(oracle, cut)
            _grads_equal(torch, f"{label} cut batch", a, o, (be, oracle))
            del a, o
    finally:
        torch.use_deterministic_algorithms(False)
    for key, n in launch_counts(K).items():
        launches[key] += n
    row["ste"]["cut_batch"] = list(CUT_BATCH)
    row["ste"]["s"] = ste_s
    print(f"  {label} STE steps (qat off, deterministic): "
          f"{STE_PAIR[0]} == {STE_PAIR[1]} in the loss and all "
          f"{n_leaves} gradient leaves, bit for bit; cut batch "
          f"{CUT_BATCH[0]} x {CUT_BATCH[1]}: "
          + ", ".join(f"{a} == {o}" for a, o in ORACLE_PAIRS)
          + "; seconds " + ", ".join(f"{k} {v:.1f}" for k, v in
                                     ste_s.items()), flush=True)
    return row


def train_phase(torch, detail, dev: str, full: bool) -> tuple:
    """Phase 12 (see the module docstring): the train loop (part a) and
    each arch's training steps (part b). Returns the train line and the
    STE steps' kernel launches (the 'train' path)."""
    from repro_torch.kernels import approx_matmul as K

    launches = {key: 0 for key in launch_counts(K)}
    out = {"loop": train_loop_check(torch, dev, full)}
    for arch in TRAIN_ARCHS:
        out[arch] = train_arch_check(torch, dev, full, arch, launches)
        if dev == "cuda":
            torch.cuda.empty_cache()
    detail["train"] = out
    return out, launches


if __name__ == "__main__":
    sys.exit(main())
