// Approximate-multiplier integer matmuls for Hopper (sm_90a) on the CUDA
// cores: the DEFICIT and STAGE1 bodies of the JAX package's Pallas module
// src/repro/kernels/approx_matmul.py (the EXACT and RANK1 bodies run on the
// int8 tensor cores, in tc_matmul.cu):
//
//   approx_matmul_pallas       (kernel="deficit" | "stage1")  -> BODY_DEFICIT,
//                                                                BODY_STAGE1, int32 out
//   fused_matmul_pallas        (variant="deficit" | "stage1") -> same bodies,
//                                                                f32 epilogue out
//
// out[r, n] = sum_k P(x[r, k], w[k, n]) for int8 operands in [-127, 127],
// where P is the exact product minus the design's error term:
//   DEFICIT  sign(x) sign(w) deficit_sum(|x|, |w|), evaluated as the
//            straight-line integer program that kernels/codegen.py generates
//            from core/deficit.py (deficit_gen.cuh; 206 operations for the
//            proposed design, up to 889 for the others). No 64K-entry table.
//   STAGE1   sign(x) sign(w) sum over the 7 STAGE1_SITES of
//            window(|x|) window(|w|) << col: each operand's 7 window ANDs are
//            packed into a feature mask once when its tile is staged, so a
//            pair costs one AND plus the weighted bit sum.
//
// What bounds it on this card: integer work on the CUDA cores, not bytes.
// Per multiply-accumulate nvcc (CUDA 12.8) emits 160 integer instructions
// that combine both operands for the DEFICIT body (proposed design) and 16
// for STAGE1, as kernels/sass.py counts them in the SASS; the operands are
// int8, so a 64x64x32 tile reuses each
// staged byte 64 times. The design answers with a register tile of 4x4
// outputs per thread: each staged operand is read from shared memory once
// per 16 pairs, and the pair work is register arithmetic, in which nvcc can
// hoist each operand's own bit extraction out of the pair loop.
//
// Parallelism: one block per 64x64 output tile, 256 threads; each block
// loops over K itself in steps of 32 (blocks run in any order, nothing
// carries between them). Ragged edges are masked loads of zero, and a zero
// operand contributes exactly 0 under every body. The (B, M) rows of the
// batched entries are one row axis: w is shared.
//
// Integer arithmetic: accumulators are uint32_t and cast to int32 at the
// end. Signed overflow and left shifts of negative values are undefined in
// C++; the sums wrap modulo 2^32 as the reference's int32 sums do.
//
// Epilogue rounding: __fadd_rn(__fmul_rn(__int2float_rn(acc), scale[n]),
// bias[n]), then fmaxf(., 0) for the ReLU. This rounds twice, as the
// reference's separate multiply and add do; the _rn intrinsics keep nvcc
// from contracting them into one FMA. So the fused output equals
// float32(acc) * scale + bias computed as two separate float32 operations,
// bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

#include "deficit_gen.cuh"

namespace {

enum Body { BODY_DEFICIT = 0, BODY_STAGE1 = 1 };
enum OutKind { OUT_INT32 = 0, OUT_F32 = 1, OUT_F32_RELU = 2 };

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 32;   // contraction step staged in shared memory
constexpr int TM = 4;    // output rows per thread (strided by BM / TM)
constexpr int TN = 4;    // output columns per thread (strided by BN / TN)
constexpr int TY = BM / TM;
constexpr int TX = BN / TN;
constexpr int THREADS = TX * TY;

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

template <int BODY, int DESIGN>
__global__ void __launch_bounds__(THREADS)
approx_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 int rows, int K, int N,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, int out_kind,
                 void* __restrict__ out) {
  // x tile stored k-major (transposed) with one int of padding, so the
  // transposing store from row-major x is free of bank conflicts
  __shared__ int xs[BK][BM + 1];
  __shared__ int ws[BK][BN];
  constexpr int FK = BODY == BODY_STAGE1 ? BK : 1;
  __shared__ int xf[FK][BM + 1];
  __shared__ int wf[FK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int col0 = blockIdx.y * BN;

  uint32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const long long gr = row0 + r;
      const int gk = k0 + c;
      const int v = (gr < rows && gk < K) ? x[gr * K + gk] : 0;
      xs[c][r] = v;
      if constexpr (BODY == BODY_STAGE1) xf[c][r] = stage1_x_features(abs(v));
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gc = col0 + c;
      const int v = (gk < K && gc < N)
                        ? w[static_cast<long long>(gk) * N + gc] : 0;
      ws[r][c] = v;
      if constexpr (BODY == BODY_STAGE1) wf[r][c] = stage1_w_features(abs(v));
    }
    __syncthreads();

#pragma unroll 1
    for (int kk = 0; kk < BK; ++kk) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + TY * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + TX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] += static_cast<uint32_t>(a[i] * b[j]);

      if constexpr (BODY == BODY_DEFICIT) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int d = deficit_fn<DESIGN>(abs(a[i]), abs(b[j]));
            acc[i][j] -= static_cast<uint32_t>(sgn(a[i]) * sgn(b[j]) * d);
          }
      } else {
        int fa[TM], fb[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) fa[i] = xf[kk][ty + TY * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) fb[j] = wf[kk][tx + TX * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int corr = stage1_correction(fa[i] & fb[j]);
            acc[i][j] -= static_cast<uint32_t>(sgn(a[i]) * sgn(b[j]) * corr);
          }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long gr = row0 + ty + TY * i;
    if (gr >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx + TX * j;
      if (gc >= N) continue;
      const int v = static_cast<int>(acc[i][j]);
      if (out_kind == OUT_INT32) {
        static_cast<int32_t*>(out)[gr * N + gc] = v;
      } else {
        float f = __fadd_rn(__fmul_rn(__int2float_rn(v), scale[gc]), bias[gc]);
        if (out_kind == OUT_F32_RELU) f = fmaxf(f, 0.0f);
        static_cast<float*>(out)[gr * N + gc] = f;
      }
    }
  }
}

struct Args {
  const int8_t* x;
  const int8_t* w;
  int rows, K, N;
  const float* scale;
  const float* bias;
  int out_kind;
  void* out;
};

template <int BODY, int DESIGN>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.rows + BM - 1) / BM, (a.N + BN - 1) / BN);
  approx_mm_kernel<BODY, DESIGN><<<grid, THREADS, 0, stream>>>(
      a.x, a.w, a.rows, a.K, a.N, a.scale, a.bias, a.out_kind, a.out);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_deficit(int design, const Args& a, cudaStream_t stream) {
  if constexpr (D < DEFICIT_N_DESIGNS) {
    if (design == D) return launch<BODY_DEFICIT, D>(a, stream);
    return launch_deficit<D + 1>(design, a, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t: 0 on a successful launch. The kernel runs on
// `stream`, allocates nothing and does not synchronise.
extern "C" int approx_mm_launch(int body, int design, const void* x,
                                const void* w, int rows, int K, int N,
                                const void* scale, const void* bias,
                                int out_kind, void* out, void* stream) {
  if (rows == 0 || N == 0) return cudaSuccess;
  if (rows < 0 || K < 0 || N < 0 || out_kind < OUT_INT32 ||
      out_kind > OUT_F32_RELU)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
               rows, K, N, static_cast<const float*>(scale),
               static_cast<const float*>(bias), out_kind, out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case BODY_DEFICIT: return launch_deficit<0>(design, a, s);
    case BODY_STAGE1: return launch<BODY_STAGE1, 0>(a, s);
    default: return cudaErrorInvalidValue;
  }
}
