// Int8 tensor-core matmuls for Hopper (sm_90a): the EXACT and RANK1 bodies
// of the JAX package's Pallas module src/repro/kernels/approx_matmul.py:
//
//   fused_matmul_pallas(variant="exact")   -> BODY_EXACT, f32 epilogue out
//   rank1_matmul_pallas                     -> BODY_RANK1, int32 out
//   rank1_fused_matmul_pallas               -> BODY_RANK1, f32 epilogue out
//
// EXACT   out[r, n] = sum_k x[r, k] w[k, n], int8 operands.
// RANK1   the exact dot minus the rank-factored correction
//         sum_{k, r'} u[x[r, k] & 0xFF][r'] v[r'][w[k, n] & 0xFF] of
//         core/factor.py: u in {-1, 0, 1} and v split into two balanced
//         base-128 int8 digit planes, v = p0 + 128 p1. So the correction is
//         two int8 GEMMs over a contraction of width K * Rp, the exact dot
//         one more over K, and all three run on the int8 tensor cores.
//
// Operands, as the wrapper (kernels/approx_matmul.py) prepares them per call:
//   x       (rows, K) int8, row-major, as the caller holds it;
//   w_op    (N, K) int8: w transposed to K-major (the tensor cores take B
//           only K-major for 8-bit types);
//   planes  (2 * N, f_ld) int8: row d * N + n holds digit plane d of
//           v[:, w[:, n] & 0xFF] in feature order k * Rp + r', with R
//           padded to Rp, a multiple of 4, by zero factors; f_ld >= K * Rp
//           and the features past K * Rp are zero (the wrapper pads K to a
//           multiple of 4, so that f_ld is a multiple of 16 bytes);
//   u_tab   (256, Rp) int8: u_signed, zero columns past R.
// None is padded to the kernel's tiles: the copies into shared memory fill
// the rows past N and the bytes past the end of a row with zeros, and a
// zero operand adds 0. This file owns every tile size and picks the block
// width from N.
//
// The x side of the correction, the (rows, K * Rp) feature matrix, never
// touches device memory (it would be 462 MB at FFDNet's middle layer):
// each block stages its x rows and the 256 x Rp table in shared memory and
// builds every A fragment in registers, where wgmma takes A. A fragment
// register holds 4 consecutive features of one row, and since Rp is a
// multiple of 4 those are 4 factors r'..r'+3 of one operand x[r, k]: one
// byte load of x and one 4-byte load of the table per register, and no
// shared-memory round trip for the expanded operand. The table is staged
// negated, so the digit-0 correction accumulates into the exact dot's
// fragments:
//   acc0 = x . w + (-u) . p0,  acc1 = (-u) . p1,  out = acc0 + (acc1 << 7)
// in uint32_t, wrapping modulo 2^32 as the reference's int32 sum does. The
// MMAs accumulate s32 without .satfinite, so they wrap too. Both digit
// planes are one B of width 2 * BN, so one wgmma serves both.
//
// x is staged in slabs of at most XK_MAX columns of K, so shared memory
// does not grow with K: for each slab the block runs the exact dot's
// chunks over the slab's columns and then the correction's chunks whose
// first feature falls in them (a chunk of KS features spans at most
// KS / 32 + 1 columns, so a slab stages 32 columns past its own). Layers
// with K <= XK_MAX (all of LeNet-5's and FFDNet's) stage x once.
//
// Instruction: wgmma.mma_async m64nNk32 .s32.s8.s8 (IGMMA in the SASS),
// N = BN for the exact dot and 2 * BN for the correction; A from registers,
// B from shared memory through a descriptor, in the no-swizzle K-major
// layout (8-row x 16-byte core matrices, LBO between the two 16-byte
// halves of a 32-byte step, SBO between 8-row groups). The A fragments of
// a ring stage are built in registers while the previous stage's wgmmas
// run. ptxas still reports (C7513) that it serializes the wgmmas because
// registers they read are written between them; measured on the H100 this
// kernel is nonetheless faster than the same design on mma.sync (IMMA).
//
// What bounds it on this card: the int8 tensor cores are the bound of the
// function (FFDNet's middle layer needs 99 int8 MACs per (x, w) pair for
// RANK1, 1 for EXACT; bytes bound EXACT), but this kernel is held back by
// streaming B. B (w_op or the planes: 3.8 MB at FFDNet's middle layer)
// streams from L2 through a ring of STAGES chunks of KS bytes per row,
// loaded with cp.async (16-byte copies where the row length allows, else
// 4-byte copies, else byte loads), and every block reads all of it. The
// design answers with 128-row blocks (two warpgroups share each B stage,
// halving the L2 traffic of 64-row blocks), per-thread copy addresses set
// once, and a starting chunk that differs per block, so that the blocks do
// not all queue on the same L2 lines.
//
// Parallelism: one block of two warpgroups per 128 x BN output tile, each
// warpgroup 64 rows; BN in {8, 16, 32, 64}, the narrowest that holds N, so
// a narrow layer (FFDNet's N = 4) computes an 8-column tile, not a
// 64-column one. FFDNet's 16,384-row layers give 128 blocks, about one per
// SM. Blocks run in any order; each loops over the contraction itself.
//
// Epilogue rounding: __fadd_rn(__fmul_rn(__int2float_rn(acc), scale[n]),
// bias[n]), then fmaxf(., 0) for the ReLU, as in approx_matmul.cu, so the
// fused output equals the unfused PyTorch composition bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

enum Body { BODY_EXACT = 0, BODY_RANK1 = 1 };
enum OutKind { OUT_INT32 = 0, OUT_F32 = 1, OUT_F32_RELU = 2 };

constexpr int BM = 128;         // output rows per block: two wgmma M
constexpr int KS = 128;         // contraction bytes per ring stage
constexpr int STAGES = 3;       // ring depth
constexpr int THREADS = 256;    // two warpgroups
constexpr int DIGITS = 2;       // base-128 digit planes of v
constexpr int DIGIT_SHIFT = 7;
constexpr int XK_MAX = 1024;    // columns of K per staged x slab
constexpr int SMEM_MAX = 227 * 1024;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Block width: the narrowest instantiated tile that holds N, else 64.
int block_n(int n) { return n <= 8 ? 8 : n <= 16 ? 16 : n <= 32 ? 32 : 64; }

// Columns of a staged x slab of xk columns of K: RANK1 reaches up to 4
// past the slab (see above). A multiple of 32, so that the row stride
// (x_cols + 16 bytes) spreads the 8 rows of a fragment over distinct banks.
__host__ __device__ constexpr int x_cols(int body, int xk) {
  return xk + (body == BODY_RANK1 ? 32 : 0);
}

size_t smem_bytes(int body, int bn, int xk, int rp) {
  const int nd = body == BODY_RANK1 ? DIGITS : 1;
  size_t b = static_cast<size_t>(STAGES) * nd * bn * KS;
  b += static_cast<size_t>(BM) * (x_cols(body, xk) + 16);
  if (body == BODY_RANK1) b += 256 * static_cast<size_t>(rp);
  return b;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

// The widest copy every row of an operand with rows of ld bytes allows:
// 16 or 4 bytes of cp.async where each row start is so aligned, else 1
// (byte loads through registers).
__device__ __forceinline__ int copy_width(const void* p, long long ld) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (ld % 16 == 0 && a % 16 == 0) return 16;
  if (ld % 4 == 0 && a % 4 == 0) return 4;
  return 1;
}

// 16 bytes of a row into shared memory, of which the first `rem` exist
// (rem <= 0: none, and src is only a valid address); the rest are zero.
// For widths 16 and 4, rem is a multiple of the width.
template <int WIDTH>
__device__ __forceinline__ void copy16(unsigned char* dst,
                                       const int8_t* src, int rem) {
  if constexpr (WIDTH == 16) {
    cp_async16(dst, src, rem > 0);
  } else if constexpr (WIDTH == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cp_async4(dst + 4 * i, rem > 4 * i ? src + 4 * i : src, rem > 4 * i);
  } else {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < rem)
        v[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[i]))
                    << (8 * (i % 4));
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Shared-memory matrix descriptor: no swizzle, K-major. Addresses and
// offsets in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// D (64 x N, s32, in registers) += A (64 x 32 s8, registers) B (N x 32 s8,
// shared memory); d holds N / 2 values per thread.
template <int N> struct Wgmma;

template <> struct Wgmma<8> {
  template <int M>
  __device__ __forceinline__ static void run(uint32_t (&d)[M],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    static_assert(M >= 4, "accumulator too small");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(1));
  }
};

template <> struct Wgmma<16> {
  template <int M>
  __device__ __forceinline__ static void run(uint32_t (&d)[M],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    static_assert(M >= 8, "accumulator too small");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(1));
  }
};

template <> struct Wgmma<32> {
  template <int M>
  __device__ __forceinline__ static void run(uint32_t (&d)[M],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    static_assert(M >= 16, "accumulator too small");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(1));
  }
};

template <> struct Wgmma<64> {
  template <int M>
  __device__ __forceinline__ static void run(uint32_t (&d)[M],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    static_assert(M >= 32, "accumulator too small");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(1));
  }
};

template <> struct Wgmma<128> {
  template <int M>
  __device__ __forceinline__ static void run(uint32_t (&d)[M],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    static_assert(M >= 64, "accumulator too small");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(1));
  }
};

template <int BODY, int BN>
__global__ void __launch_bounds__(THREADS)
tc_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w_op,
             const int8_t* __restrict__ planes,
             const int8_t* __restrict__ u_tab, int rows, int K, int N,
             int xk, int rp, int f_ld, const float* __restrict__ scale,
             const float* __restrict__ bias, int out_kind,
             void* __restrict__ out) {
  constexpr int ND = BODY == BODY_RANK1 ? DIGITS : 1;  // accumulator sets
  constexpr int NB = ND * BN;                          // B rows per stage
  constexpr int SBO = KS * 8;   // bytes between 8-row core-matrix groups
  constexpr int LBO = 128;      // bytes between K-adjacent core matrices

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* bs = smem;                                   // B ring
  unsigned char* xs = bs + STAGES * NB * KS;                  // x slab
  const int xcols = x_cols(BODY, xk);
  const int xstride = xcols + 16;
  unsigned char* us = xs + BM * xstride;                      // -u table

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  const int r16 = warp * 16 + g;   // this lane's first row in the block
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int col0 = blockIdx.y * BN;

  if constexpr (BODY == BODY_RANK1) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(u_tab);
    for (int e = tid; e < 64 * rp; e += THREADS)
      reinterpret_cast<uint32_t*>(us)[e] = __vneg4(src[e]);
  }

  // The block's x rows over columns [kb, kb + xcols), zero past `rows` and
  // K: 4-byte cp.async where rows are 4-byte aligned, else byte loads.
  const bool vec4 = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  auto stage_x = [&](int kb) {
    for (int e = tid; e < BM * (xcols / 4); e += THREADS) {
      const int r = e / (xcols / 4), c = kb + e % (xcols / 4) * 4;
      const long long gr = row0 + r;
      const bool in = gr < rows && c < K;
      const int8_t* p = x + (in ? gr * K + c : 0);
      unsigned char* dst = xs + r * xstride + (c - kb);
      if (vec4) {
        cp_async4(dst, p, in);
      } else {
        uint32_t v = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (in && c + i < K)
            v |= static_cast<uint32_t>(static_cast<uint8_t>(p[i])) << (8 * i);
        *reinterpret_cast<uint32_t*>(dst) = v;
      }
    }
    cp_async_commit();
    cp_async_wait<0>();   // landed; phase() syncs the block
  };

  uint32_t acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0u;

  // One phase: stream NW rows of B (row d * N + col0 + n, n < BN, rows of
  // ld bytes) through the ring over chunks [c_lo, c_hi) of KS bytes, in
  // core-matrix order, and run one m64 nNW k32 wgmma per 32-byte step with
  // the A fragments that `afrag(k0, s, a)` builds for step s of the chunk
  // at byte k0. A chunk's fragments are built while the previous chunk's
  // wgmmas run (two register buffers). Each block starts at its own chunk
  // and wraps around: the sums are integers, so the order does not change
  // them, and blocks that read the same B at the same time would all queue
  // on the same L2 lines. WIDTH is copy_width(B, ld).
  auto ring = [&](auto nw, auto width, const int8_t* __restrict__ B, int ld,
                  int c_lo, int c_hi, auto&& afrag) {
    constexpr int NW = decltype(nw)::value;
    constexpr int WIDTH = decltype(width)::value;
    constexpr int STEPS = KS / 32;
    const int nchunks = c_hi - c_lo;
    const int rot = (blockIdx.x + 7 * blockIdx.y) % nchunks;
    auto rotated = [&](int c) {
      return c_lo + (c + rot < nchunks ? c + rot : c + rot - nchunks);
    };
    // a thread copies the same 16-byte pieces of every chunk: their
    // sources and destinations are set once; THREADS is a multiple of the
    // KS / 16 pieces of a row, so a thread's pieces share one column
    constexpr int PIECES = (NW * (KS / 16) + THREADS - 1) / THREADS;
    const int col = tid % (KS / 16) * 16;
    const int8_t* src[PIECES];
    uint32_t dst[PIECES];
    bool ok[PIECES];
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {
      const int row = (tid + i * THREADS) / (KS / 16);
      const int d = row / BN, n = row % BN;
      ok[i] = row < NW && col0 + n < N;
      src[i] = B + (ok[i] && col < ld
                    ? (static_cast<long long>(d) * N + col0 + n) * ld + col
                    : 0);
      dst[i] = (row / 8) * SBO + (col / 16) * LBO + (row % 8) * 16;
    }
    auto load = [&](int slot, int ci) {
      unsigned char* stage = bs + slot * NB * KS;
      const int off = rotated(ci) * KS;
      const int rem = ld - off - col;   // bytes of the row from this piece
#pragma unroll
      for (int i = 0; i < PIECES; ++i)
        if (tid + i * THREADS < NW * (KS / 16)) {
          const bool in = ok[i] & (rem > 0);
          copy16<WIDTH>(stage + dst[i], src[i] + (in ? off : 0),
                        in ? rem : 0);
        }
    };
    __syncthreads();   // staged x / table visible; ring free
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nchunks) load(s, s);
      cp_async_commit();
    }
    uint32_t a0[STEPS][4], a1[STEPS][4];
    auto chunk = [&](int c, uint32_t (&ac)[STEPS][4]) {
#pragma unroll
      for (int s = 0; s < STEPS; ++s) afrag(rotated(c) * KS, s, ac[s]);
      wgmma_wait<0>();   // chunk c - 1 is done with its stage and A
      cp_async_wait<STAGES - 2>();
      // cp.async wrote the stage through the generic proxy (byte loads
      // too); wgmma reads it through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (c + STAGES - 1 < nchunks) load((c + STAGES - 1) % STAGES,
                                         c + STAGES - 1);
      cp_async_commit();
      const unsigned char* b = bs + (c % STAGES) * NB * KS;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < STEPS; ++s)
        Wgmma<NW>::run(acc, ac[s], smem_desc(b + s * 2 * LBO, LBO, SBO));
      wgmma_commit();
    };
    // two chunks per trip, so that each register buffer has a fixed name
    for (int c = 0; c < nchunks; c += 2) {
      chunk(c, a0);
      if (c + 1 < nchunks) chunk(c + 1, a1);
    }
    wgmma_wait<0>();
    cp_async_wait<0>();
  };
  // one ring per copy width, so that the chunk loop does not branch on it
  auto phase = [&](auto nw, const int8_t* __restrict__ B, int ld, int c_lo,
                   int c_hi, auto&& afrag) {
    switch (copy_width(B, ld)) {
      case 16:
        ring(nw, std::integral_constant<int, 16>(), B, ld, c_lo, c_hi, afrag);
        break;
      case 4:
        ring(nw, std::integral_constant<int, 4>(), B, ld, c_lo, c_hi, afrag);
        break;
      default:
        ring(nw, std::integral_constant<int, 1>(), B, ld, c_lo, c_hi, afrag);
    }
  };

  const int k_chunks = (K + KS - 1) / KS;
  const int f_chunks =
      static_cast<int>((static_cast<long long>(K) * rp + KS - 1) / KS);
  for (int kb = 0; kb < K; kb += xk) {
    __syncthreads();   // every warp is done with the previous slab
    stage_x(kb);

    // EXACT dot over the slab's columns: A straight from the staged x
    phase(std::integral_constant<int, BN>(), w_op, K, kb / KS,
          min(k_chunks, (kb + xk) / KS),
          [&](int k0, int s, uint32_t (&a)[4]) {
      const unsigned char* p = xs + r16 * xstride + (k0 - kb) + s * 32
                               + tig * 4;
      a[0] = *reinterpret_cast<const uint32_t*>(p);
      a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * xstride);
      a[2] = *reinterpret_cast<const uint32_t*>(p + 16);
      a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * xstride + 16);
    });

    if constexpr (BODY == BODY_RANK1) {
      // the correction's chunks whose first feature k * rp + r' has k in
      // the slab. Feature f = k * rp + r'; this lane's two 4-feature
      // groups of a step start at f = k0 + 32 s + h * 16 + tig * 4
      // (h = 0, 1): divided out at a chunk's first step, then advanced by
      // 32, which moves (k, r') by at most one k since rp >= 32.
      int kh[2], rh[2];
      const uint32_t* ut = reinterpret_cast<const uint32_t*>(us);
      const int rp4 = rp / 4;
      phase(std::integral_constant<int, NB>(), planes, f_ld,
            kb * rp / KS, min(f_chunks, (kb + xk) * rp / KS),
            [&](int k0, int s, uint32_t (&a)[4]) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (s == 0) {
            const int f = k0 + h * 16 + tig * 4;
            kh[h] = f / rp;
            rh[h] = f - kh[h] * rp;
          } else {
            rh[h] += 32;
            if (rh[h] >= rp) { rh[h] -= rp; ++kh[h]; }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {   // j: (row g | g + 8) x (h = 0 | 1)
          const int h = j / 2, rr = r16 + (j % 2) * 8;
          const int xb = xs[rr * xstride + kh[h] - kb];
          a[j] = ut[xb * rp4 + rh[h] / 4];
        }
      });
    }
  }

  // epilogue: acc[4 j + c] is row 16 warp + g + 8 (c / 2), column
  // 8 j + 2 tig + c % 2 of the wgmma's N; digit plane 1 is columns BN..2BN
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long gr = row0 + r16 + (c / 2) * 8;
      const int gc = col0 + j * 8 + tig * 2 + c % 2;
      if (gr >= rows || gc >= N) continue;
      uint32_t v = acc[4 * j + c];
      if constexpr (ND == 2) v += acc[4 * (j + BN / 8) + c] << DIGIT_SHIFT;
      const int iv = static_cast<int>(v);
      if (out_kind == OUT_INT32) {
        static_cast<int32_t*>(out)[gr * N + gc] = iv;
      } else {
        float f = __fadd_rn(__fmul_rn(__int2float_rn(iv), scale[gc]), bias[gc]);
        if (out_kind == OUT_F32_RELU) f = fmaxf(f, 0.0f);
        static_cast<float*>(out)[gr * N + gc] = f;
      }
    }
}

struct Args {
  const int8_t *x, *w_op, *planes, *u_tab;
  int rows, K, N, xk, rp, f_ld;
  const float *scale, *bias;
  int out_kind;
  void* out;
};

template <int BODY, int BN>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.rows + BM - 1) / BM, (a.N + BN - 1) / BN);
  const size_t smem = smem_bytes(BODY, BN, a.xk, a.rp);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      tc_mm_kernel<BODY, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  tc_mm_kernel<BODY, BN><<<grid, THREADS, smem, stream>>>(
      a.x, a.w_op, a.planes, a.u_tab, a.rows, a.K, a.N, a.xk, a.rp, a.f_ld,
      a.scale, a.bias, a.out_kind, a.out);
  return cudaGetLastError();
}

template <int BODY>
cudaError_t launch_bn(const Args& a, cudaStream_t s) {
  switch (block_n(a.N)) {
    case 8: return launch<BODY, 8>(a, s);
    case 16: return launch<BODY, 16>(a, s);
    case 32: return launch<BODY, 32>(a, s);
    default: return launch<BODY, 64>(a, s);
  }
}

}  // namespace

// Returns a cudaError_t: 0 on a successful launch. The kernel runs on
// `stream`, allocates nothing and does not synchronise. `planes` (`nd`
// digit planes, rows of `f_ld` bytes) and `u_tab` (`rp` columns) are read
// only for body 1 (RANK1).
extern "C" int tc_mm_launch(int body, const void* x, const void* w_op,
                            const void* planes, const void* u_tab, int rows,
                            int K, int N, int nd, int rp, int f_ld,
                            const void* scale, const void* bias,
                            int out_kind, void* out, void* stream) {
  if (rows == 0 || N == 0) return cudaSuccess;
  if (rows < 0 || K <= 0 || N < 0 || out_kind < OUT_INT32 ||
      out_kind > OUT_F32_RELU)
    return cudaErrorInvalidValue;
  if (body == BODY_RANK1 &&
      (nd != DIGITS || rp < 32 || rp % 4 ||
       f_ld < static_cast<long long>(K) * rp ||
       static_cast<long long>(round_up(K, XK_MAX) + XK_MAX) * rp >=
           (1LL << 31)))
    return cudaErrorInvalidValue;
  const int xk = round_up(K, KS) < XK_MAX ? round_up(K, KS) : XK_MAX;
  const Args a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w_op),
               static_cast<const int8_t*>(planes),
               static_cast<const int8_t*>(u_tab), rows, K, N, xk, rp, f_ld,
               static_cast<const float*>(scale),
               static_cast<const float*>(bias), out_kind, out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case BODY_EXACT: return launch_bn<BODY_EXACT>(a, s);
    case BODY_RANK1: return launch_bn<BODY_RANK1>(a, s);
    default: return cudaErrorInvalidValue;
  }
}
