// Approximate-multiplier integer matmuls for Hopper (sm_90a) on the CUDA
// cores: the DEFICIT and STAGE1 bodies of the JAX package's Pallas module
// src/repro/kernels/approx_matmul.py (the EXACT and RANK1 bodies run on the
// int8 tensor cores, in tc_matmul.cu):
//
//   approx_matmul_pallas  (kernel="deficit" | "stage1")   int32 out
//   fused_matmul_pallas   (variant="deficit" | "stage1")  f32 epilogue out
//
// out[r, n] = sum_k P(x[r, k], w[k, n]) for int8 operands, where P is the
// exact product minus the design's error term,
//   P(x, w) = x w - sign(x) sign(w) C(|x|, |w|),
// C = deficit_sum (DEFICIT, per design) or the stage-1 site correction
// (STAGE1). One body serves both: C is a 129 x 129 int16 table over |x|,
// |w| in [0, 128] (-128 reaches 128) that the wrapper builds once per
// (function, design, device) and each block stages into shared memory. The
// TPU kernel evaluates the circuit as bit operations because a TPU core has
// no fast gather; on this card that circuit cost 160 integer instructions a
// pair, the table costs 4 (the exact IMAD, the index add, the sign product,
// the fold) and one LDS.S16.
//
// What bounds it on this card: the pair work on the CUDA cores, issue slots
// and shared-memory lookups alike (4 instructions a pair over 128 lanes a
// clock per SM, 1 lookup over 32), not bytes: the operands are int8, so a
// 64x64x32 tile reuses each staged byte 64 times. Lookups can conflict in
// the banks: lanes of a warp that share a row tile read the same |x| row
// with different |w|, and the row stride of 130 int16 (65 words) starts
// row r r banks further on, so lanes that look up equal |w| in different
// rows hit different banks.
//
// The plan. A launch takes a plan (kernels/approx_matmul.py, ``plan``): a
// BM x BN output tile (BM in 4..64 sized to the rows, so decode's 4 rows
// compute no padding rows; BN in 16..64) and a split of K into slices of
// k_slice columns, enough to give every SM a block where the tiles alone
// do not. Block b computes tile (b % col_tiles, b / col_tiles % row_tiles)
// over K slice b / (row_tiles * col_tiles). A plan that does not cover
// every output and every k exactly once is refused. A block runs 256
// threads: 16 over columns (TN = BN / 16 each), BM / 4 over rows (4 each),
// and the rest as KG groups that take interleaved k of each staged step;
// the groups' sums meet in shared memory. Each staged operand is stored
// with its sign and its table offset (row or column), computed once.
//
// Split-K. With one slice a block writes its outputs itself. Otherwise each
// block stores its uint32 partial sums in partial[slice][row][col], then
// counts itself in counters[tile]; the tile's last-arriving block adds the
// slices' partials in slice order, runs the epilogue once per output, and
// sets the counter back to 0 (the wrapper keeps the counters zeroed between
// launches). Integer addition modulo 2^32 is associative, so any split
// gives the bits of the unsplit sum.
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

namespace {

enum OutKind { OUT_INT32 = 0, OUT_F32 = 1, OUT_F32_RELU = 2 };

constexpr int THREADS = 256;
constexpr int BK = 32;               // contraction step staged in shared memory
constexpr int TM = 4;                // output rows per thread (contiguous)
constexpr int TX = 16;               // threads across a tile's columns
constexpr int TABLE_ROWS = 129;      // |x| in [0, 128]
constexpr int TABLE_STRIDE = 130;    // int16 entries per row
constexpr int TABLE_BYTES = (TABLE_ROWS * TABLE_STRIDE * 2 + 15) / 16 * 16;

template <int BM, int BN>
struct Tile {
  static constexpr int TN = BN / TX;            // output columns per thread
  static constexpr int TY = BM / TM;            // threads across the rows
  static constexpr int KG = THREADS / (TX * TY);  // k groups
  static_assert(TN >= 1 && TY >= 1 && KG >= 1 && BK % KG == 0, "tile");
};

template <int BM, int BN>
constexpr int smem_bytes() {
  // the table, then x (value, -sign, row offset) and w (value, sign,
  // column offset)
  return TABLE_BYTES + 3 * BK * (BM + BN) * 4;
}

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

// n contiguous ints from shared memory in one vector load where n allows
template <int n>
__device__ __forceinline__ void load_ints(int (&dst)[n], const int* src) {
  if constexpr (n == 4) {
    const int4 v = *reinterpret_cast<const int4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else if constexpr (n == 2) {
    const int2 v = *reinterpret_cast<const int2*>(src);
    dst[0] = v.x; dst[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i) dst[i] = src[i];
  }
}

__device__ __forceinline__ void store_out(int out_kind, void* out,
                                          long long idx, uint32_t acc,
                                          const float* scale,
                                          const float* bias, int col) {
  const int v = static_cast<int>(acc);
  if (out_kind == OUT_INT32) {
    static_cast<int32_t*>(out)[idx] = v;
  } else {
    float f = __fadd_rn(__fmul_rn(__int2float_rn(v), scale[col]), bias[col]);
    if (out_kind == OUT_F32_RELU) f = fmaxf(f, 0.0f);
    static_cast<float*>(out)[idx] = f;
  }
}

struct Args {
  const int8_t* x;
  const int8_t* w;
  int rows, K, N;
  int k_slice, row_tiles, col_tiles, splits;
  const int16_t* table;
  const float* scale;
  const float* bias;
  int out_kind;
  void* out;
  uint32_t* partial;
  int* counters;
};

template <int BM, int BN>
__global__ void __launch_bounds__(THREADS)
approx_mm_kernel(const Args a) {
  using T = Tile<BM, BN>;
  constexpr int TN = T::TN, TY = T::TY, KG = T::KG;
  extern __shared__ int4 smem4[];
  const char* table = reinterpret_cast<const char*>(smem4);
  int* ops = reinterpret_cast<int*>(smem4 + TABLE_BYTES / 16);
  int* xv = ops;                 // [BK][BM] x
  int* xn = xv + BK * BM;        // [BK][BM] -sign(x)
  int* xo = xn + BK * BM;        // [BK][BM] byte offset of row |x|
  int* wv = xo + BK * BM;        // [BK][BN] w
  int* wn = wv + BK * BN;        // [BK][BN] sign(w)
  int* wo = wn + BK * BN;        // [BK][BN] byte offset of column |w|
  uint32_t* red = reinterpret_cast<uint32_t*>(ops);  // [KG][BM][BN], after

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX % TY;
  const int g = tid / (TX * TY);
  int b = blockIdx.x;
  const int ct = b % a.col_tiles;
  b /= a.col_tiles;
  const int rt = b % a.row_tiles;
  const int slice = b / a.row_tiles;
  const long long row0 = static_cast<long long>(rt) * BM;
  const int col0 = ct * BN;
  const int k_begin = slice * a.k_slice;
  const int k_end = min(a.K, k_begin + a.k_slice);

  const int4* src = reinterpret_cast<const int4*>(a.table);
  for (int e = tid; e < TABLE_BYTES / 16; e += THREADS) smem4[e] = src[e];

  uint32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // x: consecutive threads take consecutive rows of one k (conflict-free
    // stores; the strided global reads hit L1 after the first k)
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int c = e / BM, r = e % BM;
      const long long gr = row0 + r;
      const int gk = k0 + c;
      const int v = (gr < a.rows && gk < k_end) ? a.x[gr * a.K + gk] : 0;
      xv[e] = v;
      xn[e] = -sgn(v);
      xo[e] = abs(v) * (TABLE_STRIDE * 2);
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gc = col0 + c;
      const int v = (gk < k_end && gc < a.N)
                        ? a.w[static_cast<long long>(gk) * a.N + gc] : 0;
      wv[e] = v;
      wn[e] = sgn(v);
      wo[e] = abs(v) * 2;
    }
    __syncthreads();

#pragma unroll 1
    for (int kk = g; kk < BK; kk += KG) {
      int av[TM], an[TM], ao[TM], bv[TN], bn[TN], bo[TN];
      load_ints(av, xv + kk * BM + ty * TM);
      load_ints(an, xn + kk * BM + ty * TM);
      load_ints(ao, xo + kk * BM + ty * TM);
      load_ints(bv, wv + kk * BN + tx * TN);
      load_ints(bn, wn + kk * BN + tx * TN);
      load_ints(bo, wo + kk * BN + tx * TN);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int corr =
              *reinterpret_cast<const int16_t*>(table + ao[i] + bo[j]);
          acc[i][j] += static_cast<uint32_t>(av[i] * bv[j]);
          acc[i][j] += static_cast<uint32_t>(an[i] * bn[j] * corr);
        }
    }
    __syncthreads();
  }

  // the k groups' sums meet in shared memory (over the staged operands)
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      red[(g * BM + ty * TM + i) * BN + tx * TN + j] = acc[i][j];
  __syncthreads();

  const long long part_stride = static_cast<long long>(a.rows) * a.N;
  for (int o = tid; o < BM * BN; o += THREADS) {
    const int r = o / BN, c = o % BN;
    const long long gr = row0 + r;
    const int gc = col0 + c;
    if (gr >= a.rows || gc >= a.N) continue;
    uint32_t v = 0u;
#pragma unroll
    for (int q = 0; q < KG; ++q) v += red[q * BM * BN + o];
    const long long idx = gr * a.N + gc;
    if (a.splits == 1)
      store_out(a.out_kind, a.out, idx, v, a.scale, a.bias, gc);
    else
      a.partial[slice * part_stride + idx] = v;
  }
  if (a.splits == 1) return;

  // split-K: the tile's last-arriving block sums the slices and finishes
  __shared__ int last;
  __threadfence();
  __syncthreads();
  const int tile = rt * a.col_tiles + ct;
  if (tid == 0) last = atomicAdd(&a.counters[tile], 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int o = tid; o < BM * BN; o += THREADS) {
    const int r = o / BN, c = o % BN;
    const long long gr = row0 + r;
    const int gc = col0 + c;
    if (gr >= a.rows || gc >= a.N) continue;
    const long long idx = gr * a.N + gc;
    uint32_t v = 0u;
    for (int s = 0; s < a.splits; ++s)
      v += __ldcg(a.partial + s * part_stride + idx);
    store_out(a.out_kind, a.out, idx, v, a.scale, a.bias, gc);
  }
  if (tid == 0) a.counters[tile] = 0;
}

template <int BM, int BN>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = smem_bytes<BM, BN>();
  // past 48 KB a kernel must ask for its dynamic shared memory; asked once
  // per device
  static unsigned configured = 0u;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(approx_mm_kernel<BM, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    if (dev < 32) configured |= 1u << dev;
  }
  const unsigned blocks = static_cast<unsigned>(a.row_tiles) *
                          static_cast<unsigned>(a.col_tiles) *
                          static_cast<unsigned>(a.splits);
  approx_mm_kernel<BM, BN><<<blocks, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_bn(int bn, const Args& a, cudaStream_t s) {
  switch (bn) {
    case 16: return launch<BM, 16>(a, s);
    case 32: return launch<BM, 32>(a, s);
    case 64: return launch<BM, 64>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// Returns a cudaError_t: 0 on a successful launch, cudaErrorInvalidValue
// for arguments or a plan it refuses. The kernel runs on `stream`,
// allocates nothing and does not synchronise.
extern "C" int approx_mm_launch(const void* x, const void* w, int rows,
                                int K, int N, int bm, int bn, int k_slice,
                                int row_tiles, int col_tiles, int splits,
                                const void* table, int table_stride,
                                int table_bytes, const void* scale,
                                const void* bias, int out_kind, void* out,
                                void* partial, void* counters,
                                int n_counters, void* stream) {
  if (rows < 0 || K < 1 || N < 0 || out_kind < OUT_INT32 ||
      out_kind > OUT_F32_RELU || (out_kind != OUT_INT32 &&
                                  (scale == nullptr || bias == nullptr)))
    return cudaErrorInvalidValue;
  if (rows == 0 || N == 0) return cudaSuccess;
  if (table == nullptr || table_stride != TABLE_STRIDE ||
      table_bytes != TABLE_BYTES)
    return cudaErrorInvalidValue;
  // the plan must cover every output and every k exactly once
  if (bm <= 0 || bn <= 0 || k_slice <= 0 ||
      row_tiles != ceil_div(rows, bm) || col_tiles != ceil_div(N, bn) ||
      splits != ceil_div(K, k_slice) ||
      static_cast<long long>(row_tiles) * col_tiles * splits >= (1ll << 31))
    return cudaErrorInvalidValue;
  if (splits > 1 && (partial == nullptr || counters == nullptr ||
                     n_counters < static_cast<long long>(row_tiles) *
                                      col_tiles))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
               rows, K, N, k_slice, row_tiles, col_tiles, splits,
               static_cast<const int16_t*>(table),
               static_cast<const float*>(scale),
               static_cast<const float*>(bias), out_kind, out,
               static_cast<uint32_t*>(partial), static_cast<int*>(counters)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 4: return launch_bn<4>(bn, a, s);
    case 8: return launch_bn<8>(bn, a, s);
    case 16: return launch_bn<16>(bn, a, s);
    case 32: return launch_bn<32>(bn, a, s);
    case 64: return launch_bn<64>(bn, a, s);
    default: return cudaErrorInvalidValue;
  }
}
