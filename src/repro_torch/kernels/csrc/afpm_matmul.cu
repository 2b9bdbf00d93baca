// Segmented split-float matmul (the paper's AFPM on tensor cores) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/afpm_matmul.py::afpm_matmul_pallas
// (bodies _split, _accumulate, _kernel2d, _kernel_batched).
//
// What it computes: out (M, N) fp32 = x (M, K) @ w (K, N), x fp32 or bf16,
// w fp32.  Every operand element t splits into hi = bf16_rne(t) and
// lo = bf16(t - hi).  The sum takes hi(x)·hi(w) always, plus lo(x)·hi(w)
// when passes >= 2, plus hi(x)·lo(w) when passes == 3; lo·lo is never
// taken.  Accumulation is fp32 across K.  The caller flattens leading batch
// dims of x into M: the weight is shared, and an output element depends only
// on its own row of x, its column of w and the K order, never on M or N.
//
// Design (simple and right first; wgmma, TMA and a skinny-M path are later
// work):
// - one CTA of 4 warps per 32 x 64 output tile; a loop over K inside the
//   block takes the place of the TPU grid's sequential k axis;
// - each K step loads a 32 x 32 tile of x and a 32 x 64 tile of w, splits
//   every element into hi/lo bf16 on the way into shared memory
//   (__float2bfloat16_rn), and zero-fills past the ragged edges, so nothing
//   is padded in device memory; a thread's loads for the next K step are
//   issued into registers before this step's products, so they overlap;
// - each warp owns two 16 x 16 output fragments and runs 1-3 nvcuda::wmma
//   16x16x16 bf16 -> fp32 products per fragment per 16-deep slice;
// - the tensor cores' fp32 accumulation inside an mma is not IEEE
//   round-to-nearest, so each K step accumulates into a fresh fragment and
//   is then added into the running fp32 sum with ordinary IEEE adds.  That
//   keeps the result within a few ulps of the plain version for K ~ 10^4.
//
// What bounds it on an H100: at decode (M = number of slots, <= 16) it is
// bound by bytes, the fp32 weight read once (about 14.5 GB for a full-width
// qwen3-4b forward: 7 projections x 36 layers).  Most rows of each 16-row
// fragment are then wasted, and only ceil(N / 64) CTAs run, too few to fill
// 132 SMs for the narrow projections.  At prefill-chunk M (32) it is bound
// by the 2 * passes * M * N * K bf16 tensor-core operations.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>

using namespace nvcuda;

namespace {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;

__device__ __forceinline__ float load_elem(const float* p) { return *p; }
__device__ __forceinline__ float load_elem(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void split(float v, __nv_bfloat16* hi,
                                      __nv_bfloat16* lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  *hi = h;
  *lo = __float2bfloat16_rn(v - __bfloat162float(h));
}

template <typename TX, int PASSES>
__global__ void __launch_bounds__(THREADS)
    afpm_matmul_kernel(const TX* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(32) __nv_bfloat16 xh[BM * BK];
  __shared__ __align__(32) __nv_bfloat16 xl[BM * BK];
  __shared__ __align__(32) __nv_bfloat16 wh[BK * BN];
  __shared__ __align__(32) __nv_bfloat16 wl[BK * BN];
  __shared__ __align__(32) float ctile[BM * BN];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int frow = (warp / 2) * 16;  // this warp's fragment row
  const int fcol = (warp % 2) * 32;  // first of its two fragment columns

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);

  // each thread stages its share of the next K tile in registers, so its
  // global loads are in flight while the tensor cores work on this tile
  constexpr int XPT = BM * BK / THREADS;
  constexpr int WPT = BK * BN / THREADS;
  float xr[XPT], wr[WPT];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int i = tid + j * THREADS;
      const int gm = m0 + i / BK, gk = k0 + i % BK;
      xr[j] = (gm < M && gk < K)
                  ? load_elem(x + static_cast<size_t>(gm) * K + gk)
                  : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int i = tid + j * THREADS;
      const int gk = k0 + i / BN, gn = n0 + i % BN;
      wr[j] = (gk < K && gn < N) ? w[static_cast<size_t>(gk) * N + gn] : 0.0f;
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int j = 0; j < XPT; ++j)
      split(xr[j], &xh[tid + j * THREADS], &xl[tid + j * THREADS]);
#pragma unroll
    for (int j = 0; j < WPT; ++j)
      split(wr[j], &wh[tid + j * THREADS], &wl[tid + j * THREADS]);
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> step[2];
    wmma::fill_fragment(step[0], 0.0f);
    wmma::fill_fragment(step[1], 0.0f);
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a_hi, a_lo;
      wmma::load_matrix_sync(a_hi, xh + frow * BK + kk, BK);
      if (PASSES >= 2) wmma::load_matrix_sync(a_lo, xl + frow * BK + kk, BK);
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            b;
        const int col = fcol + j * 16;
        wmma::load_matrix_sync(b, wh + kk * BN + col, BN);
        wmma::mma_sync(step[j], a_hi, b, step[j]);            // AC
        if (PASSES >= 2) wmma::mma_sync(step[j], a_lo, b, step[j]);  // AD
        if (PASSES >= 3) {
          wmma::load_matrix_sync(b, wl + kk * BN + col, BN);
          wmma::mma_sync(step[j], a_hi, b, step[j]);          // BC
        }
      }
    }
    // IEEE fp32 adds across K steps (both fragments share one layout)
    for (int j = 0; j < 2; ++j)
      for (int t = 0; t < acc[j].num_elements; ++t) acc[j].x[t] += step[j].x[t];
    __syncthreads();
  }

  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(ctile + frow * BN + fcol + j * 16, acc[j], BN,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int gm = m0 + i / BN, gn = n0 + i % BN;
    if (gm < M && gn < N) out[static_cast<size_t>(gm) * N + gn] = ctile[i];
  }
}

template <typename TX>
cudaError_t launch(const void* x, const float* w, float* out, int M, int K,
                   int N, int passes, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const TX* xp = static_cast<const TX*>(x);
  switch (passes) {
    case 1:
      afpm_matmul_kernel<TX, 1><<<grid, THREADS, 0, stream>>>(xp, w, out, M, K, N);
      break;
    case 2:
      afpm_matmul_kernel<TX, 2><<<grid, THREADS, 0, stream>>>(xp, w, out, M, K, N);
      break;
    case 3:
      afpm_matmul_kernel<TX, 3><<<grid, THREADS, 0, stream>>>(xp, w, out, M, K, N);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (M, K) row-major, fp32 (x_is_bf16 == 0) or bf16; w: (K, N) fp32
// row-major; out: (M, N) fp32.  Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (0 on success).
int afpm_matmul_launch(const void* x, int x_is_bf16, const void* w, void* out,
                       int M, int K, int N, int passes, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  float* op = static_cast<float*>(out);
  const cudaError_t err =
      x_is_bf16 ? launch<__nv_bfloat16>(x, wp, op, M, K, N, passes, s)
                : launch<float>(x, wp, op, M, K, N, passes, s);
  return static_cast<int>(err);
}

const char* afpm_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
