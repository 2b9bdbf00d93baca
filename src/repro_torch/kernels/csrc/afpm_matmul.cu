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
// dims of x into M.
//
// What bounds it on an H100: bytes.  A weight element (4 bytes) feeds
// 2 * passes * M operations, and the card's bf16 ridge is about 295
// operations a byte, so the kernel is bound by reading the fp32 weight up to
// M of about 590 / passes: 197 rows at passes = 3.  Every M the serving path
// gives it (decode 1-4 rows, prefill chunks of 8-32 rows, whole prompts of
// 40-150 rows) is below that.  What matters is streaming the weight at the
// full memory rate, not the tensor cores' rate.
//
// The canonical per-element arithmetic (the same for every M, N and tile
// plan, so an output element depends only on its row of x, its column of w
// and K; the engine's batched decode and chunked prefill rely on that):
// - K is cut into chunks of KCHUNK = 512, a function of K alone;
// - a chunk's partial P_c folds its 32-deep K steps in order with IEEE adds,
//   P_c = ((0 + S_0) + S_1) + ...;
// - a step S_s is one fresh tensor-core sum: for each 16-deep slice in order
//   the products hi·hi, lo(x)·hi(w), hi(x)·lo(w) (as passes asks) are
//   chained through mma.sync.m16n8k16 bf16 -> fp32 from a zero fragment.
//   The tensor cores' in-mma fp32 accumulation is not round-to-nearest;
//   the IEEE adds between steps keep K ~ 10^4 within a few ulps;
// - out = ((P_0 + P_1) + P_2) + ... with IEEE adds (__fadd_rn, never
//   contracted and never a float atomic).
// For K <= 512 this is the arithmetic of the port's first K1 kernel
// (commit 4b4aa8d), step for step.
//
// Design: weight streaming.  The weight is the mma's A operand (16 columns
// of w as 16 rows of w^T, so out^T = w^T x^T) and the tokens sit on the
// mma's n8 side, so decode's 1-4 rows waste half a fragment, not 3/4.
// (ldmatrix is not used: the operands reach the registers as fp32 and are
// split there.)
// - A CTA of 4 warps owns BN = 64 columns of w (16 a warp) and BM = 8 * MT
//   rows of x (MT n8 tiles, MT in {1, 2, 4, 8}: up to 64 rows; more rows
//   take more CTAs along z, and the weight is then read once per M block).
//   Up to 32 rows, where the grid still gives every SM two CTAs, a CTA has
//   8 warps and 128 columns: rows of 512 contiguous bytes stream better
//   from memory (wi / wg / mlp.wo).
// - Split mode (grid.y = the number of chunks): each CTA does one chunk of
//   K, writes its partial to a workspace, and the last CTA of an output
//   tile to finish (an integer atomic counter) folds the partials in chunk
//   order, 4 elements a thread at once.  This fills the card when N and M
//   give few tiles (wk/wv at N = 1024: 16 column tiles x 5 chunks).  Whole
//   mode (grid.y = 1): one CTA walks every chunk and folds in registers;
//   the same arithmetic, used when the tiles alone fill the card.
// - Weight and x tiles of each 32-deep step go to shared memory through a
//   ring of 4 slots filled with cp.async, 3 steps in flight: 16-byte copies
//   (.cg) where the rows are 16-byte aligned, else 4-byte copies for w and
//   plain loads for x; zero-filled at every ragged edge, nothing padded in
//   device memory.  The weight's copies carry an L2 evict-first policy (it
//   is read once a call).  Each step's fp32 values are split to hi/lo bf16
//   pairs in registers on their way from shared memory to the mma operands.
// The wrapper's plan (afpm_matmul.py) picks MT, the warps and the mode from
// (M, K, N); none of them changes the arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int KSTEP = 32;    // K of one step: one fresh mma sum
constexpr int KCHUNK = 512;  // K of one chunk: the canonical split
constexpr int STEPS_PER_CHUNK = KCHUNK / KSTEP;
constexpr int STAGES = 4;    // ring slots: STAGES - 1 steps in flight
// A CTA has WARPS warps (4 or 8) and owns BN = 16 * WARPS columns of w; a w
// slot's row stride is BN + 4 floats, so the 4 rows 2q apart of a fragment
// load hit 4 bank groups
template <int WARPS>
__host__ __device__ constexpr int wstride() { return 16 * WARPS + 4; }
constexpr int XS = 40;       // x slot row stride, elements (likewise)
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or zeros when !ok (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// The weight is read once a call: its copies carry an L2 evict-first
// policy, so the stream displaces its own lines and not what else the L2
// holds (activations, cache pages, dirty lines that would be written
// back), and ask the L2 to fetch whole 256-byte rows of a tile.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

__device__ __forceinline__ void cp_async16_stream(void* dst, const void* src,
                                                  bool ok, uint64_t pol) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint.L2::256B [%0], [%1], 16, %2, "
      "%3;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(ok ? 16 : 0), "l"(pol));
}

__device__ __forceinline__ void cp_async4_stream(void* dst, const void* src,
                                                 bool ok, uint64_t pol) {
  asm volatile(
      "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2, %3;\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(ok ? 4 : 0), "l"(pol));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// two fp32 values -> (hi, lo) bf16 pairs, a in the low half
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(__fsub_rn(a, __low2float(h)),
                                  __fsub_rn(b, __high2float(h))));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 sum
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename TX, int WARPS>
__host__ __device__ constexpr int smem_bytes(int mt) {
  return STAGES * (KSTEP * wstride<WARPS>() * 4 +
                   8 * mt * XS * static_cast<int>(sizeof(TX)));
}

// Fragment element i (0..3) of n8 tile t in a warp's 16-column slab: row
// (a column of w) g + 8 * (i / 2), token 8 t + 2 q + i % 2.
template <typename TX, int PASSES, int MT, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
    afpm_matmul_kernel(const TX* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ out, float* __restrict__ part,
                       unsigned* __restrict__ counters, int M, int K, int N,
                       int x_vec, int w_vec) {
  constexpr int BM = 8 * MT, THREADS = 32 * WARPS, BN = 16 * WARPS;
  constexpr int WS = wstride<WARPS>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned is_last;
  float* ws = reinterpret_cast<float*>(smem);
  TX* xs = reinterpret_cast<TX*>(smem + STAGES * KSTEP * WS * 4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.z * BM;
  const bool split = gridDim.y > 1;
  // this CTA's K range: one chunk (split) or all of K (whole)
  const int kbeg = blockIdx.y * KCHUNK;
  const int kend = split ? min(K, kbeg + KCHUNK) : K;
  const int nsteps = (kend - kbeg + KSTEP - 1) / KSTEP;
  const uint64_t pol = evict_first_policy();

  auto load_step = [&](int s) {  // step s into ring slot s % STAGES
    if (s >= nsteps) return;
    const int k0 = kbeg + s * KSTEP;
    float* wd = ws + (s % STAGES) * KSTEP * WS;
    if (w_vec) {  // KSTEP rows of BN floats: 16-byte copies, 4 a thread
#pragma unroll
      for (int j = 0; j < KSTEP * BN / 4 / THREADS; ++j) {
        const int i = tid + j * THREADS;
        const int r = i / (BN / 4), c = i % (BN / 4) * 4;
        const int k = k0 + r, n = n0 + c;
        const bool ok = k < kend && n < N;
        cp_async16_stream(wd + r * WS + c,
                          ok ? w + static_cast<size_t>(k) * N + n : w, ok, pol);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < KSTEP * BN / THREADS; ++j) {
        const int i = tid + j * THREADS;
        const int r = i / BN, c = i % BN;
        const int k = k0 + r, n = n0 + c;
        const bool ok = k < kend && n < N;
        cp_async4_stream(wd + r * WS + c,
                         ok ? w + static_cast<size_t>(k) * N + n : w, ok, pol);
      }
    }
    TX* xd = xs + (s % STAGES) * BM * XS;
    if (x_vec) {
      constexpr int EPC = 16 / static_cast<int>(sizeof(TX));
      constexpr int per_row = KSTEP / EPC;
      for (int i = tid; i < BM * per_row; i += THREADS) {
        const int r = i / per_row, c = i % per_row * EPC;
        const int m = m0 + r, k = k0 + c;
        const bool ok = m < M && k < kend;
        cp_async16(xd + r * XS + c, ok ? x + static_cast<size_t>(m) * K + k : x,
                   ok);
      }
    } else {  // unaligned rows: plain loads, ordered by the next barrier
      for (int i = tid; i < BM * KSTEP; i += THREADS) {
        const int r = i / KSTEP, c = i % KSTEP;
        const int m = m0 + r, k = k0 + c;
        xd[r * XS + c] = (m < M && k < kend)
                             ? x[static_cast<size_t>(m) * K + k]
                             : zero<TX>();
      }
    }
  };

  // one 32-deep step from ring slot `slot`: the fresh mma sum of its two
  // 16-deep slices, added into the chunk's partial `acc` (IEEE)
  float acc[MT][4];
  auto compute = [&](int slot) {
    const float* wt = ws + slot * KSTEP * WS + warp * 16 + g;
    const TX* xt = xs + slot * BM * XS + g * XS + 2 * q;
    float step[MT][4];
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) step[t][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KSTEP; kk += 16) {
      // A = w^T: register j holds rows g + 8 (j % 2), k pair 2q + 8 (j / 2)
      uint32_t ah[4], al[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* a = wt + (kk + 2 * q + 8 * (j >> 1)) * WS + 8 * (j & 1);
        split2(a[0], a[WS], ah[j], al[j]);
      }
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        // B = x^T: register j holds token 8t + g, k pair 2q + 8j
        uint32_t bh[2], bl[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 v = load2(xt + t * 8 * XS + kk + 8 * j);
          split2(v.x, v.y, bh[j], bl[j]);
        }
        mma(step[t], ah, bh);                     // hi(x)·hi(w)
        if (PASSES >= 2) mma(step[t], ah, bl);    // lo(x)·hi(w)
        if (PASSES >= 3) mma(step[t], al, bh);    // hi(x)·lo(w)
      }
    }
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][i] = __fadd_rn(acc[t][i], step[t][i]);
  };

  float res[MT][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) res[t][i] = acc[t][i] = 0.0f;
  bool first_chunk = true;

  // the ring: STAGES - 1 steps in flight, one barrier a step
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load_step(s);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s landed; every warp is done with step s - 1
    load_step(s + STAGES - 1);
    cp_async_commit();
    compute(s % STAGES);
    const int gstep = kbeg / KSTEP + s;
    if ((gstep + 1) % STEPS_PER_CHUNK == 0 || s == nsteps - 1) {  // chunk end
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          res[t][i] = first_chunk ? acc[t][i] : __fadd_rn(res[t][i], acc[t][i]);
          acc[t][i] = 0.0f;
        }
      first_chunk = false;
    }
  }
  cp_async_wait<0>();

  float* dst = split ? part + static_cast<size_t>(blockIdx.y) * M * N : out;
  const int nw = n0 + warp * 16 + g;
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + t * 8 + 2 * q + (i & 1), n = nw + 8 * (i >> 1);
      if (m < M && n < N) dst[static_cast<size_t>(m) * N + n] = res[t][i];
    }
  if (!split) return;

  // the last CTA of this output tile folds the partials in chunk order
  __threadfence();
  __syncthreads();
  unsigned* counter = counters + blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(counter, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const size_t plane = static_cast<size_t>(M) * N;
  const unsigned chunks = gridDim.y;
  const int tile = min(BM, M - m0) * BN;
  constexpr int E = 4;  // elements a thread folds at once, 8 chunks each:
                        // 32 loads in flight
  for (int e0 = tid; e0 < tile; e0 += E * THREADS) {
    size_t idx[E];
    bool ok[E];
    float r[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int e = e0 + j * THREADS, n = n0 + e % BN;
      ok[j] = e < tile && n < N;
      idx[j] = ok[j] ? static_cast<size_t>(m0 + e / BN) * N + n : 0;
      r[j] = ok[j] ? __ldcg(part + idx[j]) : 0.0f;
    }
    for (unsigned c0 = 1; c0 < chunks; c0 += 8) {
      float v[E][8];
#pragma unroll
      for (int j = 0; j < E; ++j)
#pragma unroll
        for (unsigned c = 0; c < 8; ++c)
          v[j][c] = ok[j] && c0 + c < chunks
                        ? __ldcg(part + (c0 + c) * plane + idx[j])
                        : 0.0f;
#pragma unroll
      for (int j = 0; j < E; ++j)
#pragma unroll
        for (unsigned c = 0; c < 8; ++c)
          if (c0 + c < chunks) r[j] = __fadd_rn(r[j], v[j][c]);
    }
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (ok[j]) out[idx[j]] = r[j];
  }
  if (tid == 0) *counter = 0;  // ready for the next call on this stream
}

struct Args {
  const void* x;
  const float* w;
  float* out;
  float* part;
  unsigned* counters;
  int M, K, N, split, x_vec, w_vec, device;
  cudaStream_t stream;
};

template <typename TX, int PASSES, int MT, int WARPS>
cudaError_t launch_one(const Args& a) {
  auto kernel = afpm_matmul_kernel<TX, PASSES, MT, WARPS>;
  constexpr int smem = smem_bytes<TX, WARPS>(MT);
  constexpr int BN = 16 * WARPS;
  if (smem > 48 * 1024) {  // above 48 KB only with the limit raised, once
    static std::atomic<bool> raised[MAX_DEVICES];  // a device
    if (a.device < 0 || a.device >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (!raised[a.device].load(std::memory_order_acquire)) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      raised[a.device].store(true, std::memory_order_release);
    }
  }
  const int chunks = a.K > 0 ? (a.K + KCHUNK - 1) / KCHUNK : 1;
  const dim3 grid((a.N + BN - 1) / BN, a.split ? chunks : 1,
                  (a.M + 8 * MT - 1) / (8 * MT));
  kernel<<<grid, 32 * WARPS, smem, a.stream>>>(
      static_cast<const TX*>(a.x), a.w, a.out, a.part, a.counters, a.M, a.K,
      a.N, a.x_vec, a.w_vec);
  return cudaGetLastError();
}

// (mt, warps): every mt with 4 warps, mt up to 4 with 8
template <typename TX, int PASSES>
cudaError_t launch_mt(const Args& a, int mt, int warps) {
  if (warps == 4) switch (mt) {
      case 1: return launch_one<TX, PASSES, 1, 4>(a);
      case 2: return launch_one<TX, PASSES, 2, 4>(a);
      case 4: return launch_one<TX, PASSES, 4, 4>(a);
      case 8: return launch_one<TX, PASSES, 8, 4>(a);
    }
  if (warps == 8) switch (mt) {
      case 1: return launch_one<TX, PASSES, 1, 8>(a);
      case 2: return launch_one<TX, PASSES, 2, 8>(a);
      case 4: return launch_one<TX, PASSES, 4, 8>(a);
    }
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t launch(const Args& a, int passes, int mt, int warps) {
  switch (passes) {
    case 1: return launch_mt<TX, 1>(a, mt, warps);
    case 2: return launch_mt<TX, 2>(a, mt, warps);
    case 3: return launch_mt<TX, 3>(a, mt, warps);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x: (M, K) row-major, fp32 (x_is_bf16 == 0) or bf16; w: (K, N) fp32
// row-major; out: (M, N) fp32.  The plan (mt n8 tiles of rows a CTA, 4 or
// 8 warps, split mode or not, and whether x's and w's rows are 16-byte
// aligned) comes from the wrapper.  In split mode `part` holds
// ceil(K / 512) * M * N floats and `counters` ceil(N / (16 warps)) *
// ceil(M / (8 mt)) zeros (left zero again when the kernel ends).  Launches on `stream` on CUDA device `device`, does not
// synchronise, and returns the launch's cudaError_t (0 on success).
int afpm_matmul_launch(const void* x, int x_is_bf16, const void* w, void* out,
                       void* part, void* counters, int M, int K, int N,
                       int passes, int mt, int warps, int split, int x_vec,
                       int w_vec, int device, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{x, static_cast<const float*>(w), static_cast<float*>(out),
               static_cast<float*>(part), static_cast<unsigned*>(counters),
               M, K, N, split, x_vec, w_vec, device,
               static_cast<cudaStream_t>(stream)};
  err = x_is_bf16 ? launch<__nv_bfloat16>(a, passes, mt, warps)
                  : launch<float>(a, passes, mt, warps);
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

const char* afpm_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
