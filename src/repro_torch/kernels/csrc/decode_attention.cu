// A decode step's attention core for Hopper: qk-norm, RoPE, the cache write
// and grouped-query attention with fp64 sums, in one launch a layer.
//
// Replaces no TPU kernel: the JAX package leaves attention, its norms,
// RoPE and the cache update to XLA, and the port ran them as plain
// PyTorch ops (models/attention.py::decode_core_plain, which stays as this
// kernel's plain version).  It was added because that chain cost a decode
// step more than the layer's projections: some 78 ATen launches a layer on
// the host, and on the device fp64 copies of the whole gathered K/V view
// (4 bytes of traffic for every cached bf16 byte, several times over)
// feeding two DGEMMs.
//
// What it computes, per batch row b at position p (per-row positions, or
// one broadcast to every row) and per query head h of KV head kh:
// - q and k (fp32, as K1 returned them) are normalised as layers.rmsnorm
//   does under fp64 sums (square-sum in fp64, rsqrt(mean + eps), times
//   (1 + scale) in fp64, rounded once to fp32), then rotated as
//   layers.apply_rope does (split halves, in fp32: angle = float(pos) *
//   freq, cosf / sinf, x1 cos - x2 sin with each product and the difference
//   rounded on its own, as PyTorch's separate kernels round them);
// - k and v are written into the cache at [b, p, kh] (rounded to the
//   cache's dtype, as models/attention.py::_cache_update writes them);
// - s_j = (q_bf16 . k_j) * D^-0.5 for every key j in [lo, p] (lo = p -
//   window + 1 with a window, else 0), each product exact and the dot
//   summed in fp64; with a softcap s = tanh(s / cap) * cap in fp64;
// - the softmax in two passes, as PyTorch's fp64 softmax: the max, the
//   fp64 sum of exp(s - max), then p_j = e_j / sum, and only then p_j
//   rounded to bf16 through fp32 (as .to(torch.bfloat16) rounds a double);
// - o = sum_j p_j v_j in fp64 over bf16 operands, rounded once to the
//   output's dtype through fp32.
// Keys outside [lo, p] are masked to exact zeros in the plain chain; here
// they are skipped, which gives the same sums.
//
// Every sum runs in an order fixed by the row's own position: the dot over
// the head dim in ascending order (one fused multiply-add a product: the
// product of two bf16 values is exact, so fma(q, k, acc) rounds exactly as
// an exact product added to acc); the exp sum over tiles of 128 keys
// aligned at position 0, each reduced by a fixed tree, the tiles taken in
// order; the PV sum over the keys of each residue class j mod R (R =
// 128 / (D / 8), a function of the head dim) in ascending order, the
// classes' sums then in a fixed pairwise tree.  Nothing depends on
// the batch, on the view's length or on the other rows, so a row's bits
// are the same alone and among 96 rows, in the engine's 640-position view
// and in a solo generate's cache.
//
// What bounds it on an H100: bytes.  Each attended key's bf16 K and V row
// is read once (256 bytes each at head dim 128); at qwen3-4b's batch-short
// fill (96 rows, 8 KV heads, about 240 keys a row) that is about 95 MB a
// layer, 28 us at 3.35 TB/s.  Its fp64 work (one widening and G fused
// multiply-adds per cached element, G query heads a KV head) comes to about
// as much at the card's non-tensor fp64 rates, so both are kept to one
// pass over the cache.
//
// Design: one CTA of 128 threads per (row, KV head, group of GB query
// heads), GB the largest of 4, 2, 1 that divides the group (a grid of 768
// CTAs at batch-short).  The prologue normalises and rotates its GB query
// heads and the KV head's k (one warp a vector, a shuffle tree over the
// head dim), keeps them in shared memory as fp64 of their bf16 values,
// and writes the new cache row (the CTA of the first group only).  The
// score pass gives each thread one key of a tile; it reads the key's row
// with 16-byte loads, 8 in flight, and keeps its GB dots in registers
// against q in shared memory; the new key at p is taken from shared
// memory, so no CTA reads a cache row that any CTA writes.  Scores (GB
// doubles a key) stay in shared memory up to a length the wrapper chooses
// and go to a scratch buffer it allocates beyond that.  The PV pass reads
// V rows whole: D / 8 threads a row, 16 bytes each, R rows at a time, 4
// keys in flight a thread, each thread holding GB x 8 sums; the R
// partial sums then meet in shared memory.
//
// What holds it back: a CTA walks its row's keys alone, so a batch of a
// few rows at a long cache (4 rows x 8 KV heads: 32 CTAs for 132 SMs)
// leaves most of the card idle; splitting the keys over CTAs would need a
// second pass for the softmax's max and sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = THREADS;  // keys a tile of the exp sum: one a thread
constexpr int INFLIGHT = 8;    // a score thread's 16-byte loads in flight
constexpr int PV_KEYS = 4;     // a PV thread's keys (16-byte loads) in flight
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;
constexpr int MAX_SMEM = 232448;

struct Args {
  const float* q;        // (B, H, D)
  const float* k;        // (B, KH, D)
  const float* v;        // (B, KH, D)
  const float* q_scale;  // (D,), with has_norm
  const float* k_scale;  // (D,), with has_norm
  const float* freqs;    // (D / 2,)
  void* k_cache;         // (B, S, KH, D), bf16 or fp32
  void* v_cache;
  const long long* pos;  // (B,) at pos_stride, or null: pos_scalar
  long long pos_stride, pos_scalar;
  const long long* rpos;  // RoPE positions, (B,) at rpos_stride
  long long rpos_stride;
  void* out;        // (B, H, D), bf16 or fp32
  double* scratch;  // scores, when they do not stay in shared memory
  int B, S, H, KH, D, G;
  int window, has_norm, scores_in_smem;
  double eps, scale, cap;
};

__host__ __device__ constexpr size_t align8(size_t n) { return (n + 7) & ~size_t(7); }

// shared memory: q [D][GB], the new k and v [D], the block reductions
// [WARPS][GB], the normalised vectors [(GB + 1) D] fp32, the scores [S][GB];
// then, reused, the PV partials [THREADS / (D / 8)][GB][D]
__host__ __device__ size_t smem_bytes(int D, int GB, int S, int in_smem) {
  const size_t layout =
      sizeof(double) * (size_t(D) * GB + 2 * size_t(D) + WARPS * GB) +
      align8(sizeof(float) * size_t(GB + 1) * D) +
      (in_smem ? sizeof(double) * size_t(S) * GB : 0);
  const size_t partials = sizeof(double) * size_t(THREADS / (D / 8)) * GB * D;
  return layout > partials ? layout : partials;
}

__device__ __forceinline__ double bf16_dbl(float x) {
  return static_cast<double>(__bfloat162float(__float2bfloat16_rn(x)));
}

__device__ __forceinline__ void store_cache(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store_cache(float* p, float x) { *p = x; }

__device__ __forceinline__ void store_out(__nv_bfloat16* p, double x) {
  *p = __float2bfloat16_rn(__double2float_rn(x));
}
__device__ __forceinline__ void store_out(float* p, double x) {
  *p = __double2float_rn(x);
}

// 8 consecutive cache elements as loaded (one 16-byte load of bf16, two
// of fp32, from a 16-byte aligned address), and widened as the attention
// reads them
template <typename TC> struct Raw8;
template <> struct Raw8<__nv_bfloat16> { uint4 u; };
template <> struct Raw8<float> { float4 u, w; };

__device__ __forceinline__ void load8(const __nv_bfloat16* p, Raw8<__nv_bfloat16>& r) {
  r.u = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void load8(const float* p, Raw8<float>& r) {
  r.u = reinterpret_cast<const float4*>(p)[0];
  r.w = reinterpret_cast<const float4*>(p)[1];
}

__device__ __forceinline__ void widen8(const Raw8<__nv_bfloat16>& r, double (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void widen8(const Raw8<float>& r, double (&x)[8]) {
  x[0] = bf16_dbl(r.u.x); x[1] = bf16_dbl(r.u.y);
  x[2] = bf16_dbl(r.u.z); x[3] = bf16_dbl(r.u.w);
  x[4] = bf16_dbl(r.w.x); x[5] = bf16_dbl(r.w.y);
  x[6] = bf16_dbl(r.w.z); x[7] = bf16_dbl(r.w.w);
}

// Sum over the block, the same bits in every thread: a butterfly in each
// warp (lanes L and L ^ o add the same pair, so every lane holds the same
// value), then the warps' sums as ((w0 + w1) + (w2 + w3)).
template <int GB>
__device__ __forceinline__ void block_sum(double (&x)[GB], double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x[g] = __dadd_rn(x[g], __shfl_xor_sync(FULL, x[g], o));
    if (lane == 0) red[warp * GB + g] = x[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GB; ++g)
    x[g] = __dadd_rn(__dadd_rn(red[g], red[GB + g]),
                     __dadd_rn(red[2 * GB + g], red[3 * GB + g]));
  __syncthreads();
}

template <int GB>
__device__ __forceinline__ void block_max(double (&x)[GB], double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x[g] = fmax(x[g], __shfl_xor_sync(FULL, x[g], o));
    if (lane == 0) red[warp * GB + g] = x[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GB; ++g)
    x[g] = fmax(fmax(red[g], red[GB + g]), fmax(red[2 * GB + g], red[3 * GB + g]));
  __syncthreads();
}

template <typename TC, typename TO, int GB>
__global__ void __launch_bounds__(THREADS)
    decode_attention_kernel(const Args a) {
  extern __shared__ double smem[];
  const int D = a.D, half = D / 2, S = a.S, KH = a.KH;
  const int groups = a.G / GB;
  const int kh = blockIdx.x / groups;
  const int h0 = kh * a.G + (blockIdx.x % groups) * GB;
  const bool writer = blockIdx.x % groups == 0;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  double* qd = smem;              // [D][GB]: q as bf16, widened
  double* kn = qd + D * GB;       // [D]: the new k, likewise
  double* vn = kn + D;            // [D]: the new v, likewise
  double* red = vn + D;           // [WARPS][GB]
  float* xs = reinterpret_cast<float*>(red + WARPS * GB);  // [GB + 1][D]
  double* sc = a.scores_in_smem
                   ? reinterpret_cast<double*>(
                         reinterpret_cast<char*>(xs) +
                         align8(sizeof(float) * size_t(GB + 1) * D))
                   : a.scratch + (size_t(b) * gridDim.x + blockIdx.x) * size_t(S) * GB;

  TO* out = static_cast<TO*>(a.out) + (size_t(b) * a.H + h0) * D;
  const long long p = a.pos ? a.pos[b * a.pos_stride] : a.pos_scalar;
  if (p < 0 || p >= S) {  // no cache row to write (the plain chain raises)
    for (int i = tid; i < GB * D; i += THREADS)
      store_out(out + i, __longlong_as_double(0x7ff8000000000000LL));
    return;
  }

  // 1. q's GB heads and k, normalised (one warp a vector)
  for (int vec = warp; vec <= GB; vec += WARPS) {
    const float* src = vec < GB ? a.q + (size_t(b) * a.H + h0 + vec) * D
                                : a.k + (size_t(b) * KH + kh) * D;
    float* dst = xs + vec * D;
    if (a.has_norm) {
      double ss = 0.0;
      for (int d = lane; d < D; d += 32) {
        const double x = src[d];
        ss = __dadd_rn(ss, __dmul_rn(x, x));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ss = __dadd_rn(ss, __shfl_xor_sync(FULL, ss, o));
      const double r = rsqrt(__dadd_rn(__dmul_rn(ss, 1.0 / D), a.eps));
      const float* scale = vec < GB ? a.q_scale : a.k_scale;
      for (int d = lane; d < D; d += 32)
        dst[d] = __double2float_rn(
            __dmul_rn(__dmul_rn(static_cast<double>(src[d]), r),
                      __dadd_rn(1.0, static_cast<double>(scale[d]))));
    } else {
      for (int d = lane; d < D; d += 32) dst[d] = src[d];
    }
  }
  __syncthreads();

  // 2. RoPE in fp32; the new cache row
  TC* kc = static_cast<TC*>(a.k_cache);
  TC* vc = static_cast<TC*>(a.v_cache);
  const size_t row_p = ((size_t(b) * S + p) * KH + kh) * D;
  const float rp = __ll2float_rn(a.rpos[b * a.rpos_stride]);
  for (int i = tid; i < (GB + 1) * half; i += THREADS) {
    const int vec = i / half, d = i - vec * half;
    const float* x = xs + vec * D;
    const float ang = __fmul_rn(rp, a.freqs[d]);
    const float c = cosf(ang), s = sinf(ang);
    const float x1 = x[d], x2 = x[d + half];
    const float o1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
    const float o2 = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
    if (vec < GB) {
      qd[d * GB + vec] = bf16_dbl(o1);
      qd[(d + half) * GB + vec] = bf16_dbl(o2);
    } else {
      kn[d] = bf16_dbl(o1);
      kn[d + half] = bf16_dbl(o2);
      if (writer) {
        store_cache(kc + row_p + d, o1);
        store_cache(kc + row_p + d + half, o2);
      }
    }
  }
  for (int d = tid; d < D; d += THREADS) {
    const float x = a.v[(size_t(b) * KH + kh) * D + d];
    vn[d] = bf16_dbl(x);
    if (writer) store_cache(vc + row_p + d, x);
  }
  __syncthreads();

  // 3. scores, one key a thread; their max
  const long long lo = a.window > 0 ? (p - a.window + 1 > 0 ? p - a.window + 1 : 0) : 0;
  const int t0 = static_cast<int>(lo / TILE), t1 = static_cast<int>(p / TILE);
  double mx[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) mx[g] = -INFINITY;
  for (int t = t0; t <= t1; ++t) {
    const long long j = static_cast<long long>(t) * TILE + tid;
    if (j < lo || j > p) continue;
    double acc[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) acc[g] = 0.0;
    if (j < p) {
      const TC* row = kc + ((size_t(b) * S + j) * KH + kh) * D;
      for (int c0 = 0; c0 < D; c0 += 8 * INFLIGHT) {
        Raw8<TC> raw[INFLIGHT];  // the loads first, then the sums
#pragma unroll
        for (int u = 0; u < INFLIGHT; ++u)
          if (c0 + 8 * u < D) load8(row + c0 + 8 * u, raw[u]);
#pragma unroll
        for (int u = 0; u < INFLIGHT; ++u) {
          if (c0 + 8 * u >= D) break;
          double kd[8];
          widen8(raw[u], kd);
#pragma unroll
          for (int e = 0; e < 8; ++e)
#pragma unroll
            for (int g = 0; g < GB; ++g)
              acc[g] = __fma_rn(qd[(c0 + 8 * u + e) * GB + g], kd[e], acc[g]);
        }
      }
    } else {
      for (int d = 0; d < D; ++d) {
        const double kd = kn[d];
#pragma unroll
        for (int g = 0; g < GB; ++g) acc[g] = __fma_rn(qd[d * GB + g], kd, acc[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      double s = __dmul_rn(acc[g], a.scale);
      if (a.cap > 0.0) s = __dmul_rn(tanh(__ddiv_rn(s, a.cap)), a.cap);
      sc[j * GB + g] = s;
      mx[g] = fmax(mx[g], s);
    }
  }
  block_max<GB>(mx, red);

  // 4. the exp sum, tile by tile from position 0
  double tot[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) tot[g] = 0.0;
  for (int t = t0; t <= t1; ++t) {
    const long long j = static_cast<long long>(t) * TILE + tid;
    const bool in = j >= lo && j <= p;
    double e[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      e[g] = in ? exp(__dsub_rn(sc[j * GB + g], mx[g])) : 0.0;
      if (in) sc[j * GB + g] = e[g];
    }
    block_sum<GB>(e, red);
#pragma unroll
    for (int g = 0; g < GB; ++g) tot[g] = __dadd_rn(tot[g], e[g]);
  }
  // p = e / sum, rounded to bf16 through fp32
  for (int t = t0; t <= t1; ++t) {
    const long long j = static_cast<long long>(t) * TILE + tid;
    if (j < lo || j > p) continue;
#pragma unroll
    for (int g = 0; g < GB; ++g)
      sc[j * GB + g] = bf16_dbl(__double2float_rn(__ddiv_rn(sc[j * GB + g], tot[g])));
  }
  __syncthreads();

  // 5. PV: a V row is read as D / 8 chunks of 8 elements, one a thread,
  // so nclass = THREADS / (D / 8) rows are read at a time; the threads of
  // class r walk the keys j = r (mod nclass) in ascending order.  After a
  // barrier all shared memory is free, and the classes' partial sums meet
  // there in a fixed pairwise tree.
  const int chunks = D / 8, nclass = THREADS / chunks;
  const int cls = tid / chunks, c = tid - cls * chunks;
  double o[GB][8];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) o[g][e] = 0.0;
  if (cls < nclass) {
    long long j = lo + ((cls - lo) % nclass + nclass) % nclass;
    const TC* col = vc + (size_t(b) * S * KH + kh) * D + 8 * c;
    const size_t step = size_t(KH) * D;
    for (; j + nclass * (PV_KEYS - 1) < p; j += nclass * (PV_KEYS)) {
      Raw8<TC> raw[PV_KEYS];
#pragma unroll
      for (int u = 0; u < PV_KEYS; ++u) load8(col + (j + u * nclass) * step, raw[u]);
#pragma unroll
      for (int u = 0; u < PV_KEYS; ++u) {
        double vd[8];
        widen8(raw[u], vd);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const double pj = sc[(j + u * nclass) * GB + g];
#pragma unroll
          for (int e = 0; e < 8; ++e) o[g][e] = __fma_rn(pj, vd[e], o[g][e]);
        }
      }
    }
    for (; j < p; j += nclass) {
      Raw8<TC> raw;
      load8(col + j * step, raw);
      double vd[8];
      widen8(raw, vd);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const double pj = sc[j * GB + g];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[g][e] = __fma_rn(pj, vd[e], o[g][e]);
      }
    }
    if (j == p) {  // the new row, from shared memory
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const double pj = sc[p * GB + g];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[g][e] = __fma_rn(pj, vn[8 * c + e], o[g][e]);
      }
    }
  }
  __syncthreads();
  double* part = smem;  // [nclass][GB][D]
  if (cls < nclass) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) part[(cls * GB + g) * D + 8 * c + e] = o[g][e];
  }
  __syncthreads();
  for (int w = 1; w < nclass; w *= 2) {
    const int pairs = (nclass + 2 * w - 1) / (2 * w);
    for (int i = tid; i < pairs * GB * D; i += THREADS) {
      const int lo_i = (i / (GB * D)) * 2 * w, gd = i % (GB * D);
      if (lo_i + w < nclass)
        part[lo_i * GB * D + gd] =
            __dadd_rn(part[lo_i * GB * D + gd], part[(lo_i + w) * GB * D + gd]);
    }
    __syncthreads();
  }
  for (int i = tid; i < GB * D; i += THREADS) store_out(out + i, part[i]);
}

template <typename TC, typename TO, int GB>
cudaError_t launch_one(const Args& a, int device, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<TC, TO, GB>;
  static std::atomic<bool> raised[MAX_DEVICES];  // the limit, once a device
  if (!raised[device].load(std::memory_order_acquire)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return e;
    raised[device].store(true, std::memory_order_release);
  }
  const size_t smem = smem_bytes(a.D, GB, a.S, a.scores_in_smem);
  if (smem > size_t(MAX_SMEM)) return cudaErrorInvalidValue;
  const dim3 grid(a.KH * (a.G / GB), a.B);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TC, typename TO>
cudaError_t launch_gb(const Args& a, int gb, int device, cudaStream_t stream) {
  switch (gb) {
    case 1: return launch_one<TC, TO, 1>(a, device, stream);
    case 2: return launch_one<TC, TO, 2>(a, device, stream);
    case 4: return launch_one<TC, TO, 4>(a, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, H, D), k and v (B, KH, D): fp32, contiguous.  k_cache and v_cache
// (B, S, KH, D) contiguous, bf16 (cache_bf16) or fp32, 16-byte aligned,
// D a multiple of 8 up to 256.  pos: (B,) int64 at pos_stride elements, or
// null for pos_scalar; rpos likewise (the RoPE positions).  q_scale and
// k_scale (D,) fp32 with has_norm.  out (B, H, D) bf16 (out_bf16) or fp32.
// scratch: B * H * S doubles unless scores_in_smem.  gb divides H / KH.
// Launches on `stream` on CUDA device `device`, does not synchronise, and
// returns the launch's cudaError_t (0 on success).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* q_scale, const void* k_scale,
                            const void* freqs, void* k_cache, void* v_cache,
                            int cache_bf16, const void* pos,
                            long long pos_stride, long long pos_scalar,
                            const void* rpos, long long rpos_stride, void* out,
                            int out_bf16, void* scratch, int B, int S, int H,
                            int KH, int D, int gb, int window, int has_norm,
                            int scores_in_smem, double eps, double scale,
                            double cap, int device, void* stream) {
  if (B <= 0 || KH <= 0) return 0;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (D % 8 || D < 8 || D > 256 || H % KH || (H / KH) % gb)
    return cudaErrorInvalidValue;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(q_scale),
               static_cast<const float*>(k_scale), static_cast<const float*>(freqs),
               k_cache, v_cache, static_cast<const long long*>(pos), pos_stride,
               pos_scalar, static_cast<const long long*>(rpos), rpos_stride, out,
               static_cast<double*>(scratch), B, S, H, KH, D, H / KH, window,
               has_norm, scores_in_smem, eps, scale, cap};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cache_bf16)
    err = out_bf16 ? launch_gb<__nv_bfloat16, __nv_bfloat16>(a, gb, device, st)
                   : launch_gb<__nv_bfloat16, float>(a, gb, device, st);
  else
    err = out_bf16 ? launch_gb<float, __nv_bfloat16>(a, gb, device, st)
                   : launch_gb<float, float>(a, gb, device, st);
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
