// Mamba2 SSD chunked scan (state-space duality) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_pallas
// (body _kernel).
//
// What it computes, per batch row b and head h, over chunks of Q steps
// (l = the per-chunk log cumulative decay A_h * cumsum(dt), computed outside
// the kernel by the plain chunk_decay and passed in, as the reference
// hoists it):
//   y[t]  = sum_{s<=t} (C_t . B_s) e^{min(l_t - l_s, 0)} dt_s x_s   (intra)
//         + (C_t e^{l_t}) @ S_prev                                 (carry)
//   S_new = e^{l_Q} S_prev + sum_s (B_s dt_s e^{l_Q - l_s})^T x_s  (state)
// with the (N, P) fp32 state S starting at zero.  x (batch, L, H, P),
// dt and l (batch, L, H), B and C (batch, L, N), shared by every head, are
// read in that public layout through their strides; nothing is transposed
// on the host.  y (batch, L, H, P) is fp32 and contiguous.
//
// Design (simple and right first):
// - one CTA of 256 threads per (head, batch row); the Pallas grid's
//   sequential chunk axis becomes a loop inside the block, and S stays in
//   shared memory across it (32 KB at N 128, P 64);
// - per chunk the x chunk, l, dt and the state weights dt e^{l_Q - l} are
//   staged in shared memory; the Q rows are then taken in sub-tiles of 16:
//   C of the sub-tile is staged, the masked decay matrix
//   M[t, s] = (C_t . B_s) e^{min(l_t - l_s, 0)} dt_s is formed for s <= t
//   only (16 x Q, never the whole Q x Q), and y = M @ x + (C e^l) @ S_prev
//   is written out; only after the last sub-tile is S updated;
// - B is staged in slabs of 32 rows (rows padded by one word, so a warp
//   reading one column of a slab hits 32 banks), once per sub-tile for
//   C B^T and once, scaled by dt e^{l_Q - l}, for the state update, whose
//   dot sums into a second (N, P) buffer; shared memory then holds about
//   133 KB at Q 128 and 175 KB at Q 256 (N 128, P 64), above the 48 KB
//   default, so the launcher raises the kernel's dynamic shared-memory limit;
// - all arithmetic is fp32 on the CUDA cores, not the tensor cores: TF32
//   would round the operands to 10 mantissa bits, and the reference's dots
//   are full fp32.  expf, not __expf; no fast-math.
//
// FMA contraction: nvcc contracts a * b + c into one fused multiply-add by
// default.  It applies here to the running sums of the three dots (C . B,
// M @ x and (C e^l) @ S, and the state update's sum over s), which is how a
// dot accumulates on this card; the plain version's matmuls sum in another
// order anyway, so the two agree within a stated tolerance, not bit for bit.
// The elementwise steps the reference rounds one by one (the decay ratio,
// M's two products, the state's e^{l_Q} S + update) are written with
// __fmul_rn / __fadd_rn, which nvcc never contracts.
//
// Batch invariance: an element of y depends only on its (batch row, head)
// and the chunk order, never on the batch size, so a batch-1 prefill and a
// batched one give the same bits.
//
// What bounds it on an H100: operations.  Per (batch row, chunk, head) the
// causal half of C B^T and of M @ x takes Q(Q+1)/2 (N + P) FMAs and the carry
// and the state update 2 Q N P, about 3.7 M FMAs at Q 128, N 128, P 64,
// against some 0.4 MB of bytes; one layer of a 256-step prefill (24 heads,
// 2 chunks) is 0.35 GFLOP, 5.3 us at the fp32 rate of 67 TFLOP/s, while its
// 3.5 MB take 1 us at 3.35 TB/s.  A batch-1 prefill runs only H = 24 CTAs on
// 132 SMs, so this kernel sits well above that bound; sharing C B^T across
// heads, tensor-core products with split fp32 operands and more CTAs a head
// are later work.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int R = 16;   // rows of a sub-tile
constexpr int SB = 32;  // rows of B in a staged slab

__global__ void __launch_bounds__(THREADS)
    ssd_scan_kernel(const float* __restrict__ x, long long sxb, long long sxl,
                    long long sxh, const float* __restrict__ dt,
                    long long sdb, long long sdl, long long sdh,
                    const float* __restrict__ lg,  // contiguous (b, L, H)
                    const float* __restrict__ Bm, long long sbb,
                    long long sbl, const float* __restrict__ Cm,
                    long long scb, long long scl,
                    float* __restrict__ y,  // contiguous (b, L, H, P)
                    int L, int H, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int NB = N + 1;       // padded slab row: conflict-free column reads
  float* S = smem;            // N * P   state
  float* Sd = S + N * P;      // N * P   the state update's dot
  float* xs = Sd + N * P;     // Q * P   x chunk
  float* lq = xs + Q * P;     // Q       log decay
  float* dq = lq + Q;         // Q       dt
  float* wq = dq + Q;         // Q       dt e^{l_Q - l}
  float* Cs = wq + Q;         // R * N   C rows of the sub-tile
  float* Ms = Cs + R * N;     // R * Q   masked decay matrix of the sub-tile
  float* Bs = Ms + R * Q;     // SB * NB a slab of B (or of B dt e^{l_Q - l})

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float* xb = x + b * sxb + h * sxh;
  const float* db = dt + b * sdb + h * sdh;
  const float* lb = lg + static_cast<long long>(b) * L * H + h;
  const float* Bb = Bm + b * sbb;
  const float* Cb = Cm + b * scb;
  float* yb = y + (static_cast<long long>(b) * L * H + h) * P;

  for (int i = tid; i < N * P; i += THREADS) S[i] = 0.f;

  for (int c0 = 0; c0 < L; c0 += Q) {
    for (int i = tid; i < Q * P; i += THREADS) {
      const int s = i / P, p = i % P;
      xs[i] = xb[(c0 + s) * sxl + p];
    }
    for (int i = tid; i < Q; i += THREADS) {
      lq[i] = lb[static_cast<long long>(c0 + i) * H];
      dq[i] = db[(c0 + i) * sdl];
    }
    __syncthreads();
    const float lQ = lq[Q - 1];
    for (int i = tid; i < Q; i += THREADS)
      wq[i] = __fmul_rn(dq[i], expf(__fadd_rn(lQ, -lq[i])));

    // y, one sub-tile of R rows at a time, from the state before this chunk
    for (int t0 = 0; t0 < Q; t0 += R) {
      const int rows = min(R, Q - t0);
      const int cols = t0 + rows;  // only s < cols can meet s <= t
      for (int i = tid; i < rows * N; i += THREADS) {
        const int r = i / N, n = i % N;
        Cs[i] = Cb[(c0 + t0 + r) * scl + n];
      }
      for (int s0 = 0; s0 < cols; s0 += SB) {
        const int sn = min(SB, cols - s0);
        for (int i = tid; i < sn * N; i += THREADS) {
          const int j = i / N, n = i % N;
          Bs[j * NB + n] = Bb[(c0 + s0 + j) * sbl + n];
        }
        __syncthreads();
        for (int i = tid; i < rows * sn; i += THREADS) {
          const int r = i / sn, s = s0 + i % sn, t = t0 + r;
          float m = 0.f;
          if (s <= t) {
            const float* Cr = Cs + r * N;
            const float* Br = Bs + (s - s0) * NB;
            float cb = 0.f;
            for (int n = 0; n < N; ++n) cb += Cr[n] * Br[n];
            const float ratio = expf(fminf(__fadd_rn(lq[t], -lq[s]), 0.f));
            m = __fmul_rn(__fmul_rn(cb, ratio), dq[s]);
          }
          Ms[r * Q + s] = m;
        }
        __syncthreads();  // the slab is rewritten next
      }
      for (int i = tid; i < rows * P; i += THREADS) {
        const int r = i / P, p = i % P, t = t0 + r;
        const float* Mr = Ms + r * Q;
        float intra = 0.f;
        for (int s = 0; s <= t; ++s) intra += Mr[s] * xs[s * P + p];
        const float el = expf(lq[t]);
        const float* Cr = Cs + r * N;
        float carry = 0.f;
        for (int n = 0; n < N; ++n) carry += __fmul_rn(Cr[n], el) * S[n * P + p];
        yb[static_cast<long long>(c0 + t) * H * P + p] = __fadd_rn(intra, carry);
      }
      __syncthreads();  // Cs and Ms are rewritten by the next sub-tile
    }

    // only then the state: S = e^{l_Q} S + (B dt e^{l_Q - l})^T @ x
    for (int i = tid; i < N * P; i += THREADS) Sd[i] = 0.f;
    for (int s0 = 0; s0 < Q; s0 += SB) {
      const int sn = min(SB, Q - s0);
      for (int i = tid; i < sn * N; i += THREADS) {
        const int j = i / N, n = i % N;
        Bs[j * NB + n] = __fmul_rn(Bb[(c0 + s0 + j) * sbl + n], wq[s0 + j]);
      }
      __syncthreads();
      for (int i = tid; i < N * P; i += THREADS) {
        const int n = i / P, p = i % P;
        float acc = Sd[i];
        for (int j = 0; j < sn; ++j) acc += Bs[j * NB + n] * xs[(s0 + j) * P + p];
        Sd[i] = acc;
      }
      __syncthreads();
    }
    const float eQ = expf(lQ);
    for (int i = tid; i < N * P; i += THREADS)
      S[i] = __fadd_rn(__fmul_rn(eQ, S[i]), Sd[i]);
    __syncthreads();  // S is read, and xs, lq, dq, wq rewritten, next chunk
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for (N, P, Q), in bytes.
long long ssd_scan_smem_bytes(int N, int P, int Q) {
  const long long n = N, p = P, q = Q;
  return static_cast<long long>(sizeof(float)) *
         (2 * n * p + q * p + 3 * q + R * n + R * q + SB * (n + 1));
}

// Strides are in elements; the innermost dim of x, B and C (and dt's H
// dim through sdh) is addressed through them too, except P and N, which
// must be contiguous.  L must be a multiple of Q.  Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() (0 on success).
int ssd_scan_launch(const void* x, long long sxb, long long sxl,
                    long long sxh, const void* dt, long long sdb,
                    long long sdl, long long sdh, const void* l,
                    const void* B, long long sbb, long long sbl,
                    const void* C, long long scb, long long scl, void* y,
                    int batch, int L, int H, int P, int N, int Q,
                    void* stream) {
  if (batch <= 0 || L <= 0 || H <= 0) return 0;
  if (Q <= 0 || L % Q != 0 || P <= 0 || N <= 0 || H > 65535 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = ssd_scan_smem_bytes(N, P, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, batch);
  ssd_scan_kernel<<<grid, THREADS, static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), sxb, sxl, sxh,
      static_cast<const float*>(dt), sdb, sdl, sdh,
      static_cast<const float*>(l), static_cast<const float*>(B), sbb, sbl,
      static_cast<const float*>(C), scb, scl, static_cast<float*>(y), L, H, P,
      N, Q);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
