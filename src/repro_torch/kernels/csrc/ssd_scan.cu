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
//         + (C_t e^{l_t}) @ S_c                                    (carry)
//   S_c+1 = e^{l_Q} S_c + dS_c,  dS_c = sum_s (B_s dt_s e^{l_Q - l_s})^T x_s
// with the (N, P) fp32 state S_0 = 0.  x (batch, L, H, P), dt and l
// (batch, L, H), B and C (batch, L, N), shared by every head, are read in
// that public layout through their strides; nothing is transposed on the
// host.  y (batch, L, H, P) is fp32 and contiguous.
//
// What bounds it on an H100: operations.  At H 24, P 64, N 128, Q 128 a
// chunk needs C B^T once (Q(Q+1)/2 N FMAs, shared by the heads) and per
// head M @ x (Q(Q+1)/2 P), the carry (Q N P, not on the first chunk) and
// dS (Q N P, not on the last chunk): some 2.7 M FMAs a (chunk, head)
// against 0.1 MB of its inputs.  All of it is fp32 on the CUDA cores: TF32
// would round the operands to 10 mantissa bits, and the reference's dots
// are full fp32.
//
// Design: a call launches two kernels, and every part of a chunk that does
// not need the state runs in parallel across chunks:
// - chunk_kernel, 256 threads a task.  A C B^T task forms one 64 x 64
//   tile of a chunk's lower triangle, once per (batch row, chunk), into a
//   workspace (s-major, rows padded to a multiple of 4).  A state task
//   forms one 64 x 64 tile of dS_c for (chunk c < nc - 1, head), writes it
//   to a workspace slot and counts itself in with an integer counter per
//   (batch row, head, tile); the last of a tile's tasks to arrive walks the
//   chunks in order, S_c+1 = e^{l_Q} S_c + dS_c with the reference's two
//   roundings, 4 slots read ahead, and leaves S_c+1 in slot c (then zeroes
//   the counter for the next call).  A tile's tasks are consecutive, so
//   their walk overlaps the other tiles' work.  No float is ever summed
//   with an atomic, and a walk is the same arithmetic whichever CTA does it.
// - output_kernel, 128 threads per (chunk, head, 32 rows, 64 columns of
//   P): M = CB e^{min(l_t - l_s, 0)} dt_s is formed in shared memory from
//   the workspace as its slabs land, y = M @ x over the slabs a warp's rows
//   reach (the causal mask is on the chunk, s <= t, t < Q, not on the
//   tile), plus (C e^l) @ S_c for c > 0.  Small tiles give a batch-1
//   prefill of 256 steps 192 CTAs for the 132 SMs.
// - every dot is an outer product over slabs of 32 k, k-major and swizzled
//   in shared memory, a 4 x 4 register tile a thread: one float4 of each
//   operand a k step for 16 FMAs.  Slabs arrive by cp.async, 4 in flight,
//   one barrier a slab; a thread forms (scales, masks) exactly what it
//   copied, so no extra barrier is needed.  Rows along m go 16 bytes a copy
//   where they are aligned (the workspaces always are); rows along k go 4
//   bytes a copy, 8 consecutive k a run, so a warp reads whole sectors.
// - nothing is wasted on what y does not need: no dS for the last chunk,
//   no carry for the first, so a single chunk (prompts of 40 and 77) is
//   C B^T and M @ x alone.
// What holds it back (PERF.md): the 4 x 4 tiles read shared memory
// once for every 8 FMAs, the per-head expf of M and the 4-byte copies of
// the rows along k cost about as much again, and the walk is serial per
// tile; a batch-1 call also pays chunk_decay's PyTorch cumsum, a serial
// scan of Q steps that takes longer than both kernels at the served
// lengths.
//
// FMA contraction: nvcc contracts a * b + c into one fused multiply-add by
// default.  It applies here to the running sums of the dots (C . B, M @ x,
// (C e^l) @ S and the sum over s of dS), each summed in index order, which
// is how a dot accumulates on this card; the plain version's matmuls sum in
// another order, so the two agree within a stated tolerance, not bit for
// bit.  The elementwise steps the reference rounds one by one (the decay
// ratio, M's two products, the state weights and B's scaling, C e^l, the
// state's e^{l_Q} S + dS and intra + carry) are written with __fmul_rn /
// __fadd_rn, which nvcc never contracts; expf, not __expf; no fast-math.
//
// Batch invariance: the tiles and grids depend on (L, Q, H, P, N) alone
// (the batch is the grid's second dimension), so an element's arithmetic
// is a function of its (batch row, head) and the chunk order, and a
// batch-1 prefill and a batched one give the same bits.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int KS = 32;         // depth of a staged slab
constexpr int TA = 64;         // chunk_kernel's tile: 64 x 64 outputs
constexpr int THREADS_A = 256;
constexpr int ROWS = 32;       // output_kernel's tile: 32 rows x 64 of P
constexpr int TP = 64;
constexpr int THREADS_B = 128;
constexpr int DEPTH = 4;       // state slots the walk reads ahead
constexpr int STAGES = 4;      // slabs in flight

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// 4-byte asynchronous copy to shared memory, zero-filled when !ok (then
// nothing is read); the issuing thread sees it after cp_wait.
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
// 16-byte asynchronous copy of the first `bytes` (0 to 16) of src, the
// rest zero-filled; src and dst 16-byte aligned.
__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// every group but the newest STAGES - 2 has landed
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

// A slab is KS x TM, k-major, with element (k, m) at k TM + (m ^ 4 (k % 8)):
// the swizzle keeps every aligned float4 of a row together and spreads a
// column's 8 consecutive k over the 32 banks.
template <int TM>
__device__ __forceinline__ int at(int k, int m) {
  return k * TM + (m ^ ((k & 7) << 2));
}
// The (k, m) a thread copies as element i of a slab whose source rows run
// along k (B and C for C B^T, C for the carry): runs of 8 k, so a warp
// reads 32 bytes of each of 4 source rows and writes 32 distinct banks.
// Slabs whose source rows run along m (x, S, dS's B, the C B^T workspace)
// are copied 4 elements at a time (copy4).
template <int TM>
__device__ __forceinline__ void along_k(int i, int& k, int& m) {
  k = (i & 7) | (i / (8 * TM)) << 3;
  m = (i >> 3) % TM;
}

// Elements m to m + 3 (m a multiple of 4) of slab row k from src, of which
// the first n (clamped to 0..4) are real and the rest zeros: one 16-byte
// copy when src is 16-byte aligned (vec), else four 4-byte ones.  base is
// any valid address, read in no case.
template <int TM>
__device__ __forceinline__ void copy4(float* slab, int k, int m,
                                      const float* src, int n,
                                      const float* base, bool vec) {
  const int c = n < 0 ? 0 : n > 4 ? 4 : n;
  float* d = slab + at<TM>(k, m);
  if (vec) {
    cp16(d, c ? src : base, 4 * c);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) cp4(d + e, e < c ? src + e : base, e < c);
  }
}

// acc[i][j] += sum_k As[k][4 rg + i] * Bs[k][4 cg + j] over one slab; As
// is KS x TM, Bs KS x TN, both k-major and swizzled: a 4 x 4 register tile,
// 16 FMAs for two float4 reads a k step.
template <int TM, int TN>
__device__ __forceinline__ void slab_fma(const float* As, const float* Bs,
                                         int rg, int cg, float (&acc)[4][4]) {
#pragma unroll 8
  for (int k = 0; k < KS; ++k) {
    const float4 u = *reinterpret_cast<const float4*>(As + at<TM>(k, 4 * rg));
    const float4 v = *reinterpret_cast<const float4*>(Bs + at<TN>(k, 4 * cg));
    const float a[4] = {u.x, u.y, u.z, u.w}, b[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
  }
}

__global__ void __launch_bounds__(THREADS_A, 2)
    chunk_kernel(const float* __restrict__ x, long long sxb, long long sxl,
                 long long sxh, const float* __restrict__ dt, long long sdb,
                 long long sdl, long long sdh,
                 const float* __restrict__ lg,  // contiguous (b, L, H)
                 const float* __restrict__ Bm, long long sbb, long long sbl,
                 const float* __restrict__ Cm, long long scb, long long scl,
                 float* __restrict__ cbt,  // (b, nc, Q, Qp), s-major
                 float* ds,                // (b, nc - 1, H, N, Pp)
                 int* count,               // (b, H, tiles of N, tiles of P)
                 int L, int H, int P, int N, int Q, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                     // STAGES slabs of KS x TA
  float* Bs = As + STAGES * KS * TA;    // STAGES slabs of KS x TA
  float* wq = Bs + STAGES * KS * TA;    // Q state weights dt e^{l_Q - l}
  __shared__ int last;

  const int nc = L / Q;
  const int tq = cdiv(Q, TA);
  const int tri = tq * (tq + 1) / 2;  // C B^T tiles of one chunk
  const int tn = cdiv(N, TA), tp = cdiv(P, TA);
  const int Qp = cdiv(Q, 4) * 4, Pp = cdiv(P, 4) * 4;  // padded rows
  const int b = blockIdx.y;
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  int task = blockIdx.x;
  float acc[4][4] = {};

  if (task < nc * tri) {
    // C B^T tile: rows s (B), columns t (C), s-tile <= t-tile
    const int c = task / tri;
    int k = task % tri, ti = 0;
    while (k > ti) k -= ++ti;
    const int s0 = k * TA, t0 = ti * TA;
    const float* Bb = Bm + b * sbb + static_cast<long long>(c) * Q * sbl;
    const float* Cb = Cm + b * scb + static_cast<long long>(c) * Q * scl;
    auto issue = [&](int n0, int st) {
      for (int i = tid; i < KS * TA; i += THREADS_A) {
        int k, r;
        along_k<TA>(i, k, r);
        const int n = n0 + k;
        const bool bo = n < N && s0 + r < Q, co = n < N && t0 + r < Q;
        cp4(As + st * KS * TA + at<TA>(k, r),
            bo ? Bb + (s0 + r) * sbl + n : Bb, bo);
        cp4(Bs + st * KS * TA + at<TA>(k, r),
            co ? Cb + (t0 + r) * scl + n : Cb, co);
      }
      cp_commit();
    };
    const int ns = cdiv(N, KS);
    for (int j = 0; j < STAGES - 1; ++j)
      if (j < ns) issue(j * KS, j); else cp_commit();
    for (int j = 0; j < ns; ++j) {
      cp_wait();
      __syncthreads();  // slab j is in; every thread is done with j - 1
      if (j + STAGES - 1 < ns)
        issue((j + STAGES - 1) * KS, (j + STAGES - 1) % STAGES);
      else
        cp_commit();
      slab_fma<TA, TA>(As + j % STAGES * KS * TA, Bs + j % STAGES * KS * TA,
                          rg, cg, acc);
    }
    float* out = cbt + (static_cast<long long>(b) * nc + c) * Q * Qp;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + 4 * rg + i, t = t0 + 4 * cg + j;
        if (s < Q && t < Q) out[static_cast<long long>(s) * Qp + t] = acc[i][j];
      }
    return;
  }

  // dS tile of chunk c < nc - 1 and head h: rows n, columns p, sum over s.
  // A tile's chunks are consecutive tasks, so they run together and its
  // walk overlaps other tiles' work
  task -= nc * tri;
  const int nch = nc - 1;
  const int c = task % nch, tile = task / nch;
  const int h = tile / (tn * tp);
  const int ni = tile % (tn * tp) / tp, pi = tile % tp;
  const int n0 = ni * TA, p0 = pi * TA;
  const long long c0 = static_cast<long long>(c) * Q;
  const float* lb = lg + static_cast<long long>(b) * L * H + h;
  const float* Bb = Bm + b * sbb + c0 * sbl + n0;
  const float* xb = x + b * sxb + c0 * sxl + h * sxh + p0;
  auto issue = [&](int s0, int st) {
    for (int g = tid; g < KS * TA / 4; g += THREADS_A) {
      const int k = g / (TA / 4), m = 4 * (g % (TA / 4)), s = s0 + k;
      const bool in = s < Q;
      copy4<TA>(As + st * KS * TA, k, m, Bb + s * sbl + m, in ? N - n0 - m : 0,
                Bm, vec & 2);
      copy4<TA>(Bs + st * KS * TA, k, m, xb + s * sxl + m, in ? P - p0 - m : 0,
                x, vec & 1);
    }
    cp_commit();
  };
  const int ns = cdiv(Q, KS);
  for (int j = 0; j < STAGES - 1; ++j)
    if (j < ns) issue(j * KS, j); else cp_commit();
  const float lQ = lb[(c0 + Q - 1) * H];
  for (int s = tid; s < Q; s += THREADS_A)
    wq[s] = __fmul_rn(dt[b * sdb + (c0 + s) * sdl + h * sdh],
                      expf(__fadd_rn(lQ, -lb[(c0 + s) * H])));
  __syncthreads();
  for (int j = 0; j < ns; ++j) {
    cp_wait();
    float* as = As + j % STAGES * KS * TA;
    // B's rows scaled by their state weight, each by the thread that
    // copied it (zero-filled elements stay zero)
    for (int g = tid; g < KS * TA / 4; g += THREADS_A) {
      const int k = g / (TA / 4), m = 4 * (g % (TA / 4)), s = j * KS + k;
      if (s < Q) {
        float* a = as + at<TA>(k, m);
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = __fmul_rn(a[e], wq[s]);
      }
    }
    __syncthreads();  // slab j is in and scaled; every thread is done with j - 1
    if (j + STAGES - 1 < ns)
      issue((j + STAGES - 1) * KS, (j + STAGES - 1) % STAGES);
    else
      cp_commit();
    slab_fma<TA, TA>(as, Bs + j % STAGES * KS * TA, rg, cg, acc);
  }

  const long long slot = static_cast<long long>(H) * N * Pp;
  float* dsb = ds + (static_cast<long long>(b) * nch * H + h) * N * Pp;
  const int nr = 4 * rg, pc = 4 * cg;
  const bool in = n0 + nr < N && p0 + pc < P;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + nr + i < N && p0 + pc + j < P)
        dsb[c * slot + (n0 + nr + i) * Pp + p0 + pc + j] = acc[i][j];
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = count + ((static_cast<long long>(b) * H + h) * tn + ni) * tp + pi;
    last = atomicAdd(cnt, 1) == nch - 1;
    if (last) *cnt = 0;  // every task of the tile has arrived
  }
  __syncthreads();
  if (!last || !in) return;
  __threadfence();

  // the chunks in order: slot cc becomes S_cc+1 = e^{l_Q} S_cc + dS_cc,
  // DEPTH slots read at once, a float4 of a padded row at a time (its
  // padding is never read back)
  float4 S[4] = {};
  for (int cc0 = 0; cc0 < nch; cc0 += DEPTH) {
    float4 d[DEPTH][4];
    float lq[DEPTH];
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      const bool on = cc0 + u < nch;
      lq[u] = on ? lb[(static_cast<long long>(cc0 + u) * Q + Q - 1) * H] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        d[u][i] = on && n0 + nr + i < N
                      ? __ldcg(reinterpret_cast<const float4*>(
                            dsb + (cc0 + u) * slot + (n0 + nr + i) * Pp + p0 +
                            pc))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      if (cc0 + u >= nch) break;
      const float eQ = expf(lq[u]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        S[i].x = __fadd_rn(__fmul_rn(eQ, S[i].x), d[u][i].x);
        S[i].y = __fadd_rn(__fmul_rn(eQ, S[i].y), d[u][i].y);
        S[i].z = __fadd_rn(__fmul_rn(eQ, S[i].z), d[u][i].z);
        S[i].w = __fadd_rn(__fmul_rn(eQ, S[i].w), d[u][i].w);
        if (n0 + nr + i < N)
          *reinterpret_cast<float4*>(dsb + (cc0 + u) * slot +
                                     (n0 + nr + i) * Pp + p0 + pc) = S[i];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS_B)
    output_kernel(const float* __restrict__ x, long long sxb, long long sxl,
                  long long sxh, const float* __restrict__ dt, long long sdb,
                  long long sdl, long long sdh,
                  const float* __restrict__ lg,  // contiguous (b, L, H)
                  const float* __restrict__ Cm, long long scb, long long scl,
                  const float* __restrict__ cbt,  // (b, nc, Q, Qp), s-major
                  const float* __restrict__ ds,   // S_c in slot c - 1
                  float* __restrict__ y,          // contiguous (b, L, H, P)
                  int L, int H, int P, int N, int Q, int vec) {
  constexpr int R = ROWS, THREADS = THREADS_B;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                    // STAGES slabs of KS x R
  float* Bs = As + STAGES * KS * R;    // STAGES slabs of KS x TP
  float* el = Bs + STAGES * KS * TP;   // R      e^{l_t} of the tile's rows
  float* lq = el + R;             // Q      l of the chunk
  float* dq = lq + Q;             // Q      dt of the chunk

  const int nc = L / Q;
  const int tr = cdiv(Q, R), tp = cdiv(P, TP);
  const int Qp = cdiv(Q, 4) * 4, Pp = cdiv(P, 4) * 4;  // padded rows
  const int b = blockIdx.y;
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  // the longest row tiles (the most causal work) first
  const int task = blockIdx.x;
  const int per_r = nc * H * tp;
  const int ri = tr - 1 - task / per_r;
  const int c = task % per_r / (H * tp);
  const int h = task % (H * tp) / tp, pi = task % tp;
  const int t0 = ri * R, p0 = pi * TP;
  const int rows = min(R, Q - t0), smax = t0 + rows;
  const long long c0 = static_cast<long long>(c) * Q;
  const float* lb = lg + static_cast<long long>(b) * L * H + h;
  const float* xb = x + b * sxb + c0 * sxl + h * sxh + p0;
  const float* cb = cbt + (static_cast<long long>(b) * nc + c) * Q * Qp + t0;
  const float* Cb = Cm + b * scb + (c0 + t0) * scl;
  const float* S =
      ds + ((static_cast<long long>(b) * (nc - 1) + c - 1) * H + h) * N * Pp + p0;

  // slab j < ni is M @ x over s in [32 j, 32 j + 32), the rest the carry
  // (C e^l) @ S_c over n (none on the first chunk)
  const int ni = cdiv(smax, KS), ns = ni + (c > 0 ? cdiv(N, KS) : 0);
  auto issue = [&](int j) {
    float* as = As + j % STAGES * KS * R;
    float* bs = Bs + j % STAGES * KS * TP;
    if (j < ni) {
      for (int g = tid; g < KS * R / 4; g += THREADS) {
        const int k = g / (R / 4), m = 4 * (g % (R / 4)), s = j * KS + k;
        copy4<R>(as, k, m, cb + static_cast<long long>(s) * Qp + m,
                 s < smax ? rows - m : 0, cbt, true);
      }
      for (int g = tid; g < KS * TP / 4; g += THREADS) {
        const int k = g / (TP / 4), m = 4 * (g % (TP / 4)), s = j * KS + k;
        copy4<TP>(bs, k, m, xb + s * sxl + m, s < smax ? P - p0 - m : 0, x,
                  vec & 1);
      }
    } else {
      const int n0 = (j - ni) * KS;
      for (int i = tid; i < KS * R; i += THREADS) {
        int k, r;
        along_k<R>(i, k, r);
        const bool ok = r < rows && n0 + k < N;
        cp4(as + at<R>(k, r), ok ? Cb + r * scl + n0 + k : Cb, ok);
      }
      for (int g = tid; g < KS * TP / 4; g += THREADS) {
        const int k = g / (TP / 4), m = 4 * (g % (TP / 4)), n = n0 + k;
        copy4<TP>(bs, k, m, S + static_cast<long long>(n) * Pp + m,
                  n < N ? P - p0 - m : 0, ds, true);
      }
    }
    cp_commit();
  };
  for (int j = 0; j < STAGES - 1; ++j)
    if (j < ns) issue(j); else cp_commit();
  for (int i = tid; i < smax; i += THREADS) {
    lq[i] = lb[(c0 + i) * H];
    dq[i] = dt[b * sdb + (c0 + i) * sdl + h * sdh];
  }
  for (int i = tid; i < R; i += THREADS)
    el[i] = i < rows ? expf(lb[(c0 + t0 + i) * H]) : 0.f;
  __syncthreads();

  float acc[4][4] = {}, car[4][4] = {};
  // the warp's rows: a slab of M wholly above them (s > t) is all zeros
  const int warp_last = t0 + (tid / 32 + 1) * 8 - 1;
  for (int j = 0; j < ns; ++j) {
    cp_wait();
    float* as = As + j % STAGES * KS * R;
    const float* bs = Bs + j % STAGES * KS * TP;
    // each thread forms what it copied: M = CB e^{min(l_t - l_s, 0)} dt_s
    // for s <= t and 0 above, or C e^{l_t}
    if (j < ni) {
      for (int g = tid; g < KS * R / 4; g += THREADS) {
        const int k = g / (R / 4), m = 4 * (g % (R / 4)), s = j * KS + k;
        float* a = as + at<R>(k, m);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m + e;
          float v = 0.f;  // s > t: C B^T there is not M's
          if (r < rows && s <= t0 + r) {
            const float ratio = expf(fminf(__fadd_rn(lq[t0 + r], -lq[s]), 0.f));
            v = __fmul_rn(__fmul_rn(a[e], ratio), dq[s]);
          }
          a[e] = v;
        }
      }
    } else {
      for (int i = tid; i < KS * R; i += THREADS) {
        int k, r;
        along_k<R>(i, k, r);
        if (r < rows) as[at<R>(k, r)] = __fmul_rn(as[at<R>(k, r)], el[r]);
      }
    }
    __syncthreads();  // slab j is in and formed; every thread is done with j - 1
    if (j + STAGES - 1 < ns) issue(j + STAGES - 1); else cp_commit();
    if (j >= ni)
      slab_fma<R, TP>(as, bs, rg, cg, car);
    else if (j * KS <= warp_last)
      slab_fma<R, TP>(as, bs, rg, cg, acc);
  }

  float* yb = y + ((static_cast<long long>(b) * L + c0 + t0) * H + h) * P + p0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * rg + i, col = 4 * cg + j;
      if (r < rows && p0 + col < P)
        yb[static_cast<long long>(r) * H * P + col] =
            __fadd_rn(acc[i][j], car[i][j]);
    }
}

long long output_smem(int Q) {
  return static_cast<long long>(sizeof(float)) *
         (STAGES * KS * (ROWS + TP) + ROWS + 2 * static_cast<long long>(Q));
}

long long chunk_smem(int Q) {
  return static_cast<long long>(sizeof(float)) *
         (2 * STAGES * KS * TA + static_cast<long long>(Q));
}

}  // namespace

extern "C" {

// Dynamic shared memory the larger of the two kernels needs at chunk Q, in
// bytes (the wrapper checks it against the card's 227 KB).
long long ssd_scan_smem_bytes(int Q) {
  const long long a = chunk_smem(Q), b = output_smem(Q);
  return a > b ? a : b;
}

// Strides are in elements; P and N must be contiguous.  L must be a
// multiple of Q; bit 0 of `vec` says x's rows (bit 1: B's) may be copied 16
// bytes at a time (16-byte aligned base, strides multiples of 4); grid_a
// and grid_b are the plan's CTAs a batch row of the two kernels
// (kernels/ssd_scan.py::plan, which covers each kernel's tiles once).  cbt
// holds batch * (L / Q) * Q * Qp floats, ds batch * (L / Q - 1) * H * N * Pp
// (Qp, Pp: Q and P rounded up to multiples of 4), count batch * H *
// ceil(N / 64) * ceil(P / 64) ints, zero on entry (the kernel leaves them
// zero).  Launches both kernels on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 on success).
int ssd_scan_launch(const void* x, long long sxb, long long sxl,
                    long long sxh, const void* dt, long long sdb,
                    long long sdl, long long sdh, const void* l,
                    const void* B, long long sbb, long long sbl,
                    const void* C, long long scb, long long scl, void* y,
                    void* cbt, void* ds, void* count, int batch, int L, int H,
                    int P, int N, int Q, int vec, int grid_a, int grid_b,
                    void* stream) {
  if (batch <= 0 || L <= 0 || H <= 0) return 0;
  if (Q <= 0 || L % Q != 0 || P <= 0 || N <= 0 || batch > 65535 ||
      grid_a <= 0 || grid_b <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(dt);
  const float* lf = static_cast<const float*>(l);
  const float* Cf = static_cast<const float*>(C);
  float* cbf = static_cast<float*>(cbt);
  float* dsf = static_cast<float*>(ds);
  const long long smem_a = chunk_smem(Q);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_a));
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_kernel<<<dim3(grid_a, batch), THREADS_A,
                 static_cast<size_t>(smem_a), s>>>(
      xf, sxb, sxl, sxh, df, sdb, sdl, sdh, lf, static_cast<const float*>(B),
      sbb, sbl, Cf, scb, scl, cbf, dsf, static_cast<int*>(count), L, H, P, N,
      Q, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem_b = output_smem(Q);
  err = cudaFuncSetAttribute(output_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_b));
  if (err != cudaSuccess) return static_cast<int>(err);
  output_kernel<<<dim3(grid_b, batch), THREADS_B,
                  static_cast<size_t>(smem_b), s>>>(
      xf, sxb, sxl, sxh, df, sdb, sdl, sdh, lf, Cf, scb, scl, cbf, dsf,
      static_cast<float*>(y), L, H, P, N, Q, vec);
  err = cudaGetLastError();
  return static_cast<int>(err);
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
