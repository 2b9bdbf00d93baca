// Bit-level AFPM multiply (the paper's AC-n-n / ACL-n datapath) for Hopper:
// an elementwise entry and an emulated-matmul entry.
//
// Replaces the TPU kernel src/repro/kernels/afpm_bitwise.py::
// afpm_bitwise_pallas (body _kernel -> src/repro/core/afpm.py::afpm_mult_f32).
// The emulated matmul is src/repro/core/afpm.py::afpm_matmul_emulated, which
// the JAX package writes in jnp around the same datapath and leaves to XLA to
// fuse; eager PyTorch fuses nothing, so on the card it is a kernel here.
//
// The product: AFPM(x, y) on fp32 carriers, bit for bit the reference's
// uint32 datapath: decode (optionally into a narrower storage format:
// mantissa truncated, exponent rebiased and clipped, subnormals flushed),
// mantissa segments A/B and C/D of n bits, AC always, AD/BC executed or
// bypassed with shift compensation, BD omitted, a 3n-bit accumulator
// (AC-n-n) or the ACL-n bitwise-AND term, normalisation, then the exception
// rules (overflow -> inf, underflow and flushed operands -> 0, inf and nan
// operands).  NaN results are 0x7fc00000, the reference's jnp.nan.
// inf/nan/finite are classed from the operand bits, never by float
// compares, so nvcc's flush-to-zero setting cannot reach them.
//
// The datapath is cut in two, so that a matmul decodes each operand once:
// - decode_operand: one operand -> a 16-byte record (Rec).  The bypass and
//   compensation of AD depend on C, D and on A only through A * D = 0 when
//   A = 0, so they fold into the w operand: AD' = A * D' with D' = D when
//   it is executed (D >> 2 != 0, or the forced case C = 0) or zero, else
//   2 (the compensation A << 1) or 0 (no compensation); BC' = B' * C
//   likewise.  So cross = (AC << n) + AD' + B'C = A * ((C << n) + D') +
//   B' * C (mod 2^32, as the reference's uint32 wraps).  The record holds
//   the segments, that multiplier, the linear term (w's with the
//   accumulator's one added) and an exponent word: the sign at bit 31 and
//   the unbiased storage exponent plus an offset, or a class code
//   (zero/flushed, inf, nan) in its place;
// - product: two records -> the product's bits: two multiplies and adds
//   for the accumulator, a shift for the normalisation bit, one add of the
//   exponent words (which adds the signs too: bit 31 is their xor), the
//   assembly, and three selects for the exception rules, which read the
//   classes off the summed exponent word (section "exponent word"); its
//   adds are multiply-adds, which the FMA pipe takes (see product).
// Both entries use the same two functions, so a K = 1 emulated matmul is
// the elementwise product.
//
// Elementwise entry: one thread four elements an iteration of a
// grid-stride loop, 16-byte loads and stores when every pointer is 16-byte
// aligned, and one element an iteration otherwise and for the tail.  Bound
// on an H100 by its bytes (12 an element at 3.35 TB/s) or its instructions
// an element (decode twice and the product; chip_smoke.py counts them from
// the built kernel's SASS), whichever is larger.
//
// Emulated-matmul entry: out (M, N) fp32 = x (M, K) @ w (K, N) with every
// product AFPM's.  The canonical order (the same for every M, N and plan,
// so an element depends only on its row of x, its column of w, K and
// k_chunk):
// - K is cut into chunks of k_chunk from k = 0 (the last may be short);
// - a chunk's sum starts at +0 and adds its products in ascending k with
//   IEEE fp32 adds (the same value as starting from the first product:
//   the two differ only in the sign of a zero sum, which the next add
//   absorbs);
// - out starts at +0 and adds the chunk sums in chunk order, IEEE fp32.
// Columns of K beyond K are absent (the reference pads with zeros, whose
// products are +0 and change no sum's value).
// What bounds it: integer instructions, some twenty a product and one fp32
// add; the tensor cores cannot help, and the ALU pipe's half rate counts
// as much as their number (see product).  Design:
// - a CTA of 256 threads owns a 64 x 64 output tile, 4 x 4 outputs a
//   thread (rows ty + 16 i, columns tx + 16 j);
// - K goes in steps of 32: the raw x and w tiles of step s + 2 are copied
//   into shared memory with cp.async (two slots) while step s computes;
//   each step's operands are decoded once into records in shared memory
//   (x[m, k] feeds 64 products of the tile, w[k, n] 64), and the inner loop
//   reads 4 + 4 records (16-byte loads) for its 16 products;
// - split mode, for calls with few tiles: the grid's z splits the chunks
//   into groups, one CTA a (tile, group); every chunk's sum goes to a
//   workspace, and the tile's last CTA (an integer counter, no float
//   atomics) folds them in chunk order: the same bits as whole mode, where
//   one CTA walks every chunk and folds in registers.
// The wrapper's plan (kernels/afpm_bitwise.py::plan) picks the mode and the
// groups; neither changes the arithmetic.
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;  // a CTA's threads (the elementwise entry's most)
constexpr int MAX_DEVICES = 64;
constexpr uint32_t INF_BITS = 0x7F800000u;
constexpr uint32_t NAN_BITS = 0x7FC00000u;

// Exponent word.  x's holds e_x + OFF_X, w's e_w + OFF_W below the sign,
// e the unbiased storage exponent of a normal operand, or ZERO_E (zero or
// flushed subnormal), INF_E or NAN_E.  Their sum em (sign masked; the
// product compares 2 em, whose sign is shifted out) then lands in a range
// of its own for each class pair, with e_unb = e_x + e_w + the
// normalisation bit:
//   normal x normal:  e_unb + OFF_SUM, e_unb in [-254, 257];
//   zero x finite:    at most ZERO_E + 129 + OFF_SUM, below every
//                     underflow threshold (result: signed zero);
//   inf x finite/inf: at least INF_E - 127 + OFF_SUM, above every overflow
//                     threshold (result: signed inf);
//   zero x inf:       ZERO_INF or ZERO_INF + 1 (result: NaN);
//   nan x anything:   at least NAN_MIN (result: NaN).
// OFF_SUM = 126 (mod 512): em's low 9 bits are e_unb + 126, the result's
// exponent field less the implicit one that the mantissa adds.
constexpr int ZERO_E = -1024, INF_E = 8192, NAN_E = 65536;
constexpr int OFF_X = 2048, OFF_W = 2174, OFF_SUM = OFF_X + OFF_W;
static_assert(OFF_SUM % 512 == 126, "em's low 9 bits must be e_unb + 126");
constexpr uint32_t ZERO_INF = ZERO_E + INF_E + OFF_SUM;
constexpr uint32_t NAN_MIN = ZERO_E + NAN_E + OFF_SUM;

struct Params {
  int n;            // segment width
  int M;            // storage mantissa width
  int bias;         // storage exponent bias
  int emax_field;   // storage all-ones exponent field
  int hi_shift;     // M - n: the high segment A / C
  int lo_shift;     // M - 2n: the low segment B / D (AC-n-n)
  int lin_shift;    // M - T: the linear terms, T the accumulator's width
  uint32_t unit;    // 1 << T: the accumulator's one
  int cross_shift;  // 3n - T: the cross term into the accumulator
  int norm_shift;   // T + 1: acc >> norm_shift is the normalisation bit
  uint32_t man_mul;  // 2^(23 - T): the accumulator's fraction into fp32's
  uint32_t over2;   // 2 em above this overflows to inf
  uint32_t under2;  // 2 em below this underflows to zero
  // constants the product multiplies by, given at run time so that nvcc
  // issues those adds and shifts as IMADs (see product)
  uint32_t one, two, exp_mul, zero_inf_neg2;
};

// T = 3n clipped to the mantissa (AC-n-n) or n (ACL-n)
Params make_params(int n, int man_bits, int bias, int max_exp_field, bool acl) {
  const int three_n = 3 * n;
  const int T = acl ? n : (three_n < man_bits ? three_n : man_bits);
  Params p;
  p.n = n;
  p.M = man_bits;
  p.bias = bias;
  p.emax_field = max_exp_field;
  p.hi_shift = man_bits - n;
  p.lo_shift = acl ? 0 : man_bits - 2 * n;
  p.lin_shift = man_bits - T;
  p.unit = 1u << T;
  p.cross_shift = acl ? 0 : three_n - T;
  p.norm_shift = T + 1;
  p.man_mul = 1u << (23 - T);
  p.over2 = 2u * static_cast<uint32_t>(max_exp_field - 1 - bias + OFF_SUM);
  p.under2 = 2u * static_cast<uint32_t>(1 - bias + OFF_SUM);
  p.one = 1u;
  p.two = 2u;
  p.exp_mul = 1u << 23;
  p.zero_inf_neg2 = 0u - 2u * ZERO_INF;
  return p;
}

// fp32 bits -> (biased exponent field, mantissa field) of the storage format
template <bool FULL>
__device__ __forceinline__ void decode(uint32_t bits, const Params& p,
                                       uint32_t& e, uint32_t& m) {
  const uint32_t man32 = bits & 0x7FFFFFu;
  const uint32_t exp32 = (bits >> 23) & 0xFFu;
  if (FULL) {
    e = exp32;
    m = man32;
    return;
  }
  uint32_t man = man32 >> (23 - p.M);
  int ef = static_cast<int>(exp32) - 127 + p.bias;
  ef = ef < 0 ? 0 : (ef > p.emax_field ? p.emax_field : ef);
  uint32_t exp = static_cast<uint32_t>(ef);
  // flush values outside the format's normal range
  if (exp == 0u || exp == static_cast<uint32_t>(p.emax_field)) man = 0u;
  // keep the inf/nan class of the fp32 operand
  if (exp32 == 255u) {
    exp = static_cast<uint32_t>(p.emax_field);
    if (man32 != 0u) man = 1u;
  }
  e = exp;
  m = man;
}

// One decoded operand (16 bytes: one shared-memory load).
struct Rec {
  uint32_t seg;  // high segment A (C); | low segment B (D) << 16 if BD is kept
  uint32_t mul;  // x: B'; w: (C << n) + D' (AC-n-n; 0 in ACL-n)
  uint32_t lin;  // x: its linear term; w: the accumulator's one + its own
  uint32_t exs;  // the exponent word
};

// x (W = false) or w (W = true) operand -> its record
template <bool ACL, bool FULL, bool COND, bool COMP, bool SKIP_BD, bool W>
__device__ __forceinline__ Rec decode_operand(uint32_t bits, const Params& p) {
  uint32_t e, m;
  decode<FULL>(bits, p, e, m);
  const uint32_t a = bits & 0x7FFFFFFFu;
  const int bias = FULL ? 127 : p.bias;
  const int ev = a > INF_BITS   ? NAN_E
                 : a == INF_BITS ? INF_E
                 : e == 0u       ? ZERO_E
                                 : static_cast<int>(e) - bias;
  Rec r;
  r.exs = (bits & 0x80000000u) | static_cast<uint32_t>(ev + (W ? OFF_W : OFF_X));
  const uint32_t A = m >> p.hi_shift;
  if (ACL) {
    r.seg = A;
    r.mul = 0u;
    r.lin = W ? p.unit + A : A;
    return r;
  }
  const uint32_t B = (m >> p.lo_shift) & ((1u << p.n) - 1u);
  // bypassed (the low segment's upper n-2 bits zero, not forced by a zero
  // high segment, and both segments nonzero): the compensation's 2 or 0
  uint32_t eff = B;
  if (COND && (B >> 2) == 0u && A != 0u && B != 0u) eff = COMP ? 2u : 0u;
  r.seg = SKIP_BD ? A : A | (B << 16);
  r.mul = W ? (A << p.n) + eff : eff;
  r.lin = (m >> p.lin_shift) + (W ? p.unit : 0u);
  return r;
}

// two records -> the product's fp32 bits.  Hopper runs an integer add,
// shift, compare or select on its ALU pipe at half the issue rate, and an
// IMAD on the FMA pipe at the full rate; with the ALU ops alone the
// emulated matmul waits on the ALU pipe.  So the adds, the exponent's shift
// and twice em are written as multiply-adds by Params' run-time 1, 2,
// 2^23 and 2^(23 - T), which nvcc cannot fold away, so that the two
// pipes share a product's instructions.
template <bool ACL, bool SKIP_BD>
__device__ __forceinline__ uint32_t product(const Rec& x, const Rec& w,
                                            const Params& p) {
  uint32_t low;  // the accumulator's term below its linear ones
  if (ACL) {
    low = x.seg & w.seg;
  } else {
    const uint32_t A = SKIP_BD ? x.seg : x.seg & 0xFFFFu;
    const uint32_t C = SKIP_BD ? w.seg : w.seg & 0xFFFFu;
    uint32_t cross = A * w.mul + x.mul * C;  // Mx * My in units of 2^-3n
    if (!SKIP_BD) cross += ((x.seg >> 16) * (w.seg >> 16)) >> p.n;
    low = cross >> p.cross_shift;
  }
  // (1 + Mx)(1 + My) in units of 2^-T, below 4 units
  const uint32_t acc = w.lin * p.one + (low * p.one + x.lin);
  const uint32_t ge2 = acc >> p.norm_shift;  // product in [2, 4)
  const uint32_t e = w.exs * p.one + (ge2 * p.one + x.exs);
  const uint32_t em2 = e * p.two;  // 2 em: the sign shifted out
  // exponent field e_unb + 127 (em's low 9 bits, plus the implicit one
  // that acc's leading bit adds) and fraction, without the sign
  uint32_t mag = e * p.exp_mul + (acc >> ge2) * p.man_mul;
  // the exception rules, in the reference's order
  if (em2 > p.over2) mag = INF_BITS;
  if (em2 < p.under2) mag = 0u;
  uint32_t res = (e & 0x80000000u) | mag;
  if (e * p.two + p.zero_inf_neg2 <= 2u || em2 >= 2u * NAN_MIN) res = NAN_BITS;
  return res;
}

template <bool ACL, bool FULL, bool COND, bool COMP, bool SKIP_BD>
__device__ __forceinline__ uint32_t afpm_bits(uint32_t xb, uint32_t yb,
                                              const Params& p) {
  return product<ACL, SKIP_BD>(
      decode_operand<ACL, FULL, COND, COMP, SKIP_BD, false>(xb, p),
      decode_operand<ACL, FULL, COND, COMP, SKIP_BD, true>(yb, p), p);
}

// ---- elementwise entry ----------------------------------------------------

template <bool ACL, bool FULL, bool COND, bool COMP, bool SKIP_BD>
__global__ void __launch_bounds__(THREADS)
    afpm_bitwise_kernel(const uint32_t* __restrict__ x,
                        const uint32_t* __restrict__ y,
                        uint32_t* __restrict__ out, long long count, int vec,
                        Params p) {
  // blockDim.x threads a CTA (at most THREADS): the launch's CTA shape
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (vec) {  // four elements an iteration: the loop chip_smoke.py counts
    const long long count4 = count >> 2;
    const uint4* x4 = reinterpret_cast<const uint4*>(x);
    const uint4* y4 = reinterpret_cast<const uint4*>(y);
    uint4* o4 = reinterpret_cast<uint4*>(out);
#pragma unroll 1
    for (long long i = first; i < count4; i += stride) {
      const uint4 a = __ldg(x4 + i), b = __ldg(y4 + i);
      uint4 r;
      r.x = afpm_bits<ACL, FULL, COND, COMP, SKIP_BD>(a.x, b.x, p);
      r.y = afpm_bits<ACL, FULL, COND, COMP, SKIP_BD>(a.y, b.y, p);
      r.z = afpm_bits<ACL, FULL, COND, COMP, SKIP_BD>(a.z, b.z, p);
      r.w = afpm_bits<ACL, FULL, COND, COMP, SKIP_BD>(a.w, b.w, p);
      o4[i] = r;
    }
    tail = count4 << 2;
  }
#pragma unroll 1
  for (long long i = tail + first; i < count; i += stride)
    out[i] = afpm_bits<ACL, FULL, COND, COMP, SKIP_BD>(__ldg(x + i), __ldg(y + i), p);
}

// ---- emulated-matmul entry ------------------------------------------------

constexpr int BM = 64, BN = 64;  // output tile of a CTA
constexpr int KT = 32;           // K of one staged step
constexpr int XS = KT + 1;       // raw x row stride: column reads hit 32 banks
constexpr int RAW_X = BM * XS, RAW_W = KT * BN;  // floats of a raw slot
constexpr int EMU_SMEM = KT * (BM + BN) * static_cast<int>(sizeof(Rec)) +
                         2 * (RAW_X + RAW_W) * 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes, or a zero when !ok (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ Rec load_rec(const Rec* r) {
  const uint4 v = *reinterpret_cast<const uint4*>(r);
  return Rec{v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ void store_rec(Rec* r, const Rec& v) {
  *reinterpret_cast<uint4*>(r) = make_uint4(v.seg, v.mul, v.lin, v.exs);
}

// grid (row tiles, column tiles, groups of chunks); one group is whole mode
template <bool ACL, bool FULL, bool COND, bool COMP, bool SKIP_BD>
__global__ void __launch_bounds__(THREADS, 2)
    afpm_emulated_kernel(const float* __restrict__ x,
                         const float* __restrict__ w, float* __restrict__ out,
                         float* __restrict__ part,
                         unsigned* __restrict__ counters, int M, int K, int N,
                         int k_chunk, int group, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned is_last;
  Rec* decx = reinterpret_cast<Rec*>(smem);  // [KT][BM]
  Rec* decw = decx + KT * BM;                // [KT][BN]
  float* raw = reinterpret_cast<float*>(decw + KT * BN);  // 2 x ([BM][XS], [KT][BN])

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const bool split = gridDim.z > 1;
  const int chunks = (K + k_chunk - 1) / k_chunk;
  const int c_first = blockIdx.z * group;
  const int c_stop = min(chunks, c_first + group);
  const int kbeg = c_first * k_chunk;
  const int kend = c_stop < chunks ? c_stop * k_chunk : K;
  const int nsteps = (kend - kbeg + KT - 1) / KT;

  auto load_step = [&](int s) {  // raw tiles of step s into slot s % 2
    if (s >= nsteps) return;
    const int k0 = kbeg + s * KT;
    float* xr = raw + (s & 1) * (RAW_X + RAW_W);
    float* wr = xr + RAW_X;
#pragma unroll
    for (int j = 0; j < BM * KT / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int r = i / KT, c = i % KT;
      const int m = m0 + r, k = k0 + c;
      const bool ok = m < M && k < kend;
      cp_async4(xr + r * XS + c, ok ? x + static_cast<size_t>(m) * K + k : x, ok);
    }
#pragma unroll
    for (int j = 0; j < KT * BN / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int r = i / BN, c = i % BN;
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < kend && n < N;
      cp_async4(wr + i, ok ? w + static_cast<size_t>(k) * N + n : w, ok);
    }
  };

  auto decode_step = [&](int s) {  // slot s % 2 -> the records of step s
    const float* xr = raw + (s & 1) * (RAW_X + RAW_W);
    const float* wr = xr + RAW_X;
#pragma unroll
    for (int j = 0; j < BM * KT / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int r = i % BM, c = i / BM;
      store_rec(decx + c * BM + r,
                decode_operand<ACL, FULL, COND, COMP, SKIP_BD, false>(
                    __float_as_uint(xr[r * XS + c]), p));
    }
#pragma unroll
    for (int j = 0; j < KT * BN / THREADS; ++j) {
      const int i = tid + j * THREADS;
      store_rec(decw + i, decode_operand<ACL, FULL, COND, COMP, SKIP_BD, true>(
                              __float_as_uint(wr[i]), p));
    }
  };

  float acc[4][4], sum[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = sum[i][j] = 0.0f;

  // a chunk's sum is complete at k = boundary: fold it (whole mode) or
  // store it (split mode)
  int chunk = c_first;
  int boundary = kend - kbeg > k_chunk ? kbeg + k_chunk : kend;
  auto end_chunk = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (split) {
          const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
          if (m < M && n < N)
            part[(static_cast<size_t>(chunk) * M + m) * N + n] = sum[i][j];
        } else {
          acc[i][j] = __fadd_rn(acc[i][j], sum[i][j]);
        }
        sum[i][j] = 0.0f;
      }
    ++chunk;
    boundary = kend - boundary > k_chunk ? boundary + k_chunk : kend;
  };

  load_step(0);
  cp_async_commit();
  load_step(1);
  cp_async_commit();
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<1>();  // step s landed (step s + 1 may be in flight)
    __syncthreads();     // ... and every thread is done with step s - 1
    decode_step(s);
    __syncthreads();     // step s's records visible, its raw slot free
    load_step(s + 2);
    cp_async_commit();
    const int k0 = kbeg + s * KT;
    const int klen = min(KT, kend - k0);
    int kk = 0;
    while (kk < klen) {
      const int stop = min(klen, boundary - k0);
#pragma unroll 1
      for (; kk < stop; ++kk) {  // 16 products: the loop chip_smoke.py counts
        Rec xv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = load_rec(decx + kk * BM + ty + 16 * i);
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = load_rec(decw + kk * BN + tx + 16 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sum[i][j] = __fadd_rn(
                sum[i][j], __uint_as_float(product<ACL, SKIP_BD>(xv[i], wv[j], p)));
      }
      if (k0 + kk == boundary) end_chunk();
    }
  }
  cp_async_wait<0>();

  if (!split) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
        if (m < M && n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j];
      }
    return;
  }

  // the last CTA of this tile folds every chunk's sum in chunk order
  __threadfence();
  __syncthreads();
  unsigned* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(counter, 1u) == gridDim.z - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const size_t plane = static_cast<size_t>(M) * N;
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int m = m0 + e / BN, n = n0 + e % BN;
    if (m >= M || n >= N) continue;
    const size_t idx = static_cast<size_t>(m) * N + n;
    float r = 0.0f;
#pragma unroll 8
    for (int c = 0; c < chunks; ++c) r = __fadd_rn(r, __ldcg(part + c * plane + idx));
    out[idx] = r;
  }
  if (tid == 0) *counter = 0u;  // ready for the next call on this stream
}

// ---- instantiation and launch ---------------------------------------------

struct Elementwise {
  template <bool A, bool F, bool C, bool P, bool S>
  static const void* get() {
    return reinterpret_cast<const void*>(afpm_bitwise_kernel<A, F, C, P, S>);
  }
};

struct Emulated {
  template <bool A, bool F, bool C, bool P, bool S>
  static const void* get() {
    return reinterpret_cast<const void*>(afpm_emulated_kernel<A, F, C, P, S>);
  }
};

// the instantiation of a config: ACL ignores the ablation knobs, as the
// reference does
template <class Kind, bool F>
const void* ac_kernel(int variant) {
  switch (variant) {
    case 0: return Kind::template get<false, F, false, false, false>();
    case 1: return Kind::template get<false, F, false, false, true>();
    case 2: return Kind::template get<false, F, false, true, false>();
    case 3: return Kind::template get<false, F, false, true, true>();
    case 4: return Kind::template get<false, F, true, false, false>();
    case 5: return Kind::template get<false, F, true, false, true>();
    case 6: return Kind::template get<false, F, true, true, false>();
    default: return Kind::template get<false, F, true, true, true>();
  }
}

// 0..17: AC fp32 (0-7), AC narrow (8-15), ACL fp32 (16), ACL narrow (17)
int config_index(int acl, int full, int conditional, int compensation,
                 int skip_bd) {
  if (acl) return full ? 16 : 17;
  return (full ? 0 : 8) + (conditional ? 4 : 0) + (compensation ? 2 : 0) +
         (skip_bd ? 1 : 0);
}

template <class Kind>
const void* kernel_for(int index) {
  if (index == 16) return Kind::template get<true, true, false, false, true>();
  if (index == 17) return Kind::template get<true, false, false, false, true>();
  return index < 8 ? ac_kernel<Kind, true>(index) : ac_kernel<Kind, false>(index - 8);
}

bool bad_config(int seg_n, int man_bits, int acl) {
  return seg_n < 0 || man_bits < 0 || man_bits > 23 || seg_n > man_bits ||
         (!acl && 2 * seg_n > man_bits);
}

// run fn on `device`, the caller's device restored after
template <class Fn>
cudaError_t on_device(int device, Fn fn) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = fn();
  if (current != device) cudaSetDevice(current);
  return err;
}

cudaError_t launch(const void* fn, dim3 grid, void** args, int smem,
                   void* stream, int threads = THREADS) {
  const cudaError_t err = cudaLaunchKernel(fn, grid, dim3(threads), args, smem,
                                           static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clears a launch error too
  return err != cudaSuccess ? err : last;
}

}  // namespace

extern "C" {

// x, y, out: `count` contiguous fp32 values (as bits).  acl selects ACL-n;
// full says the storage format is fp32 itself (man_bits 23, exp_bits 8).
// The ablation knobs only shape AC-n-n.  The CTA shape: `threads` a CTA (a
// multiple of 32, at most THREADS) and at most `max_blocks` CTAs, which
// loop over the elements; no shape changes a product.  Launches on
// `stream` on CUDA device `device`, does not synchronise, and returns the
// launch's cudaError_t (0 on success).
int afpm_bitwise_launch(const void* x, const void* y, void* out,
                        long long count, int seg_n, int man_bits, int bias,
                        int max_exp_field, int acl, int full, int conditional,
                        int compensation, int skip_bd, int threads,
                        int max_blocks, int device, void* stream) {
  if (count < 0 || bad_config(seg_n, man_bits, acl) || threads < 32 ||
      threads > THREADS || threads % 32 != 0 || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (count == 0) return 0;
  const void* fn = kernel_for<Elementwise>(
      config_index(acl, full, conditional, compensation, skip_bd));
  int vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
             reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const long long items = vec ? (count + 3) / 4 : count;
  const long long want = (items + threads - 1) / threads;
  const dim3 grid(static_cast<unsigned>(want < max_blocks ? want : max_blocks));
  Params p = make_params(seg_n, man_bits, bias, max_exp_field, acl != 0);
  const void* xp = x;
  const void* yp = y;
  void* op = out;
  void* args[] = {&xp, &yp, &op, &count, &vec, &p};
  return static_cast<int>(
      on_device(device, [&] { return launch(fn, grid, args, 0, stream, threads); }));
}

// x: (M, K) fp32 row-major, w: (K, N) fp32 row-major, out: (M, N) fp32.
// The wrapper's plan gives `group` chunks of k_chunk a CTA and `splits`
// groups (the grid's z; 1 is whole mode).  In split mode `part` holds
// ceil(K / k_chunk) * M * N floats and `counters` ceil(M / 64) *
// ceil(N / 64) zeros (left zero again when the kernel ends).  Launches on
// `stream` on CUDA device `device`, does not synchronise, and returns the
// launch's cudaError_t (0 on success).
int afpm_emulated_launch(const void* x, const void* w, void* out, void* part,
                         void* counters, int M, int K, int N, int k_chunk,
                         int group, int splits, int seg_n, int man_bits,
                         int bias, int max_exp_field, int acl, int full,
                         int conditional, int compensation, int skip_bd,
                         int device, void* stream) {
  if (M < 0 || K < 0 || N < 0 || M > (1 << 30) || K > (1 << 30) ||
      N > (1 << 30) || k_chunk < 1 || group < 1 || splits < 1 ||
      splits > 65535 || (N + BN - 1) / BN > 65535 ||
      bad_config(seg_n, man_bits, acl) ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const int index = config_index(acl, full, conditional, compensation, skip_bd);
  const void* fn = kernel_for<Emulated>(index);
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((N + BN - 1) / BN),
                  static_cast<unsigned>(splits));
  Params p = make_params(seg_n, man_bits, bias, max_exp_field, acl != 0);
  const void* xp = x;
  const void* wp = w;
  void* op = out;
  void* pp = part;
  void* cp = counters;
  void* args[] = {&xp, &wp, &op, &pp, &cp, &M, &K, &N, &k_chunk, &group, &p};
  static std::atomic<bool> raised[MAX_DEVICES][18];  // smem limit, per device
  if (device < 0 || device >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  return static_cast<int>(on_device(device, [&] {
    if (!raised[device][index].load(std::memory_order_acquire)) {
      const cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, EMU_SMEM);
      if (e != cudaSuccess) return e;
      raised[device][index].store(true, std::memory_order_release);
    }
    return launch(fn, grid, args, EMU_SMEM, stream);
  }));
}

const char* afpm_bitwise_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
