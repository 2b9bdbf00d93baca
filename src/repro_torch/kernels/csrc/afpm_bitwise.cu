// Bit-level AFPM elementwise multiply (the paper's AC-n-n / ACL-n datapath)
// for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/afpm_bitwise.py::
// afpm_bitwise_pallas (body _kernel -> src/repro/core/afpm.py::afpm_mult_f32).
//
// What it computes: out[i] = AFPM(x[i], y[i]) on fp32 carriers, bit for bit
// the reference's uint32 datapath: decode (optionally into a narrower
// storage format: mantissa truncated, exponent rebiased and clipped,
// subnormals flushed), mantissa segments A/B and C/D of n bits, AC always,
// AD/BC executed or bypassed with shift compensation, BD omitted, a 3n-bit
// accumulator (AC-n-n) or the ACL-n bitwise-AND term, normalisation, then
// the exception rules (overflow -> inf, underflow and flushed operands -> 0,
// inf and nan operands).  NaN results are 0x7fc00000, the reference's
// jnp.nan.  inf/nan/finite are classed from the operand bits, never by
// float compares, so nvcc's flush-to-zero setting cannot reach them.
//
// Design (simple and right first):
// - one thread per element in a grid-stride loop (not unrolled, so the
//   loop body is what one element costs), 4-byte loads and stores that
//   neighbouring threads take from neighbouring addresses; the tail is the
//   loop bound, so nothing is padded in device memory (the TPU kernel pads
//   to (256, 256) tiles with jnp.resize);
// - the widths (n, the storage mantissa width, bias, all-ones exponent) are
//   runtime values in a small struct passed by value; the mode (AC/ACL),
//   whether the storage format is fp32, and the ablation knobs
//   (conditional, compensation, skip_bd) are template parameters, so each
//   config's kernel carries no branch on them;
// - every shift count is below 32 for every config the wrapper accepts:
//   23 - M, M - n, M - 2n and 3n - T all lie in [0, 23].
//
// What bounds it on an H100: 12 bytes an element (two fp32 reads, one
// write) at 3.35 TB/s.  The loop body is 56 (ACL-n) to about 120 (AC-n-n
// with narrow storage) SASS instructions an element; at the card's
// instruction rate (132 SMs x 4 schedulers x 32 lanes x 1.98 GHz) they
// take less time than the bytes, though not at the INT32 rate alone (64
// lanes an SM).
// chip_smoke.py counts the instructions from the built kernel's SASS and
// times the kernel against both; at 8192 x 8192 it reached 64% (AC5-5)
// and 77% (ACL5) of the byte bound on an H100 80GB HBM3 (PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 4096;
constexpr uint32_t INF_BITS = 0x7F800000u;
constexpr uint32_t NAN_BITS = 0x7FC00000u;

struct Params {
  int n;           // segment width
  int M;           // storage mantissa width
  int bias;        // storage exponent bias
  int emax_field;  // storage all-ones exponent field
};

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

// approximate cross term Mx*My in units of 2^-3n (AC-n-n)
template <bool COND, bool COMP, bool SKIP_BD>
__device__ __forceinline__ uint32_t ac_cross(uint32_t mx, uint32_t my, int n,
                                             int M) {
  const uint32_t lo = (1u << n) - 1u;
  const uint32_t A = mx >> (M - n), B = (mx >> (M - 2 * n)) & lo;
  const uint32_t C = my >> (M - n), D = (my >> (M - 2 * n)) & lo;
  const uint32_t AD = A * D, BC = B * C;
  uint32_t ad = AD, bc = BC;
  if (COND) {
    // bypass when the upper n-2 bits of the low operand are zero, unless
    // the other high segment is zero (the paper's forced products)
    const bool exec_ad = (D >> 2) != 0u || (C == 0u && A != 0u && D != 0u);
    const bool exec_bc = (B >> 2) != 0u || (A == 0u && C != 0u && B != 0u);
    const uint32_t comp_ad = (COMP && A != 0u && D != 0u) ? A << 1 : 0u;
    const uint32_t comp_bc = (COMP && C != 0u && B != 0u) ? C << 1 : 0u;
    ad = exec_ad ? AD : comp_ad;
    bc = exec_bc ? BC : comp_bc;
  }
  uint32_t cross = ((A * C) << n) + ad + bc;
  if (!SKIP_BD) cross += (B * D) >> n;
  return cross;
}

template <bool ACL, bool FULL, bool COND, bool COMP, bool SKIP_BD>
__device__ __forceinline__ uint32_t afpm_bits(uint32_t xb, uint32_t yb,
                                              const Params& p) {
  const int M = FULL ? 23 : p.M;
  const int bias = FULL ? 127 : p.bias;
  const int emax = FULL ? 255 : p.emax_field;
  const int n = p.n;
  uint32_t ex, mx, ey, my;
  decode<FULL>(xb, p, ex, mx);
  decode<FULL>(yb, p, ey, my);
  const uint32_t sign = (xb ^ yb) & 0x80000000u;

  int T;
  uint32_t acc;
  if (!ACL) {
    T = min(3 * n, M);  // accumulator fractional width
    const uint32_t cross = ac_cross<COND, COMP, SKIP_BD>(mx, my, n, M);
    // linear terms use the mantissas truncated to their upper T bits
    acc = (1u << T) + (mx >> (M - T)) + (my >> (M - T)) + (cross >> (3 * n - T));
  } else {
    T = n;
    const uint32_t A = mx >> (M - n), C = my >> (M - n);
    acc = (1u << T) + A + C + (A & C);
  }
  // normalise on the two integer bits of the accumulator (product in [1, 4))
  const uint32_t U = 1u << T;
  const bool ge2 = acc >= (U << 1);
  const uint32_t man_res = ((ge2 ? acc >> 1 : acc) - U) << (M - T);
  const int e_unb = static_cast<int>(ex) - bias + static_cast<int>(ey) - bias +
                    static_cast<int>(ge2);
  uint32_t res = sign | (static_cast<uint32_t>(e_unb + 127) << 23) |
                 (man_res << (23 - M));

  // exception rules, in the reference's order
  const uint32_t s_inf = sign | INF_BITS;
  if (e_unb > emax - 1 - bias) res = s_inf;
  if (e_unb < 1 - bias) res = sign;
  const uint32_t xa = xb & 0x7FFFFFFFu, ya = yb & 0x7FFFFFFFu;
  const bool any_zero = ex == 0u || ey == 0u;  // zero or flushed subnormal
  if (any_zero && xa < INF_BITS && ya < INF_BITS) res = sign;
  const bool inf_in = xa == INF_BITS || ya == INF_BITS;
  if (inf_in) res = s_inf;
  if (xa > INF_BITS || ya > INF_BITS || (inf_in && any_zero)) res = NAN_BITS;
  return res;
}

template <bool ACL, bool FULL, bool COND, bool COMP, bool SKIP_BD>
__global__ void __launch_bounds__(THREADS)
    afpm_bitwise_kernel(const uint32_t* __restrict__ x,
                        const uint32_t* __restrict__ y,
                        uint32_t* __restrict__ out, long long count,
                        Params p) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
#pragma unroll 1
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       i < count; i += stride)
    out[i] = afpm_bits<ACL, FULL, COND, COMP, SKIP_BD>(__ldg(x + i), __ldg(y + i), p);
}

using KernelFn = void (*)(const uint32_t*, const uint32_t*, uint32_t*,
                          long long, Params);

template <bool FULL>
KernelFn ac_kernel(int conditional, int compensation, int skip_bd) {
  switch ((conditional ? 4 : 0) | (compensation ? 2 : 0) | (skip_bd ? 1 : 0)) {
    case 0: return afpm_bitwise_kernel<false, FULL, false, false, false>;
    case 1: return afpm_bitwise_kernel<false, FULL, false, false, true>;
    case 2: return afpm_bitwise_kernel<false, FULL, false, true, false>;
    case 3: return afpm_bitwise_kernel<false, FULL, false, true, true>;
    case 4: return afpm_bitwise_kernel<false, FULL, true, false, false>;
    case 5: return afpm_bitwise_kernel<false, FULL, true, false, true>;
    case 6: return afpm_bitwise_kernel<false, FULL, true, true, false>;
    default: return afpm_bitwise_kernel<false, FULL, true, true, true>;
  }
}

}  // namespace

extern "C" {

// x, y, out: `count` contiguous fp32 values (as bits).  acl selects ACL-n;
// full says the storage format is fp32 itself (man_bits 23, exp_bits 8).
// The ablation knobs only shape AC-n-n.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
int afpm_bitwise_launch(const void* x, const void* y, void* out,
                        long long count, int seg_n, int man_bits, int bias,
                        int max_exp_field, int acl, int full, int conditional,
                        int compensation, int skip_bd, void* stream) {
  if (count < 0 || seg_n < 0 || man_bits < 0 || man_bits > 23 ||
      seg_n > man_bits || (!acl && 2 * seg_n > man_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  if (count == 0) return 0;
  KernelFn fn;
  if (acl)
    fn = full ? afpm_bitwise_kernel<true, true, false, false, true>
              : afpm_bitwise_kernel<true, false, false, false, true>;
  else
    fn = full ? ac_kernel<true>(conditional, compensation, skip_bd)
              : ac_kernel<false>(conditional, compensation, skip_bd);
  const long long want = (count + THREADS - 1) / THREADS;
  const dim3 grid(static_cast<unsigned>(want < MAX_BLOCKS ? want : MAX_BLOCKS));
  Params p{seg_n, man_bits, bias, max_exp_field};
  const uint32_t* xp = static_cast<const uint32_t*>(x);
  const uint32_t* yp = static_cast<const uint32_t*>(y);
  uint32_t* op = static_cast<uint32_t*>(out);
  void* args[] = {&xp, &yp, &op, &count, &p};
  const cudaError_t err =
      cudaLaunchKernel(reinterpret_cast<const void*>(fn), grid, dim3(THREADS),
                       args, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clears a launch error too
  return static_cast<int>(err != cudaSuccess ? err : last);
}

const char* afpm_bitwise_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
