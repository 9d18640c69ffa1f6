// The numerics mirrors for Hopper (sm_90a): glibc's sinf, XLA's inline f32
// log / log2 / exp, and the GLSL pow that the reference's jitted fusions
// compute as exp(log(x) * c), one f32 element in, one f32 element out.
//
// Replaces no TPU kernel: these are the functions that the reference's
// jitted XLA fusions execute inline on the CPU (XLA's CPU code calls
// libm's sinf; its log and exp are inline Cephes polynomials), which the
// port repeats bit for bit in policy.sinf32 / logf32 / log2f32 / expf32 as
// float64 and int64 tensor passes (20 to 40 a call). This kernel is the
// same arithmetic in one pass over the tensor: every rounding is written
// out with __dmul_rn / __dadd_rn / __dsub_rn and __fmul_rn / __fadd_rn /
// __fsub_rn, and the file is built with -fmad=false besides, so nothing
// is contracted into an FMA that the plain version does not take.
//
// The multiply-adds of log and exp. The plain versions take policy.fma32
// there (the f32 product exact in f64, one f64 add, narrowed to f32, as
// csrc/fma.cu computes it), which differs from a single-rounding __fmaf_rn only
// where the f64 sum is inexact and lands on an f32 tie. Here every one of
// them is __fmaf_rn: over all 2^32 f32 inputs of log and of exp, the
// kernel with __fmaf_rn at all 20 sites, and with it at each site alone,
// gives the bits of the kernel with the f64 formula at every input
// (tools/torch_mirror_kernel_variants.py --sites on an H100); the exhaustive
// sweeps of chip_smoke.py's phase 26 and tests/test_torch_cuda.py hold the
// kernel to the plain versions at every input again. A pow is exp of
// (log's result times c), so it keeps the bits too. The f64 formula cost
// each multiply-add two f64 operations and about two f32 <-> f64
// conversions, which issue 16 a clock per SM (f64 operations 64, f32
// 128): 44 conversions a pow element, 2.4 ms of crt-mattias's output
// gamma, against one FFMA now.
//
// sin always takes both reductions, chosen per element (|x| >= 120: the
// 96-bit fixed-point product with 2/pi, glibc's reduce_large); for
// |x| < 120 that gives the bits of the plain version's below_120 form.
// Comparisons are written out as the plain code's torch.where / clamp,
// so NaN propagates where it does there (fminf / fmaxf would drop it).
//
// What bounds it: bytes, for log, log2, exp and pow (an element moves 8
// bytes; pow does 20 FFMA, 6 FADD and 6 FMUL, exp 9, 1 and 2); sin does
// 11 to 15 f64 operations and its two conversions. Design: one thread per
// 4 elements with 16-byte loads and stores where both pointers are 16-byte
// aligned (a contiguous tensor the caching allocator hands out is),
// grid-stride, the op a template parameter so each instantiation is
// straight-line code.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

enum Op { kSin = 0, kLog = 1, kLog2 = 2, kExp = 3, kPow = 4 };

// glibc's sinf constants (policy._HPI_INV, _HPI, _PI63, _SIN_S, _SIN_C) and
// the bits of 2/pi in byte-stepped 32-bit windows (policy._INV_PIO4).
__constant__ uint32_t kInvPio4[24] = {
    0xa2u,       0xa2f9u,     0xa2f983u,   0xa2f9836eu, 0xf9836e4eu, 0x836e4e44u,
    0x6e4e4415u, 0x4e441529u, 0x441529fcu, 0x1529fc27u, 0x29fc2757u, 0xfc2757d1u,
    0x2757d1f5u, 0x57d1f534u, 0xd1f534ddu, 0xf534ddc0u, 0x34ddc0dbu, 0xddc0db62u,
    0xc0db6295u, 0xdb629599u, 0x6295993cu, 0x95993c43u, 0x993c4390u, 0x3c439041u,
};
constexpr double kHpiInv = 0x1.45f306dc9c883p+23;
constexpr double kHpi = 0x1.921fb54442d18p+0;
constexpr double kPi63 = 0x1.921fb54442d18p-62;
constexpr double kS1 = -0x1.555545995a603p-3, kS2 = 0x1.1107605230bc4p-7, kS3 = -0x1.994eb3774cf24p-13;
constexpr double kC0 = 0x1p+0, kC1 = -0x1.ffffffd0c621cp-2, kC2 = 0x1.55553e1068f19p-5,
                 kC3 = -0x1.6c087e89a359dp-10, kC4 = 0x1.99343027bf8c3p-16;

// XLA's log and exp (policy._SQRTHF, _LOG_C, _LN2_*, _LOG2E, _EXP_*).
constexpr float kFltMin = 0x1p-126f;
constexpr float kSqrtHf = 0x1.6a09e6p-1f;
constexpr float kLogA = 0x1.204376p-4f, kLogB = -0x1.d7a37p-4f, kLogC = 0x1.de4a34p-4f,
                kLogD = -0x1.fcba9ep-4f, kLogF = 0x1.23d37ep-3f, kLogG = -0x1.555cap-3f,
                kLogH = 0x1.999d58p-3f, kLogI = -0x1.fffff8p-3f, kLogJ = 0x1.555554p-2f;
constexpr float kLn2Lo = -0x1.bd0106p-13f;
constexpr float kLn2Hi = 0x1.63p-1f;
constexpr float kLog2e = 0x1.715476p+0f;
constexpr float kExpLo = -0x1.5f3334p+6f, kExpHi = 0x1.633334p+6f;
constexpr float kExp0 = 0x1.a0d2cep-13f, kExp1 = 0x1.6e879cp-10f, kExp2 = 0x1.111210p-7f,
                kExp3 = 0x1.555382p-5f, kExp4 = 0x1.555554p-3f;

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

// policy.sinf32 (glibc's sinf).
__device__ __forceinline__ float sin_mirror(float x) {
  const float ax = fabsf(x);
  if (ax < 0x1p-12f) return x;  // glibc's tiny-argument return (keeps -0.0)
  double xr;
  int n, sign;
  if (ax >= 120.0f) {
    // policy._reduce_large on |x|: |x| * 4/pi in 96-bit fixed point. The
    // sign is applied last.
    const uint32_t xi = __float_as_uint(ax);
    const int idx = (xi >> 26) & 15;
    const uint32_t m = ((xi & 0xffffffu) | 0x800000u) << ((xi >> 23) & 7);
    uint64_t res0 = static_cast<uint64_t>(m * kInvPio4[idx]);
    const uint64_t res1 = static_cast<uint64_t>(m) * kInvPio4[idx + 4];
    const uint64_t res2 = static_cast<uint64_t>(m) * kInvPio4[idx + 8];
    res0 = (res2 >> 32) | (res0 << 32);
    res0 += res1;
    const uint64_t q = ((res0 + (1ull << 61)) >> 62) & 3;
    res0 -= q << 62;
    xr = __dmul_rn(static_cast<double>(static_cast<int64_t>(res0)), kPi63);
    n = static_cast<int>(q);
    sign = (x < 0.0f ? -1 : 1) * (1 - (n & 2));
  } else {
    // n = round(x * 2/pi) through 2^24 fixed point (a truncating cast,
    // in range for |x| < 120; NaN gives NaN whatever n is).
    const double xd = static_cast<double>(x);
    n = (__double2int_rz(__dmul_rn(xd, kHpiInv)) + 0x800000) >> 24;
    xr = __dsub_rn(xd, __dmul_rn(static_cast<double>(n), kHpi));
    sign = 1 - (n & 2);
  }
  const double x2 = __dmul_rn(xr, xr);
  double r;
  if (n & 1) {
    const double x4 = __dmul_rn(x2, x2);
    r = __dadd_rn(__dadd_rn(__dadd_rn(kC0, __dmul_rn(x2, kC1)), __dmul_rn(x4, kC2)),
                  __dmul_rn(__dmul_rn(x4, x2), __dadd_rn(kC3, __dmul_rn(x2, kC4))));
  } else {
    const double x3 = __dmul_rn(xr, x2);
    r = __dadd_rn(__dadd_rn(xr, __dmul_rn(x3, kS1)),
                  __dmul_rn(__dmul_rn(x3, x2), __dadd_rn(kS2, __dmul_rn(x2, kS3))));
  }
  if (isinf(x)) return quiet_nan();
  return __double2float_rn(__dmul_rn(r, static_cast<double>(sign)));
}

// policy.logf32 (XLA's inline f32 log).
__device__ __forceinline__ float log_mirror(float x) {
  const float xc = x > kFltMin ? x : kFltMin;  // subnormals, 0, negatives and NaN
  const int bits = __float_as_int(xc);
  float e = __fadd_rn(static_cast<float>((bits >> 23) - 127), 1.0f);
  const float m = __int_as_float((bits & static_cast<int>(0x807fffffu)) | 0x3f000000);
  const bool small = m < kSqrtHf;
  const float xm = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  const float z = __fmul_rn(xm, xm);
  const float x3 = __fmul_rn(z, xm);
  const float y0 = __fmaf_rn(__fmaf_rn(xm, kLogA, kLogB), xm, kLogC);
  const float y1 = __fmaf_rn(__fmaf_rn(xm, kLogD, kLogF), xm, kLogG);
  const float y2 = __fmaf_rn(__fmaf_rn(xm, kLogH, kLogI), xm, kLogJ);
  const float p = __fmaf_rn(__fmaf_rn(__fmaf_rn(y0, x3, y1), x3, y2), x3, __fmul_rn(e, kLn2Lo));
  float r = __fmaf_rn(e, kLn2Hi, __fadd_rn(__fmaf_rn(z, -0.5f, xm), p));
  if (!(x >= kFltMin)) r = quiet_nan();
  if (fabsf(x) < kFltMin) r = -INFINITY;
  if (x == INFINITY) r = INFINITY;
  return r;
}

// policy.expf32 (XLA's inline f32 exp).
__device__ __forceinline__ float exp_mirror(float x) {
  x = x < kExpLo ? kExpLo : x;
  x = x > kExpHi ? kExpHi : x;
  float fx = floorf(__fmaf_rn(x, kLog2e, 0.5f));
  fx = fx < -127.0f ? -127.0f : fx;  // torch.clamp: NaN stays NaN
  fx = fx > 127.0f ? 127.0f : fx;
  const float r = __fmaf_rn(fx, -kLn2Lo, __fmaf_rn(fx, -kLn2Hi, x));
  const float p = __fmaf_rn(__fmaf_rn(__fmaf_rn(__fmaf_rn(__fmaf_rn(r, kExp0, kExp1), r, kExp2), r, kExp3), r, kExp4), r, 0.5f);
  const float y = __fadd_rn(__fmaf_rn(p, __fmul_rn(r, r), r), 1.0f);
  const int n = isnan(fx) ? 0 : __float2int_rz(fx);  // nan_to_num(fx).to(int32); fx is integral in [-127, 127]
  const float out = __fmul_rn(y, __int_as_float((n + 127) << 23));
  return out < kFltMin ? 0.0f : out;  // a subnormal result flushes to zero
}

template <int OP>
__device__ __forceinline__ float apply(float x, float c) {
  if (OP == kSin) return sin_mirror(x);
  if (OP == kLog) return log_mirror(x);
  if (OP == kLog2) return __fmul_rn(log_mirror(x), kLog2e);
  if (OP == kExp) return exp_mirror(x);
  return exp_mirror(__fmul_rn(log_mirror(x), c));  // kPow: graph/kernels._glsl_pow
}

template <int OP, bool VEC>
__global__ void __launch_bounds__(kThreads) mirror_kernel(const float* __restrict__ x, float* __restrict__ out,
                                                          int64_t n, float c) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t done = 0;
  if (VEC) {
    const int64_t n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t j = i; j < n4; j += stride) {
      float4 v = __ldcs(x4 + j);
      v.x = apply<OP>(v.x, c);
      v.y = apply<OP>(v.y, c);
      v.z = apply<OP>(v.z, c);
      v.w = apply<OP>(v.w, c);
      __stcs(o4 + j, v);
    }
    done = n4 << 2;
  }
  for (int64_t j = done + i; j < n; j += stride) out[j] = apply<OP>(__ldcs(x + j), c);
}

template <int OP>
void launch(const float* x, float* out, int64_t n, float c, cudaStream_t s) {
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int64_t units = vec ? (n >> 2) + 1 : n;
  const int blocks = static_cast<int>(units / kThreads + 1 < kMaxBlocks ? units / kThreads + 1 : kMaxBlocks);
  if (vec) {
    mirror_kernel<OP, true><<<blocks, kThreads, 0, s>>>(x, out, n, c);
  } else {
    mirror_kernel<OP, false><<<blocks, kThreads, 0, s>>>(x, out, n, c);
  }
}

}  // namespace

// x, out: f32 [n] contiguous (out may not alias x). op: 0 sin, 1 log,
// 2 log2, 3 exp, 4 pow with the f32 constant c (exp(log(x) * c)).
// Launches on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unknown op.
extern "C" int mirrors_launch(const float* x, float* out, long long n, int op, float c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kSin: launch<kSin>(x, out, n, c, s); break;
    case kLog: launch<kLog>(x, out, n, c, s); break;
    case kLog2: launch<kLog2>(x, out, n, c, s); break;
    case kExp: launch<kExp>(x, out, n, c, s); break;
    case kPow: launch<kPow>(x, out, n, c, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
