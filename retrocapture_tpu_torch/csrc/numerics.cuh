// The port's f32 numerics mirrors as device functions, for every kernel that
// computes them: glibc's sinf, XLA's inline f32 log and exp, the GLSL pow
// that the reference's jitted fusions compute as exp(log(x) * c), and
// policy.fma32's multiply-add (the f64 sum narrowed once).
//
// csrc/mirrors.cu runs the first four elementwise (the operator
// rctpu::mirror), csrc/fma.cu the last (rctpu::fma), and
// csrc/mattias_epilogue.cu all of them inside crt-mattias's epilogue. Each
// function gives the bits of its plain version in policy (the mirrors'
// exhaustive card test holds sin, log and exp to them over all 2^32
// inputs). Every rounding is written out with __dmul_rn / __dadd_rn /
// __dsub_rn and __fmul_rn / __fadd_rn / __fsub_rn, and a source that
// includes this file is built with -fmad=false (ops/cuda/_build.py), so
// nothing is contracted into an FMA that the plain version does not take.
//
// The multiply-adds of log and exp are __fmaf_rn: their plain versions take
// policy.fma32 there, and over all 2^32 f32 inputs of log and of exp
// __fmaf_rn at all 20 sites, and at each site alone, gives the bits of the
// f64 formula at every input (tools/torch_mirror_kernel_variants.py
// --sites on an H100). A pow is exp of (log's result times c), so it keeps
// the bits too.
//
// sin always takes both reductions, chosen per element (|x| >= 120: the
// 96-bit fixed-point product with 2/pi, glibc's reduce_large); for
// |x| < 120 that gives the bits of the plain version's below_120 form.
// Comparisons are written out as the plain code's torch.where / clamp,
// so NaN propagates where it does there (fminf / fmaxf would drop it).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// graph/kernels._glsl_pow: exp(log(x) * c), c the folded f32 constant.
__device__ __forceinline__ float pow_mirror(float x, float c) { return exp_mirror(__fmul_rn(log_mirror(x), c)); }

// policy.fma32: a*b + c rounded once to f32. The product of two f32 values
// is exact in f64 (48 bits of 53; no f32 product leaves the f64 range), so
// __dmul_rn is exact; __dadd_rn rounds the sum to f64 and __double2float_rn
// narrows it to f32. That equals __fmaf_rn except where the f64 sum is
// inexact and lands on an f32 tie: there the second rounding goes to even
// (a = b = 1 + 2^-12, c = 2^-80: this gives 1 + 2^-11, __fmaf_rn
// 1 + 2^-11 + 2^-23).
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)), static_cast<double>(c)));
}

}  // namespace
