// The xbr-lv2 full-resolution epilogue for Hopper (sm_90a).
//
// Replaces the TPU kernel retrocapture_tpu/ops/pallas/xbr_epilogue.py:
// xbr_epilogue. The xbr-lv2 hand kernel reduces the shader to 19 planes at
// [output rows, source columns]: the E, H, F, B, D colours x255 and four
// packed flag codes (S [B, 19, OH, W]). Per output pixel (b, y, x) this
// kernel reads the 19 values at source column bx[x] (a NEAREST
// x-upsample), scales the colours by 1/255, decodes each code into its five
// flags (edri, edr, edr_left, edr_up, px), rebuilds the four fp ramps of
// each corner from fpy[y] and fpx[x], takes their flag-weighted maximum,
// and does the px mixes, res1/res2 and the c_df select; alpha = 1.
//
// The TPU kernel rebuilt the x-upsample from a rotated 128-lane window,
// because Mosaic gathers are single-vreg; that limited it to sources whose
// column span per tile fits the window (xbr_epilogue_fits). Here one thread
// per output pixel reads its 19 values through L1: neighbouring threads of
// an upscale share source columns, so each S row is fetched from DRAM about
// once. No width limit.
//
// What bounds it: bytes. Per frame at 320 -> 1920, 1080 rows it must read
// S (19 x 1080 x 320 x 4 B = 26.3 MB) and write the output (1080 x 1920 x
// 16 B = 33.2 MB): 59.4 MB, 17.7 us at 3.35 TB/s. The arithmetic is about
// 250 f32 operations per pixel (0.52 GFLOP a frame, 7.8 us at 67 TFLOP/s,
// and 24 f64 operations of the contracted mixes). The
// design reads each S element about once from DRAM (L1 reuse across the r
// output columns of one source column) and writes one 16-byte float4 per
// pixel, so both streams are coalesced.
//
// Numerics: every rounding is written out. __fmul_rn/__fadd_rn where the
// reference (jitted XLA on the CPU) rounds each operation; the mixes by a
// fractional ramp weight, which XLA contracts, as the f64 product and sum
// rounded once (__double2float_rn), the formula of the port's policy.fma32.
// So the kernel is bit-equal to the plain torch version; a true fmaf would
// differ from it in rare double-rounding cases.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChannels = 19;

// a + (b - a) * m, m a flag (0 or 1): the product is exact.
__device__ __forceinline__ float mix_flag(float a, float b, float m) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), m));
}

// a + (b - a) * m contracted: the product (b - a) * m is exact in f64, the
// sum is rounded once to f64 and then to f32.
__device__ __forceinline__ float mix_frac(float a, float b, float m) {
  const double p = __dmul_rn(static_cast<double>(__fsub_rn(b, a)), static_cast<double>(m));
  return __double2float_rn(__dadd_rn(p, static_cast<double>(a)));
}

// clip((A fy + B fx + c) * k, 0, 1) from one (A, B, c, k) row of the table.
__device__ __forceinline__ float ramp(const float* t, float fy, float fx) {
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(t), fy), __fmul_rn(__ldg(t + 1), fx)), __ldg(t + 2));
  return fminf(fmaxf(__fmul_rn(s, __ldg(t + 3)), 0.0f), 1.0f);
}

__global__ void xbr_epilogue_kernel(const float* __restrict__ S, const int* __restrict__ bx,
                                    const float* __restrict__ fpx, const float* __restrict__ fpy,
                                    const float* __restrict__ table, float4* __restrict__ out,
                                    int OH, int W, int OW) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= OW) return;
  const size_t plane = static_cast<size_t>(OH) * W;
  const float* s = S + static_cast<size_t>(b) * kChannels * plane + static_cast<size_t>(y) * W + __ldg(bx + x);
  float v[kChannels];
#pragma unroll
  for (int c = 0; c < kChannels; ++c) v[c] = __ldg(s + c * plane);

  const float inv = __ldg(table + 64);
  float E[3], H[3], F[3], B[3], D[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    E[i] = __fmul_rn(v[i], inv);
    H[i] = __fmul_rn(v[3 + i], inv);
    F[i] = __fmul_rn(v[6 + i], inv);
    B[i] = __fmul_rn(v[9 + i], inv);
    D[i] = __fmul_rn(v[12 + i], inv);
  }
  const float fy = __ldg(fpy + y);
  const float fx = __ldg(fpx + x);

  // Codes are integers 0..31 by construction: bit k is the k-th flag, the
  // values the reference's remainder/floor decode gives.
  float m[4], px[4];
#pragma unroll
  for (int ci = 0; ci < 4; ++ci) {
    const int code = static_cast<int>(v[15 + ci]);
    const float edri = static_cast<float>(code & 1);
    const float edr = static_cast<float>((code >> 1) & 1);
    const float edrl = static_cast<float>((code >> 2) & 1);
    const float edru = static_cast<float>((code >> 3) & 1);
    px[ci] = static_cast<float>(code >> 4);
    // table: [ramp][corner][A, B, c, k], ramps fx30, fx60, fx45, fx45i.
    const float r30 = ramp(table + (0 * 4 + ci) * 4, fy, fx);
    const float r60 = ramp(table + (1 * 4 + ci) * 4, fy, fx);
    const float r45 = ramp(table + (2 * 4 + ci) * 4, fy, fx);
    const float r45i = ramp(table + (3 * 4 + ci) * 4, fy, fx);
    m[ci] = fmaxf(fmaxf(__fmul_rn(edrl, r30), __fmul_rn(edru, r60)),
                  fmaxf(__fmul_rn(edr, r45), __fmul_rn(edri, r45i)));
  }

  float res1[3], res2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float tx = mix_flag(H[i], F[i], px[0]);
    const float tz = mix_flag(B[i], D[i], px[2]);
    const float ty = mix_flag(F[i], B[i], px[1]);
    const float tw = mix_flag(D[i], H[i], px[3]);
    res1[i] = mix_frac(mix_frac(E[i], tx, m[0]), tz, m[2]);
    res2[i] = mix_frac(mix_frac(E[i], ty, m[1]), tw, m[3]);
  }
  const float cdf1 = __fadd_rn(__fadd_rn(fabsf(__fsub_rn(E[0], res1[0])), fabsf(__fsub_rn(E[1], res1[1]))),
                               fabsf(__fsub_rn(E[2], res1[2])));
  const float cdf2 = __fadd_rn(__fadd_rn(fabsf(__fsub_rn(E[0], res2[0])), fabsf(__fsub_rn(E[1], res2[1]))),
                               fabsf(__fsub_rn(E[2], res2[2])));
  const float sel = cdf2 >= cdf1 ? 1.0f : 0.0f;
  out[(static_cast<size_t>(b) * OH + y) * OW + x] =
      make_float4(mix_flag(res1[0], res2[0], sel), mix_flag(res1[1], res2[1], sel),
                  mix_flag(res1[2], res2[2], sel), 1.0f);
}

}  // namespace

// S: f32 [B, 19, OH, W] contiguous; bx: int32 [OW] (source columns, in
// [0, W)); fpx: f32 [OW]; fpy: f32 [OH]; table: f32 [65] (the ramp table
// [4][4][4] and 1/255); out: f32 [B, OH, OW, 4], 16-byte aligned.
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int xbr_epilogue_launch(const float* S, const int* bx, const float* fpx, const float* fpy,
                                   const float* table, float* out, int B, int OH, int W, int OW,
                                   void* stream) {
  if (B < 1 || OH < 1 || OH > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kThreads);
  const dim3 grid((OW + kThreads - 1) / kThreads, OH, B);
  xbr_epilogue_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      S, bx, fpx, fpy, table, reinterpret_cast<float4*>(out), OH, W, OW);
  return static_cast<int>(cudaGetLastError());
}
