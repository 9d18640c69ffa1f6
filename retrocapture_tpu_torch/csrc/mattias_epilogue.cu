// crt-mattias's epilogue for Hopper (sm_90a): the three blur planes of a
// batch to RGBA f32 in one pass.
//
// Replaces no TPU kernel: the reference computes the tail of crt-mattias.glsl
// (graph/kernels.py, _mattias_kernel) as jnp code that XLA fuses. The port's
// plain version, graph/kernels._mattias_epilogue_plain, runs it as eager
// passes over the whole batch, each reading and writing [B, OH, OW, 3] f32
// again: a stack of the planes, about 20 multiplies, clamps and wheres,
// about 12 rctpu::fma launches, the sine and pow mirrors and two cats. This
// kernel reads each plane once, each per-pixel map once a batch, and writes
// RGBA once, with the bits of the plain version.
//
// Bits. Every step of the plain version is taken in its order and at its
// precision: plain products and sums are __fmul_rn / __fadd_rn / __fsub_rn,
// its rctpu::fma calls fma32 (policy.fma32's f64 formula), its sines and pows
// the mirrors' sin_mirror and pow_mirror (numerics.cuh, shared with
// csrc/mirrors.cu), its clamps compare as torch.clamp does (NaN stays NaN),
// and the last two wheres zero what lies outside the screen and then any
// NaN. The file is built with -fmad=false. Every constant is the f32 value
// the plain version uses, computed on the host (ops/cuda/mattias_epilogue.py)
// and passed by value.
//
// Per-frame scalars come from device memory when the kernel runs:
// FrameCount (f32, one a frame, or one for the batch) and, for a traced
// SCANSPEED, the parameter's 0-d buffer, so that a replayed CUDA graph reads
// the values of its time. A constant SCANSPEED is folded into one factor on
// the host, as the plain version folds it. Each block first computes the
// batch's per-frame scalars (the scanline's time, the flicker, the hashes'
// drift) into shared memory.
//
// What bounds it: the sines, pows and fma32s. A pixel of a frame takes 4
// sines, 4 pows and 20 fma32s, about 80 f32 <-> f64 and float <-> int
// conversions in all, which issue 16 a clock per SM; its bytes are the three
// planes read (12) and RGBA written (16). Design: one thread owns a run of 4
// adjacent pixels (1 where the pointers do not allow 16-byte accesses) for
// every frame of the batch: its 6 maps are read once into registers, the
// planes stream in with 16-byte loads and RGBA goes out with streaming
// stores (__stcs, which saved 12-15% in csrc/fma.cu); grid-stride.

#include <string.h>

#include <initializer_list>

#include "numerics.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;
constexpr int kMaxFrames = 4096;  // frames of one launch: 3 scalars each in 48 KB of shared memory

// The plain version's constants, in ops/cuda/mattias_epilogue.py's order:
// each an f32 value, the factors and addends of its multiply-adds already
// widened to f64 (exact), so that the kernel converts no constant.
struct Narrow {
  float post[3];  // the blur groups' post-adds, summed a channel
  float tint[3];  // 0.95, 1.05, 0.95
  float off[3];  // the three hashes' offsets 0, 0.3, 0.5
  float k06;  // the contrast's 0.6
  float c09, c045;  // the folded constants of pow 0.9 and pow 0.45
  float t60;  // f32(1) / f32(60)
  float k35;  // 3.5
  float scan_k;  // a constant SCANSPEED's factor: f32(f32(t60 * SCANSPEED) * 3.5)
  float k38;  // the scanline's 3.8
  float flick_k, k0015;  // f32(300) * t60, the flicker's 0.0015
  float drift_k;  // f32(t60 * f32(1e-4))
  float k78233, inv314, k43758;  // rand()'s 78.233, f32(1) / f32(3.14), 43758.5453
};
struct Wide {
  double k04, k03;  // the contrast's 0.4, the saturation's 0.3
  double oh15;  // f32(oh) * 1.5: the scanline's phase a unit of v
  double k015, k035;  // the scanline's 0.15 and 0.35
  double k129898, km314, km025;  // rand()'s 12.9898 and -3.14, the noise's -0.25
};
struct Consts {
  Narrow f;
  Wide d;
};
constexpr int kNarrow = sizeof(Narrow) / sizeof(float);
constexpr int kWide = sizeof(Wide) / sizeof(double);

// fma32 with a constant factor, or factor and addend, widened on the host.
__device__ __forceinline__ float fma32(float a, double b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(a), b), static_cast<double>(c)));
}
__device__ __forceinline__ float fma32(float a, double b, double c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(a), b), c));
}

struct Args {
  const float* plane[3];
  long long plane_stride[3];  // elements from one frame's plane to the next (0: shared)
  const float* bv;  // the blur's v, [OH, OW]
  const float* uv_u;  // the base warp, [OH, OW] each
  const float* uv_v;
  const float* vig;  // the vignette, [OH, OW]
  const float* comb;  // the comb mask's factor, [OH, OW]
  const unsigned char* inside;  // the inside test, [OH, OW] bool
  const float* fcf;  // FrameCount, f32
  int fcf_stride;  // 1: one a frame, 0: one for the batch
  const float* scanspeed;  // a traced SCANSPEED's 0-d buffer, or null
  float* out;  // [B, OH, OW, 4]
  int batch;
  long long n;  // pixels a frame
};

// torch.clamp(x, 0, 1): NaN stays NaN.
__device__ __forceinline__ float clamp01(float x) {
  x = x < 0.0f ? 0.0f : x;
  return x > 1.0f ? 1.0f : x;
}

// One pixel of one frame: the three blurred channels to RGBA, the plain
// version's steps in its order. bv comes widened: it is the same in every
// frame.
__device__ __forceinline__ float4 shade(const Consts& k, const float (&rgb)[3], double bv, float uv_u, float uv_v,
                                        float vig, float comb, bool inside, float scan_t, float flick, float drift) {
  const float phase = __double2float_rn(__dadd_rn(__dmul_rn(bv, k.d.oh15), static_cast<double>(scan_t)));
  const float scans = clamp01(fma32(sin_mirror(phase), k.d.k015, k.d.k035));
  const float scan = __fmul_rn(pow_mirror(scans, k.f.c09), k.f.k38);
  const float du = __fadd_rn(uv_u, drift), dv = __fadd_rn(uv_v, drift);
  float o[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float x = __fadd_rn(rgb[c], k.f.post[c]);
    x = clamp01(fma32(x, k.d.k04, __fmul_rn(__fmul_rn(x, k.f.k06), x)));
    x = __fmul_rn(x, vig);
    x = __fmul_rn(x, k.f.tint[c]);
    const double xd = static_cast<double>(x);  // fma32(fma32(x, x, -x), 0.3, x)
    const float sq = __double2float_rn(__dsub_rn(__dmul_rn(xd, xd), xd));
    x = __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(sq), k.d.k03), xd));
    x = __fmul_rn(x, scan);
    x = __fmul_rn(x, flick);
    x = __fmul_rn(x, comb);
    // rand(uv + drift + offset): dot with (12.9898, 78.233), mod 3.14, sin.
    const float cu = __fadd_rn(du, k.f.off[c]), cv = __fadd_rn(dv, k.f.off[c]);
    const float dt = fma32(cu, k.d.k129898, __fmul_rn(cv, k.f.k78233));
    const float sn = fma32(floorf(__fmul_rn(dt, k.f.inv314)), k.d.km314, dt);
    const float s = __fmul_rn(sin_mirror(sn), k.f.k43758);
    x = __fmul_rn(x, fma32(__fsub_rn(s, floorf(s)), k.d.km025, 1.0f));
    x = pow_mirror(x < 0.0f ? 0.0f : x, k.f.c045);  // torch.clamp_min: NaN stays NaN
    x = inside ? x : 0.0f;
    o[c] = isnan(x) ? 0.0f : x;
  }
  return make_float4(o[0], o[1], o[2], 1.0f);
}

// PX adjacent pixels a thread: 4 with 16-byte accesses, or 1.
template <int PX>
__global__ void __launch_bounds__(kThreads) mattias_epilogue_kernel(const Args a, const Consts k) {
  extern __shared__ float frame[];  // [3][batch]: the scanline's time, the flicker, the drift
  for (int b = threadIdx.x; b < a.batch; b += kThreads) {
    const float f = __ldg(a.fcf + static_cast<long long>(b) * a.fcf_stride);
    frame[b] = a.scanspeed ? __fmul_rn(__fmul_rn(__fmul_rn(f, k.f.t60), __ldg(a.scanspeed)), k.f.k35)
                           : __fmul_rn(f, k.f.scan_k);
    frame[a.batch + b] = fma32(sin_mirror(__fmul_rn(f, k.f.flick_k)), k.f.k0015, 1.0f);
    frame[2 * a.batch + b] = __fmul_rn(f, k.f.drift_k);
  }
  __syncthreads();
  const long long runs = a.n / PX;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; r < runs; r += stride) {
    const long long p0 = r * PX;
    double bv[PX];
    float uu[PX], uv[PX], vig[PX], comb[PX];
    bool inside[PX];
    if constexpr (PX == 4) {
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(a.bv + p0));
      const float4 u4 = __ldg(reinterpret_cast<const float4*>(a.uv_u + p0));
      const float4 v4 = __ldg(reinterpret_cast<const float4*>(a.uv_v + p0));
      const float4 g4 = __ldg(reinterpret_cast<const float4*>(a.vig + p0));
      const float4 c4 = __ldg(reinterpret_cast<const float4*>(a.comb + p0));
      const uchar4 i4 = __ldg(reinterpret_cast<const uchar4*>(a.inside + p0));
      bv[0] = b4.x, bv[1] = b4.y, bv[2] = b4.z, bv[3] = b4.w;  // widened once for every frame
      uu[0] = u4.x, uu[1] = u4.y, uu[2] = u4.z, uu[3] = u4.w;
      uv[0] = v4.x, uv[1] = v4.y, uv[2] = v4.z, uv[3] = v4.w;
      vig[0] = g4.x, vig[1] = g4.y, vig[2] = g4.z, vig[3] = g4.w;
      comb[0] = c4.x, comb[1] = c4.y, comb[2] = c4.z, comb[3] = c4.w;
      inside[0] = i4.x, inside[1] = i4.y, inside[2] = i4.z, inside[3] = i4.w;
    } else {
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        bv[j] = __ldg(a.bv + p0 + j), uu[j] = __ldg(a.uv_u + p0 + j), uv[j] = __ldg(a.uv_v + p0 + j);
        vig[j] = __ldg(a.vig + p0 + j), comb[j] = __ldg(a.comb + p0 + j), inside[j] = __ldg(a.inside + p0 + j);
      }
    }
    for (int b = 0; b < a.batch; ++b) {
      float rgb[PX][3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* p = a.plane[c] + b * a.plane_stride[c] + p0;
        if constexpr (PX == 4) {
          const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
          rgb[0][c] = v.x, rgb[1][c] = v.y, rgb[2][c] = v.z, rgb[3][c] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < PX; ++j) rgb[j][c] = __ldcs(p + j);
        }
      }
      const float scan_t = frame[b], flick = frame[a.batch + b], drift = frame[2 * a.batch + b];
      float4* out = reinterpret_cast<float4*>(a.out) + b * a.n + p0;
#pragma unroll
      for (int j = 0; j < PX; ++j)
        __stcs(out + j, shade(k, rgb[j], bv[j], uu[j], uv[j], vig[j], comb[j], inside[j], scan_t, flick, drift));
    }
  }
}

bool aligned(const void* p, int bytes) { return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0; }

}  // namespace

// plane0..2: f32 [B, OH, OW] each, a frame's plane contiguous, frames
// stride0..2 elements apart (0: one plane for every frame). bv, uv_u, uv_v,
// vig, comb: f32 [OH, OW] contiguous; inside: bool [OH, OW] contiguous. fcf:
// f32 FrameCount, fcf_stride 1 (one a frame) or 0 (one for the batch).
// scanspeed: a traced SCANSPEED's f32 0-d buffer, or null for a constant one
// (folded into the constants). narrow, wide: the host's n_narrow f32 and
// n_wide f64 constants, Narrow's and Wide's fields in order.
// out: f32 [B, OH, OW, 4] contiguous, 16-byte aligned; n = OH * OW. Launches
// on `stream`, one launch per 4096 frames; returns cudaGetLastError() after
// the launches, or cudaErrorInvalidValue for a count of constants other than
// the kernel's or an unaligned output.
extern "C" int mattias_epilogue_launch(const float* plane0, const float* plane1, const float* plane2,
                                       long long stride0, long long stride1, long long stride2, const float* bv,
                                       const float* uv_u, const float* uv_v, const float* vig, const float* comb,
                                       const unsigned char* inside, const float* fcf, int fcf_stride,
                                       const float* scanspeed, const float* narrow, int n_narrow,
                                       const double* wide, int n_wide, float* out, int batch, long long n,
                                       void* stream) {
  if (n_narrow != kNarrow || n_wide != kWide || !aligned(out, 16)) return static_cast<int>(cudaErrorInvalidValue);
  Consts k;
  memcpy(&k.f, narrow, sizeof k.f);
  memcpy(&k.d, wide, sizeof k.d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{{plane0, plane1, plane2}, {stride0, stride1, stride2}, bv, uv_u, uv_v, vig, comb, inside,
         fcf, fcf_stride, scanspeed, out, 0, n};
  bool vec = n % 4 == 0 && aligned(inside, 4);
  for (int c = 0; c < 3; ++c) vec = vec && aligned(a.plane[c], 16) && a.plane_stride[c] % 4 == 0;
  for (const float* m : {bv, uv_u, uv_v, vig, comb}) vec = vec && aligned(m, 16);
  const long long runs = vec ? n / 4 : n;
  const int blocks = static_cast<int>(runs / kThreads + 1 < kMaxBlocks ? runs / kThreads + 1 : kMaxBlocks);
  for (int b0 = 0; b0 < batch; b0 += kMaxFrames) {
    Args part = a;
    part.batch = batch - b0 < kMaxFrames ? batch - b0 : kMaxFrames;
    for (int c = 0; c < 3; ++c) part.plane[c] += b0 * a.plane_stride[c];
    part.fcf += static_cast<long long>(b0) * fcf_stride;
    part.out += 4 * b0 * n;
    const size_t smem = 3 * sizeof(float) * part.batch;
    if (vec) {
      mattias_epilogue_kernel<4><<<blocks, kThreads, smem, s>>>(part, k);
    } else {
      mattias_epilogue_kernel<1><<<blocks, kThreads, smem, s>>>(part, k);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
