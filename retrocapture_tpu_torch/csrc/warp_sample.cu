// Warped texture() tap for Hopper (sm_90a): GL NEAREST / LINEAR sampling
// at per-pixel normalized (u, v), four wrap modes, border color 0.
//
// Replaces the TPU kernel
// retrocapture_tpu/ops/pallas/warp_sample.py:warp_sample_pallas
// (_warp_sample_call / _make_kernel). On the TPU the gather had to be
// rebuilt from VMEM-resident bands and one-hot MXU contractions, because
// TPU gathers are slow. Hopper gathers through L1 natively, so the kernel
// is the reference's plain gather (ops/sampling.py:1200-1233). Neighbouring
// pixels of a smooth warp (CRT curvature) read neighbouring texels, so the
// texel reads hit L1/L2; a batch's textures (9.8 MB at 8 x 240 x 320 x 4)
// stay in the 50 MB L2.
//
// What bounds it: bytes, and nearly all of them the output (8 frames of
// 1080p RGBA f32 are 265 MB, over 90% of the bound's 292 MB). Design:
// one thread per output pixel reads (u, v) and does the index, wrap and
// weight math once, then loops over the batch's frames at the same taps,
// so the coordinates are read once for the batch. For
// C == 4 with 16-byte-aligned pointers (every contiguous RGBA texture the
// caching allocator gives) a texel is one float4 load and an output pixel
// one float4 streaming store (__stcs: the output cannot stay in L2), so a
// warp's store is 512 contiguous bytes; any other C or alignment takes a
// channel at a time, which the wrapper counts (warp_sample.general_launches).
// No texture-size limit: the TPU's VMEM budget does not apply.
//
// Index math is the reference's, bit for bit: floor, then NaN/+-inf ->
// INT32_MIN and finite out-of-range values saturate (sampling._ifloor32,
// tested with isfinite explicitly rather than relying on the float->int
// intrinsic's NaN result); the +1 tap wraps in int32 as XLA's add does;
// wrap modes use floor-mod as jnp.remainder does. The NEAREST index
// product is __fmul_rn. The LINEAR coordinate u*W - 0.5 and the lerps
// t00 + (t01 - t00)*fx are each one fused multiply-add (__fmaf_rn: one
// rounding), as the reference's jitted gather computes them on the CPU,
// where XLA contracts them into FMAs; the plain version takes the same
// single rounding through policy.fmaf32, so the two agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Wrap { kClampToEdge = 0, kClampToBorder = 1, kRepeat = 2, kMirroredRepeat = 3 };

__device__ __forceinline__ int ifloor32(float x) {
  const float f = floorf(x);
  if (!isfinite(f)) return INT32_MIN;
  if (f >= 2147483647.0f) return INT32_MAX;
  if (f <= -2147483648.0f) return INT32_MIN;
  return static_cast<int>(f);
}

__device__ __forceinline__ int add1(int i) {
  // int32 add that wraps (INT32_MAX + 1 == INT32_MIN), as XLA's does.
  return static_cast<int>(static_cast<unsigned int>(i) + 1u);
}

__device__ __forceinline__ int floor_mod(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// Wrapped index in [0, n); *valid is false only for a border tap.
__device__ __forceinline__ int wrap_index(int i, int n, int mode, bool* valid) {
  *valid = true;
  switch (mode) {
    case kRepeat:
      return floor_mod(i, n);
    case kMirroredRepeat: {
      const int m = floor_mod(i, 2 * n);
      return m < n ? m : 2 * n - 1 - m;
    }
    case kClampToBorder:
      *valid = i >= 0 && i < n;
      return min(max(i, 0), n - 1);
    default:
      return min(max(i, 0), n - 1);
  }
}

// One channel of the LINEAR tap: the three lerps, each one rounding.
__device__ __forceinline__ float bilerp(float t00, float t01, float t10, float t11, float fx,
                                        float fy) {
  const float top = __fmaf_rn(__fsub_rn(t01, t00), fx, t00);
  const float bot = __fmaf_rn(__fsub_rn(t11, t10), fx, t10);
  return __fmaf_rn(__fsub_rn(bot, top), fy, top);
}

__device__ __forceinline__ float4 texel4(const float* src, size_t off, bool ok) {
  return ok ? __ldg(reinterpret_cast<const float4*>(src + off)) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ float texel(const float* src, size_t off, bool ok) {
  return ok ? __ldg(src + off) : 0.0f;
}

// One thread per output pixel: the tap positions, wrapped indices and
// weights once, then every frame of the batch at the same taps. VEC4
// (C == 4, 16-byte-aligned texture): a texel is one float4 load and the
// pixel one float4 streaming store; otherwise a channel at a time.
template <bool LINEAR, bool VEC4>
__global__ void __launch_bounds__(kThreads)
    warp_sample_kernel(const float* __restrict__ tex, const float* __restrict__ u,
                       const float* __restrict__ v, float* __restrict__ out, int B, int H, int W,
                       int C, int P, int mode) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const size_t frame = static_cast<size_t>(H) * W * C;  // floats a texture
  const size_t oframe = static_cast<size_t>(P) * C;     // floats an output frame
  const float uu = __ldg(u + p);
  const float vv = __ldg(v + p);
  if (!LINEAR) {
    bool okx, oky;
    const int ix = wrap_index(ifloor32(__fmul_rn(uu, static_cast<float>(W))), W, mode, &okx);
    const int iy = wrap_index(ifloor32(__fmul_rn(vv, static_cast<float>(H))), H, mode, &oky);
    const bool ok = okx && oky;
    const size_t off = (static_cast<size_t>(iy) * W + ix) * C;
    if (VEC4) {
      float4* dst = reinterpret_cast<float4*>(out) + p;
#pragma unroll 4
      for (int b = 0; b < B; ++b) __stcs(dst + b * static_cast<size_t>(P), texel4(tex + b * frame, off, ok));
    } else {
      for (int b = 0; b < B; ++b) {
        float* dst = out + b * oframe + static_cast<size_t>(p) * C;
        for (int c = 0; c < C; ++c) dst[c] = texel(tex + b * frame, off + c, ok);
      }
    }
    return;
  }
  const float x = __fmaf_rn(uu, static_cast<float>(W), -0.5f);
  const float y = __fmaf_rn(vv, static_cast<float>(H), -0.5f);
  const float fx = __fsub_rn(x, floorf(x));
  const float fy = __fsub_rn(y, floorf(y));
  const int x0 = ifloor32(x);
  const int y0 = ifloor32(y);
  bool vx0, vx1, vy0, vy1;
  const int x0w = wrap_index(x0, W, mode, &vx0);
  const int x1w = wrap_index(add1(x0), W, mode, &vx1);
  const int y0w = wrap_index(y0, H, mode, &vy0);
  const int y1w = wrap_index(add1(y0), H, mode, &vy1);
  const size_t o00 = (static_cast<size_t>(y0w) * W + x0w) * C;
  const size_t o01 = (static_cast<size_t>(y0w) * W + x1w) * C;
  const size_t o10 = (static_cast<size_t>(y1w) * W + x0w) * C;
  const size_t o11 = (static_cast<size_t>(y1w) * W + x1w) * C;
  const bool k00 = vy0 && vx0, k01 = vy0 && vx1, k10 = vy1 && vx0, k11 = vy1 && vx1;
  if (VEC4) {
    float4* dst = reinterpret_cast<float4*>(out) + p;
#pragma unroll 2
    for (int b = 0; b < B; ++b) {
      const float* src = tex + b * frame;
      const float4 t00 = texel4(src, o00, k00);
      const float4 t01 = texel4(src, o01, k01);
      const float4 t10 = texel4(src, o10, k10);
      const float4 t11 = texel4(src, o11, k11);
      float4 r;
      r.x = bilerp(t00.x, t01.x, t10.x, t11.x, fx, fy);
      r.y = bilerp(t00.y, t01.y, t10.y, t11.y, fx, fy);
      r.z = bilerp(t00.z, t01.z, t10.z, t11.z, fx, fy);
      r.w = bilerp(t00.w, t01.w, t10.w, t11.w, fx, fy);
      __stcs(dst + b * static_cast<size_t>(P), r);
    }
    return;
  }
  for (int b = 0; b < B; ++b) {
    const float* src = tex + b * frame;
    float* dst = out + b * oframe + static_cast<size_t>(p) * C;
    for (int c = 0; c < C; ++c) {
      dst[c] = bilerp(texel(src, o00 + c, k00), texel(src, o01 + c, k01), texel(src, o10 + c, k10),
                      texel(src, o11 + c, k11), fx, fy);
    }
  }
}

}  // namespace

// tex: f32 [B, H, W, C] contiguous; u, v: f32 [P] (the HO x WO grid,
// shared by the batch); out: f32 [B, P, C]. mode: 0 clamp_to_edge,
// 1 clamp_to_border, 2 repeat, 3 mirrored_repeat. vec: the float4 path,
// which needs C == 4 and tex and out 16-byte aligned (the wrapper decides
// and counts the other launches). Launches on `stream`; returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a vec
// launch that does not meet its conditions.
extern "C" int warp_sample_launch(const float* tex, const float* u, const float* v, float* out,
                                  int B, int H, int W, int C, int P, int linear, int mode, int vec,
                                  void* stream) {
  if (vec && (C != 4 || ((reinterpret_cast<uintptr_t>(tex) | reinterpret_cast<uintptr_t>(out)) & 15))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kThreads);
  const dim3 grid((P + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (linear && vec) {
    warp_sample_kernel<true, true><<<grid, block, 0, s>>>(tex, u, v, out, B, H, W, C, P, mode);
  } else if (linear) {
    warp_sample_kernel<true, false><<<grid, block, 0, s>>>(tex, u, v, out, B, H, W, C, P, mode);
  } else if (vec) {
    warp_sample_kernel<false, true><<<grid, block, 0, s>>>(tex, u, v, out, B, H, W, C, P, mode);
  } else {
    warp_sample_kernel<false, false><<<grid, block, 0, s>>>(tex, u, v, out, B, H, W, C, P, mode);
  }
  return static_cast<int>(cudaGetLastError());
}
