// Warped texture() tap for Hopper (sm_90a): GL NEAREST / LINEAR sampling
// at per-pixel normalized (u, v), four wrap modes, border color 0.
//
// Replaces the TPU kernel
// retrocapture_tpu/ops/pallas/warp_sample.py:warp_sample_pallas
// (_warp_sample_call / _make_kernel). On the TPU the gather had to be
// rebuilt from VMEM-resident bands and one-hot MXU contractions, because
// TPU gathers are slow. Hopper gathers through L1 natively, so the kernel
// is the reference's plain gather (ops/sampling.py:1200-1233) with one
// thread per output pixel: at most 4 texel reads per channel, straight
// from global memory. Neighbouring pixels of a smooth warp (CRT
// curvature) read neighbouring texels, so the reads hit L1/L2.
//
// What bounds it: bytes. Per output pixel it reads 8 bytes of (u, v),
// up to 4 texels of C floats (mostly cache hits) and writes C floats.
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

__device__ __forceinline__ float texel(const float* src, int iy, int ix, bool ok, int W, int C,
                                       int c) {
  return ok ? __ldg(src + (static_cast<size_t>(iy) * W + ix) * C + c) : 0.0f;
}

template <bool LINEAR>
__global__ void warp_sample_kernel(const float* __restrict__ tex, const float* __restrict__ u,
                                   const float* __restrict__ v, float* __restrict__ out, int H,
                                   int W, int C, int P, int mode) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= P) return;
  const float* src = tex + static_cast<size_t>(b) * H * W * C;
  float* dst = out + (static_cast<size_t>(b) * P + p) * C;
  const float uu = __ldg(u + p);
  const float vv = __ldg(v + p);
  if (!LINEAR) {
    bool okx, oky;
    const int ix = wrap_index(ifloor32(__fmul_rn(uu, static_cast<float>(W))), W, mode, &okx);
    const int iy = wrap_index(ifloor32(__fmul_rn(vv, static_cast<float>(H))), H, mode, &oky);
    const bool ok = okx && oky;
    for (int c = 0; c < C; ++c) dst[c] = texel(src, iy, ix, ok, W, C, c);
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
  for (int c = 0; c < C; ++c) {
    const float t00 = texel(src, y0w, x0w, vy0 && vx0, W, C, c);
    const float t01 = texel(src, y0w, x1w, vy0 && vx1, W, C, c);
    const float t10 = texel(src, y1w, x0w, vy1 && vx0, W, C, c);
    const float t11 = texel(src, y1w, x1w, vy1 && vx1, W, C, c);
    const float top = __fmaf_rn(__fsub_rn(t01, t00), fx, t00);
    const float bot = __fmaf_rn(__fsub_rn(t11, t10), fx, t10);
    dst[c] = __fmaf_rn(__fsub_rn(bot, top), fy, top);
  }
}

}  // namespace

// tex: f32 [B, H, W, C] contiguous; u, v: f32 [P] (the HO x WO grid,
// shared by the batch); out: f32 [B, P, C]. mode: 0 clamp_to_edge,
// 1 clamp_to_border, 2 repeat, 3 mirrored_repeat. Launches on `stream`;
// returns cudaGetLastError() after the launch.
extern "C" int warp_sample_launch(const float* tex, const float* u, const float* v, float* out,
                                  int B, int H, int W, int C, int P, int linear, int mode,
                                  void* stream) {
  const dim3 block(kThreads);
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (linear) {
    warp_sample_kernel<true><<<grid, block, 0, s>>>(tex, u, v, out, H, W, C, P, mode);
  } else {
    warp_sample_kernel<false><<<grid, block, 0, s>>>(tex, u, v, out, H, W, C, P, mode);
  }
  return static_cast<int>(cudaGetLastError());
}
