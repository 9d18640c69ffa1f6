// Warped multi-group 5x5 NEAREST-tap blur for Hopper (sm_90a).
//
// Replaces the TPU kernels retrocapture_tpu/ops/pallas/blur_groups.py:
// _blur_groups_call_v2 (exact weights, the default) and _blur_groups_call
// (v1, rank-2 SVD weights), both reached through blur5x5_groups. The
// crt-mattias fragment sums, per output pixel, G blur() groups of 5x5
// NEAREST taps around per-group warped bases; group g adds to its output
// channel
//     sum_j sum_i W_g[j][i] * tex[row_j, col_i, ch_g]
//     col_i = clamp(floor(((u + bx) + xo_i) * W), 0, W-1)   (rows with by, yo_j, H)
// On the TPU the gather had to be rebuilt from VMEM bands, lane rotations
// and one-hot masks. Hopper gathers through L1, so this kernel is the sum
// itself: one thread per output pixel, the groups in order, j then i.
// v1 and v2 differ only in the f32 weight table the host builds.
//
// What bounds it: L1/L2 load throughput. Per output pixel it reads 8 bytes
// of (u, v) and G*25 texels (225 for crt-mattias) and writes one float per
// channel. One frame's texture (240x320x3 f32, 0.9 MB) stays in L2, and
// neighbouring threads of an upscaling warp read the same or neighbouring
// texels, so the texel loads hit L1. Shared-memory tiling is a later step.
//
// Numerics: tap coordinates are __fadd_rn/__fmul_rn in the evaluator's
// order and the sum is acc = __fadd_rn(acc, __fmul_rn(w, t)), so nvcc
// contracts nothing and the plain torch version (same loop, same order)
// is bit-equal. floor -> int follows the port's ifloor32: NaN/+-inf ->
// INT32_MIN, finite values saturate; then the clamp to the texture.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 4;   // output channels
constexpr int kParams = 37;    // bx, by, xo[5], yo[5], W[25]

__device__ __forceinline__ int ifloor32(float x) {
  const float f = floorf(x);
  if (!isfinite(f)) return INT32_MIN;
  if (f >= 2147483647.0f) return INT32_MAX;
  if (f <= -2147483648.0f) return INT32_MIN;
  return static_cast<int>(f);
}

__device__ __forceinline__ int tap(float base, float off, float n, int hi) {
  return min(max(ifloor32(__fmul_rn(__fadd_rn(base, off), n)), 0), hi);
}

__global__ void blur_groups_kernel(const float* __restrict__ tex, const float* __restrict__ u,
                                   const float* __restrict__ v,
                                   const float* __restrict__ params,
                                   const int* __restrict__ chan, float* __restrict__ out,
                                   int H, int W, int C, int P, int B, int G, int S) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= P) return;
  const float* src = tex + static_cast<size_t>(b) * H * W * C;
  const float uu = __ldg(u + p);
  const float vv = __ldg(v + p);
  const float fw = static_cast<float>(W);
  const float fh = static_cast<float>(H);
  float acc[kMaxSlots] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int g = 0; g < G; ++g) {
    const float* prm = params + g * kParams;
    const int ch = __ldg(chan + 2 * g);
    const int slot = __ldg(chan + 2 * g + 1);
    const float ug = __fadd_rn(uu, __ldg(prm + 0));
    const float vg = __fadd_rn(vv, __ldg(prm + 1));
    int col[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) col[i] = tap(ug, __ldg(prm + 2 + i), fw, W - 1) * C + ch;
    float a = acc[0];
    if (slot == 1) a = acc[1];
    if (slot == 2) a = acc[2];
    if (slot == 3) a = acc[3];
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const float* row = src + static_cast<size_t>(tap(vg, __ldg(prm + 7 + j), fh, H - 1)) * W * C;
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        a = __fadd_rn(a, __fmul_rn(__ldg(prm + 12 + 5 * j + i), __ldg(row + col[i])));
      }
    }
    if (slot == 0) acc[0] = a;
    if (slot == 1) acc[1] = a;
    if (slot == 2) acc[2] = a;
    if (slot == 3) acc[3] = a;
  }
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) {
    if (s < S) out[(static_cast<size_t>(s) * B + b) * P + p] = acc[s];
  }
}

}  // namespace

// tex: f32 [B, H, W, C] contiguous; u, v: f32 [P] (the HO x WO grid, shared
// by the batch); params: f32 [G, 37] (bx, by, xo[5], yo[5], W[5][5]);
// chan: int32 [G, 2] (texture channel, output slot); out: f32 [S, B, P].
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int blur_groups_launch(const float* tex, const float* u, const float* v,
                                  const float* params, const int* chan, float* out, int B,
                                  int H, int W, int C, int P, int G, int S, void* stream) {
  if (S < 1 || S > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kThreads);
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  blur_groups_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      tex, u, v, params, chan, out, H, W, C, P, B, G, S);
  return static_cast<int>(cudaGetLastError());
}
