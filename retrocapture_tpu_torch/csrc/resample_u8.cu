// Fused separable LINEAR viewport blit + uint8 pack for Hopper (sm_90a).
//
// Replaces the TPU kernel retrocapture_tpu/ops/pallas/resample.py:resample_u8
// (bodies _make_kernel_both/_x/_y, reached through blit_u8). That kernel
// computes, per channel,
//     out[y, x, c] = u8(rint(clip(sum_s sum_t ay[y,s] * tex[s,t,c] * ax[x,t], 0, 1) * 255))
// as two dense f32 matmuls on the MXU. Each row of ay and ax has at most
// two nonzero weights (LINEAR, clamp_to_edge), so on Hopper each output
// pixel reads at most 2x2 texels: the wrapper hands the kernel each
// row's two (index, weight) pairs, taken on the host from the very matrix
// the reference builds (sampling._axis_matrix), and the kernel sums y
// first and x second, as the reference's matmul order does.
//
// What bounds it: output bytes. A 320x240 -> 1920x1080 blit of a batch
// of 128 RGB frames writes 796 MB of u8 and reads 118 MB of f32 texels
// (which stay in L1/L2: every texel is read by ~27 output pixels). The
// design keeps the work per byte written small: one thread per output
// pixel, all channels of the pixel in one thread, no shared memory.
//
// Numerics: products and sums are __fmul_rn / __fadd_rn, so nvcc cannot
// contract them into FMAs; the quantize is rintf (round half to even)
// with NaN -> 0, as jnp.round + astype(uint8) gives.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned char quant_u8(float b) {
  if (b != b) return 0;  // NaN stores 0 (clip and fminf would hide it)
  b = fminf(fmaxf(b, 0.0f), 1.0f);
  return static_cast<unsigned char>(rintf(__fmul_rn(b, 255.0f)));
}

template <bool HAS_Y, bool HAS_X>
__global__ void resample_u8_kernel(const float* __restrict__ tex,
                                   unsigned char* __restrict__ out,
                                   const int* __restrict__ yi0, const float* __restrict__ yw0,
                                   const int* __restrict__ yi1, const float* __restrict__ yw1,
                                   const int* __restrict__ xi0, const float* __restrict__ xw0,
                                   const int* __restrict__ xi1, const float* __restrict__ xw1,
                                   int H, int W, int C, int OH, int OW) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y;
  const int b = blockIdx.z;
  if (ox >= OW) return;
  const float* src = tex + static_cast<size_t>(b) * H * W * C;
  unsigned char* dst = out + ((static_cast<size_t>(b) * OH + oy) * OW + ox) * C;

  int r0 = oy, r1 = oy;
  float wy0 = 1.0f, wy1 = 0.0f;
  if (HAS_Y) {
    r0 = __ldg(yi0 + oy);
    r1 = __ldg(yi1 + oy);
    wy0 = __ldg(yw0 + oy);
    wy1 = __ldg(yw1 + oy);
  }
  int c0 = ox, c1 = ox;
  float wx0 = 1.0f, wx1 = 0.0f;
  if (HAS_X) {
    c0 = __ldg(xi0 + ox);
    c1 = __ldg(xi1 + ox);
    wx0 = __ldg(xw0 + ox);
    wx1 = __ldg(xw1 + ox);
  }
  const float* row0 = src + static_cast<size_t>(r0) * W * C;
  const float* row1 = src + static_cast<size_t>(r1) * W * C;
  for (int c = 0; c < C; ++c) {
    float v;
    if (HAS_Y && HAS_X) {
      const float a0 = __fadd_rn(__fmul_rn(wy0, __ldg(row0 + c0 * C + c)),
                                 __fmul_rn(wy1, __ldg(row1 + c0 * C + c)));
      const float a1 = __fadd_rn(__fmul_rn(wy0, __ldg(row0 + c1 * C + c)),
                                 __fmul_rn(wy1, __ldg(row1 + c1 * C + c)));
      v = __fadd_rn(__fmul_rn(wx0, a0), __fmul_rn(wx1, a1));
    } else if (HAS_Y) {
      v = __fadd_rn(__fmul_rn(wy0, __ldg(row0 + ox * C + c)),
                    __fmul_rn(wy1, __ldg(row1 + ox * C + c)));
    } else if (HAS_X) {
      v = __fadd_rn(__fmul_rn(wx0, __ldg(row0 + c0 * C + c)),
                    __fmul_rn(wx1, __ldg(row0 + c1 * C + c)));
    } else {
      v = __ldg(row0 + ox * C + c);
    }
    dst[c] = quant_u8(v);
  }
}

}  // namespace

// tex: f32 [B, H, W, C] contiguous; out: u8 [B, OH, OW, C]. A null y (x)
// table means the axis is the identity and its pass is skipped.
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int resample_u8_launch(const float* tex, unsigned char* out,
                                  const int* yi0, const float* yw0,
                                  const int* yi1, const float* yw1,
                                  const int* xi0, const float* xw0,
                                  const int* xi1, const float* xw1,
                                  int B, int H, int W, int C, int OH, int OW,
                                  void* stream) {
  const dim3 block(kThreads);
  const dim3 grid((OW + kThreads - 1) / kThreads, OH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool hy = yi0 != nullptr;
  const bool hx = xi0 != nullptr;
  if (hy && hx) {
    resample_u8_kernel<true, true><<<grid, block, 0, s>>>(
        tex, out, yi0, yw0, yi1, yw1, xi0, xw0, xi1, xw1, H, W, C, OH, OW);
  } else if (hy) {
    resample_u8_kernel<true, false><<<grid, block, 0, s>>>(
        tex, out, yi0, yw0, yi1, yw1, xi0, xw0, xi1, xw1, H, W, C, OH, OW);
  } else if (hx) {
    resample_u8_kernel<false, true><<<grid, block, 0, s>>>(
        tex, out, yi0, yw0, yi1, yw1, xi0, xw0, xi1, xw1, H, W, C, OH, OW);
  } else {
    resample_u8_kernel<false, false><<<grid, block, 0, s>>>(
        tex, out, yi0, yw0, yi1, yw1, xi0, xw0, xi1, xw1, H, W, C, OH, OW);
  }
  return static_cast<int>(cudaGetLastError());
}
