// Integer-ratio LINEAR viewport blit in phase form + uint8 pack for Hopper
// (sm_90a).
//
// Replaces the TPU kernel retrocapture_tpu/ops/pallas/resample.py:
// _resample_u8_xphase (body _make_kernel_xphase, plan _xphase_plan),
// which blit_u8 takes under RCTPU_XPHASE=on when the output width is an
// integer multiple r of the source width. Output column X = r*k + p reads
// the source texels k + d[p] and k + d[p] + 1 (clamped) with the matrix's
// own weights w0[p, k], w1[p, k]. On the TPU the phase form replaced a
// dense [W, OW] MXU matmul; here it is the same 2-tap sum as
// resample_u8.cu, regrouped so that one thread owns one source column.
//
// One thread per (frame, output row, source column k): it takes the y
// pass (the same 2-tap tables as resample_u8.cu, or the identity) at
// columns k-1, k, k+1 once, then writes the r x C bytes of output columns
// r*k .. r*k + r-1.
//
// What bounds it: output bytes, as for resample_u8 (a 320x240 ->
// 1920x1080 blit of a batch of 128 RGB frames writes 796 MB of u8). Each
// thread's r*C bytes are contiguous, and a warp writes 32*r*C contiguous
// bytes.
//
// Numerics: y = __fadd_rn(__fmul_rn(wy0, t0), __fmul_rn(wy1, t1)), then
// x = __fadd_rn(__fmul_rn(w0, a0), __fmul_rn(w1, a1)) with the lower
// source column first: the operands and order of resample_u8.cu, so the
// two kernels write the same bytes. rintf rounds half to even; NaN -> 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ unsigned char quant_u8(float b) {
  if (b != b) return 0;
  b = fminf(fmaxf(b, 0.0f), 1.0f);
  return static_cast<unsigned char>(rintf(__fmul_rn(b, 255.0f)));
}

template <bool HAS_Y>
__global__ void resample_xphase_kernel(const float* __restrict__ tex,
                                       unsigned char* __restrict__ out,
                                       const int* __restrict__ yi0, const float* __restrict__ yw0,
                                       const int* __restrict__ yi1, const float* __restrict__ yw1,
                                       const int* __restrict__ d, const float* __restrict__ w0,
                                       const float* __restrict__ w1, int H, int W, int C, int OH,
                                       int R) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y;
  const int b = blockIdx.z;
  if (k >= W) return;
  const float* src = tex + static_cast<size_t>(b) * H * W * C;
  unsigned char* dst = out + ((static_cast<size_t>(b) * OH + oy) * W + k) * R * C;
  int r0 = oy, r1 = oy;
  float wy0 = 1.0f, wy1 = 0.0f;
  if (HAS_Y) {
    r0 = __ldg(yi0 + oy);
    r1 = __ldg(yi1 + oy);
    wy0 = __ldg(yw0 + oy);
    wy1 = __ldg(yw1 + oy);
  }
  const float* row0 = src + static_cast<size_t>(r0) * W * C;
  const float* row1 = src + static_cast<size_t>(r1) * W * C;
  const int km = max(k - 1, 0);
  const int kp = min(k + 1, W - 1);
  for (int c = 0; c < C; ++c) {
    float a[3];  // the y pass at columns k-1, k, k+1 (clamped)
    const int cols[3] = {km, k, kp};
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int o = cols[t] * C + c;
      a[t] = HAS_Y ? __fadd_rn(__fmul_rn(wy0, __ldg(row0 + o)), __fmul_rn(wy1, __ldg(row1 + o)))
                   : __ldg(row0 + o);
    }
    for (int p = 0; p < R; ++p) {
      // d[p] in {-1, 0}: taps (k-1, k) or (k, k+1).
      const bool lo = __ldg(d + p) < 0;
      const float t0 = lo ? a[0] : a[1];
      const float t1 = lo ? a[1] : a[2];
      const size_t wi = static_cast<size_t>(p) * W + k;
      const float v = __fadd_rn(__fmul_rn(__ldg(w0 + wi), t0), __fmul_rn(__ldg(w1 + wi), t1));
      dst[p * C + c] = quant_u8(v);
    }
  }
}

}  // namespace

// tex: f32 [B, H, W, C] contiguous; out: u8 [B, OH, R*W, C]. A null y table
// means the y axis is the identity (OH == H). d: int32 [R] in {-1, 0};
// w0, w1: f32 [R, W]. Launches on `stream`; returns cudaGetLastError().
extern "C" int resample_xphase_launch(const float* tex, unsigned char* out, const int* yi0,
                                      const float* yw0, const int* yi1, const float* yw1,
                                      const int* d, const float* w0, const float* w1, int B,
                                      int H, int W, int C, int OH, int R, void* stream) {
  const dim3 block(kThreads);
  const dim3 grid((W + kThreads - 1) / kThreads, OH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (yi0 != nullptr) {
    resample_xphase_kernel<true><<<grid, block, 0, s>>>(tex, out, yi0, yw0, yi1, yw1, d, w0, w1,
                                                        H, W, C, OH, R);
  } else {
    resample_xphase_kernel<false><<<grid, block, 0, s>>>(tex, out, yi0, yw0, yi1, yw1, d, w0, w1,
                                                         H, W, C, OH, R);
  }
  return static_cast<int>(cudaGetLastError());
}
