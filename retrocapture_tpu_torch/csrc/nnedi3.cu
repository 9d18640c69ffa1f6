// nnedi3's neural doubling pass for Hopper (sm_90a): one launch a pass for
// the whole batch, the RGBA f32 input read once and the interleaved RGBA
// f32 output written once.
//
// Replaces no TPU kernel: the reference computes an nnedi3 pass as jnp code
// inside retrocapture_tpu/graph/kernels.py (_nnedi3_kernel), which XLA
// fuses. The port ran it as eager torch (graph/kernels.py:_nnedi3_plain,
// still the plain version): 32 shifted tap planes, widened to f64, the
// window's sums, an f64 GEMM [2 nns, 32] x [32, h w c], the exp mirror, the
// softsign mix and the interleave's stack and cat, about 2.2 GB of f64 and
// f32 planes a frame at 960 x 640 through device memory.
//
// Per source texel (y, x) and channel c < comps of frame b it predicts the
// value between the texel and its successor along the doubled axis (pass 1,
// axis 0: rows; pass 2, axis 1: columns):
//   the 32 edge-clamped taps of the 8 x 4 window, q = s*4 + cw at (dy, dx) =
//     (s/2 - 1, (s%2)*4 + cw - 3) for pass 1, the transpose for pass 2;
//   ssum and sumsq summed in f64 and rounded once to f32; mstd0 = ssum / 32,
//     mstd1 = sumsq / 32 - mstd0^2, mstd2 = 1 / sqrt(mstd1) where mstd1 >=
//     f32(1.192092896e-7), else 0, then mstd1 *= mstd2;
//   2 nns dots, d = sum_k w[k] tap[k] as an f64 chain of fused multiply-adds
//     in k order, rounded once to f32;
//   e1 = exp(d1 * mstd2 + b1) (numerics.cuh's exp_mirror), s2 = d2 * mstd2 +
//     b2, wsum = sum e1 and vsum = sum e1 * s2 / (1 + |s2|), both in f64 over
//     the neurons and rounded once;
//   pred = clamp(mstd0 + 5 vsum / wsum * mstd1, 0, 1), NaN kept.
// The output holds the source texel and then pred along the doubled axis,
// channels comps..3 set to 1.
//
// Bits. Every f32 step is the plain version's eager op, written out with
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn, and the
// source is built with -fmad=false (ops/cuda/_build.py), so nothing is
// contracted that the plain version rounds twice. A product of two f32
// values is exact in f64, so the dots' and sumsq's __fma_rn equal the plain
// version's multiply and add. The f64 sums run in a fixed order where the
// plain version's reductions and GEMM take theirs: the two agree to an f64
// ulp or so, which moves the f32 result only where it lands on an f32
// rounding boundary (the card tests hold >= 99.99% of predicted values
// bit-equal).
//
// What bounds it: f64 issue. A predicted value takes 2 nns dots of 32
// DFMAs (4,096 at nns 64) and about 50 f32, f64 and conversion
// instructions a neuron (exp, the softsign's division, the f64 sums),
// against 32 f32 taps read and 16-32 bytes written. At the H100's 64 FP64
// lanes an SM the benchmark's 4-pass chain (8.49 G multiply-adds a frame)
// needs >= 0.5 ms a frame; its bytes (13.8 MB a frame) need 4 us.
//
// Design:
//  * The net, f64 [2 nns, 32] and f32 [2 nns] (up to 32.5 KB), is staged in
//    shared memory once a block. A warp reads two weights with one
//    broadcast 16-byte load and uses each for both of its texels, so a
//    DFMA costs a quarter of a load. (Kept in constant memory
//    with the loops unrolled, each f64 weight still took a ULDC of its own
//    on sm_90a, the 12 forms took 155 s to build, and the benchmark's four
//    passes at batch 16 took 22.8 ms on an H100, against 16.5 ms here:
//    PERF.md §6.)
//  * A thread owns 2 source texels 32 apart on one row and holds their
//    windows' 32 taps of one channel in f64 registers, converted once; it
//    runs its channels one after the other. The neurons go 2 at a time:
//    8 independent chains of DFMAs (2 neurons x d1, d2 x 2 texels), then the
//    4 exp and softsign mixes, whose sums keep the neurons' order.
//  * A block owns 64 x 4 texels of one frame and stages them with their
//    clamped halo (rows -1..+2 and columns -3..+4 for pass 1, the transpose
//    for pass 2) in shared memory once; nothing goes through device memory
//    between the window and the output. The source's even rows or columns
//    are copied from the staged tile, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "numerics.cuh"

namespace {

constexpr int kTaps = 32;
constexpr int kPx = 2;  // texels a thread, 32 apart on a row
constexpr int kGroup = 2;  // neurons whose dots run together
constexpr int kTw = 32 * kPx;  // a block's texels along x
constexpr int kTh = 4;  // ... and along y
constexpr int kThreads = 32 * kTh;
constexpr float kEps = 1.192092896e-7f;  // the variance's threshold

// torch.clamp(x, 0, 1): NaN stays NaN.
__device__ __forceinline__ float clamp01(float x) {
  x = x < 0.0f ? 0.0f : x;
  return x > 1.0f ? 1.0f : x;
}

// The predicted values of kPx windows from their 32 taps each, widened; w
// and bias the staged net.
template <int NNS>
__device__ __forceinline__ void predict(const double (&t)[kPx][kTaps], const double* w, const float* bias,
                                        float (&pred)[kPx]) {
  float mstd0[kPx], mstd1[kPx], mstd2[kPx];
  double wsum[kPx], vsum[kPx];
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
    double ssum = 0.0, sumsq = 0.0;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      ssum = __dadd_rn(ssum, t[p][k]);
      sumsq = __fma_rn(t[p][k], t[p][k], sumsq);
    }
    mstd0[p] = __fmul_rn(__double2float_rn(ssum), 0.03125f);
    const float var = __fsub_rn(__fmul_rn(__double2float_rn(sumsq), 0.03125f), __fmul_rn(mstd0[p], mstd0[p]));
    mstd2[p] = var >= kEps ? __fdiv_rn(1.0f, __fsqrt_rn(var)) : 0.0f;
    mstd1[p] = __fmul_rn(var, mstd2[p]);
    wsum[p] = 0.0, vsum[p] = 0.0;
  }
#pragma unroll 1
  for (int j0 = 0; j0 < NNS; j0 += kGroup) {
    double d1[kGroup][kPx], d2[kGroup][kPx];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int p = 0; p < kPx; ++p) d1[g][p] = 0.0, d2[g][p] = 0.0;
    }
#pragma unroll
    for (int k = 0; k < kTaps; k += 2) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const double2 a = *reinterpret_cast<const double2*>(w + (j0 + g) * kTaps + k);
        const double2 b = *reinterpret_cast<const double2*>(w + (NNS + j0 + g) * kTaps + k);
#pragma unroll
        for (int p = 0; p < kPx; ++p) {
          d1[g][p] = __fma_rn(a.x, t[p][k], d1[g][p]);
          d2[g][p] = __fma_rn(b.x, t[p][k], d2[g][p]);
          d1[g][p] = __fma_rn(a.y, t[p][k + 1], d1[g][p]);
          d2[g][p] = __fma_rn(b.y, t[p][k + 1], d2[g][p]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const float b1 = bias[j0 + g], b2 = bias[NNS + j0 + g];
#pragma unroll
      for (int p = 0; p < kPx; ++p) {
        const float e1 = exp_mirror(__fadd_rn(__fmul_rn(__double2float_rn(d1[g][p]), mstd2[p]), b1));
        const float s2 = __fadd_rn(__fmul_rn(__double2float_rn(d2[g][p]), mstd2[p]), b2);
        const float mix = __fmul_rn(e1, __fdiv_rn(s2, __fadd_rn(fabsf(s2), 1.0f)));
        wsum[p] = __dadd_rn(wsum[p], static_cast<double>(e1));
        vsum[p] = __dadd_rn(vsum[p], static_cast<double>(mix));
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
    const float ws = __double2float_rn(wsum[p]), vs = __double2float_rn(vsum[p]);
    pred[p] = clamp01(__fadd_rn(mstd0[p], __fmul_rn(__fdiv_rn(__fmul_rn(5.0f, vs), ws), mstd1[p])));
  }
}

struct Args {
  const float* tex;  // [B, h, w, C] f32 at the strides below
  long long sb, sh, sw, sc;  // element strides of frame, row, column, channel
  const double* weights;  // [2 nns, 32] f64, 16-byte aligned
  const float* biases;  // [2 nns] f32
  float* out;  // [B, oh, ow, 4] f32, contiguous
  int h, w;
};

// AXIS 0 doubles the rows (pass 1), 1 the columns (pass 2).
template <int AXIS, int COMPS, int NNS>
__global__ void __launch_bounds__(kThreads) nnedi3_kernel(const Args a) {
  constexpr int kUp = AXIS == 0 ? 1 : 3, kDown = AXIS == 0 ? 2 : 4;  // the window's rows around its texel
  constexpr int kLeft = AXIS == 0 ? 3 : 1, kRight = AXIS == 0 ? 4 : 2;  // ... and columns
  constexpr int kSh = kTh + kUp + kDown, kSw = kTw + kLeft + kRight;
  __shared__ __align__(16) double w[2 * NNS * kTaps];
  __shared__ float bias[2 * NNS];
  __shared__ float tile[COMPS][kSh][kSw];

  const int lin = threadIdx.y * 32 + threadIdx.x;
  for (int i = lin; i < NNS * kTaps; i += kThreads) {
    reinterpret_cast<double2*>(w)[i] = __ldg(reinterpret_cast<const double2*>(a.weights) + i);
  }
  for (int i = lin; i < 2 * NNS; i += kThreads) bias[i] = __ldg(a.biases + i);
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTh, x0 = blockIdx.x * kTw;
  const float* src = a.tex + b * a.sb;
  for (int i = lin; i < kSh * kSw; i += kThreads) {
    const int r = i / kSw, c = i - r * kSw;
    const int gy = min(max(y0 - kUp + r, 0), a.h - 1), gx = min(max(x0 - kLeft + c, 0), a.w - 1);
    const float* p = src + gy * a.sh + gx * a.sw;
#pragma unroll
    for (int ch = 0; ch < COMPS; ++ch) tile[ch][r][c] = __ldg(p + ch * a.sc);
  }
  __syncthreads();
  const int ty = threadIdx.y, tx = threadIdx.x;
  const int y = y0 + ty;
  if (y >= a.h || x0 + tx >= a.w) return;

  // The even (source) texels and the predicted ones, channels comps..3 at 1.
  float4 even[kPx], odd[kPx];
#pragma unroll
  for (int p = 0; p < kPx; ++p) even[p] = odd[p] = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
#pragma unroll 1
  for (int ch = 0; ch < COMPS; ++ch) {
    double t[kPx][kTaps];
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
#pragma unroll
      for (int q = 0; q < kTaps; ++q) {
        const int s = q / 4, cw = q % 4;
        const int du = s / 2 - 1, dv = (s % 2) * 4 + cw - 3;  // (minor, major) offsets of pass 1
        const int dy = AXIS == 0 ? du : dv, dx = AXIS == 0 ? dv : du;
        t[p][q] = static_cast<double>(tile[ch][ty + kUp + dy][tx + 32 * p + kLeft + dx]);
      }
    }
    float pred[kPx];
    predict<NNS>(t, w, bias, pred);
    // Selects on registers: the channel loop stays rolled, one copy of the
    // net's code.
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      const float own = tile[ch][ty + kUp][tx + 32 * p + kLeft];
      if (ch == 0) {
        even[p].x = own, odd[p].x = pred[p];
      } else if (ch == 1) {
        even[p].y = own, odd[p].y = pred[p];
      } else {
        even[p].z = own, odd[p].z = pred[p];
      }
    }
  }
  float4* frame = reinterpret_cast<float4*>(a.out) + static_cast<long long>(b) * (2LL * a.h * a.w);
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
    const int x = x0 + tx + 32 * p;
    if (x >= a.w) break;
    if constexpr (AXIS == 0) {
      float4* out = frame + (2LL * y) * a.w + x;
      __stcs(out, even[p]);
      __stcs(out + a.w, odd[p]);
    } else {
      float4* out = frame + static_cast<long long>(y) * (2 * a.w) + 2 * x;
      __stcs(out, even[p]);
      __stcs(out + 1, odd[p]);
    }
  }
}

template <int AXIS, int COMPS, int NNS>
void launch(const Args& a, int batch, cudaStream_t s) {
  const dim3 grid((a.w + kTw - 1) / kTw, (a.h + kTh - 1) / kTh, batch);
  nnedi3_kernel<AXIS, COMPS, NNS><<<grid, dim3(32, kTh), 0, s>>>(a);
}

template <int AXIS, int COMPS>
bool launch_nns(const Args& a, int batch, int nns, cudaStream_t s) {
  switch (nns) {
    case 16: launch<AXIS, COMPS, 16>(a, batch, s); return true;
    case 32: launch<AXIS, COMPS, 32>(a, batch, s); return true;
    case 64: launch<AXIS, COMPS, 64>(a, batch, s); return true;
    default: return false;
  }
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// tex: f32 [B, h, w, C] at element strides sb, sh, sw, sc (channels 0 ..
// comps - 1 read); weights: f64 [2 nns, 32] contiguous, 16-byte aligned
// (rows 0 .. nns - 1 the neurons' sum1 weights, then their sum2 weights,
// column q = s*4 + c); biases: f32 [2 nns] (b1, then b2); out: f32 [B, oh,
// ow, 4] contiguous, 16-byte aligned, (oh, ow) = (2h, w) for axis 0 and (h,
// 2w) for axis 1. Launches on `stream`; returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an axis, comps or nns the kernel has
// no form for, a batch or a count of row tiles over 65535 or an unaligned
// net or output.
extern "C" int nnedi3_launch(const float* tex, long long sb, long long sh, long long sw, long long sc,
                             const double* weights, const float* biases, float* out, int batch, int h, int w,
                             int axis, int comps, int nns, void* stream) {
  if (batch < 1 || batch > 65535 || h < 1 || w < 1 || (h + kTh - 1) / kTh > 65535 || (axis != 0 && axis != 1) ||
      (comps != 1 && comps != 3) || (nns != 16 && nns != 32 && nns != 64) || !aligned(weights) || !aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{tex, sb, sh, sw, sc, weights, biases, out, h, w};
  const bool ok = axis == 0 ? (comps == 1 ? launch_nns<0, 1>(a, batch, nns, s) : launch_nns<0, 3>(a, batch, nns, s))
                            : (comps == 1 ? launch_nns<1, 1>(a, batch, nns, s) : launch_nns<1, 3>(a, batch, nns, s));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
