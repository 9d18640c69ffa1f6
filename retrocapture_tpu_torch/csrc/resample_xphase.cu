// Integer-ratio LINEAR viewport blit in phase form + uint8 pack for Hopper
// (sm_90a).
//
// Replaces the TPU kernel retrocapture_tpu/ops/pallas/resample.py:
// _resample_u8_xphase (body _make_kernel_xphase, plan _xphase_plan),
// which blit_u8 takes under RCTPU_XPHASE=on when the output width is an
// integer multiple r of the source width. Output column X = r*k + p reads
// the y-pass values at source columns k + d[p] and k + d[p] + 1 (clamped)
// with the matrix's own weights w0[p, k], w1[p, k]. On the TPU the phase
// form replaced a dense [W, OW] MXU matmul; here it is the same 2-tap sum
// as resample_u8.cu.
//
// What bounds it: the bytes it writes (a 320x240 -> 1920x1080 blit of a
// batch of 128 RGB frames writes 796 MB of u8), and then the instructions
// per output byte. The first version (one thread per source column, 18
// single-byte stores and 36 weight loads per thread, the y pass redone
// for 3 columns per channel, 2.5 blocks per row) reached 7.1% of the byte
// bound.
//
// Design:
//  * A block owns one frame and a band of kBand consecutive output rows.
//  * It loads the phase tables d, w0, w1 into shared memory once.
//  * It keeps the current pair of source rows in shared memory and loads
//    them again only when the y taps move to other rows (every 4.5 output
//    rows at 240 -> 1080); the y-pass row (all channels) is computed once
//    per output row into shared memory.
//  * A thread computes the r*C bytes of one or two source columns with
//    no divergence (the y-pass values at k-1, k, k+1 loaded once) and
//    stages them in shared memory, where consecutive threads' bytes land
//    in distinct banks; the block then writes the staged row with 16-byte
//    stores, each thread 16 consecutive output bytes across pixel and
//    phase boundaries. The bytes of a row before its first and after its
//    last 16-byte boundary (rows whose length or start is not a multiple
//    of 16) are written one by one.
//
// Numerics: y = __fadd_rn(__fmul_rn(wy0, t0), __fmul_rn(wy1, t1)), then
// x = __fadd_rn(__fmul_rn(w0, a0), __fmul_rn(w1, a1)) with the lower
// source column first: the operands and order of resample_u8.cu, so the
// two kernels write the same bytes. The pack clamps to [0, 1] (NaN -> 0,
// as fmaxf drops it), scales by 255 and rounds half to even (quant_u8).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 160;
constexpr int kBand = 24;  // output rows per block
constexpr size_t kMaxShared = 227 * 1024;

// round(clamp(b, 0, 1) * 255) with NaN -> 0 (fmaxf drops it), in full-rate
// f32 operations (a float -> int conversion issues at 1/8 of the f32
// rate): adding 1.5*2^23 rounds to an integer, half to even as rintf
// does, and leaves it in the low bits of the sum.
__device__ __forceinline__ unsigned char quant_u8(float b) {
  const float t = __fadd_rn(__fmul_rn(fminf(fmaxf(b, 0.0f), 1.0f), 255.0f), 12582912.0f);
  return static_cast<unsigned char>(__float_as_uint(t));
}

// Source column k's r*C bytes of an output row (phases p, channels c) into
// `dst`, from the y-pass row `ya` [W][C]: the y-pass values at k-1, k, k+1
// are loaded once, each phase's weights once.
template <int C>
__device__ __forceinline__ void column_bytes(unsigned char* dst, const float* ya, const float* sw0,
                                             const float* sw1, const int* sd, int k, int W, int R) {
  const int km = max(k - 1, 0);
  const int kp = min(k + 1, W - 1);
  float am[C], a0[C], ap[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    am[c] = ya[km * C + c];
    a0[c] = ya[k * C + c];
    ap[c] = ya[kp * C + c];
  }
  for (int p = 0; p < R; ++p) {
    // d[p] in {-1, 0}: taps (k-1, k) or (k, k+1).
    const bool lo = sd[p] < 0;
    const float wa = sw0[p * W + k];
    const float wb = sw1[p * W + k];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float t0 = lo ? am[c] : a0[c];
      const float t1 = lo ? a0[c] : ap[c];
      dst[p * C + c] = quant_u8(__fadd_rn(__fmul_rn(wa, t0), __fmul_rn(wb, t1)));
    }
  }
}

__host__ __device__ __forceinline__ size_t stage_offset(int R, int W, int C, bool has_y) {
  const size_t floats = 2 * static_cast<size_t>(R) * W + (has_y ? 3 : 1) * static_cast<size_t>(W) * C + R;
  return (floats * 4 + 15) & ~static_cast<size_t>(15);
}

// Dynamic shared memory: w0 [R][W], w1 [R][W], the source rows [2][W][C]
// (y pass only), the y-pass row [W][C] (f32), d [R] (i32), then the
// staged output row (16-byte aligned, rowbytes + 16 bytes).
template <bool HAS_Y, int C>
__global__ void __launch_bounds__(kThreads)
resample_xphase_kernel(const float* __restrict__ tex, unsigned char* __restrict__ out,
                       const int* __restrict__ yi0, const float* __restrict__ yw0,
                       const int* __restrict__ yi1, const float* __restrict__ yw1,
                       const int* __restrict__ d, const float* __restrict__ w0,
                       const float* __restrict__ w1, int H, int W, int OH, int R) {
  extern __shared__ __align__(16) float smem[];
  const int rw = R * W;
  const int wc = W * C;
  float* sw0 = smem;
  float* sw1 = sw0 + rw;
  float* srow = sw1 + rw;  // [2][W][C]
  float* sya = HAS_Y ? srow + 2 * wc : srow;
  int* sd = reinterpret_cast<int*>(sya + wc);
  unsigned char* stage = reinterpret_cast<unsigned char*>(smem) + stage_offset(R, W, C, HAS_Y);

  const int b = blockIdx.y;
  const int oy_begin = blockIdx.x * kBand;
  const int oy_end = min(OH, oy_begin + kBand);
  const float* src = tex + static_cast<size_t>(b) * H * wc;
  const int rowbytes = R * wc;
  // A thread stages whole source columns; two at a time when r*C is 2 mod
  // 4, so that consecutive threads' bytes lie an odd number of 4-byte
  // banks apart.
  const int m = ((R * C) & 3) == 2 ? 2 : 1;
  const int units = (W + m - 1) / m;

  for (int i = threadIdx.x; i < rw; i += kThreads) {
    sw0[i] = __ldg(w0 + i);
    sw1[i] = __ldg(w1 + i);
  }
  for (int i = threadIdx.x; i < R; i += kThreads) sd[i] = __ldg(d + i);

  int cur0 = -1, cur1 = -1;
  for (int oy = oy_begin; oy < oy_end; ++oy) {
    // The y-pass row.
    if (HAS_Y) {
      const int r0 = __ldg(yi0 + oy);
      const int r1 = __ldg(yi1 + oy);
      if (r0 != cur0 || r1 != cur1) {  // block-uniform
        for (int e = threadIdx.x; e < wc; e += kThreads) {
          srow[e] = __ldg(src + static_cast<size_t>(r0) * wc + e);
          srow[wc + e] = __ldg(src + static_cast<size_t>(r1) * wc + e);
        }
        cur0 = r0;
        cur1 = r1;
        __syncthreads();
      }
      const float wa = __ldg(yw0 + oy);
      const float wb = __ldg(yw1 + oy);
      for (int e = threadIdx.x; e < wc; e += kThreads) {
        sya[e] = __fadd_rn(__fmul_rn(wa, srow[e]), __fmul_rn(wb, srow[wc + e]));
      }
    } else {
      for (int e = threadIdx.x; e < wc; e += kThreads) {
        sya[e] = __ldg(src + static_cast<size_t>(oy) * wc + e);
      }
    }
    __syncthreads();

    // Stage the row at the offset it has modulo 16 in global memory, so
    // that 16-byte-aligned global chunks are 16-byte-aligned in shared.
    unsigned char* orow = out + (static_cast<size_t>(b) * OH + oy) * rowbytes;
    const int s = static_cast<int>(reinterpret_cast<uintptr_t>(orow) & 15);
    for (int q = threadIdx.x; q < units; q += kThreads) {
      for (int k = q * m; k < min(q * m + m, W); ++k) {
        column_bytes<C>(stage + s + static_cast<size_t>(k) * R * C, sya, sw0, sw1, sd, k, W, R);
      }
    }
    __syncthreads();

    const int head = min((16 - s) & 15, rowbytes);
    const int chunks = (rowbytes - head) >> 4;
    const int tail = head + (chunks << 4);
    for (int q = threadIdx.x; q < chunks; q += kThreads) {
      const int e = head + (q << 4);
      *reinterpret_cast<uint4*>(orow + e) = *reinterpret_cast<const uint4*>(stage + s + e);
    }
    for (int e = threadIdx.x; e < head; e += kThreads) orow[e] = stage[s + e];
    for (int e = tail + threadIdx.x; e < rowbytes; e += kThreads) orow[e] = stage[s + e];
    // The next row's staging comes after the __syncthreads that follows
    // its y pass, so this row's copy has finished by then.
  }
}

template <bool HAS_Y, int C>
int launch(const float* tex, unsigned char* out, const int* yi0, const float* yw0, const int* yi1,
           const float* yw1, const int* d, const float* w0, const float* w1, int B, int H, int W,
           int OH, int R, cudaStream_t s) {
  const size_t shmem = stage_offset(R, W, C, HAS_Y) + static_cast<size_t>(R) * W * C + 16;
  if (shmem > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(resample_xphase_kernel<HAS_Y, C>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((OH + kBand - 1) / kBand, B);
  resample_xphase_kernel<HAS_Y, C><<<grid, kThreads, shmem, s>>>(tex, out, yi0, yw0, yi1, yw1, d,
                                                                 w0, w1, H, W, OH, R);
  return static_cast<int>(cudaGetLastError());
}

template <bool HAS_Y>
int launch_c(const float* tex, unsigned char* out, const int* yi0, const float* yw0, const int* yi1,
             const float* yw1, const int* d, const float* w0, const float* w1, int B, int H, int W,
             int C, int OH, int R, cudaStream_t s) {
  switch (C) {
    case 1: return launch<HAS_Y, 1>(tex, out, yi0, yw0, yi1, yw1, d, w0, w1, B, H, W, OH, R, s);
    case 2: return launch<HAS_Y, 2>(tex, out, yi0, yw0, yi1, yw1, d, w0, w1, B, H, W, OH, R, s);
    case 3: return launch<HAS_Y, 3>(tex, out, yi0, yw0, yi1, yw1, d, w0, w1, B, H, W, OH, R, s);
    case 4: return launch<HAS_Y, 4>(tex, out, yi0, yw0, yi1, yw1, d, w0, w1, B, H, W, OH, R, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// tex: f32 [B, H, W, C] contiguous, 1 <= C <= 4; out: u8 [B, OH, R*W, C].
// A null y table means the y axis is the identity (OH == H). d: int32 [R]
// in {-1, 0}; w0, w1: f32 [R, W]. Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for another C or when the
// tables and rows exceed shared memory.
extern "C" int resample_xphase_launch(const float* tex, unsigned char* out, const int* yi0,
                                      const float* yw0, const int* yi1, const float* yw1,
                                      const int* d, const float* w0, const float* w1, int B,
                                      int H, int W, int C, int OH, int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (yi0 != nullptr) {
    return launch_c<true>(tex, out, yi0, yw0, yi1, yw1, d, w0, w1, B, H, W, C, OH, R, s);
  }
  return launch_c<false>(tex, out, yi0, yw0, yi1, yw1, d, w0, w1, B, H, W, C, OH, R, s);
}
