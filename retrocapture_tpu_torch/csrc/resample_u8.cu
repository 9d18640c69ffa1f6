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
// What bounds it: bytes. A 320x240 -> 1920x1080 blit of a batch of 128 RGB
// frames writes 796 MB of u8 and reads 118 MB of f32 texels; a 1080p ->
// 1080p blit reads 3.2 GB. After the bytes come the instructions per
// output byte: the first version (one thread per output pixel, the y pass
// redone for both source columns of every pixel, eight table loads a
// pixel, a float -> int conversion and a single-byte global store per
// value) reached 12% of the byte bound on the upscale.
//
// Design:
//  * A warp is the unit of work: it owns one frame, a band of up to 32
//    consecutive output rows and a segment of up to 256 output columns, and
//    shares nothing with the other warps of its block, so no block-wide
//    barrier is needed and the warps of an SM hide each other's latencies.
//    A lane owns the segment's pixels lane, lane + 32, ... (8 at most):
//    neighbouring lanes read neighbouring (in an upscale: the same) texels,
//    which shared memory serves without bank conflicts at any ratio. The
//    wrapper gives each segment the range of source columns its x taps read
//    (lo, n); the x taps of a lane's pixels and the y taps of the band's
//    rows (one row a lane, handed round by shuffle) sit in registers for
//    the whole band.
//  * A texel takes 1, 2 or 4 floats of shared memory (3 channels are padded
//    to 4), so that a tap is one 4-, 8- or 16-byte load for all channels.
//  * The warp keeps two source rows (its segment's n texels) in its part of
//    shared memory, row r in slot r & 1. A row is fetched once, with
//    asynchronous copies (cp.async) issued a row ahead, so that the fetch
//    runs under the x pass and the store of the row before. The y-pass row
//    is computed once per output row into shared memory.
//  * A lane computes its pixels from the y-pass row, packs each value by
//    adding 1.5 * 2^23 (full-rate f32; a float -> int conversion issues at
//    a fraction of that rate) and stages its bytes in shared memory at the
//    offset the segment has modulo 16 in global memory. The warp then
//    writes the staged bytes with 16-byte stores; the bytes before the
//    first and after the last 16-byte boundary go one by one.
//  * A segment whose source range does not fit the shared-memory budget
//    (the wrapper first narrows the segments; only a caller's own matrix
//    with taps far apart gets here), and every segment of a y matrix whose
//    two taps of a row lie an even number of rows apart (they would share a
//    slot; no blit matrix does that), computes the same values from global
//    memory in the same kernel and stages and stores them the same way.
//    The wrapper counts those units (resample.general_blocks()).
//  * The channel count is a template parameter, 1 to 4; the wrapper raises
//    for more (no caller of the port passes more than 4).
//
// Numerics: y = __fadd_rn(__fmul_rn(wy0, t0), __fmul_rn(wy1, t1)), then
// x = __fadd_rn(__fmul_rn(wx0, a0), __fmul_rn(wx1, a1)) with the lower
// source column first, so nvcc cannot contract them into FMAs; the pack
// clamps to [0, 1] (NaN -> 0, as fmaxf drops it), scales by 255 and rounds
// half to even. resample_xphase.cu uses the same operands in the same
// order, so the two kernels write the same bytes.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;  // units per block
constexpr int kThreads = 32 * kWarps;
constexpr int kPix = 8;  // output pixels per lane: lane, lane + 32, ...
constexpr int kSegMax = 32 * kPix;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxShared = 227 * 1024;

// Floats a texel of C channels takes in shared memory.
__host__ __device__ constexpr int padded(int C) { return C == 3 ? 4 : C; }

// round(clamp(b, 0, 1) * 255) in the low byte: adding 1.5 * 2^23 rounds to
// an integer, half to even as rintf does, and leaves it in the low bits.
__device__ __forceinline__ unsigned quant_bits(float b) {
  return __float_as_uint(__fadd_rn(__fmul_rn(fminf(fmaxf(b, 0.0f), 1.0f), 255.0f), 12582912.0f));
}

__device__ __forceinline__ float lerp2(float w0, float t0, float w1, float t1) {
  return __fadd_rn(__fmul_rn(w0, t0), __fmul_rn(w1, t1));
}

// A texel's C channels in shared memory, moved with one load or store.
template <int C>
struct Texel {
  float v[padded(C)];
};
template <int C>
__device__ __forceinline__ Texel<C> load_texel(const float* p) {
  Texel<C> t;
  if (C == 1) {
    t.v[0] = *p;
  } else if (C == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    t.v[0] = f.x;
    t.v[1] = f.y;
  } else {
    const float4 f = *reinterpret_cast<const float4*>(p);
    t.v[0] = f.x;
    t.v[1] = f.y;
    t.v[2] = f.z;
    t.v[3] = f.w;
  }
  return t;
}
template <int C>
__device__ __forceinline__ void store_texel(float* p, const Texel<C>& t) {
  if (C == 1) {
    *p = t.v[0];
  } else if (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(t.v[0], t.v[1]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(t.v[0], t.v[1], t.v[2], t.v[3]);
  }
}

// Start the warp's asynchronous copy of n texels from g (C floats each) into
// shared dst (padded(C) floats each). `wide`: g is 16-byte aligned, so a
// texel of 2 or 4 channels goes in one copy.
template <int C>
__device__ __forceinline__ void fetch_row(float* dst, const float* __restrict__ g, int n, int lane,
                                          bool wide) {
  constexpr int CP = padded(C);
  if ((C == 2 || C == 4) && wide) {
    for (int t = lane; t < n; t += 32) __pipeline_memcpy_async(dst + CP * t, g + C * t, C * sizeof(float));
  } else {
    for (int t = lane; t < n; t += 32) {
#pragma unroll
      for (int c = 0; c < C; ++c) __pipeline_memcpy_async(dst + CP * t + c, g + C * t + c, sizeof(float));
    }
  }
}

// A warp's bytes of dynamic shared memory: the two source rows [2][cap], the
// y-pass row [cap] where there is a y pass (f32, cap a multiple of 4), then
// the staged bytes (16-byte aligned, kSegMax * C + 16).
__host__ __device__ constexpr size_t unit_bytes(bool has_y, int cap, int C) {
  return static_cast<size_t>(has_y ? 3 : 2) * cap * sizeof(float) + kSegMax * C + 16;
}

template <bool HAS_Y, bool HAS_X, int C>
__global__ void __launch_bounds__(kThreads)
resample_u8_kernel(const float* __restrict__ tex, unsigned char* __restrict__ out,
                   const int* __restrict__ yi0, const float* __restrict__ yw0,
                   const int* __restrict__ yi1, const float* __restrict__ yw1,
                   const int* __restrict__ xi0, const float* __restrict__ xw0,
                   const int* __restrict__ xi1, const float* __restrict__ xw1,
                   const int* __restrict__ seg_lo, const int* __restrict__ seg_n,
                   int H, int W, int OH, int OW, int seg_px, int segs, int band, int bands,
                   long long units, int cap) {
  constexpr int CP = padded(C);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long unit = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (unit >= units) return;  // no block-wide barrier below
  float* slot0 = reinterpret_cast<float*>(smem_raw + warp * unit_bytes(HAS_Y, cap, C));
  float* slot1 = slot0 + cap;
  float* sya = slot1 + cap;  // HAS_Y only; else a source row is the y-pass row
  unsigned char* stage = reinterpret_cast<unsigned char*>(HAS_Y ? sya + cap : sya);

  const int seg = static_cast<int>(unit % segs);
  unit /= segs;
  const int bnd = static_cast<int>(unit % bands);
  const int b = static_cast<int>(unit / bands);
  const int x_begin = seg * seg_px;
  const int width = min(OW, x_begin + seg_px) - x_begin;
  const int oy_begin = bnd * band;
  const int oy_end = min(OH, oy_begin + band);
  const int lo = __ldg(seg_lo + seg);
  const int n = __ldg(seg_n + seg);  // 0: the source range is not in shared memory
  const bool fits = n > 0;
  const size_t wc = static_cast<size_t>(W) * C;
  const float* src = tex + static_cast<size_t>(b) * H * wc;
  const bool wide = (reinterpret_cast<uintptr_t>(tex) & 15) == 0;
  const int nbytes = width * C;

  // The x taps of this lane's pixels, for the whole band: float offsets into
  // the y-pass row. A lane past the segment's end computes the segment's
  // last pixel again and stages the same bytes at the same place.
  int e0[kPix], e1[kPix];
  float w0[kPix], w1[kPix];
  if (fits) {
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int x = x_begin + min(32 * j + lane, width - 1);
      e0[j] = ((HAS_X ? __ldg(xi0 + x) : x) - lo) * CP;
      e1[j] = ((HAS_X ? __ldg(xi1 + x) : x) - lo) * CP;
      w0[j] = HAS_X ? __ldg(xw0 + x) : 1.0f;
      w1[j] = HAS_X ? __ldg(xw1 + x) : 0.0f;
    }
  }
  // The y taps of the band: lane l holds row oy_begin + l.
  int my_r0 = 0, my_r1 = 0;
  float my_wy0 = 1.0f, my_wy1 = 0.0f;
  {
    const int oy = min(oy_begin + lane, oy_end - 1);
    if (HAS_Y) {
      my_r0 = __ldg(yi0 + oy);
      my_r1 = __ldg(yi1 + oy);
      my_wy0 = __ldg(yw0 + oy);
      my_wy1 = __ldg(yw1 + oy);
    } else {
      my_r0 = my_r1 = oy;
    }
  }

  // The source rows in shared memory, uniform across the warp: row r lives
  // in slot r & 1, id0 / id1 are the rows held (or on their way) there.
  // request() makes rows r0 and r1 present (r1 - r0 is odd or zero).
  int id0 = -1, id1 = -1;
  const float* seg_src = src + static_cast<size_t>(lo) * C;
  auto request = [&](int r0, int r1) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int r = t == 0 ? r0 : r1;
      if (((r & 1) ? id1 : id0) != r) {
        fetch_row<C>((r & 1) ? slot1 : slot0, seg_src + static_cast<size_t>(r) * wc, n, lane, wide);
        if (r & 1) {
          id1 = r;
        } else {
          id0 = r;
        }
      }
    }
    __pipeline_commit();
  };
  if (fits) request(__shfl_sync(kFull, my_r0, 0), __shfl_sync(kFull, my_r1, 0));

  for (int oy = oy_begin; oy < oy_end; ++oy) {
    const int k = oy - oy_begin;
    const int r0 = __shfl_sync(kFull, my_r0, k);
    const int r1 = __shfl_sync(kFull, my_r1, k);
    const float wy0 = __shfl_sync(kFull, my_wy0, k);
    const float wy1 = __shfl_sync(kFull, my_wy1, k);

    // Stage the bytes at the offset they have modulo 16 in global memory,
    // so that 16-byte-aligned global chunks are 16-byte-aligned in shared.
    unsigned char* orow = out + ((static_cast<size_t>(b) * OH + oy) * OW + x_begin) * C;
    const int s = static_cast<int>(reinterpret_cast<uintptr_t>(orow) & 15);

    if (fits) {
      __pipeline_wait_prior(0);
      __syncwarp();
      const float* ya = (r0 & 1) ? slot1 : slot0;
      if (HAS_Y) {
        const float* ra = ya;
        const float* rb = (r1 & 1) ? slot1 : slot0;
        for (int t = lane; t < n; t += 32) {
          const Texel<C> ta = load_texel<C>(ra + CP * t);
          const Texel<C> tb = load_texel<C>(rb + CP * t);
          Texel<C> y;
#pragma unroll
          for (int c = 0; c < CP; ++c) y.v[c] = c < C ? lerp2(wy0, ta.v[c], wy1, tb.v[c]) : 0.0f;
          store_texel<C>(sya + CP * t, y);
        }
        __syncwarp();
        ya = sya;
      }
      // The slots are free of readers (with a y pass), or the other slot is
      // (without: its readers finished a row ago): fetch what the next row
      // lacks.
      if (oy + 1 < oy_end) request(__shfl_sync(kFull, my_r0, k + 1), __shfl_sync(kFull, my_r1, k + 1));
      // The x pass: a full segment takes the copy without the bounds.
      auto x_pass = [&](auto full_segment) {
        constexpr bool kFullSeg = decltype(full_segment)::value;
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          if (kFullSeg || 32 * j < width) {  // uniform
            const Texel<C> a0 = load_texel<C>(ya + e0[j]);
            Texel<C> a1 = a0;
            if (HAS_X) a1 = load_texel<C>(ya + e1[j]);
            unsigned q[C];
#pragma unroll
            for (int c = 0; c < C; ++c) {
              q[c] = quant_bits(HAS_X ? lerp2(w0[j], a0.v[c], w1[j], a1.v[c]) : a0.v[c]);
            }
            unsigned char* mine = stage + s + C * (kFullSeg ? 32 * j + lane : min(32 * j + lane, width - 1));
            if (C == 4 && (s & 3) == 0) {
              const unsigned lo16 = __byte_perm(q[0], q[1 % C], 0x0040);
              const unsigned hi16 = __byte_perm(q[2 % C], q[3 % C], 0x0040);
              *reinterpret_cast<unsigned*>(mine) = __byte_perm(lo16, hi16, 0x5410);
            } else {
#pragma unroll
              for (int c = 0; c < C; ++c) mine[c] = static_cast<unsigned char>(q[c]);
            }
          }
        }
      };
      if (width == kSegMax) {
        x_pass(std::true_type{});
      } else {
        x_pass(std::false_type{});
      }
    } else {
      // From global memory: the taps and both passes per value.
      const float* row0 = src + static_cast<size_t>(r0) * wc;
      const float* row1 = src + static_cast<size_t>(r1) * wc;
      for (int xl = lane; xl < width; xl += 32) {
        const int x = x_begin + xl;
        const int g0 = (HAS_X ? __ldg(xi0 + x) : x) * C;
        const int g1 = (HAS_X ? __ldg(xi1 + x) : x) * C;
        const float wx0 = HAS_X ? __ldg(xw0 + x) : 1.0f;
        const float wx1 = HAS_X ? __ldg(xw1 + x) : 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float a0 = __ldg(row0 + g0 + c);
          float a1 = __ldg(row0 + g1 + c);
          if (HAS_Y) {
            a0 = lerp2(wy0, a0, wy1, __ldg(row1 + g0 + c));
            a1 = lerp2(wy0, a1, wy1, __ldg(row1 + g1 + c));
          }
          stage[s + C * xl + c] = static_cast<unsigned char>(quant_bits(HAS_X ? lerp2(wx0, a0, wx1, a1) : a0));
        }
      }
    }
    __syncwarp();

    const int head = min((16 - s) & 15, nbytes);
    const int chunks = (nbytes - head) >> 4;
    const int tail = head + (chunks << 4);
    for (int j = lane; j < chunks; j += 32) {
      const int e = head + (j << 4);
      *reinterpret_cast<uint4*>(orow + e) = *reinterpret_cast<const uint4*>(stage + s + e);
    }
    for (int e = lane; e < head; e += 32) orow[e] = stage[s + e];
    for (int e = tail + lane; e < nbytes; e += 32) orow[e] = stage[s + e];
    __syncwarp();  // the next row stages over these bytes
  }
}

struct Args {
  const float* tex;
  unsigned char* out;
  const int* yi0;
  const float* yw0;
  const int* yi1;
  const float* yw1;
  const int* xi0;
  const float* xw0;
  const int* xi1;
  const float* xw1;
  const int* seg_lo;
  const int* seg_n;
  int B, H, W, OH, OW, seg_px, band, cap;
  cudaStream_t stream;
};

template <bool HAS_Y, bool HAS_X, int C>
int launch(const Args& a) {
  if (a.seg_px < 1 || a.seg_px > kSegMax || a.band < 1 || a.band > 32 || a.cap < 0 || (a.cap & 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int segs = (a.OW + a.seg_px - 1) / a.seg_px;
  const int bands = (a.OH + a.band - 1) / a.band;
  const long long units = static_cast<long long>(segs) * bands * a.B;
  const long long blocks = (units + kWarps - 1) / kWarps;
  if (blocks < 1 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = kWarps * unit_bytes(HAS_Y, a.cap, C);
  if (shmem > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(resample_u8_kernel<HAS_Y, HAS_X, C>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  resample_u8_kernel<HAS_Y, HAS_X, C><<<static_cast<unsigned>(blocks), kThreads, shmem, a.stream>>>(
      a.tex, a.out, a.yi0, a.yw0, a.yi1, a.yw1, a.xi0, a.xw0, a.xi1, a.xw1, a.seg_lo, a.seg_n, a.H,
      a.W, a.OH, a.OW, a.seg_px, segs, a.band, bands, units, a.cap);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_yx(const Args& a) {
  const bool hy = a.yi0 != nullptr;
  const bool hx = a.xi0 != nullptr;
  if (hy && hx) return launch<true, true, C>(a);
  if (hy) return launch<true, false, C>(a);
  if (hx) return launch<false, true, C>(a);
  return launch<false, false, C>(a);
}

}  // namespace

// tex: f32 [B, H, W, C] contiguous, 1 <= C <= 4; out: u8 [B, OH, OW, C]. A
// null y (x) table means the axis is the identity and its pass is skipped.
// Output columns are cut into segments of seg_px (at most 256); seg_lo and
// seg_n [ceil(OW / seg_px)] give the first source column and the count of
// source columns that the segment's x taps read (the segment's own columns
// where x is the identity), n = 0 for a segment that reads from global
// memory (every segment, where the two y taps of some row lie an even,
// nonzero number of rows apart); cap is the largest n times the floats a
// texel takes in shared memory (1, 2, 4, 4 for C = 1..4), rounded up to a
// multiple of 4. band: output rows per unit, at most 32. Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for another C or a plan that
// exceeds shared memory.
extern "C" int resample_u8_launch(const float* tex, unsigned char* out,
                                  const int* yi0, const float* yw0,
                                  const int* yi1, const float* yw1,
                                  const int* xi0, const float* xw0,
                                  const int* xi1, const float* xw1,
                                  const int* seg_lo, const int* seg_n,
                                  int B, int H, int W, int C, int OH, int OW,
                                  int seg_px, int band, int cap, void* stream) {
  const Args a{tex, out, yi0, yw0, yi1, yw1, xi0, xw0, xi1, xw1, seg_lo, seg_n,
               B, H, W, OH, OW, seg_px, band, cap, static_cast<cudaStream_t>(stream)};
  switch (C) {
    case 1: return launch_yx<1>(a);
    case 2: return launch_yx<2>(a);
    case 3: return launch_yx<3>(a);
    case 4: return launch_yx<4>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
