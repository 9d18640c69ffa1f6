// The xbr-lv2 front section for Hopper (sm_90a): the 19 planes S that the
// epilogue (xbr_epilogue.cu) reads, written once from the source texels.
//
// Replaces no TPU kernel: the reference's front section is jnp code inside
// retrocapture_tpu/graph/kernels.py:_xbr_lv2_kernel (:340), which XLA fuses.
// The port ran it as eager torch (graph/kernels.py:_xbr_planes, still the
// plain version): 5 row gathers, 10 column slices, 5 luma maps, 8 stacks of
// [4, OH, W] and about 120 elementwise passes of the edge rules, each a
// pass over [B, 4, OH, W] f32 in device memory.
//
// Per output row r and source column x of frame b it computes, from the 21
// NEAREST taps tex[rows[dy][r], cols[x + 2 + dx]] (dx, dy in -2..2, the
// corners of the 5x5 window left out):
//   planes 0-14: the E, H, F, B, D colours x255 (rounded to the level for a
//     texture on the k/255 grid, `quantized`), 3 channels each;
//   planes 15-18: one code a corner, edri + 2 edr + 4 edr_left + 8 edr_up +
//     16 px, from the lumas of the taps (and, for small_details >= 0.5, the
//     y-weighted lumas of the 12 outer taps).
// The four corners are the same rules on the window rotated by 90 degrees:
// corner i reads tap (dx, dy) of corner 0 at rot^i(dx, dy), rot(dx, dy) =
// (dy, -dx).
//
// What bounds it: bytes. S is 19 planes [OH, W] f32 a frame; at batch 64
// and 240x320 -> 1080 rows that is 1.68 GB, 0.50 ms at 3.35 TB/s. The
// source (19.7-78.6 MB as u8 to RGBA f32) is read a few times from L2.
//
// Design:
//  * A block owns `tile_px` source columns (one a thread) and `rows`
//    consecutive output rows of one frame, and walks its rows in order.
//  * An output row's S depends only on its five row indices. When they
//    equal the row before's (about 4.5 output rows a source row at 240 ->
//    1080), the thread stores the 19 values it holds in registers again.
//    Otherwise the block stages, in shared memory, the five gathered rows
//    over its columns plus a 2-texel halo: each texel's luma (and y-luma)
//    once, and the colours x255 of the middle three rows; then each thread
//    computes its 19 values from shared memory. The branch is the same
//    for the whole block (the row indices are).
//  * Each value is stored with a streaming store (st.global.cs): a warp
//    writes 128 contiguous bytes of each plane, and nothing reads S back
//    before the epilogue.
//
// Numerics: every rounding is written out, and the source is built with
// -fmad=false (ops/cuda/_build.py), so nothing is contracted behind them.
// The luma is _xbr_lum's fma32(x2, w2, fma32(x0, w0, x1 * w1)), fma32 as
// policy.fma32 defines it (the f64 product is exact, the f64 sum rounded,
// then narrowed); torch.round is rintf (half to even); the sums of wd1 and
// wd2 run in the written order; wd1 + f32(0.1) and cf * df are rounded
// before their comparison; the never-assigned vec4 f4 is 0. So S is
// bit-equal to the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPlanes = 19;
constexpr int kHalo = 2;
constexpr int kMaxThreads = 512;
constexpr int kStagedRows = 5;  // dy = -2..2
constexpr int kColourRows = 3;  // dy = -1..1: the colours of E, H, F, B, D

// The kernel's constants, by value in its parameter space.
struct Constants {
  float eq_thr;  // XBR_EQ_THRESHOLD
  float cf;      // XBR_LV2_COEFFICIENT
  float inv255;  // f32(1 / 255)
  float tenth;   // f32(0.1)
  float lw[3];   // the luma weights (_XBR_RGBW)
  float yw[3];   // the y-luma weights (_XBR_Y x XBR_Y_WEIGHT, each rounded to f32)
};

// The five row-index maps [OH] (dy = -2..2), int64.
struct Rows {
  const long long* p[kStagedRows];
};

// policy.fma32: a*b + c rounded once to f32 through an f64 sum. The product
// of two f32 values is exact in f64, __dadd_rn rounds the sum to f64 and
// __double2float_rn narrows it. A copy of csrc/fma.cu's formula.
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)), static_cast<double>(c)));
}

// _xbr_lum: dot(rgb, w) as jitted XLA computes it.
__device__ __forceinline__ float luma(float x0, float x1, float x2, const float (&w)[3]) {
  return fma32(x2, w[2], fma32(x0, w[0], __fmul_rn(x1, w[1])));
}

__device__ __forceinline__ float df(float a, float b) { return fabsf(__fsub_rn(a, b)); }

// Tap (dx, dy) of corner 0, turned R quarter turns: rot(dx, dy) = (dy, -dx).
template <int R>
struct Rot {
  __host__ __device__ static constexpr int x(int dx, int dy) { return Rot<R - 1>::y(dx, dy); }
  __host__ __device__ static constexpr int y(int dx, int dy) { return -Rot<R - 1>::x(dx, dy); }
};
template <>
struct Rot<0> {
  __host__ __device__ static constexpr int x(int dx, int dy) { return dx; }
  __host__ __device__ static constexpr int y(int dx, int dy) { return dy; }
};

// One corner's code: edri + 2 edr + 4 edr_left + 8 edr_up + 16 px, the
// rules of _xbr_planes in their order. `lum` and `far` point at the
// thread's column (dx = 0) of the staged rows' dy = 0 row; `far` holds the
// taps i4, i5, h5 read (lumas, or y-lumas for small_details >= 0.5).
template <int R>
__device__ __forceinline__ float corner_code(const float* lum, const float* far, int txh, bool small,
                                             const Constants& k) {
#define TAP(p, dx, dy) p[Rot<R>::y(dx, dy) * txh + Rot<R>::x(dx, dy)]
  const float e = lum[0];
  const float b = TAP(lum, 0, -1), c = TAP(lum, 1, -1), d = TAP(lum, -1, 0), f = TAP(lum, 1, 0);
  const float g = TAP(lum, -1, 1), h = TAP(lum, 0, 1), i = TAP(lum, 1, 1);
  const float i4 = TAP(far, 2, 1), i5 = TAP(far, 1, 2), h5 = TAP(far, 0, 2);
#undef TAP
  const float thr = k.eq_thr;
  auto eq = [thr](float p, float q) { return df(p, q) <= thr; };
  const bool irlv0 = (e != f) && (e != h);
  const bool irlv1 = irlv0 && ((!eq(f, b) && !eq(f, c)) || (!eq(h, d) && !eq(h, g)) ||
                               (eq(e, i) && ((!eq(f, 0.0f) && !eq(f, i4)) || (!eq(h, h5) && !eq(h, i5)))) ||
                               eq(e, g) || eq(e, c));
  const bool irlv2l = (e != g) && (d != g);
  const bool irlv2u = (e != c) && (b != c);
  float wd1, wd2;
  if (!small) {
    wd1 = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(df(e, c), df(e, g)), df(i, h5)), df(i, 0.0f)),
                    __fmul_rn(4.0f, df(h, f)));
    wd2 = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(df(h, d), df(h, i5)), df(f, i4)), df(f, b)),
                    __fmul_rn(4.0f, df(e, i)));
  } else {
    wd1 = __fadd_rn(
        __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(df(e, c), df(e, g)), df(i, 0.0f)), df(i, h5)), df(b, d)),
                  df(i4, i5)),
        __fmul_rn(2.0f, df(h, f)));
    wd2 = __fadd_rn(
        __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(df(h, d), df(h, i5)), df(f, b)), df(f, i4)), df(g, h5)),
                  df(c, 0.0f)),
        __fmul_rn(2.0f, df(e, i)));
  }
  const bool edri = (wd2 >= wd1) && irlv0;
  const bool edr = (wd2 >= __fadd_rn(wd1, k.tenth)) && irlv1;
  const bool edr_l = (df(h, c) >= __fmul_rn(k.cf, df(f, g))) && irlv2l && edr;
  const bool edr_u = (df(f, g) >= __fmul_rn(k.cf, df(h, c))) && irlv2u && edr;
  const bool px = df(e, h) >= df(e, f);
  return static_cast<float>(int(edri) + 2 * int(edr) + 4 * int(edr_l) + 8 * int(edr_u) + 16 * int(px));
}

__global__ void __launch_bounds__(kMaxThreads) xbr_front_kernel(
    const float* __restrict__ tex, long long sb, long long sh, long long sw, long long sc,
    const long long* __restrict__ cols, Rows rows, Constants k, float* __restrict__ out, int H, int W, int OH,
    int rows_per_block, int small, int quantized) {
  extern __shared__ float smem[];
  const int tx = threadIdx.x;
  const int tile = blockDim.x;
  const int txh = tile + 2 * kHalo;
  float* s_lum = smem;                           // [5][txh]
  float* s_lumy = s_lum + kStagedRows * txh;     // [5][txh], small_details >= 0.5 only
  float* s_col = s_lumy + kStagedRows * txh;     // [3 rows][3 channels][txh]
  const int x0 = blockIdx.x * tile;
  const int x = x0 + tx;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(r0 + rows_per_block, OH);
  const float* texb = tex + static_cast<long long>(blockIdx.z) * sb;
  const size_t plane = static_cast<size_t>(OH) * W;
  float* outp = out + static_cast<size_t>(blockIdx.z) * kPlanes * plane + x;
  const bool is_small = small != 0;
  const float* far = is_small ? s_lumy : s_lum;

  int held[kStagedRows] = {-1, -1, -1, -1, -1};
  float v[kPlanes];
  for (int r = r0; r < r1; ++r) {
    int cur[kStagedRows];
    bool same = true;
#pragma unroll
    for (int q = 0; q < kStagedRows; ++q) {
      cur[q] = static_cast<int>(min(max(__ldg(rows.p[q] + r), 0LL), static_cast<long long>(H - 1)));
      same = same && cur[q] == held[q];
    }
    if (!same) {  // the same for every thread of the block
      __syncthreads();  // every thread is done reading the rows staged before
      for (int j = tx; j < txh; j += tile) {
        const long long c = min(max(__ldg(cols + min(x0 + j, W + 3)), 0LL), static_cast<long long>(W - 1));
#pragma unroll
        for (int q = 0; q < kStagedRows; ++q) {
          const float* t = texb + cur[q] * sh + c * sw;
          float c0 = __fmul_rn(__ldg(t), 255.0f);
          float c1 = __fmul_rn(__ldg(t + sc), 255.0f);
          float c2 = __fmul_rn(__ldg(t + 2 * sc), 255.0f);
          if (quantized) {
            c0 = rintf(c0);
            c1 = rintf(c1);
            c2 = rintf(c2);
          }
          if (q >= 1 && q <= kColourRows) {
            float* sc_row = s_col + (q - 1) * 3 * txh + j;
            sc_row[0] = c0;
            sc_row[txh] = c1;
            sc_row[2 * txh] = c2;
          }
          const float t0 = __fmul_rn(c0, k.inv255), t1 = __fmul_rn(c1, k.inv255), t2 = __fmul_rn(c2, k.inv255);
          s_lum[q * txh + j] = luma(t0, t1, t2, k.lw);
          if (is_small) s_lumy[q * txh + j] = luma(t0, t1, t2, k.yw);
        }
      }
      __syncthreads();
      const int m = kHalo * txh + tx + kHalo;  // the thread's tap (0, 0)
      // E (0, 0), H (0, 1), F (1, 0), B (0, -1), D (-1, 0): colour row dy + 1.
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float* cc = s_col + ch * txh + tx + kHalo;
        v[ch] = cc[3 * txh];            // E
        v[3 + ch] = cc[6 * txh];        // H
        v[6 + ch] = cc[3 * txh + 1];    // F
        v[9 + ch] = cc[0];              // B
        v[12 + ch] = cc[3 * txh - 1];   // D
      }
      v[15] = corner_code<0>(s_lum + m, far + m, txh, is_small, k);
      v[16] = corner_code<1>(s_lum + m, far + m, txh, is_small, k);
      v[17] = corner_code<2>(s_lum + m, far + m, txh, is_small, k);
      v[18] = corner_code<3>(s_lum + m, far + m, txh, is_small, k);
#pragma unroll
      for (int q = 0; q < kStagedRows; ++q) held[q] = cur[q];
    }
    if (x < W) {
      float* o = outp + static_cast<size_t>(r) * W;
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) __stcs(o + p * plane, v[p]);
    }
  }
}

}  // namespace

// tex [B, H, W, >= 3] f32 with element strides (sb, sh, sw, sc); cols
// [W + 4] and rows[5] [OH] int64 (clamped again here); consts (host
// memory): eq_thr, cf, 1/255, 0.1, the 3 luma and the 3 y-luma weights;
// out [B, 19, OH, W] f32, contiguous. Returns cudaGetLastError().
extern "C" int xbr_front_launch(const float* tex, long long sb, long long sh, long long sw, long long sc,
                                const long long* cols, const long long* r_m2, const long long* r_m1,
                                const long long* r_0, const long long* r_p1, const long long* r_p2,
                                const float* consts, float* out, int B, int H, int W, int OH, int tile_px,
                                int rows, int small, int quantized, void* stream) {
  if (B < 1 || H < 1 || W < 1 || OH < 1 || B > 65535 || rows < 1 || tile_px < 32 || tile_px > kMaxThreads ||
      (tile_px & 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int row_tiles = (OH + rows - 1) / rows;
  if (row_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = static_cast<size_t>(tile_px + 2 * kHalo) * (2 * kStagedRows + 3 * kColourRows) * sizeof(float);
  Constants k;
  k.eq_thr = consts[0];
  k.cf = consts[1];
  k.inv255 = consts[2];
  k.tenth = consts[3];
  for (int i = 0; i < 3; ++i) {
    k.lw[i] = consts[4 + i];
    k.yw[i] = consts[7 + i];
  }
  const Rows rs = {{r_m2, r_m1, r_0, r_p1, r_p2}};
  const dim3 grid((W + tile_px - 1) / tile_px, row_tiles, B);
  xbr_front_kernel<<<grid, tile_px, shmem, static_cast<cudaStream_t>(stream)>>>(
      tex, sb, sh, sw, sc, cols, rs, k, out, H, W, OH, rows, small, quantized);
  return static_cast<int>(cudaGetLastError());
}
