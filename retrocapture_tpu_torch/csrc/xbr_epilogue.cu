// The xbr-lv2 full-resolution epilogue for Hopper (sm_90a).
//
// Replaces the TPU kernel retrocapture_tpu/ops/pallas/xbr_epilogue.py:
// xbr_epilogue. The xbr-lv2 hand kernel reduces the shader to 19 planes at
// [output rows, source columns]: the E, H, F, B, D colours x255 and four
// packed flag codes (S [B, 19, OH, W]). Per output pixel (b, y, x) this
// kernel reads the 19 values at source column bx[x] (a NEAREST
// x-upsample), scales the colours by 1/255, decodes each code into its five
// flags (edri, edr, edr_left, edr_up, px), rebuilds the four fp ramps of
// each corner from fpy[y] and fpx[x], takes their flag-weighted maximum,
// and does the px mixes, res1/res2 and the c_df select; alpha = 1.
//
// The TPU kernel rebuilt the x-upsample from a rotated 128-lane window,
// because Mosaic gathers are single-vreg; that limited it to sources whose
// column span per tile fits the window (xbr_epilogue_fits). No width limit
// here.
//
// What bounds it: bytes. Per frame at 320 -> 1920, 1080 rows it must read
// S (19 x 1080 x 320 x 4 B = 26.3 MB) and write the output (1080 x 1920 x
// 16 B = 33.2 MB): 59.4 MB, 17.7 us at 3.35 TB/s. Then the slow
// instructions: the contracted mixes are f64 (policy.fma32's formula), and
// a conversion to or from a 64-bit type issues at 1/8 of the f32 rate. The
// first version (one thread per output pixel) spent about 48 such
// conversions, 24 int <-> float conversions and 64 loads of the ramp table a
// pixel, and redid the per-source-column work (scales, decodes, px mixes)
// for each of the r output columns of a source column.
//
// Design:
//  * A block owns a tile of `rows` output rows x `tile_px` output columns
//    (one column a thread) of one frame. The wrapper gives each column
//    tile the range of source columns that bx maps it to (lo, n); any bx
//    has such a range, monotone or not.
//  * Phase A, once per source texel of the tile (rows x n of them, spread
//    over the threads, loads coalesced along the row): the 15 scales, the
//    decode (the code's integer read from the f32 bits after adding 2^23,
//    no conversion), the four px mixes, and what the first mixes need in
//    f64: E, tx - E and ty - E. These go to shared memory beside E, tz,
//    tw in f32 and the 16 flag bits, a record of seven 16-byte words a
//    texel (the stores of neighbouring texels fall in distinct banks).
//  * Phase B, per output pixel: the 16 ramps from constants in the
//    kernel's parameter space (B * fx of a thread's column is the same for
//    all its rows), a flag times a ramp as a select (the ramp is clamped,
//    so flag ? ramp : 0 has the product's bits), the weights m converted to
//    f64 once per corner, each contracted mix as one f64 fma (the product
//    of two f32 values is exact in f64, so fma(d, m, a) = d * m + a rounded
//    once to f64, then to f32), the c_df select and one float4 store,
//    coalesced. About 28 conversions a pixel remain.
//  * A column tile whose source range exceeds the shared-memory budget (a
//    downscale, a scattered bx) does phase A's work per pixel in registers
//    from global memory, in the same kernel; the wrapper counts those
//    blocks (xbr_epilogue.general_blocks()).
//
// Numerics: every rounding is written out. __fmul_rn/__fadd_rn where the
// reference (jitted XLA on the CPU) rounds each operation; the mixes by a
// fractional ramp weight, which XLA contracts, as the f64 product and sum
// rounded once to f64 and once to f32, the formula of the port's
// policy.fma32. So the kernel is bit-equal to the plain torch version; a
// true fmaf would differ from it in rare double-rounding cases.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 3;  // blocks an SM: 78 registers a thread, no spills
constexpr int kChannels = 19;

// [ramp][corner][A, B, c, k], ramps fx30, fx60, fx45, fx45i; then 1/255.
struct Constants {
  float ramp[4][4][4];
  float inv255;
};

// What phase B needs of one source texel: 112 bytes, moved to and from
// shared memory as seven 16-byte words.
struct __align__(16) Texel {
  double dE[3], dx[3], dy[3];  // E, tx - E, ty - E
  float E[3], tz[3], tw[3];
  unsigned flags;  // corner ci: bits 4ci..4ci+3 = edri, edr, edr_left, edr_up
};
static_assert(sizeof(Texel) == 112, "Texel is seven 16-byte words");
constexpr int kTexelWords = sizeof(Texel) / 16;

// a + (b - a) * m, m a flag (0 or 1): the product is exact.
__device__ __forceinline__ float mix_flag(float a, float b, float m) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), m));
}

// a + (b - a) * m contracted, m already in f64: the f64 product is exact,
// the sum is rounded once to f64 and then to f32.
__device__ __forceinline__ float mix_frac(float a, float b, double m) {
  return __double2float_rn(__fma_rn(static_cast<double>(__fsub_rn(b, a)), m, static_cast<double>(a)));
}

// The 19 values at `s` (stride `plane`) to a texel record.
__device__ __forceinline__ Texel prepare(const float* __restrict__ s, size_t plane, float inv) {
  float v[kChannels];
#pragma unroll
  for (int c = 0; c < kChannels; ++c) v[c] = __ldg(s + c * plane);
  float H[3], F[3], B[3], D[3], px[4];
  Texel t;
  t.flags = 0;
#pragma unroll
  for (int ci = 0; ci < 4; ++ci) {
    // Codes are integers 0..31 by construction: bit k is the k-th flag, the
    // values the reference's remainder/floor decode gives. code + 2^23 is
    // exact and holds the integer in its low mantissa bits.
    const unsigned code = __float_as_uint(__fadd_rn(v[15 + ci], 8388608.0f)) & 31u;
    t.flags |= (code & 15u) << (4 * ci);
    px[ci] = (code & 16u) ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t.E[i] = __fmul_rn(v[i], inv);
    H[i] = __fmul_rn(v[3 + i], inv);
    F[i] = __fmul_rn(v[6 + i], inv);
    B[i] = __fmul_rn(v[9 + i], inv);
    D[i] = __fmul_rn(v[12 + i], inv);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float tx = mix_flag(H[i], F[i], px[0]);
    const float ty = mix_flag(F[i], B[i], px[1]);
    t.tz[i] = mix_flag(B[i], D[i], px[2]);
    t.tw[i] = mix_flag(D[i], H[i], px[3]);
    t.dE[i] = static_cast<double>(t.E[i]);
    t.dx[i] = static_cast<double>(__fsub_rn(tx, t.E[i]));
    t.dy[i] = static_cast<double>(__fsub_rn(ty, t.E[i]));
  }
  return t;
}

// clip(((A fy + B fx) + c) * k, 0, 1) with B fx given.
__device__ __forceinline__ float ramp(const float (&r)[4], float fy, float bfx) {
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(r[0], fy), bfx), r[2]);
  return fminf(fmaxf(__fmul_rn(s, r[3]), 0.0f), 1.0f);
}

// One output pixel from its texel record; bfx[ramp][corner] = B * fx.
__device__ __forceinline__ float4 finish(const Texel& t, const Constants& k, float fy,
                                         const float (&bfx)[4][4]) {
  double m[4];
#pragma unroll
  for (int ci = 0; ci < 4; ++ci) {
    const unsigned f = t.flags >> (4 * ci);
    const float r30 = (f & 4u) ? ramp(k.ramp[0][ci], fy, bfx[0][ci]) : 0.0f;
    const float r60 = (f & 8u) ? ramp(k.ramp[1][ci], fy, bfx[1][ci]) : 0.0f;
    const float r45 = (f & 2u) ? ramp(k.ramp[2][ci], fy, bfx[2][ci]) : 0.0f;
    const float r45i = (f & 1u) ? ramp(k.ramp[3][ci], fy, bfx[3][ci]) : 0.0f;
    m[ci] = static_cast<double>(fmaxf(fmaxf(r30, r60), fmaxf(r45, r45i)));
  }
  float res1[3], res2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float a1 = __double2float_rn(__fma_rn(t.dx[i], m[0], t.dE[i]));  // mix(E, tx, m0)
    const float a2 = __double2float_rn(__fma_rn(t.dy[i], m[1], t.dE[i]));  // mix(E, ty, m1)
    res1[i] = mix_frac(a1, t.tz[i], m[2]);
    res2[i] = mix_frac(a2, t.tw[i], m[3]);
  }
  const float cdf1 = __fadd_rn(__fadd_rn(fabsf(__fsub_rn(t.E[0], res1[0])), fabsf(__fsub_rn(t.E[1], res1[1]))),
                               fabsf(__fsub_rn(t.E[2], res1[2])));
  const float cdf2 = __fadd_rn(__fadd_rn(fabsf(__fsub_rn(t.E[0], res2[0])), fabsf(__fsub_rn(t.E[1], res2[1]))),
                               fabsf(__fsub_rn(t.E[2], res2[2])));
  const float sel = cdf2 >= cdf1 ? 1.0f : 0.0f;
  return make_float4(mix_flag(res1[0], res2[0], sel), mix_flag(res1[1], res2[1], sel),
                     mix_flag(res1[2], res2[2], sel), 1.0f);
}

// Dynamic shared memory: the texel records of the tile, [rows][n].
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
xbr_epilogue_kernel(const float* __restrict__ S, const int* __restrict__ bx,
                    const float* __restrict__ fpx, const float* __restrict__ fpy,
                    const int* __restrict__ tile_lo, const int* __restrict__ tile_n,
                    const __grid_constant__ Constants k, float4* __restrict__ out, int OH, int W,
                    int OW, int rows) {
  extern __shared__ __align__(16) uint4 records[];

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y_begin = blockIdx.y * rows;
  const int ny = min(rows, OH - y_begin);
  const int b = blockIdx.z;
  const int lo = __ldg(tile_lo + blockIdx.x);
  const int n = __ldg(tile_n + blockIdx.x);  // 0: the tile reads S from global memory
  const size_t plane = static_cast<size_t>(OH) * W;
  const float* sb = S + static_cast<size_t>(b) * kChannels * plane;

  if (n > 0) {
    for (int i = threadIdx.x; i < ny * n; i += blockDim.x) {
      const int r = i / n;
      const int c = i - r * n;
      const Texel t = prepare(sb + static_cast<size_t>(y_begin + r) * W + lo + c, plane, k.inv255);
      const uint4* w = reinterpret_cast<const uint4*>(&t);
#pragma unroll
      for (int j = 0; j < kTexelWords; ++j) records[i * kTexelWords + j] = w[j];
    }
    __syncthreads();
  }
  if (x >= OW) return;

  const int col = __ldg(bx + x);
  const float fx = __ldg(fpx + x);
  float bfx[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int ci = 0; ci < 4; ++ci) bfx[q][ci] = __fmul_rn(k.ramp[q][ci][1], fx);
  }
  for (int r = 0; r < ny; ++r) {
    const int y = y_begin + r;
    Texel t;
    if (n > 0) {
      uint4* w = reinterpret_cast<uint4*>(&t);
      const int i = r * n + col - lo;
#pragma unroll
      for (int j = 0; j < kTexelWords; ++j) w[j] = records[i * kTexelWords + j];
    } else {
      t = prepare(sb + static_cast<size_t>(y) * W + col, plane, k.inv255);
    }
    out[(static_cast<size_t>(b) * OH + y) * OW + x] = finish(t, k, __ldg(fpy + y), bfx);
  }
}

}  // namespace

// S: f32 [B, 19, OH, W] contiguous; bx: int32 [OW] (source columns, in
// [0, W)); fpx: f32 [OW]; fpy: f32 [OH]; out: f32 [B, OH, OW, 4], 16-byte
// aligned. Output columns are cut into tiles of tile_px (a multiple of 32,
// at most 256: the block size); tile_lo and tile_n [ceil(OW / tile_px)]
// give the first source column and the count of source columns that bx maps
// the tile to, n = 0 for a tile that reads S from global memory. rows:
// output rows per block; rows x the largest n x 112 bytes of shared memory
// must fit. table: 65 floats on the HOST (the ramp table [4][4][4] and
// 1/255), passed to the kernel by value. Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int xbr_epilogue_launch(const float* S, const int* bx, const float* fpx, const float* fpy,
                                   const int* tile_lo, const int* tile_n, const float* table,
                                   float* out, int B, int OH, int W, int OW, int tile_px, int rows,
                                   int max_n, void* stream) {
  if (B < 1 || OH < 1 || OW < 1 || B > 65535 || rows < 1 || tile_px < 32 || tile_px > kMaxThreads ||
      (tile_px & 31) || max_n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int row_tiles = (OH + rows - 1) / rows;
  if (row_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = static_cast<size_t>(rows) * max_n * sizeof(Texel);
  if (shmem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(xbr_epilogue_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Constants k;
  for (int i = 0; i < 64; ++i) (&k.ramp[0][0][0])[i] = table[i];
  k.inv255 = table[64];
  const dim3 grid((OW + tile_px - 1) / tile_px, row_tiles, B);
  xbr_epilogue_kernel<<<grid, tile_px, shmem, static_cast<cudaStream_t>(stream)>>>(
      S, bx, fpx, fpy, tile_lo, tile_n, k, reinterpret_cast<float4*>(out), OH, W, OW, rows);
  return static_cast<int>(cudaGetLastError());
}
