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
// v1 and v2 differ only in the f32 weight table the host builds.
//
// What bounds it: instructions. Each output pixel costs G*25 (225 for
// crt-mattias) texel reads, a multiply and an add each, and 10 tap indices
// per group; the bytes (a 0.9 MB frame in, 25 MB of planes out at 1080p)
// take a tenth of that time. The first version (one thread per pixel,
// every tap and weight an L1 load at a stride of C floats, the index math
// redone per tap) ran at 4.5% of its bound.
//
// Design:
//  * A block owns a 64 x 16 tile of output pixels; each of its 256 threads
//    owns 4 pixels of one column (rows ty, ty+4, ty+8, ty+12).
//  * The group table (bx, by, xo, yo, W) sits in shared memory; a thread
//    holds one group's 25 weights in registers while it sums that group
//    for its 4 pixels, so no tap reloads a weight.
//  * The tile's source footprint is gathered once, coalesced, from global
//    memory into shared memory, one plane per channel, so every tap is a
//    stride-1 shared load. The footprint box comes from the tap index
//    functions, which are monotone in u (f32 add, multiply by W > 0, floor
//    and clamp all are): each group's columns span [col(umin), col(umax)]
//    over the tile, and rows likewise.
//  * A tile with a non-finite or huge coordinate (a tap coordinate beyond
//    +-2^21 texels), or whose box exceeds the shared budget (a wild warp),
//    sums from global memory in the same kernel, with the full index
//    semantics below. Each such tile adds one to the wide-tile counter.
//  * Tap indices are computed once per group row and column.
//
// Numerics: tap coordinates are __fadd_rn/__fmul_rn in the evaluator's
// order and the sum is acc = __fadd_rn(acc, __fmul_rn(w, t)) in group
// order, j then i, so nvcc contracts nothing and the plain torch version
// (same loop, same order) is bit-equal. floor -> int follows the port's
// ifloor32 (NaN/+-inf -> INT32_MIN, finite values saturate), then the
// clamp to the texture. On the shared path every tap coordinate lies
// within +-2^21, where tap_near (one saturating floor conversion) gives
// the same index.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 64;
constexpr int kTileH = 16;
constexpr int kRows = 4;                      // output pixels per thread
constexpr int kThreads = kTileW * kTileH / kRows;  // 256
constexpr int kMaxSlots = 4;                  // output channels
constexpr int kParams = 37;                   // bx, by, xo[5], yo[5], W[25]
constexpr int kBudget = 6144;                 // footprint floats in shared memory

__device__ __forceinline__ int ifloor32(float x) {
  const float f = floorf(x);
  if (!isfinite(f)) return INT32_MIN;
  if (f >= 2147483647.0f) return INT32_MAX;
  if (f <= -2147483648.0f) return INT32_MIN;
  return static_cast<int>(f);
}

// The tap index with the reference's full semantics (any coordinate).
__device__ __forceinline__ int tap(float base, float off, float n, int hi) {
  return min(max(ifloor32(__fmul_rn(__fadd_rn(base, off), n)), 0), hi);
}

// The tap coordinate ((base + off) * n).
__device__ __forceinline__ float coord(float base, float off, float n) {
  return __fmul_rn(__fadd_rn(base, off), n);
}

// clamp(floor(x), 0, hi) for a finite x far from the int range's ends
// (|x| < kNear): __float2int_rd floors exactly there.
constexpr float kNear = 2097152.0f;  // 2^21

__device__ __forceinline__ int tap_near(float x, int hi) {
  return min(max(__float2int_rd(x), 0), hi);
}

__device__ __forceinline__ float warp_min(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_imin(int x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_imax(int x) {
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// An output slot's running sum, selected and stored back by value so that
// the sums stay in registers.
__device__ __forceinline__ float slot_get(const float (&acc)[kMaxSlots], int slot) {
  return slot == 0 ? acc[0] : slot == 1 ? acc[1] : slot == 2 ? acc[2] : acc[3];
}

__device__ __forceinline__ void slot_put(float (&acc)[kMaxSlots], int slot, float a) {
  if (slot == 0) acc[0] = a;
  if (slot == 1) acc[1] = a;
  if (slot == 2) acc[2] = a;
  if (slot == 3) acc[3] = a;
}

// Dynamic shared memory: the group table [G][37] f32, the (channel, slot)
// table [G][2] i32, then the footprint planes [C][bh][bw] f32.
__global__ void __launch_bounds__(kThreads, 3)
blur_groups_kernel(const float* __restrict__ tex, const float* __restrict__ u,
                   const float* __restrict__ v, const float* __restrict__ params,
                   const int* __restrict__ chan, float* __restrict__ out,
                   int* __restrict__ wide_tiles, int H, int W, int C, int HO, int WO,
                   int B, int G, int S) {
  extern __shared__ float smem[];
  float* sprm = smem;
  int* schan = reinterpret_cast<int*>(smem + G * kParams);
  float* stex = smem + G * kParams + 2 * G;
  __shared__ float red[4][kThreads / 32];
  __shared__ int sbad[kThreads / 32];
  __shared__ int box[4];  // x0, y0, bw, bh; bw == 0 means wide

  const int b = blockIdx.z;
  const int tx = threadIdx.x % kTileW;
  const int ty = threadIdx.x / kTileW;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int ox = blockIdx.x * kTileW + tx;
  const int oy0 = blockIdx.y * kTileH + ty;
  const float fw = static_cast<float>(W);
  const float fh = static_cast<float>(H);

  for (int i = threadIdx.x; i < G * kParams; i += kThreads) sprm[i] = __ldg(params + i);
  for (int i = threadIdx.x; i < 2 * G; i += kThreads) schan[i] = __ldg(chan + i);

  // This thread's pixels, and the tile's coordinate range.
  float uu[kRows], vv[kRows];
  bool in[kRows];
  float umin = INFINITY, umax = -INFINITY, vmin = INFINITY, vmax = -INFINITY;
  int bad = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int oy = oy0 + r * (kTileH / kRows);
    in[r] = ox < WO && oy < HO;
    uu[r] = 0.0f;
    vv[r] = 0.0f;
    if (in[r]) {
      const int p = oy * WO + ox;
      uu[r] = __ldg(u + p);
      vv[r] = __ldg(v + p);
      bad |= isnan(uu[r]) || isnan(vv[r]);  // the min and max below drop NaN
      umin = fminf(umin, uu[r]);
      umax = fmaxf(umax, uu[r]);
      vmin = fminf(vmin, vv[r]);
      vmax = fmaxf(vmax, vv[r]);
    }
  }
  umin = warp_min(umin);
  umax = warp_max(umax);
  vmin = warp_min(vmin);
  vmax = warp_max(vmax);
  bad = __any_sync(0xffffffffu, bad);
  if (lane == 0) {
    red[0][warp] = umin;
    red[1][warp] = umax;
    red[2][warp] = vmin;
    red[3][warp] = vmax;
    sbad[warp] = bad;
  }
  __syncthreads();

  // Warp 0: the footprint box, lane g taking group g.
  if (warp == 0) {
    float a0 = INFINITY, a1 = -INFINITY, c0 = INFINITY, c1 = -INFINITY;
    int any_bad = 0;
    for (int k = 0; k < kThreads / 32; ++k) {
      a0 = fminf(a0, red[0][k]);
      a1 = fmaxf(a1, red[1][k]);
      c0 = fminf(c0, red[2][k]);
      c1 = fmaxf(c1, red[3][k]);
      any_bad |= sbad[k];
    }
    int x0 = INT32_MAX, x1 = INT32_MIN, y0 = INT32_MAX, y1 = INT32_MIN;
    if (!any_bad) {
      for (int g = lane; g < G; g += 32) {
        const float* prm = sprm + g * kParams;
        const float ulo = __fadd_rn(a0, prm[0]), uhi = __fadd_rn(a1, prm[0]);
        const float vlo = __fadd_rn(c0, prm[1]), vhi = __fadd_rn(c1, prm[1]);
        for (int i = 0; i < 5; ++i) {
          const float xl = coord(ulo, prm[2 + i], fw), xh = coord(uhi, prm[2 + i], fw);
          const float yl = coord(vlo, prm[7 + i], fh), yh = coord(vhi, prm[7 + i], fh);
          // Every coordinate of the tile lies between these two.
          any_bad |= !(fabsf(xl) < kNear && fabsf(xh) < kNear && fabsf(yl) < kNear && fabsf(yh) < kNear);
          x0 = min(x0, tap_near(xl, W - 1));
          x1 = max(x1, tap_near(xh, W - 1));
          y0 = min(y0, tap_near(yl, H - 1));
          y1 = max(y1, tap_near(yh, H - 1));
        }
      }
      any_bad = __any_sync(0xffffffffu, any_bad);
      x0 = warp_imin(x0);
      x1 = warp_imax(x1);
      y0 = warp_imin(y0);
      y1 = warp_imax(y1);
    }
    if (lane == 0) {
      const long long area = any_bad ? 0LL : static_cast<long long>(x1 - x0 + 1) * (y1 - y0 + 1) * C;
      const bool fits = !any_bad && area <= kBudget;
      box[0] = x0;
      box[1] = y0;
      box[2] = fits ? x1 - x0 + 1 : 0;
      box[3] = fits ? y1 - y0 + 1 : 0;
      if (!fits && wide_tiles != nullptr) atomicAdd(wide_tiles, 1);
    }
  }
  __syncthreads();

  const int bx0 = box[0], by0 = box[1], bw = box[2], bh = box[3];
  const float* src = tex + static_cast<size_t>(b) * H * W * C;
  float acc[kRows][kMaxSlots];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s) acc[r][s] = 0.0f;

  if (bw > 0) {
    // Gather the footprint: each box row is bw*C contiguous floats of the
    // texture, split into the channel planes.
    const int plane = bw * bh;
    const int rowlen = bw * C;
    for (int e = threadIdx.x; e < rowlen * bh; e += kThreads) {
      const int r = e / rowlen;
      const int q = e - r * rowlen;
      const int c = q / C;
      const int ch = q - c * C;
      stex[ch * plane + r * bw + c] =
          __ldg(src + (static_cast<size_t>(by0 + r) * W + bx0) * C + q);
    }
    __syncthreads();
    for (int g = 0; g < G; ++g) {
      const float* prm = sprm + g * kParams;
      const int slot = schan[2 * g + 1];
      const float* pl = stex + schan[2 * g] * plane;
      float wt[25];
#pragma unroll
      for (int k = 0; k < 25; ++k) wt[k] = prm[12 + k];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (!in[r]) continue;
        const float ug = __fadd_rn(uu[r], prm[0]);
        const float vg = __fadd_rn(vv[r], prm[1]);
        int col[5];
#pragma unroll
        for (int i = 0; i < 5; ++i) col[i] = tap_near(coord(ug, prm[2 + i], fw), W - 1) - bx0;
        float a = slot_get(acc[r], slot);
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          const float* row = pl + (tap_near(coord(vg, prm[7 + j], fh), H - 1) - by0) * bw;
#pragma unroll
          for (int i = 0; i < 5; ++i) a = __fadd_rn(a, __fmul_rn(wt[5 * j + i], row[col[i]]));
        }
        slot_put(acc[r], slot, a);
      }
    }
  } else {
    // Wide tile: the same sums, each texel from global memory.
    for (int g = 0; g < G; ++g) {
      const float* prm = sprm + g * kParams;
      const int ch = schan[2 * g];
      const int slot = schan[2 * g + 1];
      float wt[25];
#pragma unroll
      for (int k = 0; k < 25; ++k) wt[k] = prm[12 + k];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (!in[r]) continue;
        const float ug = __fadd_rn(uu[r], prm[0]);
        const float vg = __fadd_rn(vv[r], prm[1]);
        int col[5];
#pragma unroll
        for (int i = 0; i < 5; ++i) col[i] = tap(ug, prm[2 + i], fw, W - 1) * C + ch;
        float a = slot_get(acc[r], slot);
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          const float* row = src + static_cast<size_t>(tap(vg, prm[7 + j], fh, H - 1)) * W * C;
#pragma unroll
          for (int i = 0; i < 5; ++i) a = __fadd_rn(a, __fmul_rn(wt[5 * j + i], __ldg(row + col[i])));
        }
        slot_put(acc[r], slot, a);
      }
    }
  }

  const size_t P = static_cast<size_t>(HO) * WO;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (!in[r]) continue;
    const size_t p = static_cast<size_t>(oy0 + r * (kTileH / kRows)) * WO + ox;
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s) {
      if (s < S) out[(static_cast<size_t>(s) * B + b) * P + p] = acc[r][s];
    }
  }
}

}  // namespace

// tex: f32 [B, H, W, C] contiguous (C <= 4); u, v: f32 [HO, WO] (shared by
// the batch); params: f32 [G, 37] (bx, by, xo[5], yo[5], W[5][5]); chan:
// int32 [G, 2] (texture channel, output slot); out: f32 [S, B, HO, WO];
// wide_tiles: int32 counter that each tile summed from global memory adds
// one to (may be null). Launches on `stream`; returns cudaGetLastError().
extern "C" int blur_groups_launch(const float* tex, const float* u, const float* v,
                                  const float* params, const int* chan, float* out,
                                  int* wide_tiles, int B, int H, int W, int C, int HO, int WO,
                                  int G, int S, void* stream) {
  if (S < 1 || S > kMaxSlots || C < 1 || C > 4 || G < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shmem = (static_cast<size_t>(G) * (kParams + 2) + kBudget) * sizeof(float);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blur_groups_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(kThreads);
  const dim3 grid((WO + kTileW - 1) / kTileW, (HO + kTileH - 1) / kTileH, B);
  blur_groups_kernel<<<grid, block, shmem, static_cast<cudaStream_t>(stream)>>>(
      tex, u, v, params, chan, out, wide_tiles, H, W, C, HO, WO, B, G, S);
  return static_cast<int>(cudaGetLastError());
}
