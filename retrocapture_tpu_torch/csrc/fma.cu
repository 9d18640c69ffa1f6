// The operator rctpu::fma for Hopper (sm_90a): a*b + c over f32 operands
// that broadcast against each other, one f32 result an element, in one of
// two roundings:
//
//   mode 0, policy.fma32: the f64 sum narrowed once (numerics.cuh), how
//     the port models XLA-CPU's contracted multiply-add in a jitted fusion;
//   mode 1, policy.fmaf32: __fmaf_rn, a true fused multiply-add.
//
// Replaces no TPU kernel: the reference's jitted fusions contract these
// multiply-adds inline. Eager torch computes policy.fma32 as up to three
// f64 casts, an f64 multiply, an f64 add and a narrowing, each a pass over
// the broadcast shape (fmaf32 as about five times that); this kernel reads
// each operand once and writes the result once.
//
// Operands. Each of a, b, c is a value the host passes (a Python scalar,
// already rounded to f32), one f32 in device memory read when the kernel
// runs (a 0-d tensor: a traced parameter or FrameCount, so that a CUDA
// graph's replay reads the value of its time), or a tensor read through
// its strides (0 along a broadcast dimension: an expanded view is never
// materialised). The host (ops/cuda/fma.py) merges the result's
// dimensions, picks one of three paths and names each operand's kind; it
// caches that plan by the operands' shapes and strides. Alignment is
// checked here, at every launch.
//
// What bounds it: bytes. An element reads at most 12 bytes and writes 4;
// fma32's three widenings and one narrowing issue 16 a clock per SM, a
// quarter of the f64 rate, which at 132 SMs keeps up with the memory rate.
// The paths:
//
// * dense: every tensor operand laid out as the result. A block per 512
//   float4s, each thread 2 float4s an operand in flight before the
//   arithmetic; an operand that is the same view as another is read once.
// * tile: the result as [B, R, Q, C] (a batch of rows, pixels, C <= 4
//   channels; a flat or narrow result is folded into rows of 32 pixels by
//   the host; B is 1 but for a stream or frame batch in front), one
//   block of 32 x 8 threads a tile of 32 pixels by 16 rows, a thread one
//   pixel of 2 rows. The tile comes from the block index by one multiply-high
//   division, the batch item from the grid row, the pixel from the
//   thread index. Per operand: a row's value
//   (one per row), a column's (the pixel's C values, read once a thread
//   into registers: a channel vector [4], a column weight [1, W, 1]), a
//   line (the pixel's C values at r * sr + q * C: 16-byte accesses for
//   C = 4), a transposed operand (r * C + q * sq: staged through a padded
//   shared-memory tile so that its reads run along its own contiguous
//   axis and the result's writes along the result's; two at most), or a
//   gather (any other strides).
// * general: anything else (more than 4 merged dimensions, more than 4
//   channels innermost, three transposed operands, offsets past 2^31): one
//   thread an element, its offsets from
//   the element's index by a multiply-and-shift division per dimension,
//   grid-stride. The host counts these launches (general_launches()).

#include "numerics.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kMaxDims = 8;
constexpr int kUnroll = 2;  // float4s of an operand a dense-path thread holds in flight
// The tile path's block: 32 pixels (one a lane) by kTileRows rows, a
// thread every kTileWarps-th row. Tiles run in row-major order.
constexpr int kTilePx = 32;
constexpr int kTileRows = 16;
constexpr int kTileWarps = 8;
constexpr int kMaxBatch = 65535;  // gridDim.y: one batch item a grid row
constexpr int kMaxTiles = 2;  // transposed operands of one launch
static_assert(kTileRows % kTileWarps == 0 && kTilePx % kTileWarps == 0,
              "a tile's rows and pixels split evenly over its warps");

// Loads of operands read once, and the result's stores. The loads keep
// the default caching: streaming loads (__ldcs) took up to 13% longer on
// the main paths' forms. The stores stream (__stcs): 12-15% less time
// where the writes are most of the bytes, the same elsewhere
// (tools/torch_fma_kernel_variants.py).
__device__ __forceinline__ float ld_once(const float* p) { return *p; }
__device__ __forceinline__ float4 ld_once(const float4* p) { return *p; }
__device__ __forceinline__ void st_once(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void st_once(float4* p, float4 v) { __stcs(p, v); }

enum Mode { kFma32 = 0, kFmaf = 1 };
enum Path { kPathDense = 0, kPathTile = 1, kPathGeneral = 2 };
// ops/cuda/fma.py's operand kinds. Every path: kValue, kScalar. Dense:
// kDense. General: kStrided. Tile: kRow, kCol, kLine, kGather, kTile.
enum Kind { kValue = 0, kScalar = 1, kDense = 2, kStrided = 3, kRow = 4, kCol = 5, kLine = 6, kGather = 7, kTile = 8 };

template <int MODE>
__device__ __forceinline__ float fma_op(float a, float b, float c) {
  return MODE == kFma32 ? fma32(a, b, c) : __fmaf_rn(a, b, c);
}

template <int MODE>
__device__ __forceinline__ float4 fma_op4(float4 a, float4 b, float4 c) {
  return make_float4(fma_op<MODE>(a.x, b.x, c.x), fma_op<MODE>(a.y, b.y, c.y), fma_op<MODE>(a.z, b.z, c.z),
                     fma_op<MODE>(a.w, b.w, c.w));
}

__device__ __forceinline__ float4 splat(float v) { return make_float4(v, v, v, v); }

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// n / d for n < 2^31 as a multiply-high, an add and a shift (d >= 1).
struct Divider {
  unsigned int d, m, s;
};

Divider make_divider(unsigned int d) {
  unsigned int s = 0;
  while (s < 32 && (1ull << s) < d) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {d, static_cast<unsigned int>(m), s};
}

__device__ __forceinline__ unsigned int quotient(const Divider& v, unsigned int n) {
  return (__umulhi(n, v.m) + n) >> v.s;
}

// ---- the dense path --------------------------------------------------------

struct DenseArgs {
  const float* p[3];
  float v[3];
  int kind[3];  // kValue, kScalar or kDense
  int b_is_a, c_is_a, c_is_b;  // one view read once
};

__device__ __forceinline__ float scalar_value(const float* p, float v, int kind) {
  return kind == kScalar ? __ldg(p) : v;
}

template <int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads) fma_dense_kernel(const DenseArgs args, float* __restrict__ out, int n) {
  const float s0 = scalar_value(args.p[0], args.v[0], args.kind[0]);
  const float s1 = scalar_value(args.p[1], args.v[1], args.kind[1]);
  const float s2 = scalar_value(args.p[2], args.v[2], args.kind[2]);
  const bool d0 = args.kind[0] == kDense, d1 = args.kind[1] == kDense, d2 = args.kind[2] == kDense;
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  int done = 0;
  if (VEC) {
    const int n4 = n >> 2;
    const float4* a4 = reinterpret_cast<const float4*>(args.p[0]);
    const float4* b4 = reinterpret_cast<const float4*>(args.p[1]);
    const float4* c4 = reinterpret_cast<const float4*>(args.p[2]);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int j0 = first; j0 < n4; j0 += kUnroll * stride) {
      float4 a[kUnroll], b[kUnroll], c[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * stride;
        if (j < n4) {
          a[u] = d0 ? ld_once(a4 + j) : splat(s0);
          b[u] = d1 ? (args.b_is_a ? a[u] : ld_once(b4 + j)) : splat(s1);
          c[u] = d2 ? (args.c_is_a ? a[u] : args.c_is_b ? b[u] : ld_once(c4 + j)) : splat(s2);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * stride;
        if (j < n4) st_once(o4 + j, fma_op4<MODE>(a[u], b[u], c[u]));
      }
    }
    done = n4 << 2;
  }
  const float* pa = args.p[0];
  const float* pb = args.p[1];
  const float* pc = args.p[2];
  for (int j0 = done + first; j0 < n; j0 += kUnroll * stride) {
    float a[kUnroll], b[kUnroll], c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * stride;
      if (j < n) {
        a[u] = d0 ? ld_once(pa + j) : s0;
        b[u] = d1 ? (args.b_is_a ? a[u] : ld_once(pb + j)) : s1;
        c[u] = d2 ? (args.c_is_a ? a[u] : args.c_is_b ? b[u] : ld_once(pc + j)) : s2;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * stride;
      if (j < n) st_once(out + j, fma_op<MODE>(a[u], b[u], c[u]));
    }
  }
}

template <int MODE, bool VEC>
void launch_dense(const DenseArgs& args, float* out, int n, cudaStream_t s) {
  const long long units = VEC ? (n >> 2) + (n & 3) : n;  // float4s (and the tail) or floats
  // A block per kUnroll x 256 float4s: a grid of the blocks that fit on
  // the card at once (the occupancy query), grid-stride, took 5-9% longer
  // (tools/torch_fma_kernel_variants.py).
  const long long want = (units + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const int blocks = static_cast<int>(want > 0 ? want : 1);
  fma_dense_kernel<MODE, VEC><<<blocks, kThreads, 0, s>>>(args, out, n);
}

// ---- the tile path ---------------------------------------------------------

struct TileOperand {
  const float* p;
  float v;
  int kind;
  int vec;  // kLine: 16-byte loads of a pixel (every pixel's first channel 16-byte aligned)
  int slot;  // kTile: its staged tile, 0 or 1
  unsigned sb, sr, sq, sc;  // element strides along the batch, rows, pixels and channels
};

struct TileArgs {
  TileOperand op[3];
  unsigned rows, px, n;  // R, Q and one batch item's elements (a folded result's last row may be partial)
  Divider px_tiles;  // tiles along Q
  // The transposed operands (kTile), each staged through shared memory
  // (two operands that are one view share a tile): `tiles` of them.
  int tiles;
  const float* tile_p[kMaxTiles];
  unsigned tile_sb[kMaxTiles], tile_sq[kMaxTiles];
  int tile_vec[kMaxTiles];  // its pixels' runs start 16-byte aligned in every batch item
  int vec_out;
};

// A staged pixel's row in shared memory: its kTileRows rows x C channels,
// padded. C = 4 keeps 16-byte stores and loads: at a pitch of 4
// floats past a multiple of 32 the 8 lanes of each 16-byte phase fall in
// distinct bank quads. Other C take 4-byte accesses at an odd pitch: lane
// q reads bank q + const.
template <int C>
struct Stage {
  static constexpr int kPitch = C == 4 ? kTileRows * 4 + 4 : kTileRows * C + 1;
};

// The transposed operand's pixels q0.. of batch item z's tile at rows r0.. into
// `stage`: warp w takes pixels w, w + kTileWarps, ..., each a run of
// (up to) kTileRows * C contiguous floats along the operand's own axis.
// Every load
// of the warp's runs is issued before the first store into shared memory.
template <int C>
__device__ __forceinline__ void stage_tile(const TileArgs& args, int slot, float* stage, unsigned z, unsigned q0,
                                           unsigned r0) {
  const float* tile_p = args.tile_p[slot];
  const unsigned tile_sb = args.tile_sb[slot], tile_sq = args.tile_sq[slot];
  constexpr int kRows = kTileRows;
  constexpr int P = Stage<C>::kPitch;
  constexpr int kPer = kTilePx / kTileWarps;  // pixels a warp stages
  constexpr int kVec = kRows * C / 4;  // float4s of a full run
  constexpr int kLanes4 = (kVec + 31) / 32;  // ... a lane
  constexpr int kLanes1 = (kRows * C + 31) / 32;  // floats of a run a lane
  const unsigned left = args.rows - r0;
  const int nf = static_cast<int>(left < kRows ? left : kRows) * C;
  const int lane = threadIdx.x;
  if (args.tile_vec[slot] && nf == kRows * C) {
    float4 v[kPer][kLanes4];
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const unsigned q = q0 + threadIdx.y + m * kTileWarps;
      const float4* src = reinterpret_cast<const float4*>(tile_p + z * tile_sb + q * tile_sq + r0 * C);
#pragma unroll
      for (int i = 0; i < kLanes4; ++i) {
        const int f = lane + 32 * i;
        if (q < args.px && f < kVec) v[m][i] = ld_once(src + f);
      }
    }
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int qq = threadIdx.y + m * kTileWarps;
      float* dst = stage + qq * P;
#pragma unroll
      for (int i = 0; i < kLanes4; ++i) {
        const int f = lane + 32 * i;
        if (q0 + qq < args.px && f < kVec) {
          if (C == 4) {
            reinterpret_cast<float4*>(dst)[f] = v[m][i];
          } else {
            dst[4 * f] = v[m][i].x;
            dst[4 * f + 1] = v[m][i].y;
            dst[4 * f + 2] = v[m][i].z;
            dst[4 * f + 3] = v[m][i].w;
          }
        }
      }
    }
  } else {
    float v[kPer][kLanes1];
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const unsigned q = q0 + threadIdx.y + m * kTileWarps;
      const float* src = tile_p + z * tile_sb + q * tile_sq + r0 * C;
#pragma unroll
      for (int i = 0; i < kLanes1; ++i) {
        const int f = lane + 32 * i;
        if (q < args.px && f < nf) v[m][i] = ld_once(src + f);
      }
    }
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int qq = threadIdx.y + m * kTileWarps;
#pragma unroll
      for (int i = 0; i < kLanes1; ++i) {
        const int f = lane + 32 * i;
        if (q0 + qq < args.px && f < nf) stage[qq * P + f] = v[m][i];
      }
    }
  }
}

// One operand's C values at pixel (r, q) of batch item z (`valid` of them
// in the result; 0: none), from `fixed` (host values, device scalars,
// column operands) or memory; a transposed operand's come from the staged
// tile afterwards.
template <int C>
__device__ __forceinline__ void load_pixel(const TileOperand& o, unsigned z, unsigned r, unsigned q, int valid,
                                           const float (&fixed)[C], float (&x)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = fixed[c];
  if (valid == 0) return;
  if (o.kind == kRow) {
    const float v = __ldg(o.p + z * o.sb + r * o.sr);
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = v;
  } else if (o.kind == kLine) {
    const float* p = o.p + z * o.sb + r * o.sr + q * C;
    if (C == 4 && o.vec && valid == 4) {
      const float4 v = ld_once(reinterpret_cast<const float4*>(p));
      x[0] = v.x;
      x[1 % C] = v.y;
      x[2 % C] = v.z;
      x[3 % C] = v.w;
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < valid) x[c] = ld_once(p + c);
      }
    }
  } else if (o.kind == kGather) {
    const float* p = o.p + z * o.sb + r * o.sr + q * o.sq;
    if (o.sc == 0) {
      const float v = __ldg(p);
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = v;
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < valid) x[c] = __ldg(p + c * o.sc);
      }
    }
  }
}

// A transposed operand's C values at tile row `srow` of this thread's pixel.
template <int C>
__device__ __forceinline__ void tile_pixel(const float* stage, int srow, float (&x)[C]) {
  const float* s = stage + threadIdx.x * Stage<C>::kPitch + srow * C;
  if (C == 4) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    x[0] = v.x;
    x[1 % C] = v.y;
    x[2 % C] = v.z;
    x[3 % C] = v.w;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = s[c];
  }
}

// TILES: the staged (transposed) operands, 0 to kMaxTiles, fixed at
// compile time so that the other operands' loads stay ahead of the staging.
template <int MODE, int C, int TILES>
__global__ void __launch_bounds__(kTilePx * kTileWarps) fma_tile_kernel(const TileArgs args, float* __restrict__ out) {
  constexpr int kRowsPerThread = kTileRows / kTileWarps;
  constexpr int kStage = kTilePx * Stage<C>::kPitch;  // floats of one staged tile
  __shared__ __align__(16) float stage[TILES ? TILES * kStage : 4];
  // This block's tile, from its index by one multiply-high division, and
  // its batch item.
  const unsigned z = blockIdx.y;
  const unsigned by = quotient(args.px_tiles, blockIdx.x);
  const unsigned q0 = (blockIdx.x - by * args.px_tiles.d) * kTilePx, r0 = by * kTileRows;
  const unsigned q = q0 + threadIdx.x;
  const bool q_ok = q < args.px;
  // What a thread reads once: host values, device scalars and a column
  // operand's C values at its pixel (the same in every row).
  float fixed[3][C];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const TileOperand& o = args.op[k];
    const float s = o.kind == kScalar ? __ldg(o.p) : o.v;
#pragma unroll
    for (int c = 0; c < C; ++c) fixed[k][c] = s;
    if (o.kind == kCol && q_ok) {
#pragma unroll
      for (int c = 0; c < C; ++c) fixed[k][c] = __ldg(o.p + z * o.sb + q * o.sq + c * o.sc);
    }
  }
  // Every load of the tile is issued before the first use: the operands'
  // rows, then the transposed operand's staging.
  float x[3][kRowsPerThread][C];
  int valid[kRowsPerThread];
#pragma unroll
  for (int u = 0; u < kRowsPerThread; ++u) {
    const unsigned r = r0 + threadIdx.y + u * kTileWarps;
    valid[u] = 0;
    if (q_ok && r < args.rows) {
      const unsigned e = (r * args.px + q) * C;
      const unsigned left = args.n > e ? args.n - e : 0;
      valid[u] = left < C ? static_cast<int>(left) : C;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) load_pixel<C>(args.op[k], z, r, q, valid[u], fixed[k], x[k][u]);
  }
  if (TILES) {
#pragma unroll
    for (int t = 0; t < TILES; ++t) stage_tile<C>(args, t, stage + t * kStage, z, q0, r0);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (args.op[k].kind == kTile && valid[u] > 0) {
          const int slot = TILES == 1 ? 0 : args.op[k].slot;
          tile_pixel<C>(stage + slot * kStage, threadIdx.y + u * kTileWarps, x[k][u]);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kRowsPerThread; ++u) {
    if (valid[u] == 0) continue;
    const unsigned r = r0 + threadIdx.y + u * kTileWarps;
    float* o = out + z * args.n + (r * args.px + q) * C;
    float y[C];
#pragma unroll
    for (int c = 0; c < C; ++c) y[c] = fma_op<MODE>(x[0][u][c], x[1][u][c], x[2][u][c]);
    if (C == 4 && args.vec_out && valid[u] == 4) {
      st_once(reinterpret_cast<float4*>(o), make_float4(y[0], y[1 % C], y[2 % C], y[3 % C]));
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < valid[u]) st_once(o + c, y[c]);
      }
    }
  }
}

template <int MODE, int C>
void launch_tile(TileArgs args, unsigned batch, float* out, cudaStream_t s) {
  const unsigned px_tiles = (args.px + kTilePx - 1) / kTilePx;
  args.px_tiles = make_divider(px_tiles);
  const unsigned blocks = px_tiles * ((args.rows + kTileRows - 1) / kTileRows);
  const dim3 grid(blocks, batch), block(kTilePx, kTileWarps);
  if (args.tiles == 2) {
    fma_tile_kernel<MODE, C, 2><<<grid, block, 0, s>>>(args, out);
  } else if (args.tiles == 1) {
    fma_tile_kernel<MODE, C, 1><<<grid, block, 0, s>>>(args, out);
  } else {
    fma_tile_kernel<MODE, C, 0><<<grid, block, 0, s>>>(args, out);
  }
}

template <int MODE>
void launch_tile_c(const TileArgs& args, unsigned batch, float* out, int C, cudaStream_t s) {
  switch (C) {
    case 1: launch_tile<MODE, 1>(args, batch, out, s); break;
    case 2: launch_tile<MODE, 2>(args, batch, out, s); break;
    case 3: launch_tile<MODE, 3>(args, batch, out, s); break;
    default: launch_tile<MODE, 4>(args, batch, out, s); break;
  }
}

// ---- the general path --------------------------------------------------------

struct Operand {
  const float* p;
  float v;
  int kind;
  long long stride[kMaxDims];
};

struct Args {
  Operand op[3];
  int ndim;
  long long size[kMaxDims];  // the result's dimensions, outermost first
  Divider div[kMaxDims];
};

__device__ __forceinline__ float scalar_of(const Operand& o) { return o.kind == kScalar ? __ldg(o.p) : o.v; }

template <int MODE>
__global__ void __launch_bounds__(kThreads) fma_strided_kernel(const Args args, float* __restrict__ out,
                                                               unsigned int n) {
  const float s0 = scalar_of(args.op[0]), s1 = scalar_of(args.op[1]), s2 = scalar_of(args.op[2]);
  const unsigned int stride = gridDim.x * kThreads;
  for (unsigned int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    long long o0 = 0, o1 = 0, o2 = 0;
    unsigned int rem = i;
#pragma unroll
    for (int d = kMaxDims - 1; d >= 0; --d) {
      if (d < args.ndim) {
        const unsigned int q = quotient(args.div[d], rem);
        const long long coord = static_cast<long long>(rem - q * args.div[d].d);
        rem = q;
        o0 += coord * args.op[0].stride[d];
        o1 += coord * args.op[1].stride[d];
        o2 += coord * args.op[2].stride[d];
      }
    }
    const float a = args.op[0].kind >= kDense ? args.op[0].p[o0] : s0;
    const float b = args.op[1].kind >= kDense ? args.op[1].p[o1] : s1;
    const float c = args.op[2].kind >= kDense ? args.op[2].p[o2] : s2;
    out[i] = fma_op<MODE>(a, b, c);
  }
}

int blocks_for(long long units) {
  const long long b = units / kThreads + 1;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

// False for a tile launch with more transposed operands than kMaxTiles.
template <int MODE>
bool launch(int path, const float* const ptrs[3], const float vals[3], float* out, int n, int ndim,
            const long long* size, const long long* kinds, const long long* strides, cudaStream_t s) {
  if (path == kPathDense) {
    DenseArgs args = {};
    bool vec = aligned16(out);
    for (int k = 0; k < 3; ++k) {
      args.p[k] = ptrs[k];
      args.v[k] = vals[k];
      args.kind[k] = static_cast<int>(kinds[k]);
      if (args.kind[k] == kDense) vec = vec && aligned16(ptrs[k]);
    }
    args.b_is_a = args.kind[0] == kDense && args.kind[1] == kDense && ptrs[1] == ptrs[0];
    args.c_is_a = args.kind[0] == kDense && args.kind[2] == kDense && ptrs[2] == ptrs[0];
    args.c_is_b = args.kind[1] == kDense && args.kind[2] == kDense && ptrs[2] == ptrs[1];
    if (vec) {
      launch_dense<MODE, true>(args, out, n, s);
    } else {
      launch_dense<MODE, false>(args, out, n, s);
    }
  } else if (path == kPathTile) {
    TileArgs args = {};
    const unsigned batch = static_cast<unsigned>(size[0]);
    const int C = static_cast<int>(size[3]);
    args.rows = static_cast<unsigned>(size[1]);
    args.px = static_cast<unsigned>(size[2]);
    args.n = static_cast<unsigned>(n / batch);
    args.vec_out = aligned16(out);
    for (int k = 0; k < 3; ++k) {
      TileOperand& o = args.op[k];
      o.p = ptrs[k];
      o.v = vals[k];
      o.kind = static_cast<int>(kinds[k]);
      o.sb = static_cast<unsigned>(strides[4 * k]);
      o.sr = static_cast<unsigned>(strides[4 * k + 1]);
      o.sq = static_cast<unsigned>(strides[4 * k + 2]);
      o.sc = static_cast<unsigned>(strides[4 * k + 3]);
      o.vec = C == 4 && aligned16(o.p) && o.sr % 4 == 0 && o.sb % 4 == 0;
      if (o.kind == kTile) {
        int t = 0;
        while (t < args.tiles && !(args.tile_p[t] == o.p && args.tile_sb[t] == o.sb && args.tile_sq[t] == o.sq)) ++t;
        if (t == kMaxTiles) return false;
        if (t == args.tiles) {
          args.tile_p[t] = o.p;
          args.tile_sb[t] = o.sb;
          args.tile_sq[t] = o.sq;
          args.tile_vec[t] = aligned16(o.p) && o.sq % 4 == 0 && o.sb % 4 == 0;
          ++args.tiles;
        }
        o.slot = t;
      }
    }
    launch_tile_c<MODE>(args, batch, out, C, s);
  } else {
    Args args = {};
    args.ndim = ndim;
    for (int d = 0; d < ndim; ++d) {
      args.size[d] = size[d];
      args.div[d] = make_divider(static_cast<unsigned int>(size[d]));
    }
    for (int k = 0; k < 3; ++k) {
      Operand& o = args.op[k];
      o.p = ptrs[k];
      o.v = vals[k];
      o.kind = static_cast<int>(kinds[k]);
      for (int d = 0; d < ndim; ++d) o.stride[d] = strides[ndim * k + d];
    }
    fma_strided_kernel<MODE><<<blocks_for(n), kThreads, 0, s>>>(args, out, static_cast<unsigned int>(n));
  }
  return true;
}

}  // namespace

// a, b, c: f32 device pointers, or null for the value va / vb / vc. out:
// f32, contiguous, of the broadcast shape, not aliasing an operand. path:
// 0 dense, 1 tile, 2 general (ops/cuda/fma.py's plan). geometry: n (the
// result's elements, fewer than 2^31), ndim, the ndim sizes (dense: [n];
// tile: [B, R, Q, C]; general: the merged dimensions, outermost first, at
// most 8), the kinds of a, b and c, then the element strides of a, b and c
// over those dimensions (ndim each; 0 where the operand is broadcast).
// mode: 0 fma32, 1 fmaf32. Launches on `stream`; returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a bad
// mode, path, ndim or size, or a tile launch of three distinct transposed
// operands.
extern "C" int fma_launch(const float* a, const float* b, const float* c, float va, float vb, float vc, float* out,
                          int path, const long long* geometry, int mode, void* stream) {
  const long long n = geometry[0];
  const int ndim = static_cast<int>(geometry[1]);
  if (ndim < 0 || ndim > kMaxDims || (mode != kFma32 && mode != kFmaf) || path < kPathDense ||
      path > kPathGeneral || (path == kPathDense && ndim != 1) || (path == kPathTile && ndim != 4) ||
      n >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const long long* size = geometry + 2;
  if (path == kPathTile && (size[0] < 1 || size[0] > kMaxBatch || size[3] < 1 || size[3] > 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* ptrs[3] = {a, b, c};
  const float vals[3] = {va, vb, vc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = mode == kFma32
                     ? launch<kFma32>(path, ptrs, vals, out, static_cast<int>(n), ndim, size, size + ndim,
                                      size + ndim + 3, s)
                     : launch<kFmaf>(path, ptrs, vals, out, static_cast<int>(n), ndim, size, size + ndim,
                                     size + ndim + 3, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
