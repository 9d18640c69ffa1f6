// The operator rctpu::fma for Hopper (sm_90a): a*b + c over f32 operands
// that broadcast against each other, one f32 result an element, in one of
// two roundings:
//
//   mode 0, policy.fma32: the f64 sum narrowed once (fma32 below), how
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
// materialised). The host merges the result's dimensions where every
// operand allows (ops/cuda/fma.py).
//
// What bounds it: bytes. An element reads at most 12 bytes and writes 4;
// fma32's three widenings and one narrowing issue 16 a clock per SM, a
// quarter of the f64 rate, which at 132 SMs keeps up with the memory rate.
// Design: where every tensor operand is laid out as the result (or is a
// device scalar), one thread per 4 elements with 16-byte loads and stores
// (when all pointers are 16-byte aligned); else one thread per element,
// its offsets from the element's index by a multiply-and-shift division
// per dimension (32-bit indices: the wrapper takes fewer than 2^31
// elements), grid-stride in both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// policy.fma32: a*b + c rounded once to f32. The product of two f32 values
// is exact in f64 (48 bits of 53; no f32 product leaves the f64 range), so
// __dmul_rn is exact; __dadd_rn rounds the sum to f64 and __double2float_rn
// narrows it to f32. That equals __fmaf_rn except where the f64 sum is
// inexact and lands on an f32 tie: there the second rounding goes to even
// (a = b = 1 + 2^-12, c = 2^-80: this gives 1 + 2^-11, __fmaf_rn
// 1 + 2^-11 + 2^-23). Built with -fmad=false, so that nothing else is
// contracted around it.
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)), static_cast<double>(c)));
}

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kMaxDims = 8;

enum Mode { kFma32 = 0, kFmaf = 1 };
enum Kind { kValue = 0, kScalar = 1, kDense = 2, kStrided = 3 };

struct Operand {
  const float* p;
  float v;
  int kind;
  long long stride[kMaxDims];
};

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

struct Args {
  Operand op[3];
  int ndim;
  long long size[kMaxDims];  // the result's dimensions, outermost first
  Divider div[kMaxDims];
};

template <int MODE>
__device__ __forceinline__ float fma_op(float a, float b, float c) {
  return MODE == kFma32 ? fma32(a, b, c) : __fmaf_rn(a, b, c);
}

__device__ __forceinline__ float scalar_of(const Operand& o) { return o.kind == kScalar ? __ldg(o.p) : o.v; }

template <int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads) fma_dense_kernel(const Args args, float* __restrict__ out, long long n) {
  const float s0 = scalar_of(args.op[0]), s1 = scalar_of(args.op[1]), s2 = scalar_of(args.op[2]);
  const bool d0 = args.op[0].kind == kDense, d1 = args.op[1].kind == kDense, d2 = args.op[2].kind == kDense;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long done = 0;
  if (VEC) {
    const long long n4 = n >> 2;
    const float4* a4 = reinterpret_cast<const float4*>(args.op[0].p);
    const float4* b4 = reinterpret_cast<const float4*>(args.op[1].p);
    const float4* c4 = reinterpret_cast<const float4*>(args.op[2].p);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long j = i; j < n4; j += stride) {
      const float4 a = d0 ? a4[j] : make_float4(s0, s0, s0, s0);
      const float4 b = d1 ? b4[j] : make_float4(s1, s1, s1, s1);
      const float4 c = d2 ? c4[j] : make_float4(s2, s2, s2, s2);
      o4[j] = make_float4(fma_op<MODE>(a.x, b.x, c.x), fma_op<MODE>(a.y, b.y, c.y), fma_op<MODE>(a.z, b.z, c.z),
                          fma_op<MODE>(a.w, b.w, c.w));
    }
    done = n4 << 2;
  }
  for (long long j = done + i; j < n; j += stride) {
    out[j] = fma_op<MODE>(d0 ? args.op[0].p[j] : s0, d1 ? args.op[1].p[j] : s1, d2 ? args.op[2].p[j] : s2);
  }
}

__device__ __forceinline__ unsigned int quotient(const Divider& v, unsigned int n) {
  return (__umulhi(n, v.m) + n) >> v.s;
}

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

template <int MODE>
void launch(const Args& args, float* out, long long n, bool dense, bool vec, cudaStream_t s) {
  if (dense && vec) {
    fma_dense_kernel<MODE, true><<<blocks_for((n >> 2) + 1), kThreads, 0, s>>>(args, out, n);
  } else if (dense) {
    fma_dense_kernel<MODE, false><<<blocks_for(n), kThreads, 0, s>>>(args, out, n);
  } else {
    fma_strided_kernel<MODE><<<blocks_for(n), kThreads, 0, s>>>(args, out, static_cast<unsigned int>(n));
  }
}

}  // namespace

// a, b, c: f32 device pointers, or null for the value va / vb / vc. out:
// f32, contiguous, of the broadcast shape (fewer than 2^31 elements), not
// aliasing an operand. geometry: the result's ndim (<= 8) sizes, outermost
// first, then the
// element strides of a, b and c over those dimensions (ndim each; 0 where
// the operand is broadcast). mode: 0 fma32, 1 fmaf32. Launches on
// `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a bad mode, ndim or size.
extern "C" int fma_launch(const float* a, const float* b, const float* c, float va, float vb, float vc, float* out,
                          int ndim, const long long* geometry, int mode, void* stream) {
  if (ndim < 0 || ndim > kMaxDims || (mode != kFma32 && mode != kFmaf)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args args = {};
  args.ndim = ndim;
  long long n = 1;
  long long contiguous[kMaxDims];
  for (int d = ndim - 1; d >= 0; --d) {
    args.size[d] = geometry[d];
    contiguous[d] = n;
    n *= geometry[d];
  }
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (n >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  for (int d = 0; d < ndim; ++d) args.div[d] = make_divider(static_cast<unsigned int>(args.size[d]));
  const float* ptrs[3] = {a, b, c};
  const float vals[3] = {va, vb, vc};
  bool dense = true;
  bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int k = 0; k < 3; ++k) {
    Operand& o = args.op[k];
    o.p = ptrs[k];
    o.v = vals[k];
    bool zero = true, packed = true;
    for (int d = 0; d < ndim; ++d) {
      o.stride[d] = geometry[ndim * (k + 1) + d];
      zero = zero && (o.stride[d] == 0 || args.size[d] == 1);
      packed = packed && (o.stride[d] == contiguous[d] || args.size[d] == 1);
    }
    if (o.p == nullptr) {
      o.kind = kValue;
    } else if (zero) {
      o.kind = kScalar;
    } else if (packed) {
      o.kind = kDense;
      vec = vec && (reinterpret_cast<uintptr_t>(o.p) & 15) == 0;
    } else {
      o.kind = kStrided;
      dense = false;
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kFma32) {
    launch<kFma32>(args, out, n, dense, vec, s);
  } else {
    launch<kFmaf>(args, out, n, dense, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}
