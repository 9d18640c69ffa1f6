// The numerics mirrors for Hopper (sm_90a): glibc's sinf, XLA's inline f32
// log / log2 / exp, and the GLSL pow that the reference's jitted fusions
// compute as exp(log(x) * c), one f32 element in, one f32 element out.
//
// Replaces no TPU kernel: these are the functions that the reference's
// jitted XLA fusions execute inline on the CPU (XLA's CPU code calls
// libm's sinf; its log and exp are inline Cephes polynomials), which the
// port repeats bit for bit in policy.sinf32 / logf32 / log2f32 / expf32 as
// float64 and int64 tensor passes (20 to 40 a call). This kernel is the
// same arithmetic in one pass over the tensor: every rounding is written
// out with __dmul_rn / __dadd_rn / __dsub_rn and __fmul_rn / __fadd_rn /
// __fsub_rn, and the file is built with -fmad=false besides, so nothing
// is contracted into an FMA that the plain version does not take.
//
// The device functions are numerics.cuh's, which crt-mattias's epilogue
// kernel includes too; the exhaustive sweeps of tests/test_torch_cuda.py
// hold this kernel to the plain versions at every input. Their multiply-adds
// were policy's f64 formula once: two f64 operations and about two f32 <->
// f64 conversions each, which issue 16 a clock per SM (f64 operations 64,
// f32 128): 44 conversions a pow element, 2.4 ms of crt-mattias's output
// gamma, against one FFMA now.
//
// What bounds it: bytes, for log, log2, exp and pow (an element moves 8
// bytes; pow does 20 FFMA, 6 FADD and 6 FMUL, exp 9, 1 and 2); sin does
// 11 to 15 f64 operations and its two conversions. Design: one thread per
// 4 elements with 16-byte loads and stores where both pointers are 16-byte
// aligned (a contiguous tensor the caching allocator hands out is),
// grid-stride, the op a template parameter so each instantiation is
// straight-line code.

#include "numerics.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

enum Op { kSin = 0, kLog = 1, kLog2 = 2, kExp = 3, kPow = 4 };

template <int OP>
__device__ __forceinline__ float apply(float x, float c) {
  if (OP == kSin) return sin_mirror(x);
  if (OP == kLog) return log_mirror(x);
  if (OP == kLog2) return __fmul_rn(log_mirror(x), kLog2e);
  if (OP == kExp) return exp_mirror(x);
  return pow_mirror(x, c);  // kPow
}

template <int OP, bool VEC>
__global__ void __launch_bounds__(kThreads) mirror_kernel(const float* __restrict__ x, float* __restrict__ out,
                                                          int64_t n, float c) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t done = 0;
  if (VEC) {
    const int64_t n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t j = i; j < n4; j += stride) {
      float4 v = __ldcs(x4 + j);
      v.x = apply<OP>(v.x, c);
      v.y = apply<OP>(v.y, c);
      v.z = apply<OP>(v.z, c);
      v.w = apply<OP>(v.w, c);
      __stcs(o4 + j, v);
    }
    done = n4 << 2;
  }
  for (int64_t j = done + i; j < n; j += stride) out[j] = apply<OP>(__ldcs(x + j), c);
}

template <int OP>
void launch(const float* x, float* out, int64_t n, float c, cudaStream_t s) {
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int64_t units = vec ? (n >> 2) + 1 : n;
  const int blocks = static_cast<int>(units / kThreads + 1 < kMaxBlocks ? units / kThreads + 1 : kMaxBlocks);
  if (vec) {
    mirror_kernel<OP, true><<<blocks, kThreads, 0, s>>>(x, out, n, c);
  } else {
    mirror_kernel<OP, false><<<blocks, kThreads, 0, s>>>(x, out, n, c);
  }
}

}  // namespace

// x, out: f32 [n] contiguous (out may not alias x). op: 0 sin, 1 log,
// 2 log2, 3 exp, 4 pow with the f32 constant c (exp(log(x) * c)).
// Launches on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unknown op.
extern "C" int mirrors_launch(const float* x, float* out, long long n, int op, float c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kSin: launch<kSin>(x, out, n, c, s); break;
    case kLog: launch<kLog>(x, out, n, c, s); break;
    case kLog2: launch<kLog2>(x, out, n, c, s); break;
    case kExp: launch<kExp>(x, out, n, c, s); break;
    case kPow: launch<kPow>(x, out, n, c, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
