// Squared-EDT row pass: out[r, j] = min_{|d| <= T} (g2[r, j + d] + d^2),
// with 1e7 standing in for g2 past either end of the row.
//
// Replaces: tcvom_tpu/ops/edt_pallas.py::_edt_row_kernel (reached through
// edt_row_pass_fused; called by tcvom_tpu/ops/distance.py::edt_squared).
//
// Bound on the H100: device memory. The function needs each value read once
// and each output written once, 8 bytes an output: at the main path's
// [2176, 1920] 33 MB, ~10 us at 3.35 TB/s. Its least exact algorithm is a
// min-plus convolution with the convex kernel d^2 (|d| <= T), which a
// lower-envelope or monotone-argmin pass does in a few operations an output,
// far below the bytes. The brute-force loop here does 3T operations an
// output (two mins and an add per offset pair): at 132 SMs x 128 lanes x
// 1.98 GHz one per slot, that loop cannot run faster than ~96 us.
//
// Design: one block per (row, segment of `seg` outputs; one segment up to
// 9216 outputs), the segment and its halo g2[r, j0 - T : j0 + seg + T]
// staged in shared memory once (1e7 outside the row), so device memory is
// read ~(seg + 2T) / seg = 1.27x at the serving shape (from L2) and
// written once. Each thread owns kPer = 9 adjacent outputs and sweeps the
// offsets in groups of kPer with two register windows over shared memory
// (one for -d, one for +d): every shared load feeds kPer outputs, d^2 is
// shared by the thread's outputs and carried exactly as a running value
// ((d + 1)^2 = d^2 + 2d + 1, exact in f32 below 2^24), so the loop holds
// only the adds and mins. kPer is odd so that the threads' windows (kPer
// words apart) fall in distinct banks. Offsets past the last whole group
// (and past d = 4095, where d^2 leaves f32's exact integers) take a plain
// loop with d^2 converted per offset. The mins, not the adds, then bound
// the loop: a float or int min issues on the 64-lane ALU pipe, half the
// add's rate.
//
// The sweep: the two f32 adds, then one DPX three-way min of their bit
// patterns, acc = __vimin3_s32(acc, bits(l + d^2), bits(r + d^2)):
// non-negative floats (+0.0 up to +inf) order as their bit patterns do as
// ints, and each sum is the plain version's, so it is bit-exact wherever the
// block's staged values are non-negative. The EDT's inputs are squared
// distances, so on the main path every block takes it; a block holding any
// other value runs the plain version's operations in its order,
// acc = fminf(acc, fminf(g2[j - d], g2[j + d]) + d^2), bit-exact for any
// input. (On the H100 the f32 form alone on every block is 4-6 % slower.)
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kPer = 9;          // outputs per thread; odd: no bank conflicts
constexpr int kMaxThreads = 1024;
constexpr float kBig = 1.0e7f;
constexpr int kExactD = 4096;    // d^2 is an exact f32 integer for d < this

// The two forms of the sweep: the accumulator A and one relaxation
// acc = min(acc, g2[j - d] + d^2, g2[j + d] + d^2). Dpx::takes says which
// staged values its form is exact for.
struct F32 {
  using A = float;
  static __device__ A init(float v) { return v; }
  static __device__ A relax(A acc, float l, float r, float d2) {
    return fminf(acc, fminf(l, r) + d2);
  }
  static __device__ float result(A acc) { return acc; }
};

struct Dpx {
  using A = int;
  static __device__ A init(float v) { return __float_as_int(v); }
  static __device__ A relax(A acc, float l, float r, float d2) {
    return __vimin3_s32(acc, __float_as_int(l + d2), __float_as_int(r + d2));
  }
  static __device__ float result(A acc) { return __int_as_float(acc); }
  static __device__ bool takes(float v) {
    return __float_as_uint(v) <= 0x7f800000u;  // +0.0 .. +inf
  }
};

// Outputs c[0..kPer) (c[u] = g2[r, j + u]; c[-T - kPer .. T + 2 kPer) is
// staged) over the offsets 0..T, into out[0..n_out).
template <class Op>
__device__ __forceinline__ void sweep(const float* c, int trunc, float* out,
                                      int n_out) {
  typename Op::A acc[kPer];
  float lw[2 * kPer - 1], rw[2 * kPer - 1];
#pragma unroll
  for (int u = 0; u < kPer; ++u) acc[u] = Op::init(c[u]);
  // group of offsets d0 .. d0 + kPer - 1: lw[i] = c[i - d0 - kPer + 1],
  // rw[i] = c[d0 + i], so g2[j + u - d] = lw[u - (d - d0) + kPer - 1] and
  // g2[j + u + d] = rw[u + (d - d0)]
#pragma unroll
  for (int i = 0; i < 2 * kPer - 1; ++i) {
    lw[i] = c[i - kPer];
    rw[i] = c[1 + i];
  }
  float d2 = 1.f, step = 3.f;  // d^2 and 2d + 1 at d = d0
  const int last = min(trunc, kExactD - 1);
  int d0 = 1;
  for (; d0 + kPer - 1 <= last; d0 += kPer) {
#pragma unroll
    for (int dd = 0; dd < kPer; ++dd) {
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        acc[u] = Op::relax(acc[u], lw[u - dd + kPer - 1], rw[u + dd], d2);
      }
      d2 += step;
      step += 2.f;
    }
#pragma unroll
    for (int i = 2 * kPer - 2; i >= kPer; --i) lw[i] = lw[i - kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) lw[i] = c[i - d0 - 2 * kPer + 1];
#pragma unroll
    for (int i = 0; i < kPer - 1; ++i) rw[i] = rw[i + kPer];
#pragma unroll
    for (int i = kPer - 1; i < 2 * kPer - 1; ++i) rw[i] = c[d0 + kPer + i];
  }
  for (int d = d0; d <= trunc; ++d) {
    const float sq = __int2float_rn(d * d);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      acc[u] = Op::relax(acc[u], c[u - d], c[u + d], sq);
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    if (u < n_out) out[u] = Op::result(acc[u]);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    edt_row_kernel(const float* __restrict__ g2, float* __restrict__ out,
                   int width, int trunc, int seg, int nseg) {
  extern __shared__ float s[];  // [kPer + seg + 2 * trunc + 2 * kPer]
  const long long row = blockIdx.x / nseg;
  const int j0 = blockIdx.x % nseg * seg;
  const float* g = g2 + row * width;
  const int span = seg + 2 * trunc + 3 * kPer;
  bool exact = true;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int col = j0 - trunc - kPer + i;
    const float v = (col >= 0 && col < width) ? g[col] : kBig;
    s[i] = v;
    exact = exact && Dpx::takes(v);
  }
  // a block whose values the DPX form does not take exactly runs the f32 one
  const bool dpx = __syncthreads_and(exact);
  const int first = threadIdx.x * kPer;
  if (j0 + first >= width) return;
  const float* c = s + kPer + trunc + first;
  float* o = out + row * width + j0 + first;
  const int n_out = min(kPer, width - j0 - first);
  if (dpx) {
    sweep<Dpx>(c, trunc, o, n_out);
  } else {
    sweep<F32>(c, trunc, o, n_out);
  }
}

}  // namespace

// seg and smem_bytes come from the host's plan
// (tcvom_tpu_torch/ops/edt_kernel.py::row_plan); a plan this source does not
// fit is refused with cudaErrorInvalidValue.
extern "C" int edt_row_pass(const void* g2, void* out, int rows, int width,
                            int trunc, int seg, int smem_bytes, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (seg <= 0 || seg % kPer || seg / kPer > kMaxThreads ||
      smem_bytes != (seg + 2 * trunc + 3 * kPer) *
                        static_cast<int>(sizeof(float))) {
    return cudaErrorInvalidValue;
  }
  const int nseg = (width + seg - 1) / seg;
  if (static_cast<long long>(rows) * nseg >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(edt_row_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  edt_row_kernel<<<rows * nseg, seg / kPer, smem_bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g2), static_cast<float*>(out), width, trunc,
      seg, nseg);
  return static_cast<int>(cudaGetLastError());
}
