// Squared-EDT row pass: out[r, j] = min_{|d| <= T} (g2[r, j + d] + d^2),
// with 1e7 standing in for g2 past either end of the row.
//
// Replaces: tcvom_tpu/ops/edt_pallas.py::_edt_row_kernel (reached through
// edt_row_pass_fused; called by tcvom_tpu/ops/distance.py::edt_squared).
//
// Bound on the H100: arithmetic. Each output takes 3T f32 operations
// (two mins and an add per offset pair) against 8 bytes of device memory,
// so at the main path's [2176, 1920], T = 256 it does ~3.2 G operations on
// 33 MB: ~48 us at 67 TFLOP/s of f32 against ~10 us of HBM traffic.
//
// Design: one block of 256 threads per (row, segment of 256 outputs). The
// block stages g2[r, j0 - T : j0 + 256 + T] in shared memory once (1e7
// outside the row), so device memory is read about once per element
// ((256 + 2T) / 256 = 3x at T = 256, from L2) and written once. Each
// thread then sweeps d = 1..T over shared memory, sharing the d^2 add
// between the +d and -d candidates. Every value is an integer-valued f32
// below 2^24 (g2 <= 1e7, d^2 <= 65536 on the main path), so the result is
// exact and equals the plain version bit for bit in any order.
#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 256;
constexpr float kBig = 1.0e7f;

__global__ void edt_row_kernel(const float* __restrict__ g2,
                               float* __restrict__ out, int width, int trunc,
                               int nseg) {
  extern __shared__ float s[];  // [kSeg + 2 * trunc]
  const long long row = blockIdx.x / nseg;
  const int j0 = (blockIdx.x % nseg) * kSeg;
  const float* g = g2 + row * width;
  const int span = kSeg + 2 * trunc;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int col = j0 - trunc + i;
    s[i] = (col >= 0 && col < width) ? g[col] : kBig;
  }
  __syncthreads();
  const int j = j0 + threadIdx.x;
  if (j >= width) return;
  const float* c = s + trunc + threadIdx.x;
  float acc = c[0];
  for (int d = 1; d <= trunc; ++d) {
    acc = fminf(acc, fminf(c[-d], c[d]) + static_cast<float>(d * d));
  }
  out[row * width + j] = acc;
}

}  // namespace

extern "C" int edt_row_pass_f32(const void* g2, void* out, int rows,
                                int width, int trunc, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nseg = (width + kSeg - 1) / kSeg;
  const size_t smem = static_cast<size_t>(kSeg + 2 * trunc) * sizeof(float);
  edt_row_kernel<<<rows * nseg, kSeg, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g2), static_cast<float*>(out), width, trunc,
      nseg);
  return static_cast<int>(cudaGetLastError());
}
