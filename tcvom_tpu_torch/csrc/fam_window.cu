// FAM window attention:
//   out[b,y,x,:] = mask[b,y,x] * sum_p softmax_p(q . k_p / sqrt(C)) * k_p
// over the window^2 neighbours p of (y, x) in k, row-major over (dy, dx).
// A neighbour outside the frame is a zero vector: its logit is 0 and it
// stays in the softmax, but it adds nothing to the sum. The sum is of k,
// not of a separate value tensor. q, k, out: [B, H, W, C]; mask: [B, H, W, 1].
// The training instantiation (kLogits) also writes the masked raw logits
//   logits[b,y,x,p] = mask[b,y,x] * q . k_p / sqrt(C)      [B, H, W, window^2]
// in F.unfold's patch order, which the attention loss reads.
//
// Replaces: tcvom_tpu/ops/fam_pallas.py::_fam_kernel_mxu2 (inference,
// entries fam_window_*) and, with kLogits, both logits-writing kernels
// _fam_kernel (:38, the f32 training crop) and _fam_kernel_mxu (:97, the
// validation crop and bf16 training), which compute one function.
//
// Bound on the H100: device memory. At the main path's [2, 136, 240, 256]
// bf16 it must read q and k and write out, ~100 MB (~30 us at 3.35 TB/s),
// while its ~3.3 GFLOP would take ~3 us on the bf16 tensor cores.
//
// Design (simple first): one warp per query pixel, the lanes splitting the
// channels. For each neighbour the warp forms the dot product with a
// shuffle reduction, then updates an online softmax: the running max, the
// denominator and the weighted k accumulator stay in f32 registers, and
// the result is scaled by the mask and stored in q's dtype. The window^2
// re-reads of k hit L1/L2, so device memory sees each input about once.
// Any H, W, C >= 1 and odd window; channels beyond 256 are handled in
// further passes that recompute the logits. No tensor cores yet.
// With kLogits, lane 0 stores each neighbour's logit (already reduced
// across the warp) in the first channel pass only, so a logit is written
// exactly once whatever C; the extra [B, H, W, window^2] output is ~6 %
// of the bytes moved at C = 256, window 7.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kWarps = 8;        // query pixels per block
constexpr int kPerLane = 8;      // accumulator channels per lane per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, bool kLogits>
__global__ void fam_window_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k,
                                  const T* __restrict__ mask,
                                  T* __restrict__ out, T* __restrict__ logits,
                                  int h, int w, int c, int window,
                                  float scale, long long npix) {
  const int lane = threadIdx.x & 31;
  const long long pix =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (pix >= npix) return;  // uniform across the warp
  const int x = static_cast<int>(pix % w);
  const int y = static_cast<int>((pix / w) % h);
  const long long frame = pix / (static_cast<long long>(w) * h);
  const int r = window / 2;
  const T* qp = q + pix * c;
  const float m = to_f32(mask[pix]);
  T* lp = kLogits ? logits + pix * window * window : nullptr;

  for (int c0 = 0; c0 < c; c0 += 32 * kPerLane) {
    float acc[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;
    float run_max = -INFINITY;
    float denom = 0.f;
    int p = 0;
    for (int dy = -r; dy <= r; ++dy) {
      const int yy = y + dy;
      for (int dx = -r; dx <= r; ++dx) {
        const int xx = x + dx;
        const bool inside = yy >= 0 && yy < h && xx >= 0 && xx < w;
        const T* kp = k + ((frame * h + yy) * w + xx) * c;
        float logit = 0.f;
        if (inside) {
          float dot = 0.f;
          for (int ch = lane; ch < c; ch += 32) {
            dot += to_f32(qp[ch]) * to_f32(kp[ch]);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          }
          logit = dot * scale;
        }
        if (kLogits && c0 == 0 && lane == 0) store(lp + p, logit * m);
        ++p;
        const float new_max = fmaxf(run_max, logit);
        const float corr = expf(run_max - new_max);
        const float e = expf(logit - new_max);
        denom = denom * corr + e;
        if (inside) {
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) {
            const int ch = c0 + lane + 32 * i;
            const float kv = ch < c ? to_f32(kp[ch]) : 0.f;
            acc[i] = acc[i] * corr + e * kv;
          }
        } else {
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) acc[i] *= corr;
        }
        run_max = new_max;
      }
    }
    T* op = out + pix * c;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int ch = c0 + lane + 32 * i;
      if (ch < c) store(op + ch, acc[i] / denom * m);
    }
  }
}

template <typename T, bool kLogits>
int launch(const void* q, const void* k, const void* mask, void* out,
           void* logits, int b, int h, int w, int c, int window, float scale,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long npix = static_cast<long long>(b) * h * w;
  const long long blocks = (npix + kWarps - 1) / kWarps;
  fam_window_kernel<T, kLogits>
      <<<static_cast<unsigned int>(blocks), 32 * kWarps, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(mask), static_cast<T*>(out),
          static_cast<T*>(logits), h, w, c, window, scale, npix);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fam_window_f32(const void* q, const void* k, const void* mask,
                              void* out, int b, int h, int w, int c,
                              int window, float scale, int device,
                              void* stream) {
  return launch<float, false>(q, k, mask, out, nullptr, b, h, w, c, window,
                              scale, device, stream);
}

extern "C" int fam_window_bf16(const void* q, const void* k, const void* mask,
                               void* out, int b, int h, int w, int c,
                               int window, float scale, int device,
                               void* stream) {
  return launch<__nv_bfloat16, false>(q, k, mask, out, nullptr, b, h, w, c,
                                      window, scale, device, stream);
}

extern "C" int fam_window_logits_f32(const void* q, const void* k,
                                     const void* mask, void* out,
                                     void* logits, int b, int h, int w, int c,
                                     int window, float scale, int device,
                                     void* stream) {
  return launch<float, true>(q, k, mask, out, logits, b, h, w, c, window,
                             scale, device, stream);
}

extern "C" int fam_window_logits_bf16(const void* q, const void* k,
                                      const void* mask, void* out,
                                      void* logits, int b, int h, int w,
                                      int c, int window, float scale,
                                      int device, void* stream) {
  return launch<__nv_bfloat16, true>(q, k, mask, out, logits, b, h, w, c,
                                     window, scale, device, stream);
}
