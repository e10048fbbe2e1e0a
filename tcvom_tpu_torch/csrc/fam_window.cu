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
// entries fam_window_bf16_mma and fam_window_f32) and, with kLogits, both
// logits-writing kernels _fam_kernel (:38, the f32 training crop) and
// _fam_kernel_mxu (:97, the validation crop and bf16 training), which
// compute one function.
//
// Bound on the H100: device memory. At the main path's [2, 136, 240, 256]
// bf16 it must read q and k and write out, ~100 MB (~30 us at 3.35 TB/s),
// while its ~3.3 GFLOP would take ~3 us on the bf16 tensor cores.
//
// Two designs live here.
//
// bf16 inference (fam_window_mma_kernel, the serving path): the tensor
// cores, as the TPU kernel uses its MXU: one correlation product and one
// reconstruction product per tile. One block of four warps takes an 8x8
// tile of query pixels; each warp owns two query rows, 16 rows of an
// mma.sync m16n8k16. The tile's q and its (8 + 2r)^2 halo of k are staged
// in shared memory in 64-channel chunks with 16-byte cp.async (zero-filled
// outside the frame and past C, which gives the zero-neighbour semantics
// for free). A warp's two query rows meet only 2r + 2 halo rows, which are
// contiguous in shared memory: (2r + 2)(8 + 2r) columns (112 at window 7,
// of which 49 are a row's band). Pass 1 accumulates S = q . k_halo^T over
// the chunks in f32 registers; the softmax runs over each row's band in
// f32 (quad shuffles), and the unnormalised weights exp(s - max) <= 1 are
// rounded to bf16, as the TPU kernel casts its weights (fam_pallas.py:249),
// and become the A operand of pass 2 in registers; the denominator is the
// f32 sum of the rounded weights. Pass 2 computes O = P . k_halo chunk by
// chunk (ldmatrix.trans of the same staging), then O / denom * mask is
// stored as bf16. With one chunk (C <= 64) the halo stays staged between
// the passes; otherwise it is staged again. The wasted tensor-core work
// (112 columns for 49) is ~2.3x of 3.3 GFLOP, a few microseconds. Each
// staged byte feeds 16x8x16 products, where one warp per pixel spends ~24
// load instructions and a shuffle-reduction chain on every (pixel,
// neighbour) pair. Window 1..9 (r <= 4): the shared memory is (halo + pad
// + 64 q rows) x 72 bf16 x 2 bytes, at most 46 KB, so no opt-in is
// needed (a static_assert holds every window to that).
//
// f32 and logits (fam_window_kernel): one warp per query pixel,
// the lanes splitting the channels. For each neighbour the warp forms the
// dot product with a shuffle reduction, then updates an online softmax in
// f32 registers, and the result is scaled by the mask and stored in q's
// dtype. Any H, W, C >= 1 and odd window; channels beyond 256 are handled
// in further passes that recompute the logits. With kLogits, lane 0 stores
// each neighbour's logit (already reduced across the warp) in the first
// channel pass only, so a logit is written exactly once whatever C.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

// ---- bf16 inference on the tensor cores ----------------------------------

constexpr int kMmaWarps = 4;            // two query rows each
constexpr int kTileH = 2 * kMmaWarps;   // query tile rows
constexpr int kTileW = 8;               // query tile columns
constexpr int kChunk = 64;              // channels staged at a time
constexpr int kStride = kChunk + 8;     // bf16 per staged row: 144 bytes, so
                                        // ldmatrix's 8 rows hit 8 bank quads

template <int R>
struct Plan {
  static constexpr int kHaloW = kTileW + 2 * R;
  static constexpr int kHaloH = kTileH + 2 * R;
  static constexpr int kCols = (2 * R + 2) * kHaloW;  // one warp's halo pixels
  static constexpr int kColsPad = (kCols + 15) / 16 * 16;
  static constexpr int kNTiles = kColsPad / 8;        // n-tiles of S
  static constexpr int kKSteps = kColsPad / 16;       // k-steps of P . K
  // zero rows after the halo for the last warp's padded columns
  static constexpr int kHaloRows = kHaloH * kHaloW + (kColsPad - kCols);
  static constexpr int kSmemBytes =
      (kHaloRows + kTileH * kTileW) * kStride * 2;
  static_assert(kSmemBytes <= 48 * 1024, "needs the shared-memory opt-in");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage channels [c0, c0 + kChunk) of `rows` pixels into dst (kStride apart):
// pixel i of the staging sits at (y0 + i / width_px - off, x0 + i % width_px
// - off) of the frame; out-of-frame pixels and channels past C are zeros.
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int rows,
                                      int width_px, int off, int y0, int x0,
                                      long long frame_px, int h, int w, int c,
                                      int c0, bool vec) {
  constexpr int kVecs = kChunk / 8;
  for (int i = threadIdx.x; i < rows * kVecs; i += blockDim.x) {
    const int pix = i / kVecs;
    const int ch = c0 + (i % kVecs) * 8;
    const int yy = y0 + pix / width_px - off;
    const int xx = x0 + pix % width_px - off;
    const bool inside = yy >= 0 && yy < h && xx >= 0 && xx < w;
    const int n = inside ? min(8, c - ch) : 0;
    const __nv_bfloat16* s =
        src + (frame_px + static_cast<long long>(yy) * w + xx) * c + ch;
    __nv_bfloat16* d = dst + pix * kStride + (i % kVecs) * 8;
    if (vec) {  // C % 8 == 0 and 16-byte aligned: n is 8 or <= 0
      cp_async16(d, n > 0 ? s : src, n > 0 ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = e < n ? s[e] : __float2bfloat16(0.f);
    }
  }
}

template <int R>
__global__ void __launch_bounds__(32 * kMmaWarps, 4)
    fam_window_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ mask,
                          __nv_bfloat16* __restrict__ out, int h, int w,
                          int c, int tiles_y, int tiles_x, float scale_log2e,
                          bool vec) {
  using P = Plan<R>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sq = sk + P::kHaloRows * kStride;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tx = blockIdx.x % tiles_x;
  const int ty = (blockIdx.x / tiles_x) % tiles_y;
  const long long frame_px =
      static_cast<long long>(blockIdx.x / (tiles_x * tiles_y)) * h * w;
  const int y0 = ty * kTileH, x0 = tx * kTileW;
  const int nchunks = (c + kChunk - 1) / kChunk;

  for (int i = threadIdx.x; i < (P::kHaloRows - P::kHaloH * P::kHaloW) *
                                    kStride;
       i += blockDim.x) {
    sk[P::kHaloH * P::kHaloW * kStride + i] = __float2bfloat16(0.f);
  }
  // this warp's halo columns: halo rows 2 * warp .. 2 * warp + 2r + 1
  const __nv_bfloat16* kw = sk + 2 * warp * P::kHaloW * kStride;
  const __nv_bfloat16* qw = sq + 16 * warp * kStride;

  // ---- pass 1: S = q . k_halo^T over the channel chunks
  float s[P::kNTiles][4];
#pragma unroll
  for (int n = 0; n < P::kNTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  for (int ci = 0; ci < nchunks; ++ci) {
    stage(sk, k, P::kHaloH * P::kHaloW, P::kHaloW, R, y0, x0, frame_px, h, w,
          c, ci * kChunk, vec);
    stage(sq, q, kTileH * kTileW, kTileW, 0, y0, x0, frame_px, h, w, c,
          ci * kChunk, vec);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, qw + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kStride +
                         16 * ks + 8 * (lane >> 4));
#pragma unroll
      for (int n = 0; n < P::kNTiles; n += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, kw + (8 * n + (lane & 7) + 8 * (lane >> 4)) * kStride +
                           16 * ks + 8 * ((lane >> 3) & 1));
        mma_bf16(s[n], a, b[0], b[1]);
        mma_bf16(s[n + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  // ---- softmax over each row's band. Element e of n-tile n is row
  // g + 8 * (e >> 1) (query (2 * warp + (e >> 1), g) of the tile) and
  // column 8n + 2t + (e & 1) (halo pixel (col / kHaloW, col % kHaloW) of
  // this warp's rows).
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < P::kNTiles; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * n + 2 * t + (e & 1);
      const int dy = col / P::kHaloW - (e >> 1);
      const int dx = col % P::kHaloW - g;
      const bool band = col < P::kCols && dy >= 0 && dy <= 2 * R &&
                        dx >= 0 && dx <= 2 * R;
      s[n][e] = band ? s[n][e] : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
  }
  float den[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
  uint32_t pa[P::kKSteps][4];  // the weights as A fragments of pass 2
#pragma unroll
  for (int n = 0; n < P::kNTiles; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat162 pr = __floats2bfloat162_rn(
          exp2f((s[n][2 * i] - mx[i]) * scale_log2e),
          exp2f((s[n][2 * i + 1] - mx[i]) * scale_log2e));
      den[i] += __low2float(pr) + __high2float(pr);
      pa[n >> 1][(n & 1) * 2 + i] = pack_bf16(pr);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    den[i] += __shfl_xor_sync(0xffffffffu, den[i], 1);
    den[i] += __shfl_xor_sync(0xffffffffu, den[i], 2);
  }

  // ---- pass 2: O = P . k_halo, chunk by chunk, stored as bf16
  float scale_row[2];
  long long pix_row[2];
  bool live_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int yy = y0 + 2 * warp + i, xx = x0 + g;
    live_row[i] = yy < h && xx < w;
    pix_row[i] = frame_px + static_cast<long long>(yy) * w + xx;
    scale_row[i] =
        live_row[i] ? __bfloat162float(mask[pix_row[i]]) / den[i] : 0.f;
  }
  const bool pairs = vec;  // C even and aligned: store two channels at once
  for (int ci = 0; ci < nchunks; ++ci) {
    if (nchunks > 1) {
      stage(sk, k, P::kHaloH * P::kHaloW, P::kHaloW, R, y0, x0, frame_px, h,
            w, c, ci * kChunk, vec);
      cp_async_wait_all();
      __syncthreads();
    }
    float o[kChunk / 8][4];
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < P::kKSteps; ++ks) {
#pragma unroll
      for (int n = 0; n < kChunk / 8; n += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, kw + (16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1)) * kStride +
                   8 * n + 8 * (lane >> 4));
        mma_bf16(o[n], pa[ks], b[0], b[1]);
        mma_bf16(o[n + 1], pa[ks], b[2], b[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!live_row[i]) continue;
      __nv_bfloat16* op = out + pix_row[i] * c;
#pragma unroll
      for (int n = 0; n < kChunk / 8; ++n) {
        const int ch = ci * kChunk + 8 * n + 2 * t;
        const float v0 = o[n][2 * i] * scale_row[i];
        const float v1 = o[n][2 * i + 1] * scale_row[i];
        if (pairs) {
          if (ch < c) {
            *reinterpret_cast<__nv_bfloat162*>(op + ch) =
                __floats2bfloat162_rn(v0, v1);
          }
        } else {
          if (ch < c) op[ch] = __float2bfloat16_rn(v0);
          if (ch + 1 < c) op[ch + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
    if (nchunks > 1) __syncthreads();
  }
}

template <int R>
int launch_mma(const void* q, const void* k, const void* mask, void* out,
               int b, int h, int w, int c, float scale, cudaStream_t stream) {
  const int tiles_y = (h + kTileH - 1) / kTileH;
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const long long blocks = static_cast<long long>(b) * tiles_y * tiles_x;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  const bool vec = c % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  fam_window_mma_kernel<R>
      <<<static_cast<unsigned int>(blocks), 32 * kMmaWarps,
         Plan<R>::kSmemBytes, stream>>>(static_cast<const __nv_bfloat16*>(q),
                   static_cast<const __nv_bfloat16*>(k),
                   static_cast<const __nv_bfloat16*>(mask),
                   static_cast<__nv_bfloat16*>(out), h, w, c, tiles_y,
                   tiles_x, scale * 1.4426950408889634f, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---- warp per pixel: f32 inference and both logits entries ---------------

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

// window: odd, 1..9; any other is refused with cudaErrorInvalidValue.
extern "C" int fam_window_bf16_mma(const void* q, const void* k,
                                   const void* mask, void* out, int b, int h,
                                   int w, int c, int window, float scale,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (window) {
    case 1: return launch_mma<0>(q, k, mask, out, b, h, w, c, scale, s);
    case 3: return launch_mma<1>(q, k, mask, out, b, h, w, c, scale, s);
    case 5: return launch_mma<2>(q, k, mask, out, b, h, w, c, scale, s);
    case 7: return launch_mma<3>(q, k, mask, out, b, h, w, c, scale, s);
    case 9: return launch_mma<4>(q, k, mask, out, b, h, w, c, scale, s);
    default: return cudaErrorInvalidValue;
  }
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
