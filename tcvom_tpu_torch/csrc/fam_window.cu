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
// Replaces: tcvom_tpu/ops/fam_pallas.py::_fam_kernel_mxu2 (B, inference,
// entries fam_window_bf16_mma and fam_window_f32) and, with kLogits, both
// logits-writing kernels _fam_kernel (C, :38, the f32 training crop) and
// _fam_kernel_mxu (D, :97, the validation crop and bf16 training), which
// compute one function. One tile kernel serves all four entries.
//
// Bound on the H100: device memory. It must read q and k and write out (and
// the logits, ~6 % more): ~100 MB at the serving path's [2, 136, 240, 256]
// bf16 (~30 us at 3.35 TB/s), ~320 MB at the validation step's
// [12, 68, 120, 256] f32 (~96 us). The function's operations are far below
// that line (~4.9 GFLOP there). The kernel's own are not: in f32 it runs
// ~36 GFLOP of 3xTF32 products at the validation shape, counting the
// band's waste below (112 columns for 49) and the three products each,
// ~0.07 ms at the data sheet's dense TF32 rate, which mma.sync does not
// reach; in bf16 ~7 GFLOP, a few microseconds.
//
// The design: the tensor cores, as the TPU kernel uses its MXU, one
// correlation product and one reconstruction product per tile. One block of
// four warps takes an 8x8 tile of query pixels; each warp owns two query
// rows, the 16 rows of its mma.sync tiles. The tile's q and its (8 + 2r)^2
// halo of k are staged in shared memory 128 bytes a pixel at a time (64
// bf16 or 32 f32 channels) with 16-byte cp.async, zero-filled outside the
// frame and past C, which gives the zero-neighbour semantics for free. A
// warp's two query rows meet only 2r + 2 halo rows, contiguous in shared
// memory: (2r + 2)(8 + 2r) columns (112 at window 7, of which 49 are a
// row's band). Pass 1 accumulates S = q . k_halo^T over the chunks in f32
// registers; kLogits then stores each band element's S * scale * mask; the
// softmax runs over each row's band in f32 (quad shuffles); the
// unnormalised weights exp(s - max) <= 1 become the A operand of pass 2 in
// registers. Pass 2 computes O = P . k_halo chunk by chunk, then
// O / denom * mask is stored. With one chunk the halo stays staged between
// the passes; otherwise it is staged again (at C = 256 in f32 the staging
// reads ~750 MB from L2 at the validation shape). Each staged byte feeds
// whole mma tiles rather than one (pixel, neighbour) dot product.
//
// bf16: mma.sync m16n8k16. The weights are rounded to bf16, as the TPU
// kernel casts its weights (fam_pallas.py:249), and the denominator is the
// f32 sum of the rounded weights.
//
// f32: mma.sync m16n8k8 in 3xTF32, the counterpart of the TPU kernel's
// Precision.HIGHEST (a multi-pass bf16 split, fam_pallas.py:132-135). Each
// f32 operand x is split at fragment load into big, x rounded to tf32, and
// small = x - big (split_tf32), and each product is a_small . b_big +
// a_big . b_small + a_big . b_big: about 21 of f32's 24 mantissa bits. The
// tensor core truncates its own f32 sums, so each k-step's three products
// are summed in a fresh accumulator that is added to the running sum in
// f32 (mma_3xtf32); the kernel then stays within ~2e-6 of the plain
// version at the path's shapes (chip_smoke.py), inside the 1e-5 the f32
// entries are held to. The weights stay
// f32 and are split like any operand (in the chunk loop, not hoisted out
// of it: that would take twice their registers); the denominator is their
// f32 sum. Pass 2's A fragment takes the accumulator layout as it is
// (columns 2t, 2t + 1 of a row), so its k index t stands for halo column
// 2t and t + 4 for 2t + 1, and the B fragment reads the same two halo
// rows; its n index j of n-tile n stands for channel 4j + n of the chunk,
// so one 16-byte load gives a thread its B values for all four n-tiles and
// one thread stores eight contiguous channels. With rows 144 bytes apart,
// pass 1's ldmatrix and pass 2's 16-byte loads are free of bank conflicts.
//
// Window 1..9 (r <= 4): the shared memory is (halo + pad + 64 q rows) x 144
// bytes, at most 46 KB, so no opt-in is needed (a static_assert holds every
// window to that). Any other window is refused with cudaErrorInvalidValue.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMmaWarps = 4;            // two query rows each
constexpr int kTileH = 2 * kMmaWarps;   // query tile rows
constexpr int kTileW = 8;               // query tile columns
constexpr int kRowBytes = 144;          // a staged pixel: 128 bytes of
                                        // channels and 16 of pad, so
                                        // ldmatrix's 8 rows hit 8 bank quads

// A staged chunk of T: kChunk channels a pixel, kStride apart; cp.async
// moves kVec elements, an mma k-step of pass 1 spans kStep.
template <typename T>
struct Chunk {
  static constexpr int kChunk = 128 / sizeof(T);
  static constexpr int kStride = kRowBytes / sizeof(T);
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kStep = 32 / sizeof(T);
};

template <int R>
struct Plan {
  static constexpr int kHaloW = kTileW + 2 * R;
  static constexpr int kHaloH = kTileH + 2 * R;
  static constexpr int kCols = (2 * R + 2) * kHaloW;  // one warp's halo pixels
  static constexpr int kColsPad = (kCols + 15) / 16 * 16;
  static constexpr int kNTiles = kColsPad / 8;        // n-tiles of S
  static constexpr int kKSteps = kColsPad / 16;       // bf16 k-steps of P . K
  // zero rows after the halo for the last warp's padded columns
  static constexpr int kHaloRows = kHaloH * kHaloW + (kColsPad - kCols);
  static constexpr int kSmemBytes =
      (kHaloRows + kTileH * kTileW) * kRowBytes;
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

// Four 8x8 matrices of 16-bit elements; read as 32-bit elements, the same
// load gives four 8x4 tf32 matrices, a thread getting (row g, column t).
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

// d += a . b, m16n8k8, tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An f32 operand as two tf32 terms. big: x rounded to tf32, to nearest
// with ties away from zero, on the bit pattern (what cvt.rna.tf32.f32 does
// for finite x, in two integer instructions where cvt takes four). small:
// x - big, exact in f32; the tensor core reads its tf32 part (it ignores an
// operand's low 13 bits), so x = big + small within 2^-21 relative.
struct Split {
  uint32_t big, small;
};

__device__ __forceinline__ Split split_tf32(float x) {
  Split s;
  s.big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  s.small = __float_as_uint(x - __uint_as_float(s.big));
  return s;
}

// d += a . b in 3xTF32: the three products, the small terms first, summed
// in a fresh accumulator that is then added to d in f32. The tensor core
// truncates its own sums: chained on d over a whole pass (96 products at
// C = 256), that bias took the logits past the 1e-5 the f32 entries are
// held to; with the fresh sum and an IEEE add they stay well inside it.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Split (&a)[4],
                                           Split b0, Split b1) {
  const uint32_t big[4] = {a[0].big, a[1].big, a[2].big, a[3].big};
  const uint32_t small[4] = {a[0].small, a[1].small, a[2].small, a[3].small};
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(p, small, b0.big, b1.big);
  mma_tf32(p, big, b0.small, b1.small);
  mma_tf32(p, big, b0.big, b1.big);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += p[i];
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Stage one chunk (channels [c0, c0 + kChunk)) of `rows` pixels into dst
// (kStride apart): pixel i of the staging sits at (y0 + i / width_px - off,
// x0 + i % width_px - off) of the frame; out-of-frame pixels and channels
// past C are zeros.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int rows,
                                      int width_px, int off, int y0, int x0,
                                      long long frame_px, int h, int w, int c,
                                      int c0, bool vec) {
  using E = Chunk<T>;
  constexpr int kVecs = E::kChunk / E::kVec;
  for (int i = threadIdx.x; i < rows * kVecs; i += blockDim.x) {
    const int pix = i / kVecs;
    const int ch = c0 + (i % kVecs) * E::kVec;
    const int yy = y0 + pix / width_px - off;
    const int xx = x0 + pix % width_px - off;
    const bool inside = yy >= 0 && yy < h && xx >= 0 && xx < w;
    const int n = inside ? min(E::kVec, c - ch) : 0;
    const T* s =
        src + (frame_px + static_cast<long long>(yy) * w + xx) * c + ch;
    T* d = dst + pix * E::kStride + (i % kVecs) * E::kVec;
    if (vec) {  // C % kVec == 0 and 16-byte aligned: n is kVec or <= 0
      cp_async16(d, n > 0 ? s : src, n > 0 ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < E::kVec; ++e) d[e] = e < n ? s[e] : zero<T>();
    }
  }
}

// Four blocks an SM (128 registers a thread), but three (168) for f32 at
// windows 3 and 9, which ptxas spills at 128 and not at 168 (window 9
// holds 80 accumulators of S). f32 at window 5 spills ~80 bytes at 128 and
// more at 168, so it keeps four; no path runs it.
template <typename T, int R, bool kLogits>
__global__ void __launch_bounds__(32 * kMmaWarps,
                                  sizeof(T) == 4 && (R == 1 || R == 4) ? 3
                                                                       : 4)
    fam_window_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ mask, T* __restrict__ out,
                          T* __restrict__ logits, int h, int w, int c,
                          int tiles_y, int tiles_x, float scale,
                          float scale_log2e, bool vec) {
  using P = Plan<R>;
  using E = Chunk<T>;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);
  T* sq = sk + P::kHaloRows * E::kStride;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tx = blockIdx.x % tiles_x;
  const int ty = (blockIdx.x / tiles_x) % tiles_y;
  const long long frame_px =
      static_cast<long long>(blockIdx.x / (tiles_x * tiles_y)) * h * w;
  const int y0 = ty * kTileH, x0 = tx * kTileW;
  const int nchunks = (c + E::kChunk - 1) / E::kChunk;

  for (int i = threadIdx.x; i < (P::kHaloRows - P::kHaloH * P::kHaloW) *
                                    E::kStride;
       i += blockDim.x) {
    sk[P::kHaloH * P::kHaloW * E::kStride + i] = zero<T>();
  }
  // this warp's halo columns: halo rows 2 * warp .. 2 * warp + 2r + 1
  const T* kw = sk + 2 * warp * P::kHaloW * E::kStride;
  const T* qw = sq + 16 * warp * E::kStride;

  // ---- pass 1: S = q . k_halo^T over the channel chunks
  float s[P::kNTiles][4];
#pragma unroll
  for (int n = 0; n < P::kNTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  for (int ci = 0; ci < nchunks; ++ci) {
    stage(sk, k, P::kHaloH * P::kHaloW, P::kHaloW, R, y0, x0, frame_px, h, w,
          c, ci * E::kChunk, vec);
    stage(sq, q, kTileH * kTileW, kTileW, 0, y0, x0, frame_px, h, w, c,
          ci * E::kChunk, vec);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < E::kChunk / E::kStep; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, qw + ((lane & 7) + 8 * ((lane >> 3) & 1)) * E::kStride +
                         E::kStep * ks + E::kVec * (lane >> 4));
      if constexpr (kF32) {
        Split as[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) as[j] = split_tf32(__uint_as_float(a[j]));
#pragma unroll
        for (int n = 0; n < P::kNTiles; n += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, kw + (8 * n + (lane & 7) + 8 * (lane >> 4)) *
                                  E::kStride +
                             E::kStep * ks + E::kVec * ((lane >> 3) & 1));
          mma_3xtf32(s[n], as, split_tf32(__uint_as_float(b[0])),
                     split_tf32(__uint_as_float(b[1])));
          mma_3xtf32(s[n + 1], as, split_tf32(__uint_as_float(b[2])),
                     split_tf32(__uint_as_float(b[3])));
        }
      } else {
#pragma unroll
        for (int n = 0; n < P::kNTiles; n += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, kw + (8 * n + (lane & 7) + 8 * (lane >> 4)) *
                                  E::kStride +
                             E::kStep * ks + E::kVec * ((lane >> 3) & 1));
          mma_bf16(s[n], a, b[0], b[1]);
          mma_bf16(s[n + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  // ---- the band. Element e of n-tile n is row g + 8 * (e >> 1) (query
  // (2 * warp + (e >> 1), g) of the tile) and column 8n + 2t + (e & 1)
  // (halo pixel (col / kHaloW, col % kHaloW) of this warp's rows), which is
  // neighbour (dy, dx) = (col / kHaloW - (e >> 1), col % kHaloW - g) of the
  // query, each in 0..2r. kLogits stores it first, then the softmax.
  T* lrow[2];
  float lscale[2];
  if constexpr (kLogits) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int yy = y0 + 2 * warp + i, xx = x0 + g;
      const long long pix = frame_px + static_cast<long long>(yy) * w + xx;
      const bool live = yy < h && xx < w;
      lrow[i] = live ? logits + pix * (2 * R + 1) * (2 * R + 1) : nullptr;
      lscale[i] = live ? to_f32(mask[pix]) * scale : 0.f;
    }
  }
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
      if constexpr (kLogits) {
        if (band && lrow[e >> 1]) {
          store(lrow[e >> 1] + dy * (2 * R + 1) + dx,
                s[n][e] * lscale[e >> 1]);
        }
      }
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
  // the weights as A fragments of pass 2: bf16 packed; f32 in place in s
  uint32_t pa[kF32 ? 1 : P::kKSteps][4];
#pragma unroll
  for (int n = 0; n < P::kNTiles; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if constexpr (kF32) {
        s[n][2 * i] = exp2f((s[n][2 * i] - mx[i]) * scale_log2e);
        s[n][2 * i + 1] = exp2f((s[n][2 * i + 1] - mx[i]) * scale_log2e);
        den[i] += s[n][2 * i] + s[n][2 * i + 1];
      } else {
        const __nv_bfloat162 pr = __floats2bfloat162_rn(
            exp2f((s[n][2 * i] - mx[i]) * scale_log2e),
            exp2f((s[n][2 * i + 1] - mx[i]) * scale_log2e));
        den[i] += __low2float(pr) + __high2float(pr);
        pa[n >> 1][(n & 1) * 2 + i] = pack_bf16(pr);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    den[i] += __shfl_xor_sync(0xffffffffu, den[i], 1);
    den[i] += __shfl_xor_sync(0xffffffffu, den[i], 2);
  }

  // ---- pass 2: O = P . k_halo, chunk by chunk, stored in T
  float scale_row[2];
  long long pix_row[2];
  bool live_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int yy = y0 + 2 * warp + i, xx = x0 + g;
    live_row[i] = yy < h && xx < w;
    pix_row[i] = frame_px + static_cast<long long>(yy) * w + xx;
    scale_row[i] = live_row[i] ? to_f32(mask[pix_row[i]]) / den[i] : 0.f;
  }
  const bool pairs = vec;  // C % kVec == 0 and aligned: vector stores
  for (int ci = 0; ci < nchunks; ++ci) {
    if (nchunks > 1) {
      stage(sk, k, P::kHaloH * P::kHaloW, P::kHaloW, R, y0, x0, frame_px, h,
            w, c, ci * E::kChunk, vec);
      cp_async_wait_all();
      __syncthreads();
    }
    if constexpr (kF32) {
      // an empty asm that "changes" the weights: without it the compiler
      // hoists their splits out of the chunk loop, twice the registers
#pragma unroll
      for (int n = 0; n < P::kNTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(s[n][e]));
      }
      // n-tile n, column j: channel 4j + n of the chunk; k index t: halo
      // column 8ks + 2t, t + 4: 8ks + 2t + 1 (the accumulator layout)
      float o[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < P::kNTiles; ++ks) {
        const Split pa_ks[4] = {split_tf32(s[ks][0]), split_tf32(s[ks][2]),
                                split_tf32(s[ks][1]), split_tf32(s[ks][3])};
        const float4 b0 = *reinterpret_cast<const float4*>(
            kw + (8 * ks + 2 * t) * E::kStride + 4 * g);
        const float4 b1 = *reinterpret_cast<const float4*>(
            kw + (8 * ks + 2 * t + 1) * E::kStride + 4 * g);
        mma_3xtf32(o[0], pa_ks, split_tf32(b0.x), split_tf32(b1.x));
        mma_3xtf32(o[1], pa_ks, split_tf32(b0.y), split_tf32(b1.y));
        mma_3xtf32(o[2], pa_ks, split_tf32(b0.z), split_tf32(b1.z));
        mma_3xtf32(o[3], pa_ks, split_tf32(b0.w), split_tf32(b1.w));
      }
      // row i's channels 8t + n (column 2t of n-tile n) and 8t + 4 + n
      // (column 2t + 1): eight contiguous channels a thread
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!live_row[i]) continue;
        T* op = out + pix_row[i] * c;
        const int ch = ci * E::kChunk + 8 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = 2 * i + half;
          const float v[4] = {o[0][e] * scale_row[i], o[1][e] * scale_row[i],
                              o[2][e] * scale_row[i], o[3][e] * scale_row[i]};
          const int c4 = ch + 4 * half;
          if (pairs) {
            if (c4 < c) {
              *reinterpret_cast<float4*>(op + c4) =
                  make_float4(v[0], v[1], v[2], v[3]);
            }
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (c4 + j < c) store(op + c4 + j, v[j]);
            }
          }
        }
      }
    } else {
      float o[E::kChunk / 8][4];
#pragma unroll
      for (int n = 0; n < E::kChunk / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < P::kKSteps; ++ks) {
#pragma unroll
        for (int n = 0; n < E::kChunk / 8; n += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, kw + (16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                          E::kStride +
                     8 * n + 8 * (lane >> 4));
          mma_bf16(o[n], pa[ks], b[0], b[1]);
          mma_bf16(o[n + 1], pa[ks], b[2], b[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!live_row[i]) continue;
        T* op = out + pix_row[i] * c;
#pragma unroll
        for (int n = 0; n < E::kChunk / 8; ++n) {
          const int ch = ci * E::kChunk + 8 * n + 2 * t;
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
    }
    if (nchunks > 1) __syncthreads();
  }
}

template <typename T, int R, bool kLogits>
int launch(const void* q, const void* k, const void* mask, void* out,
           void* logits, int b, int h, int w, int c, float scale,
           cudaStream_t stream) {
  const int tiles_y = (h + kTileH - 1) / kTileH;
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const long long blocks = static_cast<long long>(b) * tiles_y * tiles_x;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  const bool vec = c % Chunk<T>::kVec == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  fam_window_mma_kernel<T, R, kLogits>
      <<<static_cast<unsigned int>(blocks), 32 * kMmaWarps,
         Plan<R>::kSmemBytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(mask), static_cast<T*>(out),
          static_cast<T*>(logits), h, w, c, tiles_y, tiles_x, scale,
          scale * 1.4426950408889634f, vec);
  return static_cast<int>(cudaGetLastError());
}

// window: odd, 1..9; any other is refused with cudaErrorInvalidValue.
template <typename T, bool kLogits>
int dispatch(const void* q, const void* k, const void* mask, void* out,
             void* logits, int b, int h, int w, int c, int window,
             float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FAM_LAUNCH(r) \
  launch<T, r, kLogits>(q, k, mask, out, logits, b, h, w, c, scale, s)
  switch (window) {
    case 1: return FAM_LAUNCH(0);
    case 3: return FAM_LAUNCH(1);
    case 5: return FAM_LAUNCH(2);
    case 7: return FAM_LAUNCH(3);
    case 9: return FAM_LAUNCH(4);
    default: return cudaErrorInvalidValue;
  }
#undef FAM_LAUNCH
}

}  // namespace

extern "C" int fam_window_f32(const void* q, const void* k, const void* mask,
                              void* out, int b, int h, int w, int c,
                              int window, float scale, int device,
                              void* stream) {
  return dispatch<float, false>(q, k, mask, out, nullptr, b, h, w, c, window,
                                scale, device, stream);
}

extern "C" int fam_window_bf16_mma(const void* q, const void* k,
                                   const void* mask, void* out, int b, int h,
                                   int w, int c, int window, float scale,
                                   int device, void* stream) {
  return dispatch<__nv_bfloat16, false>(q, k, mask, out, nullptr, b, h, w, c,
                                        window, scale, device, stream);
}

extern "C" int fam_window_logits_f32(const void* q, const void* k,
                                     const void* mask, void* out,
                                     void* logits, int b, int h, int w, int c,
                                     int window, float scale, int device,
                                     void* stream) {
  return dispatch<float, true>(q, k, mask, out, logits, b, h, w, c, window,
                               scale, device, stream);
}

extern "C" int fam_window_logits_bf16(const void* q, const void* k,
                                      const void* mask, void* out,
                                      void* logits, int b, int h, int w,
                                      int c, int window, float scale,
                                      int device, void* stream) {
  return dispatch<__nv_bfloat16, true>(q, k, mask, out, logits, b, h, w, c,
                                       window, scale, device, stream);
}
