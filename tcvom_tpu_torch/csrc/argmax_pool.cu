// DIM's 2x2, stride-2 argmax max pool of an NCHW tensor and its inverse,
// the max unpool (tcvom_tpu_torch/ops/argmax_pool_kernel.py):
//   argmax_pool_fwd:    y[r, c] = the max of x's window (rows 2r, 2r + 1,
//                       columns 2c, 2c + 1) and idx[r, c] its row-major
//                       position in [0, 4), the first on ties;
//   argmax_pool_unpool: out's window of (r, c) holds x[r, c] at slot
//                       idx[r, c] and +0 at the other three.
// Both functions are exact, a max and a slot choice. The kernels take the
// plain version's steps, max(max(a, b), max(d, e)) with a NaN operand winning
// as in torch.maximum, in f32, and the slot from the same compares, so their
// results equal the plain ops' on the card bit for bit.
//
// Replaces: no TPU kernel. The JAX package leaves both functions to XLA
// (tcvom_tpu/ops/image.py::max_pool_argmax_2x2, ::max_unpool_2x2), which
// fuses each into one pass. PyTorch runs the plain composition as ~10
// elementwise launches over strided views (the pool) and a broadcast compare
// and a where (the unpool), moving 10.75 and 4.75 bytes an element where the
// functions need 2.75.
//
// Bound on the H100: device memory. The pool reads x and writes a quarter as
// many values and uint8 indices, the unpool the reverse: 2.75 bytes an
// element of the larger side in bf16. At DIM's five levels of a 1088x1920
// frame (five pools and five unpools a matte) that is 1.40 GB a matte, 0.42
// ms at 3.35 TB/s. A few compares an element are far below that line.
//
// The design: one launch a call, one thread a run of V consecutive outputs of
// one pooled row, neighbouring threads on neighbouring runs, so that each
// warp's loads and stores cover whole lines. V is 4 where a row's width is a
// multiple of 8 values and the addresses allow it: a pool thread then loads
// the 8 values of its windows' top row and the 8 of their bottom row with one
// 16-byte load each in bf16 (two in f32) and stores its 4 values and 4
// indices at once; an unpool thread loads 4 values and 4 indices and stores 8
// values to each of the two output rows. Otherwise V is 1 and every value is
// loaded and stored alone (DIM's deepest levels at small frames).
//
// The pool also takes a channels-last tensor (argmax_pool_fwd_nhwc), as DIM's
// encoder holds its activations (its input frame is a permuted NHWC tensor,
// and cuDNN and BatchNorm keep that layout), and writes its values and
// indices channels-last as the plain ops do, so the convolutions after it
// see the layout, and round as, they would after the plain pool. A thread
// then takes V = 4 consecutive channels of one output pixel: four loads of V
// values, one at each window position, and one store each of V values and V
// indices. The unpool writes NCHW, as the plain ops' reshape does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;

template <int kBytes>
struct Word;
template <>
struct Word<16> {
  using type = uint4;
};
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<4> {
  using type = unsigned;
};
template <>
struct Word<2> {
  using type = unsigned short;
};
template <>
struct Word<1> {
  using type = unsigned char;
};

// N values at src, which is aligned to N values (at most 16 bytes), copied
// to dst with loads as wide as that allows
template <class T, int N>
__device__ __forceinline__ void load(const T* __restrict__ src, T* dst) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  constexpr int kWord = kBytes < 16 ? kBytes : 16;
  using W = typename Word<kWord>::type;
#pragma unroll
  for (int i = 0; i < kBytes / kWord; ++i) {
    const W w = reinterpret_cast<const W*>(src)[i];
    memcpy(reinterpret_cast<char*>(dst) + i * kWord, &w, kWord);
  }
}

template <class T, int N>
__device__ __forceinline__ void store(T* __restrict__ dst, const T* src) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  constexpr int kWord = kBytes < 16 ? kBytes : 16;
  using W = typename Word<kWord>::type;
#pragma unroll
  for (int i = 0; i < kBytes / kWord; ++i) {
    W w;
    memcpy(&w, reinterpret_cast<const char*>(src) + i * kWord, kWord);
    reinterpret_cast<W*>(dst)[i] = w;
  }
}

// N values: as wide loads where kWide, else one value at a time
template <class T, int N, bool kWide>
__device__ __forceinline__ void load_run(const T* __restrict__ src, T* dst) {
  if constexpr (kWide) {
    load<T, N>(src, dst);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

template <class T, int N, bool kWide>
__device__ __forceinline__ void store_run(T* __restrict__ dst, const T* src) {
  if constexpr (kWide) {
    store<T, N>(dst, src);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <class T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  // as PyTorch's own conversion (c10::BFloat16): a NaN becomes 0x7fc0,
  // anything else rounds to nearest even, exact here (v is one of the values)
  return v != v ? __ushort_as_bfloat16(0x7fc0) : __float2bfloat16_rn(v);
}

// torch.maximum on the card: a NaN operand wins, else fmaxf
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// x: rows of `width` values (2 * rows_out of them); y, idx: rows_out rows of
// width / 2; `runs` = rows_out * width / 2 / V
template <class T, int V>
__global__ void __launch_bounds__(kThreads)
    argmax_pool_fwd(const T* __restrict__ x, T* __restrict__ y,
                    uint8_t* __restrict__ idx, long long runs,
                    long long width) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= runs) return;
  const long long half = width / 2;
  const long long o = t * V;
  const long long r = o / half;
  const long long c = o - r * half;
  const T* top = x + 2 * r * width + 2 * c;
  T a[2 * V], b[2 * V];
  load_run<T, 2 * V, (V > 1)>(top, a);
  load_run<T, 2 * V, (V > 1)>(top + width, b);
  T out[V];
  uint8_t slot[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float a0 = to_float(a[2 * i]), a1 = to_float(a[2 * i + 1]);
    const float b0 = to_float(b[2 * i]), b1 = to_float(b[2 * i + 1]);
    // each row keeps its first value unless the second is larger; the
    // bottom row wins only if strictly larger: the first max overall
    const float hi = maximum(a0, a1), lo = maximum(b0, b1);
    out[i] = from_float<T>(maximum(hi, lo));
    slot[i] = lo > hi ? static_cast<uint8_t>(2 + (b1 > b0))
                      : static_cast<uint8_t>(a1 > a0);
  }
  store_run<T, V, (V > 1)>(y + o, out);
  store_run<uint8_t, V, (V > 1)>(idx + o, slot);
}

// x: [N, 2h, 2w, C] channels-last; y, idx: [N, h, w, C], `width` = w;
// `runs` = N * h * w * C / V
template <class T, int V>
__global__ void __launch_bounds__(kThreads)
    argmax_pool_fwd_nhwc(const T* __restrict__ x, T* __restrict__ y,
                         uint8_t* __restrict__ idx, long long runs,
                         long long width, long long channels) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= runs) return;
  const long long o = t * V;
  const long long p = o / channels;  // the output pixel
  const long long c = o - p * channels;
  const long long r = p / width;     // its row, over N * h
  const long long q = p - r * width;
  const long long row = 2 * width * channels;  // an input row's values
  const T* top = x + 2 * r * row + 2 * q * channels + c;
  T a0[V], a1[V], b0[V], b1[V];
  load_run<T, V, (V > 1)>(top, a0);
  load_run<T, V, (V > 1)>(top + channels, a1);
  load_run<T, V, (V > 1)>(top + row, b0);
  load_run<T, V, (V > 1)>(top + row + channels, b1);
  T out[V];
  uint8_t slot[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float u0 = to_float(a0[i]), u1 = to_float(a1[i]);
    const float v0 = to_float(b0[i]), v1 = to_float(b1[i]);
    const float hi = maximum(u0, u1), lo = maximum(v0, v1);
    out[i] = from_float<T>(maximum(hi, lo));
    slot[i] = lo > hi ? static_cast<uint8_t>(2 + (v1 > v0))
                      : static_cast<uint8_t>(u1 > u0);
  }
  store_run<T, V, (V > 1)>(y + o, out);
  store_run<uint8_t, V, (V > 1)>(idx + o, slot);
}

// x, idx: rows of `width` values; out: 2 * rows rows of 2 * width;
// `runs` = rows * width / V
template <class T, int V>
__global__ void __launch_bounds__(kThreads)
    argmax_pool_unpool(const T* __restrict__ x,
                       const uint8_t* __restrict__ idx, T* __restrict__ out,
                       long long runs, long long width) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= runs) return;
  const long long o = t * V;
  const long long r = o / width;
  const long long c = o - r * width;
  T v[V];
  uint8_t k[V];
  load_run<T, V, (V > 1)>(x + o, v);
  load_run<uint8_t, V, (V > 1)>(idx + o, k);
  const T zero = from_float<T>(0.f);
  T top[2 * V], bottom[2 * V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    top[2 * i] = k[i] == 0 ? v[i] : zero;
    top[2 * i + 1] = k[i] == 1 ? v[i] : zero;
    bottom[2 * i] = k[i] == 2 ? v[i] : zero;
    bottom[2 * i + 1] = k[i] == 3 ? v[i] : zero;
  }
  T* row = out + 4 * r * width + 2 * c;
  store_run<T, 2 * V, (V > 1)>(row, top);
  store_run<T, 2 * V, (V > 1)>(row + 2 * width, bottom);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

unsigned blocks_of(long long runs) {
  return static_cast<unsigned>((runs + kThreads - 1) / kThreads);
}

// the runs of `vec` outputs that `outputs` split into, each inside one run
// of `unit` (a row, or a pixel's channels), or 0 for arguments the kernels
// do not take
long long runs_of(long long outputs, long long unit, int vec, int device) {
  if (outputs <= 0 || unit <= 0 || (vec != 1 && vec != 4) || unit % vec ||
      outputs % unit) {
    return 0;
  }
  const long long runs = outputs / vec;
  if ((runs + kThreads - 1) / kThreads >= (1LL << 31)) return 0;
  return cudaSetDevice(device) == cudaSuccess ? runs : 0;
}

template <class T>
int pool(const void* x, void* y, void* idx, long long runs, long long width,
         int vec, cudaStream_t s) {
  const auto* xt = static_cast<const T*>(x);
  auto* yt = static_cast<T*>(y);
  auto* it = static_cast<uint8_t*>(idx);
  if (vec == 4) {
    if (!aligned(x, 8 * sizeof(T)) || !aligned(y, 4 * sizeof(T)) ||
        !aligned(idx, 4)) {
      return cudaErrorMisalignedAddress;
    }
    argmax_pool_fwd<T, 4><<<blocks_of(runs), kThreads, 0, s>>>(xt, yt, it,
                                                               runs, width);
  } else {
    argmax_pool_fwd<T, 1><<<blocks_of(runs), kThreads, 0, s>>>(xt, yt, it,
                                                               runs, width);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int pool_nhwc(const void* x, void* y, void* idx, long long runs,
              long long width, long long channels, int vec, cudaStream_t s) {
  const auto* xt = static_cast<const T*>(x);
  auto* yt = static_cast<T*>(y);
  auto* it = static_cast<uint8_t*>(idx);
  if (vec == 4) {
    if (!aligned(x, 4 * sizeof(T)) || !aligned(y, 4 * sizeof(T)) ||
        !aligned(idx, 4)) {
      return cudaErrorMisalignedAddress;
    }
    argmax_pool_fwd_nhwc<T, 4><<<blocks_of(runs), kThreads, 0, s>>>(
        xt, yt, it, runs, width, channels);
  } else {
    argmax_pool_fwd_nhwc<T, 1><<<blocks_of(runs), kThreads, 0, s>>>(
        xt, yt, it, runs, width, channels);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int unpool(const void* x, const void* idx, void* out, long long runs,
           long long width, int vec, cudaStream_t s) {
  const auto* xt = static_cast<const T*>(x);
  const auto* it = static_cast<const uint8_t*>(idx);
  auto* ot = static_cast<T*>(out);
  if (vec == 4) {
    if (!aligned(x, 4 * sizeof(T)) || !aligned(idx, 4) ||
        !aligned(out, 8 * sizeof(T))) {
      return cudaErrorMisalignedAddress;
    }
    argmax_pool_unpool<T, 4><<<blocks_of(runs), kThreads, 0, s>>>(
        xt, it, ot, runs, width);
  } else {
    argmax_pool_unpool<T, 1><<<blocks_of(runs), kThreads, 0, s>>>(
        xt, it, ot, runs, width);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [rows_out * 2, width] contiguous, width even; y: [rows_out, width / 2]
// of x's dtype (bf16 when `bf16`, else f32); idx: the same shape, uint8.
// vec: 4 (width a multiple of 8, x aligned to 8 values, y to 4, idx to 4
// bytes) or 1; arguments this source does not take are refused with
// cudaErrorInvalidValue (cudaErrorMisalignedAddress for addresses).
extern "C" int argmax_pool_forward(const void* x, void* y, void* idx,
                                   long long rows_out, long long width,
                                   int bf16, int vec, int device,
                                   void* stream) {
  if (width % 2) return cudaErrorInvalidValue;
  const long long runs = runs_of(rows_out * (width / 2), width / 2, vec,
                                 device);
  if (runs == 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? pool<__nv_bfloat16>(x, y, idx, runs, width, vec, s)
              : pool<float>(x, y, idx, runs, width, vec, s);
}

// x: [N, 2 * rows_out / N, 2 * width, channels] contiguous (an NCHW tensor
// in channels-last memory); y, idx: [N, rows_out / N, width, channels], the
// dtype's and uint8. vec: 4 (channels a multiple of 4, x and y aligned to 4
// values, idx to 4 bytes) or 1.
extern "C" int argmax_pool_forward_nhwc(const void* x, void* y, void* idx,
                                        long long rows_out, long long width,
                                        long long channels, int bf16, int vec,
                                        int device, void* stream) {
  if (rows_out <= 0 || width <= 0) return cudaErrorInvalidValue;
  const long long runs = runs_of(rows_out * width * channels, channels, vec,
                                 device);
  if (runs == 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? pool_nhwc<__nv_bfloat16>(x, y, idx, runs, width, channels,
                                         vec, s)
              : pool_nhwc<float>(x, y, idx, runs, width, channels, vec, s);
}

// x: [rows, width] contiguous of the dtype; idx: the same shape, uint8; out:
// [2 * rows, 2 * width]. vec: 4 (width a multiple of 4, x aligned to 4
// values, idx to 4 bytes, out to 8 values) or 1.
extern "C" int argmax_unpool_forward(const void* x, const void* idx,
                                     void* out, long long rows,
                                     long long width, int bf16, int vec,
                                     int device, void* stream) {
  const long long runs = runs_of(rows * width, width, vec, device);
  if (runs == 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? unpool<__nv_bfloat16>(x, idx, out, runs, width, vec, s)
              : unpool<float>(x, idx, out, runs, width, vec, s);
}
